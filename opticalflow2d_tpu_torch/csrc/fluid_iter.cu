// One viscous-fluid iteration's fusable part on Hopper (sm_90a): the L-SSD
// force at the motion u, one red-black SOR sweep of the Navier-Lame system
// on the velocity, the material derivative R = v - du/dx v_x - du/dy v_y,
// and max |R|^2. Three kernels from one body:
//   B7 fluid_iter writes vel' and R; of2d_fluid_iter_batch takes the
//      listed pairs of a stack in one launch (the grid's z axis; the
//      lockstep fluid driver, engine/registration.py), each pair's vel' at
//      its place in the stack, its R and max |R|^2 in list order;
//   B8 fluid_sweep_max writes vel' only: R stays in registers, and
//      fluid_euler.cu (B9) recomputes it for the Euler step;
//   K3 fluid_iter_strip is B7 on one strip of the strip-parallel driver
//      (parallel/spatial.py), pre-padded with pad >= 2 halo rows a side
//      (the driver pads 8, the TPU kernel's _PAD); it writes the strip's
//      max |R|^2, which the driver maxes over the strips.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/fluid_fused.py,
//   fluid_iter_pallas (B7, :188), fluid_sweep_max_pallas (B8, :345) and
//   fluid_iter_strip (K3, :250), all on the body _fluid_body (:55).
// Bound on this card: device-memory bandwidth. It reads u and vel (2 planes
//   each) and g = (gx, gy, It) (3 planes) and writes vel' (2 planes), and
//   for B7 R (2 planes): 44 B per pixel for B7, 36 B for B8, for about 60
//   flops.
// Design (fluid_stages.cuh; the sweep in PERF.md): one block per output
//   tile of kFluidPlan (32 x 64 on 512 threads, two blocks an SM), u, vel
//   and g staged with a halo of 2 cells by cp.async. The red half-sweep
//   reads one velocity buffer and writes its red cells into the other; the
//   black half reads its red 4-neighbours there and writes its black cells
//   beside them, so the second buffer holds vel' over the tile without a
//   copy (elastic_stages.cuh's half at k = 1, its force at the read-only
//   u): the black half reads red values one cell away, which read old
//   values one cell further, so the halo of 2 keeps the tile exact. Lanes
//   are compacted by colour, each thread sliding a register window down a
//   run of its column's cells of the half's colour. The material
//   derivative reads u one cell away (material_derivative.cuh). Tiles
//   inside the image take a route without border tests. Each block
//   writes its max |R|^2 partial; a second kernel takes the max over the
//   blocks (exact in any order). dt = dumax / sqrt(max) and the gated Euler
//   update stay outside, as in the TPU kernels (solvers/fluid.py).
// Strips (rows.cuh): tile rows come from the padded strip; the sweep's
//   colours and interior and R's one-sided borders use the global row, so
//   R is one-sided at global rows 0 and nx - 1 only. The strips of an
//   image, concatenated, equal B7 on it bit for bit, and the max of their
//   max |R|^2 equals B7's.
// Border: sweep updates only at global interior cells; the derivatives of
//   u are one-sided at the global border (ops/grid.py::partial_x/y). Cells
//   outside the image load as 0 and are never read by an image cell.
// Numerics: the plain version's expressions in its order, with -fmad=false,
//   so vel' and R round like solvers/fluid.py's plain chain on the card,
//   and B8's max |R|^2 equals B7's bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "fluid_stages.cuh"

namespace {

// kStoreR: write R (B7); without it R is never stored (B8).
template <bool kRefStencil, bool kMaxabsBug, bool kStoreR>
int launch_fluid_iter(const float* u, const float* vel, const float* g, float* vel_out,
                      float* r_out, float* partials, float* maxsq, Rows rows, int ny,
                      SorScalars s, cudaStream_t stream) {
  constexpr FluidPlan p = kFluidPlan;
  constexpr int smem = fluid_smem_bytes(p);
  auto* kernel = fluid_iter_kernel<p.tx, p.ty, p.threads, p.min_blocks, kFluidRun, kRefStencil,
                                   kMaxabsBug, kStoreR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + p.ty - 1) / p.ty, (rows.nxl + p.tx - 1) / p.tx);
  kernel<<<grid, p.threads, smem, stream>>>(u, vel, g, vel_out, r_out, partials, rows, ny, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, maxsq,
                                                     static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

// B7 batched: one grid layer per listed pair, one max a pair.
template <bool kRefStencil, bool kMaxabsBug>
int launch_fluid_iter_batch(const float* u, const float* vel, const float* g, float* vel_out,
                            float* r_out, float* partials, float* maxsq, const int* pairs,
                            int n_pairs, int nx, int ny, SorScalars s, cudaStream_t stream) {
  constexpr FluidPlan p = kFluidPlan;
  constexpr int smem = fluid_smem_bytes(p);
  auto* kernel = fluid_iter_batch_kernel<p.tx, p.ty, p.threads, p.min_blocks, kFluidRun,
                                         kRefStencil, kMaxabsBug>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + p.ty - 1) / p.ty, (nx + p.tx - 1) / p.tx, n_pairs);
  kernel<<<grid, p.threads, smem, stream>>>(u, vel, g, vel_out, r_out, partials,
                                            whole_image(nx), ny, s, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_partials_kernel<<<n_pairs, kSumThreads, 0, stream>>>(partials, maxsq,
                                                           static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

template <bool kStoreR>
int dispatch(const float* u, const float* vel, const float* g, float* vel_out, float* r_out,
             float* partials, float* maxsq, Rows rows, int ny, SorScalars s,
             int reference_stencil, int maxabs_bug, cudaStream_t stream) {
  if (reference_stencil)
    return maxabs_bug ? launch_fluid_iter<true, true, kStoreR>(u, vel, g, vel_out, r_out,
                                                               partials, maxsq, rows, ny, s,
                                                               stream)
                      : launch_fluid_iter<true, false, kStoreR>(u, vel, g, vel_out, r_out,
                                                                partials, maxsq, rows, ny, s,
                                                                stream);
  return maxabs_bug ? launch_fluid_iter<false, true, kStoreR>(u, vel, g, vel_out, r_out, partials,
                                                              maxsq, rows, ny, s, stream)
                    : launch_fluid_iter<false, false, kStoreR>(u, vel, g, vel_out, r_out,
                                                               partials, maxsq, rows, ny, s,
                                                               stream);
}

}  // namespace

extern "C" int of2d_fluid_iter_smem_bytes() { return fluid_smem_bytes(kFluidPlan); }

// Thread blocks (rows of the partials) of a launch over nx (or a strip's
// nxl) rows.
extern "C" int of2d_sor_nblocks(int nx, int ny) {
  return fluid_tiles(nx, ny, kFluidPlan.tx, kFluidPlan.ty);
}

// B7: u, vel [2, nx, ny], g [3, nx, ny] -> vel_out, r_out [2, nx, ny],
// maxsq [1]; partials [nblocks] (of2d_sor_nblocks) is scratch.
extern "C" int of2d_fluid_iter(const float* u, const float* vel, const float* g,
                               float* vel_out, float* r_out, float* partials, float* maxsq,
                               int nx, int ny, float mu, float mpl, float omw,
                               float inv_diag, int reference_stencil, int maxabs_bug,
                               cudaStream_t stream) {
  return dispatch<true>(u, vel, g, vel_out, r_out, partials, maxsq, whole_image(nx), ny,
                        SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, maxabs_bug,
                        stream);
}

// B7 batched: u, vel [B, 2, nx, ny], g [B, 3, nx, ny] -> for the n_pairs
// pairs listed in pairs (device int32, each in [0, B), no repeats) vel_out
// [B, 2, nx, ny] at each pair's place (the other pairs are not written),
// and r_out [n_pairs, 2, nx, ny] and maxsq [n_pairs] in list order;
// partials [n_pairs, of2d_sor_nblocks(nx, ny)] is scratch. Each pair's
// vel', R and max |R|^2 equal its own of2d_fluid_iter's.
extern "C" int of2d_fluid_iter_batch(const float* u, const float* vel, const float* g,
                                     float* vel_out, float* r_out, float* partials,
                                     float* maxsq, const int* pairs, int n_pairs, int nx,
                                     int ny, float mu, float mpl, float omw, float inv_diag,
                                     int reference_stencil, int maxabs_bug,
                                     cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  const SorScalars s{mu, mpl, omw, inv_diag};
  if (reference_stencil)
    return maxabs_bug ? launch_fluid_iter_batch<true, true>(u, vel, g, vel_out, r_out, partials,
                                                            maxsq, pairs, n_pairs, nx, ny, s,
                                                            stream)
                      : launch_fluid_iter_batch<true, false>(u, vel, g, vel_out, r_out,
                                                             partials, maxsq, pairs, n_pairs,
                                                             nx, ny, s, stream);
  return maxabs_bug ? launch_fluid_iter_batch<false, true>(u, vel, g, vel_out, r_out, partials,
                                                           maxsq, pairs, n_pairs, nx, ny, s,
                                                           stream)
                    : launch_fluid_iter_batch<false, false>(u, vel, g, vel_out, r_out, partials,
                                                            maxsq, pairs, n_pairs, nx, ny, s,
                                                            stream);
}

// B8: as B7 without R: -> vel_out [2, nx, ny], maxsq [1].
extern "C" int of2d_fluid_sweep_max(const float* u, const float* vel, const float* g,
                                    float* vel_out, float* partials, float* maxsq, int nx,
                                    int ny, float mu, float mpl, float omw, float inv_diag,
                                    int reference_stencil, int maxabs_bug,
                                    cudaStream_t stream) {
  return dispatch<false>(u, vel, g, vel_out, nullptr, partials, maxsq, whole_image(nx), ny,
                         SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, maxabs_bug,
                         stream);
}

// K3: u_pad, vel_pad [2, nxl + 2 pad, ny], g_pad [3, nxl + 2 pad, ny] of
// the strip whose first owned row is global row row0 of nx_glob ->
// vel_out, r_out [2, nxl, ny] and the strip's maxsq [1]; partials
// [of2d_sor_nblocks(nxl, ny)] is scratch. Needs pad >= 2.
extern "C" int of2d_fluid_iter_strip(const float* u_pad, const float* vel_pad,
                                     const float* g_pad, float* vel_out, float* r_out,
                                     float* partials, float* maxsq, int nxl, int ny, int pad,
                                     int row0, int nx_glob, float mu, float mpl, float omw,
                                     float inv_diag, int reference_stencil, int maxabs_bug,
                                     cudaStream_t stream) {
  const Rows rows{nxl, pad, row0, nx_glob};
  if (!strip_ok(rows, kFluidHalo)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(u_pad, vel_pad, g_pad, vel_out, r_out, partials, maxsq, rows, ny,
                        SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, maxabs_bug,
                        stream);
}
