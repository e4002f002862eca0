// One viscous-fluid iteration's fusable part on Hopper (sm_90a): the L-SSD
// force at the motion u, one red-black SOR sweep of the Navier-Lame system
// on the velocity, the material derivative R = v - du/dx v_x - du/dy v_y,
// and max |R|^2. Three kernels from one body:
//   B7 fluid_iter writes vel' and R;
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
// Design: each thread block owns a kSorTile x kSorTile output tile and
//   loads u, vel and g with a halo of 2 cells into shared memory, the
//   velocity twice (ping-pong). The red half-sweep reads one velocity
//   buffer and writes the other, the black half writes it back
//   (sor_stages.cuh): the black half reads red values one cell away, which
//   read old values one cell further, so the halo of 2 keeps the tile
//   exact. The force is pointwise in u, which is read-only. The material
//   derivative reads u one cell away (material_derivative.cuh). Each block
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

#include "material_derivative.cuh"
#include "partials.cuh"
#include "sor_stages.cuh"

namespace {

constexpr int kHalo = 2;
constexpr int kExt = kSorTile + 2 * kHalo;
constexpr int kExt2 = kExt * kExt;
// Shared floats: u (2 planes), two velocity buffers (2 planes each), g (3
// planes) and one max per warp.
constexpr int kFluidSmemFloats = 9 * kExt2 + kSorThreadsX;

// kStoreR: write R (B7); without it R is never stored (B8).
template <bool kRefStencil, bool kMaxabsBug, bool kStoreR>
__global__ void __launch_bounds__(kSorThreads)
fluid_iter_kernel(const float* __restrict__ u, const float* __restrict__ vel,
                  const float* __restrict__ g, float* __restrict__ vel_out,
                  float* __restrict__ r_out, float* __restrict__ partials, Rows rows, int ny,
                  SorScalars s) {
  extern __shared__ float smem[];
  float* us = smem;
  float* cur = us + 2 * kExt2;
  float* nxt = cur + 2 * kExt2;
  float* gs = nxt + 2 * kExt2;
  float* warp_max = gs + 3 * kExt2;
  const int li0 = blockIdx.y * kSorTile - kHalo;  // local index of extended row 0
  const int gi0 = rows.row0 + li0;                 // and its global index
  const int gj0 = blockIdx.x * kSorTile - kHalo;
  const int nx = rows.nx;

  load_tile(u, us, 2, rows, ny, li0, gj0, kExt);
  load_tile(vel, cur, 2, rows, ny, li0, gj0, kExt);
  load_tile(g, gs, 3, rows, ny, li0, gj0, kExt);
  __syncthreads();

  float unused = 0.f;
  sor_half_sweep<kRefStencil, false>(cur, nxt, us, gs, kExt, 1, kExt - 1, gi0, gj0, nx, ny, 0,
                                     s, 0, 0, 0, unused, unused);
  __syncthreads();
  sor_half_sweep<kRefStencil, false>(nxt, cur, us, gs, kExt, 2, kExt - 2, gi0, gj0, nx, ny, 1,
                                     s, 0, 0, 0, unused, unused);
  __syncthreads();

  const size_t n = rows.out_plane(ny);
  float m = 0.f;
  const int ty = threadIdx.x, tx = threadIdx.y;  // lane along y, warp along x
  for (int li = kHalo + tx; li < kHalo + kSorTile; li += kSorThreadsX) {
    const int lr = li0 + li;
    if (lr >= rows.nxl) break;
    const int gi = gi0 + li;
    for (int lj = kHalo + ty; lj < kHalo + kSorTile; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      if (gj >= ny) break;
      const int l = li * kExt + lj;
      const float v0 = cur[l], v1 = cur[kExt2 + l];
      float r[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* uc = us + c * kExt2;
        const float dudx = central(uc[l - kExt], uc[l], uc[l + kExt], gi, nx);
        const float dudy = central(uc[l - 1], uc[l], uc[l + 1], gj, ny);
        const float vc = c == 0 ? v0 : v1;
        r[c] = material_r(vc, v0, v1, dudx, dudy);
      }
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      vel_out[p] = v0;
      vel_out[n + p] = v1;
      if (kStoreR) {
        r_out[p] = r[0];
        r_out[n + p] = r[1];
      }
      // Motion::maxabs (src/Motion.cpp:51-58); the bug sums y twice.
      const float a = kMaxabsBug ? r[1] : r[0];
      m = fmaxf(m, a * a + r[1] * r[1]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if (ty == 0) warp_max[tx] = m;
  __syncthreads();
  if (tx == 0 && ty == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kSorThreadsX; ++w) bm = fmaxf(bm, warp_max[w]);
    partials[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = bm;
  }
}

// maxsq = max over the blocks' partials.
__global__ void __launch_bounds__(kSumThreads)
max_partials_kernel(const float* __restrict__ partials, float* __restrict__ maxsq,
                    int nblocks) {
  __shared__ float warps[kSumThreads / 32];
  float m = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kSumThreads) m = fmaxf(m, partials[b]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / 32; ++w) m = fmaxf(m, warps[w]);
    *maxsq = m;
  }
}

template <bool kRefStencil, bool kMaxabsBug, bool kStoreR>
int launch_fluid_iter(const float* u, const float* vel, const float* g, float* vel_out,
                      float* r_out, float* partials, float* maxsq, Rows rows, int ny,
                      SorScalars s, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(kFluidSmemFloats * sizeof(float));
  auto kernel = fluid_iter_kernel<kRefStencil, kMaxabsBug, kStoreR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sor_tiles(ny), sor_tiles(rows.nxl));
  kernel<<<grid, dim3(kSorThreadsY, kSorThreadsX), smem, stream>>>(u, vel, g, vel_out, r_out,
                                                                   partials, rows, ny, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, maxsq,
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

extern "C" int of2d_fluid_iter_smem_bytes() {
  return static_cast<int>(kFluidSmemFloats * sizeof(float));
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
  if (!strip_ok(rows, kHalo)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(u_pad, vel_pad, g_pad, vel_out, r_out, partials, maxsq, rows, ny,
                        SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, maxabs_bug,
                        stream);
}
