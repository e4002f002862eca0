// Temporal-blocked Horn-Schunck diffusion on Hopper (sm_90a): k Jacobi
// iterations per pass over device memory, with the reference Logger's
// per-iteration sums. One body, two entry points:
//   B1 of2d_diffusion_block, the whole image;
//   K1 of2d_diffusion_block_strip, one strip of the strip-parallel driver
//      (parallel/spatial.py), pre-padded with pad >= k halo rows a side.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/diffusion_block.py,
//   diffusion_block_pallas (B1, :223) and diffusion_block_strip (K1, :318,
//   _strip_kernel :138).
// Bound on this card: device-memory bandwidth. A pass reads u (2 planes)
//   and g = (gx, gy, It) (3 planes) and writes u: 28 B per pixel (0.140 ms
//   at 4096^2) for k steps of 33 operations (264 at k = 8: 0.132 ms at the
//   instruction floor without FMAs); a strip also reads its 2 * pad halo
//   rows of u and g.
// Design (diffusion_stages.cuh; the sweep in PERF.md): one block per output
//   tile of the first plan whose shared memory fits at k (kDiffusionPlans:
//   48 x 48 on 512 threads, two blocks an SM at k = 8, else 32 x 32 on 256),
//   u and g staged with a halo of k by cp.async; each thread slides a
//   register window down a run of its column's cells; the two u buffers
//   ping-pong; k = 8 compiled in, and tiles inside the image take a route
//   without border tests. Step s updates the extended tile shrunk by s + 1
//   cells a side, the part whose neighbours are still exact, so the tile's
//   own cells equal k single steps.
// Strips (rows.cuh): a tile row is read from the padded strip and masked by
//   global row. A strip's halo rows come from its pad and never from beyond
//   it (pad >= k, checked); rows past the pad load as 0 and their error
//   reaches no owned row within k steps. So the strips of an image,
//   concatenated, equal B1 on the image bit for bit.
// Border: q is zero where gi == 0, gi == nx-1, gj == 0 or gj == ny-1
//   (diffusion_block.py:63-66). Cells outside the image load as 0 and are
//   read by no image cell, since the border's q reads no neighbour. Ragged
//   tiles need nothing else.
// Sums: for each iteration, sqrt(d0^2 + d1^2) of the step and of the
//   previous field over the tile's owned image cells, reduced in a fixed
//   order into [nblocks, k, 2] partials, one row per tile; a second kernel
//   adds the blocks in order (partials.cuh). No float atomics, so the
//   Logger error, and with it the iteration count, is the same from run to
//   run. A strip's sums are its own; the driver adds the strips in order.
// Numerics: the Pallas kernel's order of operations, with -fmad=false, so
//   the interior rounds like k calls of diffusion_step_ref on the device.

#include <cuda_runtime.h>

#include <cstddef>

#include "diffusion_stages.cuh"

namespace {

// B1 or K1 on plan P with k compiled in (K > 0) or at run time (K = 0),
// then the sums of the partials.
template <int K, int P>
int launch_plan(const float* u, const float* g, float* out, float* partials, float* sums,
                Rows r, int ny, int k, float a2, cudaStream_t stream) {
  constexpr DiffusionPlan p = kDiffusionPlans[P];
  auto* kernel = diffusion_block_kernel<K, p.tx, p.ty, p.threads, p.min_blocks>;
  const int smem = diffusion_smem_bytes(k, p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + p.ty - 1) / p.ty, (r.nxl + p.tx - 1) / p.tx);
  kernel<<<grid, p.threads, smem, stream>>>(u, g, out, partials, r, ny, k, a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

int launch_diffusion_block(const float* u, const float* g, float* out, float* partials,
                           float* sums, Rows r, int ny, int k, float a2, cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (diffusion_plan_index(k)) {
    case 0:
      return k == kDiffusionStaticK
                 ? launch_plan<kDiffusionStaticK, 0>(u, g, out, partials, sums, r, ny, k, a2,
                                                     stream)
                 : launch_plan<0, 0>(u, g, out, partials, sums, r, ny, k, a2, stream);
    case 1: return launch_plan<0, 1>(u, g, out, partials, sums, r, ny, k, a2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);  // no plan fits
  }
}
static_assert(kDiffusionPlanCount == 2, "launch_diffusion_block dispatches every plan");

}  // namespace

// Shared memory of one block on k's plan, or, where none fits, of the last
// plan (more than a block has).
extern "C" int of2d_diffusion_block_smem_bytes(int k) {
  const int i = diffusion_plan_index(k);
  return diffusion_smem_bytes(k, kDiffusionPlans[i < 0 ? kDiffusionPlanCount - 1 : i]);
}

// Thread blocks (rows of the partials) of a launch over nx (or a strip's
// nxl) rows at k; 0 where no plan fits.
extern "C" int of2d_diffusion_block_nblocks(int nx, int ny, int k) {
  const int i = diffusion_plan_index(k);
  return i < 0 ? 0 : diffusion_tiles(nx, ny, kDiffusionPlans[i].tx, kDiffusionPlans[i].ty);
}

// B1: u [2, nx, ny], g [3, nx, ny] -> out [2, nx, ny], sums [k, 2];
// partials [of2d_diffusion_block_nblocks(nx, ny, k), k, 2] is scratch.
extern "C" int of2d_diffusion_block(const float* u, const float* g, float* out,
                                    float* partials, float* sums, int nx, int ny,
                                    int k, float a2, cudaStream_t stream) {
  return launch_diffusion_block(u, g, out, partials, sums, whole_image(nx), ny, k, a2, stream);
}

// K1: u_pad [2, nxl + 2 pad, ny], g_pad [3, nxl + 2 pad, ny] of the strip
// whose first owned row is global row row0 of nx_glob -> out [2, nxl, ny]
// and the strip's sums [k, 2]; partials [of2d_diffusion_block_nblocks(nxl,
// ny, k), k, 2] is scratch. Needs pad >= k.
extern "C" int of2d_diffusion_block_strip(const float* u_pad, const float* g_pad, float* out,
                                          float* partials, float* sums, int nxl, int ny,
                                          int k, int pad, int row0, int nx_glob, float a2,
                                          cudaStream_t stream) {
  const Rows r{nxl, pad, row0, nx_glob};
  if (!strip_ok(r, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_diffusion_block(u_pad, g_pad, out, partials, sums, r, ny, k, a2, stream);
}

extern "C" int of2d_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return bytes;
}

extern "C" const char* of2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
