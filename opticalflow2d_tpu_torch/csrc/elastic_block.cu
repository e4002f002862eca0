// Temporal-blocked elastic registration on Hopper (sm_90a): k elastic
// iterations (the pointwise L-SSD force, then a red and a black SOR
// half-sweep of the Navier-Lame system) per pass over device memory, with
// the reference Logger's per-iteration sums. One body, two entry points:
//   B6 of2d_elastic_block, the whole image;
//   K2 of2d_elastic_block_strip, one strip of the strip-parallel driver
//      (parallel/spatial.py), pre-padded with pad >= 2k halo rows a side.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/elastic_block.py,
//   elastic_block_pallas (B6, :206) and elastic_block_strip (K2, :281).
// Bound on this card: device-memory bandwidth. A pass reads u (2 planes)
//   and g = (gx, gy, It) (3 planes) and writes u: 28 B per pixel for k
//   iterations of about 50 flops each (0.100 ms at 4096^2, k = 4, without
//   FMAs, under the 0.140 ms of the bytes).
// Design (elastic_stages.cuh; the sweep in PERF.md): one block per output
//   tile of the first plan whose shared memory fits at k (kElasticPlans:
//   48 x 48 on 512 threads, else 32 x 32 on 256), staged with a halo of 2k
//   by cp.async; lanes compacted by colour, each thread sliding a register
//   window down a run of its column's cells of the half's colour; the two
//   u buffers ping-pong without a copy; k compiled in for k <= 4, and tiles
//   inside the image take a route without border tests.
// Strips (rows.cuh): tile rows are read from the padded strip and masked
//   and coloured by global row; the cone of 2k rows stays inside the pad.
//   The strips of an image, concatenated, equal B6 on the image bit for
//   bit; a strip's sums are its own.
// Border: updates only at global interior cells (1 <= i <= nx-2,
//   1 <= j <= ny-2). Cells outside the image load as 0, keep their value
//   and are read by no image cell. Ragged tiles need nothing else.
// Sums: [nblocks, k, 2] partials, one row per tile, reduced in a fixed
//   order; a second kernel adds the blocks in order (partials.cuh). No
//   float atomics, so the Logger error, and with it the iteration count,
//   repeats exactly.
// Numerics: the plain version's order of operations, with -fmad=false, so
//   the interior rounds like k calls of solvers/elastic.py::elastic_step.

#include <cuda_runtime.h>

#include <cstddef>

#include "elastic_stages.cuh"

namespace {

// B6 or K2 on plan P with k compiled in (K > 0) or at run time (K = 0),
// then the sums of the partials.
template <int K, int P, bool kRef>
int launch_plan(const float* u, const float* g, float* out, float* partials, float* sums,
                Rows r, int ny, int k, SorScalars s, cudaStream_t stream) {
  constexpr ElasticPlan p = kElasticPlans[P];
  auto* kernel = elastic_block_kernel<K, p.tx, p.ty, p.threads, p.min_blocks, kRef>;
  const int smem = elastic_smem_bytes(k, p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + p.ty - 1) / p.ty, (r.nxl + p.tx - 1) / p.tx);
  kernel<<<grid, p.threads, smem, stream>>>(u, g, out, partials, r, ny, k, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

template <bool kRef>
int launch_elastic_block(const float* u, const float* g, float* out, float* partials,
                         float* sums, Rows r, int ny, int k, SorScalars s, cudaStream_t stream) {
  switch (elastic_plan_index(k)) {
    case 0:
      switch (k) {
        case 1: return launch_plan<1, 0, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
        case 2: return launch_plan<2, 0, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
        case 3: return launch_plan<3, 0, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
        case 4: return launch_plan<4, 0, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
        default: return launch_plan<0, 0, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
      }
    case 1: return launch_plan<0, 1, kRef>(u, g, out, partials, sums, r, ny, k, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);  // no plan fits
  }
}
static_assert(kElasticPlanCount == 2, "launch_elastic_block dispatches every plan");

int dispatch_elastic_block(const float* u, const float* g, float* out, float* partials,
                           float* sums, Rows r, int ny, int k, SorScalars s,
                           int reference_stencil, cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return reference_stencil
             ? launch_elastic_block<true>(u, g, out, partials, sums, r, ny, k, s, stream)
             : launch_elastic_block<false>(u, g, out, partials, sums, r, ny, k, s, stream);
}

}  // namespace

// Shared memory of one block on k's plan, or, where none fits, of the last
// plan (more than a block has).
extern "C" int of2d_elastic_block_smem_bytes(int k) {
  const int i = elastic_plan_index(k);
  return elastic_smem_bytes(k, kElasticPlans[i < 0 ? kElasticPlanCount - 1 : i]);
}

// Thread blocks (rows of the partials) of a launch over nx (or a strip's
// nxl) rows at k; 0 where no plan fits.
extern "C" int of2d_elastic_nblocks(int nx, int ny, int k) {
  const int i = elastic_plan_index(k);
  return i < 0 ? 0 : elastic_tiles(nx, ny, kElasticPlans[i].tx, kElasticPlans[i].ty);
}

// B6: u [2, nx, ny], g [3, nx, ny] -> out [2, nx, ny], sums [k, 2];
// partials [of2d_elastic_nblocks(nx, ny, k), k, 2] is scratch.
extern "C" int of2d_elastic_block(const float* u, const float* g, float* out, float* partials,
                                  float* sums, int nx, int ny, int k, float mu, float mpl,
                                  float omw, float inv_diag, int reference_stencil,
                                  cudaStream_t stream) {
  return dispatch_elastic_block(u, g, out, partials, sums, whole_image(nx), ny, k,
                                SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, stream);
}

// K2: u_pad [2, nxl + 2 pad, ny], g_pad [3, nxl + 2 pad, ny] of the strip
// whose first owned row is global row row0 of nx_glob -> out [2, nxl, ny]
// and the strip's sums [k, 2]; partials [of2d_elastic_nblocks(nxl, ny, k),
// k, 2] is scratch. Needs pad >= 2k.
extern "C" int of2d_elastic_block_strip(const float* u_pad, const float* g_pad, float* out,
                                        float* partials, float* sums, int nxl, int ny, int k,
                                        int pad, int row0, int nx_glob, float mu, float mpl,
                                        float omw, float inv_diag, int reference_stencil,
                                        cudaStream_t stream) {
  const Rows r{nxl, pad, row0, nx_glob};
  if (!strip_ok(r, 2 * k)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_elastic_block(u_pad, g_pad, out, partials, sums, r, ny, k,
                                SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, stream);
}
