// Temporal-blocked elastic registration on Hopper (sm_90a): k elastic
// iterations (the pointwise L-SSD force, then a red and a black SOR
// half-sweep of the Navier-Lame system) per pass over device memory, with
// the reference Logger's per-iteration sums.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/elastic_block.py,
//   elastic_block_pallas (the TPU kernel, :206).
// Bound on this card: device-memory bandwidth. A pass reads u (2 planes)
//   and g = (gx, gy, It) (3 planes) and writes u: 28 B per pixel for k
//   iterations of about 50 flops each.
// Design: each thread block owns a kSorTile x kSorTile output tile and
//   loads it with a halo of 2k cells on every side into shared memory:
//   u twice (ping-pong) and g. Each iteration's dependence cone grows two
//   cells, one per half-sweep (the force is pointwise), so iteration s
//   sweeps the extended tile shrunk by 2s+1 cells (red) and 2s+2 cells
//   (black) per side, and the interior equals k single steps. The red
//   half reads one buffer and writes the other, the black half writes it
//   back (sor_stages.cuh): no half-sweep updates in place. The force at a
//   cell is computed from the half's input: the black cells are untouched
//   by the red half, so both halves see the iteration's starting field.
// Border: updates only at global interior cells (1 <= i <= nx-2,
//   1 <= j <= ny-2). Cells outside the image load as 0, keep their value
//   and are read by no image cell. Ragged tiles need nothing else.
// Sums: for each iteration, |u_t - u_{t-1}| and |u_{t-1}| over the tile's
//   image cells, reduced in a fixed order (thread, warp shuffle tree,
//   warps in order) into [nblocks, k, 2] partials; a second kernel adds
//   the blocks in order (partials.cuh). No float atomics, so the Logger
//   error, and with it the iteration count, repeats exactly.
// Numerics: the plain version's order of operations, with -fmad=false, so
//   the interior rounds like k calls of solvers/elastic.py::elastic_step.

#include <cuda_runtime.h>

#include <cstddef>

#include "partials.cuh"
#include "sor_stages.cuh"

namespace {

// Shared floats: two buffers of u (2 planes each), g (3 planes), and the
// per-iteration warp partials [k][kSorThreadsX][2].
__host__ __device__ constexpr int elastic_smem_floats(int k) {
  return 7 * (kSorTile + 4 * k) * (kSorTile + 4 * k) + k * kSorThreadsX * 2;
}

template <bool kRefStencil>
__global__ void __launch_bounds__(kSorThreads)
elastic_block_kernel(const float* __restrict__ u, const float* __restrict__ g,
                     float* __restrict__ out, float* __restrict__ partials, int nx, int ny,
                     int k, SorScalars s) {
  extern __shared__ float smem[];
  const int h = 2 * k;              // halo
  const int e = kSorTile + 2 * h;   // extended tile extent
  const int ee = e * e;
  float* cur = smem;
  float* nxt = cur + 2 * ee;
  float* gs = nxt + 2 * ee;
  float* red = gs + 3 * ee;
  const int gi0 = blockIdx.y * kSorTile - h;  // global index of extended row 0
  const int gj0 = blockIdx.x * kSorTile - h;

  load_tile(u, cur, 2, nx, ny, gi0, gj0, e);
  load_tile(g, gs, 3, nx, ny, gi0, gj0, e);
  __syncthreads();

  const int ty = threadIdx.x, tx = threadIdx.y;  // lane along y, warp along x
  for (int t = 0; t < k; ++t) {
    float dsum = 0.f, psum = 0.f;
    sor_half_sweep<kRefStencil, false>(cur, nxt, cur, gs, e, 2 * t + 1, e - 2 * t - 1, gi0,
                                       gj0, nx, ny, 0, s, 0, 0, dsum, psum);
    __syncthreads();
    sor_half_sweep<kRefStencil, true>(nxt, cur, nxt, gs, e, 2 * t + 2, e - 2 * t - 2, gi0,
                                      gj0, nx, ny, 1, s, h, h + kSorTile, dsum, psum);
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if (ty == 0) {
      red[(t * kSorThreadsX + tx) * 2] = dsum;
      red[(t * kSorThreadsX + tx) * 2 + 1] = psum;
    }
    __syncthreads();  // cur is complete before the next red half reads it
  }

  const size_t n = static_cast<size_t>(nx) * ny;
  for (int li = h + tx; li < h + kSorTile; li += kSorThreadsX) {
    const int gi = gi0 + li;
    if (gi >= nx) break;
    for (int lj = h + ty; lj < h + kSorTile; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      if (gj >= ny) break;
      const size_t p = static_cast<size_t>(gi) * ny + gj;
      const int l = li * e + lj;
      out[p] = cur[l];
      out[n + p] = cur[ee + l];
    }
  }

  const int tid = tx * kSorThreadsY + ty;
  if (tid < 2 * k) {
    const int t = tid >> 1, c = tid & 1;
    float acc = 0.f;
    for (int w = 0; w < kSorThreadsX; ++w) acc += red[(t * kSorThreadsX + w) * 2 + c];
    const size_t bid = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    partials[bid * 2 * k + tid] = acc;
  }
}

template <bool kRefStencil>
int launch_elastic_block(const float* u, const float* g, float* out, float* partials,
                         float* sums, int nx, int ny, int k, SorScalars s,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(elastic_smem_floats(k) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(elastic_block_kernel<kRefStencil>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sor_tiles(ny), sor_tiles(nx));
  elastic_block_kernel<kRefStencil><<<grid, dim3(kSorThreadsY, kSorThreadsX), smem, stream>>>(
      u, g, out, partials, nx, ny, k, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

}  // namespace

extern "C" int of2d_elastic_block_smem_bytes(int k) {
  return static_cast<int>(elastic_smem_floats(k) * sizeof(float));
}

extern "C" int of2d_sor_nblocks(int nx, int ny) { return sor_tiles(nx) * sor_tiles(ny); }

// u [2, nx, ny], g [3, nx, ny] -> out [2, nx, ny], sums [k, 2];
// partials [nblocks, k, 2] is scratch.
extern "C" int of2d_elastic_block(const float* u, const float* g, float* out, float* partials,
                                  float* sums, int nx, int ny, int k, float mu, float mpl,
                                  float omw, float inv_diag, int reference_stencil,
                                  cudaStream_t stream) {
  const SorScalars s{mu, mpl, omw, inv_diag};
  return reference_stencil
             ? launch_elastic_block<true>(u, g, out, partials, sums, nx, ny, k, s, stream)
             : launch_elastic_block<false>(u, g, out, partials, sums, nx, ny, k, s, stream);
}
