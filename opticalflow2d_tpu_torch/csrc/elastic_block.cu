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
// Strips (rows.cuh): tile rows are read from the padded strip and masked
//   and coloured by global row, (row0 + li + gj) % 2; the cone of 2k rows
//   stays inside the pad. The strips of an image, concatenated, equal B6
//   on the image bit for bit; a strip's sums are its own.
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
                     float* __restrict__ out, float* __restrict__ partials, Rows r, int ny,
                     int k, SorScalars s) {
  extern __shared__ float smem[];
  const int h = 2 * k;              // halo
  const int e = kSorTile + 2 * h;   // extended tile extent
  const int ee = e * e;
  float* cur = smem;
  float* nxt = cur + 2 * ee;
  float* gs = nxt + 2 * ee;
  float* red = gs + 3 * ee;
  const int li0 = blockIdx.y * kSorTile - h;  // local index of extended row 0
  const int gi0 = r.row0 + li0;                // and its global index
  const int gj0 = blockIdx.x * kSorTile - h;
  const int gi_end = r.row0 + r.nxl;

  load_tile(u, cur, 2, r, ny, li0, gj0, e);
  load_tile(g, gs, 3, r, ny, li0, gj0, e);
  __syncthreads();

  const int ty = threadIdx.x, tx = threadIdx.y;  // lane along y, warp along x
  for (int t = 0; t < k; ++t) {
    float dsum = 0.f, psum = 0.f;
    sor_half_sweep<kRefStencil, false>(cur, nxt, cur, gs, e, 2 * t + 1, e - 2 * t - 1, gi0,
                                       gj0, r.nx, ny, 0, s, 0, 0, gi_end, dsum, psum);
    __syncthreads();
    sor_half_sweep<kRefStencil, true>(nxt, cur, nxt, gs, e, 2 * t + 2, e - 2 * t - 2, gi0,
                                      gj0, r.nx, ny, 1, s, h, h + kSorTile, gi_end, dsum, psum);
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if (ty == 0) {
      red[(t * kSorThreadsX + tx) * 2] = dsum;
      red[(t * kSorThreadsX + tx) * 2 + 1] = psum;
    }
    __syncthreads();  // cur is complete before the next red half reads it
  }

  const size_t n = r.out_plane(ny);
  for (int li = h + tx; li < h + kSorTile; li += kSorThreadsX) {
    const int lr = li0 + li;
    if (lr >= r.nxl) break;
    for (int lj = h + ty; lj < h + kSorTile; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      if (gj >= ny) break;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
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
                         float* sums, Rows r, int ny, int k, SorScalars s,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(elastic_smem_floats(k) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(elastic_block_kernel<kRefStencil>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sor_tiles(ny), sor_tiles(r.nxl));
  elastic_block_kernel<kRefStencil><<<grid, dim3(kSorThreadsY, kSorThreadsX), smem, stream>>>(
      u, g, out, partials, r, ny, k, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

int dispatch_elastic_block(const float* u, const float* g, float* out, float* partials,
                           float* sums, Rows r, int ny, int k, SorScalars s,
                           int reference_stencil, cudaStream_t stream) {
  return reference_stencil
             ? launch_elastic_block<true>(u, g, out, partials, sums, r, ny, k, s, stream)
             : launch_elastic_block<false>(u, g, out, partials, sums, r, ny, k, s, stream);
}

}  // namespace

extern "C" int of2d_elastic_block_smem_bytes(int k) {
  return static_cast<int>(elastic_smem_floats(k) * sizeof(float));
}

// Thread blocks of a launch over nx (or a strip's nxl) rows.
extern "C" int of2d_sor_nblocks(int nx, int ny) { return sor_tiles(nx) * sor_tiles(ny); }

// B6: u [2, nx, ny], g [3, nx, ny] -> out [2, nx, ny], sums [k, 2];
// partials [nblocks, k, 2] is scratch.
extern "C" int of2d_elastic_block(const float* u, const float* g, float* out, float* partials,
                                  float* sums, int nx, int ny, int k, float mu, float mpl,
                                  float omw, float inv_diag, int reference_stencil,
                                  cudaStream_t stream) {
  return dispatch_elastic_block(u, g, out, partials, sums, whole_image(nx), ny, k,
                                SorScalars{mu, mpl, omw, inv_diag}, reference_stencil, stream);
}

// K2: u_pad [2, nxl + 2 pad, ny], g_pad [3, nxl + 2 pad, ny] of the strip
// whose first owned row is global row row0 of nx_glob -> out [2, nxl, ny]
// and the strip's sums [k, 2]; partials [nblocks(nxl, ny), k, 2] is
// scratch. Needs pad >= 2k.
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
