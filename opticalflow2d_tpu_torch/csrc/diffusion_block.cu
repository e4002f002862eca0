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
// Bound on this card: device-memory bandwidth. One step alone moves about
//   28 B per pixel (see diffusion_step.cu), with a handful of flops; a
//   strip also reads its 2 * pad halo rows of u and g.
// Design: each thread block owns a kTile x kTile output tile and loads it
//   with a halo of k cells on all four sides into shared memory: u (2
//   planes) and g = (gx, gy, It). It runs the k iterations there, with
//   __syncthreads() between them, and writes only the tile's interior: one
//   read of 5 planes (times the halo's overhead) and one write of 2 planes
//   per k iterations. Iteration s updates the extended tile shrunk by s+1
//   cells per side, the part whose neighbours are still exact, so the
//   interior equals k single steps.
// Strips (rows.cuh): a tile row at local index lr is read from padded row
//   lr + pad and has global index row0 + lr, which the border mask uses. A
//   strip's halo rows come from its pad and never from beyond it (pad >= k,
//   checked); rows past the pad load as 0 and their error reaches no owned
//   row within k steps. So the strips of an image, concatenated, equal B1
//   on the image bit for bit.
// Border: masked by global index. q is zero where gi == 0, gi == nx-1,
//   gj == 0 or gj == ny-1 (diffusion_block.py:63-66). Cells outside the
//   image load as 0 and are never updated nor read by an image cell, since
//   the border's q reads no neighbour. Ragged tiles need nothing else.
// Sums: for each iteration, sqrt(d0^2 + d1^2) of the step and of the
//   previous field over the tile's owned image cells, reduced in a fixed
//   order (thread, then warp shuffle tree, then warps in order) into
//   [nblocks, k, 2] partials; a second kernel adds the blocks in order
//   (partials.cuh). No float atomics, so the Logger error, and with it the
//   iteration count, is the same from run to run. A strip's sums are its
//   own; the driver adds the strips in order.
// Numerics: the Pallas kernel's order of operations, with -fmad=false, so
//   the interior rounds like k calls of diffusion_step_ref on the device.

#include <cuda_runtime.h>

#include <cstddef>

#include "partials.cuh"
#include "rows.cuh"

namespace {

constexpr int kTile = 32;       // interior tile, both axes
constexpr int kThreadsY = 32;   // along y, the contiguous axis: one warp a row
constexpr int kThreadsX = 8;    // warps per block
constexpr int kThreads = kThreadsX * kThreadsY;

// Shared floats: two buffers of u (2 planes each), g (3 planes), and the
// per-iteration warp partials [k][kThreadsX][2].
__host__ __device__ constexpr int smem_floats(int k) {
  return 7 * (kTile + 2 * k) * (kTile + 2 * k) + k * kThreadsX * 2;
}

__global__ void __launch_bounds__(kThreads)
diffusion_block_kernel(const float* __restrict__ u, const float* __restrict__ g,
                       float* __restrict__ out, float* __restrict__ partials, Rows r,
                       int ny, int k, float a2) {
  extern __shared__ float smem[];
  const int e = kTile + 2 * k;  // extended tile extent
  const int ee = e * e;
  float* cur = smem;
  float* nxt = cur + 2 * ee;
  float* gs = nxt + 2 * ee;
  float* red = gs + 3 * ee;

  const size_t n = r.in_plane(ny);
  const int i0 = blockIdx.y * kTile - k;  // local index of extended row 0
  const int j0 = blockIdx.x * kTile - k;
  const int ty = threadIdx.x, tx = threadIdx.y;  // lane along y, warp along x

  for (int li = tx; li < e; li += kThreadsX) {
    const bool row_ok = r.loadable(i0 + li);
    const size_t row = r.in_row(i0 + li, ny);
    for (int lj = ty; lj < e; lj += kThreadsY) {
      const int gj = j0 + lj;
      const int l = li * e + lj;
      float v0 = 0.f, v1 = 0.f, x = 0.f, y = 0.f, t = 0.f;
      if (row_ok && gj >= 0 && gj < ny) {
        const size_t p = row + gj;
        v0 = u[p];
        v1 = u[n + p];
        x = g[p];
        y = g[n + p];
        t = g[2 * n + p];
      }
      cur[l] = v0;
      cur[ee + l] = v1;
      gs[l] = x;
      gs[ee + l] = y;
      gs[2 * ee + l] = t;
    }
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    float dsum = 0.f, psum = 0.f;
    const int lo = s + 1, hi = e - s - 1;
    for (int li = lo + tx; li < hi; li += kThreadsX) {
      const int gi = r.row0 + i0 + li;
      if (gi < 0 || gi >= r.nx) continue;
      const bool interior_row = li >= k && li < k + kTile && i0 + li < r.nxl;
      for (int lj = lo + ty; lj < hi; lj += kThreadsY) {
        const int gj = j0 + lj;
        if (gj < 0 || gj >= ny) continue;
        const int l = li * e + lj;
        float q0 = 0.f, q1 = 0.f;
        if (gi > 0 && gi < r.nx - 1 && gj > 0 && gj < ny - 1) {
          const float* c1 = cur + ee;
          q0 = (cur[l - e] + cur[l + e] + (cur[l - 1] + cur[l + 1])) * 0.25f;
          q1 = (c1[l - e] + c1[l + e] + (c1[l - 1] + c1[l + 1])) * 0.25f;
        }
        const float x = gs[l], y = gs[ee + l];
        const float inner = gs[2 * ee + l] + q0 * x + q1 * y;
        const float den = a2 + x * x + y * y;
        const float scale = inner / den;
        const float n0 = q0 - x * scale;
        const float n1 = q1 - y * scale;
        nxt[l] = n0;
        nxt[ee + l] = n1;
        if (interior_row && lj >= k && lj < k + kTile) {
          const float p0 = cur[l], p1 = cur[ee + l];
          dsum += magnitude(n0 - p0, n1 - p1);
          psum += magnitude(p0, p1);
        }
      }
    }
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if (ty == 0) {
      red[(s * kThreadsX + tx) * 2] = dsum;
      red[(s * kThreadsX + tx) * 2 + 1] = psum;
    }
    __syncthreads();  // nxt is complete before anyone reads it as cur
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  const size_t n_out = r.out_plane(ny);
  for (int li = k + tx; li < k + kTile; li += kThreadsX) {
    const int lr = i0 + li;
    if (lr >= r.nxl) break;
    for (int lj = k + ty; lj < k + kTile; lj += kThreadsY) {
      const int gj = j0 + lj;
      if (gj >= ny) break;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      const int l = li * e + lj;
      out[p] = cur[l];
      out[n_out + p] = cur[ee + l];
    }
  }

  const int tid = tx * kThreadsY + ty;
  if (tid < 2 * k) {
    const int s = tid >> 1, c = tid & 1;
    float acc = 0.f;
    for (int w = 0; w < kThreadsX; ++w) acc += red[(s * kThreadsX + w) * 2 + c];
    const size_t bid = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    partials[bid * 2 * k + tid] = acc;
  }
}

dim3 tile_grid(int nx, int ny) {
  return dim3((ny + kTile - 1) / kTile, (nx + kTile - 1) / kTile);
}

int launch_diffusion_block(const float* u, const float* g, float* out, float* partials,
                           float* sums, Rows r, int ny, int k, float a2, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_floats(k) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      diffusion_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = tile_grid(r.nxl, ny);
  diffusion_block_kernel<<<grid, dim3(kThreadsY, kThreadsX), smem, stream>>>(
      u, g, out, partials, r, ny, k, a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k,
                             stream);
}

}  // namespace

extern "C" int of2d_diffusion_block_smem_bytes(int k) {
  return static_cast<int>(smem_floats(k) * sizeof(float));
}

// Thread blocks of a launch over nx (or a strip's nxl) rows: the rows of
// its partials.
extern "C" int of2d_diffusion_block_nblocks(int nx, int ny) {
  const dim3 grid = tile_grid(nx, ny);
  return static_cast<int>(grid.x * grid.y);
}

// B1: u [2, nx, ny], g [3, nx, ny] -> out [2, nx, ny], sums [k, 2];
// partials [nblocks, k, 2] is scratch.
extern "C" int of2d_diffusion_block(const float* u, const float* g, float* out,
                                    float* partials, float* sums, int nx, int ny,
                                    int k, float a2, cudaStream_t stream) {
  return launch_diffusion_block(u, g, out, partials, sums, whole_image(nx), ny, k, a2, stream);
}

// K1: u_pad [2, nxl + 2 pad, ny], g_pad [3, nxl + 2 pad, ny] of the strip
// whose first owned row is global row row0 of nx_glob -> out [2, nxl, ny]
// and the strip's sums [k, 2]; partials [nblocks(nxl, ny), k, 2] is
// scratch. Needs pad >= k.
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
