// The reference Logger's norm pair on Hopper (sm_90a):
// sums = [sum |u_new - u_prev|, sum |u_prev|] over per-pixel magnitudes of
// two [2, nx, ny] motion fields (src/Logger.cpp:30-60 tracks their ratio).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/logger_norms.py,
//   logger_norms_pallas (:178). of2d_logger_norms_batch takes the listed
//   pairs of two stacks in one launch (the grid's y axis; the lockstep
//   batch driver's curvature passes, parallel/batch.py).
// Bound on this card: device-memory bandwidth. It reads the two fields once
//   (16 B per pixel) and writes 8 bytes: at 4096^2, 268 MB, or 0.080 ms at
//   3.35 TB/s. Two square roots per pixel are far below the compute peak.
// Design: each thread block owns a contiguous chunk of kChunk pixels; its
//   threads stride through it so that neighbouring threads read neighbouring
//   addresses, keep their two sums in registers, and the block reduces them
//   in a fixed order into one row of [nblocks, 2] partials. A second kernel
//   adds the rows in block order (partials.cuh). No float atomics, so the
//   Logger error, and with it the stop, repeats exactly. Any pixel count:
//   the last chunk is masked, so unlike the TPU kernel nx need not be a
//   multiple of 8.
// Numerics: sqrt(d0*d0 + d1*d1) as in logger_norms_ref; the sums are added
//   in another order than PyTorch's, so they agree to rounding (1e-5
//   relative), not bit for bit.

// The fluid metrics (B5) in the same pass: the Logger pair and
// min(jacobian_det(u_new)) over the image, for the fluid loop's regrid
// test (src/Image.cpp:189-218).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/logger_norms.py,
//   fluid_metrics_pallas (:129).
// Bound on this card: device-memory bandwidth, as the pair: 16 B per pixel
//   read. The determinant's four one-sided or central differences read the
//   neighbouring rows and columns of u_new again, from the caches.
// Design: the chunks of the pair kernel; each thread also takes the minimum
//   determinant of its pixels, the block reduces it, and a second kernel
//   takes the minimum over the blocks (exact in any order) after the sums
//   are added in block order as above.
// Numerics: the determinant is ops/grid.py::jacobian_det's expression in
//   its order, with -fmad=false, so the minimum equals the plain one.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "partials.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;

// kBatch (B4 batched): blockIdx.y is a position in the list ``pairs``, the
// two fields of pair pairs[y] start 2 planes a pair in (64-bit offsets),
// and its partials rows follow the earlier positions' (partials.cuh); a
// single launch compiles without it.
template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
logger_norms_kernel(const float* __restrict__ u_new, const float* __restrict__ u_prev,
                    float* __restrict__ partials, size_t n, const int* __restrict__ pairs) {
  __shared__ float red[2 * kThreads / 32];
  if (kBatch) {
    const size_t pair = static_cast<size_t>(pairs[blockIdx.y]);
    u_new += pair * 2 * n;
    u_prev += pair * 2 * n;
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * kChunk;
  float dsum = 0.f, psum = 0.f;
#pragma unroll 4
  for (int r = 0; r < kPerThread; ++r) {
    const size_t p = base + static_cast<size_t>(r) * kThreads + threadIdx.x;
    if (p < n) {
      const float b0 = u_prev[p], b1 = u_prev[n + p];
      dsum += magnitude(u_new[p] - b0, u_new[n + p] - b1);
      psum += magnitude(b0, b1);
    }
  }
  const size_t row = kBatch ? static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x
                            : static_cast<size_t>(blockIdx.x);
  block_sum_pair<kThreads / 32>(dsum, psum, threadIdx.x, red, partials + 2 * row);
}

// d/dx of plane f at pixel p = (gi, gj): central inside, one-sided at the
// global border (ops/grid.py::partial_x); ``step`` is the pixel stride
// along the axis (ny along x, 1 along y).
__device__ __forceinline__ float border_diff(const float* f, size_t p, size_t step, int g,
                                             int n) {
  if (g == 0) return f[p + step] - f[p];
  if (g == n - 1) return f[p] - f[p - step];
  return (f[p + step] - f[p - step]) * 0.5f;
}

__global__ void __launch_bounds__(kThreads)
fluid_metrics_kernel(const float* __restrict__ u_new, const float* __restrict__ u_prev,
                     float* __restrict__ partials, float* __restrict__ jac_partials, int nx,
                     int ny) {
  __shared__ float red[2 * kThreads / 32];
  __shared__ float mins[kThreads / 32];
  const size_t n = static_cast<size_t>(nx) * ny;
  const float* a0 = u_new;
  const float* a1 = u_new + n;
  const size_t base = static_cast<size_t>(blockIdx.x) * kChunk;
  float dsum = 0.f, psum = 0.f, jmin = INFINITY;
#pragma unroll 4
  for (int r = 0; r < kPerThread; ++r) {
    const size_t p = base + static_cast<size_t>(r) * kThreads + threadIdx.x;
    if (p < n) {
      const float b0 = u_prev[p], b1 = u_prev[n + p];
      dsum += magnitude(a0[p] - b0, a1[p] - b1);
      psum += magnitude(b0, b1);
      const int gi = static_cast<int>(p / ny);
      const int gj = static_cast<int>(p - static_cast<size_t>(gi) * ny);
      const float duxdx = border_diff(a0, p, ny, gi, nx);
      const float duydx = border_diff(a1, p, ny, gi, nx);
      const float duxdy = border_diff(a0, p, 1, gj, ny);
      const float duydy = border_diff(a1, p, 1, gj, ny);
      jmin = fminf(jmin, (1.f + duxdx) * (1.f + duydy) - duydx * duxdy);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    jmin = fminf(jmin, __shfl_down_sync(0xffffffffu, jmin, off));
  if ((threadIdx.x & 31) == 0) mins[threadIdx.x >> 5] = jmin;
  block_sum_pair<kThreads / 32>(dsum, psum, threadIdx.x, red,
                                partials + 2 * static_cast<size_t>(blockIdx.x));
  if (threadIdx.x == 0) {  // block_sum_pair synchronised the block
    for (int w = 1; w < kThreads / 32; ++w) jmin = fminf(jmin, mins[w]);
    jac_partials[blockIdx.x] = jmin;
  }
}

// *out = min over the blocks' partials.
__global__ void __launch_bounds__(kSumThreads)
min_partials_kernel(const float* __restrict__ partials, float* __restrict__ out, int nblocks) {
  __shared__ float warps[kSumThreads / 32];
  float m = INFINITY;
  for (int b = threadIdx.x; b < nblocks; b += kSumThreads) m = fminf(m, partials[b]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / 32; ++w) m = fminf(m, warps[w]);
    *out = m;
  }
}

}  // namespace

extern "C" int of2d_logger_norms_nblocks(int nx, int ny) {
  const size_t n = static_cast<size_t>(nx) * ny;
  return static_cast<int>((n + kChunk - 1) / kChunk);
}

// u_new, u_prev [2, nx, ny] -> sums [2]; partials [nblocks, 2] is scratch.
extern "C" int of2d_logger_norms(const float* u_new, const float* u_prev, float* partials,
                                 float* sums, int nx, int ny, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(nx) * ny;
  const int nblocks = of2d_logger_norms_nblocks(nx, ny);
  logger_norms_kernel<false><<<nblocks, kThreads, 0, stream>>>(u_new, u_prev, partials, n,
                                                               nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, nblocks, 2, stream);
}

// B4 batched: u_new, u_prev [B, 2, nx, ny] -> sums [n_pairs, 2] of the pairs
// listed in pairs (device int32, each in [0, B)), in list order; partials
// [n_pairs, nblocks, 2] is scratch. Each pair's sums equal its own
// of2d_logger_norms's.
extern "C" int of2d_logger_norms_batch(const float* u_new, const float* u_prev,
                                       float* partials, float* sums, const int* pairs,
                                       int n_pairs, int nx, int ny, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(nx) * ny;
  const int nblocks = of2d_logger_norms_nblocks(nx, ny);
  logger_norms_kernel<true><<<dim3(nblocks, n_pairs), kThreads, 0, stream>>>(
      u_new, u_prev, partials, n, pairs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, nblocks, 2, stream, n_pairs);
}

// u_new, u_prev [2, nx, ny] -> out [3] = (sum |u_new - u_prev|, sum |u_prev|,
// min jacobian_det(u_new)); partials [nblocks, 3] is scratch. nx, ny >= 2.
extern "C" int of2d_fluid_metrics(const float* u_new, const float* u_prev, float* partials,
                                  float* out, int nx, int ny, cudaStream_t stream) {
  const int nblocks = of2d_logger_norms_nblocks(nx, ny);
  float* jac_partials = partials + 2 * static_cast<size_t>(nblocks);
  fluid_metrics_kernel<<<nblocks, kThreads, 0, stream>>>(u_new, u_prev, partials, jac_partials,
                                                         nx, ny);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_sum_partials(partials, out, nblocks, 2, stream);
  if (rc != 0) return rc;
  min_partials_kernel<<<1, kSumThreads, 0, stream>>>(jac_partials, out + 2, nblocks);
  return static_cast<int>(cudaGetLastError());
}
