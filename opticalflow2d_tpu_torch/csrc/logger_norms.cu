// The reference Logger's norm pair on Hopper (sm_90a):
// sums = [sum |u_new - u_prev|, sum |u_prev|] over per-pixel magnitudes of
// two [2, nx, ny] motion fields (src/Logger.cpp:30-60 tracks their ratio).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/logger_norms.py,
//   logger_norms_pallas (:178).
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

#include <cuda_runtime.h>

#include <cstddef>

#include "partials.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
logger_norms_kernel(const float* __restrict__ u_new, const float* __restrict__ u_prev,
                    float* __restrict__ partials, size_t n) {
  __shared__ float red[2 * kThreads / 32];
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
  block_sum_pair<kThreads / 32>(dsum, psum, threadIdx.x, red,
                                partials + 2 * static_cast<size_t>(blockIdx.x));
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
  logger_norms_kernel<<<nblocks, kThreads, 0, stream>>>(u_new, u_prev, partials, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, nblocks, 2, stream);
}
