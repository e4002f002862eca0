// Fixed-order sums shared by the kernels that emit the reference Logger's
// magnitude sums (diffusion_block.cu, demons_onepass.cu, logger_norms.cu).
//
// Each thread block reduces its values in a fixed order (the thread's own
// loop order, a warp shuffle tree, then the warps in index order) into one
// row of a [nblocks, nout] partials array; sum_partials_kernel then adds
// the rows in block order. No float atomics, so a sum, and with it the
// Logger error and the iteration count, is the same from run to run.
//
// A batched launch (the pair axis of the lockstep batch driver) lays its
// partials out [group][nblocks][nout], one group per pair in launch order,
// and sums each group on its own: the order depends on nblocks alone, so a
// pair's sums equal its single-pair launch's bit for bit wherever it sits
// in the launch.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSumThreads = 256;
// The most pairs one batched launch takes: a grid's y and z extents.
constexpr int kMaxPairs = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float magnitude(float a, float b) { return sqrtf(a * a + b * b); }

// Block sum of the pair (a, b) over kWarps warps, written to out[0..1] by
// thread 0. ``tid`` is the linear thread index (warp w holds tids 32w..);
// ``red`` is shared scratch of 2 * kWarps floats.
template <int kWarps>
__device__ __forceinline__ void block_sum_pair(float a, float b, int tid, float* red,
                                               float* out) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((tid & 31) == 0) {
    red[2 * (tid >> 5)] = a;
    red[2 * (tid >> 5) + 1] = b;
  }
  __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sa += red[2 * w];
      sb += red[2 * w + 1];
    }
    out[0] = sa;
    out[1] = sb;
  }
}

// sums[g][o] = sum over blocks b, in a fixed order, of partials[g][b][o];
// one thread block per output o in [0, nout) (blockIdx.x) of group g
// (blockIdx.y).
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                    int nblocks, int nout) {
  __shared__ float warps[kSumThreads / 32];
  const int o = blockIdx.x;
  partials += static_cast<size_t>(blockIdx.y) * nblocks * nout;
  sums += static_cast<size_t>(blockIdx.y) * nout;
  float acc = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kSumThreads)
    acc += partials[static_cast<size_t>(b) * nout + o];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kSumThreads / 32; ++w) total += warps[w];
    sums[o] = total;
  }
}

inline int launch_sum_partials(const float* partials, float* sums, int nblocks, int nout,
                               cudaStream_t stream, int groups = 1) {
  sum_partials_kernel<<<dim3(nout, groups), kSumThreads, 0, stream>>>(partials, sums, nblocks,
                                                                       nout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
