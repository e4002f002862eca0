// Bilinear backward warp and motion composition by direct gather on Hopper
// (sm_90a).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/warp_fused.py, _run_gather
//   (:173), reached through warp2d_pallas (:249) and compose_pallas (:257).
// Bound on this card: device-memory bandwidth. Per pixel the warp reads u
//   (8 B), four taps and the original (up to 20 B, mostly cache hits for
//   smooth motion) and writes 4 B; the compose does the same for two
//   channels.
// Design: one thread per output pixel reads its four taps at clamped
//   indices (bilinear.cuh). Hopper has a hardware gather, so the TPU
//   kernel's halo-bounded roll chain (and its exact-gather fallback) has no
//   counterpart: the gather is exact for any displacement. One templated
//   body serves both operations: 1 channel with passthrough of the image,
//   or 2 channels with the increment added (warp_fused.py:161-170).
// Numerics: weights and sums in the order of ops/warp.py:95-114, with
//   -fmad=false, so the result rounds like warp2d_ref / compose_ref on the
//   same device.

#include <cuda_runtime.h>

#include <cstddef>

#include "bilinear.cuh"

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 8;

// kCompose = false: data is the image [nx, ny]; out-of-bounds samples and
//   samples of zero weight keep the image value.
// kCompose = true: data is u_total [2, nx, ny]; in bounds the result is
//   u_inc + u_total(x + u_inc) (u_inc alone where the weight is 0), out of
//   bounds the old u_total.
template <int kChannels, bool kCompose>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gather_kernel(const float* __restrict__ data, const float* __restrict__ u,
              float* __restrict__ out, int nx, int ny) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t n = static_cast<size_t>(nx) * ny;
  const size_t p = static_cast<size_t>(i) * ny + j;
  const float ux = u[p], uy = u[n + p];
  const Bilinear b = bilinear_at(i, j, ux, uy, nx, ny);
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float* d = data + c * n;
    if (kCompose) {
      const float inc = c == 0 ? ux : uy;
      out[c * n + p] = b.in_bounds ? inc + bilinear_sample(d, b) : d[p];
    } else {
      out[p] = (b.in_bounds && b.weight != 0.f) ? bilinear_value(d, b) / b.weight : d[p];
    }
  }
}

template <int kChannels, bool kCompose>
int launch(const float* data, const float* u, float* out, int nx, int ny,
           cudaStream_t stream) {
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (nx + kThreadsX - 1) / kThreadsX);
  gather_kernel<kChannels, kCompose><<<grid, block, 0, stream>>>(data, u, out, nx, ny);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int of2d_warp2d(const float* image, const float* u, float* out, int nx,
                           int ny, cudaStream_t stream) {
  return launch<1, false>(image, u, out, nx, ny, stream);
}

extern "C" int of2d_compose(const float* u_total, const float* u_inc, float* out,
                            int nx, int ny, cudaStream_t stream) {
  return launch<2, true>(u_total, u_inc, out, nx, ny, stream);
}
