// Variants of csrc/upsample.cu for probes/upsample_sweep.py: points a thread
// along a row (kVec), rows a thread (kRows, consecutive, so that a column's
// y-part is formed once for them), the block's shape (kTY threads along y,
// kTX along x), 32- or 64-bit offsets, and what a thread does (kMode: 0 the
// kernel's arithmetic, 1 stores only, 2 the taps without the division).
// Mode 0 rounds as csrc/upsample.cu does: bilinear.cuh's taps and weights
// in its order, then / weight * s_c.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "bilinear.cuh"

namespace {

template <typename Off>
struct Taps {
  float w00, w10, w01, w11, weight;
  Off p00, p10, p01, p11;
};

// bilinear.cuh::bilinear_point with offsets of type Off.
template <typename Off>
__device__ __forceinline__ Taps<Off> taps_at(float px, float py, int nx, int ny) {
  const Bilinear b = bilinear_point(px, py, nx, ny);
  Taps<Off> t{b.w00, b.w10, b.w01, b.w11, b.weight};
  if constexpr (std::is_same_v<Off, size_t>) {
    t.p00 = b.p00; t.p10 = b.p10; t.p01 = b.p01; t.p11 = b.p11;
  } else {
    const int x0 = min(max(b.dx, 0), nx - 1);
    const int x1 = b.dx >= nx - 1 ? nx - 1 : max(b.dx + 1, 0);
    const int y0 = min(max(b.dy, 0), ny - 1);
    const int y1 = b.dy >= ny - 1 ? ny - 1 : max(b.dy + 1, 0);
    t.p00 = static_cast<Off>(x0) * ny + y0;
    t.p10 = static_cast<Off>(x1) * ny + y0;
    t.p01 = static_cast<Off>(x0) * ny + y1;
    t.p11 = static_cast<Off>(x1) * ny + y1;
  }
  return t;
}

template <typename Off>
__device__ __forceinline__ float value_at(const float* __restrict__ d, const Taps<Off>& t) {
  return d[t.p00] * t.w00 + d[t.p10] * t.w10 + d[t.p01] * t.w01 + d[t.p11] * t.w11;
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (kVec == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}

template <int kVec, int kRows, int kTY, int kTX, int kMode, bool kI32>
__global__ void __launch_bounds__(kTY * kTX)
upsample_variant(const float* __restrict__ src, float* __restrict__ out, int nx_in, int ny_in,
                 int nx_out, int ny_out, float rx, float ry, float sx, float sy) {
  using Off = std::conditional_t<kI32, unsigned, size_t>;
  const int j0 = (blockIdx.x * kTY + threadIdx.x) * kVec;
  const int i0 = (blockIdx.y * kTX + threadIdx.y) * kRows;
  if (j0 >= ny_out) return;
  const Off n_in = static_cast<Off>(nx_in) * ny_in;
  const Off n_out = static_cast<Off>(nx_out) * ny_out;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= nx_out) return;
    const float px = static_cast<float>(i) * rx;
    float vx[kVec], vy[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if constexpr (kMode == 1) {
        vx[k] = px * sx;
        vy[k] = px * sy;
      } else {
        const Taps<Off> t = taps_at<Off>(px, static_cast<float>(j0 + k) * ry, nx_in, ny_in);
        if constexpr (kMode == 2) {
          vx[k] = value_at(src, t) * sx;
          vy[k] = value_at(src + n_in, t) * sy;
        } else {
          const float weight = t.weight != 0.f ? t.weight : 1.f;
          vx[k] = value_at(src, t) / weight * sx;
          vy[k] = value_at(src + n_in, t) / weight * sy;
        }
      }
    }
    const Off p = static_cast<Off>(i) * ny_out + j0;
    store<kVec>(out + p, vx);
    store<kVec>(out + n_out + p, vy);
  }
}

template <int kVec, int kRows, int kTY, int kTX, int kMode, bool kI32>
int launch_variant(const float* src, float* out, int nx_in, int ny_in, int nx_out, int ny_out,
                   float rx, float ry, float sx, float sy, cudaStream_t stream) {
  const dim3 block(kTY, kTX);
  const dim3 grid((ny_out + kTY * kVec - 1) / (kTY * kVec),
                  (nx_out + kTX * kRows - 1) / (kTX * kRows));
  upsample_variant<kVec, kRows, kTY, kTX, kMode, kI32><<<grid, block, 0, stream>>>(
      src, out, nx_in, ny_in, nx_out, ny_out, rx, ry, sx, sy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
