// The reference's bilinear sample (src/Image.cpp:155-173,
// src/Motion.cpp:113-178), shared by the warp/compose gather and the demons
// kernels: a sample whose floor corner lies outside the grid is out of
// bounds; the (dx+1) and (dy+1) taps count only inside the grid, and the
// caller renormalizes by the included weight. Taps are read at clamped
// indices, which is exact for any displacement.
//
// Weights and sums in the order of the plain version
// (kernels/warp_fused.py::bilinear); with -fmad=false they round alike.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

struct Bilinear {
  float w00, w10, w01, w11, weight;
  size_t p00, p10, p01, p11;
  int dx, dy;  // the floor corner
  bool in_bounds;
};

// The sample of output pixel (i, j) displaced by (ux, uy) on an nx x ny grid.
__device__ __forceinline__ Bilinear bilinear_at(int i, int j, float ux, float uy, int nx,
                                                int ny) {
  Bilinear b;
  const float px = static_cast<float>(i) + ux;
  const float py = static_cast<float>(j) + uy;
  const float dxf = floorf(px), dyf = floorf(py);
  const float fx = px - dxf, fy = py - dyf;
  const int dx = static_cast<int>(dxf), dy = static_cast<int>(dyf);
  b.dx = dx;
  b.dy = dy;
  b.in_bounds = dx >= 0 && dx < nx && dy >= 0 && dy < ny;
  const bool has_x1 = dx < nx - 1, has_y1 = dy < ny - 1;
  b.w00 = (1.f - fx) * (1.f - fy);
  b.w10 = has_x1 ? fx * (1.f - fy) : 0.f;
  b.w01 = has_y1 ? (1.f - fx) * fy : 0.f;
  b.w11 = (has_x1 && has_y1) ? fx * fy : 0.f;
  b.weight = b.w00 + b.w10 + b.w01 + b.w11;
  // Clamped tap indices; (dx + 1) is formed only below nx - 1 so that it
  // cannot overflow.
  const int x0 = min(max(dx, 0), nx - 1);
  const int x1 = dx >= nx - 1 ? nx - 1 : max(dx + 1, 0);
  const int y0 = min(max(dy, 0), ny - 1);
  const int y1 = dy >= ny - 1 ? ny - 1 : max(dy + 1, 0);
  b.p00 = static_cast<size_t>(x0) * ny + y0;
  b.p10 = static_cast<size_t>(x1) * ny + y0;
  b.p01 = static_cast<size_t>(x0) * ny + y1;
  b.p11 = static_cast<size_t>(x1) * ny + y1;
  return b;
}

// The weighted tap sum of plane d, before renormalization.
__device__ __forceinline__ float bilinear_value(const float* __restrict__ d,
                                                const Bilinear& b) {
  return d[b.p00] * b.w00 + d[b.p10] * b.w10 + d[b.p01] * b.w01 + d[b.p11] * b.w11;
}

// The renormalized sample, or 0 where the weight vanishes (the compose's
// rule; the warp keeps the original pixel there instead).
__device__ __forceinline__ float bilinear_sample(const float* __restrict__ d,
                                                 const Bilinear& b) {
  return b.weight != 0.f ? bilinear_value(d, b) / b.weight : 0.f;
}

}  // namespace
