// The reference's bilinear sample (src/Image.cpp:155-173,
// src/Motion.cpp:113-178, src/Field.tpp:146-206), shared by the warp/compose
// gather, the demons kernels and the motion upsample (upsample.cu): a sample
// whose floor corner lies outside the grid is out of bounds; the (dx+1) and
// (dy+1) taps count only inside the grid, and the caller renormalizes by the
// included weight. Taps are read at clamped indices, which is exact for any
// displacement. bilinear_point takes the sample's coordinates, bilinear_at
// forms them from a pixel and its displacement.
//
// Weights and sums in the order of the plain version
// (kernels/warp_fused.py::bilinear); with -fmad=false they round alike.
//
// On a strip of the strip-parallel driver (rows.cuh) the taps are read from
// the pre-padded strip instead, under the strips' displacement contract
// (strip_taps), shared by the strip warp and compose (warp_gather.cu) and
// the demons strip kernels (demons_stages.cuh).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"

namespace {

struct Bilinear {
  float w00, w10, w01, w11, weight;
  size_t p00, p10, p01, p11;
  int dx, dy;  // the floor corner
  bool in_bounds;
};

// The sample at (px, py) on an nx x ny grid.
__device__ __forceinline__ Bilinear bilinear_point(float px, float py, int nx, int ny) {
  Bilinear b;
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

// The sample of output pixel (i, j) displaced by (ux, uy) on an nx x ny grid.
__device__ __forceinline__ Bilinear bilinear_at(int i, int j, float ux, float uy, int nx,
                                                int ny) {
  return bilinear_point(static_cast<float>(i) + ux, static_cast<float>(j) + uy, nx, ny);
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

// Move the taps of b, the sample of global pixel (gi, j), into the padded
// strip of rows r. False, and the sample's value is 0, where a floor offset
// rx = dx - gi or ry = dy - j lies outside [-halo, halo] (the contract of
// parallel/spatial.py::_bilinear_local, the jnp strip route of the TPU
// package, spatial.py:262-315), or where a tap row lies outside the padded
// strip (only for rows a kernel computes past the reach of the rows it owns).
__device__ __forceinline__ bool strip_taps(Bilinear& b, int gi, int j, const Rows& r, int ny,
                                           int halo) {
  const int rx = b.dx - gi, ry = b.dy - j;
  if (rx < -halo || rx > halo || ry < -halo || ry > halo) return false;
  const int lx = b.dx - r.row0;
  if (lx < -r.pad || lx + 1 >= r.nxl + r.pad) return false;
  const size_t x0 = r.in_row(lx, ny);
  const size_t x1 = x0 + ny;
  const int y0 = min(max(b.dy, 0), ny - 1);
  const int y1 = b.dy >= ny - 1 ? ny - 1 : max(b.dy + 1, 0);
  b.p00 = x0 + y0;
  b.p10 = x1 + y0;
  b.p01 = x0 + y1;
  b.p11 = x1 + y1;
  return true;
}

}  // namespace
