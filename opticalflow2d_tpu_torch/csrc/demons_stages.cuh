// The stages of one demons iteration on a 2D tile in shared memory, shared
// by demons_onepass.cu (B10: all of them) and demons_fused.cu (B11: warp
// to smoothed correspondence; B12: accumulate and smooth).
//
// A thread block owns a kTile x kTile output tile. Each stage reads a
// region of the tile extended by the reach of the stages after it and
// writes a smaller one: every buffer is two planes (x, y channels) of
// rows x cols floats, row-major, whose cell (0, 0) is a known global
// (gi, gj). Cells outside the image hold 0 and are never read by a cell
// inside it: the gradient is one-sided at the image border and every
// smoothing tap is masked by its global index, as the plain versions
// zero-pad. So ragged tiles need no special case.
//
// Numerics: each stage repeats its plain version's float expressions in
// the same order (solvers/base.py::demons_force, ops/conv.py::
// convolve2d_clip, kernels/warp_fused.py), and the library is built with
// -fmad=false, so the fields round like the plain versions on the card.
//
// Rows (rows.cuh): the stages work in global coordinates and touch device
// memory only through r. The dense kernels pass whole_image(nx). The strip
// kernels (kStrip) pass a strip of the strip-parallel driver, its inputs
// pre-padded with r.pad halo rows a side: a cell is read from padded row
// gi - row0 + pad, output row gi - row0 is written, and a gather takes its
// taps from the padded strip under the strips' displacement contract
// (bilinear.cuh::strip_taps), else its value is 0. A cell whose row the
// padded strip does not hold is 0 like one outside the image; it feeds only
// rows past the strip's own, which are not written.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "bilinear.cuh"
#include "partials.cuh"
#include "rows.cuh"

namespace {

constexpr int kTile = 32;       // output tile, both axes
constexpr int kThreadsY = 32;   // lanes along y, the contiguous axis
constexpr int kThreadsX = 8;    // warps, along x
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxTaps = 64;

// Gaussian taps, passed by value as a kernel parameter.
struct Taps {
  float w[kMaxTaps];
};

__device__ __forceinline__ bool inside(int g, int n) { return g >= 0 && g <= n - 1; }

// Sum of the taps whose source index g + t - c lies in [0, n): the
// renormalization denominator along one axis, added in tap order.
__device__ __forceinline__ float tap_weight(int g, int n, const Taps& taps, int k) {
  const int c = k / 2;
  float acc = inside(g - c, n) ? taps.w[0] : 0.f;
  for (int t = 1; t < k; ++t) acc += inside(g + t - c, n) ? taps.w[t] : 0.f;
  return acc;
}

// Masked tap sum along one axis: src[t * stride] * taps[t] for the taps
// whose source index g + t - c lies in [0, n), in tap order.
__device__ __forceinline__ float tap_sum(const float* src, int stride, int g, int n,
                                         const Taps& taps, int k) {
  const int c = k / 2;
  float acc = inside(g - c, n) ? src[0] * taps.w[0] : 0.f;
  for (int t = 1; t < k; ++t)
    acc += inside(g + t - c, n) ? src[t * stride] * taps.w[t] : 0.f;
  return acc;
}

// Stage 1: the warped moving image and the reference on the e x e region
// at global (gi0, gj0): iwar = iaux(x + u(x)), the original pixel where
// the sample is out of bounds or of zero weight (warp2d_ref; on a strip
// warp2d_strip_ref).
template <bool kStrip>
__device__ void stage_warp(const float* __restrict__ iaux, const float* __restrict__ iref,
                           const float* __restrict__ u, const Rows& r, int ny, int halo,
                           int gi0, int gj0, int e, float* iwar_s, float* iref_s) {
  const size_t n = r.in_plane(ny);
  for (int li = threadIdx.y; li < e; li += kThreadsX) {
    const int gi = gi0 + li;
    const bool row_in = r.loadable(gi - r.row0);
    for (int lj = threadIdx.x; lj < e; lj += kThreadsY) {
      const int gj = gj0 + lj;
      float w = 0.f, ref = 0.f;
      if (row_in && inside(gj, ny)) {
        const size_t p = r.in_row(gi - r.row0, ny) + gj;
        Bilinear b = bilinear_at(gi, gj, u[p], u[n + p], r.nx, ny);
        const bool taps = kStrip ? strip_taps(b, gi, gj, r, ny, halo) : true;
        const float value = taps ? bilinear_value(iaux, b) : 0.f;
        w = (b.in_bounds && b.weight != 0.f) ? value / b.weight : iaux[p];
        ref = iref[p];
      }
      iwar_s[li * e + lj] = w;
      iref_s[li * e + lj] = ref;
    }
  }
}

// Stage 2: gradient of iwar (central, one-sided at the image border), It
// and the demons force with its 0/0 guard, on the (e-2) x (e-2) region at
// global (gi0 + 1, gj0 + 1); (gi0, gj0) is the input region's origin.
// ``a`` is sigma_i^2 and ``b`` sigma_x^2, each rounded to float32.
__device__ void stage_force(const float* iwar_s, const float* iref_s, int e, int gi0,
                            int gj0, int nx, int ny, float a, float b, float* corr) {
  const int m = e - 2;
  for (int li = threadIdx.y; li < m; li += kThreadsX) {
    const int gi = gi0 + 1 + li;
    for (int lj = threadIdx.x; lj < m; lj += kThreadsY) {
      const int gj = gj0 + 1 + lj;
      float cx = 0.f, cy = 0.f;
      if (inside(gi, nx) && inside(gj, ny)) {
        const int l = (li + 1) * e + lj + 1;
        const float w = iwar_s[l];
        const float gx = gi == 0        ? iwar_s[l + e] - w
                         : gi == nx - 1 ? w - iwar_s[l - e]
                                        : (iwar_s[l + e] - iwar_s[l - e]) * 0.5f;
        const float gy = gj == 0        ? iwar_s[l + 1] - w
                         : gj == ny - 1 ? w - iwar_s[l - 1]
                                        : (iwar_s[l + 1] - iwar_s[l - 1]) * 0.5f;
        const float it = w - iref_s[l];
        const float den = gx * gx + gy * gy + it * it * a / b;
        if (den > 0.f) {
          cx = (gx * it * -1.f) / den;
          cy = (gy * it * -1.f) / den;
        }
      }
      corr[li * m + lj] = cx;
      corr[m * m + li * m + lj] = cy;
    }
  }
}

// The x pass of the separable Gaussian: ``in`` is rows_in x cols with
// global row gi0_out - c at row 0; ``out`` is (rows_in - 2c) x cols with
// global row gi0_out at row 0.
__device__ void smooth_x(const float* in, int rows_in, int cols, int gi0_out, int nx,
                         const Taps& taps, int k, float* out) {
  const int rows = rows_in - 2 * (k / 2);
  for (int li = threadIdx.y; li < rows; li += kThreadsX) {
    const int gi = gi0_out + li;
    for (int lj = threadIdx.x; lj < cols; lj += kThreadsY) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        out[ch * rows * cols + li * cols + lj] =
            tap_sum(in + ch * rows_in * cols + li * cols + lj, cols, gi, nx, taps, k);
    }
  }
}

// The y pass and the renormalization: ``in`` is rows x cols_in with global
// cell (gi0, gj0_out - c) at (0, 0); ``out`` is rows x (cols_in - 2c) with
// (gi0, gj0_out) at (0, 0), 0 outside the image.
__device__ void smooth_y(const float* in, int rows, int cols_in, int gi0, int gj0_out,
                         int nx, int ny, const Taps& taps, int k, float* out) {
  const int cols = cols_in - 2 * (k / 2);
  for (int li = threadIdx.y; li < rows; li += kThreadsX) {
    const int gi = gi0 + li;
    const bool row_in = inside(gi, nx);
    const float den_x = row_in ? tap_weight(gi, nx, taps, k) : 0.f;
    for (int lj = threadIdx.x; lj < cols; lj += kThreadsY) {
      const int gj = gj0_out + lj;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        float v = 0.f;
        if (row_in && inside(gj, ny)) {
          const float den = den_x * tap_weight(gj, ny, taps, k);
          v = tap_sum(in + ch * rows * cols_in + li * cols_in + lj, 1, gj, ny, taps, k) / den;
        }
        out[ch * rows * cols + li * cols + lj] = v;
      }
    }
  }
}

// Stage 5: accumulate the smoothed correspondence ``cs`` (d x d at global
// (gi0, gj0)) into the motion u: u + c (kAddition), or the composition
// c + u(x + c) in bounds and u out of bounds (compose_ref; on a strip
// compose_strip_ref).
template <bool kAddition, bool kStrip>
__device__ void stage_accumulate(const float* cs, int d, int gi0, int gj0,
                                 const float* __restrict__ u, const Rows& r, int ny, int halo,
                                 float* comp) {
  const size_t n = r.in_plane(ny);
  for (int li = threadIdx.y; li < d; li += kThreadsX) {
    const int gi = gi0 + li;
    const bool row_in = r.loadable(gi - r.row0);
    for (int lj = threadIdx.x; lj < d; lj += kThreadsY) {
      const int gj = gj0 + lj;
      const int l = li * d + lj;
      float o0 = 0.f, o1 = 0.f;
      if (row_in && inside(gj, ny)) {
        const size_t p = r.in_row(gi - r.row0, ny) + gj;
        const float c0 = cs[l], c1 = cs[d * d + l];
        if (kAddition) {
          o0 = u[p] + c0;
          o1 = u[n + p] + c1;
        } else {
          Bilinear b = bilinear_at(gi, gj, c0, c1, r.nx, ny);
          const bool taps = kStrip ? strip_taps(b, gi, gj, r, ny, halo) : true;
          o0 = b.in_bounds ? c0 + (taps ? bilinear_sample(u, b) : 0.f) : u[p];
          o1 = b.in_bounds ? c1 + (taps ? bilinear_sample(u + n, b) : 0.f) : u[n + p];
        }
      }
      comp[l] = o0;
      comp[d * d + l] = o1;
    }
  }
}

// The last y pass, into the [2, r.nxl, ny] output of the block's tile:
// ``xs`` is kTile x cols with global cell (i0, j0 - c) at (0, 0). With
// kSums, also the Logger magnitudes |out - u| and |u| of the tile's cells,
// added in this thread's loop order.
template <bool kSums>
__device__ void smooth_y_store(const float* xs, int cols, int i0, int j0, const Rows& r,
                               int ny, const Taps& taps, int k, float* __restrict__ out,
                               const float* __restrict__ u, float& dsum, float& psum) {
  const size_t n = r.out_plane(ny), n_in = r.in_plane(ny);
  for (int li = threadIdx.y; li < kTile; li += kThreadsX) {
    const int gi = i0 + li;
    const int lr = gi - r.row0;
    if (lr >= r.nxl) break;
    const float den_x = tap_weight(gi, r.nx, taps, k);
    for (int lj = threadIdx.x; lj < kTile; lj += kThreadsY) {
      const int gj = j0 + lj;
      if (gj >= ny) break;
      const float den = den_x * tap_weight(gj, ny, taps, k);
      const float* src = xs + li * cols + lj;
      const float o0 = tap_sum(src, 1, gj, ny, taps, k) / den;
      const float o1 = tap_sum(src + kTile * cols, 1, gj, ny, taps, k) / den;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      out[p] = o0;
      out[n + p] = o1;
      if (kSums) {
        const size_t q = r.in_row(lr, ny) + gj;
        const float u0 = u[q], u1 = u[n_in + q];
        dsum += magnitude(o0 - u0, o1 - u1);
        psum += magnitude(u0, u1);
      }
    }
  }
}

// One thread block per kTile x kTile tile of the rows r owns.
inline dim3 tile_grid(const Rows& r, int ny) {
  return dim3((ny + kTile - 1) / kTile, (r.nxl + kTile - 1) / kTile);
}

// Copy host taps into the by-value struct; false if k is not odd in
// [1, kMaxTaps].
inline bool make_taps(const float* host, int k, Taps* taps) {
  if (k < 1 || k > kMaxTaps || k % 2 == 0) return false;
  for (int t = 0; t < kMaxTaps; ++t) taps->w[t] = t < k ? host[t] : 0.f;
  return true;
}

}  // namespace
