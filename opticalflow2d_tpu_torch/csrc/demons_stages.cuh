// The stages of one demons iteration on a 2D tile in shared memory, shared
// by demons_onepass.cu (B10: all of them) and demons_fused.cu (B11: warp
// to smoothed correspondence; B12: accumulate and smooth).
//
// A thread block owns a TX x TY output tile (x rows by y columns, y the
// contiguous axis). Each stage reads a region of the tile extended by the
// reach of the stages after it and writes a smaller one: every buffer is
// one or two planes (x, y channels) of rows x cols floats, row-major, whose
// cell (0, 0) is a known global (gi, gj). Cells outside the image hold 0
// and are never read by a cell inside it: the gradient is one-sided at the
// image border and every smoothing tap is masked by its global index, as
// the plain versions zero-pad. So ragged tiles need no special case.
//
// Layout of the work: every stage walks its region by a flattened cell
// index (row-major, consecutive cells on consecutive threads), so no lane
// idles on a row that is not a multiple of 32 wide and the y passes read
// consecutive words across lanes. With the tap count K known at compile
// time (K > 0) the tap loops unroll and the x passes keep a sliding window
// of kRun + K - 1 values in registers: one shared-memory read per output
// instead of K. K = 0 takes the tap count at run time. A gather fetches
// the taps of a batch of cells (kBatch for the warp, its caller's for the
// compose) before using any of them.
//
// Two routes, one body: kInterior drops every `inside`/`loadable` test and
// takes each renormalization denominator as the product of two full tap
// sums, computed once per tile. It is taken where the tile's region,
// extended by its reach, lies inside the image (and, for a strip, inside
// the padded strip, with the tile inside the strip's own rows), where every
// one of those tests is true, so both routes give the same bits. The
// per-sample tests of the gathers (in bounds, weight, the strips' contract)
// depend on the displacement and stay on every cell.
//
// Numerics: each stage repeats its plain version's float expressions in
// the same order (solvers/base.py::demons_force, ops/conv.py::
// convolve2d_clip, kernels/warp_fused.py), every tap sum as acc = s0*w0,
// then acc += s_t*w_t in tap order, and the library is built with
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

constexpr int kMaxTaps = 64;
// The demons kernels' output tile where it fits, and the tile every width
// falls back to (the sweeps in PERF.md). B10 and B11 stage their inputs in
// two buffers (kStagedPlans); B12 stages c in one, two blocks an SM
// (kComposePlans), and recomputes a halo of 1.13x the tile at kw 5 (68^2 /
// 64^2, against 1.27x at 32 x 32) while its gathers of u, not its 24 B a
// pixel, hold it (demons_fused.cu).
constexpr int kTileX = 64, kTileY = 64, kTileBufs = 2;
constexpr int kSmallTile = 32;
constexpr int kMaxSmemBytes = 232448;  // an H100 thread block, opt-in
constexpr int kRun = 8;                // x-pass outputs per window (K > 0)
constexpr int kBatch = 4;              // cells the warp gathers at once

// Threads of a block owning a tx x ty tile: 4 to 8 cells each.
__host__ __device__ constexpr int demons_threads(int tx, int ty) {
  return tx * ty >= 2048 ? 512 : 256;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Gaussian taps, passed by value as a kernel parameter.
struct Taps {
  float w[kMaxTaps];
};

// The regions of one tile at (i0, j0): the warp region extends the tile by
// ``reach`` (origin (i0 - r, j0 - r)), the force region by reach - 1, the
// smoothed correspondence of B10 by c = k / 2.
struct DemonsGeo {
  int c, r, ex, ey, mx, my, dx, dy;
  __host__ __device__ constexpr DemonsGeo(int k, int tx, int ty, int reach)
      : c(k / 2), r(reach), ex(tx + 2 * reach), ey(ty + 2 * reach), mx(tx + 2 * reach - 2),
        my(ty + 2 * reach - 2), dx(tx + 2 * (k / 2)), dy(ty + 2 * (k / 2)) {}
};

// A region of rows x cols cells whose cell (0, 0) is global (gi0, gj0).
struct Region {
  int rows, cols, gi0, gj0;
};

__device__ __forceinline__ bool inside(int g, int n) { return g >= 0 && g <= n - 1; }

// Whether the tile at (i0, j0) and its region ``reach`` around it lie inside
// the image and the padded strip, with the tile inside the rows r owns: the
// interior route's condition, in global coordinates.
__device__ __forceinline__ bool interior_tile(const Rows& r, int ny, int i0, int j0, int tx,
                                              int ty, int reach) {
  const int lo = i0 - reach, hi = i0 + tx + reach;
  return lo >= 0 && hi <= r.nx && lo - r.row0 >= -r.pad && hi - r.row0 <= r.nxl + r.pad &&
         i0 + tx <= r.row0 + r.nxl && j0 - reach >= 0 && j0 + ty + reach <= ny;
}

// A thread's row-major walk over planes of rows x cols cells from cell
// ``start``, ``stride`` cells a step, with no division per step (a stride
// less than a plane): (ch, li, lj) is the current cell.
struct Walk {
  int ch, li, lj, dli, dlj, rows, cols;
  __device__ __forceinline__ Walk(int start, int stride, int rows_, int cols_)
      : rows(rows_), cols(cols_) {
    li = start / cols;
    lj = start - li * cols;
    ch = li / rows;
    li -= ch * rows;
    dli = stride / cols;
    dlj = stride - dli * cols;
  }
  __device__ __forceinline__ void step() {
    lj += dlj;
    li += dli;
    if (lj >= cols) {
      lj -= cols;
      ++li;
    }
    if (li >= rows) {
      li -= rows;
      ++ch;
    }
  }
};

// Calls f(li, lj, l) for every cell l = li * cols + lj of a rows x cols
// region, consecutive cells on consecutive threads of kN.
template <int kN, typename F>
__device__ __forceinline__ void for_cells(int rows, int cols, F&& f) {
  const int n = rows * cols;
  Walk cur(threadIdx.x, kN, rows, cols);
  for (int l = threadIdx.x; l < n; l += kN, cur.step()) f(cur.li, cur.lj, l);
}

// Sum of the taps whose source index g + t - c lies in [0, n): the
// renormalization denominator along one axis, added in tap order.
template <int K>
__device__ __forceinline__ float tap_weight(int g, int n, const Taps& taps, int k) {
  const int kk = K > 0 ? K : k, c = kk / 2;
  float acc = inside(g - c, n) ? taps.w[0] : 0.f;
#pragma unroll
  for (int t = 1; t < kk; ++t) acc += inside(g + t - c, n) ? taps.w[t] : 0.f;
  return acc;
}

// The same where every source index lies inside: all taps, in tap order.
template <int K>
__device__ __forceinline__ float tap_total(const Taps& taps, int k) {
  const int kk = K > 0 ? K : k;
  float acc = taps.w[0];
#pragma unroll
  for (int t = 1; t < kk; ++t) acc += taps.w[t];
  return acc;
}

// Tap sum along one axis: src[t * stride] * taps[t] for the taps whose
// source index g + t - c lies in [0, n) (all of them with kInterior), in tap
// order.
template <int K, bool kInterior>
__device__ __forceinline__ float tap_sum(const float* src, int stride, int g, int n,
                                         const Taps& taps, int k) {
  const int kk = K > 0 ? K : k, c = kk / 2;
  float acc = (kInterior || inside(g - c, n)) ? src[0] * taps.w[0] : 0.f;
#pragma unroll
  for (int t = 1; t < kk; ++t)
    acc += (kInterior || inside(g + t - c, n)) ? src[t * stride] * taps.w[t] : 0.f;
  return acc;
}

// --- asynchronous staging ------------------------------------------------------

// One float from global to shared memory without passing through registers;
// zero-filled where !valid (then src is not read).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying ``nplanes`` planes of ``src`` (read through r) on region g
// into dst, g.rows x g.cols per plane, 0 where a cell is not loadable.
template <int kN>
__device__ __forceinline__ void stage_region(const float* __restrict__ src, int nplanes,
                                             const Rows& r, int ny, Region g, float* dst) {
  const size_t n = r.in_plane(ny);
  const int cells = g.rows * g.cols;
  for_cells<kN>(g.rows, g.cols, [&](int li, int lj, int l) {
    const int gi = g.gi0 + li, gj = g.gj0 + lj;
    const bool ok = r.loadable(gi - r.row0) && inside(gj, ny);
    const size_t p = ok ? r.in_row(gi - r.row0, ny) + gj : 0;
    for (int ch = 0; ch < nplanes; ++ch) cp_async_f32(dst + ch * cells + l, src + ch * n + p, ok);
  });
}

// The motion u at a cell of a stage's region, for the compose's pass-through
// (u where x + c leaves the grid), the addition and the Logger sums: from
// the staged copy (base at the region's cell (0, 0), ``stride`` floats a
// row, ``plane`` a channel) or from device memory through r.
struct StagedCell {
  const float* base;
  int stride, plane;
  __device__ float operator()(int li, int lj, int, int, int ch) const {
    return base[ch * plane + li * stride + lj];
  }
};

struct GlobalCell {
  const float* __restrict__ u;
  Rows r;
  int ny;
  __device__ float operator()(int, int, int gi, int gj, int ch) const {
    return __ldg(u + ch * r.in_plane(ny) + r.in_row(gi - r.row0, ny) + gj);
  }
};

// --- the stages ------------------------------------------------------------------

// Stage 1: the warped moving image on region w: iwar = iaux(x + u(x)), the
// original pixel where the sample is out of bounds or of zero weight
// (warp2d_ref; on a strip warp2d_strip_ref). ``su`` holds u's two planes on
// w.
template <int kN, bool kInterior, bool kStrip>
__device__ __forceinline__ void stage_warp(const float* __restrict__ iaux, const float* su,
                                           const Rows& r, int ny, int halo, Region w,
                                           float* iwar) {
  const int n = w.rows * w.cols;
  Walk cur(threadIdx.x, kN, w.rows, w.cols);
  for (int base = threadIdx.x; base < n; base += kN * kBatch) {
    Bilinear b[kBatch];
    float v[kBatch][4];
    bool live[kBatch], taps[kBatch];
    int row[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q, cur.step()) {
      const int l = base + q * kN;
      const int gi = w.gi0 + cur.li, gj = w.gj0 + cur.lj;
      row[q] = gi;
      live[q] = l < n && (kInterior || (r.loadable(gi - r.row0) && inside(gj, ny)));
      taps[q] = false;
      if (live[q]) {
        b[q] = bilinear_at(gi, gj, su[l], su[n + l], r.nx, ny);
        taps[q] = kStrip ? strip_taps(b[q], gi, gj, r, ny, halo) : true;
        if (taps[q]) {
          v[q][0] = __ldg(iaux + b[q].p00);
          v[q][1] = __ldg(iaux + b[q].p10);
          v[q][2] = __ldg(iaux + b[q].p01);
          v[q][3] = __ldg(iaux + b[q].p11);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int l = base + q * kN;
      if (l >= n) break;
      float out = 0.f;
      if (live[q]) {
        const Bilinear& s = b[q];
        const float value =
            taps[q] ? v[q][0] * s.w00 + v[q][1] * s.w10 + v[q][2] * s.w01 + v[q][3] * s.w11 : 0.f;
        if (s.in_bounds && s.weight != 0.f) {
          out = value / s.weight;
        } else {
          const int lj = l - (row[q] - w.gi0) * w.cols;
          out = __ldg(iaux + r.in_row(row[q] - r.row0, ny) + w.gj0 + lj);
        }
      }
      iwar[l] = out;
    }
  }
}

// Stage 2: gradient of iwar (central, one-sided at the image border), It
// and the demons force with its 0/0 guard, on the (w.rows - 2) x (w.cols - 2)
// region inside w; ``sref`` holds iref on that region. ``a`` is sigma_i^2
// and ``b`` sigma_x^2, each rounded to float32.
template <int kN, bool kInterior>
__device__ __forceinline__ void stage_force(const float* iwar, const float* sref, Region w,
                                            int nx, int ny, float a, float b, float* corr) {
  const int e = w.cols, mr = w.rows - 2, mc = w.cols - 2, m = mr * mc;
  for_cells<kN>(mr, mc, [&](int li, int lj, int l) {
    const int gi = w.gi0 + 1 + li, gj = w.gj0 + 1 + lj;
    float cx = 0.f, cy = 0.f;
    if (kInterior || (inside(gi, nx) && inside(gj, ny))) {
      const int q = (li + 1) * e + lj + 1;
      const float wv = iwar[q];
      float gx, gy;
      if (kInterior) {
        gx = (iwar[q + e] - iwar[q - e]) * 0.5f;
        gy = (iwar[q + 1] - iwar[q - 1]) * 0.5f;
      } else {
        gx = gi == 0        ? iwar[q + e] - wv
             : gi == nx - 1 ? wv - iwar[q - e]
                            : (iwar[q + e] - iwar[q - e]) * 0.5f;
        gy = gj == 0        ? iwar[q + 1] - wv
             : gj == ny - 1 ? wv - iwar[q - 1]
                            : (iwar[q + 1] - iwar[q - 1]) * 0.5f;
      }
      const float it = wv - sref[l];
      const float den = gx * gx + gy * gy + it * it * a / b;
      if (den > 0.f) {
        cx = (gx * it * -1.f) / den;
        cy = (gy * it * -1.f) / den;
      }
    }
    corr[l] = cx;
    corr[m + l] = cy;
  });
}

// The x pass of the separable Gaussian on two channels: ``in`` is
// rows_in x cols a channel with global row gi0_out - c at row 0; ``out`` is
// (rows_in - 2c) x cols a channel with global row gi0_out at row 0. With K
// known, a thread takes kRun consecutive outputs of one column from a
// window of kRun + K - 1 values in registers.
template <int K, int kN, bool kInterior>
__device__ __forceinline__ void smooth_x(const float* in, int rows_in, int cols, int gi0_out,
                                         int nx, const Taps& taps, int k, float* out) {
  const int kk = K > 0 ? K : k, c = kk / 2;
  const int rows = rows_in - 2 * c;
  if constexpr (K > 0) {
    const int runs = (rows + kRun - 1) / kRun;
    Walk cur(threadIdx.x, kN, runs, cols);
    for (int item = threadIdx.x; item < 2 * runs * cols; item += kN, cur.step()) {
      const int ch = cur.ch, lj = cur.lj, li0 = cur.li * kRun;
      const float* src = in + ch * rows_in * cols + li0 * cols + lj;
      float win[kRun + K - 1];
#pragma unroll
      for (int s = 0; s < kRun + K - 1; ++s) win[s] = li0 + s < rows_in ? src[s * cols] : 0.f;
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        const int li = li0 + q;
        if (li >= rows) break;
        const int gi = gi0_out + li;
        float acc = (kInterior || inside(gi - c, nx)) ? win[q] * taps.w[0] : 0.f;
#pragma unroll
        for (int t = 1; t < K; ++t)
          acc += (kInterior || inside(gi + t - c, nx)) ? win[q + t] * taps.w[t] : 0.f;
        out[ch * rows * cols + li * cols + lj] = acc;
      }
    }
  } else {
    Walk cur(threadIdx.x, kN, rows, cols);
    for (int item = threadIdx.x; item < 2 * rows * cols; item += kN, cur.step())
      out[item] = tap_sum<K, kInterior>(in + (cur.ch * rows_in + cur.li) * cols + cur.lj, cols,
                                        gi0_out + cur.li, nx, taps, k);
  }
}

// The y pass and the renormalization on two channels: ``in`` is
// rows x cols_in a channel with global cell (gi0, gj0_out - c) at (0, 0);
// ``out`` is rows x (cols_in - 2c) with (gi0, gj0_out) at (0, 0), 0 outside
// the image. ``den_in`` is the interior denominator.
template <int K, int kN, bool kInterior>
__device__ __forceinline__ void smooth_y(const float* in, int rows, int cols_in, int gi0,
                                         int gj0_out, int nx, int ny, const Taps& taps, int k,
                                         float den_in, float* out) {
  const int kk = K > 0 ? K : k;
  const int cols = cols_in - 2 * (kk / 2);
  Walk cur(threadIdx.x, kN, rows, cols);
  for (int item = threadIdx.x; item < 2 * rows * cols; item += kN, cur.step()) {
    const int ch = cur.ch, li = cur.li, lj = cur.lj;
    const int gi = gi0 + li, gj = gj0_out + lj;
    float v = 0.f;
    if (kInterior || (inside(gi, nx) && inside(gj, ny))) {
      const float den = kInterior ? den_in
                                  : tap_weight<K>(gi, nx, taps, k) * tap_weight<K>(gj, ny, taps, k);
      v = tap_sum<K, kInterior>(in + ch * rows * cols_in + li * cols_in + lj, 1, gj, ny, taps, k) /
          den;
    }
    out[item] = v;
  }
}

// Accumulate the smoothed correspondence ``cs`` (two channels on region s)
// into the motion u: u + c (kAddition), or the composition c + u(x + c) in
// bounds and u out of bounds (compose_ref; on a strip compose_strip_ref).
// ``ucell`` gives u at the cells of s; kB cells' taps are fetched before
// any is used. A tap's offset in its plane is taken as an Offset: int where
// the caller has checked that twice the input plane is below 2^31.
template <int kN, bool kInterior, bool kAddition, bool kStrip, int kB, typename Offset = size_t,
          typename UCell>
__device__ __forceinline__ void stage_accumulate(const float* cs, Region s,
                                                 const float* __restrict__ u, const UCell& ucell,
                                                 const Rows& r, int ny, int halo, float* comp) {
  const int n = s.rows * s.cols;
  const size_t np = r.in_plane(ny);
  Walk cur(threadIdx.x, kN, s.rows, s.cols);
  for (int base = threadIdx.x; base < n; base += kN * kB) {
    Bilinear b[kB];
    float v[kB][8];
    bool live[kB], taps[kB];
    const Walk first = cur;
#pragma unroll
    for (int q = 0; q < kB; ++q, cur.step()) {
      const int l = base + q * kN;
      const int gi = s.gi0 + cur.li, gj = s.gj0 + cur.lj;
      live[q] = l < n && (kInterior || (r.loadable(gi - r.row0) && inside(gj, ny)));
      taps[q] = false;
      if (!kAddition && live[q]) {
        b[q] = bilinear_at(gi, gj, cs[l], cs[n + l], r.nx, ny);
        taps[q] = kStrip ? strip_taps(b[q], gi, gj, r, ny, halo) : true;
        if (b[q].in_bounds && taps[q]) {
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            const float* __restrict__ plane = u + ch * np;
            v[q][4 * ch + 0] = __ldg(plane + static_cast<Offset>(b[q].p00));
            v[q][4 * ch + 1] = __ldg(plane + static_cast<Offset>(b[q].p10));
            v[q][4 * ch + 2] = __ldg(plane + static_cast<Offset>(b[q].p01));
            v[q][4 * ch + 3] = __ldg(plane + static_cast<Offset>(b[q].p11));
          }
        }
      }
    }
    Walk at = first;
#pragma unroll
    for (int q = 0; q < kB; ++q, at.step()) {
      const int l = base + q * kN;
      if (l >= n) break;
      float o[2] = {0.f, 0.f};
      if (live[q]) {
        const int li = at.li, lj = at.lj;
        const int gi = s.gi0 + li, gj = s.gj0 + lj;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          const float cc = cs[ch * n + l];
          if (kAddition) {
            o[ch] = ucell(li, lj, gi, gj, ch) + cc;
          } else if (b[q].in_bounds) {
            const Bilinear& t = b[q];
            const float* x = v[q] + 4 * ch;
            const float sample =
                taps[q] && t.weight != 0.f
                    ? (x[0] * t.w00 + x[1] * t.w10 + x[2] * t.w01 + x[3] * t.w11) / t.weight
                    : 0.f;
            o[ch] = cc + sample;
          } else {
            o[ch] = ucell(li, lj, gi, gj, ch);
          }
        }
      }
      comp[l] = o[0];
      comp[n + l] = o[1];
    }
  }
}

// The last y pass, into the [2, r.nxl, ny] output of the tx x ty tile at
// (i0, j0): ``xs`` is tx x cols_in a channel with global cell (i0, j0 - c) at
// (0, 0). With ``sums``, also the Logger magnitudes |out - u| and |u| of
// the tile's cells (u from ``ucell``, at the tile's cells), added in this
// thread's loop order.
template <int K, int kN, bool kInterior, typename UCell>
__device__ __forceinline__ void smooth_y_store(const float* xs, int tx, int ty, int cols_in,
                                               int i0, int j0, const Rows& r, int ny,
                                               const Taps& taps, int k, float den_in,
                                               float* __restrict__ out, bool sums,
                                               const UCell& ucell, float& dsum, float& psum) {
  const size_t n = r.out_plane(ny);
  const int plane = tx * cols_in;
  for_cells<kN>(tx, ty, [&](int li, int lj, int) {
    const int gi = i0 + li, gj = j0 + lj;
    const int lr = gi - r.row0;
    if (!kInterior && (lr >= r.nxl || gj >= ny)) return;
    const float den = kInterior ? den_in
                                : tap_weight<K>(gi, r.nx, taps, k) * tap_weight<K>(gj, ny, taps, k);
    const float* src = xs + li * cols_in + lj;
    const float o0 = tap_sum<K, kInterior>(src, 1, gj, ny, taps, k) / den;
    const float o1 = tap_sum<K, kInterior>(src + plane, 1, gj, ny, taps, k) / den;
    const size_t p = static_cast<size_t>(lr) * ny + gj;
    out[p] = o0;
    out[n + p] = o1;
    if (sums) {
      const float u0 = ucell(li, lj, gi, gj, 0), u1 = ucell(li, lj, gi, gj, 1);
      dsum += magnitude(o0 - u0, o1 - u1);
      psum += magnitude(u0, u1);
    }
  });
}

// --- launch helpers ---------------------------------------------------------------

// A demons kernel's tile and staging: a tx x ty output tile, and 2 staging
// buffers (the next tile's inputs copied while this one computes) or 1.
struct DemonsPlan {
  int tx, ty, nbuf;
};

// B10's and B11's plans in order of preference: the preferred tile with two
// buffers, 32 x 32 with two, 32 x 32 with one. B12's: the preferred tile
// with one, 32 x 32 with one.
constexpr DemonsPlan kStagedPlans[] = {
    {kTileX, kTileY, kTileBufs}, {kSmallTile, kSmallTile, 2}, {kSmallTile, kSmallTile, 1}};
constexpr DemonsPlan kComposePlans[] = {{kTileX, kTileY, 1}, {kSmallTile, kSmallTile, 1}};

// The first of ``plans`` whose shared memory (smem_floats(k, tx, ty, nbuf))
// fits a thread block; tx = 0 if none does.
template <typename SmemFloats, int N>
inline DemonsPlan demons_plan(int k, SmemFloats smem_floats, const DemonsPlan (&plans)[N]) {
  for (const DemonsPlan& p : plans)
    if (smem_floats(k, p.tx, p.ty, p.nbuf) * static_cast<int>(sizeof(float)) <= kMaxSmemBytes)
      return p;
  return {0, 0, 0};
}

__host__ __device__ inline int demons_tiles(const Rows& r, int ny, int tx, int ty) {
  return ((r.nxl + tx - 1) / tx) * ((ny + ty - 1) / ty);
}

// Blocks of a persistent grid over ``tiles`` tiles: as many as are resident
// on the card at once, cached per kernel instantiation (``cache``) for the
// current device and shared-memory size.
struct GridCache {
  int device = -1, smem = -1, blocks = 0;
};

template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, int tiles, GridCache* cache,
                    int* blocks) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cache->device != device || cache->smem != smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    *cache = GridCache{device, smem, per_sm * sms};
  }
  *blocks = tiles < cache->blocks ? tiles : cache->blocks;
  return 0;
}

// Copy host taps into the by-value struct; false if k is not odd in
// [1, kMaxTaps].
inline bool make_taps(const float* host, int k, Taps* taps) {
  if (k < 1 || k > kMaxTaps || k % 2 == 0) return false;
  for (int t = 0; t < kMaxTaps; ++t) taps->w[t] = t < k ? host[t] : 0.f;
  return true;
}

}  // namespace
