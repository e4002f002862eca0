// The red-black SOR half-sweep of the Navier-Lame system on a 2D tile in
// shared memory, shared by elastic_block.cu (B6: k elastic iterations) and
// fluid_iter.cu (B7: one sweep on the velocity), as sor_candidate_tile
// (opticalflow2d_tpu/pallas_kernels/elastic_block.py:32) serves both TPU
// kernels.
//
// A buffer is two planes (x, y components) of e x e floats, row-major, at
// a plane stride of e * e; its cell (0, 0) lies at global (gi0, gj0). The
// colours and the interior are global, so a strip (rows.cuh) sweeps its
// rows as the whole image does; a strip whose first row is odd has the
// colours of its local indices flipped (parallel/spatial.py:175-182).
//
// A half-sweep cannot update in place: the cross term of component c reads
// the other component at the four diagonal neighbours, which have the
// cell's own colour. So every candidate is computed from the input buffer
// and written to the output buffer, the cells of the other colour copied,
// as solvers/elastic.py computes all candidates and then masks.
//
// Numerics: the plain version's expressions in its order, with the scalars
// rounded to float32 once on the host (solvers/elastic.py::sor_scalars);
// the library is built with -fmad=false, so the tile rounds like the plain
// version on the card.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"

namespace {

constexpr int kSorTile = 32;      // output tile, both axes
constexpr int kSorThreadsY = 32;  // lanes along y, the contiguous axis
constexpr int kSorThreadsX = 8;   // warps, along x
constexpr int kSorThreads = kSorThreadsX * kSorThreadsY;

struct SorScalars {
  float mu, mpl, omw, inv_diag;  // mu, mu + lambda, 1 - omega, omega / (-6 mu - 2 lambda)
};

// The SOR candidate of component c at cell l of buffer x (row stride e,
// plane stride ee) for right-hand side b_c (solvers/elastic.py::
// _gs_candidate). kRefStencil: the y-component's second-derivative term
// takes x-direction neighbours, as the reference does.
template <bool kRefStencil>
__device__ __forceinline__ float sor_candidate(const float* x, int ee, int e, int l, int c,
                                               float b_c, const SorScalars& s) {
  const float* xc = x + c * ee;
  const float* xo = x + (1 - c) * ee;
  const float xp = xc[l + e], xm = xc[l - e], yp = xc[l + 1], ym = xc[l - 1];
  const float lap4 = ((xp + xm) + yp) + ym;
  const float cross = 0.25f * (((xo[l + e + 1] - xo[l - e + 1]) - xo[l + e - 1]) + xo[l - e - 1]);
  const float second = (c == 0 || kRefStencil) ? xp + xm : yp + ym;
  const float num = (b_c - s.mu * lap4) - s.mpl * (second + cross);
  return s.omw * xc[l] + s.inv_diag * num;
}

// One half-sweep over the cells [lo, hi) x [lo, hi) of the tile: the cells
// of colour ``parity`` ((gi + gj) & 1) inside the image's interior take
// their candidate, every other cell keeps its value. The right-hand side
// is the L-SSD force grad(I) * (It + f0*gx + f1*gy) at the cell
// (solvers/base.py::lssd_force), from the field f (two planes) and
// gs = (gx, gy, It) (three planes). Reads x, writes out.
//
// kSums: also add, per thread, |out - prev| and |prev| over the cells of
// [t_lo, t_hi)^2 inside the image and above global row gi_end (the end of
// the rows the launch owns), where prev is what ``out`` held before this
// half-sweep (the Logger's previous field).
template <bool kRefStencil, bool kSums>
__device__ __forceinline__ void sor_half_sweep(const float* x, float* out, const float* f,
                                               const float* gs, int e, int lo, int hi,
                                               int gi0, int gj0, int nx, int ny, int parity,
                                               const SorScalars& s, int t_lo, int t_hi,
                                               int gi_end, float& dsum, float& psum) {
  const int ee = e * e;
  for (int li = lo + threadIdx.y; li < hi; li += kSorThreadsX) {
    const int gi = gi0 + li;
    const bool row_interior = gi >= 1 && gi <= nx - 2;
    const bool row_sums = kSums && gi >= 0 && gi < gi_end && li >= t_lo && li < t_hi;
    for (int lj = lo + threadIdx.x; lj < hi; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      const int l = li * e + lj;
      float n0 = x[l], n1 = x[ee + l];
      if (row_interior && gj >= 1 && gj <= ny - 2 && ((gi + gj) & 1) == parity) {
        const float gx = gs[l], gy = gs[ee + l];
        const float inner = (gs[2 * ee + l] + f[l] * gx) + f[ee + l] * gy;
        n0 = sor_candidate<kRefStencil>(x, ee, e, l, 0, gx * inner, s);
        n1 = sor_candidate<kRefStencil>(x, ee, e, l, 1, gy * inner, s);
      }
      if (kSums && row_sums && gj >= 0 && gj < ny && lj >= t_lo && lj < t_hi) {
        const float p0 = out[l], p1 = out[ee + l];
        const float d0 = n0 - p0, d1 = n1 - p1;
        dsum += sqrtf(d0 * d0 + d1 * d1);
        psum += sqrtf(p0 * p0 + p1 * p1);
      }
      out[l] = n0;
      out[ee + l] = n1;
    }
  }
}

// Load the first nplanes planes of a field with rows r (rows.cuh) into a
// tile buffer of e x e cells per plane whose cell (0, 0) is at local row li0
// and column gj0; cells outside the input or the image hold 0.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* dst,
                                          int nplanes, const Rows& r, int ny, int li0, int gj0,
                                          int e) {
  const size_t n = r.in_plane(ny);
  const int ee = e * e;
  for (int li = threadIdx.y; li < e; li += kSorThreadsX) {
    const bool row_ok = r.loadable(li0 + li);
    const size_t row = r.in_row(li0 + li, ny);
    for (int lj = threadIdx.x; lj < e; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      const bool in = row_ok && gj >= 0 && gj < ny;
      const size_t p = in ? row + gj : 0;
      for (int c = 0; c < nplanes; ++c) dst[c * ee + li * e + lj] = in ? src[c * n + p] : 0.f;
    }
  }
}

__host__ __device__ constexpr int sor_tiles(int n) { return (n + kSorTile - 1) / kSorTile; }

}  // namespace
