// The SOR tile layout the elastic block (B6) and the fluid iteration (B7,
// B8, K3) had before their redesigns, kept for the probes' "before"
// measurements (probes/elastic_block.cuh, probes/fluid_iter.cuh): one
// 256-thread block per 32 x 32 tile, a warp a row, every cell of a
// half-sweep's square visited and the other colour copied, loads through
// registers.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"
#include "sor_stages.cuh"

namespace {

constexpr int kSorTile = 32;      // output tile, both axes
constexpr int kSorThreadsY = 32;  // lanes along y, the contiguous axis
constexpr int kSorThreadsX = 8;   // warps, along x
constexpr int kSorThreads = kSorThreadsX * kSorThreadsY;

// One half-sweep over the cells [lo, hi) x [lo, hi) of the tile: the cells
// of colour ``parity`` ((gi + gj) & 1) inside the image's interior take
// their candidate, every other cell keeps its value. The right-hand side
// is the L-SSD force grad(I) * (It + f0*gx + f1*gy) at the cell
// (solvers/base.py::lssd_force), from the field f (two planes) and
// gs = (gx, gy, It) (three planes). Reads x, writes out.
template <bool kRefStencil>
__device__ __forceinline__ void sor_half_sweep(const float* x, float* out, const float* f,
                                               const float* gs, int e, int lo, int hi,
                                               int gi0, int gj0, int nx, int ny, int parity,
                                               const SorScalars& s) {
  const int ee = e * e;
  for (int li = lo + threadIdx.y; li < hi; li += kSorThreadsX) {
    const int gi = gi0 + li;
    const bool row_interior = gi >= 1 && gi <= nx - 2;
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
