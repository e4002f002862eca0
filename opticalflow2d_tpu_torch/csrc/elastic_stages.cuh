// The stages of the elastic block kernel (elastic_block.cu: B6 and its strip
// mode K2) on one tile in shared memory: staging, the red-black half-sweeps
// with the Logger sums, and the store. probes/elastic_block.cuh builds the
// variants the design was chosen from out of the same functions.
//
// Geometry. A thread block owns a TX x TY output tile (x rows by y columns,
// y the contiguous axis) and stages it with a halo of h = 2k cells a side:
// u twice (ping-pong, 2 planes each) and g = (gx, gy, It) (3 planes), each
// plane ex x ey = (TX + 2h) x (TY + 2h) floats, row-major. Half-sweep s
// (s = 2t red, 2t + 1 black, of iteration t) updates the cells of its colour
// in the extended tile shrunk by s + 1 a side: the dependence cone, so the
// tile's own cells equal k single steps.
//
// Colour-compacted lanes. A work item is one column of a half's region and
// a run of kElasticRun consecutive cells of the half's colour down it
// (2 kElasticRun rows): no lane visits a cell of the other colour. Consecutive threads take
// consecutive columns; two neighbouring columns start their runs one row
// apart, so with an even row pitch (ey) a warp's 32 loads fall in 32
// distinct banks. A thread keeps the 3 x 3 window of both planes around its
// cell in registers and slides it two rows a cell: 12 shared loads a cell
// after the first, against 18 for the stencil alone.
//
// Ping-pong without the copy. The red half reads cur and writes its red
// cells into nxt; the black half reads its red 4-neighbours from nxt and
// its own value and diagonals from cur, and writes its black cells into
// nxt; then the buffers swap. Every cell a later half reads was written by
// an earlier half of its colour (the regions shrink one cell a half), so nxt
// needs no copy of cur. Cells outside the image's interior take their own
// value, so border tiles need nothing else. The force at a cell reads the
// half's input there, the iteration's starting value in both halves.
//
// Two routes, one body: kInterior drops the border and ownership tests
// where the extended tile lies inside the image (and, for a strip, the
// padded strip, its own cells inside the strip's rows): there every one of
// those tests is true, so both routes give the same bits.
//
// Sums: each owned cell adds |u_t - u_{t-1}| and |u_{t-1}| in the half of
// its colour, per thread in loop order, then a warp shuffle tree and the
// warps in index order; partials.cuh adds the blocks in order. No float
// atomics, so the Logger error repeats exactly.
//
// Numerics: the candidate is sor_candidate (sor_stages.cuh) on the window,
// the plain version's expression in its order, built with -fmad=false.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"  // Region, Walk, for_cells, interior_tile, stage_region, cp.async
#include "partials.cuh"
#include "rows.cuh"
#include "sor_stages.cuh"  // SorScalars, sor_candidate
#include "tile_stages.cuh"  // StagedTile, store_tile, tile_partials

namespace {

// An elastic plan: a tx x ty output tile on ``threads`` threads, of which
// at least ``min_blocks`` stay resident on an SM (the register budget).
struct ElasticPlan {
  int tx, ty, threads, min_blocks;
};

// In order of preference: the first whose shared memory fits a thread block
// at the launch's k is taken. 48 x 48 on 512 threads holds two blocks an SM
// at k = 4 (115 KB each) and beat 64 x 64 at one block an SM
// (probes/elastic_block.py; PERF.md).
constexpr ElasticPlan kElasticPlans[] = {{48, 48, 512, 2}, {32, 32, 256, 3}};
constexpr int kElasticPlanCount = sizeof(kElasticPlans) / sizeof(kElasticPlans[0]);
constexpr int kElasticRun = 4;  // colour cells a thread takes down one column
constexpr int kElasticMaxStaticK = 4;  // k compiled in up to this; run time above

// Shared floats of one block: u twice and g on the extended tile, and the
// per-iteration warp partials [k][warps][2].
__host__ __device__ constexpr int elastic_smem_floats(int k, int tx, int ty, int threads) {
  return 7 * (tx + 4 * k) * (ty + 4 * k) + k * (threads / 32) * 2;
}

__host__ __device__ constexpr int elastic_smem_bytes(int k, const ElasticPlan& p) {
  return elastic_smem_floats(k, p.tx, p.ty, p.threads) * static_cast<int>(sizeof(float));
}

// The index of the first plan that fits at k, or -1.
inline int elastic_plan_index(int k) {
  for (int i = 0; i < kElasticPlanCount; ++i)
    if (elastic_smem_bytes(k, kElasticPlans[i]) <= kMaxSmemBytes) return i;
  return -1;
}

static_assert(elastic_smem_bytes(kElasticMaxStaticK, kElasticPlans[0]) <= kMaxSmemBytes,
              "the compiled-in k take the first plan");

// Row W (0: above, 1: the cell's, 2: below) of the 3 x 3 window around
// buffer cell l, both planes (plane stride pl), into x[c * 9 + W * 3 + j]:
// the cell's 4-neighbours, of the other colour, from nb, the others from cur.
template <int W>
__device__ __forceinline__ void window_row(float* x, const float* cur, const float* nb, int l,
                                           int pl) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* src = ((W + j) & 1) ? nb : cur;
    x[W * 3 + j] = src[l + j - 1];
    x[9 + W * 3 + j] = src[pl + l + j - 1];
  }
}

// Half-sweep s of colour P: every cell of colour P in the region shrunk by
// s + 1 takes its candidate (inside the image's interior) or its value,
// written to out. nb: where the 4-neighbours are read (P = 0: cur; P = 1:
// the red half's output). Adds the Logger magnitudes of the owned cells of
// this colour to dsum, psum (unless !kSums: the probe's breakdown and the
// fluid sweep). The force reads the half's input at the cell, or, with
// kFixedForce, the fixed field ``fu`` (two planes on the same buffer
// geometry): the fluid sweep's force at the motion u (fluid_iter.cu).
template <int NT, int R, int P, bool kRef, bool kInterior, bool kSums = true,
          bool kFixedForce = false>
__device__ __forceinline__ void elastic_half(const float* cur, const float* nb, float* out,
                                             const float* gs, const StagedTile& g, int s,
                                             int tx, int ty, const SorScalars& sc, float& dsum,
                                             float& psum, const float* fu = nullptr) {
  const int pl = g.ex * g.ey, e = g.ey;
  const int lo = s + 1, hi_r = g.ex - lo;
  const int cols = g.ey - 2 * lo;
  const int runs = (hi_r - lo + 2 * R - 1) / (2 * R);
  const int items = runs * cols;
  Walk w(threadIdx.x, NT, runs, cols);
  for (int item = threadIdx.x; item < items; item += NT, w.step()) {
    const int lj = lo + w.lj, gj = g.gj0 + lj;
    const int la = lo + w.li * (2 * R);
    const int end = la + 2 * R < hi_r ? la + 2 * R : hi_r;
    int li = la + ((g.gi0 + la + gj + P) & 1);
    if (li >= end) continue;
    const bool col_interior = kInterior || (gj >= 1 && gj <= g.ny - 2);
    const bool col_owned = lj >= g.h && lj < g.h + ty && (kInterior || gj < g.ny);
    int l = li * e + lj;
    float x[18];
    window_row<0>(x, cur, nb, l - e, pl);
    window_row<1>(x, cur, nb, l, pl);
    window_row<2>(x, cur, nb, l + e, pl);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int gi = g.gi0 + li;
      float n0 = x[4], n1 = x[13];
      if (col_interior && (kInterior || (gi >= 1 && gi <= g.nx - 2))) {
        const float gx = gs[l], gy = gs[pl + l];
        const float f0 = kFixedForce ? fu[l] : x[4], f1 = kFixedForce ? fu[pl + l] : x[13];
        const float inner = (gs[2 * pl + l] + f0 * gx) + f1 * gy;
        n0 = sor_candidate<kRef>(x, 9, 3, 4, 0, gx * inner, sc);
        n1 = sor_candidate<kRef>(x, 9, 3, 4, 1, gy * inner, sc);
      }
      if (kSums && col_owned && li >= g.h && li < g.h + tx && (kInterior || gi < g.gi_end)) {
        dsum += magnitude(n0 - x[4], n1 - x[13]);
        psum += magnitude(x[4], x[13]);
      }
      out[l] = n0;
      out[pl + l] = n1;
      li += 2;
      l += 2 * e;
      if (q + 1 == R || li >= end) break;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        x[j] = x[6 + j];
        x[9 + j] = x[15 + j];
      }
      window_row<1>(x, cur, nb, l, pl);
      window_row<2>(x, cur, nb, l + e, pl);
    }
  }
}

// The k iterations on a staged tile (u in cur, g in gs); returns the buffer
// holding u_k. The warp partials of iteration t go to red[t][warp][2].
template <int K, int NT, int R, bool kRef, bool kInterior>
__device__ __forceinline__ const float* elastic_iterations(float* cur, float* nxt,
                                                           const float* gs, float* red,
                                                           const StagedTile& g, int k, int tx,
                                                           int ty, const SorScalars& sc) {
  constexpr int kWarps = NT / 32;
#pragma unroll
  for (int t = 0; t < (K > 0 ? K : k); ++t) {
    float dsum = 0.f, psum = 0.f;
    elastic_half<NT, R, 0, kRef, kInterior>(cur, cur, nxt, gs, g, 2 * t, tx, ty, sc, dsum,
                                            psum);
    __syncthreads();
    elastic_half<NT, R, 1, kRef, kInterior>(cur, nxt, nxt, gs, g, 2 * t + 1, tx, ty, sc, dsum,
                                            psum);
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if ((threadIdx.x & 31) == 0) {
      red[(t * kWarps + (threadIdx.x >> 5)) * 2] = dsum;
      red[(t * kWarps + (threadIdx.x >> 5)) * 2 + 1] = psum;
    }
    __syncthreads();  // nxt is complete before the next red half reads it
    float* done = nxt;
    nxt = cur;
    cur = done;
  }
  return cur;
}

// B6 and K2 on one TX x TY tile per block; K > 0 compiles k in.
template <int K, int TX, int TY, int NT, int MB, bool kRef>
__global__ void __launch_bounds__(NT, MB)
elastic_block_kernel(const float* __restrict__ u, const float* __restrict__ g,
                     float* __restrict__ out, float* __restrict__ partials, Rows r, int ny,
                     int k_arg, SorScalars s) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : k_arg;
  const int h = 2 * k, ex = TX + 2 * h, ey = TY + 2 * h, pl = ex * ey;
  float* cur = smem;
  float* nxt = cur + 2 * pl;
  float* gs = nxt + 2 * pl;
  float* red = gs + 3 * pl;
  const int i0 = r.row0 + blockIdx.y * TX, j0 = blockIdx.x * TY;
  const StagedTile tile{ex, ey, h, i0 - h, j0 - h, r.nx, ny, r.row0 + r.nxl};
  const Region region{ex, ey, i0 - h, j0 - h};
  stage_region<NT>(u, 2, r, ny, region, cur);
  stage_region<NT>(g, 3, r, ny, region, gs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (interior_tile(r, ny, i0, j0, TX, TY, h)) {
    const float* uk = elastic_iterations<K, NT, kElasticRun, kRef, true>(cur, nxt, gs, red, tile,
                                                                          k, TX, TY, s);
    store_tile<NT, true>(uk, tile, TX, TY, r, i0, j0, out);
  } else {
    const float* uk = elastic_iterations<K, NT, kElasticRun, kRef, false>(cur, nxt, gs, red,
                                                                           tile, k, TX, TY, s);
    store_tile<NT, false>(uk, tile, TX, TY, r, i0, j0, out);
  }
  tile_partials<NT>(red, k, static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x,
                       partials);
}

__host__ __device__ constexpr int elastic_tiles(int nxl, int ny, int tx, int ty) {
  return ((nxl + tx - 1) / tx) * ((ny + ty - 1) / ty);
}

}  // namespace
