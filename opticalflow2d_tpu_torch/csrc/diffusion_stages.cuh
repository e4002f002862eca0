// The stages of the diffusion block kernel (diffusion_block.cu: B1 and its
// strip mode K1) on one tile in shared memory: staging, the k Jacobi steps
// with the Logger sums, and the store. probes/diffusion_block.cuh builds the
// variants the design was chosen from out of the same functions.
//
// Geometry. A thread block owns a TX x TY output tile (x rows by y columns,
// y the contiguous axis) and stages it with a halo of h = k cells a side: u
// twice (ping-pong, 2 planes each) and g = (gx, gy, It) (3 planes), each
// plane ex x ey = (TX + 2h) x (TY + 2h) floats, row-major. Step s updates
// every cell of the extended tile shrunk by s + 1 a side: the dependence
// cone, so the tile's own cells equal k single steps.
//
// Lanes. A work item is one column of a step's region and a run of
// kDiffusionRun consecutive cells down it; items are flattened over
// (run, column), consecutive threads on consecutive columns, so no lane
// idles on a column count that is not a multiple of 32 and none skips a
// cell. A thread keeps the column's above, cell and below values of both
// planes in registers and slides them one row a cell: the left and right
// neighbours and g come from shared memory, 9 loads a cell against 11 for
// the stencil and g alone.
//
// Two routes, one body: kInterior drops the border and ownership tests
// where the extended tile lies inside the image (and, for a strip, the
// padded strip, its own cells inside the strip's rows): there every one of
// those tests is true, so both routes give the same bits. Elsewhere a cell
// outside the image's interior takes q = 0, as the plain version masks it;
// cells outside the image hold g = 0 and are read by no image cell (the
// border's q reads no neighbour), so what they compute is never used.
//
// Sums: each owned cell adds |u_t - u_{t-1}| and |u_{t-1}| in step t, per
// thread in loop order, then a warp shuffle tree and the warps in index
// order; partials.cuh adds the blocks in order. No float atomics, so the
// Logger error repeats exactly.
//
// Numerics: each cell's expressions in the plain version's order
// (diffusion_fused.py::diffusion_step_ref), IEEE division and square root,
// built with -fmad=false.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"  // Region, Walk, for_cells, interior_tile, stage_region, cp.async
#include "partials.cuh"
#include "rows.cuh"
#include "tile_stages.cuh"  // StagedTile, store_tile, tile_partials

namespace {

// A diffusion plan: a tx x ty output tile on ``threads`` threads, of which
// at least ``min_blocks`` stay resident on an SM (the register budget).
struct DiffusionPlan {
  int tx, ty, threads, min_blocks;
};

// In order of preference: the first whose shared memory fits a thread block
// at the launch's k is taken. 48 x 48 on 512 threads holds two blocks an SM
// at k = 8 (115,712 B each, the SM's 228 KiB with their reservations)
// (probes/diffusion_block.py; PERF.md).
constexpr DiffusionPlan kDiffusionPlans[] = {{48, 48, 512, 2}, {32, 32, 256, 3}};
constexpr int kDiffusionPlanCount = sizeof(kDiffusionPlans) / sizeof(kDiffusionPlans[0]);
constexpr int kDiffusionRun = 2;      // cells a thread takes down one column
constexpr int kDiffusionStaticK = 8;  // the one k compiled in (the default block_k)

// Shared floats of one block: u twice and g on the extended tile, and the
// per-iteration warp partials [k][warps][2].
__host__ __device__ constexpr int diffusion_smem_floats(int k, int tx, int ty, int threads) {
  return 7 * (tx + 2 * k) * (ty + 2 * k) + k * (threads / 32) * 2;
}

__host__ __device__ constexpr int diffusion_smem_bytes(int k, const DiffusionPlan& p) {
  return diffusion_smem_floats(k, p.tx, p.ty, p.threads) * static_cast<int>(sizeof(float));
}

// The index of the first plan that fits at k, or -1.
inline int diffusion_plan_index(int k) {
  for (int i = 0; i < kDiffusionPlanCount; ++i)
    if (diffusion_smem_bytes(k, kDiffusionPlans[i]) <= kMaxSmemBytes) return i;
  return -1;
}

static_assert(diffusion_smem_bytes(kDiffusionStaticK, kDiffusionPlans[0]) <= kMaxSmemBytes,
              "the compiled-in k takes the first plan");

__host__ __device__ constexpr int diffusion_tiles(int nxl, int ny, int tx, int ty) {
  return ((nxl + tx - 1) / tx) * ((ny + ty - 1) / ty);
}

// Step s: every cell of the region shrunk by s + 1 takes its Jacobi update
// from cur into out. Adds the Logger magnitudes of the owned cells to dsum,
// psum (unless !kSums: the probe's breakdown).
template <int NT, int R, bool kInterior, bool kSums = true>
__device__ __forceinline__ void diffusion_step(const float* cur, float* out, const float* gs,
                                               const StagedTile& g, int s, int tx, int ty,
                                               float a2, float& dsum, float& psum) {
  const int pl = g.ex * g.ey, e = g.ey;
  const int lo = s + 1, hi_r = g.ex - lo;
  const int cols = g.ey - 2 * lo;
  const int runs = (hi_r - lo + R - 1) / R;
  const int items = runs * cols;
  Walk w(threadIdx.x, NT, runs, cols);
  for (int item = threadIdx.x; item < items; item += NT, w.step()) {
    const int lj = lo + w.lj, gj = g.gj0 + lj;
    const int la = lo + w.li * R;
    const int end = la + R < hi_r ? la + R : hi_r;
    const bool col_interior = kInterior || (gj >= 1 && gj <= g.ny - 2);
    const bool col_owned = lj >= g.h && lj < g.h + ty && (kInterior || gj < g.ny);
    int l = la * e + lj;
    float up0 = cur[l - e], up1 = cur[pl + l - e];
    float c0 = cur[l], c1 = cur[pl + l];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int li = la + q, gi = g.gi0 + li;
      const float dn0 = cur[l + e], dn1 = cur[pl + l + e];
      float q0 = 0.f, q1 = 0.f;
      if (col_interior && (kInterior || (gi >= 1 && gi <= g.nx - 2))) {
        q0 = (up0 + dn0 + (cur[l - 1] + cur[l + 1])) * 0.25f;
        q1 = (up1 + dn1 + (cur[pl + l - 1] + cur[pl + l + 1])) * 0.25f;
      }
      const float x = gs[l], y = gs[pl + l];
      const float inner = gs[2 * pl + l] + q0 * x + q1 * y;
      const float den = a2 + x * x + y * y;
      const float scale = inner / den;
      const float n0 = q0 - x * scale;
      const float n1 = q1 - y * scale;
      out[l] = n0;
      out[pl + l] = n1;
      if (kSums && col_owned && li >= g.h && li < g.h + tx && (kInterior || gi < g.gi_end)) {
        dsum += magnitude(n0 - c0, n1 - c1);
        psum += magnitude(c0, c1);
      }
      if (q + 1 == R || li + 1 >= end) break;
      up0 = c0;
      up1 = c1;
      c0 = dn0;
      c1 = dn1;
      l += e;
    }
  }
}

// The warp partials of step t into red[t][warp][2].
template <int NT>
__device__ __forceinline__ void diffusion_warp_partials(float dsum, float psum, int t,
                                                        float* red) {
  constexpr int kWarps = NT / 32;
  dsum = warp_sum(dsum);
  psum = warp_sum(psum);
  if ((threadIdx.x & 31) == 0) {
    red[(t * kWarps + (threadIdx.x >> 5)) * 2] = dsum;
    red[(t * kWarps + (threadIdx.x >> 5)) * 2 + 1] = psum;
  }
}

// The k steps on a staged tile (u in cur, g in gs); returns the buffer
// holding u_k.
template <int K, int NT, int R, bool kInterior>
__device__ __forceinline__ const float* diffusion_iterations(float* cur, float* nxt,
                                                             const float* gs, float* red,
                                                             const StagedTile& g, int k,
                                                             int tx, int ty, float a2) {
#pragma unroll
  for (int t = 0; t < (K > 0 ? K : k); ++t) {
    float dsum = 0.f, psum = 0.f;
    diffusion_step<NT, R, kInterior>(cur, nxt, gs, g, t, tx, ty, a2, dsum, psum);
    diffusion_warp_partials<NT>(dsum, psum, t, red);
    __syncthreads();  // nxt is complete before the next step reads it
    float* done = nxt;
    nxt = cur;
    cur = done;
  }
  return cur;
}

// Stage u and g on the tile's extended region with cp.async and wait.
template <int NT>
__device__ __forceinline__ void diffusion_stage(const float* __restrict__ u,
                                                const float* __restrict__ g, const Rows& r,
                                                int ny, const StagedTile& t, float* cur,
                                                float* gs) {
  const Region region{t.ex, t.ey, t.gi0, t.gj0};
  stage_region<NT>(u, 2, r, ny, region, cur);
  stage_region<NT>(g, 3, r, ny, region, gs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// B1 and K1 on one TX x TY tile per block; K > 0 compiles k in.
template <int K, int TX, int TY, int NT, int MB>
__global__ void __launch_bounds__(NT, MB)
diffusion_block_kernel(const float* __restrict__ u, const float* __restrict__ g,
                       float* __restrict__ out, float* __restrict__ partials, Rows r, int ny,
                       int k_arg, float a2) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : k_arg;
  const int ex = TX + 2 * k, ey = TY + 2 * k, pl = ex * ey;
  float* cur = smem;
  float* nxt = cur + 2 * pl;
  float* gs = nxt + 2 * pl;
  float* red = gs + 3 * pl;
  const int i0 = r.row0 + blockIdx.y * TX, j0 = blockIdx.x * TY;
  const StagedTile tile{ex, ey, k, i0 - k, j0 - k, r.nx, ny, r.row0 + r.nxl};
  diffusion_stage<NT>(u, g, r, ny, tile, cur, gs);
  if (interior_tile(r, ny, i0, j0, TX, TY, k)) {
    const float* uk = diffusion_iterations<K, NT, kDiffusionRun, true>(cur, nxt, gs, red, tile,
                                                                       k, TX, TY, a2);
    store_tile<NT, true>(uk, tile, TX, TY, r, i0, j0, out);
  } else {
    const float* uk = diffusion_iterations<K, NT, kDiffusionRun, false>(cur, nxt, gs, red, tile,
                                                                        k, TX, TY, a2);
    store_tile<NT, false>(uk, tile, TX, TY, r, i0, j0, out);
  }
  tile_partials<NT>(red, k, static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x,
                         partials);
}

}  // namespace
