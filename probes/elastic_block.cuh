// Variants of B6/K2 for probes/elastic_block.py: the form B6 had before its
// redesign (one 256-thread block per 32 x 32 tile, every cell of each
// half-sweep's square visited, the other colour copied, k at run time,
// synchronous loads), and the redesigned kernel with the knobs its design was
// chosen by: tile, threads, register budget (blocks an SM), cells a run,
// layout (ping-pong, or in place through registers), staging (cp.async or
// loads through registers), the interior route, k compiled in or not; and a
// persistent grid that stages the next tile while this one sweeps.
// NHALF stops either after that many half-sweeps and stores the buffer it
// reached, and SUMS drops the Logger magnitudes, for a cumulative breakdown:
// NHALF 0 is the staging and the store.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>

#include "elastic_stages.cuh"
#include "probe_attrs.cuh"
#include "sor_before.cuh"

namespace {

// ---- B6 before its redesign ----
// The half-sweep B6 ran before its redesign (sor_stages.cuh's, with the
// Logger sums): over the cells [lo, hi) x [lo, hi) of the tile, the cells
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
__device__ __forceinline__ void before_half_sweep(const float* x, float* out, const float* f,
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

__host__ __device__ constexpr int before_smem_floats(int k) {
  return 7 * (kSorTile + 4 * k) * (kSorTile + 4 * k) + k * kSorThreadsX * 2;
}

template <bool kRef, int NHALF, bool SUMS>
__global__ void __launch_bounds__(kSorThreads)
before_kernel(const float* __restrict__ u, const float* __restrict__ g, float* __restrict__ out,
              float* __restrict__ partials, Rows r, int ny, int k, SorScalars s) {
  extern __shared__ float smem[];
  const int h = 2 * k, e = kSorTile + 2 * h, ee = e * e;
  float* cur = smem;
  float* nxt = cur + 2 * ee;
  float* gs = nxt + 2 * ee;
  float* red = gs + 3 * ee;
  const int li0 = blockIdx.y * kSorTile - h;
  const int gi0 = r.row0 + li0;
  const int gj0 = blockIdx.x * kSorTile - h;
  const int gi_end = r.row0 + r.nxl;
  load_tile(u, cur, 2, r, ny, li0, gj0, e);
  load_tile(g, gs, 3, r, ny, li0, gj0, e);
  __syncthreads();
  const int ty = threadIdx.x, tx = threadIdx.y;
  for (int t = 0; t < k && 2 * t < NHALF; ++t) {
    float dsum = 0.f, psum = 0.f;
    before_half_sweep<kRef, false>(cur, nxt, cur, gs, e, 2 * t + 1, e - 2 * t - 1, gi0, gj0, r.nx,
                                ny, 0, s, 0, 0, gi_end, dsum, psum);
    __syncthreads();
    if (2 * t + 1 < NHALF)
      before_half_sweep<kRef, SUMS>(nxt, cur, nxt, gs, e, 2 * t + 2, e - 2 * t - 2, gi0, gj0, r.nx,
                                 ny, 1, s, h, h + kSorTile, gi_end, dsum, psum);
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if (ty == 0) {
      red[(t * kSorThreadsX + tx) * 2] = dsum;
      red[(t * kSorThreadsX + tx) * 2 + 1] = psum;
    }
    __syncthreads();
  }
  const size_t n = r.out_plane(ny);
  for (int li = h + tx; li < h + kSorTile; li += kSorThreadsX) {
    const int lr = li0 + li;
    if (lr >= r.nxl) break;
    for (int lj = h + ty; lj < h + kSorTile; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      if (gj >= ny) break;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      out[p] = cur[li * e + lj];
      out[n + p] = cur[ee + li * e + lj];
    }
  }
  const int tid = tx * kSorThreadsY + ty;
  if (tid < 2 * k) {
    float acc = 0.f;
    for (int w = 0; w < kSorThreadsX; ++w)
      acc += red[((tid >> 1) * kSorThreadsX + w) * 2 + (tid & 1)];
    partials[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * k + tid] = acc;
  }
}

template <bool kRef, int NHALF, bool SUMS>
int launch_before(const float* u, const float* g, float* out, float* partials, float* sums,
                  const Rows& r, int ny, int k, SorScalars s, cudaStream_t stream) {
  auto* kernel = before_kernel<kRef, NHALF, SUMS>;
  const int smem = before_smem_floats(k) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sor_tiles(ny), sor_tiles(r.nxl));
  kernel<<<grid, dim3(kSorThreadsY, kSorThreadsX), smem, stream>>>(u, g, out, partials, r, ny,
                                                                    k, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

// ---- the redesigned kernel, with its knobs ----

// Loads through registers instead of cp.async (STAGE 1).
template <int NT>
__device__ __forceinline__ void load_region(const float* __restrict__ src, int nplanes,
                                            const Rows& r, int ny, Region g, float* dst) {
  const size_t n = r.in_plane(ny);
  const int cells = g.rows * g.cols;
  for_cells<NT>(g.rows, g.cols, [&](int li, int lj, int l) {
    const int gi = g.gi0 + li, gj = g.gj0 + lj;
    const bool ok = r.loadable(gi - r.row0) && inside(gj, ny);
    const size_t p = ok ? r.in_row(gi - r.row0, ny) + gj : 0;
    for (int ch = 0; ch < nplanes; ++ch) dst[ch * cells + l] = ok ? __ldg(src + ch * n + p) : 0.f;
  });
}

// Layout (b): half-sweep s in place on the one u buffer. Every thread
// computes its cells' candidates into registers (at most M items of R
// cells), then the block waits, then each writes them over its cells.
template <int NT, int R, int P, int M, bool kRef, bool kInterior, bool kSums>
__device__ __forceinline__ void inplace_half(float* u, const float* gs, const StagedTile& g,
                                             int s, int tx, int ty, const SorScalars& sc,
                                             float& dsum, float& psum) {
  const int pl = g.ex * g.ey, e = g.ey;
  const int lo = s + 1, hi_r = g.ex - lo;
  const int cols = g.ey - 2 * lo;
  const int runs = (hi_r - lo + 2 * R - 1) / (2 * R);
  const int items = runs * cols;
  float c0[M][R], c1[M][R];
  int at[M], cnt[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    cnt[m] = 0;
    at[m] = 0;
    const int item = threadIdx.x + m * NT;
    if (item >= items) continue;
    const int run = item / cols;
    const int lj = lo + item - run * cols, gj = g.gj0 + lj;
    const int la = lo + run * (2 * R);
    const int end = la + 2 * R < hi_r ? la + 2 * R : hi_r;
    int li = la + ((g.gi0 + la + gj + P) & 1);
    const bool col_interior = kInterior || (gj >= 1 && gj <= g.ny - 2);
    const bool col_owned = lj >= g.h && lj < g.h + ty && (kInterior || gj < g.ny);
    int l = li * e + lj;
    at[m] = l;
    float x[18];
    if (li < end) {
      window_row<0>(x, u, u, l - e, pl);
      window_row<1>(x, u, u, l, pl);
      window_row<2>(x, u, u, l + e, pl);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (li >= end) break;
      const int gi = g.gi0 + li;
      float n0 = x[4], n1 = x[13];
      if (col_interior && (kInterior || (gi >= 1 && gi <= g.nx - 2))) {
        const float gx = gs[l], gy = gs[pl + l];
        const float inner = (gs[2 * pl + l] + x[4] * gx) + x[13] * gy;
        n0 = sor_candidate<kRef>(x, 9, 3, 4, 0, gx * inner, sc);
        n1 = sor_candidate<kRef>(x, 9, 3, 4, 1, gy * inner, sc);
      }
      if (kSums && col_owned && li >= g.h && li < g.h + tx && (kInterior || gi < g.gi_end)) {
        dsum += magnitude(n0 - x[4], n1 - x[13]);
        psum += magnitude(x[4], x[13]);
      }
      c0[m][q] = n0;
      c1[m][q] = n1;
      cnt[m] = q + 1;
      li += 2;
      l += 2 * e;
      if (q + 1 == R || li >= end) break;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        x[j] = x[6 + j];
        x[9 + j] = x[15 + j];
      }
      window_row<1>(x, u, u, l, pl);
      window_row<2>(x, u, u, l + e, pl);
    }
  }
  __syncthreads();  // every diagonal read before any cell is written
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < cnt[m]) {
        u[at[m] + 2 * q * e] = c0[m][q];
        u[pl + at[m] + 2 * q * e] = c1[m][q];
      }
    }
  }
}

__host__ __device__ constexpr int new_smem_floats(int k, int tx, int ty, int nt, int layout) {
  return (layout == 0 ? 7 : 5) * (tx + 4 * k) * (ty + 4 * k) + k * (nt / 32) * 2;
}

// The items of half-sweep 0, the largest, over NT threads: M of layout (b).
__host__ __device__ constexpr int inplace_items(int k, int tx, int ty, int nt, int r) {
  return k == 0 ? 1
                : (((tx + 4 * k - 2 + 2 * r - 1) / (2 * r)) * (ty + 4 * k - 2) + nt - 1) / nt;
}

template <int K, int TX, int TY, int NT, int R, bool kRef, int LAYOUT, int NHALF, bool SUMS,
          bool kInterior>
__device__ __forceinline__ const float* new_iterations(float* cur, float* nxt, const float* gs,
                                                       float* red, const StagedTile& g, int k,
                                                       const SorScalars& sc) {
  constexpr int kWarps = NT / 32;
  constexpr int M = inplace_items(K, TX, TY, NT, R);
#pragma unroll
  for (int t = 0; t < (K > 0 ? K : k); ++t) {
    if (2 * t >= NHALF) break;
    float dsum = 0.f, psum = 0.f;
    if constexpr (LAYOUT == 0) {
      elastic_half<NT, R, 0, kRef, kInterior, SUMS>(cur, cur, nxt, gs, g, 2 * t, TX, TY, sc,
                                                    dsum, psum);
      __syncthreads();
      if (2 * t + 1 < NHALF)
        elastic_half<NT, R, 1, kRef, kInterior, SUMS>(cur, nxt, nxt, gs, g, 2 * t + 1, TX, TY,
                                                      sc, dsum, psum);
    } else {
      inplace_half<NT, R, 0, M, kRef, kInterior, SUMS>(cur, gs, g, 2 * t, TX, TY, sc, dsum, psum);
      __syncthreads();
      if (2 * t + 1 < NHALF)
        inplace_half<NT, R, 1, M, kRef, kInterior, SUMS>(cur, gs, g, 2 * t + 1, TX, TY, sc, dsum,
                                                         psum);
    }
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if ((threadIdx.x & 31) == 0) {
      red[(t * kWarps + (threadIdx.x >> 5)) * 2] = dsum;
      red[(t * kWarps + (threadIdx.x >> 5)) * 2 + 1] = psum;
    }
    __syncthreads();
    if constexpr (LAYOUT == 0) {
      float* done = nxt;
      nxt = cur;
      cur = done;
    }
  }
  return cur;
}

template <int K, int TX, int TY, int NT, int MB, int R, bool kRef, int LAYOUT, int STAGE,
          bool INTERIOR, int NHALF, bool SUMS, int DELAY = 0>
__global__ void __launch_bounds__(NT, MB)
new_kernel(const float* __restrict__ u, const float* __restrict__ g, float* __restrict__ out,
           float* __restrict__ partials, Rows r, int ny, int k_arg, SorScalars s, int sms) {
  extern __shared__ float smem[];
  // DELAY > 0: the first wave's second block on each SM (block ids sms ..
  // 2 sms - 1) starts DELAY ns late, out of phase with the first.
  if (DELAY > 0) {
    const int bid = blockIdx.y * gridDim.x + blockIdx.x;
    if (bid >= sms && bid < 2 * sms) __nanosleep(DELAY);
  }
  const int k = K > 0 ? K : k_arg;
  const int h = 2 * k, ex = TX + 2 * h, ey = TY + 2 * h, pl = ex * ey;
  float* cur = smem;
  float* nxt = cur + (LAYOUT == 0 ? 2 * pl : 0);
  float* gs = cur + (LAYOUT == 0 ? 4 : 2) * pl;
  float* red = gs + 3 * pl;
  const int i0 = r.row0 + blockIdx.y * TX, j0 = blockIdx.x * TY;
  const StagedTile tile{ex, ey, h, i0 - h, j0 - h, r.nx, ny, r.row0 + r.nxl};
  const Region region{ex, ey, i0 - h, j0 - h};
  if (STAGE == 0) {
    stage_region<NT>(u, 2, r, ny, region, cur);
    stage_region<NT>(g, 3, r, ny, region, gs);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    load_region<NT>(u, 2, r, ny, region, cur);
    load_region<NT>(g, 3, r, ny, region, gs);
  }
  __syncthreads();
  if (INTERIOR && interior_tile(r, ny, i0, j0, TX, TY, h)) {
    const float* uk =
        new_iterations<K, TX, TY, NT, R, kRef, LAYOUT, NHALF, SUMS, true>(cur, nxt, gs, red,
                                                                          tile, k, s);
    store_tile<NT, true>(uk, tile, TX, TY, r, i0, j0, out);
  } else {
    const float* uk =
        new_iterations<K, TX, TY, NT, R, kRef, LAYOUT, NHALF, SUMS, false>(cur, nxt, gs, red,
                                                                           tile, k, s);
    store_tile<NT, false>(uk, tile, TX, TY, r, i0, j0, out);
  }
  tile_partials<NT>(red, k, static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x, partials);
}

template <int K, int TX, int TY, int NT, int MB, int R, bool kRef, int LAYOUT, int STAGE,
          bool INTERIOR, int NHALF, bool SUMS, int DELAY = 0>
int launch_new(const float* u, const float* g, float* out, float* partials, float* sums,
               const Rows& r, int ny, int k, SorScalars s, cudaStream_t stream) {
  auto* kernel =
      new_kernel<K, TX, TY, NT, MB, R, kRef, LAYOUT, STAGE, INTERIOR, NHALF, SUMS, DELAY>;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int smem = new_smem_floats(k, TX, TY, NT, LAYOUT) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + TY - 1) / TY, (r.nxl + TX - 1) / TX);
  kernel<<<grid, NT, smem, stream>>>(u, g, out, partials, r, ny, k, s, sms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

// A persistent grid over the tiles: NB staging areas of u and g (5 planes
// each) and the second u buffer; with NB = 2 the next tile's copies are in
// flight while this one sweeps.
__host__ __device__ constexpr int pers_smem_floats(int k, int tx, int ty, int nt, int nb) {
  return (5 * nb + 2) * (tx + 4 * k) * (ty + 4 * k) + k * (nt / 32) * 2;
}

template <int K, int TX, int TY, int NT, int MB, int R, bool kRef, int NB>
__global__ void __launch_bounds__(NT, MB)
pers_kernel(const float* __restrict__ u, const float* __restrict__ g, float* __restrict__ out,
            float* __restrict__ partials, Rows r, int ny, int k_arg, SorScalars s) {
  extern __shared__ float smem[];
  const int k = K > 0 ? K : k_arg;
  const int h = 2 * k, ex = TX + 2 * h, ey = TY + 2 * h, pl = ex * ey;
  float* extra = smem + NB * 5 * pl;
  float* red = extra + 2 * pl;
  const int tiles_y = (ny + TY - 1) / TY, tiles = elastic_tiles(r.nxl, ny, TX, TY);
  auto stage = [&](int t, float* dst) {
    const int i0 = r.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    const Region region{ex, ey, i0 - h, j0 - h};
    stage_region<NT>(u, 2, r, ny, region, dst);
    stage_region<NT>(g, 3, r, ny, region, dst + 2 * pl);
    cp_async_commit();
  };
  int t = blockIdx.x, buf = 0;
  if (NB == 2 && t < tiles) stage(t, smem);
  for (; t < tiles; t += gridDim.x, buf ^= 1) {
    float* area = smem;
    if (NB == 2) {
      const int next = t + gridDim.x;
      if (next < tiles) stage(next, smem + (buf ^ 1) * 5 * pl);
      else cp_async_commit();
      cp_async_wait<1>();
      area = smem + buf * 5 * pl;
    } else {
      stage(t, area);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = r.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    const StagedTile tile{ex, ey, h, i0 - h, j0 - h, r.nx, ny, r.row0 + r.nxl};
    if (interior_tile(r, ny, i0, j0, TX, TY, h)) {
      const float* uk = elastic_iterations<K, NT, R, kRef, true>(area, extra, area + 2 * pl, red,
                                                                  tile, k, TX, TY, s);
      store_tile<NT, true>(uk, tile, TX, TY, r, i0, j0, out);
    } else {
      const float* uk = elastic_iterations<K, NT, R, kRef, false>(area, extra, area + 2 * pl, red,
                                                                   tile, k, TX, TY, s);
      store_tile<NT, false>(uk, tile, TX, TY, r, i0, j0, out);
    }
    tile_partials<NT>(red, k, t, partials);
    __syncthreads();
  }
}

template <int K, int TX, int TY, int NT, int MB, int R, bool kRef, int NB>
int launch_pers(const float* u, const float* g, float* out, float* partials, float* sums,
                const Rows& r, int ny, int k, SorScalars s, cudaStream_t stream) {
  static GridCache cache;
  auto* kernel = pers_kernel<K, TX, TY, NT, MB, R, kRef, NB>;
  const int smem = pers_smem_floats(k, TX, TY, NT, NB) * 4;
  const int tiles = elastic_tiles(r.nxl, ny, TX, TY);
  int blocks;
  const int rc = persistent_grid(kernel, NT, smem, tiles, &cache, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, NT, smem, stream>>>(u, g, out, partials, r, ny, k, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, tiles, 2 * k, stream);
}

}  // namespace
