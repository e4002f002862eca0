// Variants of B1/K1 for probes/diffusion_block.py: the form B1 had before its
// redesign (one 256-thread block per 32 x 32 tile, a warp a row of the 46
// columns, a `continue` per cell outside the image, k at run time, loads
// through registers), and the redesigned kernel with the knobs its design
// was chosen by: tile, threads, register budget (blocks an SM), cells a
// run, the order of the work items (one walk over the region, or the owned
// tile's items first: SPLIT), the interior route, k compiled in or not.
// NSTEPS stops either after that many steps and stores the buffer it
// reached, and SUMS drops the Logger magnitudes, for a cumulative
// breakdown: NSTEPS 0 is the staging and the store.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>

#include "diffusion_stages.cuh"
#include "probe_attrs.cuh"

namespace {

// ---- B1 before its redesign ----
constexpr int kBeforeTile = 32, kBeforeThreadsY = 32, kBeforeThreadsX = 8;
constexpr int kBeforeThreads = kBeforeThreadsX * kBeforeThreadsY;

__host__ __device__ constexpr int before_smem_floats(int k) {
  return 7 * (kBeforeTile + 2 * k) * (kBeforeTile + 2 * k) + k * kBeforeThreadsX * 2;
}

template <int NSTEPS, bool SUMS>
__global__ void __launch_bounds__(kBeforeThreads)
before_kernel(const float* __restrict__ u, const float* __restrict__ g, float* __restrict__ out,
              float* __restrict__ partials, Rows r, int ny, int k, float a2) {
  extern __shared__ float smem[];
  const int e = kBeforeTile + 2 * k;
  const int ee = e * e;
  float* cur = smem;
  float* nxt = cur + 2 * ee;
  float* gs = nxt + 2 * ee;
  float* red = gs + 3 * ee;
  const size_t n = r.in_plane(ny);
  const int i0 = blockIdx.y * kBeforeTile - k;
  const int j0 = blockIdx.x * kBeforeTile - k;
  const int ty = threadIdx.x, tx = threadIdx.y;
  for (int li = tx; li < e; li += kBeforeThreadsX) {
    const bool row_ok = r.loadable(i0 + li);
    const size_t row = r.in_row(i0 + li, ny);
    for (int lj = ty; lj < e; lj += kBeforeThreadsY) {
      const int gj = j0 + lj;
      const int l = li * e + lj;
      float v0 = 0.f, v1 = 0.f, x = 0.f, y = 0.f, t = 0.f;
      if (row_ok && gj >= 0 && gj < ny) {
        const size_t p = row + gj;
        v0 = u[p];
        v1 = u[n + p];
        x = g[p];
        y = g[n + p];
        t = g[2 * n + p];
      }
      cur[l] = v0;
      cur[ee + l] = v1;
      gs[l] = x;
      gs[ee + l] = y;
      gs[2 * ee + l] = t;
    }
  }
  __syncthreads();
  for (int s = 0; s < k && s < NSTEPS; ++s) {
    float dsum = 0.f, psum = 0.f;
    const int lo = s + 1, hi = e - s - 1;
    for (int li = lo + tx; li < hi; li += kBeforeThreadsX) {
      const int gi = r.row0 + i0 + li;
      if (gi < 0 || gi >= r.nx) continue;
      const bool interior_row = li >= k && li < k + kBeforeTile && i0 + li < r.nxl;
      for (int lj = lo + ty; lj < hi; lj += kBeforeThreadsY) {
        const int gj = j0 + lj;
        if (gj < 0 || gj >= ny) continue;
        const int l = li * e + lj;
        float q0 = 0.f, q1 = 0.f;
        if (gi > 0 && gi < r.nx - 1 && gj > 0 && gj < ny - 1) {
          const float* c1 = cur + ee;
          q0 = (cur[l - e] + cur[l + e] + (cur[l - 1] + cur[l + 1])) * 0.25f;
          q1 = (c1[l - e] + c1[l + e] + (c1[l - 1] + c1[l + 1])) * 0.25f;
        }
        const float x = gs[l], y = gs[ee + l];
        const float inner = gs[2 * ee + l] + q0 * x + q1 * y;
        const float den = a2 + x * x + y * y;
        const float scale = inner / den;
        const float n0 = q0 - x * scale;
        const float n1 = q1 - y * scale;
        nxt[l] = n0;
        nxt[ee + l] = n1;
        if (SUMS && interior_row && lj >= k && lj < k + kBeforeTile) {
          const float p0 = cur[l], p1 = cur[ee + l];
          dsum += magnitude(n0 - p0, n1 - p1);
          psum += magnitude(p0, p1);
        }
      }
    }
    dsum = warp_sum(dsum);
    psum = warp_sum(psum);
    if (ty == 0) {
      red[(s * kBeforeThreadsX + tx) * 2] = dsum;
      red[(s * kBeforeThreadsX + tx) * 2 + 1] = psum;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const size_t n_out = r.out_plane(ny);
  for (int li = k + tx; li < k + kBeforeTile; li += kBeforeThreadsX) {
    const int lr = i0 + li;
    if (lr >= r.nxl) break;
    for (int lj = k + ty; lj < k + kBeforeTile; lj += kBeforeThreadsY) {
      const int gj = j0 + lj;
      if (gj >= ny) break;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      const int l = li * e + lj;
      out[p] = cur[l];
      out[n_out + p] = cur[ee + l];
    }
  }
  const int tid = tx * kBeforeThreadsY + ty;
  if (tid < 2 * k) {
    const int s = tid >> 1, c = tid & 1;
    float acc = 0.f;
    for (int w = 0; w < kBeforeThreadsX; ++w) acc += red[(s * kBeforeThreadsX + w) * 2 + c];
    partials[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * k + tid] = acc;
  }
}

template <int NSTEPS, bool SUMS>
int launch_before(const float* u, const float* g, float* out, float* partials, float* sums,
                  const Rows& r, int ny, int k, float a2, cudaStream_t stream) {
  auto* kernel = before_kernel<NSTEPS, SUMS>;
  const int smem = before_smem_floats(k) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + kBeforeTile - 1) / kBeforeTile, (r.nxl + kBeforeTile - 1) / kBeforeTile);
  kernel<<<grid, dim3(kBeforeThreadsY, kBeforeThreadsX), smem, stream>>>(u, g, out, partials, r,
                                                                          ny, k, a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

// ---- the redesigned kernel, with its knobs ----

// One run of a step: the cells la .. end - 1 of column lj take their Jacobi
// update from cur into out. kSums: the run lies in the owned tile, and its
// cells (inside the image and the launch's rows) add their Logger
// magnitudes to dsum, psum.
template <int R, bool kInterior, bool kSums>
__device__ __forceinline__ void diffusion_run(const float* cur, float* out, const float* gs,
                                              const StagedTile& g, int la, int end, int lj,
                                              float a2, float& dsum, float& psum) {
  const int pl = g.ex * g.ey, e = g.ey;
  const int gj = g.gj0 + lj;
  const bool col_interior = kInterior || (gj >= 1 && gj <= g.ny - 2);
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
    if (kSums && (kInterior || (gi < g.gi_end && gj < g.ny))) {
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

// SPLIT 1: step s with its work items in three segments of one flattened
// index, consecutive threads on consecutive items, so that the Logger sums
// run on whole warps: the owned tile (runs aligned to its rows, every run
// full, each adding its sums), its left and right bands, and the top and
// bottom bands of the region (runs cut at the bands' ends). The owned tile
// has a multiple of 32 items, so no warp mixes cells with and without sums.
template <int NT, int R, bool kInterior, bool kSums>
__device__ __forceinline__ void owned_first_step(const float* cur, float* out, const float* gs,
                                               const StagedTile& g, int s, int tx, int ty,
                                               float a2, float& dsum, float& psum) {
  const int lo = s + 1, h = g.h;
  const int a = h - lo;                     // the bands' depth
  const int w = g.ey - 2 * lo;              // the top and bottom bands' width
  const int band_runs = (a + R - 1) / R;    // runs down a column of one band
  const int n_core = (tx / R) * ty;
  const int n_side = (tx / R) * 2 * a;
  const int n_items = n_core + n_side + 2 * band_runs * w;
  for (int it = threadIdx.x; it < n_items; it += NT) {
    if (it < n_core) {
      const int m = it / ty;
      const int la = h + m * R;
      diffusion_run<R, kInterior, kSums>(cur, out, gs, g, la, la + R, h + it - m * ty, a2, dsum,
                                         psum);
    } else if (it < n_core + n_side) {
      const int j = it - n_core, side = a > 0 ? 2 * a : 1, m = j / side, c = j - m * side;
      const int la = h + m * R;
      const int lj = c < a ? lo + c : h + ty + c - a;
      diffusion_run<R, kInterior, false>(cur, out, gs, g, la, la + R, lj, a2, dsum, psum);
    } else {
      const int j = it - n_core - n_side, m = j / w, c = j - m * w;
      const bool top = m < band_runs;
      const int la = top ? lo + m * R : h + tx + (m - band_runs) * R;
      const int band_end = top ? h : g.ex - lo;
      const int end = la + R < band_end ? la + R : band_end;
      diffusion_run<R, kInterior, false>(cur, out, gs, g, la, end, lo + c, a2, dsum, psum);
    }
  }
}

template <int K, int NT, int R, int NSTEPS, bool SUMS, bool kInterior, bool SPLIT>
__device__ __forceinline__ const float* new_iterations(float* cur, float* nxt, const float* gs,
                                                       float* red, const StagedTile& g, int k,
                                                       int tx, int ty, float a2) {
#pragma unroll
  for (int t = 0; t < (K > 0 ? K : k); ++t) {
    if (t >= NSTEPS) break;
    float dsum = 0.f, psum = 0.f;
    if (SPLIT)
      owned_first_step<NT, R, kInterior, SUMS>(cur, nxt, gs, g, t, tx, ty, a2, dsum, psum);
    else
      diffusion_step<NT, R, kInterior, SUMS>(cur, nxt, gs, g, t, tx, ty, a2, dsum, psum);
    diffusion_warp_partials<NT>(dsum, psum, t, red);
    __syncthreads();
    float* done = nxt;
    nxt = cur;
    cur = done;
  }
  return cur;
}

template <int K, int TX, int TY, int NT, int MB, int R, bool INTERIOR, int NSTEPS, bool SUMS,
          bool SPLIT>
__global__ void __launch_bounds__(NT, MB)
new_kernel(const float* __restrict__ u, const float* __restrict__ g, float* __restrict__ out,
           float* __restrict__ partials, Rows r, int ny, int k_arg, float a2) {
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
  if (INTERIOR && interior_tile(r, ny, i0, j0, TX, TY, k)) {
    const float* uk =
        new_iterations<K, NT, R, NSTEPS, SUMS, true, SPLIT>(cur, nxt, gs, red, tile, k, TX, TY, a2);
    store_tile<NT, true>(uk, tile, TX, TY, r, i0, j0, out);
  } else {
    const float* uk =
        new_iterations<K, NT, R, NSTEPS, SUMS, false, SPLIT>(cur, nxt, gs, red, tile, k, TX, TY, a2);
    store_tile<NT, false>(uk, tile, TX, TY, r, i0, j0, out);
  }
  tile_partials<NT>(red, k, static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x,
                         partials);
}

template <int K, int TX, int TY, int NT, int MB, int R, bool INTERIOR, int NSTEPS, bool SUMS,
          bool SPLIT>
int launch_new(const float* u, const float* g, float* out, float* partials, float* sums,
               const Rows& r, int ny, int k, float a2, cudaStream_t stream) {
  auto* kernel = new_kernel<K, TX, TY, NT, MB, R, INTERIOR, NSTEPS, SUMS, SPLIT>;
  const int smem = diffusion_smem_floats(k, TX, TY, NT) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + TY - 1) / TY, (r.nxl + TX - 1) / TX);
  kernel<<<grid, NT, smem, stream>>>(u, g, out, partials, r, ny, k, a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum_partials(partials, sums, static_cast<int>(grid.x * grid.y), 2 * k, stream);
}

}  // namespace
