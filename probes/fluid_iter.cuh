// Variants of B7/B8/K3 for probes/fluid_iter.py: the form B7 had before its
// redesign (one 256-thread block per 32 x 32 tile, a warp a row of the 36
// columns, every cell of each half-sweep's square visited and the other
// colour copied, loads through registers), and the redesigned kernel with
// the knobs its design was chosen by: tile, threads, register budget
// (blocks an SM), colour cells a run, the interior route, R stored (B7) or
// not (B8).
// NHALF stops either after that many half-sweeps, and DERIV 0 stores the
// velocity buffer reached without the material derivative or the max, for
// a cumulative breakdown: NHALF 0 with DERIV 0 is the staging and the store.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>

#include "fluid_stages.cuh"
#include "probe_attrs.cuh"
#include "sor_before.cuh"

namespace {

// ---- B7 before its redesign ----
constexpr int kBeforeExt = kSorTile + 4;
constexpr int kBeforeExt2 = kBeforeExt * kBeforeExt;
constexpr int kBeforeSmemFloats = 9 * kBeforeExt2 + kSorThreadsX;

template <int NHALF, bool DERIV, bool kStoreR>
__global__ void __launch_bounds__(kSorThreads)
before_kernel(const float* __restrict__ u, const float* __restrict__ vel,
              const float* __restrict__ g, float* __restrict__ vel_out, float* __restrict__ r_out,
              float* __restrict__ partials, Rows rows, int ny, SorScalars s) {
  extern __shared__ float smem[];
  float* us = smem;
  float* cur = us + 2 * kBeforeExt2;
  float* nxt = cur + 2 * kBeforeExt2;
  float* gs = nxt + 2 * kBeforeExt2;
  float* warp_max = gs + 3 * kBeforeExt2;
  const int li0 = blockIdx.y * kSorTile - 2;
  const int gi0 = rows.row0 + li0;
  const int gj0 = blockIdx.x * kSorTile - 2;
  const int nx = rows.nx;
  load_tile(u, us, 2, rows, ny, li0, gj0, kBeforeExt);
  load_tile(vel, cur, 2, rows, ny, li0, gj0, kBeforeExt);
  load_tile(g, gs, 3, rows, ny, li0, gj0, kBeforeExt);
  __syncthreads();
  const float* v = cur;
  if (NHALF >= 1) {
    sor_half_sweep<true>(cur, nxt, us, gs, kBeforeExt, 1, kBeforeExt - 1, gi0, gj0, nx, ny, 0, s);
    __syncthreads();
    v = nxt;
  }
  if (NHALF >= 2) {
    sor_half_sweep<true>(nxt, cur, us, gs, kBeforeExt, 2, kBeforeExt - 2, gi0, gj0, nx, ny, 1, s);
    __syncthreads();
    v = cur;
  }
  const size_t n = rows.out_plane(ny);
  float m = 0.f;
  const int ty = threadIdx.x, tx = threadIdx.y;
  for (int li = 2 + tx; li < 2 + kSorTile; li += kSorThreadsX) {
    const int lr = li0 + li;
    if (lr >= rows.nxl) break;
    const int gi = gi0 + li;
    for (int lj = 2 + ty; lj < 2 + kSorTile; lj += kSorThreadsY) {
      const int gj = gj0 + lj;
      if (gj >= ny) break;
      const int l = li * kBeforeExt + lj;
      const float v0 = v[l], v1 = v[kBeforeExt2 + l];
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      vel_out[p] = v0;
      vel_out[n + p] = v1;
      if (!DERIV) continue;
      float r[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* uc = us + c * kBeforeExt2;
        const float dudx = central(uc[l - kBeforeExt], uc[l], uc[l + kBeforeExt], gi, nx);
        const float dudy = central(uc[l - 1], uc[l], uc[l + 1], gj, ny);
        r[c] = material_r(c == 0 ? v0 : v1, v0, v1, dudx, dudy);
      }
      if (kStoreR) {
        r_out[p] = r[0];
        r_out[n + p] = r[1];
      }
      m = fmaxf(m, r[0] * r[0] + r[1] * r[1]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if (ty == 0) warp_max[tx] = m;
  __syncthreads();
  if (tx == 0 && ty == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kSorThreadsX; ++w) bm = fmaxf(bm, warp_max[w]);
    partials[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = bm;
  }
}

template <int NHALF, bool DERIV, bool kStoreR>
int launch_before(const float* u, const float* vel, const float* g, float* vel_out, float* r_out,
                  float* partials, float* maxsq, const Rows& r, int ny, SorScalars s,
                  cudaStream_t stream) {
  auto* kernel = before_kernel<NHALF, DERIV, kStoreR>;
  constexpr int smem = kBeforeSmemFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sor_tiles(ny), sor_tiles(r.nxl));
  kernel<<<grid, dim3(kSorThreadsY, kSorThreadsX), smem, stream>>>(u, vel, g, vel_out, r_out,
                                                                    partials, r, ny, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, maxsq,
                                                     static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

// ---- the redesigned kernel, with its knobs ----

template <int NT, int R, bool kInterior, int NHALF, bool DERIV, bool kStoreR>
__device__ __forceinline__ float new_body(const float* us, float* cur, float* nxt, const float* gs,
                                          const StagedTile& g, int tx, int ty,
                                          const SorScalars& s, const Rows& r, int i0, int j0,
                                          float* vel_out, float* r_out) {
  float dsum = 0.f, psum = 0.f;
  const float* v = cur;
  if (NHALF >= 1) {
    elastic_half<NT, R, 0, true, kInterior, false, true>(cur, cur, nxt, gs, g, 0, tx, ty, s, dsum,
                                                         psum, us);
    __syncthreads();
    v = nxt;
  }
  if (NHALF >= 2) {
    elastic_half<NT, R, 1, true, kInterior, false, true>(cur, nxt, nxt, gs, g, 1, tx, ty, s, dsum,
                                                         psum, us);
    __syncthreads();
  }
  if (!DERIV) {
    store_tile<NT, kInterior>(v, g, tx, ty, r, i0, j0, vel_out);  // vel only
    return 0.f;
  }
  return fluid_tail<NT, kInterior, false, kStoreR>(v, us, g, tx, ty, r, i0, j0, vel_out, r_out);
}

template <int TX, int TY, int NT, int MB, int R, bool INTERIOR, int NHALF, bool DERIV,
          bool kStoreR>
__global__ void __launch_bounds__(NT, MB)
new_kernel(const float* __restrict__ u, const float* __restrict__ vel,
           const float* __restrict__ g, float* __restrict__ vel_out, float* __restrict__ r_out,
           float* __restrict__ partials, Rows r, int ny, SorScalars s) {
  extern __shared__ float smem[];
  constexpr int h = kFluidHalo, ex = TX + 2 * h, ey = TY + 2 * h, pl = ex * ey;
  float* us = smem;
  float* cur = us + 2 * pl;
  float* nxt = cur + 2 * pl;
  float* gs = nxt + 2 * pl;
  float* warp_max = gs + 3 * pl;
  const int i0 = r.row0 + blockIdx.y * TX, j0 = blockIdx.x * TY;
  const StagedTile tile{ex, ey, h, i0 - h, j0 - h, r.nx, ny, r.row0 + r.nxl};
  const Region region{ex, ey, i0 - h, j0 - h};
  stage_region<NT>(u, 2, r, ny, region, us);
  stage_region<NT>(vel, 2, r, ny, region, cur);
  stage_region<NT>(g, 3, r, ny, region, gs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float m =
      INTERIOR && interior_tile(r, ny, i0, j0, TX, TY, h)
          ? new_body<NT, R, true, NHALF, DERIV, kStoreR>(us, cur, nxt, gs, tile, TX, TY, s, r, i0,
                                                         j0, vel_out, r_out)
          : new_body<NT, R, false, NHALF, DERIV, kStoreR>(us, cur, nxt, gs, tile, TX, TY, s, r,
                                                          i0, j0, vel_out, r_out);
  fluid_block_max<NT>(m, warp_max, static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x,
                      partials);
}

template <int TX, int TY, int NT, int MB, int R, bool INTERIOR, int NHALF, bool DERIV,
          bool kStoreR>
int launch_new(const float* u, const float* vel, const float* g, float* vel_out, float* r_out,
               float* partials, float* maxsq, const Rows& r, int ny, SorScalars s,
               cudaStream_t stream) {
  auto* kernel = new_kernel<TX, TY, NT, MB, R, INTERIOR, NHALF, DERIV, kStoreR>;
  constexpr int smem = fluid_smem_floats(TX, TY, NT) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + TY - 1) / TY, (r.nxl + TX - 1) / TX);
  kernel<<<grid, NT, smem, stream>>>(u, vel, g, vel_out, r_out, partials, r, ny, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  max_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, maxsq,
                                                     static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
