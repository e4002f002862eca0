// The stages of the fluid iteration kernels (fluid_iter.cu: B7, its pair
// axis, B8 and the strip mode K3) on one tile in shared memory: staging,
// the red and black SOR half-sweeps of the velocity, and the material
// derivative with its store and max |R|^2. probes/fluid_iter.cuh builds
// the variants the design was chosen from out of the same functions.
//
// Geometry. A thread block owns a TX x TY output tile and stages it with a
// halo of 2 cells a side: u (2 planes), the velocity (2 planes), a second
// velocity buffer and g = (gx, gy, It) (3 planes), each plane (TX + 4) x
// (TY + 4) floats. The sweep is elastic_stages.cuh's at k = 1: the red half
// on the tile shrunk by 1 reads cur and writes its red cells into nxt, the
// black half on the tile shrunk by 2 reads its red 4-neighbours from nxt and
// writes its black cells there, so nxt holds vel' over the owned tile
// without a copy; lanes are compacted by colour, each thread sliding a 3 x 3
// register window down a run of its column's cells of the half's colour.
// The one difference from elastic: the force reads the fixed motion u, not
// the half's input (kFixedForce).
//
// Tail. The material derivative R = v - du/dx v_x - du/dy v_y over the
// owned tile, flattened over its cells (coalesced stores of vel' and, for
// B7, R), and the tile's max |R|^2 (exact in any order).
//
// Two routes, one body: kInterior drops the border tests where the tile's
// region lies inside the image (and the padded strip): there every one of
// them is true, so both routes give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"  // Region, for_cells, interior_tile, stage_region, cp.async
#include "elastic_stages.cuh"  // elastic_half
#include "material_derivative.cuh"
#include "rows.cuh"
#include "sor_stages.cuh"
#include "tile_stages.cuh"  // StagedTile

namespace {

// A fluid plan: a tx x ty output tile on ``threads`` threads, at least
// ``min_blocks`` resident on an SM (the register budget).
struct FluidPlan {
  int tx, ty, threads, min_blocks;
};

// The tile every fluid launch takes (probes/fluid_iter.py; PERF.md).
constexpr FluidPlan kFluidPlan = {32, 64, 512, 2};
constexpr int kFluidRun = 2;  // colour cells a thread takes down one column
constexpr int kFluidHalo = 2;

// Shared floats of one block: u, two velocity buffers and g (9 planes) on
// the extended tile, and one max per warp.
__host__ __device__ constexpr int fluid_smem_floats(int tx, int ty, int threads) {
  return 9 * (tx + 2 * kFluidHalo) * (ty + 2 * kFluidHalo) + threads / 32;
}

__host__ __device__ constexpr int fluid_smem_bytes(const FluidPlan& p) {
  return fluid_smem_floats(p.tx, p.ty, p.threads) * static_cast<int>(sizeof(float));
}

__host__ __device__ constexpr int fluid_tiles(int nxl, int ny, int tx, int ty) {
  return ((nxl + tx - 1) / tx) * ((ny + ty - 1) / ty);
}

// The material derivative over the owned tile from the swept velocity vel
// and u (both staged); writes vel' and, with kStoreR, R into [2, r.nxl, ny]
// planes, and returns the thread's max |R|^2 (Motion::maxabs,
// src/Motion.cpp:51-58; the bug sums y twice).
template <int NT, bool kInterior, bool kMaxabsBug, bool kStoreR>
__device__ __forceinline__ float fluid_tail(const float* vel, const float* us,
                                            const StagedTile& g, int tx, int ty, const Rows& r,
                                            int i0, int j0, float* __restrict__ vel_out,
                                            float* __restrict__ r_out) {
  const size_t n = r.out_plane(g.ny);
  const int pl = g.ex * g.ey, e = g.ey;
  float m = 0.f;
  for_cells<NT>(tx, ty, [&](int li, int lj, int) {
    const int gi = i0 + li, gj = j0 + lj, lr = gi - r.row0;
    if (!kInterior && (lr >= r.nxl || gj >= g.ny)) return;
    const int l = (li + g.h) * e + lj + g.h;
    const float v0 = vel[l], v1 = vel[pl + l];
    float rc[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* uc = us + c * pl;
      const float dudx = kInterior ? (uc[l + e] - uc[l - e]) * 0.5f
                                   : central(uc[l - e], uc[l], uc[l + e], gi, g.nx);
      const float dudy = kInterior ? (uc[l + 1] - uc[l - 1]) * 0.5f
                                   : central(uc[l - 1], uc[l], uc[l + 1], gj, g.ny);
      rc[c] = material_r(c == 0 ? v0 : v1, v0, v1, dudx, dudy);
    }
    const size_t p = static_cast<size_t>(lr) * g.ny + gj;
    vel_out[p] = v0;
    vel_out[n + p] = v1;
    if (kStoreR) {
      r_out[p] = rc[0];
      r_out[n + p] = rc[1];
    }
    const float a = kMaxabsBug ? rc[1] : rc[0];
    m = fmaxf(m, a * a + rc[1] * rc[1]);
  });
  return m;
}

// The red and black half-sweeps of the staged velocity (cur; nxt receives
// vel'), then the tail.
template <int NT, int R, bool kRef, bool kInterior, bool kMaxabsBug, bool kStoreR>
__device__ __forceinline__ float fluid_body(const float* us, const float* cur, float* nxt,
                                            const float* gs, const StagedTile& g, int tx,
                                            int ty, const SorScalars& s, const Rows& r, int i0,
                                            int j0, float* __restrict__ vel_out,
                                            float* __restrict__ r_out) {
  float dsum = 0.f, psum = 0.f;  // no Logger sums in the fluid sweep
  elastic_half<NT, R, 0, kRef, kInterior, false, true>(cur, cur, nxt, gs, g, 0, tx, ty, s, dsum,
                                                       psum, us);
  __syncthreads();
  elastic_half<NT, R, 1, kRef, kInterior, false, true>(cur, nxt, nxt, gs, g, 1, tx, ty, s, dsum,
                                                       psum, us);
  __syncthreads();
  return fluid_tail<NT, kInterior, kMaxabsBug, kStoreR>(nxt, us, g, tx, ty, r, i0, j0, vel_out,
                                                        r_out);
}

// The block's max of the threads' m into partials[bid]; ``warp_max`` is
// shared scratch of NT / 32 floats.
template <int NT>
__device__ __forceinline__ void fluid_block_max(float m, float* warp_max, size_t bid,
                                                float* __restrict__ partials) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < NT / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    partials[bid] = bm;
  }
}

// One TX x TY tile of B7, B8 or K3: stage, sweep, tail, and the tile's max
// |R|^2 into partials[bid]. The tile is block (blockIdx.y, blockIdx.x) of
// the planes at u, vel, g, vel_out and r_out.
template <int TX, int TY, int NT, int R, bool kRef, bool kMaxabsBug, bool kStoreR>
__device__ __forceinline__ void fluid_iter_tile(float* smem, const float* __restrict__ u,
                                                const float* __restrict__ vel,
                                                const float* __restrict__ g,
                                                float* __restrict__ vel_out,
                                                float* __restrict__ r_out, const Rows& r,
                                                int ny, const SorScalars& s, size_t bid,
                                                float* __restrict__ partials) {
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
      interior_tile(r, ny, i0, j0, TX, TY, h)
          ? fluid_body<NT, R, kRef, true, kMaxabsBug, kStoreR>(us, cur, nxt, gs, tile, TX, TY, s,
                                                               r, i0, j0, vel_out, r_out)
          : fluid_body<NT, R, kRef, false, kMaxabsBug, kStoreR>(us, cur, nxt, gs, tile, TX, TY,
                                                                s, r, i0, j0, vel_out, r_out);
  fluid_block_max<NT>(m, warp_max, bid, partials);
}

// B7 (kStoreR), B8 and K3 on one TX x TY tile per block.
template <int TX, int TY, int NT, int MB, int R, bool kRef, bool kMaxabsBug, bool kStoreR>
__global__ void __launch_bounds__(NT, MB)
fluid_iter_kernel(const float* __restrict__ u, const float* __restrict__ vel,
                  const float* __restrict__ g, float* __restrict__ vel_out,
                  float* __restrict__ r_out, float* __restrict__ partials, Rows r, int ny,
                  SorScalars s) {
  extern __shared__ float smem[];
  fluid_iter_tile<TX, TY, NT, R, kRef, kMaxabsBug, kStoreR>(
      smem, u, vel, g, vel_out, r_out, r, ny, s,
      static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x, partials);
}

// B7 batched: blockIdx.z is a position in the list ``pairs``. The planes of
// pair pairs[z] start 2 (u, vel, vel_out) or 3 (g) planes a pair in, with
// 64-bit offsets; R and the partials of position z start z pairs in, so
// they come out in list order. Whole images only.
template <int TX, int TY, int NT, int MB, int R, bool kRef, bool kMaxabsBug>
__global__ void __launch_bounds__(NT, MB)
fluid_iter_batch_kernel(const float* __restrict__ u, const float* __restrict__ vel,
                        const float* __restrict__ g, float* __restrict__ vel_out,
                        float* __restrict__ r_out, float* __restrict__ partials, Rows r,
                        int ny, SorScalars s, const int* __restrict__ pairs) {
  extern __shared__ float smem[];
  const size_t plane = r.out_plane(ny);
  const size_t pair = static_cast<size_t>(pairs[blockIdx.z]);
  const size_t z = blockIdx.z;
  const size_t tiles = static_cast<size_t>(gridDim.x) * gridDim.y;
  fluid_iter_tile<TX, TY, NT, R, kRef, kMaxabsBug, true>(
      smem, u + pair * 2 * plane, vel + pair * 2 * plane, g + pair * 3 * plane,
      vel_out + pair * 2 * plane, r_out + z * 2 * plane, r, ny, s,
      z * tiles + static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x, partials);
}

// maxsq = max over the blocks' partials; block x of the grid takes group x
// of nblocks partials into maxsq[x] (one group a pair of a batched launch).
__global__ void __launch_bounds__(kSumThreads)
max_partials_kernel(const float* __restrict__ partials, float* __restrict__ maxsq,
                    int nblocks) {
  __shared__ float warps[kSumThreads / 32];
  partials += static_cast<size_t>(blockIdx.x) * nblocks;
  maxsq += blockIdx.x;
  float m = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kSumThreads) m = fmaxf(m, partials[b]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / 32; ++w) m = fmaxf(m, warps[w]);
    *maxsq = m;
  }
}

}  // namespace
