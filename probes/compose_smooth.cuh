// Variants of B12/K7 for probes/compose_smooth.py: the form B12 had before its
// redesign (one 256-thread block per 32 x 32 tile, c loaded through
// registers, masked stages, the tap count at run time, two compose cells in
// flight), and the redesigned kernel with the knobs its design was chosen
// by: tile, staging buffers, register budget (blocks an SM), compose batch,
// 32-bit tap offsets. STOP cuts either after a stage and stores that
// stage's buffer at the tile's cells, for a cumulative breakdown: 0 after
// staging c, 1 after the compose, 2 after the x pass, 3 the full kernel.
#pragma once
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "demons_stages.cuh"
#include "probe_attrs.cuh"

namespace {

// ---- B12 before its redesign ----
template <bool kStrip, int STOP>
__global__ void __launch_bounds__(demons_threads(kSmallTile, kSmallTile))
before_kernel(const float* __restrict__ u, const float* __restrict__ cin,
              float* __restrict__ out, Rows rows, int ny, int halo, int k, Taps taps_d) {
  constexpr int kN = demons_threads(kSmallTile, kSmallTile);
  extern __shared__ float smem[];
  const int c = k / 2;
  const int d = kSmallTile + 2 * c;
  float* sa = smem;
  float* sb = sa + 2 * d * d;
  const int i0 = rows.row0 + blockIdx.y * kSmallTile, j0 = blockIdx.x * kSmallTile;
  const size_t n = rows.in_plane(ny);
  const Region s{d, d, i0 - c, j0 - c};
  for_cells<kN>(d, d, [&](int li, int lj, int l) {
    const int gi = s.gi0 + li, gj = s.gj0 + lj;
    float c0 = 0.f, c1 = 0.f;
    if (rows.loadable(gi - rows.row0) && inside(gj, ny)) {
      const size_t p = rows.in_row(gi - rows.row0, ny) + gj;
      c0 = cin[p];
      c1 = cin[n + p];
    }
    sa[l] = c0;
    sa[d * d + l] = c1;
  });
  __syncthreads();
  const size_t on = rows.out_plane(ny);
  auto dump = [&](const float* buf, int stride, int plane, int oi, int oj) {
    for_cells<kN>(kSmallTile, kSmallTile, [&](int li, int lj, int) {
      const int gi = i0 + li, gj = j0 + lj, lr = gi - rows.row0;
      if (lr >= rows.nxl || gj >= ny) return;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      out[p] = buf[(li + oi) * stride + lj + oj];
      out[on + p] = buf[plane + (li + oi) * stride + lj + oj];
    });
  };
  if (STOP == 0) { dump(sa, d, d * d, c, c); return; }
  const GlobalCell cell{u, rows, ny};
  stage_accumulate<kN, false, false, kStrip, 2>(sa, s, u, cell, rows, ny, halo, sb);
  __syncthreads();
  if (STOP == 1) { dump(sb, d, d * d, c, c); return; }
  smooth_x<0, kN, false>(sb, d, d, i0, rows.nx, taps_d, k, sa);
  __syncthreads();
  if (STOP == 2) { dump(sa, d, kSmallTile * d, 0, c); return; }
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<0, kN, false>(sa, kSmallTile, kSmallTile, d, i0, j0, rows, ny, taps_d, k, 0.f,
                               out, false, cell, unused0, unused1);
}

template <bool kStrip, int STOP>
int launch_before(const float* u, const float* c, float* out, const Rows& rows, int ny,
                  int halo, int k, const Taps& td, cudaStream_t stream) {
  const int d = kSmallTile + 2 * (k / 2);
  const int smem = 4 * d * d * 4;
  cudaError_t err = cudaFuncSetAttribute(before_kernel<kStrip, STOP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + kSmallTile - 1) / kSmallTile, (rows.nxl + kSmallTile - 1) / kSmallTile);
  before_kernel<kStrip, STOP><<<grid, demons_threads(kSmallTile, kSmallTile), smem, stream>>>(
      u, c, out, rows, ny, halo, k, td);
  return static_cast<int>(cudaGetLastError());
}

// ---- the redesigned kernel, with its knobs ----
constexpr int new_smem_floats(int k, int tx, int ty, int nb) {
  return (nb + 1) * 2 * (tx + 2 * (k / 2)) * (ty + 2 * (k / 2));
}

template <int K, int TX, int TY, bool kInterior, bool kStrip, int KB, bool I32, int STOP>
__device__ __forceinline__ void new_tile(const float* __restrict__ u, float* __restrict__ out,
                                         const Rows& rows, int ny, int halo, int k,
                                         const Taps& td, float den, float* sc, float* comp,
                                         int i0, int j0) {
  constexpr int kN = demons_threads(TX, TY);
  const int c = (K > 0 ? K : k) / 2, dx = TX + 2 * c, dy = TY + 2 * c;
  const size_t on = rows.out_plane(ny);
  auto dump = [&](const float* buf, int stride, int plane, int oi, int oj) {
    for_cells<kN>(TX, TY, [&](int li, int lj, int) {
      const int gi = i0 + li, gj = j0 + lj, lr = gi - rows.row0;
      if (!kInterior && (lr >= rows.nxl || gj >= ny)) return;
      const size_t p = static_cast<size_t>(lr) * ny + gj;
      out[p] = buf[(li + oi) * stride + lj + oj];
      out[on + p] = buf[plane + (li + oi) * stride + lj + oj];
    });
  };
  if (STOP == 0) { dump(sc, dy, dx * dy, c, c); return; }
  using Offset = std::conditional_t<I32, int, size_t>;
  stage_accumulate<kN, kInterior, false, kStrip, KB, Offset>(
      sc, Region{dx, dy, i0 - c, j0 - c}, u, GlobalCell{u, rows, ny}, rows, ny, halo, comp);
  __syncthreads();
  if (STOP == 1) { dump(comp, dy, dx * dy, c, c); return; }
  smooth_x<K, kN, kInterior>(comp, dx, dy, i0, rows.nx, td, k, sc);  // TX x dy
  __syncthreads();
  if (STOP == 2) { dump(sc, dy, TX * dy, 0, c); return; }
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<K, kN, kInterior>(sc, TX, TY, dy, i0, j0, rows, ny, td, k, den, out, false,
                                   GlobalCell{u, rows, ny}, unused0, unused1);
}

template <int K, int TX, int TY, int NB, int MB, int KB, bool I32, int STOP, bool kStrip>
__global__ void __launch_bounds__(demons_threads(TX, TY), MB)
new_kernel(const float* __restrict__ u, const float* __restrict__ cin, float* __restrict__ out,
           Rows rows, int ny, int halo, int k, Taps td) {
  constexpr int kN = demons_threads(TX, TY);
  extern __shared__ float smem[];
  const int c = (K > 0 ? K : k) / 2, dx = TX + 2 * c, dy = TY + 2 * c, plane2 = 2 * dx * dy;
  float* comp = smem + NB * plane2;
  const float den = tap_total<K>(td, k) * tap_total<K>(td, k);
  const int tiles_y = (ny + TY - 1) / TY, tiles = demons_tiles(rows, ny, TX, TY);
  auto stage_tile = [&](int t, float* dst) {
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    stage_region<kN>(cin, 2, rows, ny, Region{dx, dy, i0 - c, j0 - c}, dst);
    cp_async_commit();
  };
  int t = blockIdx.x, buf = 0;
  if (NB == 2 && t < tiles) stage_tile(t, smem);
  for (; t < tiles; t += gridDim.x, buf ^= 1) {
    float* sc = smem;
    if (NB == 2) {
      const int next = t + gridDim.x;
      if (next < tiles) stage_tile(next, smem + (buf ^ 1) * plane2);
      else cp_async_commit();
      cp_async_wait<1>();
      sc = smem + buf * plane2;
    } else {
      stage_tile(t, sc);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    if (interior_tile(rows, ny, i0, j0, TX, TY, c))
      new_tile<K, TX, TY, true, kStrip, KB, I32, STOP>(u, out, rows, ny, halo, k, td, den, sc,
                                                       comp, i0, j0);
    else
      new_tile<K, TX, TY, false, kStrip, KB, I32, STOP>(u, out, rows, ny, halo, k, td, den, sc,
                                                        comp, i0, j0);
    __syncthreads();
  }
}

template <int K, int TX, int TY, int NB, int MB, int KB, bool I32, int STOP, bool kStrip>
int launch_new(const float* u, const float* c, float* out, const Rows& rows, int ny, int halo,
               int k, const Taps& td, cudaStream_t stream) {
  static GridCache cache;
  auto* kernel = new_kernel<K, TX, TY, NB, MB, KB, I32, STOP, kStrip>;
  const int smem = new_smem_floats(k, TX, TY, NB) * 4;
  int blocks;
  const int rc = persistent_grid(kernel, demons_threads(TX, TY), smem,
                                 demons_tiles(rows, ny, TX, TY), &cache, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, demons_threads(TX, TY), smem, stream>>>(u, c, out, rows, ny, halo, k, td);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
