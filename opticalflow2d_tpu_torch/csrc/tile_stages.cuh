// What the staged-tile kernels share: a tile's geometry in global terms, the
// store of its own cells and its block's row of the Logger partials. Used by
// elastic_stages.cuh (B6, K2), fluid_stages.cuh (B7, B8, K3) and
// diffusion_stages.cuh (B1, K1), whose blocks each stage one output tile
// with a halo in shared memory (buffer rows of ey floats).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"  // for_cells
#include "rows.cuh"

namespace {

// One tile's buffers in global terms.
struct StagedTile {
  int ex, ey;    // extended tile: buffer rows and columns (row pitch ey)
  int h;         // halo
  int gi0, gj0;  // global cell of buffer cell (0, 0)
  int nx, ny;    // the image
  int gi_end;    // end of the global rows the launch owns
};

// The tile's own cells of buffer u into out [2, r.nxl, ny].
template <int NT, bool kInterior>
__device__ __forceinline__ void store_tile(const float* u, const StagedTile& g, int tx, int ty,
                                           const Rows& r, int i0, int j0,
                                           float* __restrict__ out) {
  const size_t n = r.out_plane(g.ny);
  const int pl = g.ex * g.ey;
  for_cells<NT>(tx, ty, [&](int li, int lj, int) {
    const int lr = i0 + li - r.row0, gj = j0 + lj;
    if (!kInterior && (lr >= r.nxl || gj >= g.ny)) return;
    const size_t p = static_cast<size_t>(lr) * g.ny + gj;
    const int l = (li + g.h) * g.ey + lj + g.h;
    out[p] = u[l];
    out[n + p] = u[pl + l];
  });
}

// Block bid's row of the [nblocks, k, 2] partials: the warps in order.
template <int NT>
__device__ __forceinline__ void tile_partials(const float* red, int k, size_t bid,
                                              float* __restrict__ partials) {
  constexpr int kWarps = NT / 32;
  const int tid = threadIdx.x;
  if (tid < 2 * k) {
    const int t = tid >> 1, c = tid & 1;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += red[(t * kWarps + w) * 2 + c];
    partials[bid * 2 * k + tid] = acc;
  }
}

}  // namespace
