// The diffeomorphic demons iteration as two kernels on Hopper (sm_90a),
// with the exp map between them:
//   B11 of2d_demons_correspondence: warp -> gradient -> demons force ->
//     Gaussian(sigma_fluid), written as c [2, nx, ny];
//   B12 of2d_compose_smooth: Gaussian(sigma_diffusion) of the composition
//     c + u(x + c) (u where x + c leaves the grid);
//   K6 of2d_demons_correspondence_strip and K7 of2d_compose_smooth_strip:
//     the same on one strip of the strip-parallel driver
//     (parallel/spatial.py), pre-padded with its neighbours' halo rows.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/demons_fused.py,
//   demons_correspondence_pallas (:401, body _corr_kernel :241) and
//   compose_smooth_pallas (:481, body _compose_kernel :301), dense (B11,
//   B12) and with prepadded=True (K6, K7).
// Bounds on this card. Bytes: B11 reads iaux, iref and u and writes c, 24 B
//   per pixel; B12 reads u and c and writes the new motion, 24 B per pixel:
//   at 4096^2 each moves 403 MB, or 0.120 ms at 3.35 TB/s. Operations: B11
//   45 + 8k a pixel (85 at kw 5), B12 36 + 8k, under the bytes even at the
//   float32 rate without fused multiply-adds (half of 67 TFLOP/s, as
//   -fmad=false builds). Like B10, both are held by issued instructions and
//   latency instead: index arithmetic, masks, IEEE divisions and the
//   recomputed halo, and the gathers' latency with 16 (B11) or 32 (B12)
//   warps an SM.
// Design of B11 and K6: B10's front half (demons_onepass.cu), on the same
//   persistent grid of TX x TY tiles, 64 x 64 up to kw 13: the tile
//   extended by kw//2 + 1 in shared memory (iwar, then corr and the x
//   pass), u and iref staged with cp.async, two buffers where they fit,
//   the interior route and kw 5 with its taps known.
// Design of B12 and K7: a persistent grid of two 512-thread blocks an SM (64
//   registers a thread), each walking 64 x 64 tiles (32 x 32 past kw 57):
//   c's two planes on the tile +- kw//2 staged with cp.async (zero-filled
//   off the image or the padded strip), composed with u gathered from
//   global memory at x + c (two cells' taps in flight, 32-bit offsets where
//   twice an input plane stays below 2^31), the x pass written back over
//   the staged c, the y pass into the output. Interior tiles skip the
//   masks and take one denominator; kw 5 is compiled with its taps known.
//   One staging buffer, not two: the SM's other block computes while this
//   one copies, and two 74 KB blocks leave the L1 more room for the
//   gathers of u than two 111 KB ones (PERF.md: the sweep). The gathers are
//   exact for any displacement, so the exp map's squarings, which grow the
//   field, need no halo bound. At kw 5 on 4096^2 the compose's gathers take
//   half of the time, the staging and the store a third (PERF.md).
// Strips (kStrip, rows.cuh): the same stages on the strip's rows, the
//   gathers' taps from the padded strip inside the strips' contract only
//   (bilinear.cuh::strip_taps). An output row of K6 reaches kw//2 + halo + 2
//   rows, of K7 kw//2 + halo + 1: the pads the entry points ask for. Inside
//   the contract a strip equals B11's or B12's rows bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"

namespace {

__host__ __device__ constexpr int correspondence_smem_floats(int k, int tx, int ty, int nbuf) {
  // Two buffers: stage buffers [u on the warp region, 2 planes | iref on
  // the force region] x 2, work buffer A (iwar, then the x pass), B (corr).
  // One buffer: P (u, then corr), Q (iwar) and R (iref), Q + R then holding
  // the x pass.
  const DemonsGeo g(k, tx, ty, k / 2 + 1);
  const int stage = 2 * g.ex * g.ey + g.mx * g.my;
  if (nbuf == 1) return stage + g.ex * g.ey;
  return 2 * stage + cmax(g.ex * g.ey, 2 * tx * g.my) + 2 * g.mx * g.my;
}

__host__ __device__ constexpr int compose_smooth_smem_floats(int k, int tx, int ty, int nbuf) {
  // nbuf stage buffers of c's two planes on the tile +- kw//2, the current
  // one then holding the x pass, and `composed`, two planes on that region.
  const DemonsGeo g(k, tx, ty, k / 2);
  return (nbuf + 1) * 2 * g.dx * g.dy;
}

// B12's register budget, 64 a thread (two 512-thread blocks an SM), and the
// compose cells whose taps are fetched before any is used (the sweep in
// PERF.md).
__host__ __device__ constexpr int compose_blocks(int tx, int ty) {
  return 65536 / (64 * demons_threads(tx, ty));
}
constexpr int kComposeBatch = 2;

DemonsPlan correspondence_plan(int k) {
  return demons_plan(k, correspondence_smem_floats, kStagedPlans);
}
DemonsPlan compose_smooth_plan(int k) {
  return demons_plan(k, compose_smooth_smem_floats, kComposePlans);
}

// One tile of B11 or K6, its inputs staged in su and sr.
template <int K, int TX, int TY, bool kInterior, bool kStrip>
__device__ __forceinline__ void correspondence_tile(const float* __restrict__ iaux,
                                                    float* __restrict__ out, const Rows& rows,
                                                    int ny, int halo, int k, const Taps& tf,
                                                    float a, float b, float den_f,
                                                    const float* su, const float* sr,
                                                    float* iwar, float* corr, float* xs, int i0,
                                                    int j0) {
  constexpr int kN = demons_threads(TX, TY);
  const DemonsGeo g(K > 0 ? K : k, TX, TY, (K > 0 ? K : k) / 2 + 1);
  const Region w{g.ex, g.ey, i0 - g.r, j0 - g.r};
  stage_warp<kN, kInterior, kStrip>(iaux, su, rows, ny, halo, w, iwar);
  __syncthreads();
  stage_force<kN, kInterior>(iwar, sr, w, rows.nx, ny, a, b, corr);
  __syncthreads();
  smooth_x<K, kN, kInterior>(corr, g.mx, g.my, i0, rows.nx, tf, k, xs);  // TX x my
  __syncthreads();
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<K, kN, kInterior>(xs, TX, TY, g.my, i0, j0, rows, ny, tf, k, den_f, out, false,
                                   GlobalCell{nullptr, rows, ny}, unused0, unused1);
}

template <int K, int TX, int TY, int kNBuf, bool kStrip>
__global__ void __launch_bounds__(demons_threads(TX, TY))
correspondence_kernel(const float* __restrict__ iaux, const float* __restrict__ iref,
                      const float* __restrict__ u, float* __restrict__ out, Rows rows, int ny,
                      int halo, int k, Taps taps_f, float a, float b) {
  constexpr int kN = demons_threads(TX, TY);
  extern __shared__ float smem[];
  const int kk = K > 0 ? K : k;
  const DemonsGeo g(kk, TX, TY, kk / 2 + 1);
  const int stage = 2 * g.ex * g.ey + g.mx * g.my;
  float *stage_buf[2], *su, *sr, *iwar, *corr, *xs;
  if (kNBuf == 2) {
    stage_buf[0] = smem;
    stage_buf[1] = smem + stage;
    iwar = xs = smem + 2 * stage;
    corr = iwar + cmax(g.ex * g.ey, 2 * TX * g.my);
    su = sr = nullptr;
  } else {
    su = corr = smem;
    iwar = xs = su + 2 * g.ex * g.ey;
    sr = iwar + g.ex * g.ey;
    stage_buf[0] = stage_buf[1] = su;
  }
  const float den_f = tap_total<K>(taps_f, k) * tap_total<K>(taps_f, k);
  const int tiles_y = (ny + TY - 1) / TY, tiles = demons_tiles(rows, ny, TX, TY);

  // Start the copies of tile t's u (warp region) and iref (force region).
  auto stage_tile = [&](int t, float* to_u, float* to_ref) {
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    stage_region<kN>(u, 2, rows, ny, Region{g.ex, g.ey, i0 - g.r, j0 - g.r}, to_u);
    stage_region<kN>(iref, 1, rows, ny, Region{g.mx, g.my, i0 - g.r + 1, j0 - g.r + 1}, to_ref);
    cp_async_commit();
  };

  int t = blockIdx.x, buf = 0;
  if (kNBuf == 2 && t < tiles) stage_tile(t, stage_buf[0], stage_buf[0] + 2 * g.ex * g.ey);
  for (; t < tiles; t += gridDim.x, buf ^= 1) {
    if (kNBuf == 2) {
      const int next = t + gridDim.x;
      if (next < tiles) stage_tile(next, stage_buf[buf ^ 1], stage_buf[buf ^ 1] + 2 * g.ex * g.ey);
      else cp_async_commit();
      cp_async_wait<1>();
      su = stage_buf[buf];
      sr = su + 2 * g.ex * g.ey;
    } else {
      stage_tile(t, su, sr);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    if (interior_tile(rows, ny, i0, j0, TX, TY, g.r)) {
      correspondence_tile<K, TX, TY, true, kStrip>(iaux, out, rows, ny, halo, k, taps_f, a, b,
                                                   den_f, su, sr, iwar, corr, xs, i0, j0);
    } else {
      correspondence_tile<K, TX, TY, false, kStrip>(iaux, out, rows, ny, halo, k, taps_f, a, b,
                                                    den_f, su, sr, iwar, corr, xs, i0, j0);
    }
    __syncthreads();
  }
}

// One tile of B12 or K7, c staged in sc on the tile +- kw//2: the compose
// into comp, the x pass back into sc (which the compose has read), and the
// y pass into the output.
template <int K, int TX, int TY, typename Offset, bool kInterior, bool kStrip>
__device__ __forceinline__ void compose_smooth_tile(const float* __restrict__ u,
                                                    float* __restrict__ out, const Rows& rows,
                                                    int ny, int halo, int k, const Taps& td,
                                                    float den_d, float* sc, float* comp, int i0,
                                                    int j0) {
  constexpr int kN = demons_threads(TX, TY);
  const DemonsGeo g(K > 0 ? K : k, TX, TY, (K > 0 ? K : k) / 2);
  const GlobalCell cell{u, rows, ny};
  stage_accumulate<kN, kInterior, false, kStrip, kComposeBatch, Offset>(
      sc, Region{g.dx, g.dy, i0 - g.c, j0 - g.c}, u, cell, rows, ny, halo, comp);
  __syncthreads();
  smooth_x<K, kN, kInterior>(comp, g.dx, g.dy, i0, rows.nx, td, k, sc);  // TX x dy
  __syncthreads();
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<K, kN, kInterior>(sc, TX, TY, g.dy, i0, j0, rows, ny, td, k, den_d, out, false,
                                   cell, unused0, unused1);
}

// One staging buffer: the SM's other block computes while this one copies.
template <int K, int TX, int TY, typename Offset, bool kStrip>
__global__ void __launch_bounds__(demons_threads(TX, TY), compose_blocks(TX, TY))
compose_smooth_kernel(const float* __restrict__ u, const float* __restrict__ cin,
                      float* __restrict__ out, Rows rows, int ny, int halo, int k,
                      Taps taps_d) {
  constexpr int kN = demons_threads(TX, TY);
  extern __shared__ float smem[];
  const int kk = K > 0 ? K : k;
  const DemonsGeo g(kk, TX, TY, kk / 2);
  float* sc = smem;
  float* comp = smem + 2 * g.dx * g.dy;
  const float den_d = tap_total<K>(taps_d, k) * tap_total<K>(taps_d, k);
  const int tiles_y = (ny + TY - 1) / TY, tiles = demons_tiles(rows, ny, TX, TY);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    stage_region<kN>(cin, 2, rows, ny, Region{g.dx, g.dy, i0 - g.c, j0 - g.c}, sc);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (interior_tile(rows, ny, i0, j0, TX, TY, g.c)) {
      compose_smooth_tile<K, TX, TY, Offset, true, kStrip>(u, out, rows, ny, halo, k, taps_d,
                                                           den_d, sc, comp, i0, j0);
    } else {
      compose_smooth_tile<K, TX, TY, Offset, false, kStrip>(u, out, rows, ny, halo, k, taps_d,
                                                            den_d, sc, comp, i0, j0);
    }
    __syncthreads();
  }
}

template <int K, int TX, int TY, int kNBuf, bool kStrip>
int launch_correspondence(const float* iaux, const float* iref, const float* u, float* out,
                          const Rows& rows, int ny, int halo, int k, const Taps& tf, float a,
                          float b, cudaStream_t stream) {
  static GridCache cache;
  auto* kernel = correspondence_kernel<K, TX, TY, kNBuf, kStrip>;
  const int smem =
      correspondence_smem_floats(k, TX, TY, kNBuf) * static_cast<int>(sizeof(float));
  int blocks;
  const int rc = persistent_grid(kernel, demons_threads(TX, TY), smem,
                                 demons_tiles(rows, ny, TX, TY), &cache, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, demons_threads(TX, TY), smem, stream>>>(iaux, iref, u, out, rows, ny, halo, k,
                                                           tf, a, b);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of k's plan: kw 5 with its taps known, the others at
// run time.
template <bool kStrip>
int dispatch_correspondence(const float* iaux, const float* iref, const float* u, float* out,
                            const Rows& rows, int ny, int halo, int k, const float* taps_f,
                            float a, float b, cudaStream_t stream) {
  Taps tf;
  if (!make_taps(taps_f, k, &tf)) return static_cast<int>(cudaErrorInvalidValue);
  const DemonsPlan p = correspondence_plan(k);
  if (p.tx == kTileX && p.ty == kTileY && p.nbuf == kTileBufs)
    return k == 5 ? launch_correspondence<5, kTileX, kTileY, kTileBufs, kStrip>(
                        iaux, iref, u, out, rows, ny, halo, k, tf, a, b, stream)
                  : launch_correspondence<0, kTileX, kTileY, kTileBufs, kStrip>(
                        iaux, iref, u, out, rows, ny, halo, k, tf, a, b, stream);
  if (p.tx == kSmallTile && p.nbuf == 2)
    return launch_correspondence<0, kSmallTile, kSmallTile, 2, kStrip>(
        iaux, iref, u, out, rows, ny, halo, k, tf, a, b, stream);
  if (p.tx == kSmallTile && p.nbuf == 1)
    return launch_correspondence<0, kSmallTile, kSmallTile, 1, kStrip>(
        iaux, iref, u, out, rows, ny, halo, k, tf, a, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int K, int TX, int TY, typename Offset, bool kStrip>
int launch_compose_kernel(const float* u, const float* c, float* out, const Rows& rows, int ny,
                          int halo, int k, const Taps& td, cudaStream_t stream) {
  static GridCache cache;
  auto* kernel = compose_smooth_kernel<K, TX, TY, Offset, kStrip>;
  const int smem = compose_smooth_smem_floats(k, TX, TY, 1) * static_cast<int>(sizeof(float));
  int blocks;
  const int rc = persistent_grid(kernel, demons_threads(TX, TY), smem,
                                 demons_tiles(rows, ny, TX, TY), &cache, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, demons_threads(TX, TY), smem, stream>>>(u, c, out, rows, ny, halo, k, td);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit tap offsets where twice an input plane stays below 2^31.
template <int K, int TX, int TY, bool kStrip>
int launch_compose_smooth(const float* u, const float* c, float* out, const Rows& rows, int ny,
                          int halo, int k, const Taps& td, cudaStream_t stream) {
  return 2 * rows.in_plane(ny) < (size_t{1} << 31)
             ? launch_compose_kernel<K, TX, TY, int, kStrip>(u, c, out, rows, ny, halo, k, td,
                                                             stream)
             : launch_compose_kernel<K, TX, TY, size_t, kStrip>(u, c, out, rows, ny, halo, k,
                                                                td, stream);
}

// The instantiation of k's plan: kw 5 with its taps known, the others at
// run time.
template <bool kStrip>
int dispatch_compose_smooth(const float* u, const float* c, float* out, const Rows& rows,
                            int ny, int halo, int k, const float* taps_d, cudaStream_t stream) {
  Taps td;
  if (!make_taps(taps_d, k, &td)) return static_cast<int>(cudaErrorInvalidValue);
  const DemonsPlan p = compose_smooth_plan(k);
  if (p.tx == kTileX && p.ty == kTileY)
    return k == 5 ? launch_compose_smooth<5, kTileX, kTileY, kStrip>(u, c, out, rows, ny, halo, k,
                                                                    td, stream)
                  : launch_compose_smooth<0, kTileX, kTileY, kStrip>(u, c, out, rows, ny, halo, k,
                                                                    td, stream);
  if (p.tx == kSmallTile)
    return launch_compose_smooth<0, kSmallTile, kSmallTile, kStrip>(u, c, out, rows, ny, halo, k,
                                                                    td, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory of a B11 (and K6) thread block at kernelwidth k: its plan's,
// or, where no tile fits, the smallest layout's.
extern "C" int of2d_demons_correspondence_smem_bytes(int k) {
  const DemonsPlan p = correspondence_plan(k);
  const int floats = p.tx ? correspondence_smem_floats(k, p.tx, p.ty, p.nbuf)
                          : correspondence_smem_floats(k, kSmallTile, kSmallTile, 1);
  return floats * static_cast<int>(sizeof(float));
}

// Shared memory of a B12 (and K7) thread block at kernelwidth k: its plan's,
// or, where no tile fits, the smallest layout's.
extern "C" int of2d_compose_smooth_smem_bytes(int k) {
  const DemonsPlan p = compose_smooth_plan(k);
  const int floats = p.tx ? compose_smooth_smem_floats(k, p.tx, p.ty, p.nbuf)
                          : compose_smooth_smem_floats(k, kSmallTile, kSmallTile, 1);
  return floats * static_cast<int>(sizeof(float));
}

// B11: iaux, iref [nx, ny], u [2, nx, ny] -> c [2, nx, ny]; taps_f is a
// host array of k floats; a = sigma_i^2, b = sigma_x^2.
extern "C" int of2d_demons_correspondence(const float* iaux, const float* iref,
                                          const float* u, float* out, int nx, int ny, int k,
                                          const float* taps_f, float a, float b,
                                          cudaStream_t stream) {
  return dispatch_correspondence<false>(iaux, iref, u, out, whole_image(nx), ny, 0, k, taps_f, a,
                                        b, stream);
}

// B12: u, c [2, nx, ny] -> Gaussian(sigma_d) of compose(u, c), [2, nx, ny];
// taps_d is a host array of k floats.
extern "C" int of2d_compose_smooth(const float* u, const float* c, float* out, int nx,
                                   int ny, int k, const float* taps_d,
                                   cudaStream_t stream) {
  return dispatch_compose_smooth<false>(u, c, out, whole_image(nx), ny, 0, k, taps_d,
                                        stream);
}

// K6, one strip: iaux_pad, iref_pad [nxl + 2 pad, ny], u_pad [2, nxl + 2
// pad, ny] of the strip whose first row is global row row0 of nx_glob -> c
// [2, nxl, ny]. Needs pad >= k / 2 + halo + 2.
extern "C" int of2d_demons_correspondence_strip(const float* iaux_pad, const float* iref_pad,
                                                const float* u_pad, float* out, int nxl,
                                                int ny, int pad, int row0, int nx_glob,
                                                int halo, int k, const float* taps_f, float a,
                                                float b, cudaStream_t stream) {
  const Rows rows{nxl, pad, row0, nx_glob};
  if (halo < 0 || !strip_ok(rows, k / 2 + halo + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_correspondence<true>(iaux_pad, iref_pad, u_pad, out, rows, ny, halo, k, taps_f,
                                       a, b, stream);
}

// K7, one strip: u_pad, c_pad [2, nxl + 2 pad, ny] -> [2, nxl, ny]. Needs
// pad >= k / 2 + halo + 1.
extern "C" int of2d_compose_smooth_strip(const float* u_pad, const float* c_pad, float* out,
                                         int nxl, int ny, int pad, int row0, int nx_glob,
                                         int halo, int k, const float* taps_d,
                                         cudaStream_t stream) {
  const Rows rows{nxl, pad, row0, nx_glob};
  if (halo < 0 || !strip_ok(rows, k / 2 + halo + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_compose_smooth<true>(u_pad, c_pad, out, rows, ny, halo, k, taps_d, stream);
}
