// One Thirion demons iteration in one pass over device memory on Hopper
// (sm_90a): warp -> gradient -> demons force -> Gaussian(sigma_fluid) ->
// compose or add -> Gaussian(sigma_diffusion), with the reference Logger's
// sums [sum |u_new - u|, sum |u|]. Three entry points:
//   B10 of2d_demons_onepass: the whole image;
//   B10 of2d_demons_onepass_batch: the listed pairs of a stack in one
//     launch (the lockstep demons driver, engine/registration.py), each
//     pair's field at its place in the stack, its sums in list order;
//   K5 of2d_demons_onepass_strip: one strip of the strip-parallel driver
//     (parallel/spatial.py), pre-padded with its neighbours' halo rows,
//     composing under the strips' displacement contract, no Logger sums.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/demons_onepass.py,
//   thirion_onepass_pallas (:310, body _onepass_body :114-206), dense (B10)
//   and with prepadded=True (K5, strip body _strip_kernel :222).
// Bounds on this card. Bytes: it must read iaux, iref and u and write
//   u_new, 24 B per pixel: at 4096^2, 403 MB, or 0.120 ms at 3.35 TB/s.
//   Operations: two k-tap separable Gaussians over two channels, the force
//   and two bilinear gathers, about 93 + 16k per pixel (173 at kw 5); with
//   -fmad=false no multiply-add fuses, so the float32 rate is half of 67
//   TFLOP/s, and 173 operations a pixel take 0.087 ms at 4096^2. So bytes
//   bound it on paper. What holds it on the card is neither: it issues
//   several times those operations (index arithmetic, masks, about ten IEEE
//   divisions a pixel, the recomputed halo), and at 128 registers a thread
//   an SM holds 16 warps, too few to hide the latency of its two dependent
//   gathers (the warp of iaux and the compose of u) at each stage's barrier.
//   It is held by issued instructions and latency (PERF.md: the breakdown).
// Design: a persistent grid (as many blocks as are resident, each walking
//   the tiles in tile order) over TX x TY output tiles, 64 x 64 up to kw 7,
//   else 32 x 32 (demons_plan). Shared memory holds the tile extended by
//   r = kw//2 (sigma_d) + kw//2 (sigma_f) + 1 (gradient) on every side; the
//   stages of demons_stages.cuh shrink it stage by stage: iwar (gathered
//   from global iaux at x + u(x)), corr, the x pass of sigma_f, the
//   smoothed c, `composed` on the tile +- kw//2 (gathered from global u at
//   x + c), the x pass of sigma_d, and the tile written once. So the
//   intermediates never touch device memory. The regular inputs, u's two
//   planes on the warp region and iref on the force region, are staged
//   with cp.async: with two buffers the next tile's copies fly while this
//   one computes (and u at the cells comes from the stage); where two do
//   not fit (kw > 23), one buffer overlays the work buffers. The larger
//   tile cuts the recomputed halo (the warp region at kw 5: 1.34x the tile
//   at 64 x 64 against 1.72x at 32 x 32); flattened cell indices leave no
//   lane idle; interior tiles (the region and its reach inside the image)
//   run without masks, with one denominator per smooth; kw 5, the main
//   paths' width, is compiled with its taps known. The warp gathers kBatch
//   cells' taps before using any; the compose one cell at a time (batches
//   cost more registers than they gained). The gathers read global memory
//   and are exact for any displacement, so the TPU kernel's halo bound and
//   its fallback have no counterpart. Per-tile Logger partials are added in
//   tile order by a second kernel (partials.cuh). A kernelwidth with no
//   tile that fits is refused by the wrapper.
// Pair axis: the persistent grid walks the listed pairs' tiles, pair by
//   pair (onepass_walk over PairTiles), so a block's staging of its next
//   tile may cross into the next pair; each tile is computed as in B10 and
//   its partials land in its pair's rows, added per pair (partials.cuh).
// Strips (kStrip, rows.cuh): the same stages on the strip's rows; a cell
//   reads the padded strip and every gather takes its taps there, inside
//   the contract only (bilinear.cuh::strip_taps). An output row reaches
//   2 (kw//2) + halo + 2 rows (the two smooths, the gradient, the warp's
//   taps), the pad the entry point asks for; inside the contract a strip
//   equals B10's rows bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"
#include "partials.cuh"

namespace {

__host__ __device__ constexpr int onepass_smem_floats(int k, int tx, int ty, int nbuf) {
  // Two buffers: stage buffers [u on the warp region, 2 planes | iref on the
  // force region] x 2, work buffer A (iwar, the sigma_f x pass, composed),
  // B (corr, smoothed c, the sigma_d x pass). One buffer: P (u, then corr,
  // smoothed c, the sigma_d x pass), Q (iwar) and R (iref), Q + R then
  // holding the sigma_f x pass and composed. Then the Logger partials.
  const DemonsGeo g(k, tx, ty, 2 * (k / 2) + 1);
  const int stage = 2 * g.ex * g.ey + g.mx * g.my;
  const int red = 2 * (demons_threads(tx, ty) / 32);
  if (nbuf == 1) return stage + g.ex * g.ey + red;
  return 2 * stage + cmax(g.ex * g.ey, cmax(2 * g.dx * g.my, 2 * g.dx * g.dy)) +
         cmax(2 * g.mx * g.my, cmax(2 * g.dx * g.dy, 2 * tx * g.dy)) + red;
}

DemonsPlan onepass_plan(int k) { return demons_plan(k, onepass_smem_floats, kStagedPlans); }

// The buffers of one tile's stages (see onepass_smem_floats).
struct OnepassBufs {
  float *su, *sr, *iwar, *corr, *xa, *cs, *comp, *xb;
};

// One tile of B10 or K5, its inputs staged in b.su and b.sr.
template <int K, int TX, int TY, int kNBuf, bool kInterior, bool kAddition, bool kStrip>
__device__ __forceinline__ void onepass_tile(const float* __restrict__ iaux,
                                             const float* __restrict__ u,
                                             float* __restrict__ out, const Rows& rows, int ny,
                                             int halo, int k, const Taps& tf, const Taps& td,
                                             float a, float b, float den_f, float den_d,
                                             const OnepassBufs& s, int i0, int j0, bool sums,
                                             float& dsum, float& psum) {
  constexpr int kN = demons_threads(TX, TY);
  const DemonsGeo g(K > 0 ? K : k, TX, TY, 2 * ((K > 0 ? K : k) / 2) + 1);
  const int c = g.c, nx = rows.nx;
  const Region w{g.ex, g.ey, i0 - g.r, j0 - g.r};
  stage_warp<kN, kInterior, kStrip>(iaux, s.su, rows, ny, halo, w, s.iwar);
  __syncthreads();
  stage_force<kN, kInterior>(s.iwar, s.sr, w, nx, ny, a, b, s.corr);
  __syncthreads();
  smooth_x<K, kN, kInterior>(s.corr, g.mx, g.my, i0 - c, nx, tf, k, s.xa);  // dx x my
  __syncthreads();
  smooth_y<K, kN, kInterior>(s.xa, g.dx, g.my, i0 - c, j0 - c, nx, ny, tf, k, den_f, s.cs);
  __syncthreads();
  const Region d{g.dx, g.dy, i0 - c, j0 - c};
  const int o = g.r - c;  // the smoothed c's origin in the warp region
  // One gathered cell at a time: batches cost more in registers than they
  // gain here (PERF.md).
  if (kNBuf == 2) {
    stage_accumulate<kN, kInterior, kAddition, kStrip, 1>(
        s.cs, d, u, StagedCell{s.su + o * g.ey + o, g.ey, g.ex * g.ey}, rows, ny, halo, s.comp);
  } else {
    stage_accumulate<kN, kInterior, kAddition, kStrip, 1>(s.cs, d, u, GlobalCell{u, rows, ny},
                                                          rows, ny, halo, s.comp);
  }
  __syncthreads();
  smooth_x<K, kN, kInterior>(s.comp, g.dx, g.dy, i0, nx, td, k, s.xb);  // TX x dy
  __syncthreads();
  if (kNBuf == 2) {
    smooth_y_store<K, kN, kInterior>(s.xb, TX, TY, g.dy, i0, j0, rows, ny, td, k, den_d, out,
                                     sums, StagedCell{s.su + g.r * g.ey + g.r, g.ey, g.ex * g.ey},
                                     dsum, psum);
  } else {
    smooth_y_store<K, kN, kInterior>(s.xb, TX, TY, g.dy, i0, j0, rows, ny, td, k, den_d, out,
                                     sums, GlobalCell{u, rows, ny}, dsum, psum);
  }
}

// The items one launch walks (count() of them), item q being tile tile(q)
// of the planes that start offset(q) floats a plane in. B10 and K5 walk one
// image's tiles in tile order; B10's pair axis walks its listed pairs'
// tiles, the pairs in list order, each pair's tiles in tile order. Item q's
// Logger partials are row q of the launch's partials, so a pair's rows are
// its single launch's rows, in the same order.
struct ImageTiles {
  __device__ __forceinline__ int count(const Rows& rows, int ny, int tx, int ty) const {
    return demons_tiles(rows, ny, tx, ty);
  }
  __device__ __forceinline__ int tile(int q) const { return q; }
  __device__ __forceinline__ size_t offset(int) const { return 0; }
};

struct PairTiles {
  const int* __restrict__ pairs;
  int n_pairs, tiles;
  size_t plane;
  __device__ __forceinline__ int count(const Rows&, int, int, int) const {
    return n_pairs * tiles;
  }
  __device__ __forceinline__ int tile(int q) const { return q % tiles; }
  __device__ __forceinline__ size_t offset(int q) const {
    return static_cast<size_t>(pairs[q / tiles]) * plane;
  }
};

// A persistent block's walk over the items of ``at``: block b takes items
// b, b + gridDim.x, ..., each tile's inputs staged ahead with two buffers.
// The body of B10, K5 and B10's pair axis.
template <int K, int TX, int TY, int kNBuf, bool kAddition, bool kStrip, typename Items>
__device__ __forceinline__ void onepass_walk(float* smem, const float* __restrict__ iaux,
                                             const float* __restrict__ iref,
                                             const float* __restrict__ u,
                                             float* __restrict__ out,
                                             float* __restrict__ partials, const Rows& rows,
                                             int ny, int halo, int k, const Taps& taps_f,
                                             const Taps& taps_d, float a, float b,
                                             const Items& at) {
  constexpr int kN = demons_threads(TX, TY);
  const int kk = K > 0 ? K : k;
  const DemonsGeo g(kk, TX, TY, 2 * (kk / 2) + 1);
  const int stage = 2 * g.ex * g.ey + g.mx * g.my;
  OnepassBufs s;
  float* stage_buf[2];
  float* red;
  if (kNBuf == 2) {
    stage_buf[0] = smem;
    stage_buf[1] = smem + stage;
    float* wa = smem + 2 * stage;
    float* wb = wa + cmax(g.ex * g.ey, cmax(2 * g.dx * g.my, 2 * g.dx * g.dy));
    red = wb + cmax(2 * g.mx * g.my, cmax(2 * g.dx * g.dy, 2 * TX * g.dy));
    s = OnepassBufs{nullptr, nullptr, wa, wb, wa, wb, wa, wb};
  } else {
    float* p = smem;
    float* q = p + 2 * g.ex * g.ey;
    float* r = q + g.ex * g.ey;
    stage_buf[0] = stage_buf[1] = p;
    red = r + g.mx * g.my;
    s = OnepassBufs{p, r, q, p, q, p, q, p};
  }
  const float den_f = tap_total<K>(taps_f, k) * tap_total<K>(taps_f, k);
  const float den_d = tap_total<K>(taps_d, k) * tap_total<K>(taps_d, k);
  const bool sums = partials != nullptr;
  const int tiles_y = (ny + TY - 1) / TY, items = at.count(rows, ny, TX, TY);

  // Start the copies of item q's u (warp region) and iref (force region).
  auto stage_tile = [&](int q, float* su, float* sr) {
    const int t = at.tile(q);
    const size_t o = at.offset(q);
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    stage_region<kN>(u + 2 * o, 2, rows, ny, Region{g.ex, g.ey, i0 - g.r, j0 - g.r}, su);
    stage_region<kN>(iref + o, 1, rows, ny, Region{g.mx, g.my, i0 - g.r + 1, j0 - g.r + 1}, sr);
    cp_async_commit();
  };

  int q = blockIdx.x, buf = 0;
  if (kNBuf == 2 && q < items) stage_tile(q, stage_buf[0], stage_buf[0] + 2 * g.ex * g.ey);
  for (; q < items; q += gridDim.x, buf ^= 1) {
    if (kNBuf == 2) {
      const int next = q + gridDim.x;
      if (next < items) stage_tile(next, stage_buf[buf ^ 1], stage_buf[buf ^ 1] + 2 * g.ex * g.ey);
      else cp_async_commit();
      cp_async_wait<1>();
      s.su = stage_buf[buf];
      s.sr = stage_buf[buf] + 2 * g.ex * g.ey;
    } else {
      stage_tile(q, s.su, s.sr);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = at.tile(q);
    const size_t o = at.offset(q);
    const int i0 = rows.row0 + (t / tiles_y) * TX, j0 = (t % tiles_y) * TY;
    float dsum = 0.f, psum = 0.f;
    if (interior_tile(rows, ny, i0, j0, TX, TY, g.r)) {
      onepass_tile<K, TX, TY, kNBuf, true, kAddition, kStrip>(
          iaux + o, u + 2 * o, out + 2 * o, rows, ny, halo, k, taps_f, taps_d, a, b, den_f,
          den_d, s, i0, j0, sums, dsum, psum);
    } else {
      onepass_tile<K, TX, TY, kNBuf, false, kAddition, kStrip>(
          iaux + o, u + 2 * o, out + 2 * o, rows, ny, halo, k, taps_f, taps_d, a, b, den_f,
          den_d, s, i0, j0, sums, dsum, psum);
    }
    if (sums) block_sum_pair<kN / 32>(dsum, psum, threadIdx.x, red, partials + 2 * q);
    __syncthreads();
  }
}

// B10 and K5: one image's tiles.
template <int K, int TX, int TY, int kNBuf, bool kAddition, bool kStrip>
__global__ void __launch_bounds__(demons_threads(TX, TY))
demons_onepass_kernel(const float* __restrict__ iaux, const float* __restrict__ iref,
                      const float* __restrict__ u, float* __restrict__ out,
                      float* __restrict__ partials, Rows rows, int ny, int halo, int k,
                      Taps taps_f, Taps taps_d, float a, float b) {
  extern __shared__ float smem[];
  onepass_walk<K, TX, TY, kNBuf, kAddition, kStrip>(smem, iaux, iref, u, out, partials, rows,
                                                    ny, halo, k, taps_f, taps_d, a, b,
                                                    ImageTiles{});
}

// B10's pair axis: the tiles of the n_pairs pairs listed in ``pairs``, whole
// images of a stack (iaux, iref one plane a pair, u and out two).
template <int K, int TX, int TY, int kNBuf, bool kAddition>
__global__ void __launch_bounds__(demons_threads(TX, TY))
demons_onepass_batch_kernel(const float* __restrict__ iaux, const float* __restrict__ iref,
                            const float* __restrict__ u, float* __restrict__ out,
                            float* __restrict__ partials, Rows rows, int ny, int k,
                            Taps taps_f, Taps taps_d, float a, float b,
                            const int* __restrict__ pairs, int n_pairs) {
  extern __shared__ float smem[];
  onepass_walk<K, TX, TY, kNBuf, kAddition, false>(
      smem, iaux, iref, u, out, partials, rows, ny, 0, k, taps_f, taps_d, a, b,
      PairTiles{pairs, n_pairs, demons_tiles(rows, ny, TX, TY), rows.out_plane(ny)});
}

// Launch B10 or K5 (pairs == nullptr) or B10's pair axis over the listed
// pairs on a persistent grid.
template <int K, int TX, int TY, int kNBuf, bool kAddition, bool kStrip>
int launch(const float* iaux, const float* iref, const float* u, float* out, float* partials,
           const Rows& rows, int ny, int halo, int k, const Taps& tf, const Taps& td, float a,
           float b, const int* pairs, int n_pairs, cudaStream_t stream) {
  const int smem = onepass_smem_floats(k, TX, TY, kNBuf) * static_cast<int>(sizeof(float));
  const int tiles = demons_tiles(rows, ny, TX, TY);
  int blocks;
  if constexpr (kStrip) {
    (void)pairs;
    (void)n_pairs;
  } else {
    if (pairs != nullptr) {
      static GridCache cache;
      auto* kernel = demons_onepass_batch_kernel<K, TX, TY, kNBuf, kAddition>;
      const int rc = persistent_grid(kernel, demons_threads(TX, TY), smem, n_pairs * tiles,
                                     &cache, &blocks);
      if (rc != 0) return rc;
      kernel<<<blocks, demons_threads(TX, TY), smem, stream>>>(iaux, iref, u, out, partials,
                                                               rows, ny, k, tf, td, a, b, pairs,
                                                               n_pairs);
      return static_cast<int>(cudaGetLastError());
    }
  }
  static GridCache cache;
  auto* kernel = demons_onepass_kernel<K, TX, TY, kNBuf, kAddition, kStrip>;
  const int rc = persistent_grid(kernel, demons_threads(TX, TY), smem, tiles, &cache, &blocks);
  if (rc != 0) return rc;
  kernel<<<blocks, demons_threads(TX, TY), smem, stream>>>(iaux, iref, u, out, partials, rows, ny,
                                                           halo, k, tf, td, a, b);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of k's plan: kw 5 with its taps known, the others at
// run time.
template <bool kAddition, bool kStrip>
int dispatch(const float* iaux, const float* iref, const float* u, float* out, float* partials,
             const Rows& rows, int ny, int halo, int k, const Taps& tf, const Taps& td, float a,
             float b, const int* pairs, int n_pairs, cudaStream_t stream) {
  const DemonsPlan p = onepass_plan(k);
  if (p.tx == kTileX && p.ty == kTileY && p.nbuf == kTileBufs)
    return k == 5 ? launch<5, kTileX, kTileY, kTileBufs, kAddition, kStrip>(
                        iaux, iref, u, out, partials, rows, ny, halo, k, tf, td, a, b, pairs,
                        n_pairs, stream)
                  : launch<0, kTileX, kTileY, kTileBufs, kAddition, kStrip>(
                        iaux, iref, u, out, partials, rows, ny, halo, k, tf, td, a, b, pairs,
                        n_pairs, stream);
  if (p.tx == kSmallTile && p.nbuf == 2)
    return launch<0, kSmallTile, kSmallTile, 2, kAddition, kStrip>(
        iaux, iref, u, out, partials, rows, ny, halo, k, tf, td, a, b, pairs, n_pairs, stream);
  if (p.tx == kSmallTile && p.nbuf == 1)
    return launch<0, kSmallTile, kSmallTile, 1, kAddition, kStrip>(
        iaux, iref, u, out, partials, rows, ny, halo, k, tf, td, a, b, pairs, n_pairs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory of a B10 (and K5) thread block at kernelwidth k: its plan's,
// or, where no tile fits, the smallest layout's (more than a block has).
extern "C" int of2d_demons_onepass_smem_bytes(int k) {
  const DemonsPlan p = onepass_plan(k);
  const int floats = p.tx ? onepass_smem_floats(k, p.tx, p.ty, p.nbuf)
                          : onepass_smem_floats(k, kSmallTile, kSmallTile, 1);
  return floats * static_cast<int>(sizeof(float));
}

// Tiles of B10 at kernelwidth k on an nx x ny image: the rows of its
// Logger partials.
extern "C" int of2d_demons_nblocks(int nx, int ny, int k) {
  const DemonsPlan p = onepass_plan(k);
  return p.tx ? demons_tiles(whole_image(nx), ny, p.tx, p.ty) : 0;
}

// iaux, iref [nx, ny], u [2, nx, ny] -> out [2, nx, ny] and, when partials
// is not null, sums [2]; partials [nblocks, 2] is scratch. taps_f and
// taps_d are host arrays of k floats; a = sigma_i^2, b = sigma_x^2.
extern "C" int of2d_demons_onepass(const float* iaux, const float* iref, const float* u,
                                   float* out, float* partials, float* sums, int nx,
                                   int ny, int k, const float* taps_f,
                                   const float* taps_d, float a, float b, int addition,
                                   cudaStream_t stream) {
  Taps tf, td;
  if (!make_taps(taps_f, k, &tf) || !make_taps(taps_d, k, &td))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows = whole_image(nx);
  const int rc = addition ? dispatch<true, false>(iaux, iref, u, out, partials, rows, ny, 0, k,
                                                  tf, td, a, b, nullptr, 0, stream)
                          : dispatch<false, false>(iaux, iref, u, out, partials, rows, ny, 0, k,
                                                   tf, td, a, b, nullptr, 0, stream);
  if (rc != 0 || partials == nullptr) return rc;
  return launch_sum_partials(partials, sums, of2d_demons_nblocks(nx, ny, k), 2, stream);
}

// B10's pair axis: iaux, iref [B, nx, ny], u [B, 2, nx, ny] -> for the
// n_pairs pairs listed in pairs (device int32, each in [0, B), no repeats)
// out [B, 2, nx, ny] at each pair's place (the other pairs are not written)
// and sums [n_pairs, 2] in list order; partials [n_pairs, nblocks, 2]
// (of2d_demons_nblocks) is scratch. Each pair's field and sums equal its
// own of2d_demons_onepass's: its tiles are computed alike and its partials
// added in the same order.
extern "C" int of2d_demons_onepass_batch(const float* iaux, const float* iref, const float* u,
                                         float* out, float* partials, float* sums,
                                         const int* pairs, int n_pairs, int nx, int ny, int k,
                                         const float* taps_f, const float* taps_d, float a,
                                         float b, int addition, cudaStream_t stream) {
  Taps tf, td;
  if (!make_taps(taps_f, k, &tf) || !make_taps(taps_d, k, &td))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = of2d_demons_nblocks(nx, ny, k);
  if (n_pairs < 1 || n_pairs > kMaxPairs || tiles < 1 ||
      static_cast<long long>(n_pairs) * tiles > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows = whole_image(nx);
  const int rc = addition ? dispatch<true, false>(iaux, iref, u, out, partials, rows, ny, 0, k,
                                                  tf, td, a, b, pairs, n_pairs, stream)
                          : dispatch<false, false>(iaux, iref, u, out, partials, rows, ny, 0, k,
                                                   tf, td, a, b, pairs, n_pairs, stream);
  if (rc != 0) return rc;
  return launch_sum_partials(partials, sums, tiles, 2, stream, n_pairs);
}

// K5, one strip: iaux_pad, iref_pad [nxl + 2 pad, ny] and u_pad [2, nxl + 2
// pad, ny] of the strip whose first row is global row row0 of nx_glob ->
// out [2, nxl, ny], one Thirion iteration by composition, no Logger sums.
// Needs pad >= 2 (k / 2) + halo + 2, the reach of an output row.
extern "C" int of2d_demons_onepass_strip(const float* iaux_pad, const float* iref_pad,
                                         const float* u_pad, float* out, int nxl, int ny,
                                         int pad, int row0, int nx_glob, int halo, int k,
                                         const float* taps_f, const float* taps_d, float a,
                                         float b, cudaStream_t stream) {
  Taps tf, td;
  const Rows rows{nxl, pad, row0, nx_glob};
  if (!make_taps(taps_f, k, &tf) || !make_taps(taps_d, k, &td) || halo < 0 ||
      !strip_ok(rows, 2 * (k / 2) + halo + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false, true>(iaux_pad, iref_pad, u_pad, out, nullptr, rows, ny, halo, k, tf,
                               td, a, b, nullptr, 0, stream);
}
