// One Thirion demons iteration in one pass over device memory on Hopper
// (sm_90a): warp -> gradient -> demons force -> Gaussian(sigma_fluid) ->
// compose or add -> Gaussian(sigma_diffusion), with the reference Logger's
// sums [sum |u_new - u|, sum |u|]. Two entry points:
//   B10 of2d_demons_onepass: the whole image;
//   K5 of2d_demons_onepass_strip: one strip of the strip-parallel driver
//     (parallel/spatial.py), pre-padded with its neighbours' halo rows,
//     composing under the strips' displacement contract, no Logger sums.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/demons_onepass.py,
//   thirion_onepass_pallas (:310, body _onepass_body :114-206), dense (B10)
//   and with prepadded=True (K5, strip body _strip_kernel :222).
// Bound on this card: device-memory bandwidth. It must read iaux, iref and
//   u and write u_new, 24 B per pixel: at 4096^2, 403 MB, or 0.120 ms at
//   3.35 TB/s. The arithmetic (two k-tap separable Gaussians over two
//   channels, two bilinear gathers) is about 20k + 60 flops per pixel,
//   well under the float32 peak at the kernel widths users take.
// Design: one thread block per 32 x 32 output tile. Shared memory holds
//   the tile extended by r = kw//2 (sigma_d) + kw//2 (sigma_f) + 1
//   (gradient) on every side; the stages of demons_stages.cuh shrink it
//   stage by stage, between two ping-pong buffers: iwar (gathered from
//   global iaux at x + u(x)) and iref, then corr, the x pass of sigma_f,
//   the smoothed c, `composed` on the tile +- kw//2 (gathered from global u
//   at x + c), the x pass of sigma_d, and the tile written once. So the
//   intermediates never touch device memory; the halo is read again by
//   neighbouring blocks, mostly from L2. The gathers read global memory
//   and are exact for any displacement, so the TPU kernel's halo bound and
//   its fallback have no counterpart. Per-block Logger partials are added
//   in block order by a second kernel (partials.cuh). A kernelwidth whose
//   tile does not fit the card's shared memory is refused by the wrapper.
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

__host__ __device__ constexpr int onepass_smem_floats(int k) {
  // Buffer A: iwar and iref, e x e each; buffer B: corr, m x m per channel;
  // then the warp partials of the Logger sums.
  return 2 * (kTile + 2 * (2 * (k / 2) + 1)) * (kTile + 2 * (2 * (k / 2) + 1)) +
         2 * (kTile + 4 * (k / 2)) * (kTile + 4 * (k / 2)) + 2 * kThreadsX;
}

template <bool kAddition, bool kSums, bool kStrip>
__global__ void __launch_bounds__(kThreads)
demons_onepass_kernel(const float* __restrict__ iaux, const float* __restrict__ iref,
                      const float* __restrict__ u, float* __restrict__ out,
                      float* __restrict__ partials, Rows rows, int ny, int halo, int k,
                      Taps taps_f, Taps taps_d, float a, float b) {
  extern __shared__ float smem[];
  const int c = k / 2;
  const int r = 2 * c + 1;          // halo of the warp region
  const int e = kTile + 2 * r;      // iwar, iref: origin (i0 - r, j0 - r)
  const int m = kTile + 4 * c;      // corr: origin (i0 - 2c, j0 - 2c)
  const int d = kTile + 2 * c;      // smoothed c, composed: origin (i0 - c, j0 - c)
  const int nx = rows.nx;
  float* sa = smem;
  float* sb = sa + 2 * e * e;
  float* red = sb + 2 * m * m;
  const int i0 = rows.row0 + blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  stage_warp<kStrip>(iaux, iref, u, rows, ny, halo, i0 - r, j0 - r, e, sa, sa + e * e);
  __syncthreads();
  stage_force(sa, sa + e * e, e, i0 - r, j0 - r, nx, ny, a, b, sb);
  __syncthreads();
  smooth_x(sb, m, m, i0 - c, nx, taps_f, k, sa);                 // d x m
  __syncthreads();
  smooth_y(sa, d, m, i0 - c, j0 - c, nx, ny, taps_f, k, sb);     // d x d
  __syncthreads();
  stage_accumulate<kAddition, kStrip>(sb, d, i0 - c, j0 - c, u, rows, ny, halo, sa);
  __syncthreads();
  smooth_x(sa, d, d, i0, nx, taps_d, k, sb);                     // kTile x d
  __syncthreads();
  float dsum = 0.f, psum = 0.f;
  smooth_y_store<kSums>(sb, d, i0, j0, rows, ny, taps_d, k, out, u, dsum, psum);
  if (kSums) {
    const size_t bid = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    block_sum_pair<kThreadsX>(dsum, psum, threadIdx.y * kThreadsY + threadIdx.x, red,
                              partials + 2 * bid);
  }
}

template <bool kAddition, bool kSums, bool kStrip>
int launch(const float* iaux, const float* iref, const float* u, float* out,
           float* partials, const Rows& rows, int ny, int halo, int k, const Taps& tf,
           const Taps& td, float a, float b, cudaStream_t stream) {
  const int smem = static_cast<int>(onepass_smem_floats(k) * sizeof(float));
  auto* kernel = demons_onepass_kernel<kAddition, kSums, kStrip>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tile_grid(rows, ny), dim3(kThreadsY, kThreadsX), smem, stream>>>(
      iaux, iref, u, out, partials, rows, ny, halo, k, tf, td, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int of2d_demons_onepass_smem_bytes(int k) {
  return static_cast<int>(onepass_smem_floats(k) * sizeof(float));
}

extern "C" int of2d_demons_nblocks(int nx, int ny) {
  const dim3 grid = tile_grid(whole_image(nx), ny);
  return static_cast<int>(grid.x * grid.y);
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
  int rc;
  if (partials == nullptr) {
    rc = addition ? launch<true, false, false>(iaux, iref, u, out, nullptr, rows, ny, 0, k, tf,
                                               td, a, b, stream)
                  : launch<false, false, false>(iaux, iref, u, out, nullptr, rows, ny, 0, k,
                                                tf, td, a, b, stream);
    return rc;
  }
  rc = addition ? launch<true, true, false>(iaux, iref, u, out, partials, rows, ny, 0, k, tf,
                                            td, a, b, stream)
                : launch<false, true, false>(iaux, iref, u, out, partials, rows, ny, 0, k, tf,
                                             td, a, b, stream);
  if (rc != 0) return rc;
  return launch_sum_partials(partials, sums, of2d_demons_nblocks(nx, ny), 2, stream);
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
  return launch<false, false, true>(iaux_pad, iref_pad, u_pad, out, nullptr, rows, ny, halo, k,
                                    tf, td, a, b, stream);
}
