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
// Bound on this card: device-memory bandwidth. B11 reads iaux, iref and u
//   and writes c, 24 B per pixel; B12 reads u and c and writes the new
//   motion, 24 B per pixel: at 4096^2 each moves 403 MB, or 0.120 ms at
//   3.35 TB/s. Their arithmetic is well under the float32 peak.
// Design: the stages of demons_stages.cuh on a 32 x 32 output tile per
//   thread block, as in demons_onepass.cu. B11 holds the tile extended by
//   kw//2 + 1 (iwar and iref, then corr and the x pass); B12 loads c on the
//   tile +- kw//2, composes it with u gathered from global memory at
//   x + c, and smooths. The gathers are exact for any displacement, so the
//   exp map's squarings, which grow the field, need no halo bound.
// Strips (kStrip, rows.cuh): the same stages on the strip's rows, the
//   gathers' taps from the padded strip inside the strips' contract only
//   (bilinear.cuh::strip_taps). An output row of K6 reaches kw//2 + halo + 2
//   rows, of K7 kw//2 + halo + 1: the pads the entry points ask for. Inside
//   the contract a strip equals B11's or B12's rows bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "demons_stages.cuh"

namespace {

__host__ __device__ constexpr int correspondence_smem_floats(int k) {
  // Buffer A: iwar and iref, e x e each (then the x pass, kTile x m);
  // buffer B: corr, m x m per channel.
  return 2 * (kTile + 2 * (k / 2 + 1)) * (kTile + 2 * (k / 2 + 1)) +
         2 * (kTile + 2 * (k / 2)) * (kTile + 2 * (k / 2));
}

__host__ __device__ constexpr int compose_smooth_smem_floats(int k) {
  // Buffer A: c on the tile +- kw//2 (then the x pass); buffer B: composed.
  return 4 * (kTile + 2 * (k / 2)) * (kTile + 2 * (k / 2));
}

template <bool kStrip>
__global__ void __launch_bounds__(kThreads)
correspondence_kernel(const float* __restrict__ iaux, const float* __restrict__ iref,
                      const float* __restrict__ u, float* __restrict__ out, Rows rows, int ny,
                      int halo, int k, Taps taps_f, float a, float b) {
  extern __shared__ float smem[];
  const int c = k / 2;
  const int r = c + 1;
  const int e = kTile + 2 * r;   // iwar, iref: origin (i0 - r, j0 - r)
  const int m = kTile + 2 * c;   // corr: origin (i0 - c, j0 - c)
  const int nx = rows.nx;
  float* sa = smem;
  float* sb = sa + 2 * e * e;
  const int i0 = rows.row0 + blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  stage_warp<kStrip>(iaux, iref, u, rows, ny, halo, i0 - r, j0 - r, e, sa, sa + e * e);
  __syncthreads();
  stage_force(sa, sa + e * e, e, i0 - r, j0 - r, nx, ny, a, b, sb);
  __syncthreads();
  smooth_x(sb, m, m, i0, nx, taps_f, k, sa);   // kTile x m
  __syncthreads();
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<false>(sa, m, i0, j0, rows, ny, taps_f, k, out, nullptr, unused0, unused1);
}

template <bool kStrip>
__global__ void __launch_bounds__(kThreads)
compose_smooth_kernel(const float* __restrict__ u, const float* __restrict__ cin,
                      float* __restrict__ out, Rows rows, int ny, int halo, int k,
                      Taps taps_d) {
  extern __shared__ float smem[];
  const int c = k / 2;
  const int d = kTile + 2 * c;   // c and composed: origin (i0 - c, j0 - c)
  float* sa = smem;
  float* sb = sa + 2 * d * d;
  const int i0 = rows.row0 + blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const size_t n = rows.in_plane(ny);

  for (int li = threadIdx.y; li < d; li += kThreadsX) {
    const int gi = i0 - c + li;
    const bool row_in = rows.loadable(gi - rows.row0);
    for (int lj = threadIdx.x; lj < d; lj += kThreadsY) {
      const int gj = j0 - c + lj;
      float c0 = 0.f, c1 = 0.f;
      if (row_in && inside(gj, ny)) {
        const size_t p = rows.in_row(gi - rows.row0, ny) + gj;
        c0 = cin[p];
        c1 = cin[n + p];
      }
      sa[li * d + lj] = c0;
      sa[d * d + li * d + lj] = c1;
    }
  }
  __syncthreads();
  stage_accumulate<false, kStrip>(sa, d, i0 - c, j0 - c, u, rows, ny, halo, sb);
  __syncthreads();
  smooth_x(sb, d, d, i0, rows.nx, taps_d, k, sa);   // kTile x d
  __syncthreads();
  float unused0 = 0.f, unused1 = 0.f;
  smooth_y_store<false>(sa, d, i0, j0, rows, ny, taps_d, k, out, nullptr, unused0, unused1);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem_floats) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats * sizeof(float))));
}

template <bool kStrip>
int launch_correspondence(const float* iaux, const float* iref, const float* u, float* out,
                          const Rows& rows, int ny, int halo, int k, const float* taps_f,
                          float a, float b, cudaStream_t stream) {
  Taps tf;
  if (!make_taps(taps_f, k, &tf)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = prepare(correspondence_kernel<kStrip>, correspondence_smem_floats(k));
  if (rc != 0) return rc;
  correspondence_kernel<kStrip><<<tile_grid(rows, ny), dim3(kThreadsY, kThreadsX),
                                  correspondence_smem_floats(k) * sizeof(float), stream>>>(
      iaux, iref, u, out, rows, ny, halo, k, tf, a, b);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStrip>
int launch_compose_smooth(const float* u, const float* c, float* out, const Rows& rows, int ny,
                          int halo, int k, const float* taps_d, cudaStream_t stream) {
  Taps td;
  if (!make_taps(taps_d, k, &td)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = prepare(compose_smooth_kernel<kStrip>, compose_smooth_smem_floats(k));
  if (rc != 0) return rc;
  compose_smooth_kernel<kStrip><<<tile_grid(rows, ny), dim3(kThreadsY, kThreadsX),
                                  compose_smooth_smem_floats(k) * sizeof(float), stream>>>(
      u, c, out, rows, ny, halo, k, td);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int of2d_demons_correspondence_smem_bytes(int k) {
  return static_cast<int>(correspondence_smem_floats(k) * sizeof(float));
}

extern "C" int of2d_compose_smooth_smem_bytes(int k) {
  return static_cast<int>(compose_smooth_smem_floats(k) * sizeof(float));
}

// B11: iaux, iref [nx, ny], u [2, nx, ny] -> c [2, nx, ny]; taps_f is a
// host array of k floats; a = sigma_i^2, b = sigma_x^2.
extern "C" int of2d_demons_correspondence(const float* iaux, const float* iref,
                                          const float* u, float* out, int nx, int ny, int k,
                                          const float* taps_f, float a, float b,
                                          cudaStream_t stream) {
  return launch_correspondence<false>(iaux, iref, u, out, whole_image(nx), ny, 0, k, taps_f, a,
                                      b, stream);
}

// B12: u, c [2, nx, ny] -> Gaussian(sigma_d) of compose(u, c), [2, nx, ny];
// taps_d is a host array of k floats.
extern "C" int of2d_compose_smooth(const float* u, const float* c, float* out, int nx,
                                   int ny, int k, const float* taps_d,
                                   cudaStream_t stream) {
  return launch_compose_smooth<false>(u, c, out, whole_image(nx), ny, 0, k, taps_d, stream);
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
  return launch_correspondence<true>(iaux_pad, iref_pad, u_pad, out, rows, ny, halo, k, taps_f,
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
  return launch_compose_smooth<true>(u_pad, c_pad, out, rows, ny, halo, k, taps_d, stream);
}
