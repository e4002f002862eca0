// Bilinear backward warp and motion composition by direct gather on Hopper
// (sm_90a). One templated body, four entry points:
//   B3 of2d_warp2d, of2d_compose: the whole image, exact for any
//      displacement;
//   K4 of2d_warp2d_strip, of2d_compose_strip: one strip of the
//      strip-parallel driver (parallel/spatial.py), pre-padded with its
//      neighbours' halo rows, under the strip driver's displacement contract.
//
// Replaces: opticalflow2d_tpu/pallas_kernels/warp_fused.py, _run_gather
//   (:173), reached through warp2d_pallas (:249) and compose_pallas (:257)
//   for B3, and with prepadded=True through warp2d_pallas_strip (:263) and
//   compose_pallas_strip (:278) for K4.
// Bound on this card: device-memory bandwidth. Per pixel the warp reads u
//   (8 B), four taps and the original (up to 20 B, mostly cache hits for
//   smooth motion) and writes 4 B; the compose does the same for two
//   channels. A strip also reads its 2 * pad halo rows of the data.
// Design: one thread per output pixel reads its four taps (bilinear.cuh).
//   Hopper has a hardware gather, so the TPU kernel's masked-roll chain has
//   no counterpart. One body serves both operations: 1 channel with
//   passthrough of the image, or 2 channels with the increment added
//   (warp_fused.py:161-170).
// Strips (kStrip, rows.cuh): the sample of local row i uses global row
//   row0 + i for its coordinates, bounds and edge weights, as the image
//   does. Its taps are read from the pre-padded strip, at padded rows
//   dx - row0 + pad and one below, and only inside the contract of
//   parallel/spatial.py::_bilinear_local (:262-315): both floor offsets
//   rx = dx - gi and ry = dy - gj in [-halo, halo]. Outside it the sample's
//   value is 0: a warp gives 0 there and a compose adds 0, as the jnp strip
//   route of the TPU package does (the Pallas hat gather also picks up
//   rx = halo + 1; the two agree inside the contract). pad >= halo + 1
//   keeps every tap inside the padded strip; the wrapper infers pad from
//   the shapes.
// Numerics: weights and sums in the order of ops/warp.py:95-114, with
//   -fmad=false, so the result rounds like the plain versions on the same
//   device; inside the contract a strip equals B3's rows bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "bilinear.cuh"
#include "rows.cuh"

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 8;

// Move the taps of b, the sample of global pixel (gi, j), into the padded
// strip of rows r; false where a floor offset lies outside [-halo, halo].
__device__ __forceinline__ bool strip_taps(Bilinear& b, int gi, int j, const Rows& r, int ny,
                                           int halo) {
  const int rx = b.dx - gi, ry = b.dy - j;
  if (rx < -halo || rx > halo || ry < -halo || ry > halo) return false;
  const size_t x0 = static_cast<size_t>(b.dx - r.row0 + r.pad) * ny;
  const size_t x1 = x0 + ny;
  const int y0 = min(max(b.dy, 0), ny - 1);
  const int y1 = b.dy >= ny - 1 ? ny - 1 : max(b.dy + 1, 0);
  b.p00 = x0 + y0;
  b.p10 = x1 + y0;
  b.p01 = x0 + y1;
  b.p11 = x1 + y1;
  return true;
}

// kCompose = false: data is the image [rows, ny]; out-of-bounds samples and
//   samples of zero weight keep the image value.
// kCompose = true: data is u_total [2, rows, ny]; in bounds the result is
//   u_inc + u_total(x + u_inc) (u_inc alone where the weight is 0), out of
//   bounds the old u_total.
// u and out are [C, r.nxl, ny]; data carries r.pad more rows a side.
template <int kChannels, bool kCompose, bool kStrip>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gather_kernel(const float* __restrict__ data, const float* __restrict__ u,
              float* __restrict__ out, Rows r, int ny, int halo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= r.nxl || j >= ny) return;
  const size_t n = r.out_plane(ny);
  const size_t n_data = r.in_plane(ny);
  const size_t p = static_cast<size_t>(i) * ny + j;
  const size_t p_data = r.in_row(i, ny) + j;
  const int gi = r.row0 + i;
  const float ux = u[p], uy = u[n + p];
  Bilinear b = bilinear_at(gi, j, ux, uy, r.nx, ny);
  const bool taps = kStrip ? strip_taps(b, gi, j, r, ny, halo) : true;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float* d = data + c * n_data;
    const float value = taps ? bilinear_value(d, b) : 0.f;
    if (kCompose) {
      const float inc = c == 0 ? ux : uy;
      out[c * n + p] = b.in_bounds ? inc + (b.weight != 0.f ? value / b.weight : 0.f)
                                   : d[p_data];
    } else {
      out[p] = (b.in_bounds && b.weight != 0.f) ? value / b.weight : d[p_data];
    }
  }
}

template <int kChannels, bool kCompose, bool kStrip>
int launch(const float* data, const float* u, float* out, Rows r, int ny, int halo,
           cudaStream_t stream) {
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (r.nxl + kThreadsX - 1) / kThreadsX);
  gather_kernel<kChannels, kCompose, kStrip><<<grid, block, 0, stream>>>(data, u, out, r, ny,
                                                                         halo);
  return static_cast<int>(cudaGetLastError());
}

bool strip_halo_ok(const Rows& r, int halo) { return halo >= 0 && strip_ok(r, halo + 1); }

}  // namespace

extern "C" int of2d_warp2d(const float* image, const float* u, float* out, int nx,
                           int ny, cudaStream_t stream) {
  return launch<1, false, false>(image, u, out, whole_image(nx), ny, 0, stream);
}

extern "C" int of2d_compose(const float* u_total, const float* u_inc, float* out,
                            int nx, int ny, cudaStream_t stream) {
  return launch<2, true, false>(u_total, u_inc, out, whole_image(nx), ny, 0, stream);
}

// K4 warp: image_pad [nxl + 2 pad, ny], u [2, nxl, ny] of the strip whose
// first row is global row row0 of nx_glob -> out [nxl, ny]. Needs
// pad >= halo + 1.
extern "C" int of2d_warp2d_strip(const float* image_pad, const float* u, float* out, int nxl,
                                 int ny, int pad, int row0, int nx_glob, int halo,
                                 cudaStream_t stream) {
  const Rows r{nxl, pad, row0, nx_glob};
  if (!strip_halo_ok(r, halo)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1, false, true>(image_pad, u, out, r, ny, halo, stream);
}

// K4 compose: u_total_pad [2, nxl + 2 pad, ny], u_inc [2, nxl, ny] -> out
// [2, nxl, ny]. Needs pad >= halo + 1.
extern "C" int of2d_compose_strip(const float* u_total_pad, const float* u_inc, float* out,
                                  int nxl, int ny, int pad, int row0, int nx_glob, int halo,
                                  cudaStream_t stream) {
  const Rows r{nxl, pad, row0, nx_glob};
  if (!strip_halo_ok(r, halo)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<2, true, true>(u_total_pad, u_inc, out, r, ny, halo, stream);
}
