// Bilinear backward warp and motion composition by direct gather on Hopper
// (sm_90a). One templated body, four entry points:
//   B3 of2d_warp2d, of2d_compose: the whole image, exact for any
//      displacement; of2d_warp2d_batch, of2d_compose_batch: the listed pairs
//      of a stack in one launch (the grid's z axis; parallel/batch.py);
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
//   rx = dx - gi and ry = dy - gj in [-halo, halo] (bilinear.cuh::
//   strip_taps, shared with the demons strip kernels). Outside it the sample's
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
constexpr int kMaxPairs = 65535;  // pairs of one batched launch: a grid's z extent

// kCompose = false: data is the image [rows, ny]; out-of-bounds samples and
//   samples of zero weight keep the image value.
// kCompose = true: data is u_total [2, rows, ny]; in bounds the result is
//   u_inc + u_total(x + u_inc) (u_inc alone where the weight is 0), out of
//   bounds the old u_total.
// u and out are [C, r.nxl, ny]; data carries r.pad more rows a side.
// kBatch (B3 batched, whole images): blockIdx.z is a position in the list
// ``pairs``, and data, u and out of pair pairs[z] start kChannels, 2 and
// kChannels planes a pair in (64-bit offsets); a single launch compiles
// without it.
template <int kChannels, bool kCompose, bool kStrip, bool kBatch = false>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gather_kernel(const float* __restrict__ data, const float* __restrict__ u,
              float* __restrict__ out, Rows r, int ny, int halo,
              const int* __restrict__ pairs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= r.nxl || j >= ny) return;
  const size_t n = r.out_plane(ny);
  const size_t n_data = r.in_plane(ny);
  if (kBatch) {
    const size_t pair = static_cast<size_t>(pairs[blockIdx.z]);
    data += pair * kChannels * n_data;
    u += pair * 2 * n;
    out += pair * kChannels * n;
  }
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

template <int kChannels, bool kCompose, bool kStrip, bool kBatch = false>
int launch(const float* data, const float* u, float* out, Rows r, int ny, int halo,
           cudaStream_t stream, const int* pairs = nullptr, int n_pairs = 1) {
  if (n_pairs < 1 || n_pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (r.nxl + kThreadsX - 1) / kThreadsX,
                  n_pairs);
  gather_kernel<kChannels, kCompose, kStrip, kBatch><<<grid, block, 0, stream>>>(
      data, u, out, r, ny, halo, pairs);
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

// B3 batched: images [B, nx, ny] (compose: u_total [B, 2, nx, ny]), u [B, 2,
// nx, ny] -> out shaped as the data, for the n_pairs pairs listed in pairs
// (device int32, each in [0, B), no repeats; the other pairs of out are not
// written).
extern "C" int of2d_warp2d_batch(const float* images, const float* u, float* out,
                                 const int* pairs, int n_pairs, int nx, int ny,
                                 cudaStream_t stream) {
  return launch<1, false, false, true>(images, u, out, whole_image(nx), ny, 0, stream, pairs,
                                       n_pairs);
}

extern "C" int of2d_compose_batch(const float* u_total, const float* u_inc, float* out,
                                  const int* pairs, int n_pairs, int nx, int ny,
                                  cudaStream_t stream) {
  return launch<2, true, false, true>(u_total, u_inc, out, whole_image(nx), ny, 0, stream,
                                      pairs, n_pairs);
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
