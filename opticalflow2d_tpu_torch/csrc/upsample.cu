// Bilinear upsample of a motion field in one pass on Hopper (sm_90a):
// of2d_upsample_motion, the level loop's motion upsample (ops/resample.py::
// upsample_motion, engine/registration.py), each level's field brought to
// full resolution.
//
// Replaces: no TPU kernel. The JAX package upsamples in jnp
//   (opticalflow2d_tpu/ops/resample.py); the port's plain version
//   (kernels/upsample.py::upsample_motion_ref) ran it as some 60 device
//   operations on full-size temporaries (int64 corners and clamped indices,
//   weights, masks, four index gathers), 64-256 MiB each at 4096^2.
// Bound on this card: device-memory bandwidth, the output's write (8 B a
//   point for the two components) and the source's read (at most 32 MiB at
//   2048^2 -> 4096^2, which stays in the 50 MB L2): 0.040-0.050 ms at 4096^2
//   over 3.35 TB/s.
// Design: a gather bound by its stores. One thread takes kVec consecutive
//   points of kRows consecutive output rows, so consecutive threads store
//   consecutive columns (16-B stores where ny_out % 4 == 0), a column's
//   y-part is formed once for its rows, and rows that sample one source row
//   find its taps in L1. Each point's coordinates and weights are formed once
//   (bilinear.cuh::bilinear_point) and both components from them. The taps
//   are read through L1 from the L2-resident source. No shared memory, no
//   sync; 64-bit offsets (the 16384^2 path writes 2^29 floats).
//   Chosen by probes/upsample_sweep.py at 2048^2 -> 4096^2 (H100 80GB HBM3,
//   700 W): 4 points by 4 rows a thread in 32 x 4 blocks, 0.0725 ms; one row
//   a thread 0.0808, one point 0.118; the stores alone take 0.044 and the
//   arithmetic without its two correctly rounded divisions 0.062, so the
//   instructions a point, not the stores, set the rest.
// Numerics: output (i, j) samples (i * rx, j * ry), rx = f32(nx_in / nx_out),
//   with the corner-anchored taps and the edge renormalization of
//   src/Field.tpp:146-206, then scales component c by f32(n_out / n_in) of
//   its axis (src/Motion.cpp:61-85). Every product and sum is formed in the
//   plain version's order, and all four taps are multiplied even where a
//   weight is 0, so that signed zeros agree; with -fmad=false the result
//   equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "bilinear.cuh"

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 4;
constexpr int kRows = 4;       // consecutive output rows a thread

// src [2, nx_in, ny_in] -> out [2, nx_out, ny_out]. kVec is 4 only where
// ny_out % 4 == 0, so a thread's points all lie inside the row.
template <int kVec>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
upsample_kernel(const float* __restrict__ src, float* __restrict__ out, int nx_in, int ny_in,
                int nx_out, int ny_out, float rx, float ry, float sx, float sy) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int i0 = (blockIdx.y * blockDim.y + threadIdx.y) * kRows;
  if (j0 >= ny_out) return;
  const size_t n_in = static_cast<size_t>(nx_in) * ny_in;
  const size_t n_out = static_cast<size_t>(nx_out) * ny_out;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= nx_out) return;
    const float px = static_cast<float>(i) * rx;
    float vx[kVec], vy[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const Bilinear b =
          bilinear_point(px, static_cast<float>(j0 + k) * ry, nx_in, ny_in);
      const float weight = b.weight != 0.f ? b.weight : 1.f;
      vx[k] = bilinear_value(src, b) / weight * sx;
      vy[k] = bilinear_value(src + n_in, b) / weight * sy;
    }
    const size_t p = static_cast<size_t>(i) * ny_out + j0;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(out + p) = make_float4(vx[0], vx[1], vx[2], vx[3]);
      *reinterpret_cast<float4*>(out + n_out + p) = make_float4(vy[0], vy[1], vy[2], vy[3]);
    } else {
      out[p] = vx[0];
      out[n_out + p] = vy[0];
    }
  }
}

template <int kVec>
int launch(const float* src, float* out, int nx_in, int ny_in, int nx_out, int ny_out,
           float rx, float ry, float sx, float sy, cudaStream_t stream) {
  const int columns = kThreadsY * kVec;
  const int rows = kThreadsX * kRows;
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny_out + columns - 1) / columns, (nx_out + rows - 1) / rows);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  upsample_kernel<kVec><<<grid, block, 0, stream>>>(src, out, nx_in, ny_in, nx_out, ny_out,
                                                    rx, ry, sx, sy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [2, nx_in, ny_in] (the motion's two components) -> out [2, nx_out,
// ny_out], nx_in <= nx_out and ny_in <= ny_out: out(c, i, j) samples src at
// (i * rx, j * ry) and scales component 0 by sx, 1 by sy. The wrapper rounds
// rx = nx_in / nx_out, ry, sx = nx_out / nx_in and sy to float32 on the host.
extern "C" int of2d_upsample_motion(const float* src, float* out, int nx_in, int ny_in,
                                    int nx_out, int ny_out, float rx, float ry, float sx,
                                    float sy, cudaStream_t stream) {
  if (nx_in < 1 || ny_in < 1 || nx_out < nx_in || ny_out < ny_in)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ny_out % 4 == 0)
    return launch<4>(src, out, nx_in, ny_in, nx_out, ny_out, rx, ry, sx, sy, stream);
  return launch<1>(src, out, nx_in, ny_in, nx_out, ny_out, rx, ry, sx, sy, stream);
}
