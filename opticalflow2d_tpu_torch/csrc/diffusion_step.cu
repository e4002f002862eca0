// One fused Horn-Schunck diffusion step on Hopper (sm_90a).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/diffusion_fused.py,
//   diffusion_step_pallas (the TPU kernel, :106). of2d_diffusion_step_batch
//   runs the listed pairs of a stack in one launch (the grid's z axis; the
//   lockstep batch driver's recompute of a block, parallel/batch.py).
// Bound on this card: device-memory bandwidth. A step reads u (2 planes),
//   gx, gy, It and writes u_new (2 planes): about 28 B per pixel-iteration
//   against almost no arithmetic (diffusion_fused.py:3-6).
// Design: one thread per pixel, neighbouring threads on neighbouring y, so
//   every plane is read and written in coalesced rows; the four neighbours
//   of u come from global memory, where the rows above and below are L2
//   and L1 hits of the neighbouring threads' loads. The TPU kernel's row
//   tiles with 8-row halo blocks existed for VMEM alignment and have no
//   counterpart here.
// Numerics: the Pallas kernel's order of operations, with -fmad=false, so
//   the result rounds like diffusion_step_ref on the same device.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 8;
constexpr int kMaxPairs = 65535;  // pairs of one batched launch: a grid's z extent

// kBatch (B2 batched): blockIdx.z is a position in the list ``pairs``, and
// u and out of pair pairs[z] start 2 planes a pair in, gx, gy and It
// g_stride floats a pair in (64-bit offsets); a single launch compiles
// without it.
template <bool kBatch>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
diffusion_step_kernel(const float* __restrict__ u, const float* __restrict__ gx,
                      const float* __restrict__ gy, const float* __restrict__ it,
                      float* __restrict__ out, int nx, int ny, float a2,
                      const int* __restrict__ pairs, size_t g_stride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t n = static_cast<size_t>(nx) * ny;
  if (kBatch) {
    const size_t pair = static_cast<size_t>(pairs[blockIdx.z]);
    u += pair * 2 * n;
    out += pair * 2 * n;
    gx += pair * g_stride;
    gy += pair * g_stride;
    it += pair * g_stride;
  }
  const size_t p = static_cast<size_t>(i) * ny + j;
  // Zero-border quasi-laplacian (reference src/gradients.h:72-80).
  float q0 = 0.f, q1 = 0.f;
  if (i > 0 && i < nx - 1 && j > 0 && j < ny - 1) {
    const float* v = u + n;
    q0 = (u[p - ny] + u[p + ny] + (u[p - 1] + u[p + 1])) * 0.25f;
    q1 = (v[p - ny] + v[p + ny] + (v[p - 1] + v[p + 1])) * 0.25f;
  }
  // L-SSD force at q and the Jacobi update (OpticalFlow.cpp:15-39,
  // OpticalFlowDiffusion.cpp:57-84).
  const float x = gx[p], y = gy[p];
  const float inner = it[p] + q0 * x + q1 * y;
  const float den = a2 + x * x + y * y;
  const float scale = inner / den;
  out[p] = q0 - x * scale;
  out[n + p] = q1 - y * scale;
}

}  // namespace

extern "C" int of2d_diffusion_step(const float* u, const float* gx, const float* gy,
                                   const float* it, float* out, int nx, int ny,
                                   float a2, cudaStream_t stream) {
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (nx + kThreadsX - 1) / kThreadsX);
  diffusion_step_kernel<false><<<grid, block, 0, stream>>>(u, gx, gy, it, out, nx, ny, a2,
                                                           nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// B2 batched: u [B, 2, nx, ny], g [B, 3, nx, ny] (gx, gy, It) -> out [B, 2,
// nx, ny] for the n_pairs pairs listed in pairs (device int32, each in
// [0, B), no repeats; the other pairs of out are not written).
extern "C" int of2d_diffusion_step_batch(const float* u, const float* g, float* out,
                                         const int* pairs, int n_pairs, int nx, int ny,
                                         float a2, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(nx) * ny;
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (nx + kThreadsX - 1) / kThreadsX, n_pairs);
  diffusion_step_kernel<true><<<grid, block, 0, stream>>>(u, g, g + n, g + 2 * n, out, nx, ny,
                                                          a2, pairs, 3 * n);
  return static_cast<int>(cudaGetLastError());
}
