// The Euler pass of the two-pass fluid iteration on Hopper (sm_90a): R
// recomputed from the motion u and the swept velocity vel, then the gated
// explicit-Euler update u' = where(gate > 0, u + R * gate, u).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/fluid_fused.py,
//   fluid_euler_pallas (B9, :428; body _euler_kernel :394).
// Bound on this card: device-memory bandwidth. It reads u and vel (2 planes
//   each) and writes u' (2 planes): 24 B per pixel, for about 20 flops.
// Design: one thread per pixel, neighbouring threads on neighbouring y, as
//   diffusion_step.cu: the four neighbours of u come from global memory,
//   where the rows above and below are cache hits of the neighbouring
//   threads' loads. The gate is a device float, written by the timestep on
//   the card (solvers/fluid.py), so the pass needs no host read. The TPU
//   kernel's row blocks with halo rows and its full-lane gate tile existed
//   for Mosaic and have no counterpart here.
// Numerics: R through material_derivative.cuh, the expression and border
//   rule of fluid_iter.cu, with -fmad=false: R from the same stored u and
//   vel' has the bits of the R that B7 writes and B8 keeps in registers.

#include <cuda_runtime.h>

#include <cstddef>

#include "material_derivative.cuh"

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 8;

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
fluid_euler_kernel(const float* __restrict__ u, const float* __restrict__ vel,
                   const float* __restrict__ gate, float* __restrict__ out, int nx, int ny) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t n = static_cast<size_t>(nx) * ny;
  const size_t p = static_cast<size_t>(i) * ny + j;
  const float gt = *gate;
  const float v0 = vel[p], v1 = vel[n + p];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* uc = u + c * n;
    const float here = uc[p];
    // A neighbour outside the image is never used by central(); load the
    // cell itself in its place.
    const float up = i > 0 ? uc[p - ny] : here;
    const float dn = i < nx - 1 ? uc[p + ny] : here;
    const float lf = j > 0 ? uc[p - 1] : here;
    const float rt = j < ny - 1 ? uc[p + 1] : here;
    const float r = material_r(c == 0 ? v0 : v1, v0, v1, central(up, here, dn, i, nx),
                               central(lf, here, rt, j, ny));
    out[c * n + p] = gt > 0.f ? here + r * gt : here;
  }
}

}  // namespace

// u, vel [2, nx, ny], gate [1] (device) -> out [2, nx, ny]; nx, ny >= 2.
extern "C" int of2d_fluid_euler(const float* u, const float* vel, const float* gate, float* out,
                                int nx, int ny, cudaStream_t stream) {
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + kThreadsY - 1) / kThreadsY, (nx + kThreadsX - 1) / kThreadsX);
  fluid_euler_kernel<<<grid, block, 0, stream>>>(u, vel, gate, out, nx, ny);
  return static_cast<int>(cudaGetLastError());
}
