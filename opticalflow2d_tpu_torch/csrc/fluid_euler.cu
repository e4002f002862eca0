// The fluid iteration's gated explicit-Euler update on Hopper (sm_90a), in
// two kernels:
//   B9 fluid_euler, the Euler pass of the two-pass iteration: R recomputed
//      from the motion u and the swept velocity vel, then
//      u' = where(gate > 0, u + R * gate, u);
//   U4 fluid_update, the update given R: B7's R and max |R|^2 (or the plain
//      chain's, on the lexicographic and spectral steps), each pair's
//      timestep dt = dumax / sqrt(max |R|^2) and
//      u' = where(dt < timestep_skip, u + R * dt, u), for the listed pairs
//      of a stack in one launch (solvers/fluid.py: the one-pass step, a
//      list of one, and the lockstep driver's step).
//
// Replaces: opticalflow2d_tpu/pallas_kernels/fluid_fused.py,
//   fluid_euler_pallas (B9, :428; body _euler_kernel :394). U4 replaces no
//   TPU kernel: the JAX package's one-pass step updates in jnp
//   (opticalflow2d_tpu/solvers/fluid.py:99-102). As plain tensor ops that
//   update takes about ten launches, and on a partial pair list a gather of
//   u and a scatter of u' besides: about 96 B a pixel, where one pass
//   moves 24.
// Bound on this card: device-memory bandwidth. B9 reads u and vel (2 planes
//   each) and writes u' (2 planes): 24 B per pixel, for about 20 flops. U4
//   reads u and R and writes u': 24 B per pixel, 2 flops (a skipped pair
//   reads u and writes it: 16 B).
// Design: B9 is one thread per pixel, neighbouring threads on neighbouring
//   y, as diffusion_step.cu: the four neighbours of u come from global
//   memory, where the rows above and below are cache hits of the
//   neighbouring threads' loads. The gate is a device float, written by the
//   timestep on the card (solvers/fluid.py), so the pass needs no host read.
//   The TPU kernel's row blocks with halo rows and its full-lane gate tile
//   existed for Mosaic and have no counterpart here.
//   U4 is a grid of (chunks of a pair's 2 nx ny floats, listed pairs): a
//   block reads its pair's index and max |R|^2 and computes the timestep
//   itself (one root and one divide a thread, no host read), reads u at the
//   pair's place in the stack and R at its place in the list, and writes u'
//   at the pair's place, kUpdateWords words a thread in flight, 16-B words
//   where the pairs' planes and pointers allow, else floats. It allocates
//   nothing and leaves the unlisted pairs of u' as they are.
// Numerics: R through material_derivative.cuh, the expression and border
//   rule of fluid_iter.cu, with -fmad=false: R from the same stored u and
//   vel' has the bits of the R that B7 writes and B8 keeps in registers.
//   U4 rounds as the plain chain: sqrtf and the divide are IEEE (no fast
//   math), and the plain version's float64 root rounded once to float32 is
//   the correctly rounded float32 root; then the product R dt and the sum
//   with u, not contracted. max |R|^2 = 0 gives dt = inf and NaN gives
//   false: both keep u, as the plain where does.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

constexpr int kUpdateThreads = 256;
constexpr int kUpdateWords = 4;  // words a thread, loads issued before the stores
constexpr int kUpdateMaxPairs = 65535;  // a grid's y extent (partials.cuh kMaxPairs)

__device__ __forceinline__ float euler(float r, float u, float dt) { return r * dt + u; }

__device__ __forceinline__ float4 euler(float4 r, float4 u, float dt) {
  return make_float4(r.x * dt + u.x, r.y * dt + u.y, r.z * dt + u.z, r.w * dt + u.w);
}

// W is float4 or float; ``words`` the W words of one pair's [2, nx, ny].
template <typename W>
__global__ void __launch_bounds__(kUpdateThreads)
fluid_update_kernel(const W* __restrict__ u, const W* __restrict__ r,
                    const float* __restrict__ maxsq, const int* __restrict__ pairs, float dumax,
                    float skip, W* __restrict__ out, size_t words) {
  const int j = blockIdx.y;
  const size_t at = static_cast<size_t>(pairs[j]) * words;
  const W* up = u + at;
  const W* rp = r + static_cast<size_t>(j) * words;
  W* op = out + at;
  const float dt = dumax / sqrtf(maxsq[j]);
  const size_t first = static_cast<size_t>(blockIdx.x) * (kUpdateThreads * kUpdateWords) +
                       threadIdx.x;
  W uw[kUpdateWords];
  if (dt < skip) {
    W rw[kUpdateWords];
#pragma unroll
    for (int k = 0; k < kUpdateWords; ++k) {
      const size_t i = first + k * kUpdateThreads;
      if (i < words) {
        uw[k] = up[i];
        rw[k] = rp[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUpdateWords; ++k) {
      const size_t i = first + k * kUpdateThreads;
      if (i < words) op[i] = euler(rw[k], uw[k], dt);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kUpdateWords; ++k) {
      const size_t i = first + k * kUpdateThreads;
      if (i < words) uw[k] = up[i];
    }
#pragma unroll
    for (int k = 0; k < kUpdateWords; ++k) {
      const size_t i = first + k * kUpdateThreads;
      if (i < words) op[i] = uw[k];
    }
  }
}

template <typename W>
int launch_fluid_update(const float* u, const float* r, const float* maxsq, const int* pairs,
                        int n_pairs, size_t floats, float dumax, float skip, float* out,
                        cudaStream_t stream) {
  const size_t words = floats * sizeof(float) / sizeof(W);
  const size_t per_block = static_cast<size_t>(kUpdateThreads) * kUpdateWords;
  const dim3 grid(static_cast<unsigned>((words + per_block - 1) / per_block), n_pairs);
  fluid_update_kernel<W><<<grid, kUpdateThreads, 0, stream>>>(
      reinterpret_cast<const W*>(u), reinterpret_cast<const W*>(r), maxsq, pairs, dumax, skip,
      reinterpret_cast<W*>(out), words);
  return static_cast<int>(cudaGetLastError());
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

// U4: u [B, 2, nx, ny], r [n_pairs, 2, nx, ny] and maxsq [n_pairs] in list
// order, pairs (device int32, each in [0, B), no repeats) -> out [B, 2, nx,
// ny] at each listed pair's place, where(dt < skip, u + r dt, u) with dt =
// dumax / sqrt(maxsq) (the other pairs are not written); nx, ny >= 1.
extern "C" int of2d_fluid_update(const float* u, const float* r, const float* maxsq,
                                 const int* pairs, int n_pairs, int nx, int ny, float dumax,
                                 float skip, float* out, cudaStream_t stream) {
  if (n_pairs < 1 || n_pairs > kUpdateMaxPairs || nx < 1 || ny < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = 2 * static_cast<size_t>(nx) * ny;
  const bool wide = floats % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(r) |
                     reinterpret_cast<uintptr_t>(out)) % sizeof(float4) == 0;
  return wide ? launch_fluid_update<float4>(u, r, maxsq, pairs, n_pairs, floats, dumax, skip,
                                            out, stream)
              : launch_fluid_update<float>(u, r, maxsq, pairs, n_pairs, floats, dumax, skip,
                                           out, stream);
}
