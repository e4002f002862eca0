// A level's image derivatives in one pass on Hopper (sm_90a): of2d_derive,
// the force input of the variational and fluid level drivers
// (engine/registration.py), built once a refinement and again at each fluid
// regrid; of2d_derive_batch, the same for the listed pairs of a stack in one
// launch (the grid's z axis; the lockstep fluid driver's refinements and
// regrids).
//
// Replaces: no TPU kernel. The JAX package forms the derivatives in jnp
//   (opticalflow2d_tpu/solvers/base.py); the port's plain version
//   (kernels/derive.py::derive_ref) ran it as some twenty device operations
//   on full-size temporaries (the sliced differences, their halving, the
//   concatenations of the borders, the stack of the gradient and the pack
//   of gradient and temporal difference): about 27 B a point read and
//   written, 9-10 ms at 16384^2.
// Bound on this card: device-memory bandwidth, 20 B a point (the warped
//   image and the reference read once, three planes written): 1.6 ms at
//   16384^2 over 3.35 TB/s.
// Design: one thread takes kVec consecutive points of kRows consecutive
//   rows (16-B loads and stores where ny % 4 == 0) and rolls the warped
//   image's rows above, at and below through registers, so each row of it is
//   read once by the thread; the two columns beside a thread's points come
//   through L1. No shared memory, no sync; 64-bit offsets (16384^2 planes).
// Numerics: d/dx and d/dy of the warped image by central differences,
//   (f[+1] - f[-1]) * 0.5, one-sided at the borders, f[1] - f[0] and
//   f[n-1] - f[n-2] (src/gradients.h:9-32), and It = warped - iref, each in
//   the plain version's order; with -fmad=false the result equals the plain
//   version's bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsY = 32;  // along y, the contiguous axis
constexpr int kThreadsX = 4;
constexpr int kRows = 8;       // consecutive rows a thread

template <int kVec>
__device__ __forceinline__ void load_points(const float* __restrict__ p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = p[0];
  }
}

template <int kVec>
__device__ __forceinline__ void store_points(float* __restrict__ p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// iref, warped [nx, ny] -> g [3, nx, ny]: (d/dx warped, d/dy warped,
// warped - iref). kVec is 4 only where ny % 4 == 0, so a thread's points all
// lie inside the row. nx >= 2 and ny >= 2. kBatch: blockIdx.z is a position
// in the list ``pairs``; iref and g are those of pair pairs[z] of their
// stacks, warped the z-th of its (in list order); 64-bit offsets.
template <int kVec, bool kBatch>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
derive_kernel(const float* __restrict__ iref, const float* __restrict__ warped,
              float* __restrict__ g, int nx, int ny, const int* __restrict__ pairs) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int i0 = (blockIdx.y * blockDim.y + threadIdx.y) * kRows;
  if (j0 >= ny || i0 >= nx) return;
  const size_t n = static_cast<size_t>(nx) * ny;
  if (kBatch) {
    const size_t pair = static_cast<size_t>(pairs[blockIdx.z]);
    iref += pair * n;
    warped += static_cast<size_t>(blockIdx.z) * n;
    g += pair * 3 * n;
  }
  float above[kVec], at[kVec], below[kVec];
  load_points(warped + static_cast<size_t>(i0) * ny + j0, at);
  if (i0 > 0) load_points(warped + static_cast<size_t>(i0 - 1) * ny + j0, above);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= nx) return;
    const size_t p = static_cast<size_t>(i) * ny + j0;
    if (i + 1 < nx) load_points(warped + p + ny, below);
    float ref[kVec], gx[kVec], gy[kVec], it[kVec];
    load_points(iref + p, ref);
    const float left = j0 > 0 ? warped[p - 1] : 0.f;
    const float right = j0 + kVec < ny ? warped[p + kVec] : 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (i == 0)
        gx[k] = below[k] - at[k];
      else if (i == nx - 1)
        gx[k] = at[k] - above[k];
      else
        gx[k] = (below[k] - above[k]) * 0.5f;
      const int j = j0 + k;
      const float next = k == kVec - 1 ? right : at[k + 1 < kVec ? k + 1 : k];
      const float prev = k == 0 ? left : at[k > 0 ? k - 1 : k];
      if (j == 0)
        gy[k] = next - at[k];
      else if (j == ny - 1)
        gy[k] = at[k] - prev;
      else
        gy[k] = (next - prev) * 0.5f;
      it[k] = at[k] - ref[k];
    }
    store_points(g + p, gx);
    store_points(g + n + p, gy);
    store_points(g + 2 * n + p, it);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      above[k] = at[k];
      at[k] = below[k];
    }
  }
}

template <int kVec, bool kBatch>
int launch(const float* iref, const float* warped, float* g, int nx, int ny,
           const int* pairs, int n_pairs, cudaStream_t stream) {
  const int columns = kThreadsY * kVec;
  const int rows = kThreadsX * kRows;
  const dim3 block(kThreadsY, kThreadsX);
  const dim3 grid((ny + columns - 1) / columns, (nx + rows - 1) / rows, n_pairs);
  if (grid.y > 65535 || n_pairs < 1 || n_pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  derive_kernel<kVec, kBatch><<<grid, block, 0, stream>>>(iref, warped, g, nx, ny, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// iref, warped [nx, ny] -> g [3, nx, ny]: the gradient of the warped image
// (planes 0 and 1) and its difference from the reference (plane 2). nx >= 2
// and ny >= 2; the three arrays do not overlap.
extern "C" int of2d_derive(const float* iref, const float* warped, float* g, int nx, int ny,
                           cudaStream_t stream) {
  if (nx < 2 || ny < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (ny % 4 == 0) return launch<4, false>(iref, warped, g, nx, ny, nullptr, 1, stream);
  return launch<1, false>(iref, warped, g, nx, ny, nullptr, 1, stream);
}

// irefs [B, nx, ny], warped [n_pairs, nx, ny] (list order) -> g [B, 3, nx,
// ny] of the n_pairs pairs listed in pairs (device int32, each in [0, B),
// no repeats; the other pairs of g are not written): each pair's g equals
// its own of2d_derive's of (irefs[p], warped[z]).
extern "C" int of2d_derive_batch(const float* irefs, const float* warped, float* g,
                                 const int* pairs, int n_pairs, int nx, int ny,
                                 cudaStream_t stream) {
  if (nx < 2 || ny < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (ny % 4 == 0) return launch<4, true>(irefs, warped, g, nx, ny, pairs, n_pairs, stream);
  return launch<1, true>(irefs, warped, g, nx, ny, pairs, n_pairs, stream);
}
