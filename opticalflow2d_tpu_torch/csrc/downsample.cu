// Box downsample in one pass on Hopper (sm_90a): of2d_downsample, the
// pyramid's images and the motion seeds (ops/resample.py::downsample_image,
// downsample_motion; engine/registration.py), each level taken straight from
// the full-resolution image or field.
//
// Replaces: no TPU kernel. The JAX package downsamples in jnp
//   (opticalflow2d_tpu/ops/resample.py:42-66); the port's plain version
//   (kernels/downsample.py::downsample_image_ref) adds each patch as one
//   strided tensor op a term: up to 4096, fx fy launches a call (fx fy - 1
//   adds and a divide: 256 for a 16 x 16 patch), and past it about 2 fx fy
//   products and sums of output-sized temporaries, each strided read
//   pulling whole 32-B sectors for one float; a motion's component scale
//   was one more operation, on a ratio tensor copied from the host.
// Bound on this card: device-memory bandwidth. The input is read once (4 B
//   a point) and the output written once (4 / (fx fy) B a point): 0.33 ms
//   for a 16384^2 image over 3.35 TB/s, 0.020 ms at 4096^2.
// Design: one 256-thread block a tile of the output, whose input rows (about
//   kTileRows x kTileCols floats, 32 KiB) are staged in shared memory with
//   cp.async, neighbouring lanes on neighbouring 16-B words (4-B words where
//   ny_in % 4 != 0). Each patch is then summed from shared memory in the
//   plain version's order:
//   - kMean: one running sum over the patch, x offset outer and y offset
//     inner; kMeanPairs (a 2 x 2 patch on a power-of-two width): each row's
//     pair first, then the rows. Then the product with 1/(fx fy). A thread
//     an output.
//   - kProducts (an extent past 4096): each term times 1/fx into n_a partial
//     sums by x offset, added pairwise; that column times 1/fy. A thread a
//     (output row, input column), lanes on neighbouring columns, so shared
//     memory is read without bank conflicts; the columns go to a second
//     buffer, where a thread an output adds them into n_b partial sums the
//     same way.
//   A motion's component scale is the last product (1 for an image: exact).
//   A patch too large for a tile in 48 KiB (more than 32 rows or 256 columns
//   and a coarse level far below its image) is summed by a thread an output
//   straight from device memory, with the same operations.
// Numerics: every output performs the plain version's float operations in
//   its order, with -fmad=false. The divide by fx fy is the product with its
//   float32 reciprocal, as PyTorch divides a CUDA tensor by a host scalar;
//   the wrapper rounds 1/fx, 1/fy, 1/(fx fy) and the scales on the host. The
//   result equals the plain version's on CUDA bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;                  // input rows a tile aims at
constexpr int kTileCols = 256;                 // input columns a tile aims at
constexpr long long kMaxSmemFloats = 12288;    // 48 KiB: no opt-in needed

enum Form { kMean = 0, kMeanPairs = 1, kProducts = 2 };

struct Shape {
  int nx_in, ny_in, nx_out, ny_out;
  int fx, fy;     // the patch
  int form;       // Form
  int n_a, n_b;   // kProducts: partial sums over x, then over y offsets
  float sx, sy;   // kProducts: 1/fx, 1/fy
  float inv;      // kMean, kMeanPairs: 1/(fx fy)
  float s0, s1;   // the scale of plane 0 and of the others
};

// A tile: tr x tc outputs, from tr fx x tc fy inputs (row pitch tci).
struct Tile {
  int tr, tc, tri, tci;
  int tiles_y;  // tiles across the output's columns
};

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// f(r, c) for each cell of a rows x cols grid that this thread takes, the
// block's threads in row-major order over it, with no division a cell.
template <class F>
__device__ __forceinline__ void for_grid(int rows, int cols, const F& f) {
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// term(0) + ... + term(n - 1) in n_acc partial sums (term k into sum
// k % n_acc, each a running sum), then added pairwise
// (ops/resample.py::_interleaved); n_acc <= 4.
template <class Term>
__device__ __forceinline__ float interleaved(const Term& term, int n, int n_acc) {
  const int m = min(n_acc, n);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r < m) {
      float sum = term(r);
#pragma unroll 4
      for (int k = r + n_acc; k < n; k += n_acc) sum = sum + term(k);
      acc[r] = sum;
    }
  }
  if (m == 1) return acc[0];
  if (m == 2) return acc[0] + acc[1];
  if (m == 3) return (acc[0] + acc[1]) + acc[2];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// kMean, kMeanPairs: at(a, b) is the patch's value at x offset a, y offset
// b (ops/resample.py::box_mean).
template <class At>
__device__ __forceinline__ float patch_mean(const At& at, const Shape& s) {
  float sum;
  if (s.form == kMeanPairs) {
    sum = at(0, 0) + at(0, 1);
    sum = sum + (at(1, 0) + at(1, 1));
  } else {
    sum = at(0, 0);
#pragma unroll 4
    for (int b = 1; b < s.fy; ++b) sum = sum + at(0, b);
    for (int a = 1; a < s.fx; ++a) {
#pragma unroll 4
      for (int b = 0; b < s.fy; ++b) sum = sum + at(a, b);
    }
  }
  return sum * s.inv;
}

// kProducts: one column of a patch, down(a) its value at x offset a, times
// 1/fy: a term of the sum over y offsets.
template <class Down>
__device__ __forceinline__ float patch_column(const Down& down, const Shape& s) {
  return interleaved([&](int a) { return down(a) * s.sx; }, s.fx, s.n_a) * s.sy;
}

// kProducts: the patch from its columns, col(b) as patch_column gives it.
template <class Col>
__device__ __forceinline__ float patch_products(const Col& col, const Shape& s) {
  return interleaved(col, s.fy, s.n_b);
}

// src [planes, nx_in, ny_in] -> out [planes, nx_out, ny_out], a block a
// tile of one plane (blockIdx.y).
__global__ void __launch_bounds__(kThreads)
downsample_tile_kernel(const float* __restrict__ src, float* __restrict__ out, Shape s, Tile t,
                       bool vec) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* cols = tile + t.tri * t.tci;  // kProducts: tr x tci columns
  const int plane = blockIdx.y;
  const int i0 = (blockIdx.x / t.tiles_y) * t.tr;
  const int j0 = (blockIdx.x % t.tiles_y) * t.tc;
  const int rows = min(t.tr, s.nx_out - i0), ocols = min(t.tc, s.ny_out - j0);
  const int irows = rows * s.fx, icols = ocols * s.fy;
  const float* in = src + static_cast<size_t>(plane) * s.nx_in * s.ny_in +
                    static_cast<size_t>(i0) * s.fx * s.ny_in + static_cast<size_t>(j0) * s.fy;
  if (vec) {  // ny_in and tci multiples of 4: whole 16-B words inside the row
    for_grid(irows, (icols + 3) / 4, [&](int r, int c) {
      cp_async_16(tile + r * t.tci + 4 * c, in + static_cast<size_t>(r) * s.ny_in + 4 * c);
    });
  } else {
    for_grid(irows, icols, [&](int r, int c) {
      cp_async_4(tile + r * t.tci + c, in + static_cast<size_t>(r) * s.ny_in + c);
    });
  }
  cp_async_wait_all();
  __syncthreads();

  const float scale = plane == 0 ? s.s0 : s.s1;
  float* o = out + static_cast<size_t>(plane) * s.nx_out * s.ny_out +
             static_cast<size_t>(i0) * s.ny_out + j0;
  if (s.form == kProducts) {
    for_grid(rows, icols, [&](int li, int c) {
      const float* p = tile + li * s.fx * t.tci + c;
      cols[li * t.tci + c] = patch_column([&](int a) { return p[a * t.tci]; }, s);
    });
    __syncthreads();
    for_grid(rows, ocols, [&](int li, int lj) {
      const float* p = cols + li * t.tci + lj * s.fy;
      o[static_cast<size_t>(li) * s.ny_out + lj] =
          patch_products([&](int b) { return p[b]; }, s) * scale;
    });
  } else {
    for_grid(rows, ocols, [&](int li, int lj) {
      const float* p = tile + li * s.fx * t.tci + lj * s.fy;
      o[static_cast<size_t>(li) * s.ny_out + lj] =
          patch_mean([&](int a, int b) { return p[a * t.tci + b]; }, s) * scale;
    });
  }
}

// The same sums, a thread an output, read from device memory: patches too
// large for a tile.
__global__ void __launch_bounds__(kThreads)
downsample_direct_kernel(const float* __restrict__ src, float* __restrict__ out, Shape s) {
  const size_t n_out = static_cast<size_t>(s.nx_out) * s.ny_out;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const int plane = blockIdx.y;
  const int i = static_cast<int>(idx / s.ny_out), j = static_cast<int>(idx % s.ny_out);
  const float* p = src + static_cast<size_t>(plane) * s.nx_in * s.ny_in +
                   static_cast<size_t>(i) * s.fx * s.ny_in + static_cast<size_t>(j) * s.fy;
  auto at = [&](int a, int b) { return __ldg(p + static_cast<size_t>(a) * s.ny_in + b); };
  const float v =
      s.form == kProducts
          ? patch_products(
                [&](int b) { return patch_column([&](int a) { return at(a, b); }, s); }, s)
          : patch_mean(at, s);
  out[static_cast<size_t>(plane) * n_out + idx] = v * (plane == 0 ? s.s0 : s.s1);
}

}  // namespace

// src [planes, nx_in, ny_in] -> out [planes, nx_out, ny_out]: each output
// the mean of its fx x fy patch at (i fx, j fy), fx = nx_in / nx_out and
// fy = ny_in / ny_out (the rest of the rows and columns cropped), added in
// the order ``form`` names with n_a and n_b partial sums (kProducts), then
// scaled by s0 on plane 0 and s1 on the others. The wrapper
// (kernels/downsample.py) derives form, n_a and n_b from the shape as the
// plain version does and rounds sx = 1/fx, sy = 1/fy, inv = 1/(fx fy), s0
// and s1 to float32 on the host.
extern "C" int of2d_downsample(const float* src, float* out, int planes, int nx_in, int ny_in,
                               int nx_out, int ny_out, int fx, int fy, int form, int n_a,
                               int n_b, float sx, float sy, float inv, float s0, float s1,
                               cudaStream_t stream) {
  if (planes < 1 || planes > 65535 || nx_out < 1 || ny_out < 1 || nx_out > nx_in ||
      ny_out > ny_in || fx != nx_in / nx_out || fy != ny_in / ny_out || form < kMean ||
      form > kProducts || (form == kMeanPairs && (fx != 2 || fy != 2)) || n_a < 1 ||
      n_a > 4 || n_b < 1 || n_b > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{nx_in, ny_in, nx_out, ny_out, fx, fy, form, n_a, n_b, sx, sy, inv, s0, s1};
  Tile t;
  t.tr = fx < kTileRows ? kTileRows / fx : 1;
  t.tc = fy < kTileCols ? kTileCols / fy : 1;
  const long long tri = static_cast<long long>(t.tr) * fx, tci = static_cast<long long>(t.tc) * fy;
  const long long smem = tri * tci + (form == kProducts ? t.tr * tci : 0);
  if (smem <= kMaxSmemFloats) {
    t.tri = static_cast<int>(tri);
    t.tci = static_cast<int>(tci);
    t.tiles_y = (ny_out + t.tc - 1) / t.tc;
    const long long tiles = static_cast<long long>((nx_out + t.tr - 1) / t.tr) * t.tiles_y;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = ny_in % 4 == 0 && t.tci % 4 == 0;
    downsample_tile_kernel<<<dim3(static_cast<unsigned>(tiles), planes), kThreads,
                             static_cast<size_t>(smem) * sizeof(float), stream>>>(src, out, s,
                                                                                  t, vec);
  } else {
    const long long blocks = (static_cast<long long>(nx_out) * ny_out + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    downsample_direct_kernel<<<dim3(static_cast<unsigned>(blocks), planes), kThreads, 0,
                               stream>>>(src, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
