// The rows a launch owns, shared by the dense kernels and their strip modes
// (B1 and K1 diffusion_block.cu, B6 and K2 elastic_block.cu, B7/B8 and K3
// fluid_iter.cu, B3 and K4 warp_gather.cu).
//
// A launch writes local rows [0, nxl) of an [nxl, ny] plane. Its inputs
// carry ``pad`` more rows above and below those: a strip of the image
// pre-padded with its neighbours' halo rows (zeros beyond the image), as
// parallel/spatial.py::_halo_pad builds it. Local row 0 is global row
// ``row0`` of an image of ``nx`` rows; the border masks, the red-black
// colours and the one-sided derivatives use the global index. A whole
// image is {nx, 0, 0, nx}: then every expression below is the dense
// kernel's own, so a strip's interior rounds exactly like those rows of
// the dense kernel.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

struct Rows {
  int nxl, pad, row0, nx;

  // Offset of local row lr (in [-pad, nxl + pad)) in an input plane.
  __host__ __device__ size_t in_row(int lr, int ny) const {
    return static_cast<size_t>(lr + pad) * ny;
  }
  __host__ __device__ size_t in_plane(int ny) const {
    return static_cast<size_t>(nxl + 2 * pad) * ny;
  }
  __host__ __device__ size_t out_plane(int ny) const { return static_cast<size_t>(nxl) * ny; }
  // True where local row lr holds data: inside the input and the image.
  __device__ bool loadable(int lr) const {
    const int gi = row0 + lr;
    return lr >= -pad && lr < nxl + pad && gi >= 0 && gi < nx;
  }
};

__host__ __device__ inline Rows whole_image(int nx) { return Rows{nx, 0, 0, nx}; }

// A strip's geometry is usable: rows to own, the halo it needs, and rows
// inside the image.
inline bool strip_ok(const Rows& r, int halo_needed) {
  return r.nxl > 0 && r.pad >= halo_needed && r.row0 >= 0 && r.row0 + r.nxl <= r.nx;
}

}  // namespace
