// The fluid increment R = v - du/dx v_x - du/dy v_y at one cell, shared by
// fluid_iter.cu (B7 and B8, which compute it after the sweep) and
// fluid_euler.cu (B9, which recomputes it from the stored velocity), as
// _fluid_body and _euler_kernel compute it alike in
// opticalflow2d_tpu/pallas_kernels/fluid_fused.py. One expression in one
// order, built with -fmad=false, so every kernel's R has the same bits.

#pragma once

#include <cuda_runtime.h>

namespace {

// One-sided at the global border, central inside (ops/grid.py::partial_x).
__device__ __forceinline__ float central(float prv, float here, float nxt, int g, int n) {
  if (g == 0) return nxt - here;
  if (g == n - 1) return here - prv;
  return (nxt - prv) * 0.5f;
}

// R_c for the velocity (v0, v1), vc = v_c, and the derivatives of u_c
// (kernels/fluid_fused.py::material_derivative's order).
__device__ __forceinline__ float material_r(float vc, float v0, float v1, float dudx,
                                            float dudy) {
  return (vc - dudx * v0) - dudy * v1;
}

}  // namespace
