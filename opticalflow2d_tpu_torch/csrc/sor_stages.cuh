// The SOR candidate of the Navier-Lame system and its scalars, shared by the
// red-black half-sweep of elastic_stages.cuh, which runs the elastic block
// (elastic_block.cu: B6, k elastic iterations) and the fluid sweep
// (fluid_stages.cuh: B7, B8 and K3, one sweep on the velocity), as
// sor_candidate_tile (opticalflow2d_tpu/pallas_kernels/elastic_block.py:32)
// serves both TPU kernels.
//
// A half-sweep cannot update in place: the cross term of component c reads
// the other component at the four diagonal neighbours, which have the
// cell's own colour. So every candidate is computed from the half's input
// and written to another buffer, as solvers/elastic.py computes all
// candidates and then masks.
//
// Numerics: the plain version's expressions in its order, with the scalars
// rounded to float32 once on the host (solvers/elastic.py::sor_scalars);
// the library is built with -fmad=false, so the tile rounds like the plain
// version on the card.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"

namespace {

struct SorScalars {
  float mu, mpl, omw, inv_diag;  // mu, mu + lambda, 1 - omega, omega / (-6 mu - 2 lambda)
};

// The SOR candidate of component c at cell l of buffer x (row stride e,
// plane stride ee) for right-hand side b_c (solvers/elastic.py::
// _gs_candidate). kRefStencil: the y-component's second-derivative term
// takes x-direction neighbours, as the reference does.
template <bool kRefStencil>
__device__ __forceinline__ float sor_candidate(const float* x, int ee, int e, int l, int c,
                                               float b_c, const SorScalars& s) {
  const float* xc = x + c * ee;
  const float* xo = x + (1 - c) * ee;
  const float xp = xc[l + e], xm = xc[l - e], yp = xc[l + 1], ym = xc[l - 1];
  const float lap4 = ((xp + xm) + yp) + ym;
  const float cross = 0.25f * (((xo[l + e + 1] - xo[l - e + 1]) - xo[l + e - 1]) + xo[l - e - 1]);
  const float second = (c == 0 || kRefStencil) ? xp + xm : yp + ym;
  const float num = (b_c - s.mu * lap4) - s.mpl * (second + cross);
  return s.omw * xc[l] + s.inv_diag * num;
}

}  // namespace
