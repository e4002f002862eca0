// What the kernel probes' generated sources share: a kernel's registers,
// local (spilled) bytes and resident blocks an SM.
#pragma once
#include <cuda_runtime.h>

namespace {

template <typename Kernel>
int attrs(Kernel kernel, int threads, int smem, int* out3) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out3[0] = a.numRegs;
  out3[1] = static_cast<int>(a.localSizeBytes);
  out3[2] = per_sm;
  return 0;
}

}  // namespace
