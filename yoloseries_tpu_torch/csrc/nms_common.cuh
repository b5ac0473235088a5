// Shared pieces of the NMS kernels: the IoU of two xyxy boxes and the
// (score, index) priority order.
//
// The arithmetic is the plain PyTorch twins' step for step:
//   iw = max(min(ax2, bx2) - max(ax1, bx1), 0), ih likewise, inter = iw * ih,
//   iou = inter / max(area_a + area_b - inter, 1e-9)
// Built with -fmad=false and IEEE division, so no product is contracted into
// an fma and the IoU at the threshold is bit-identical to the twin's.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace yst {

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device in this process: the attribute call costs host
// time on every launch otherwise. `done` is the kernel's own bit set of
// devices (beyond 32 devices the call is simply made every time).
inline cudaError_t allow_dynamic_smem(const void* kernel, int bytes,
                                      std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return (x2 - x1) * (y2 - y1);
}

__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2, float ay2,
                                         float a_area, float bx1, float by1,
                                         float bx2, float by2, float b_area) {
  const float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
  const float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
  const float inter = iw * ih;
  return inter / fmaxf(a_area + b_area - inter, 1e-9f);
}

// j is taken before i: higher score first, ties to the lower index.
__device__ __forceinline__ bool before(float sj, int j, float si, int i) {
  return sj > si || (sj == si && j < i);
}

}  // namespace yst
