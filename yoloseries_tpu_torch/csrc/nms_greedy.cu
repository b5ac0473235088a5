// Streaming greedy NMS, one block per image.
//
// Replaces yoloseries_tpu/kernels/nms_pallas.py::pallas_greedy_nms (Pallas
// body _nms_kernel). Plain twin: yoloseries_tpu_torch/kernels/nms_greedy.py
// ::greedy_nms.
//
// Per image and per output slot: block-wide argmax of the live scores (ties
// to the lower index), broadcast of the keeper's box, suppression of every
// candidate with IoU >= thr, explicit zeroing of the keeper (a zero-area box
// has self-IoU 0), and the slot written. The loop stops at the first slot
// whose best live score is <= 0; the slots after it stay -1 / false.
//
// What bounds it on Hopper: the chain of dependent iterations (one per
// keeper), each a block-wide reduction with two __syncthreads, not bytes or
// FLOPs: the inputs are read from device memory once. The design keeps the
// four coordinate planes and the live scores of an image in shared memory
// (5 x K x 4 B, 160 KB at K = 8192), so every iteration touches shared
// memory only; one image per block lets the images of a batch run on all
// SMs at once.

#include <math.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxK = 8192;  // kernels/nms_greedy.py::GREEDY_MAX_K

__device__ __forceinline__ void argmax_step(float& bv, int& bi, float ov, int oi) {
  if (yst::before(ov, oi, bv, bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    argmax_step(bv, bi, ov, oi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                  int K, float thr, int max_keep, int* __restrict__ keep_idx,
                  bool* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* live = y2 + K;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_best;
  __shared__ float s_box[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* bb = boxes + (size_t)b * K * 4;
  const float* sc = scores + (size_t)b * K;
  int* out_idx = keep_idx + (size_t)b * max_keep;
  bool* out_valid = keep_valid + (size_t)b * max_keep;

  for (int i = tid; i < K; i += blockDim.x) {
    x1[i] = bb[4 * i + 0];
    y1[i] = bb[4 * i + 1];
    x2[i] = bb[4 * i + 2];
    y2[i] = bb[4 * i + 3];
    live[i] = sc[i];
  }
  for (int s = tid; s < max_keep; s += blockDim.x) {
    out_idx[s] = -1;
    out_valid[s] = false;
  }
  __syncthreads();

  for (int slot = 0; slot < max_keep; ++slot) {
    // each thread visits its candidates in increasing index, so a strict >
    // keeps the lowest index among equal scores
    float bv = -INFINITY;
    int bi = K;
    for (int i = tid; i < K; i += blockDim.x) {
      const float v = live[i];
      if (v > bv) {
        bv = v;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < n_warps ? red_v[lane] : -INFINITY;
      bi = lane < n_warps ? red_i[lane] : K;
      warp_argmax(bv, bi);
      if (lane == 0) {
        const bool valid = bv > 0.0f;
        s_best = valid ? bi : -1;
        if (valid) {
          out_idx[slot] = bi;
          out_valid[slot] = true;
          s_box[0] = x1[bi];
          s_box[1] = y1[bi];
          s_box[2] = x2[bi];
          s_box[3] = y2[bi];
        }
      }
    }
    __syncthreads();
    const int best = s_best;
    if (best < 0) break;  // uniform: every thread read the same s_best
    const float bx1 = s_box[0], by1 = s_box[1], bx2 = s_box[2], by2 = s_box[3];
    const float barea = yst::box_area(bx1, by1, bx2, by2);
    // each thread updates only its own candidates, and the next argmax reads
    // only those, so no barrier is needed before it
    for (int i = tid; i < K; i += blockDim.x) {
      const float iou = yst::box_iou(bx1, by1, bx2, by2, barea, x1[i], y1[i], x2[i],
                                     y2[i], yst::box_area(x1[i], y1[i], x2[i], y2[i]));
      if (iou >= thr || i == best) live[i] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int yst_nms_greedy(const float* boxes, const float* scores, int B, int K,
                              float thr, int max_keep, int* keep_idx, bool* keep_valid,
                              cudaStream_t stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const int threads = K >= kMaxThreads ? kMaxThreads : ((K + 31) / 32) * 32;
  const size_t smem = (size_t)5 * K * sizeof(float);
  static std::atomic<unsigned> smem_set{0u};
  const cudaError_t err = yst::allow_dynamic_smem(
      (const void*)greedy_nms_kernel, 5 * kMaxK * (int)sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<B, threads, smem, stream>>>(boxes, scores, K, thr, max_keep,
                                                  keep_idx, keep_valid);
  return (int)cudaGetLastError();
}
