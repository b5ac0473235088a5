// The suppression relation of exact greedy NMS as a bitmask, one block per
// (victim tile, suppressor word, image).
//
// Part of the replacement of yoloseries_tpu/kernels/nms_matrix.py::
// pallas_matrix_nms (B2, which builds the relation inside its one kernel)
// and pallas_matrix_nms_chunked (B3, whose carried-keeper kills are the
// extra words). Plain twin: yoloseries_tpu_torch/kernels/nms_matrix.py::
// nms_relation_plain.
//
// What bounds it on Hopper: the IoUs, ~30 instructions each with an IEEE
// division (-fmad=false, no fast math, so that the bit at the threshold is
// the twin's), issued by the SMs that hold a block. One block per image, as
// the first design built it, used B of 132 SMs; here B x W x ceil(K / 128)
// blocks (512 at B=8, K=512 and at B=2, K=1024) fill the card. Each block
// stages its 32 suppressors in shared memory, so a warp reads each of them
// as a broadcast; its 128 victims are one per thread, in registers, and the
// word stores are coalesced. The cheap test (both live, j before i) comes
// first and the IoU only where it holds: at most half the pairs, and for
// sorted input (the B3 strips) the tiles below the diagonal skip the
// division altogether.

#include "nms_common.cuh"
#include "nms_relation.cuh"

namespace {

constexpr int kTile = 128;  // victims per block, one per thread

__global__ void __launch_bounds__(kTile)
nms_relation_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                    int stride, int K, float thr, int Wt, const int* __restrict__ count,
                    int max_keep, const float* __restrict__ carry_box,
                    unsigned* __restrict__ rel) {
  __shared__ float s_x1[32], s_y1[32], s_x2[32], s_y2[32], s_area[32], s_score[32];
  const int b = blockIdx.z;
  const int w = blockIdx.y;
  const int W = (K + 31) / 32;
  const bool carry = w >= W;  // a word of carried keepers, not of suppressors
  const float* bb = boxes + (size_t)b * stride * 4;
  const float* sc = scores + (size_t)b * stride;
  int n_carry = 0;
  if (count != nullptr) {
    // the image's output is final, or this sorted strip starts dead and so
    // is dead throughout: the fixpoint returns too and reads no word
    n_carry = count[b];
    if (n_carry >= max_keep || !(sc[0] > 0.0f)) return;
  }
  const int j0 = 32 * (carry ? w - W : w);
  const int nj = min(32, (carry ? n_carry : K) - j0);
  if (nj <= 0) return;  // past the carry: the fixpoint reads no such word

  const int t = threadIdx.x;
  if (t < nj) {
    const float* src = carry ? carry_box + ((size_t)b * max_keep + j0 + t) * 4
                             : bb + (size_t)(j0 + t) * 4;
    const float x1 = src[0], y1 = src[1], x2 = src[2], y2 = src[3];
    s_x1[t] = x1;
    s_y1[t] = y1;
    s_x2[t] = x2;
    s_y2[t] = y2;
    s_area[t] = yst::box_area(x1, y1, x2, y2);
    s_score[t] = carry ? 1.0f : sc[j0 + t];
  }
  __syncthreads();

  const int i = blockIdx.x * kTile + t;
  if (i >= K) return;
  const float si = sc[i];
  unsigned bits = 0u;
  if (si > 0.0f) {
    const float ix1 = bb[4 * i + 0], iy1 = bb[4 * i + 1];
    const float ix2 = bb[4 * i + 2], iy2 = bb[4 * i + 3];
    const float ia = yst::box_area(ix1, iy1, ix2, iy2);
    for (int l = 0; l < nj; ++l) {
      // a carried keeper comes before every candidate of the strip
      if (!carry && !(s_score[l] > 0.0f && yst::before(s_score[l], j0 + l, si, i))) continue;
      const float iou = yst::box_iou(s_x1[l], s_y1[l], s_x2[l], s_y2[l], s_area[l],
                                     ix1, iy1, ix2, iy2, ia);
      if (iou >= thr) bits |= 1u << l;
    }
  }
  rel[((size_t)b * Wt + w) * K + i] = bits;
}

}  // namespace

namespace yst {

cudaError_t launch_relation(const float* boxes, const float* scores, int B, int stride,
                            int K, float thr, int Wt, const int* count, int max_keep,
                            const float* carry_box, unsigned* rel, cudaStream_t stream) {
  const int W = (K + 31) / 32;
  const int words = count != nullptr ? Wt : W;  // carry words only after the first strip
  const dim3 grid((K + kTile - 1) / kTile, words, B);
  nms_relation_kernel<<<grid, kTile, 0, stream>>>(boxes, scores, stride, K, thr, Wt, count,
                                                  max_keep, carry_box, rel);
  return cudaGetLastError();
}

}  // namespace yst

// The relation alone, (B, W, K) words: for the check against the twin.
extern "C" int yst_nms_relation(const float* boxes, const float* scores, int B, int K,
                                float thr, unsigned* rel, cudaStream_t stream) {
  const int W = (K + 31) / 32;
  return (int)yst::launch_relation(boxes, scores, B, K, K, thr, W, nullptr, 0, nullptr, rel,
                                   stream);
}
