// The suppression relation of the matrix NMS kernels, spread over the whole
// card. Defined in nms_relation.cu; nms_matrix.cu enqueues it before its
// fixpoint kernel.
#pragma once

#include <cuda_runtime.h>

namespace yst {

// Word w of victim i of image b, at rel[(b * Wt + w) * K + i]:
//   w < W = ceil(K / 32): bit l set iff suppressor j = 32 w + l, both j and
//     i live (score > 0), j before i and IoU(j, i) >= thr;
//   W <= w < Wt (only with count != nullptr): bit l set iff carried keeper
//     32 (w - W) + l of image b (carry_box, count[b] of them) has
//     IoU >= thr with the live victim i. Words past the carry are not
//     written.
// boxes (B, stride, 4) and scores (B, stride); the K candidates are the
// first K of each row. With count != nullptr (a later strip of sorted
// candidates) an image is skipped whole, its words not written, when
// count[b] has reached max_keep or its first candidate is dead.
cudaError_t launch_relation(const float* boxes, const float* scores, int B, int stride,
                            int K, float thr, int Wt, const int* count, int max_keep,
                            const float* carry_box, unsigned* rel, cudaStream_t stream);

}  // namespace yst
