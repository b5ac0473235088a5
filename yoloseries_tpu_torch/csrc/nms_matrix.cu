// Exact greedy NMS as a fixpoint over a suppression bitmask, one block per
// image, K <= 1024.
//
// Replaces yoloseries_tpu/kernels/nms_matrix.py::pallas_matrix_nms (Pallas
// body _matrix_nms_kernel). Plain twin: yoloseries_tpu_torch/kernels/
// nms_matrix.py::matrix_nms_plain.
//
// sup(j, i) = IoU(j, i) >= thr and j before i (higher score, ties to the
// lower index), so the input need not be sorted. Rounds, to the fixpoint:
//   confirm: undecided i with no undecided suppressor  -> kept
//   kill:    undecided i with a kept suppressor         -> decided, dropped
// which is the sequential greedy result. A keeper's output slot is the count
// of keepers before it; slots at or past max_keep are dropped.
//
// What bounds it on Hopper: building the K x K relation (K^2 IoUs, about
// 1M at K = 1024) and then a few dependent rounds, each two barriers, not
// device-memory bytes (inputs are read once). The design keeps the
// relation as a bitmask in shared memory, K x K / 8 = 128 KB at K = 1024,
// stored word-major (word w of victim i at sup[w * K + i]) so that thread i
// tests "blocked" and "killed" as ANDs of ceil(K/32) words against the
// undecided / kept bit vectors, conflict-free. Thread i of warp w is bit
// i % 32 of word w, so a __ballot_sync writes a whole word of either vector.

#include "nms_common.cuh"

namespace {

constexpr int kMaxK = 1024;

__global__ void __launch_bounds__(kMaxK)
matrix_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                  int K, float thr, int max_keep, int* __restrict__ keep_idx,
                  bool* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  const int W = (K + 31) / 32;
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* sc = y2 + K;
  float* area = sc + K;
  unsigned* sup = reinterpret_cast<unsigned*>(area + K);  // [W][K]
  unsigned* s_und = sup + (size_t)W * K;                  // [W]
  unsigned* s_kept = s_und + W;                           // [W]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bb = boxes + (size_t)b * K * 4;
  int* out_idx = keep_idx + (size_t)b * max_keep;
  bool* out_valid = keep_valid + (size_t)b * max_keep;

  for (int i = tid; i < K; i += blockDim.x) {
    x1[i] = bb[4 * i + 0];
    y1[i] = bb[4 * i + 1];
    x2[i] = bb[4 * i + 2];
    y2[i] = bb[4 * i + 3];
    sc[i] = scores[(size_t)b * K + i];
    area[i] = yst::box_area(x1[i], y1[i], x2[i], y2[i]);
  }
  for (int s = tid; s < max_keep; s += blockDim.x) {
    out_idx[s] = -1;
    out_valid[s] = false;
  }
  if (tid < W) s_kept[tid] = 0u;
  __syncthreads();

  // the relation: consecutive threads take consecutive victims i of one
  // word w, so the suppressor reads broadcast and the stores are coalesced
  for (int e = tid; e < W * K; e += blockDim.x) {
    const int w = e / K;
    const int i = e - w * K;
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i];
    const float ia = area[i], is = sc[i];
    unsigned bits = 0u;
    const int j_end = min(32, K - 32 * w);
    for (int l = 0; l < j_end; ++l) {
      const int j = 32 * w + l;
      const float iou = yst::box_iou(x1[j], y1[j], x2[j], y2[j], area[j], ix1, iy1,
                                     ix2, iy2, ia);
      if (iou >= thr && yst::before(sc[j], j, is, i)) bits |= 1u << l;
    }
    sup[e] = bits;
  }

  // one thread per candidate: blockDim >= K, rounded up to whole warps
  const int i = tid;
  bool und = i < K && sc[i] > 0.0f;
  bool kept = false;
  const unsigned und_word = __ballot_sync(0xffffffffu, und);
  if (lane == 0 && warp < W) s_und[warp] = und_word;
  bool any = __syncthreads_or(und);  // also publishes sup and s_und
  while (any) {
    bool blocked = false;
    if (und) {
      for (int w = 0; w < W && !blocked; ++w) blocked = (sup[w * K + i] & s_und[w]) != 0u;
    }
    const bool kept2 = kept || (und && !blocked);
    const unsigned kept_word = __ballot_sync(0xffffffffu, kept2);
    if (lane == 0 && warp < W) s_kept[warp] = kept_word;
    __syncthreads();
    bool killed = false;
    if (und && blocked) {
      for (int w = 0; w < W && !killed; ++w) killed = (sup[w * K + i] & s_kept[w]) != 0u;
    }
    kept = kept2;
    und = und && blocked && !killed;
    const unsigned next_und = __ballot_sync(0xffffffffu, und);
    // every read of s_und in this round came before the barrier above
    if (lane == 0 && warp < W) s_und[warp] = next_und;
    any = __syncthreads_or(und);
  }

  if (kept) {
    const float si = sc[i];
    int rank = 0;
    for (int w = 0; w < W; ++w) {
      unsigned bits = s_kept[w];
      while (bits) {
        const int j = 32 * w + __ffs(bits) - 1;
        bits &= bits - 1u;
        rank += yst::before(sc[j], j, si, i) ? 1 : 0;
      }
    }
    if (rank < max_keep) {
      out_idx[rank] = i;
      out_valid[rank] = true;
    }
  }
}

}  // namespace

extern "C" int yst_nms_matrix(const float* boxes, const float* scores, int B, int K,
                              float thr, int max_keep, int* keep_idx, bool* keep_valid,
                              cudaStream_t stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const int W = (K + 31) / 32;
  const int threads = W * 32;
  const size_t smem = (size_t)6 * K * sizeof(float) + ((size_t)W * K + 2 * W) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      matrix_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  matrix_nms_kernel<<<B, threads, smem, stream>>>(boxes, scores, K, thr, max_keep,
                                                  keep_idx, keep_valid);
  return (int)cudaGetLastError();
}
