// Exact greedy NMS as a fixpoint over a suppression bitmask: B2 (K <= 1024)
// and the strip driver B3 (any K), both on the card.
//
// Replaces yoloseries_tpu/kernels/nms_matrix.py::pallas_matrix_nms (B2,
// Pallas body _matrix_nms_kernel) and ::pallas_matrix_nms_chunked (B3, a
// JAX driver over B2). Plain twins: yoloseries_tpu_torch/kernels/
// nms_matrix.py::matrix_nms_plain (the composition of nms_relation_plain
// and matrix_fixpoint_plain) and ::matrix_nms_chunked_plain.
//
// sup(j, i) = both live, IoU(j, i) >= thr and j before i (higher score,
// ties to the lower index), so the input need not be sorted. Rounds, to
// the fixpoint:
//   confirm: undecided i with no undecided suppressor  -> kept
//   kill:    undecided i with a kept suppressor         -> decided, dropped
// which is the sequential greedy result. A keeper's output slot is the count
// of keepers before it; slots at or past max_keep are dropped. On input
// sorted by priority (the serving top-k, every B3 strip) that count is a
// popcount of the kept bits below the keeper; otherwise each keeper
// compares itself with every other, O(keepers) serial steps per thread.
//
// Each call enqueues two kernels on the caller's stream: the relation
// (nms_relation.cu, spread over all SMs) into a device scratch of (B, Wt, K)
// words, then this fixpoint, one block per image. What bounds the fixpoint
// on Hopper: a few dependent rounds, each two barriers, after one read of
// the image's words (128 KB at K = 1024, from L2, where the relation kernel
// just wrote them). The words come into shared memory by asynchronous
// copies (cp.async) while the threads read their scores and clear the
// outputs; they are word-major (word w of victim i at sup[w * K + i]) so
// thread i tests "blocked" and "killed" as ANDs of ceil(K/32) words against
// the undecided / kept bit vectors, conflict-free. Thread i of warp w is bit
// i % 32 of word w, so a __ballot_sync writes a whole word of either vector.
//
// B3 (yst_nms_matrix_chunked) takes candidates already sorted by priority
// and runs the same pair of kernels on every `chunk`-wide strip, in order,
// with a carry on the device: the keepers so far (their slots in the
// output, their boxes, their count). The relation kernel of a later strip
// also writes one word per 32 carried keepers (IoU >= thr with the
// candidate), and the fixpoint starts from the candidates no carried
// keeper kills, appends the strip's keepers after the carried ones and
// raises the count, cut at max_keep. An image whose count has reached
// max_keep is full: no later strip can reach its output (a later
// candidate's rank would pass max_keep), so both kernels of every later
// strip return at once for it, as they do for a strip whose first (best)
// candidate is dead. The host enqueues all strips without a sync.

#include <cuda_pipeline.h>

#include <stdint.h>

#include "nms_common.cuh"
#include "nms_relation.cuh"

namespace {

constexpr int kMaxK = 1024;

size_t fixpoint_smem(int K) {
  const size_t W = (K + 31) / 32;
  return (W * K + 2 * W) * sizeof(unsigned) + (size_t)K * sizeof(float);
}

// One block per image. B2: strip = 0 and carry_box = nullptr. B3: the
// strip's candidates are at boxes / scores (already offset to the strip,
// `stride` apart between images), their output index is base + i, and
// count / carry_box hold the carry; strip 0 clears the outputs and starts
// the count.
__global__ void __launch_bounds__(kMaxK)
nms_fixpoint_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                    int stride, int K, int base, int max_keep,
                    const unsigned* __restrict__ rel, int Wt, int strip,
                    int* __restrict__ count, float* __restrict__ carry_box,
                    int* __restrict__ keep_idx, bool* __restrict__ keep_valid) {
  extern __shared__ __align__(16) unsigned smem_words[];
  const int W = (K + 31) / 32;
  unsigned* sup = smem_words;                          // [W][K]
  float* sc = reinterpret_cast<float*>(sup + W * K);   // [K]
  unsigned* s_und = reinterpret_cast<unsigned*>(sc + K);  // [W]
  unsigned* s_kept = s_und + W;                        // [W]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool chunked = carry_box != nullptr;
  const float* bb = boxes + (size_t)b * stride * 4;
  const float* sb = scores + (size_t)b * stride;
  int n_carry = 0;  // keepers carried from earlier strips
  if (chunked && strip > 0) {
    // the same values for every thread: a uniform exit for a full image or
    // a strip that starts dead (sorted: the rest of the image is dead too)
    n_carry = count[b];
    if (n_carry >= max_keep || !(sb[0] > 0.0f)) return;
  }
  const unsigned* words = rel + (size_t)b * Wt * K;
  int* out_idx = keep_idx + (size_t)b * max_keep;
  bool* out_valid = keep_valid + (size_t)b * max_keep;

  // the relation words, in flight while the rest of the set-up runs
  const int n_words = W * K;
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
    for (int e = 4 * tid; e < n_words; e += 4 * blockDim.x) {
      __pipeline_memcpy_async(sup + e, words + e, 16);
    }
  } else {
    for (int e = tid; e < n_words; e += blockDim.x) {
      __pipeline_memcpy_async(sup + e, words + e, 4);
    }
  }
  __pipeline_commit();

  for (int i = tid; i < K; i += blockDim.x) sc[i] = sb[i];
  if (strip == 0) {
    for (int s = tid; s < max_keep; s += blockDim.x) {
      out_idx[s] = -1;
      out_valid[s] = false;
    }
  }
  if (tid < W) s_kept[tid] = 0u;

  // one thread per candidate: blockDim >= K, rounded up to whole warps
  const int i = tid;
  bool und = i < K && sb[i] > 0.0f;
  if (und && n_carry > 0) {  // killed by a carried keeper
    const unsigned* kill = words + (size_t)W * K + i;
    for (int g = 0; g < (n_carry + 31) / 32 && und; ++g) und = kill[(size_t)g * K] == 0u;
  }
  bool kept = false;
  const unsigned und_word = __ballot_sync(0xffffffffu, und);
  if (lane == 0 && warp < W) s_und[warp] = und_word;
  __pipeline_wait_prior(0);
  bool any = __syncthreads_or(und);  // also publishes sup, sc and s_und
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

  // scores non-increasing (the top-k and the B3 sort give them so): the
  // priority order is the index order, and a keeper's rank is the count of
  // kept bits below it; otherwise each keeper compares itself with all kept
  const bool sorted = __syncthreads_and(i + 1 >= K || sc[i] >= sc[i + 1]);
  if (kept) {
    int rank = n_carry;
    if (sorted) {
      for (int w = 0; w < warp; ++w) rank += __popc(s_kept[w]);
      rank += __popc(s_kept[warp] & ((1u << lane) - 1u));
    } else {
      const float si = sc[i];
      for (int w = 0; w < W; ++w) {
        unsigned bits = s_kept[w];
        while (bits) {
          const int j = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1u;
          rank += yst::before(sc[j], j, si, i) ? 1 : 0;
        }
      }
    }
    if (rank < max_keep) {
      out_idx[rank] = base + i;
      out_valid[rank] = true;
      if (chunked) {
        float* dst = carry_box + ((size_t)b * max_keep + rank) * 4;
        for (int c = 0; c < 4; ++c) dst[c] = bb[4 * i + c];
      }
    }
  }
  if (chunked) {
    const int n_kept = __syncthreads_count(kept);
    if (tid == 0) count[b] = min(n_carry + n_kept, max_keep);
  }
}

std::atomic<unsigned> fixpoint_smem_set{0u};

cudaError_t launch_fixpoint(const float* boxes, const float* scores, int B, int stride, int K,
                            int base, int max_keep, const unsigned* rel, int Wt, int strip,
                            int* count, float* carry_box, int* keep_idx, bool* keep_valid,
                            cudaStream_t stream) {
  const cudaError_t err = yst::allow_dynamic_smem(
      (const void*)nms_fixpoint_kernel, (int)fixpoint_smem(kMaxK), fixpoint_smem_set);
  if (err != cudaSuccess) return err;
  const int threads = (K + 31) / 32 * 32;
  nms_fixpoint_kernel<<<B, threads, fixpoint_smem(K), stream>>>(
      boxes, scores, stride, K, base, max_keep, rel, Wt, strip, count, carry_box, keep_idx,
      keep_valid);
  return cudaGetLastError();
}

}  // namespace

// B2. rel: (B, ceil(K/32), K) words of device scratch.
extern "C" int yst_nms_matrix(const float* boxes, const float* scores, int B, int K,
                              float thr, int max_keep, int* keep_idx, bool* keep_valid,
                              unsigned* rel, cudaStream_t stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int W = (K + 31) / 32;
  cudaError_t err = yst::launch_relation(boxes, scores, B, K, K, thr, W, nullptr, max_keep,
                                         nullptr, rel, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fixpoint(boxes, scores, B, K, K, 0, max_keep, rel, W, 0, nullptr,
                              nullptr, keep_idx, keep_valid, stream);
}

// B3 over candidates sorted by priority: boxes (B, Kp, 4), scores (B, Kp),
// Kp a multiple of chunk. keep_idx gets indices into the sorted axis.
// work: one device scratch of 4-byte elements, carved as
//   rel (B, W + ceil(max_keep/32), chunk) words | carry_box (B, max_keep, 4)
//   f32 | count (B) i32, with W = ceil(chunk/32).
extern "C" int yst_nms_matrix_chunked(const float* boxes, const float* scores, int B, int Kp,
                                      int chunk, float thr, int max_keep, int* keep_idx,
                                      bool* keep_valid, unsigned* work, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxK || Kp % chunk != 0) return (int)cudaErrorInvalidValue;
  const int Wt = (chunk + 31) / 32 + (max_keep + 31) / 32;
  unsigned* rel = work;
  float* carry_box = reinterpret_cast<float*>(rel + (size_t)B * Wt * chunk);
  int* count = reinterpret_cast<int*>(carry_box + (size_t)B * max_keep * 4);
  for (int c = 0; c < Kp / chunk; ++c) {
    const float* sb = boxes + (size_t)c * chunk * 4;
    const float* ss = scores + (size_t)c * chunk;
    cudaError_t err = yst::launch_relation(sb, ss, B, Kp, chunk, thr, Wt,
                                           c > 0 ? count : nullptr, max_keep, carry_box, rel,
                                           stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_fixpoint(sb, ss, B, Kp, chunk, c * chunk, max_keep, rel, Wt, c, count,
                          carry_box, keep_idx, keep_valid, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
