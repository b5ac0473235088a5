// Greedy NMS as one ordered tile scan, one block per image.
//
// Replaces yoloseries_tpu/kernels/nms_pallas.py::pallas_greedy_nms (Pallas
// body _nms_kernel). Plain twins: yoloseries_tpu_torch/kernels/nms_greedy.py
// ::greedy_nms (the argmax loop) and ::greedy_nms_tiled_plain (this design,
// step for step).
//
// Greedy takes the leftmost argmax of the live scores, suppresses every
// candidate with IoU >= thr, zeroes the keeper and repeats; a best score
// <= 0 ends the image. That is the same as walking the candidates in
// priority order (score descending, ties to the lower index) and keeping
// each live one that no earlier keeper suppresses, up to max_keep.
//
// What bounds it on Hopper: the dependent chain, one decision per keeper,
// not bytes (an image is read once) nor operations. The design it replaces
// paid a block-wide float argmax over all K, two __syncthreads and an IoU
// pass over all K candidates per keeper: ~1.2 us a keeper at K = 512. This
// one decides up to 32 keepers per block-wide step, so its chain is the
// tiles it walks, each a phase of all warps and one of warp 0 between two
// barriers, on one SM per image:
//
// 1. Priority order in the block. One __syncthreads_and tests whether the
//    scores are non-increasing; then position = index. Otherwise the block
//    sorts (score desc, index asc) 64-bit keys in shared memory (bitonic,
//    K padded to a power of two; the keys are unique, so any correct sort
//    gives greedy's order). One code path, the sort skipped on sorted input.
//    The boxes are then loaded in priority order into four coordinate planes
//    with the area beside them, computed once; liveness (score > 0) is a
//    bit set, one word per 32-wide tile of the order.
// 2. Ordered tile scan. Every warp finds the next tile with a live member
//    (a ballot over the words). In one phase the warps test the members
//    against the keepers so far (pull), spread over the warps, and build
//    the tile's 32 rows "live member j, earlier in the tile, suppresses
//    member l", one row per warp by ballot. After a barrier, warp 0
//    resolves greedy inside the tile in registers (32 dependent steps on a
//    kept mask, the rows passed by __shfl_sync), cuts at max_keep inside the
//    tile if need be, writes the keepers to their output slots and their
//    boxes to the front of the planes (slot <= position, and every position
//    before the tile is decided), and a second barrier closes the step.
//
// Pulling, not pushing: suppressing every later candidate after each tile
// would test all of them, though the scan stops once max_keep keepers are
// found, often a few tiles in (10 of 128 at K = 4096 with 300 keepers on
// the eval protocol's path). Pulled, each scanned member meets each keeper
// before it once. The block-wide steps are the tiles walked: at most
// ceil(K / 32).
//
// IoU: yst::box_iou, unchanged, built with -fmad=false. It is symmetric to
// the bit (min, max, + and * commute), so which box is `a` does not matter;
// the keeper is `a`, as in the twins. Two boxes whose x or y extents do not
// overlap have inter 0 (or NaN from an infinite side), so IoU 0 or NaN, and
// for thr > 0 no suppression: that test skips the division.
//
// Shared memory at K = 8192: keys 64 KB + planes and areas 160 KB + live bits
// 1 KB and the tile's rows, within the 227 KB a block may hold.

#include <stdint.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxK = 8192;  // kernels/nms_greedy.py::GREEDY_MAX_K
constexpr unsigned kFull = 0xffffffffu;

// Keys the in-block sort runs over: K padded to a power of two, >= 32.
int sort_width(int k) {
  int p = 32;
  while (p < k) p <<= 1;
  return p;
}

size_t greedy_smem(int K) {
  const size_t W = (K + 31) / 32;
  return (size_t)sort_width(K) * sizeof(uint64_t)  // sort keys
         + (size_t)5 * K * sizeof(float)             // x1, y1, x2, y2, area
         + (W + 34) * sizeof(unsigned);              // live bits, rows, killed, count
}

// Ascending order of the key is greedy's order: live (score > 0) first by
// score descending, then by index; dead candidates last.
__device__ __forceinline__ uint64_t priority_key(float s, int i) {
  const unsigned hi = s > 0.0f ? ~__float_as_uint(s) : kFull;
  return ((uint64_t)hi << 32) | (unsigned)i;
}

// Does keeper a suppress candidate b? box_iou(a, b) >= thr, with the
// division skipped where the extents do not overlap and thr > 0.
__device__ __forceinline__ bool suppresses(float ax1, float ay1, float ax2, float ay2,
                                           float a_area, float bx1, float by1, float bx2,
                                           float by2, float b_area, float thr) {
  const bool overlap = fminf(ax2, bx2) > fmaxf(ax1, bx1) && fminf(ay2, by2) > fmaxf(ay1, by1);
  if (!overlap && thr > 0.0f) return false;
  return yst::box_iou(ax1, ay1, ax2, ay2, a_area, bx1, by1, bx2, by2, b_area) >= thr;
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                  int K, float thr, int max_keep, int* __restrict__ keep_idx,
                  bool* __restrict__ keep_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = max(32, 1 << (32 - __clz(K - 1)));  // sort_width(K)
  const int W = (K + 31) / 32;
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);  // [Kp]
  float* x1 = reinterpret_cast<float*>(key + Kp);     // [K] each, priority order
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  unsigned* live = reinterpret_cast<unsigned*>(area + K);  // [W]
  unsigned* sup = live + W;                                 // [32] the tile's rows
  unsigned* s_killed = sup + 32;                        // members killed by keepers
  int* s_count = reinterpret_cast<int*>(s_killed + 1);  // keepers so far

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const float* bb = boxes + (size_t)b * K * 4;
  const float* sc = scores + (size_t)b * K;
  int* out_idx = keep_idx + (size_t)b * max_keep;
  bool* out_valid = keep_valid + (size_t)b * max_keep;

  // 1. priority order
  bool mono = true;
  for (int i = tid; i < K; i += n_threads) {
    if (i + 1 < K && !(sc[i] >= sc[i + 1])) mono = false;
  }
  for (int s = tid; s < max_keep; s += n_threads) {
    out_idx[s] = -1;
    out_valid[s] = false;
  }
  const bool sorted = __syncthreads_and(mono);
  if (!sorted) {  // uniform: every thread has the same `sorted`
    for (int i = tid; i < Kp; i += n_threads) key[i] = i < K ? priority_key(sc[i], i) : ~0ull;
    __syncthreads();
    for (int k = 32; k <= Kp; k <<= 1) {
      // bitonic stages whose partners lie in other warps, through shared memory
      for (int j = k >> 1; j >= 32; j >>= 1) {
        for (int i = tid; i < Kp / 2; i += n_threads) {
          const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
          const int hi = lo + j;
          const uint64_t a = key[lo], c = key[hi];
          if ((a > c) == ((lo & k) == 0)) {
            key[lo] = c;
            key[hi] = a;
          }
        }
        __syncthreads();
      }
      // the stages within 32 elements, one per lane, in registers (at
      // k = 32 every stage of the merges up to 32)
      for (int e = tid; e < Kp; e += n_threads) {
        uint64_t v = key[e];
        for (int kk = k == 32 ? 2 : k; kk <= k; kk <<= 1) {
          for (int j = min(kk >> 1, 16); j > 0; j >>= 1) {
            const uint64_t o = __shfl_xor_sync(kFull, v, j);
            const bool keep_min = ((e & j) == 0) == ((e & kk) == 0);
            v = keep_min == (o < v) ? o : v;
          }
        }
        key[e] = v;
      }
      __syncthreads();
    }
  }
  // the boxes in priority order; a warp fills one live word per pass
  for (int p = tid; p < 32 * W; p += n_threads) {
    bool is_live = false;
    if (p < K) {
      const int i = sorted ? p : (int)(unsigned)key[p];
      const float a = bb[4 * i + 0], c = bb[4 * i + 1], d = bb[4 * i + 2], e = bb[4 * i + 3];
      x1[p] = a;
      y1[p] = c;
      x2[p] = d;
      y2[p] = e;
      area[p] = yst::box_area(a, c, d, e);
      is_live = sc[i] > 0.0f;
    }
    const unsigned word = __ballot_sync(kFull, is_live);
    if (lane == 0) live[p >> 5] = word;
  }
  if (tid == 0) {
    *s_count = 0;
    *s_killed = 0u;
  }
  __syncthreads();

  // 2. ordered tile scan
  int t = -1;  // the tile in hand: every warp walks the same tiles
  while (true) {
    // the next tile with a live member (score > 0)
    int w0 = t + 1;
    t = -1;
    for (; w0 < W; w0 += 32) {
      const unsigned any = __ballot_sync(kFull, w0 + lane < W && live[w0 + lane] != 0u);
      if (any) {
        t = w0 + __ffs(any) - 1;
        break;
      }
    }
    if (t < 0) break;  // uniform: no live candidate left
    const int count = *s_count;  // keepers so far; their boxes at plane slots 0 .. count-1
    const unsigned alive = live[t];
    const int p = 32 * t + lane;  // this lane's member of the tile
    // pull: member `lane` against the keepers so far, spread over the warps
    bool dead = false;
    if ((alive >> lane) & 1u) {
      const float mx1 = x1[p], my1 = y1[p], mx2 = x2[p], my2 = y2[p], marea = area[p];
      for (int r0 = warp; r0 < count && !dead; r0 += 4 * n_warps) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u * n_warps;
          if (r < count) {
            dead |= suppresses(x1[r], y1[r], x2[r], y2[r], area[r], mx1, my1, mx2, my2, marea,
                               thr);
          }
        }
      }
    }
    const unsigned killed = __ballot_sync(kFull, dead);
    if (lane == 0 && killed != 0u) atomicOr(s_killed, killed);
    // the tile's rows, one per warp: bit j of row l says live member j,
    // earlier in the tile, suppresses live member l
    for (int l = warp; l < 32; l += n_warps) {
      bool hit = false;
      if (((alive >> l) & 1u) && lane < l && ((alive >> lane) & 1u)) {
        const int q = 32 * t + l;
        hit = suppresses(x1[p], y1[p], x2[p], y2[p], area[p], x1[q], y1[q], x2[q], y2[q],
                         area[q], thr);
      }
      const unsigned row = __ballot_sync(kFull, hit);
      if (lane == 0) sup[l] = row;
    }
    __syncthreads();
    if (warp == 0) {
      // greedy inside the tile, in registers: a member no earlier keeper
      // killed is kept unless a kept earlier member of the tile suppresses
      // it; the cut at max_keep keeps the first keepers (they do not depend
      // on later ones)
      const unsigned todo = alive & ~*s_killed;
      const unsigned my_row = sup[lane];
      unsigned kept = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const unsigned row = __shfl_sync(kFull, my_row, j);
        if (((todo >> j) & 1u) && (row & kept) == 0u) kept |= 1u << j;
      }
      const int room = max_keep - count;
      while (__popc(kept) > room) kept &= ~(0x80000000u >> __clz(kept));
      // each keeper to its output slot, and its box to plane slot `slot`:
      // slot <= p, and every position before the tile is decided
      const bool mine = (kept >> lane) & 1u;
      const int slot = count + __popc(kept & ((1u << lane) - 1u));
      float k0 = 0.0f, k1 = 0.0f, k2 = 0.0f, k3 = 0.0f, k4 = 0.0f;
      if (mine) {
        k0 = x1[p];
        k1 = y1[p];
        k2 = x2[p];
        k3 = y2[p];
        k4 = area[p];
      }
      __syncwarp();
      if (mine) {
        out_idx[slot] = sorted ? p : (int)(unsigned)key[p];
        out_valid[slot] = true;
        x1[slot] = k0;
        y1[slot] = k1;
        x2[slot] = k2;
        y2[slot] = k3;
        area[slot] = k4;
      }
      if (lane == 0) {
        *s_count = count + __popc(kept);
        *s_killed = 0u;
      }
    }
    __syncthreads();
    if (*s_count >= max_keep) break;  // uniform
  }
}

}  // namespace

extern "C" int yst_nms_greedy(const float* boxes, const float* scores, int B, int K,
                              float thr, int max_keep, int* keep_idx, bool* keep_valid,
                              cudaStream_t stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> smem_set{0u};
  const cudaError_t err = yst::allow_dynamic_smem((const void*)greedy_nms_kernel,
                                                  (int)greedy_smem(kMaxK), smem_set);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<B, kMaxThreads, greedy_smem(K), stream>>>(
      boxes, scores, K, thr, max_keep, keep_idx, keep_valid);
  return (int)cudaGetLastError();
}
