// The eval-mode epilogue of ConvBnAct in one pass: out = silu(y * mul + shift)
// per channel of a contiguous NCHW tensor, mul = weight * rsqrt(var + eps) and
// shift = bias - mean * mul worked out from BN's four f32 vectors.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the BN affine and SiLU into
// the convolution's consumer. Here they were three full passes of ATen
// (x * mul, + shift, silu), 24 bytes moved for every f32 element. Plain twin:
// yoloseries_tpu_torch/kernels/bn_silu.py::bn_silu_plain.
//
// What bounds it on Hopper: bytes. Each element is read once and written once,
// 8 bytes for f32 (4 for bf16), over 3.35 TB/s; the ~30 instructions of an
// element (expf and an IEEE division) stay under a third of the SMs'
// instruction rate at that stream. The design keeps the stream full: 16-byte
// vector loads and stores, 4 vectors in flight a thread, loaded all before
// any is stored.
// The grid runs over (plane, chunk) where a plane (one image's channel) holds
// more than half a block's elements; smaller planes (20x20 at B=16) are packed
// whole, several to a block, so a forward's small layers still fill 132 SMs. A
// block works out the mul and shift of its planes once, into shared memory.
// A range whose start is not 16-byte aligned, or whose planes split a vector
// (H*W not a multiple of the vector width), takes a scalar head and tail and
// a per-element plane.
//
// The arithmetic is ATen's eval path op for op, each op rounded on its own
// (explicit _rn intrinsics; -fmad=false besides): rsqrtf, two products, a
// difference, then t = y * mul, u = t + shift, and SiLU as ATen computes it,
// u / (1 + expf(-u)). bf16 is read into f32 and rounded once, at the end, as
// ConvBnAct rounds after its activation. `out` may equal `y`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;  // 16-byte vectors in flight a thread
constexpr int kMaxPlanes = 1024;   // planes a block may pack (shared memory)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <bool kAct>
__device__ __forceinline__ float epilogue(float y, float mul, float shift) {
  const float u = __fadd_rn(__fmul_rn(y, mul), shift);
  return kAct ? __fdiv_rn(u, __fadd_rn(1.0f, expf(-u))) : u;
}

struct Args {
  const void* y;
  void* out;
  long long planes;  // N * C
  int C;
  int hw;
  int per_block;  // > 1: whole planes packed per block; 1: one plane in chunks
  int chunks;     // chunks per plane (per_block == 1)
  int chunk;      // elements per chunk, a multiple of the vector width
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

template <typename T, bool kAct>
__global__ void __launch_bounds__(kThreads) bn_silu_kernel(Args a) {
  constexpr int V = 16 / sizeof(T);  // elements a vector
  __shared__ float s_mul[kMaxPlanes];
  __shared__ float s_shift[kMaxPlanes];

  long long plane0, start;
  int n, planes;  // the block's elements (<= kThreads * kVecsPerThread * V), planes
  if (a.per_block > 1) {
    plane0 = (long long)blockIdx.x * a.per_block;
    planes = (int)min((long long)a.per_block, a.planes - plane0);
    start = plane0 * a.hw;
    n = planes * a.hw;
  } else {
    plane0 = blockIdx.x / a.chunks;
    const int off = (int)(blockIdx.x % a.chunks) * a.chunk;
    planes = 1;
    start = plane0 * a.hw + off;
    n = min(a.chunk, a.hw - off);
  }
  for (int i = threadIdx.x; i < planes; i += kThreads) {
    const int c = (int)((plane0 + i) % a.C);
    const float mul = __fmul_rn(a.weight[c], rsqrtf(__fadd_rn(a.var[c], a.eps)));
    s_mul[i] = mul;
    s_shift[i] = __fsub_rn(a.bias[c], __fmul_rn(a.mean[c], mul));
  }
  __syncthreads();

  const T* src = static_cast<const T*>(a.y) + start;
  T* dst = static_cast<T*>(a.out) + start;
  const bool packed = a.per_block > 1;  // else every element is in plane 0
  // elements up to the first 16-byte boundary; all of them where y and out
  // are misaligned against each other
  const unsigned long long addr = reinterpret_cast<unsigned long long>(src);
  int head = (int)((16 - addr % 16) % 16) / (int)sizeof(T);
  if (addr % sizeof(T) != 0 ||
      (addr - reinterpret_cast<unsigned long long>(dst)) % 16 != 0 || head > n) {
    head = n;
  }
  const int nv = (n - head) / V;
  const int body_end = head + nv * V;

  // scalar head and tail, an element a thread
  for (int i = threadIdx.x; i < n - nv * V; i += kThreads) {
    const int e = i < head ? i : body_end + (i - head);
    const int p = packed ? e / a.hw : 0;
    dst[e] = from_f32<T>(epilogue<kAct>(to_f32(src[e]), s_mul[p], s_shift[p]));
  }

  // the vectors: one plane each unless planes split them
  const bool whole = !packed || (head == 0 && a.hw % V == 0);
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int v0 = threadIdx.x; v0 < nv; v0 += kThreads * kVecsPerThread) {
    uint4 buf[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int v = v0 + k * kThreads;
      if (v < nv) buf[k] = vsrc[v];
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int v = v0 + k * kThreads;
      if (v >= nv) continue;
      T* e = reinterpret_cast<T*>(&buf[k]);
      const int first = head + v * V;
      if (whole) {
        const int p = packed ? first / a.hw : 0;
        const float mul = s_mul[p], shift = s_shift[p];
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = from_f32<T>(epilogue<kAct>(to_f32(e[j]), mul, shift));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int p = (first + j) / a.hw;
          e[j] = from_f32<T>(epilogue<kAct>(to_f32(e[j]), s_mul[p], s_shift[p]));
        }
      }
      vdst[v] = buf[k];
    }
  }
}

template <typename T>
int launch(Args a, int act, cudaStream_t stream) {
  constexpr int kBlockElems = kThreads * kVecsPerThread * (16 / sizeof(T));
  long long blocks;
  if (a.hw > kBlockElems / 2) {  // a plane in chunks of a block's elements
    a.per_block = 1;
    a.chunks = (a.hw + kBlockElems - 1) / kBlockElems;
    a.chunk = kBlockElems;
    blocks = a.planes * a.chunks;
  } else {  // whole planes, as many as a block holds
    a.per_block = min(kBlockElems / a.hw, kMaxPlanes);
    a.chunks = 1;
    a.chunk = a.hw;
    blocks = (a.planes + a.per_block - 1) / a.per_block;
  }
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (act) {
    bn_silu_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  } else {
    bn_silu_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16. weight, bias, mean and var: C f32 values each.
extern "C" int yst_bn_silu(const void* y, void* out, int N, int C, int HW,
                           const float* weight, const float* bias, const float* mean,
                           const float* var, float eps, int act, int dtype,
                           cudaStream_t stream) {
  if (N < 1 || C < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  Args a{y, out, (long long)N * C, C, HW, 0, 0, 0, weight, bias, mean, var, eps};
  if (dtype == 0) return launch<float>(a, act, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, act, stream);
  return (int)cudaErrorInvalidValue;
}
