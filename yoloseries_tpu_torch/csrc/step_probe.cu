// Latency probes of one dependent step, for the NMS kernels' dependent-chain
// bounds: block-wide (B2, B3) and warp-wide (B1).
//
// Greedy NMS decides keepers one after another: a block-parallel kernel
// (one block per image, as nms_greedy.cu and nms_matrix.cu are) needs at
// least one block-wide exchange per dependent decision, since every thread
// must learn the decision before it can take part in the next. The least
// such exchange is what this kernel repeats: each thread publishes a value to
// shared memory, the block meets at one __syncthreads(), and each thread reads
// its neighbour's value. Two buffers alternate, so one barrier per step is
// enough. steps x (time of one step) bounds the chain from below.
//
// A kernel that decides keepers inside one warp, between two barriers (B1's
// tile scan), still needs one dependent decision per keeper. The warp probe
// measures that decision as B1's tile resolution takes it, every lane alike:
// a test of a row against the kept mask and the mask updated, the row brought
// in by a __shfl_sync that does not depend on the chain.
//
// Measurement only: chip_smoke.py times them; no serving path launches them.

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxThreads)
step_probe_kernel(int steps, float* __restrict__ out) {
  __shared__ float buf[2][kMaxThreads];
  const int tid = threadIdx.x;
  const int next = tid + 1 == (int)blockDim.x ? 0 : tid + 1;
  float v = (float)tid;
  for (int s = 0; s < steps; ++s) {
    float* cur = buf[s & 1];
    cur[tid] = v;
    __syncthreads();
    v = cur[next] + 1.0f;
  }
  out[tid] = v;
}

__global__ void __launch_bounds__(32)
warp_step_probe_kernel(int steps, unsigned* __restrict__ out) {
  const unsigned lane = threadIdx.x;
  const unsigned rows = lane * 0x9e3779b9u;
  unsigned v = lane;
  for (int s = 0; s < steps; ++s) {
    const unsigned row = __shfl_sync(kFull, rows, s & 31);
    v = (row & v) == 0u ? v | (1u << (s & 31)) : v;
  }
  out[lane] = v;
}

}  // namespace

extern "C" int yst_step_probe(int steps, int threads, float* out, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  step_probe_kernel<<<1, threads, 0, stream>>>(steps, out);
  return (int)cudaGetLastError();
}

extern "C" int yst_warp_step_probe(int steps, unsigned* out, cudaStream_t stream) {
  warp_step_probe_kernel<<<1, 32, 0, stream>>>(steps, out);
  return (int)cudaGetLastError();
}
