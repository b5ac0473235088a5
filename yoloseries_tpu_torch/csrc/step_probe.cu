// Latency probe of one block-wide dependent step, for the NMS kernels'
// dependent-chain bound.
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
// Measurement only: chip_smoke.py times it; no serving path launches it.

namespace {

constexpr int kMaxThreads = 1024;

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

}  // namespace

extern "C" int yst_step_probe(int steps, int threads, float* out, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  step_probe_kernel<<<1, threads, 0, stream>>>(steps, out);
  return (int)cudaGetLastError();
}
