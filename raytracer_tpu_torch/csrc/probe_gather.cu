// Per-lane texel gather probe for Hopper (sm_90a).
//
// Replaces the TPU probe scripts/probe_vmem_gather.py (`run`, pallas_call
// :92), which found that a Pallas kernel cannot fetch table[idx] per lane
// at all, so the textured path was split into record + replay.  The plain
// PyTorch version is in probes/gather.py.
//
// Each ray fetches 6 texels, table[(idx + b * 977) mod T] for b = 0..5, and
// sums them as floats (the script's kernel_take); the baseline sums the
// indices without fetching (kernel_baseline).  Three kernels:
// - ldg: one thread per ray, __ldg from device memory; the 420 KB table
//   of the script (T = 327 * 321) stays in the 50 MB L2;
// - smem: one persistent block per SM copies the table into shared memory
//   once, cut to what a block's opt-in dynamic shared memory holds, and
//   walks its share of the rays (T is then that cut);
// - base: the same index arithmetic without the fetch.
//
// What bounds them on the card: the fetch latency and the L2 / shared
// memory request rate, not DRAM bytes (4 B of index in and 4 B of sum out
// per ray).  Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int FETCHES = 6;
constexpr int STRIDE = 977;
constexpr int GATHER_BLOCK = 256;
constexpr int SMEM_BLOCK = 1024;

__global__ void __launch_bounds__(GATHER_BLOCK)
gather_ldg_kernel(const int* table, const int* idx, float* out, int T, int n) {
  const int i = blockIdx.x * GATHER_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int k = idx[i];
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < FETCHES; ++b)
    acc = acc + (float)__ldg(table + (k + b * STRIDE) % T);
  out[i] = acc;
}

__global__ void __launch_bounds__(SMEM_BLOCK)
gather_smem_kernel(const int* table, const int* idx, float* out, int T, int n) {
  extern __shared__ int s_table[];
  for (int j = threadIdx.x; j < T; j += SMEM_BLOCK) s_table[j] = table[j];
  __syncthreads();
  for (int i = blockIdx.x * SMEM_BLOCK + threadIdx.x; i < n;
       i += gridDim.x * SMEM_BLOCK) {
    const int k = idx[i];
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < FETCHES; ++b) acc = acc + (float)s_table[(k + b * STRIDE) % T];
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(GATHER_BLOCK)
gather_base_kernel(const int* idx, float* out, int T, int n) {
  const int i = blockIdx.x * GATHER_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int k = idx[i];
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < FETCHES; ++b) acc = acc + (float)((k + b * STRIDE) % T);
  out[i] = acc;
}

}  // namespace

// The most table entries the smem kernel holds: the opt-in dynamic shared
// memory of one block, in ints; 0 on error.
extern "C" int probe_gather_smem_entries() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes / (int)sizeof(int);
}

// mode 0: ldg, 1: smem (T at most probe_gather_smem_entries()), 2: base.
// table: at least T ints; idx, out: n.
extern "C" int probe_gather_launch(int mode, const int* table, const int* idx,
                                   float* out, int T, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + GATHER_BLOCK - 1) / GATHER_BLOCK;
  if (mode == 0) {
    gather_ldg_kernel<<<blocks, GATHER_BLOCK, 0, st>>>(table, idx, out, T, n);
  } else if (mode == 1) {
    const size_t smem = sizeof(int) * (size_t)T;
    cudaError_t err = cudaFuncSetAttribute(
        gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    gather_smem_kernel<<<sms, SMEM_BLOCK, smem, st>>>(table, idx, out, T, n);
  } else if (mode == 2) {
    gather_base_kernel<<<blocks, GATHER_BLOCK, 0, st>>>(idx, out, T, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
