// Issue-rate probes for Hopper (sm_90a): the FP32 peak, the slot cost of
// the special operations the render kernels use, and the streamed fma
// chains of the roofline.
//
// Replaces the TPU probes scripts/vpu_peak.py (`measure` / `make_kernel`,
// `measure_kernel` / `make_chain_kernel`, pallas_call at :117 and :176) and
// the streamed-chain kernel of scripts/roofline.py `vpu_peak` (:93, call
// :118).  The plain PyTorch versions are in probes/issue_peak.py.
//
// - tree kernels: each thread owns one element y and runs `statements`
//   statements; a statement is 32 independent leaves (x * c + d, or the
//   leaf of the operation under test) folded by a balanced product tree,
//   then renormalised, y = 1 + (t - 1) * 0.125.  The per-leaf constants
//   arrive as kernel parameters (constant bank operands): nvcc cannot fold
//   them, and nothing can be shared between statements, since every
//   statement depends on the last.  The fma leaf is unfused (x * c then
//   + d, as the whole library is built, --fmad=false), which is how the
//   render kernels run.
// - chain kernels: K independent chains of D dependent steps v = v * c + d
//   per statement, summed by a balanced tree (vpu_peak.py:140).
// - streamed chains: every element runs 512 steps b = b * a + 1 spread over
//   4, 8 or 16 independent chains, then sums them (roofline.py:100-114);
//   unfused, and fused with __fmaf_rn written out: the card's fused peak.
//
// What bounds them on the card: instruction issue (one warp instruction a
// clock on each of the SM's four schedulers, 128 FP32 lanes a clock), not
// bytes: each thread reads and writes one float.  cuobjdump -sass of the
// built library shows how many FFMA / FMUL / FADD each kernel issues.
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#define F(x) ((float)(x))

constexpr int P = 32;          // leaves per statement tree
constexpr int BLOCK = 256;

enum Op { OP_FMA = 0, OP_DIV = 1, OP_SQRT = 2, OP_RSQRT = 3, OP_EXP = 4,
          OP_SIN = 5, OP_SELECT = 6, OP_CONVERT = 7, OP_MASK = 8 };

// per-leaf constants, rounded from doubles on the host as JAX rounds its
// weakly typed python floats: a, b, e as each leaf reads them
struct TreeConsts {
  float a[P], b[P], e[P];
};

// balanced trees over v[0..W), pairs in order (vpu_peak.py _tree_reduce,
// _tree_reduce_add), written out by recursion so that every index is a
// constant and v stays in registers
template <int W>
__device__ __forceinline__ void product_tree(float* v) {
#pragma unroll
  for (int j = 0; j < W / 2; ++j) v[j] = v[2 * j] * v[2 * j + 1];
  if constexpr (W > 2) product_tree<W / 2>(v);
}

template <int W>
__device__ __forceinline__ void sum_tree(float* v) {
#pragma unroll
  for (int j = 0; j < W / 2; ++j) v[j] = v[2 * j] + v[2 * j + 1];
  if constexpr (W > 2) sum_tree<W / 2>(v);
}

template <int OP>
__device__ __forceinline__ float leaf(float x, float a, float b, float e) {
  if (OP == OP_FMA) return x * a + b;                        // 2 ops
  if (OP == OP_DIV) return a / (x + b);                      // c / (x + (2 + d))
  if (OP == OP_SQRT) return sqrtf(x * a);                    // a = c * c
  if (OP == OP_RSQRT) return rsqrtf(x * a);
  if (OP == OP_EXP) return expf((x - 1.0f) * a);
  if (OP == OP_SIN) return 1.0f + F(0.1) * sinf(x * a + b);
  if (OP == OP_SELECT) return x > a ? x + b : e;             // e = c + d
  if (OP == OP_CONVERT)
    return (float)(int)((x * a + b) * 256.0f) * F(1.0 / 256.0);
  // OP_MASK: e = c + 0.5
  return (x > a && x < e && x > b) ? x : a;
}

template <int OP>
__device__ __forceinline__ void tree_body(const float* x, float* out,
                                          const TreeConsts& k, int statements,
                                          long long n) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float y = x[i];
  for (int s = 0; s < statements; ++s) {
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = leaf<OP>(y, k.a[j], k.b[j], k.e[j]);
    product_tree<P>(v);
    y = 1.0f + (v[0] - 1.0f) * 0.125f;
  }
  out[i] = y;
}

#define TREE_KERNEL(name, OP)                                                  \
  extern "C" __global__ void __launch_bounds__(BLOCK)                          \
      name(const float* x, float* out, TreeConsts k, int statements,          \
           long long n) {                                                      \
    tree_body<OP>(x, out, k, statements, n);                                   \
  }
TREE_KERNEL(probe_tree_fma, OP_FMA)
TREE_KERNEL(probe_tree_div, OP_DIV)
TREE_KERNEL(probe_tree_sqrt, OP_SQRT)
TREE_KERNEL(probe_tree_rsqrt, OP_RSQRT)
TREE_KERNEL(probe_tree_exp, OP_EXP)
TREE_KERNEL(probe_tree_sin, OP_SIN)
TREE_KERNEL(probe_tree_select, OP_SELECT)
TREE_KERNEL(probe_tree_convert, OP_CONVERT)
TREE_KERNEL(probe_tree_mask, OP_MASK)

// ---- K x D fma chains (vpu_peak.py make_chain_kernel) ----
constexpr int MAX_KD = 256;
struct ChainConsts {
  float c[MAX_KD], d[MAX_KD];
};

template <int K, int D>
__device__ __forceinline__ void chain_body(const float* x, float* out,
                                           const ChainConsts& k,
                                           int statements, long long n) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float y = x[i];
  for (int s = 0; s < statements; ++s) {
    float v[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      v[c] = y;
#pragma unroll
      for (int j = 0; j < D; ++j)
        v[c] = v[c] * k.c[c * D + j] + k.d[c * D + j];
    }
    sum_tree<K>(v);
    y = 1.0f + (v[0] * F(1.0 / K) - 1.0f) * 0.125f;
  }
  out[i] = y;
}

#define CHAIN_KERNEL(name, K, D)                                               \
  extern "C" __global__ void __launch_bounds__(BLOCK)                          \
      name(const float* x, float* out, ChainConsts k, int statements,         \
           long long n) {                                                      \
    chain_body<K, D>(x, out, k, statements, n);                                \
  }
CHAIN_KERNEL(probe_chain_8x8, 8, 8)
CHAIN_KERNEL(probe_chain_16x8, 16, 8)
CHAIN_KERNEL(probe_chain_16x16, 16, 16)
CHAIN_KERNEL(probe_chain_32x4, 32, 4)

// ---- streamed chains (roofline.py vpu_peak): 512 steps per element ----
constexpr int STREAM_K = 512;

template <int CHAINS, bool FUSED>
__device__ __forceinline__ void stream_body(const float* x, float* out,
                                            long long n) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  float b[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) b[j] = a + F(0.1 * (j + 1));
  for (int s = 0; s < STREAM_K / CHAINS; ++s) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      b[j] = FUSED ? __fmaf_rn(b[j], a, 1.0f) : b[j] * a + 1.0f;
  }
  float r = b[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) r = r + b[j];
  out[i] = r;
}

#define STREAM_KERNEL(name, CHAINS, FUSED)                                     \
  extern "C" __global__ void __launch_bounds__(BLOCK)                          \
      name(const float* x, float* out, long long n) {                          \
    stream_body<CHAINS, FUSED>(x, out, n);                                     \
  }
STREAM_KERNEL(probe_stream_4, 4, false)
STREAM_KERNEL(probe_stream_8, 8, false)
STREAM_KERNEL(probe_stream_16, 16, false)
STREAM_KERNEL(probe_stream_4_fused, 4, true)
STREAM_KERNEL(probe_stream_8_fused, 8, true)
STREAM_KERNEL(probe_stream_16_fused, 16, true)

static unsigned grid_of(long long n) {
  return (unsigned)((n + BLOCK - 1) / BLOCK);
}

// op: enum Op; consts: 3 * 32 host floats (a, b, e); x, out: n device floats
extern "C" int probe_tree_launch(int op, const float* x, float* out,
                                 const float* consts, int statements,
                                 long long n, void* stream) {
  TreeConsts k;
  for (int j = 0; j < P; ++j) {
    k.a[j] = consts[j];
    k.b[j] = consts[P + j];
    k.e[j] = consts[2 * P + j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_of(n);
  switch (op) {
    case OP_FMA: probe_tree_fma<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_DIV: probe_tree_div<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_SQRT: probe_tree_sqrt<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_RSQRT: probe_tree_rsqrt<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_EXP: probe_tree_exp<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_SIN: probe_tree_sin<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_SELECT: probe_tree_select<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_CONVERT: probe_tree_convert<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    case OP_MASK: probe_tree_mask<<<g, BLOCK, 0, st>>>(x, out, k, statements, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// c, d: K * D host floats each, chain-major
extern "C" int probe_chain_launch(int K, int D, const float* x,
                                  float* out, const float* c, const float* d,
                                  int statements, long long n, void* stream) {
  if (K * D > MAX_KD) return (int)cudaErrorInvalidValue;
  ChainConsts k;
  for (int j = 0; j < MAX_KD; ++j) {
    k.c[j] = j < K * D ? c[j] : 0.0f;
    k.d[j] = j < K * D ? d[j] : 0.0f;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_of(n);
#define CH(KK, DD, name)                                                       \
  if (K == KK && D == DD) {                                                    \
    name<<<g, BLOCK, 0, st>>>(x, out, k, statements, n);                       \
    return (int)cudaGetLastError();                                            \
  }
  CH(8, 8, probe_chain_8x8)
  CH(16, 8, probe_chain_16x8)
  CH(16, 16, probe_chain_16x16)
  CH(32, 4, probe_chain_32x4)
#undef CH
  return (int)cudaErrorInvalidValue;
}

extern "C" int probe_stream_launch(int chains, int fused, const float* x,
                                   float* out, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_of(n);
#define SK(CC, name)                                                           \
  if (chains == CC) {                                                          \
    if (fused) name##_fused<<<g, BLOCK, 0, st>>>(x, out, n);                   \
    else name<<<g, BLOCK, 0, st>>>(x, out, n);                                 \
    return (int)cudaGetLastError();                                            \
  }
  SK(4, probe_stream_4)
  SK(8, probe_stream_8)
  SK(16, probe_stream_16)
#undef SK
  return (int)cudaErrorInvalidValue;
}
