// Dead-bounce probe for Hopper (sm_90a): what a warp pays for lanes whose
// path has ended.
//
// Replaces the TPU probe scripts/probe_when_skip.py (`run`, pallas_call
// :68), which asked whether pl.when can skip a bounce for a tile with no
// live lane.  The plain PyTorch version is in probes/dead_bounce.py.
//
// The same toy: 20 planes of state, here in registers, and 6 bounces of
// v = v * 1.0001 + sin(v) * 0.25, v = v + sqrt(|v| + 1e-3) over every
// plane, summed into acc; after bounce b a lane dies when b >= kill_after
// (and, with `half`, every odd lane dies after bounce 0), else it stays
// alive while acc == acc.  Two forms:
// - warp: the warp runs a bounce for all its lanes when __any_sync finds a
//   live lane (pl.when(any_alive) per tile, at a warp's width);
// - thread: a lane leaves the bounce loop when it dies, and its warp runs
//   on with the lane idle (how the render kernels end a path).
// The 20 planes start at x + z[j] with z all zeros passed as parameters,
// so that nvcc cannot merge the 20 equal chains into one.
//
// What bounds it on the card: FP32 issue, sinf and sqrtf mostly; each
// element reads and writes 4 bytes.  Every entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int NPLANES = 20;
constexpr int BOUNCES = 6;
constexpr int SKIP_BLOCK = 256;

struct Zeros {
  float z[NPLANES];
};

template <bool WARP>
__global__ void __launch_bounds__(SKIP_BLOCK)
skip_kernel(const float* x, float* out, Zeros zz, int kill_after, int half,
            long long n) {
  const long long i = (long long)blockIdx.x * SKIP_BLOCK + threadIdx.x;
  const bool live = i < n;
  const float xi = live ? x[i] : 0.0f;
  float p[NPLANES];
#pragma unroll
  for (int j = 0; j < NPLANES; ++j) p[j] = xi + zz.z[j];
  bool alive = live && xi > 0.0f;
  for (int b = 0; b < BOUNCES; ++b) {
    if (WARP) {
      if (!__any_sync(0xffffffffu, alive)) continue;
    } else if (!alive) {
      break;
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NPLANES; ++j) {
      float v = p[j];
      v = v * 1.0001f + sinf(v) * 0.25f;
      v = v + sqrtf(fabsf(v) + 1e-3f);
      p[j] = v;
      acc = acc + v;
    }
    if (b >= kill_after || (half && (i & 1))) alive = false;
    else alive = alive && (acc == acc);
  }
  if (live) out[i] = p[0];
}

}  // namespace

// x, out: n device floats; warp selects the form
extern "C" int probe_skip_launch(int warp, const float* x, float* out,
                                 int kill_after, int half, long long n,
                                 void* stream) {
  Zeros zz;
  for (int j = 0; j < NPLANES; ++j) zz.z[j] = 0.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + SKIP_BLOCK - 1) / SKIP_BLOCK);
  if (warp)
    skip_kernel<true><<<grid, SKIP_BLOCK, 0, st>>>(x, out, zz, kill_after, half, n);
  else
    skip_kernel<false><<<grid, SKIP_BLOCK, 0, st>>>(x, out, zz, kill_after, half, n);
  return (int)cudaGetLastError();
}
