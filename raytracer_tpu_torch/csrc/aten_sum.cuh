// torch.sum as ATen adds on the card (or, under W4_TORCH_CPU, as torch's
// CPU sum kernel adds), shared by W4's forward (wavefront_shade.cu: the
// diffuse entry's caps pdf, a sum over the last dimension of (n, K)
// terms) and its backward (wavefront_diffuse_bwd.cu: that pdf again, and
// the engine's sum_to of an (N, K, 3) gradient over K, a sum over a
// middle dimension).  Each restates its reduction's plan and order; the
// terms are made on demand (term(k), k < K, each called once).
// scripts/torch_op_rounding.py holds each order against torch on the
// card.

#pragma once

#include <cuda_runtime.h>

// A named namespace: the extern "C" entries of W4 take `SumPlan`.
namespace torch_sum {

// ---------------------------------------------------------------------------
// torch.sum over the last dimension of an (n, K) float32 tensor, its
// terms made on demand (term(k), k < K, each called once)
// ---------------------------------------------------------------------------

// How ATen's reduction (ATen/native/cuda/Reduce.cuh setReduceConfig) lays
// a row over a block: vec, the elements a thread loads at once (4 from K =
// 128 on, else 1); bx lanes, and by warps (1: the row is not split across
// warps); ctas, the blocks a row is split across (1: one block; more: each
// block's sum staged in global memory and the last block adding them,
// Reduce.cuh global_reduce), and staging, the staged sums, ctas a row.
// Made by `sum_plan` from K and n.
struct SumPlan {
  int vec, bx, by, ctas;
  float* staging;
};

#ifdef W4_TORCH_CPU
// The lane width of torch's CPU sum kernel (Vectorized<float>::size()).
#ifndef W4_CPU_VEC
#define W4_CPU_VEC 8
#endif

__device__ __forceinline__ int ceil_log2(long long x) {
  int b = 0;
  for (unsigned long long v = (unsigned long long)(x - 1); v; v >>= 1) ++b;
  return x <= 2 ? 1 : b;
}

// ATen/native/cpu/SumKernel.cpp row_sum: `size` elements of w lanes
// (element e lane l is term(e * w + l)) as (size / 4, 4) rows, each column
// into its own accumulator through multi_row_sum's four cascade levels,
// the elements past the rows into column 0, then the columns in order.
template <class Term>
__device__ void cpu_row_sum(long long size, int w, Term term, float* out) {
  const long long rows = size / 4;
  const int lp = ceil_log2(rows) / 4 > 4 ? ceil_log2(rows) / 4 : 4;
  const long long step = 1LL << lp, mask = step - 1;
  float acc[4][4][W4_CPU_VEC] = {};
  auto add_row = [&](long long r) {
    for (int k = 0; k < 4; ++k)
      for (int l = 0; l < w; ++l)
        acc[0][k][l] = acc[0][k][l] + term((r * 4 + k) * w + l);
  };
  long long i = 0;
  while (i + step <= rows) {
    for (long long j = 0; j < step; ++j, ++i) add_row(i);
    for (int j = 1; j < 4; ++j) {
      for (int k = 0; k < 4; ++k)
        for (int l = 0; l < w; ++l) {
          acc[j][k][l] = acc[j][k][l] + acc[j - 1][k][l];
          acc[j - 1][k][l] = 0.0f;
        }
      if ((i & (mask << (j * lp))) != 0) break;
    }
  }
  for (; i < rows; ++i) add_row(i);
  for (int j = 1; j < 4; ++j)
    for (int k = 0; k < 4; ++k)
      for (int l = 0; l < w; ++l) acc[0][k][l] = acc[0][k][l] + acc[j][k][l];
  for (long long e = rows * 4; e < size; ++e)
    for (int l = 0; l < w; ++l) acc[0][0][l] = acc[0][0][l] + term(e * w + l);
  for (int k = 1; k < 4; ++k)
    for (int l = 0; l < w; ++l) acc[0][0][l] = acc[0][0][l] + acc[0][k][l];
  for (int l = 0; l < w; ++l) out[l] = acc[0][0][l];
}

// torch's CPU sum of a row (SumKernel.cpp cascade_sum, a contiguous inner
// reduction): rows of K >= W4_CPU_VEC as vectors (vectorized_inner_sum:
// the vectors' row_sum, then the elements past them and the lanes in
// order), shorter rows as scalars; added to the zeroed output.
template <class Term>
__device__ float cpu_sum(int K, Term term) {
  float lanes[W4_CPU_VEC];
  if (K < W4_CPU_VEC) {
    cpu_row_sum(K, 1, term, lanes);
    return 0.0f + lanes[0];
  }
  const long long nv = K / W4_CPU_VEC;
  cpu_row_sum(nv, W4_CPU_VEC, term, lanes);
  float s = 0.0f;
  for (long long k = nv * W4_CPU_VEC; k < K; ++k) s = s + term(k);
  for (int l = 0; l < W4_CPU_VEC; ++l) s = s + lanes[l];
  return 0.0f + s;
}
#else
// Lane x of warp y of block c of row `row`: its terms into four
// accumulators as ReduceOp::thread_reduce adds them, the accumulators in
// order.  Below K = 128 the lane takes the terms x + y bx, then every bx
// by-th, the q-th into accumulator q % 4.  From 128 on it loads four at a
// time from the row's first 16-byte boundary: a row starting s elements
// past one gives its first 4 - s terms to lanes s..3 of warp 0, the loads
// follow, and the terms past the last whole load go to the first lanes of
// warp 0.  Split across blocks, lane x of warp y of block c starts at load
// x + y bx + c bx by and steps bx by ctas loads; the head and the tail
// terms go to block 0 alone.
template <class Term>
__device__ __forceinline__ float lane_sum(const SumPlan& S, long long row, int K,
                                          int x, int y, int c, Term term) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long stride = (long long)S.bx * S.by * S.ctas;
  long long idx = x + (long long)y * S.bx + (long long)c * S.bx * S.by;
  const bool ends = y == 0 && c == 0;
  if (S.vec == 1) {
    for (int q = 0; idx < K; ++q, idx += stride)
      acc[q & 3] = acc[q & 3] + term(idx);
  } else {
    const int s = (int)((row * K) & 3);
    long long end = K, off = 0;
    if (s > 0) {
      if (ends && x >= s && x < 4) acc[0] = 0.0f + term(x - s);
      end = K + s - 4;
      off = 4 - s;
    }
    for (; idx * 4 + 3 < end; idx += stride)
      for (int q = 0; q < 4; ++q) acc[q] = acc[q] + term(off + idx * 4 + q);
    const long long t = end - end % 4 + x;
    if (ends && t < end) acc[0] = acc[0] + term(off + t);
  }
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

__device__ __forceinline__ int bit_reverse(int r, int n) {
  int t = 0;
  for (int b = 1; b < n; b <<= 1, r >>= 1) t = (t << 1) | (r & 1);
  return t;
}

// ATen's sum of row `row` on the card, on one block (ctas 1; or block c's
// share of a row split across blocks, as block_tree makes it): the lanes
// of each warp by block_x_reduce's halving tree (lanes t and t + bx/2, then
// t and t + bx/4, ...), then the warps by block_y_reduce's.  A halving tree
// over n lanes is the pairwise tree over them in bit-reversed order, which
// a stack of log2(n) + 1 sums builds as the lanes come.
template <class Term>
__device__ float aten_sum(const SumPlan& S, long long row, int K, Term term, int c = 0) {
  float ys[10], xs[10];
  int yn = 0;
  for (int ry = 0; ry < S.by; ++ry) {
    const int y = bit_reverse(ry, S.by);
    int xn = 0;
    for (int rx = 0; rx < S.bx; ++rx) {
      xs[xn++] = lane_sum(S, row, K, bit_reverse(rx, S.bx), y, c, term);
      for (int c = rx + 1; (c & 1) == 0; c >>= 1, --xn) xs[xn - 2] = xs[xn - 2] + xs[xn - 1];
    }
    ys[yn++] = xs[0];
    for (int c = ry + 1; (c & 1) == 0; c >>= 1, --yn) ys[yn - 2] = ys[yn - 2] + ys[yn - 1];
  }
  return ys[0];
}

// Split across blocks (ctas > 1), as ATen splits it: block c's sum of row
// `row`, made by the threads of this block as block c's lanes (lane x of
// warp y is thread x + y bx of a block of bx by threads), each its lane's
// sum, then block_x_reduce's halving tree over the lanes and
// block_y_reduce's over the warps, through the shared array sh (bx by
// floats).  Every thread of the block calls it for the same row; each
// returns the block's sum.
template <class Term>
__device__ float block_tree(const SumPlan& S, long long row, int K, int c, Term& term,
                            float* sh) {
  const int t = threadIdx.x, x = t % S.bx, y = t / S.bx;
  sh[t] = lane_sum(S, row, K, x, y, c, term);
  __syncthreads();
  for (int off = S.bx / 2; off > 0; off >>= 1) {
    if (x < off) sh[t] = sh[t] + sh[t + off];
    __syncthreads();
  }
  for (int off = S.by / 2; off > 0; off >>= 1) {
    if (x == 0 && y < off) sh[t] = sh[t] + sh[t + off * S.bx];
    __syncthreads();
  }
  return sh[0];
}

// The blocks' staged sums p[0..ctas) of a row added as global_reduce's
// last block adds them: its thread x + y bx folds p[x + y bx], then every
// bx by-th, into 0, in block order; then block_y_reduce's halving tree
// over the warps, then block_x_reduce's over the lanes (the order
// scripts/torch_op_rounding.py holds against torch.sum on the card).  One
// thread does it all: a row has few blocks.
template <class Staged>
__device__ __forceinline__ float staged_sum(const SumPlan& S, const Staged& p) {
  const int B = S.bx * S.by;
  float ys[10], xs[10];
  int xn = 0;
  for (int rx = 0; rx < S.bx; ++rx) {
    const int x = bit_reverse(rx, S.bx);
    int yn = 0;
    for (int ry = 0; ry < S.by; ++ry) {
      const int y = bit_reverse(ry, S.by);
      float v = 0.0f;
      for (int c = x + y * S.bx; c < S.ctas; c += B) v = v + p[c];
      ys[yn++] = v;
      for (int m = ry + 1; (m & 1) == 0; m >>= 1, --yn) ys[yn - 2] = ys[yn - 2] + ys[yn - 1];
    }
    xs[xn++] = ys[0];
    for (int m = rx + 1; (m & 1) == 0; m >>= 1, --xn) xs[xn - 2] = xs[xn - 2] + xs[xn - 1];
  }
  return xs[0];
}

// aten_sum for a plan of one value a load and one warp a row (every plan
// below K = 128) with bx, the lanes of the warp, known at compile time:
// the same terms into the same accumulators and the same halving tree, so
// the same bits, with no partial sum indexed at run time (they stay in
// registers).  Lane x takes the terms x, x + BX, ..., the q-th into
// accumulator q % 4: the four rotate at each term so that the one it
// adds to is a0, and rotate back after the last.
template <int BX, class Term>
__device__ __forceinline__ float lane_sum_reg(int x, int K, Term& term) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int q = 0;
  for (int idx = x; idx < K; idx += BX, ++q) {
    const float t = a0 + term(idx);
    a0 = a1;
    a1 = a2;
    a2 = a3;
    a3 = t;
  }
  for (; (q & 3) != 0; ++q) {
    const float t = a0;
    a0 = a1;
    a1 = a2;
    a2 = a3;
    a3 = t;
  }
  return ((a0 + a1) + a2) + a3;
}

__host__ __device__ constexpr int bit_reverse_c(int r, int n) {
  int t = 0;
  for (int b = 1; b < n; b <<= 1, r >>= 1) t = (t << 1) | (r & 1);
  return t;
}

// The halving tree over BX lanes: the pairwise tree over the lanes in
// bit-reversed order, positions [LO, LO + M) of it.
template <int BX, int LO, int M, class Term>
__device__ __forceinline__ float reg_tree(int K, Term& term) {
  if constexpr (M == 1) {
    return lane_sum_reg<BX>(bit_reverse_c(LO, BX), K, term);
  } else {
    return reg_tree<BX, LO, M / 2>(K, term) + reg_tree<BX, LO + M / 2, M / 2>(K, term);
  }
}

// The largest bx a register sum is built for; a plan past it (or with
// four values a load, or warps splitting a row) takes aten_sum.
constexpr int REG_SUM_BX = 32;

__host__ __device__ __forceinline__ bool in_registers(const SumPlan& S) {
  return S.vec == 1 && S.by == 1 && S.ctas == 1 && S.bx >= 1 && S.bx <= REG_SUM_BX
         && (S.bx & (S.bx - 1)) == 0;
}

// aten_sum of a plan `in_registers` admits: bx picks the instantiation.
template <class Term>
__device__ __forceinline__ float reg_sum(const SumPlan& S, int K, Term& term) {
  switch (S.bx) {
    case 1: return reg_tree<1, 0, 1>(K, term);
    case 2: return reg_tree<2, 0, 2>(K, term);
    case 4: return reg_tree<4, 0, 4>(K, term);
    case 8: return reg_tree<8, 0, 8>(K, term);
    case 16: return reg_tree<16, 0, 16>(K, term);
    default: return reg_tree<32, 0, 32>(K, term);
  }
}
static_assert(REG_SUM_BX == 32, "reg_sum's cases run to bx = 32");
#endif

#ifndef W4_TORCH_CPU
inline long long last_pow2(long long n) {
  long long p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// setReduceConfig's plan for an (n, K) float32 tensor reduced over K, its
// rows contiguous (mnt_wrapper<float>::MAX_NUM_THREADS = 512, the warp 32
// lanes, a load of four from 128 elements on).  A row of 256 or more values
// a thread after the warps' split, on few rows (K above 130,000 and n at
// most a few hundred on the H100), is split across blocks (ctas > 1).
inline cudaError_t sum_plan(long long K, long long n, SumPlan* P) {
  constexpr int MNT = 512, WARP = 32;
  const int vec = K >= 128 ? 4 : 1;
  const long long dim0 = K / vec;
  const int d0 = dim0 < MNT ? (int)last_pow2(dim0) : MNT;
  const int d1 = n < MNT ? (int)last_pow2(n) : MNT;
  int bx = d0 < WARP ? d0 : WARP;
  const int by = d1 < MNT / bx ? d1 : MNT / bx;
  bx = d0 < MNT / by ? d0 : MNT / by;
  const long long per = (K + bx - 1) / bx;      // values_per_thread()
  const bool split = per >= (by * 16 < 256 ? by * 16 : 256);
  *P = {vec, bx, split ? by : 1, 1, nullptr};
  if (!split) return cudaSuccess;
  int dev = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return err;
  const long long per2 = (K + (long long)bx * by - 1) / ((long long)bx * by);
  const long long target = (long long)sms * (threads / (bx * by));
  if (per2 < 256 || n > target) return cudaSuccess;
  const long long c1 = (target + n - 1) / n, c2 = (per2 + 15) / 16, c3 = (per2 + 255) / 256;
  const long long ctas = (c1 < c2 ? c1 : c2) > c3 ? (c1 < c2 ? c1 : c2) : c3;
  if (ctas > 0x7FFFFFFF) return cudaErrorInvalidValue;
  P->ctas = (int)ctas;
  return cudaSuccess;
}

#endif

// ---------------------------------------------------------------------------
// torch.sum over the middle dimension of an (n, K, 3) float32 tensor: the
// engine's sum_to of a gradient that a (n, 1, 3) operand broadcast over K
// hands back (core/rng.py caps_geometry's origin[..., None, :])
// ---------------------------------------------------------------------------

#ifdef W4_TORCH_CPU
// torch's CPU sum of a column of K terms (no vector lanes across the
// three outputs: the scalar row_sum), added to the zeroed output.
template <class Term>
__device__ __forceinline__ float outer_sum(const SumPlan&, int K, Term term) {
  float lane;
  cpu_row_sum(K, 1, term, &lane);
  return 0.0f + lane;
}
#else
// On the card the reduced dimension is not the fastest moving, so
// setReduceConfig maps its block's lanes to the outputs; a thread takes
// the K terms of its output into four accumulators (lane_sum, one lane),
// unless values_per_thread() reaches block_height * 16 or 256, when the
// block's warps split the terms (by, each a stride of by) and add their
// sums by block_y_reduce's halving tree (aten_sum of bx 1).
template <class Term>
__device__ __forceinline__ float outer_sum(const SumPlan& S, int K, Term term) {
  return aten_sum(S, 0, K, term);
}

// That plan for n rays of K terms (3 n outputs): {1, 1, by, 1}.  A plan
// whose warps would still take 256 terms or more (K above ~4,080), which
// ATen splits across blocks, is refused: the diffuse backward then leaves
// those sums to its wrapper, which takes them with ATen's own op.
inline cudaError_t outer_plan(long long K, long long n, SumPlan* P) {
  constexpr int MNT = 512, WARP = 32;
  const long long outs = 3 * n;
  const int d0 = outs < MNT ? (int)last_pow2(outs) : MNT;
  const int d1 = K < MNT ? (int)last_pow2(K) : MNT;
  const int bx = d0 < WARP ? d0 : WARP;
  const int bh = d1 < MNT / bx ? d1 : MNT / bx;
  const bool split = K >= (long long)bh * 16 || K >= 256;
  *P = {1, 1, split ? bh : 1, 1, nullptr};
  if (split && (K + bh - 1) / bh >= 256) return cudaErrorInvalidValue;
  return cudaSuccess;
}
#endif

}  // namespace torch_sum
