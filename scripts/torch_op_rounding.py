#!/usr/bin/env python3
"""How torch rounds the ops W4 restates, on one CUDA device.

    python3 scripts/torch_op_rounding.py [--out OUT.json]

csrc/wavefront_shade.cu computes the plain shading blocks' ops as torch
computes them on the card, bit for bit.  This script holds each of those
ops against the candidate formulas W4 could restate, on 2**22 random
elements (2**18 rows for the sums over k), and reports the share of
elements whose bits agree with each candidate (1.0: the rule):
- torch.sum over a last dimension of 3 (x, y, z orders), and over k =
  1-200 against ATen's reduction tree (b lanes, the largest power of two
  <= k up to `bmax`, four accumulators a lane, halving offsets; bmax 8,
  16, 32); over k = 1-20,000 on n = 1-2**18 rows against `aten_sum`,
  the plan and order csrc/wavefront_shade.cu restates for every k
  (`sum_plan`, `aten_sum`); and over k = 131,072-2,200,000 on n = 2-512
  rows, where ATen splits a row across blocks, against both orders in
  which the last block could add the blocks' sums (the warps' tree then
  the lanes', or the lanes' then the warps');
- torch.linalg.vector_norm and linalg.cross against sums of squares and
  fma-contracted products (fma through float64);
- a division by a Python number against a true division and a product
  with the float reciprocal;
- torch.clamp_min / clamp of -0.0 and NaN;
- torch.cos, sin, exp, pow (5 and a tensor), atan2, asin, floor and the
  float -> int32 conversion against the same functions in a kernel that
  nvcc builds here with the port's flags (build/op_rounding/); asin on
  all 2**32 floats, atan2 on 2**26 pairs of random bit patterns and on
  every pair of +-0, +-inf, NaN, subnormals and a few normals (counts of
  elements whose bits differ, NaN against NaN agreeing);
- torch.sign of -0.0, +0.0 and NaN (its bits);
- an (N, 3) @ (3, 3) float32 product (the normal maps' plane and box
  branch, ops/hit_attrs.py `_apply_normal_maps`; cuBLAS on the card),
  against the orders W5 could restate (`mm3_candidates`), on rows with
  signed zeros, at several N and with the (3, 3) operand contiguous and
  a transposed view: the candidates that give every row's bits.
- the derivative formulas autograd runs for the refractive block's
  backward (csrc/wavefront_shade_bwd.cu restates them), each against the
  formulas it could be (`backward_rules`): a quotient's gradient for its
  divisor, a division by a 0-dim tensor (core/safemath.py `div`), sqrt's,
  exp's and pow(x, 2)'s, the masks of clamp_min and clamp at their
  bounds (and at -0 and NaN), the +0 a where hands its other branch and a
  select its pads, gather's 0 + g, the sum of an (N, 1) factor's (N, 3)
  gradient, a broadcast row's (torch.sum over the rows: the engine's
  sum_to), and the order the engine adds three contributions to one
  tensor (the node created last first); for W4's diffuse and glossy
  backward (csrc/wavefront_diffuse_bwd.cu, wavefront_glossy_bwd.cu) the
  engine's sum_to over K of an (N, K, 3) gradient (K = 2, Cornell's caps;
  131, the lamps; 300, past ATen's split of the terms over warps) against
  the orders csrc/aten_sum.cuh `outer_sum` restates, reciprocal's,
  vector_norm's and cross's gradients, pow(x, 5)'s and pow(b, a)'s for
  base and exponent (with their masks at a = 0 and b = 0) and logf
  against torch.log.
`--only matmul3` or `--only backward` runs that part alone.
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 22
OPS = ("cos", "sin", "exp", "pow", "atan2", "asin", "floor", "to_int", "log")
KERNEL = r"""
#include <cuda_runtime.h>
#include <math.h>
__global__ void op_k(int op, const float* x, const float* y, float* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = x[i], b = y[i];
  float r = 0.0f;
  switch (op) {
    case 0: r = cosf(a); break;
    case 1: r = sinf(a); break;
    case 2: r = expf(a); break;
    case 3: r = powf(a, b); break;
    case 4: r = atan2f(a, b); break;
    case 5: r = asinf(a); break;
    case 6: r = floorf(a); break;
    case 7: r = __int_as_float((int)a); break;
    case 8: r = logf(a); break;
  }
  out[i] = r;
}
extern "C" int op(int op, const float* x, const float* y, float* out, long long n) {
  op_k<<<(n + 255) / 256, 256>>>(op, x, y, out, n);
  return (int)cudaDeviceSynchronize();
}
"""


def tree_sum(torch, z, k, bmax, vt0=4):
    """ATen's reduction of z's last dimension (k wide) as a tree: b lanes,
    lane j the elements j, j + b, ... into vt0 accumulators in turn, the
    accumulators in order, then halving offsets."""
    b = 1
    while 2 * b <= k and 2 * b <= bmax:
        b *= 2
    lanes = []
    for j in range(b):
        acc = [torch.zeros_like(z[:, 0]) for _ in range(vt0)]
        for c, e in enumerate(range(j, k, b)):
            acc[c % vt0] = acc[c % vt0] + z[:, e]
        v = acc[0]
        for a in acc[1:]:
            v = v + a
        lanes.append(v)
    off = b // 2
    while off >= 1:
        lanes = [lanes[t] + lanes[t + off] for t in range(off)]
        off //= 2
    return lanes[0]


def last_pow2(n):
    p = 1
    while 2 * p <= n:
        p *= 2
    return p


def sum_plan(k, n, sms=132, threads=2048):
    """(vec, bx, by, ctas) of ATen's reduction of an (n, k) float32 tensor
    over k (Reduce.cuh setReduceConfig; csrc/wavefront_shade.cu
    `sum_plan`); ctas > 1 where it splits a row across blocks."""
    mnt = 512
    vec = 4 if k >= 128 else 1
    d0 = last_pow2(k // vec) if k // vec < mnt else mnt
    d1 = last_pow2(n) if n < mnt else mnt
    bx = min(d0, 32)
    by = min(d1, mnt // bx)
    bx = min(d0, mnt // by)
    per = -(-k // bx)
    if per < min(by * 16, 256):
        return vec, bx, 1, 1
    per2 = -(-k // (bx * by))
    target = sms * (threads // (bx * by))
    ctas = 1
    if per2 >= 256 and n <= target:
        ctas = max(min(-(-target // n), -(-per2 // 16)), -(-per2 // 256))
    return vec, bx, by, ctas


def aten_sum(torch, z, sms=132, threads=2048, last="yx"):
    """torch.sum(z, -1) of an (n, k) float32 tensor as
    csrc/wavefront_shade.cu `aten_sum` restates ATen's order: each lane's
    terms into four accumulators (from k = 128 four a load from the row's
    first 16-byte boundary), then halving trees over the lanes and the
    warps.  Split across ctas blocks, each block's sum so, and the last
    block's thread x + y bx folding the block sums x + y bx, then every
    bx by-th, into 0; then its trees, the warps' then the lanes' (last
    "yx", as csrc/wavefront_shade.cu restates global_reduce) or the
    lanes' then the warps' ("xy")."""
    n, k = z.shape
    vec, bx, by, ctas = sum_plan(k, n, sms, threads)
    out = torch.empty(n, dtype=z.dtype, device=z.device)
    rows = torch.arange(n, device=z.device)
    nl = bx * by * ctas                      # lane l = x + y bx + c bx by
    lanes = torch.arange(nl, device=z.device)
    x_of = lanes % bx
    ends = lanes < bx                        # warp 0 of block 0

    def halve(v, dim):
        # the halving tree along dim: t and t + w/2, then t and t + w/4, ...
        while v.shape[dim] > 1:
            h = v.shape[dim] // 2
            v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
        return v.squeeze(dim)

    def spread(w, loads):
        # w (m, loads, q) -> (m, J, nl, q): lane l's loads l, l + nl, ...
        # (zero past the last: adding +0 to a sum that is not -0 is exact)
        m, q = w.shape[0], w.shape[2]
        J = max(1, -(-loads // nl))
        pad = w.new_zeros((m, J * nl, q))
        pad[:, :loads] = w
        return pad.reshape(m, J, nl, q)

    for s in (range(4) if vec == 4 else (0,)):
        sel = rows[(rows * k) % 4 == s] if vec == 4 else rows
        if sel.numel() == 0:
            continue
        zs = z[sel]
        m = sel.numel()
        acc = zs.new_zeros((m, nl, 4))
        if vec == 1:
            # the q-th term of a lane into accumulator q % 4
            w = spread(zs[:, :, None], k)[..., 0]
            for q in range(w.shape[1]):
                acc[:, :, q % 4] = acc[:, :, q % 4] + w[:, q]
        else:
            end, off = k, 0
            if s > 0:
                head = ends & (x_of >= s) & (x_of < 4)
                acc[:, head, 0] = 0.0 + zs[:, x_of[head] - s]
                end, off = k + s - 4, 4 - s
            loads = end // 4
            w = spread(zs[:, off:off + loads * 4].reshape(m, loads, 4), loads)
            for j in range(w.shape[1]):
                acc = acc + w[:, j]
            t = end - end % 4 + x_of
            tail = ends & (t < end)
            acc[:, tail, 0] = acc[:, tail, 0] + zs[:, off + t[tail]]
        lane = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
        # each block's sum: the lanes' tree, then the warps'
        staged = halve(halve(lane.reshape(m, ctas, by, bx), 3), 2)
        if ctas == 1:
            out[sel] = staged[:, 0]
            continue
        # the last block: thread x + y bx folds the block sums x + y bx,
        # then every bx by-th, into 0
        fold = spread(staged[:, :, None], ctas)[..., 0]
        v = zs.new_zeros((m, bx * by))
        for f in range(fold.shape[1]):
            v = v + fold[:, f, :bx * by]
        v = v.reshape(m, by, bx)
        out[sel] = (halve(halve(v, 1), 1) if last == "yx"
                    else halve(halve(v, 2), 1))
    return out


MM3_ROWS = (1, 2, 3, 5, 8, 10, 11, 16, 17, 100, 1000, 1 << 16, 1 << 20,
            1_920_000, 4_160_000)


def mm3_candidates(torch, a, M):
    """{name: (N, 3)} the orders in which a @ M (a (N, 3), M (3, 3)) could
    be summed: r_c = a_0 M[0, c] + a_1 M[1, c] + a_2 M[2, c], fused
    (fma through float64: the product is exact there) or not, from 0 or
    from the first product, in k order or reversed."""
    A = [a[:, k:k + 1] for k in range(3)]
    B = [M[k][None, :] for k in range(3)]
    p = [A[k] * B[k] for k in range(3)]
    zero = torch.zeros_like(p[0])

    def fma(x, y, z):
        return (x.double() * y.double() + z.double()).float()

    return {
        "fma(a2,b2,fma(a1,b1,fma(a0,b0,0)))": fma(A[2], B[2], fma(A[1], B[1],
                                                                  fma(A[0], B[0], zero))),
        "fma(a2,b2,fma(a1,b1,a0*b0))": fma(A[2], B[2], fma(A[1], B[1], p[0])),
        "((0+a0b0)+a1b1)+a2b2": ((zero + p[0]) + p[1]) + p[2],
        "(a0b0+a1b1)+a2b2": (p[0] + p[1]) + p[2],
        "fma(a0,b0,fma(a1,b1,fma(a2,b2,0)))": fma(A[0], B[0], fma(A[1], B[1],
                                                                  fma(A[2], B[2], zero))),
        "fma(a0,b0,fma(a1,b1,a2*b2))": fma(A[0], B[0], fma(A[1], B[1], p[2])),
        "(a0b0+(a1b1+a2b2))": p[0] + (p[1] + p[2]),
    }


def mm3_rule(torch, dev, g, rows=MM3_ROWS):
    """{"N layout": [the candidates every row of which agrees]} for
    (m * 2.0) @ basis, m (N, 3) in [-0.5, 0.5] with 30% zeros (half of them
    -0), basis a (3, 3) with a +0 and a -0, contiguous or a transposed
    view (the plane branch passes basis.T of a stacked matrix, the box
    branch a row of the box table)."""
    out = {}
    for n in rows:
        m = torch.rand(n, 3, device=dev, generator=g) - 0.5
        z = torch.rand(n, 3, device=dev, generator=g) < 0.3
        neg = torch.rand(n, 3, device=dev, generator=g) < 0.5
        m = torch.where(z, torch.where(neg, -0.0, 0.0), m)
        B = torch.randn(3, 3, device=dev, generator=g)
        B[0, 1], B[1, 2], B[2, 0] = 0.0, -0.0, 0.0
        a = m * 2.0
        for lay, M in (("contiguous", B), ("transposed", B.T.contiguous().T)):
            got = a @ M
            same = lambda v: bool((got.view(torch.int32) == v.view(torch.int32)).all())
            out[f"{n} {lay}"] = [k for k, v in mm3_candidates(torch, a, M).items()
                                 if same(v)]
    return out


def outer_sum_orders(torch, z):
    """The candidate orders of torch.sum over the middle dimension of an (n,
    K, 3) tensor z (the engine's sum_to of a gradient over K): a thread's
    four accumulators over its output's K terms (term k into accumulator k
    % 4, from +0, then ((a0 + a1) + a2) + a3), and the same with the terms
    split over 16 warps (warp y the terms y, y + 16, ...) added by a halving
    tree over the warps (csrc/aten_sum.cuh `outer_sum`)."""
    def lane(ks):
        acc = [torch.zeros_like(z[:, 0]) for _ in range(4)]
        for q, k in enumerate(ks):
            acc[q % 4] = acc[q % 4] + z[:, k]
        return ((acc[0] + acc[1]) + acc[2]) + acc[3]

    K = z.shape[1]
    four = lane(range(K))
    ys = [lane(range(y, K, 16)) for y in range(16)]
    off = 8
    while off:
        ys = [ys[y] + ys[y + off] if y < off else ys[y] for y in range(len(ys))]
        off //= 2
    return {"four accumulators": four, "16 warps, halving": ys[0]}


def backward_rules(torch, dev, g, n=N, kern=None):
    """{rule: {candidate: share of elements whose bits agree}} of autograd's
    derivative formulas on `dev` (see the module doc)."""
    def rnd(*shape, scale=3.0):
        return ((torch.rand(*shape, device=dev, generator=g) * 2 - 1)
                * torch.exp(torch.randn(*shape, device=dev, generator=g) * scale))

    def share(a, b):
        eq = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
        return int(eq.sum()) / a.numel()

    def grads(f, *xs, gout):
        leaves = [x.clone().requires_grad_() for x in xs]
        return torch.autograd.grad(f(*leaves), leaves, gout)

    res = {}
    a, b, go = rnd(n), rnd(n), rnd(n)
    go[::97] = -0.0
    go[::89] = 0.0
    ga, gb = grads(lambda x, y: x / y, a, b, gout=go)
    res["div: numerator"] = {"g / b": share(ga, go / b), "g * (1 / b)": share(ga, go * (1 / b))}
    res["div: divisor"] = {"-g * ((a / b) / b)": share(gb, -go * ((a / b) / b)),
                           "-g * (a / (b * b))": share(gb, -go * (a / (b * b))),
                           "-(g * a) / (b * b)": share(gb, -(go * a) / (b * b))}
    three = torch.tensor(3.0, device=dev)
    g3, = grads(lambda x: x / three, a, gout=go)
    res["div by a 0-dim tensor"] = {"g / 3 (true)": share(g3, go / three),
                                    "g * float(1 / 3)": share(g3, go * (1.0 / 3.0))}
    x = rnd(n).abs()
    x[::101] = 0.0
    r = torch.sqrt(x)
    gs, = grads(torch.sqrt, x, gout=go)
    res["sqrt"] = {"g / (2 r)": share(gs, go / (2 * r)),
                   "(g / 2) / r": share(gs, (go / 2) / r),
                   "g * (0.5 / r)": share(gs, go * (0.5 / r))}
    e = rnd(n, scale=1.0)
    ge, = grads(torch.exp, e, gout=go)
    res["exp"] = {"g * exp(x)": share(ge, go * torch.exp(e))}
    gp, = grads(lambda v: v ** 2, a, gout=go)
    res["pow(x, 2)"] = {"g * (2 x)": share(gp, go * (2 * a)),
                        "(2 g) * x": share(gp, (2 * go) * a)}
    edge = torch.tensor([1e-30, 1e-31, 0.0, -0.0, float("nan"), 2e-30, -1.0, 1.0,
                         1.5, float("inf")], device=dev)
    ge_ = torch.full_like(edge, 0.75)
    gc, = grads(lambda v: torch.clamp_min(v, 1e-30), edge, gout=ge_)
    res["clamp_min(x, 1e-30) mask: g where x >= float(1e-30)"] = share(
        gc, torch.where(edge >= 1e-30, ge_, 0.0))
    gc, = grads(lambda v: torch.clamp(v, 0.0, 1.0), edge, gout=ge_)
    res["clamp(x, 0, 1) mask: g where 0 <= x <= 1"] = share(
        gc, torch.where((edge >= 0.0) & (edge <= 1.0), ge_, 0.0))
    c = torch.rand(n, device=dev, generator=g) < 0.5
    neg = torch.full((n,), -1.0, device=dev)
    gw1, gw2 = grads(lambda u, v: torch.where(c, u, v), a, b, gout=neg)
    res["where hands the other branch +0"] = bool(
        (gw1[~c].view(torch.int32) == 0).all() and (gw2[c].view(torch.int32) == 0).all())
    m3 = rnd(n, 3)
    gz = torch.full((n,), -0.0, device=dev)
    gsel, = grads(lambda v: v[..., 1], m3, gout=gz)
    res["select: -0 kept, +0 pads"] = bool(
        (gsel[:, 1].view(torch.int32) == gz.view(torch.int32)).all()
        and (gsel[:, 0].view(torch.int32) == 0).all())
    idx = torch.randint(0, 3, (n, 1), device=dev, generator=g)
    gg, = grads(lambda v: torch.gather(v, -1, idx), m3, gout=gz[:, None])
    res["gather: 0 + g at the index (-0 -> +0)"] = bool((gg.view(torch.int32) == 0).all())
    s = rnd(n, 1)
    go3 = rnd(n, 3)
    _, gsum = grads(lambda u, v: u * v, m3, s, gout=go3)
    t = go3 * m3
    res["(N, 1) factor: torch.sum of its (N, 3) gradient"] = {
        "((0 + x0) + (0 + x2)) + (0 + x1)": share(gsum[:, 0], ((0 + t[:, 0]) + (0 + t[:, 2]))
                                                 + (0 + t[:, 1])),
        "((0 + x0) + x1) + x2": share(gsum[:, 0], ((0 + t[:, 0]) + t[:, 1]) + t[:, 2])}
    row, c1 = rnd(3), torch.rand(n, 1, device=dev, generator=g) < 0.5
    _, grow = grads(lambda u, v: torch.where(c1, u, v[None, :]), m3, row, gout=go3)
    res["a broadcast row's gradient: torch.sum over the rows"] = share(
        grow, torch.sum(torch.where(c1, 0.0, go3), 0))
    k1, k2, k3 = rnd(n), rnd(n), rnd(n)
    g1, = grads(lambda v: (v * k1 + v * k2) + v * k3, a, gout=go)
    p1, p2, p3 = go * k1, go * k2, go * k3
    res["three contributions: the engine's order"] = {
        "(p3 + p2) + p1 (last made first)": share(g1, (p3 + p2) + p1),
        "(p1 + p2) + p3": share(g1, (p1 + p2) + p3)}
    # W4's diffuse and glossy backward (csrc/wavefront_diffuse_bwd.cu,
    # csrc/wavefront_glossy_bwd.cu)
    for K in (2, 131, 300):
        rows = n // (64 * K) or 1
        o, C, gk = rnd(rows, 3), rnd(K, 3), rnd(rows, K, 3)
        gk[:, ::3] = 0.0
        go_, = grads(lambda v: C - v[:, None, :], o, gout=gk)
        res[f"sum_to over K = {K} of an (N, K, 3) gradient"] = {
            k: share(go_, v) for k, v in outer_sum_orders(torch, -gk).items()}
    x = rnd(n)
    gr, = grads(torch.reciprocal, x, gout=go)
    r = torch.reciprocal(x)
    res["reciprocal"] = {"-g * (r * r)": share(gr, -go * (r * r)),
                         "-(g * r) * r": share(gr, -(go * r) * r)}
    v3 = rnd(n // 4, 3)
    v3[::50] = 0.0
    gn = rnd(n // 4, 1)
    gv, = grads(lambda t: torch.linalg.vector_norm(t, dim=-1, keepdim=True), v3, gout=gn)
    nv = torch.linalg.vector_norm(v3, dim=-1, keepdim=True)
    res["vector_norm"] = {"g * (v / n), 0 where n == 0": share(
        gv, gn * (v3 / nv).masked_fill(nv == 0, 0)), "v * (g / n)": share(gv, v3 * (gn / nv))}
    a3, b3, g3_ = rnd(n // 4, 3), rnd(n // 4, 3), rnd(n // 4, 3)
    ga, gb = grads(lambda p, q: torch.linalg.cross(p, q, dim=-1), a3, b3, gout=g3_)
    res["cross: a's cross(b, g), b's cross(g, a)"] = [
        share(ga, torch.linalg.cross(b3, g3_, dim=-1)),
        share(gb, torch.linalg.cross(g3_, a3, dim=-1))]
    base = torch.rand(n, device=dev, generator=g)
    base[::37] = 0.0
    base[::41] = 1.0
    expo = torch.rand(n, device=dev, generator=g) * 2000
    expo[::43] = 0.0
    g5, = grads(lambda t: torch.pow(t, 5), base, gout=go)
    four = kern("pow", base, torch.full_like(base, 4.0)) if kern else torch.pow(base, 4.0)
    res["pow(x, 5)"] = {"g * (5 * powf(x, 4))": share(g5, go * (5.0 * four))}
    gpb, gpa = grads(torch.pow, base, expo, gout=go)
    pw = torch.pow(base, expo)
    lg = kern("log", base) if kern else torch.log(base)
    res["pow(b, a): base"] = {"where(a == 0, 0, g * (a * pow(b, a - 1)))": share(
        gpb, torch.where(expo == 0, 0.0, go * (expo * torch.pow(base, expo - 1))))}
    res["pow(b, a): exponent"] = {"g * where(b == 0 & a >= 0, 0, r * logf(b))": share(
        gpa, go * torch.where((base == 0) & (expo >= 0), 0.0, pw * lg))}
    if kern:
        res["log"] = share(torch.log(base), kern("log", base))
    return res


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--only", choices=("matmul3", "backward"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from raytracer_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = ROOT / "build" / "op_rounding"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ops.cu").write_text(KERNEL)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "ops.so"), str(out_dir / "ops.cu")],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out_dir / "ops.so"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=3.0):
        return ((torch.rand(*shape, device=dev, generator=g) * 2 - 1)
                * torch.exp(torch.randn(*shape, device=dev, generator=g) * scale))

    def share(a, b):
        return int((a.view(torch.int32) == b.view(torch.int32)).sum()) / a.numel()

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    def sq(t):
        return torch.sqrt(t.double()).float()

    def kern(op, a, b=None):
        b = torch.zeros_like(a) if b is None else b
        out = torch.empty_like(a)
        torch.cuda.synchronize()
        err = lib.op(OPS.index(op), ctypes.c_void_p(a.data_ptr()),
                     ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                     ctypes.c_longlong(a.numel()))
        if err:
            raise RuntimeError(f"{op}: CUDA error {err}")
        return out

    res = {"device": smi, "torch": torch.__version__}
    if args.only == "backward":
        res["backward"] = backward_rules(torch, dev, g, kern=kern)
        return emit(res, args.out)
    res["matmul3"] = mm3_rule(torch, dev, g)
    res["matmul_allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    if args.only:
        return emit(res, args.out)
    x = rnd(N, 3)
    x0, x1, x2 = x.unbind(-1)
    s = torch.sum(x, dim=-1)
    res["sum3"] = {"(x+y)+z": share(s, (x0 + x1) + x2),
                   "(x+z)+y": share(s, (x0 + x2) + x1),
                   "x+(y+z)": share(s, x0 + (x1 + x2))}
    nv = torch.linalg.vector_norm(x, dim=-1)
    res["vector_norm"] = {
        "sqrt((xx+zz)+yy)": share(nv, sq((x0 * x0 + x2 * x2) + x1 * x1)),
        "sqrt((xx+yy)+zz)": share(nv, sq((x0 * x0 + x1 * x1) + x2 * x2)),
        "sqrt(fma chain)": share(nv, sq(fma(x2, x2, fma(x1, x1, x0 * x0))))}
    w = rnd(N, 3, scale=0.5)
    cr = torch.linalg.cross(x, w, dim=-1)
    res["cross"] = {}
    for comp, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        p, q = x[:, i] * w[:, j], x[:, j] * w[:, i]
        res["cross"][comp] = {"p-q": share(cr[:, comp], p - q),
                              "fma(ai,bj,-q)": share(cr[:, comp],
                                                     fma(x[:, i], w[:, j], -q))}
    res["sum_k"] = {}
    for k in list(range(1, 40)) + [63, 64, 65, 127, 128, 200]:
        z = rnd(N // 16, k)
        sk = torch.sum(z, -1)
        res["sum_k"][k] = {f"tree b<={bmax}": share(sk, tree_sum(torch, z, k, bmax))
                           for bmax in (8, 16, 32)}
    props = torch.cuda.get_device_properties(dev)
    sms, threads = props.multi_processor_count, props.max_threads_per_multi_processor
    res["sum_k_aten"] = {}
    for k in (1, 3, 5, 31, 64, 100, 127, 128, 129, 130, 131, 200, 255, 256,
              257, 1000, 1001, 4099, 8160, 8161, 9000, 20000):
        for n in (1, 2, 5, 15, 16, 600, 1 << 14, 1 << 18):
            if n * k > 1 << 27 or sum_plan(k, n, sms, threads)[3] > 1:
                continue
            z = rnd(n, k)
            res["sum_k_aten"][f"{k}x{n}"] = share(
                torch.sum(z, -1), aten_sum(torch, z, sms, threads))
    # rows split across blocks: ctas 2-33 (ctas > bx at 16 x 300,000 and
    # 2 x 2,200,000, where the two orders of the last block's trees differ)
    res["sum_k_split"] = {}
    for k, n in ((131072, 512), (150000, 300), (200000, 64), (131072, 8),
                 (300000, 16), (2200000, 2), (1000000, 5)):
        plan = sum_plan(k, n, sms, threads)
        z = rnd(n, k)
        want = torch.sum(z, -1)
        res["sum_k_split"][f"{k}x{n}"] = {
            "plan": list(plan),
            **{order: share(want, aten_sum(torch, z, sms, threads, order))
               for order in ("yx", "xy")}}
    xs = rnd(N)
    inv = (torch.tensor(1.0) / torch.tensor(math.pi, dtype=torch.float32)).item()
    res["div_by_python_number"] = {
        "true": share(xs / math.pi, xs / torch.tensor(math.pi, device=dev)),
        "times float reciprocal": share(xs / math.pi, xs * torch.tensor(inv, device=dev))}
    zz = torch.tensor([-0.0, float("nan")], device=dev)
    res["clamp_min(-0, 0), clamp(-0, 0, 1): sign bits"] = [
        torch.signbit(torch.clamp_min(zz, 0.0))[0].item(),
        torch.signbit(torch.clamp(zz, 0.0, 1.0))[0].item()]
    res["clamp of NaN is NaN"] = bool(torch.isnan(torch.clamp(zz, 0.0, 1.0))[1])

    ang = (torch.rand(N, device=dev, generator=g) * 2 - 1) * 1e4
    base = torch.rand(N, device=dev, generator=g)
    expo = torch.rand(N, device=dev, generator=g) * 2000
    u = torch.rand(N, device=dev, generator=g) * 2 - 1
    v = torch.rand(N, device=dev, generator=g) * 2 - 1
    e = (torch.rand(N, device=dev, generator=g) * 2 - 1) * 80
    big = torch.cat([rnd(N) * 1e3, torch.tensor([1e30, -1e30, float("nan")],
                                                device=dev)])
    res["libdevice"] = {
        "cos": share(torch.cos(ang), kern("cos", ang)),
        "sin": share(torch.sin(ang), kern("sin", ang)),
        "exp": share(torch.exp(e), kern("exp", e)),
        "pow(x, 5)": share(torch.pow(base, 5), kern("pow", base,
                                                  torch.full_like(base, 5.0))),
        "pow(x, a)": share(torch.pow(base, expo), kern("pow", base, expo)),
        "atan2": share(torch.atan2(u, v), kern("atan2", u, v)),
        "asin": share(torch.asin(u), kern("asin", u)),
        "floor": share(torch.floor(big), kern("floor", big)),
        "to int32": share(big.to(torch.int32).view(torch.float32),
                          kern("to_int", big))}
    # asin on every float; atan2 on random bit patterns and special pairs
    def bits_differ(a, b):
        return int((~((a.view(torch.int32) == b.view(torch.int32))
                      | (torch.isnan(a) & torch.isnan(b)))).sum())

    bad = 0
    for lo in range(0, 1 << 32, 1 << 28):
        x = (torch.arange(lo, lo + (1 << 28), device=dev, dtype=torch.int64)
             .to(torch.int32).view(torch.float32))
        bad += bits_differ(torch.asin(x), kern("asin", x))
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                            1e-45, -1e-45, 1e-39, -1e-39, 1.1754942e-38, 1.0,
                            -1.0, 0.5, -3.0, 1e30, -1e-30], device=dev)
    sy, sx = torch.meshgrid(special, special, indexing="ij")
    gb = torch.Generator(device=dev).manual_seed(7)
    ry = torch.randint(-(1 << 31), 1 << 31, (1 << 26,), device=dev, generator=gb,
                       dtype=torch.int64).to(torch.int32).view(torch.float32)
    rx = torch.randint(-(1 << 31), 1 << 31, (1 << 26,), device=dev, generator=gb,
                       dtype=torch.int64).to(torch.int32).view(torch.float32)
    res["asin_all_floats_differing"] = bad
    res["atan2_differing"] = {
        "random bits": bits_differ(torch.atan2(ry, rx), kern("atan2", ry, rx)),
        "special pairs": bits_differ(torch.atan2(sy.flatten(), sx.flatten()),
                                     kern("atan2", sy.flatten(), sx.flatten())),
        "pairs": int(ry.numel() + sy.numel())}
    sg = torch.sign(torch.tensor([-0.0, 0.0, float("nan")], device=dev))
    res["sign(-0, +0, nan)"] = [repr(v) for v in sg.tolist()] + [
        bool(torch.signbit(sg[0]))]
    res["backward"] = backward_rules(torch, dev, g, kern=kern)
    return emit(res, args.out)


def emit(res, out):
    line = json.dumps(res)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
