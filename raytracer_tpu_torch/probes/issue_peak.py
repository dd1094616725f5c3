"""P1: the FP32 issue peak of the card and the slot cost of special ops.

Counterpart of scripts/vpu_peak.py (`measure` / `make_kernel`, pallas_call
:117; `measure_kernel` / `make_chain_kernel`, pallas_call :176); kernels
in csrc/probe_issue.cu.  The same trees (32 leaves, constants from
np.random.default_rng(11)), the same chains (K x D, constants from
default_rng(7)), the same statement counts and renormalisation, compiled
as the render kernels are (IEEE division and sqrt, --fmad=false): the
unfused rate the render kernels run at.  The fused peak comes from the
streamed chains of probes/roofline.py, whose kernels share this source.

Rates are lane-ops/s counted as the script counts them (an fma leaf is 2
ops, a transcendental 1).  The slot cost of a special op relative to one
unfused FP32 instruction is solved from its tree's time against the fma
tree's (`slot_cost`).  The input varies from element to element around
the script's 1.0001, and every timed kernel is held against its plain
version at the timed shape.

    python -m raytracer_tpu_torch.probes.issue_peak [statements] [grid]
"""

from __future__ import annotations

import ctypes
import json
import re
import sys

import numpy as np
import torch

from ..ops.cuda_build import library_path
from . import common

TILE = 128 * 128
P = 32
# ops per leaf as vpu_peak.py counts them, and how many of those are the
# operation being calibrated
OPS_PER_LEAF = {"fma": 2, "div": 2, "sqrt": 2, "rsqrt": 2, "exp": 2,
                "sin": 4, "select": 3, "convert": 6, "mask": 6}
N_SPECIAL = {"convert": 2, "mask": 2}
OPS = tuple(OPS_PER_LEAF)                     # csrc/probe_issue.cu enum Op
SPECIAL = ("select", "div", "sqrt", "rsqrt", "exp", "sin", "convert", "mask")
CHAINS = ((8, 8), (16, 8), (16, 16), (32, 4))
SOURCE = "probe_issue.cu"


def tree_consts(op):
    """(3, 32) float32 per-leaf constants (a, b, e) of `op`'s leaves, each
    a python-float expression of vpu_peak.py `_leaves` rounded to float32
    as JAX rounds weakly typed floats."""
    rng = np.random.default_rng(11)
    cs = 1.0 + 0.01 * rng.standard_normal(P)
    ds = 0.01 * rng.standard_normal(P)
    z = np.zeros(P)
    a, b, e = {"fma": (cs, ds, z), "div": (cs, 2.0 + ds, z), "sqrt": (cs * cs, z, z),
               "rsqrt": (cs * cs, z, z), "exp": (cs, z, z),
               "sin": (cs, ds, z), "select": (cs, ds, cs + ds),
               "convert": (cs, ds, z), "mask": (cs, ds, cs + 0.5)}[op]
    return np.stack([a, b, e]).astype(np.float32)


def chain_consts(K, D):
    """(c, d) float32 (K, D) constants of vpu_peak.py make_chain_kernel."""
    rng = np.random.default_rng(7)
    cs = 1.0 + 0.01 * rng.standard_normal((K, D))
    ds = 0.01 * rng.standard_normal((K, D))
    return cs.astype(np.float32), ds.astype(np.float32)


def tree_ops_per_element(op, statements):
    """vpu_peak.py's ops count: P leaves, P - 1 tree products and the 2
    renormalising ops per statement."""
    return statements * (P * OPS_PER_LEAF[op] + (P - 1) + 2)


def chain_ops_per_element(K, D, statements):
    return statements * (K * D * 2 + (K - 1) + 3)


def slot_cost(op, fma_ms, ms):
    """Slots of one `op` relative to a 1-slot operation: a statement of
    `op`'s tree takes ms / fma_ms times the fma tree's statement slots;
    less its 1-slot ops, over its special ops.

    vpu_peak.py:218-225 scales the fma statement by the ratio of the two
    trees' lane-op rates, which equals the time ratio only where a leaf
    counts 2 ops as the fma leaf does (div, sqrt, rsqrt, exp): for sin,
    select, convert and mask it understates the statement by the ratio
    of their counts (4, 3, 6, 6 over 2), which drove convert's and
    mask's solves below 0."""
    ns = N_SPECIAL.get(op, 1)
    n_1slot = P * (OPS_PER_LEAF[op] - ns) + (P - 1) + 2
    per_stmt = ms / fma_ms * (P * OPS_PER_LEAF["fma"] + (P - 1) + 2)
    return (per_stmt - n_1slot) / (P * ns)


def _leaf(op, x, a, b, e):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    if op == "fma":
        return x * a + b
    if op == "div":
        return a / (x + b)
    if op == "sqrt":
        return torch.sqrt(x * a)
    if op == "rsqrt":
        return torch.rsqrt(x * a)
    if op == "exp":
        return torch.exp((x - one) * a)
    if op == "sin":
        return one + torch.tensor(0.1, dtype=x.dtype, device=x.device) * torch.sin(x * a + b)
    if op == "select":
        return torch.where(x > a, x + b, e)
    if op == "convert":
        v = ((x * a + b) * torch.tensor(256.0, device=x.device)).to(torch.int32)
        return v.to(torch.float32) * torch.tensor(1.0 / 256.0, device=x.device)
    m = (x > a) & (x < e) & (x > b)
    return torch.where(m, x, a.expand_as(x))


def _tree_reduce(vals, combine):
    while len(vals) > 1:
        nxt = [combine(vals[i], vals[i + 1]) for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _renorm(t, scale=None):
    one = torch.ones((), dtype=t.dtype, device=t.device)
    if scale is not None:
        t = t * scale
    return one + (t - one) * torch.tensor(0.125, device=t.device)


def tree_reference(x, op, statements):
    """The plain version of the tree kernel: float32 (n,) -> (n,)."""
    k = torch.from_numpy(tree_consts(op)).to(x.device)
    y = x
    for _ in range(statements):
        leaves = [_leaf(op, y, k[0, j], k[1, j], k[2, j]) for j in range(P)]
        y = _renorm(_tree_reduce(leaves, lambda a, b: a * b))
    return y


def chain_reference(x, K, D, statements):
    cs, ds = (torch.from_numpy(v).to(x.device) for v in chain_consts(K, D))
    inv_k = torch.tensor(1.0 / K, dtype=torch.float32, device=x.device)
    y = x
    for _ in range(statements):
        chains = []
        for c in range(K):
            v = y
            for j in range(D):
                v = v * cs[c, j] + ds[c, j]
            chains.append(v)
        y = _renorm(_tree_reduce(chains, lambda a, b: a + b), inv_k)
    return y


_F, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(x):
    common.require_card()
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 vector")


def tree(x, op, statements):
    """The tree of `op` over x: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  `tree.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return tree_reference(x, op, statements)
    _check(x)
    out = torch.empty_like(x)
    k = (ctypes.c_float * (3 * P))(*tree_consts(op).ravel().tolist())
    common.launch("probe_tree_launch", [_I, _F, _F, ctypes.POINTER(ctypes.c_float),
                                        _I, _L, _F],
                  OPS.index(op), common.ptr(x), common.ptr(out), k, statements,
                  x.numel(), common.stream(x))
    tree.launches += 1
    return out


def chain(x, K, D, statements):
    """K x D chains over x: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  `chain.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return chain_reference(x, K, D, statements)
    _check(x)
    out = torch.empty_like(x)
    cs, ds = chain_consts(K, D)
    fp = ctypes.POINTER(ctypes.c_float)
    c = (ctypes.c_float * cs.size)(*cs.ravel().tolist())
    d = (ctypes.c_float * ds.size)(*ds.ravel().tolist())
    common.launch("probe_chain_launch", [_I, _I, _F, _F, fp, fp, _I, _L, _F],
                  K, D, common.ptr(x), common.ptr(out), c, d,
                  statements, x.numel(), common.stream(x))
    chain.launches += 1
    return out


tree.launches = 0
chain.launches = 0


# SASS opcodes shown per kernel: the FP32 pipe's, the compare / select /
# min-max ones, the special-function unit's, the conversions, and the
# loads and stores of shared and local (stack) memory
SASS_OPS = ("FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "MUFU", "F2I",
            "I2F", "FRND", "LDS", "LDL", "STL")


def sass_counts(prefixes=("probe_tree", "probe_chain")):
    """{kernel: {opcode: static count}} of the probe kernels whose names
    start with `prefixes`, from cuobjdump -sass of the built library:
    the opcodes of SASS_OPS, every other instruction under "other"."""
    out = common.cuobjdump_sass(library_path("probes"))
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = None
            if m.group(1).startswith(prefixes):
                cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS + ("other",), 0))
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur is not None and m:
            opc = m.group(1)
            cur[opc if opc in cur else "other"] += 1
    return counts


def _max_err(a, b):
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    d = torch.where(a == b, 0.0, d)            # equal infinities
    return float(d.max())


# kernel against plain version: relative tolerance for ops whose CUDA
# math-library and torch forms may round differently (sinf, expf,
# rsqrtf); exact for the rest
CHECK_RTOL = 4e-6


def inputs(n, device, seed=5):
    """float32 (n,): the script's 1.0001, varied by up to +-5e-5 from
    element to element so that an indexing fault shows."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=g, device=device)
    return torch.tensor(1.0001, device=device) + (u - 0.5) * torch.tensor(1e-4, device=device)


def check(x, statements):
    """Every tree and chain kernel against its plain version on x;
    returns {name: max abs err}.  Raises past CHECK_RTOL."""
    errs = {}
    cases = [(f"tree_{op}", lambda op=op: tree(x, op, statements),
              lambda op=op: tree_reference(x, op, statements)) for op in OPS]
    cases += [(f"chain_{K}x{D}", lambda K=K, D=D: chain(x, K, D, statements),
               lambda K=K, D=D: chain_reference(x, K, D, statements))
              for K, D in CHAINS]
    for name, kern, plain in cases:
        a, b = kern(), plain()
        torch.cuda.synchronize()
        errs[name] = _max_err(a, b)
        ok = torch.isclose(a, b, rtol=CHECK_RTOL, atol=0.0, equal_nan=True)
        if not bool(ok.all()):
            raise RuntimeError(f"{name}: kernel and plain version differ "
                               f"(max abs err {errs[name]})")
        del a, b
    return errs


def run(statements=64, grid=4096, reps=3):
    """Measure on the card; returns (result dict, kernels-line rows)."""
    dev = common.require_card()
    out = {"probe": "issue_peak", **common.device_info(), "P": P,
           "grid": grid, "statements": statements}
    n = grid * TILE
    x = inputs(n, dev)
    # every timed kernel against its plain version on the timed input
    errs = check(x, statements)
    torch.cuda.empty_cache()
    tree.launches = chain.launches = 0
    rates = {}
    for K, D in CHAINS:
        ms = common.cuda_ms(lambda: chain(x, K, D, statements), reps)
        key = f"fma_chains_{K}x{D}"
        rates[key] = n * chain_ops_per_element(K, D, statements) / (ms * 1e-3)
        out[key] = {"lane_ops_per_s": rates[key], "ms": ms}
    tree_ms = {}
    for op in OPS:
        ms = common.cuda_ms(lambda: tree(x, op, statements), reps)
        tree_ms[op] = ms
        rates[op] = n * tree_ops_per_element(op, statements) / (ms * 1e-3)
        out[op] = {"lane_ops_per_s": rates[op], "ms": ms,
                   "ops_per_element": tree_ops_per_element(op, statements)}
    out["clocks_after"] = common.clocks()
    launches = {"tree": tree.launches, "chain": chain.launches}
    out["unfused_peak_lane_ops_per_s"] = max(
        [rates["fma"]] + [rates[f"fma_chains_{K}x{D}"] for K, D in CHAINS])
    slots = {op: slot_cost(op, tree_ms["fma"], tree_ms[op]) for op in SPECIAL}
    for op in SPECIAL:
        out[op]["slots_per_op"] = slots[op]
    out["slot_costs"] = slots
    out["sass"] = sass_counts()
    out["max_abs_err"] = errs
    # the plain versions at the timed shape (one run each)
    plain_ms = common.cuda_ms(lambda: tree_reference(x, "fma", statements), 1, 0)
    best_chain = max(CHAINS, key=lambda kd: rates[f"fma_chains_{kd[0]}x{kd[1]}"])
    K, D = best_chain
    chain_plain_ms = common.cuda_ms(
        lambda: chain_reference(x, K, D, statements), 1, 0)
    rows = [
        common.row("issue_tree", SOURCE, "scripts/vpu_peak.py:117",
                   launches["tree"], max(v for k, v in errs.items()
                                         if k.startswith("tree")),
                   tree_ms["fma"], plain_ms,
                   n * tree_ops_per_element("fma", statements), 8 * n),
        common.row("issue_chain", SOURCE, "scripts/vpu_peak.py:176",
                   launches["chain"], max(v for k, v in errs.items()
                                          if k.startswith("chain")),
                   out[f"fma_chains_{K}x{D}"]["ms"], chain_plain_ms,
                   n * chain_ops_per_element(K, D, statements), 8 * n)]
    out["timed_rows"] = {"issue_tree": "fma tree",
                         "issue_chain": f"{K}x{D} chains"}
    return out, rows


def main(argv):
    out, rows = run(*(int(a) for a in argv[:2]))
    out["kernels"] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
