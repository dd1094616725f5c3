"""P6: per-lane texel fetches inside a kernel.

Counterpart of scripts/probe_vmem_gather.py (`run` :85, pallas_call :92,
kernels `kernel_take` :64 and `kernel_baseline` :75, the XLA yardstick
`run_xla` :125); kernels in csrc/probe_gather.cu.  The script's shapes:
1 M rays (idx (8192, 128) from default_rng(0)), 6 fetches a ray of
table[(idx + b * 977) mod T] from T = 327 * 321 = 104,967 entries of an
arange table (821, 128).  On the TPU the fetch could not be lowered at
all and the XLA gather took ~24 ns a fetch; here: from device memory
(__ldg, the 420 KB table in L2), from shared memory (the table cut to a
block's opt-in capacity), and the no-fetch baseline.  torch.take over the
same six rounds is the library yardstick; the port never calls it.

At the script's size the table stays in L2 and the kernels take tens of
microseconds.  `run(replay_scale=(entries, elements))` also runs the
device-memory fetch and the baseline at the replay's own scale: a table of
the texture atlas's entries and one ray per (bounce, ray) element of a
record chunk, indices drawn at random over the table (the replay's own
indices follow the rays' hit points, so they are more coherent).

    python -m raytracer_tpu_torch.probes.gather [atlas entries, elements]
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from . import common

TILE_ROWS = 128
T = 327 * 321
N = 1 << 20
FETCHES, STRIDE = 6, 977
MODES = ("ldg", "smem", "base")
SOURCE = "probe_gather.cu"


def inputs(n=N, t=T):
    """(table (t // 128 + 1, 128) int32 arange, idx (n / 128, 128) int32
    in [0, t)); at the defaults the script's (821, 128) and (8192, 128)."""
    rows = t // 128 + 1
    table = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    idx = np.random.default_rng(0).integers(0, t, size=(n // 128, 128)).astype(np.int32)
    return table, idx


def gather_reference(table, idx, t_mod=T, fetch=True):
    """The plain version: per ray the float sum over b of
    table[(idx + b * 977) mod t_mod] (fetch) or of the index itself."""
    flat = table.reshape(-1)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for b in range(FETCHES):
        ix = torch.remainder(idx + b * STRIDE, t_mod)
        acc = acc + (flat[ix.long()] if fetch else ix).to(torch.float32)
    return acc


def library(table, idx, t_mod=T):
    """The same function through torch.take (the library yardstick)."""
    flat = table.reshape(-1)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for b in range(FETCHES):
        acc = acc + torch.take(flat, torch.remainder(idx + b * STRIDE, t_mod)
                               .long()).to(torch.float32)
    return acc


_V, _I = ctypes.c_void_p, ctypes.c_int


def smem_entries():
    """Table entries one block's opt-in shared memory holds on this card."""
    common.require_card()
    fn = common.load_probe_library().probe_gather_smem_entries
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


def gather(table, idx, mode="ldg", t_mod=T):
    """The six fetches (or, mode "base", the index sum) of every ray: the
    kernel for CUDA tensors, the plain version for CPU tensors.
    `gather.launches` counts kernel launches."""
    if idx.device.type == "cpu":
        return gather_reference(table, idx, t_mod, mode != "base")
    common.require_card()
    for t in (table, idx):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != idx.device:
            raise ValueError("table and idx must be contiguous int32 on one device")
    if not 0 < t_mod <= table.numel():
        raise ValueError("the modulus must be within the table")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    common.launch("probe_gather_launch", [_I, _V, _V, _V, _I, _I, _V],
                  MODES.index(mode), common.ptr(table), common.ptr(idx),
                  common.ptr(out), t_mod, idx.numel(), common.stream(idx))
    gather.launches += 1
    return out


gather.launches = 0


def at_scale(entries, elements, reps=10):
    """The device-memory fetch and the baseline over a table of `entries`
    and `elements` rays (rounded up to whole rows of 128), each held
    exactly against its plain version, torch.take beside them."""
    dev = common.require_card()
    n = -(-elements // 128) * 128
    table, idx = (torch.from_numpy(a).to(dev) for a in inputs(n, entries))
    out = {"T": entries, "table_bytes": 4 * table.numel(), "rays": n,
           "fetches": FETCHES * n}
    for mode in ("ldg", "base"):
        a = gather(table, idx, mode, entries)
        b = gather_reference(table, idx, entries, mode != "base")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"P6 {mode} at the replay's scale: kernel and "
                               "plain version differ")
        ms = common.cuda_ms(lambda: gather(table, idx, mode, entries), reps)
        out[mode] = {"ms": ms, "ns_per_fetch": ms * 1e6 / (FETCHES * n)}
    ms = common.cuda_ms(lambda: library(table, idx, entries), reps)
    out["torch_take"] = {"ms": ms, "ns_per_fetch": ms * 1e6 / (FETCHES * n)}
    return out


def run(reps=20, replay_scale=None):
    """The three kernels at the script's shapes, each held exactly against
    its plain version, torch.take beside them; and, given replay_scale =
    (atlas entries, elements), `at_scale` of them.  Returns (result dict,
    kernels-line rows)."""
    dev = common.require_card()
    table, idx = (torch.from_numpy(a).to(dev) for a in inputs())
    cut = min(T, smem_entries())
    out = {"probe": "gather", **common.device_info(), "rays": idx.numel(),
           "fetches": FETCHES * idx.numel(), "T": T, "smem_T": cut,
           "tpu_xla_ns_per_fetch": 24.0}
    mods = {"ldg": T, "smem": cut, "base": T}
    for mode in MODES:
        a = gather(table, idx, mode, mods[mode])
        b = gather_reference(table, idx, mods[mode], mode != "base")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"P6 {mode}: kernel and plain version differ")
    lib = library(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(lib, gather_reference(table, idx)):
        raise RuntimeError("P6: torch.take disagrees with the plain version")
    gather.launches = 0
    rows = []
    n_fetch = FETCHES * idx.numel()
    lib_ms = {t: common.cuda_ms(lambda: library(table, idx, t), reps)
              for t in sorted(set(mods.values()))}
    for mode in MODES:
        ms = common.cuda_ms(lambda: gather(table, idx, mode, mods[mode]), reps)
        out[mode] = {"ms": ms, "ns_per_fetch": ms * 1e6 / n_fetch,
                     "g_fetch_per_s": n_fetch / (ms * 1e-3) / 1e9}
    out["torch_take"] = {"ms": lib_ms[T], "ns_per_fetch": lib_ms[T] * 1e6 / n_fetch,
                         "ms_at_smem_T": lib_ms[cut]}
    launches = gather.launches // len(MODES)
    out["clocks_after"] = common.clocks()
    for mode in MODES:
        plain_ms = common.cuda_ms(
            lambda: gather_reference(table, idx, mods[mode], mode != "base"), 1, 0)
        # bytes: idx in and sums out, the table read once (not by base);
        # operations: per fetch an add, a remainder (~20 integer slots), a
        # convert and the float add
        tab = 0 if mode == "base" else 4 * mods[mode]
        rows.append(common.row(
            f"gather_{mode}", SOURCE, "scripts/probe_vmem_gather.py:92",
            launches, 0.0, out[mode]["ms"], plain_ms, n_fetch * 23,
            8 * idx.numel() + tab,
            lib_ms[mods[mode]] if mode != "base" else None))
    if replay_scale is not None:
        out["replay_scale"] = at_scale(*replay_scale)
    return out, rows


def main(argv):
    out, rows = run(replay_scale=tuple(int(a) for a in argv[:2]) if argv else None)
    out["kernels"] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
