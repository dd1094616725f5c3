"""P6: per-lane texel fetches inside a kernel.

Counterpart of scripts/probe_vmem_gather.py (`run` :85, pallas_call :92,
kernels `kernel_take` :64 and `kernel_baseline` :75, the XLA yardstick
`run_xla` :125); kernels in csrc/probe_gather.cu.  The script's shapes:
1 M rays (idx (8192, 128) from default_rng(0)), 6 fetches a ray of
table[(idx + b * 977) mod T] from T = 327 * 321 = 104,967 entries of an
arange table (821, 128); "mod" is the floored remainder of the int32 sum
(jnp.remainder, torch.remainder), for any int32 idx.  On the TPU the
fetch could not be lowered at all and the XLA gather took ~24 ns a fetch;
here: from device memory (ldg, the 420 KB table in L1 and L2), from
shared memory (smem: the table cut to a block's opt-in capacity, copied
once a cluster of SMs), and the no-fetch baseline (base).  torch.take
over the same six rounds is the library yardstick; the port never calls
it.

A kernel's time is the device's: `common.graph_ms` replays the wrapper's
launches from a CUDA graph, so the Python around a launch is not in it;
the time of the calls themselves (`common.cuda_ms`) is reported beside it
as the wrapper's.  At the script's size the kernels take microseconds.
`run(replay_scale=(entries, elements))` also runs them at the replay's
own scale: a table of the texture atlas's entries and one ray per
(bounce, ray) element of a record chunk, indices drawn at random over the
table (the replay's own indices follow the rays' hit points, so they are
more coherent).

    python -m raytracer_tpu_torch.probes.gather [atlas entries, elements]

runs P1 (issue_peak) first for the slot costs of the bound;
`... gather --profile` runs `profile_check` alone.
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
# probe_gather_init's plan
PLAN = ("sms", "ldg_blocks", "smem_blocks", "base_blocks", "cluster", "smem_entries")
# the edge input: a ray count that is no multiple of 4 (rays a thread) or
# of a block's rays, and the moduli it is held at (each mode at those it
# takes: smem up to its cut); every index within 4,886 of 2^31 - 1 is in it
EDGE_N = 4 * 2600 + 3
EDGE_MODULI = (1, 3, 500, 977, 978, 4885, 4886, 58108, T, 821 * 128)
INT32_MAX = 2 ** 31 - 1
# profile_check's profiler mean of base may differ from its graph time by
# this share of the latter (chip_smoke.py's cross-check)
PROFILER_TOLERANCE = 0.10
# slots of the work that are not P1's special operations: per fetch an
# index add, a compare and a float add, and (not base) the load
FETCH_SLOTS = {"ldg": 4, "smem": 4, "base": 3}


def inputs(n=N, t=T):
    """(table (t // 128 + 1, 128) int32 arange, idx (n / 128, 128) int32
    in [0, t)); at the defaults the script's (821, 128) and (8192, 128)."""
    rows = t // 128 + 1
    table = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    idx = np.random.default_rng(0).integers(0, t, size=(n // 128, 128)).astype(np.int32)
    return table, idx


def edge_inputs(n=EDGE_N):
    """(table (821, 128) int32 of values drawn over the whole int32 range,
    so that the float sums round and their order shows; idx (n,) int32):
    drawn over the whole int32 range, with negative indices, indices
    at and past every modulus of EDGE_MODULI and every index from
    2^31 - 4,887 to 2^31 - 1 (where idx + b * 977 wraps) set among them."""
    rng = np.random.default_rng(1)
    table = rng.integers(-2 ** 31, 2 ** 31, size=(821, 128)).astype(np.int32)
    idx = rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int64)
    cases = [-2 ** 31, -2 ** 31 + 1, -5000, -977, -2, -1, 0, 1, 2 ** 30]
    for t in EDGE_MODULI:
        cases += [t - 1, t, t + 1, 2 * t + 5, -t, -t - 1]
    top = np.arange(INT32_MAX - 4886, INT32_MAX + 1)
    idx[:len(cases)] = cases
    idx[len(cases) + 100:len(cases) + 100 + len(top)] = top
    return table, idx.astype(np.int32)


def edge_moduli(mode, entries):
    """The moduli of EDGE_MODULI that `mode` takes (smem: at most its
    `entries`)."""
    return tuple(t for t in EDGE_MODULI if mode != "smem" or t <= entries)


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
_plans = {}


def plan(lib=None):
    """{PLAN key: int}: the card's resident blocks for each kernel, the
    smem kernel's cluster size and table entries; probe_gather_init
    queries them (and makes the kernels' settings) once a library, so a
    launch makes no query.  lib: the probes' library unless given."""
    lib = lib or common.load_probe_library()
    if lib not in _plans:
        info = (_I * len(PLAN))()
        common.launch("probe_gather_init", [ctypes.POINTER(_I)], info, lib=lib)
        _plans[lib] = dict(zip(PLAN, info))
    return _plans[lib]


def smem_entries():
    """Table entries the smem kernel holds on this card: one block's opt-in
    shared memory less its barrier."""
    common.require_card()
    return plan()["smem_entries"]


def gather(table, idx, mode="ldg", t_mod=T):
    """The six fetches (or, mode "base", the index sum) of every ray: the
    kernel for CUDA tensors, the plain version for CPU tensors.
    `gather.launches` counts kernel launches."""
    if idx.device.type == "cpu":
        return gather_reference(table, idx, t_mod, mode != "base")
    common.require_card()
    return _launch(table, idx, mode, t_mod)


def _launch(table, idx, mode, t_mod, lib=None):
    """Launch `mode`'s kernel from `lib` (the probes' library unless given;
    the tests pass the CPU stand-in's build, csrc/emu, with CPU tensors)
    and count it in `gather.launches`."""
    for t in (table, idx):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != idx.device:
            raise ValueError("table and idx must be contiguous int32 on one device")
    if idx.data_ptr() % 16 or (mode == "smem" and table.data_ptr() % 16):
        raise ValueError("idx (and for smem the table) must be 16-byte aligned")
    p = plan(lib)
    top = min(table.numel(), p["smem_entries"]) if mode == "smem" else table.numel()
    if not 0 < t_mod <= top:
        raise ValueError(f"the modulus must be within the table (at most {top})")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel() == 0:
        return out
    common.launch("probe_gather_launch", [_I, _V, _V, _V, _I, _I, _I, _V],
                  MODES.index(mode), common.ptr(table), common.ptr(idx),
                  common.ptr(out), t_mod, idx.numel(), p[f"{mode}_blocks"],
                  common.stream(idx), lib=lib)
    gather.launches += 1
    return out


gather.launches = 0


def work(mode, rays, t_mod, costs):
    """(FP32 issue slots, bytes) the function needs, the same for every
    implementation: per fetch the FETCH_SLOTS single-slot operations, a
    select (the conditional subtract) and an int -> float convert at
    their P1 slot costs; per ray one remainder, at P1's cost of a
    division; bytes: idx in and the sums out, 4 B a ray each, and the
    table's t_mod entries read once (not by base)."""
    per_fetch = FETCH_SLOTS[mode] + costs["select"] + costs["convert"]
    slots = rays * (FETCHES * per_fetch + costs["div"])
    return slots, 8 * rays + (0 if mode == "base" else 4 * t_mod)


def hold_edge(dev, entries, lib=None):
    """Every mode against its plain version, bit for bit, on edge_inputs at
    each of its moduli; raises on a difference.  Returns the number of
    (mode, modulus) pairs held."""
    table, idx = (torch.from_numpy(a).to(dev) for a in edge_inputs())
    held = 0
    for mode in MODES:
        for t in edge_moduli(mode, entries):
            got = _launch(table, idx, mode, t, lib)
            want = gather_reference(table, idx, t, mode != "base")
            if not torch.equal(got, want):
                raise RuntimeError(f"P6 {mode}: kernel and plain version differ on the "
                                   f"edge input at T = {t} "
                                   f"({int((got != want).sum())} rays)")
            held += 1
    return held


def _measure(table, idx, mods, costs, reps, lib_ms):
    """Each mode held bit for bit against its plain version on (table,
    idx), then timed: the kernel (graph) and the wrapper (calls), its
    launches in the timing, and its bound.  mods: {mode: modulus}."""
    rays = idx.numel()
    out = {"rays": rays, "fetches": FETCHES * rays}
    for mode in MODES:
        a = gather(table, idx, mode, mods[mode])
        b = gather_reference(table, idx, mods[mode], mode != "base")
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError(f"P6 {mode} at {rays} rays: kernel and plain version "
                               "differ")
        del a, b
        call = lambda: gather(table, idx, mode, mods[mode])
        before = gather.launches
        ms, runs = common.graph_ms(call, reps)
        # the capture counted the reps launches that only the graph's runs made
        gather.launches += (runs - 1) * reps
        wrapper_ms = common.cuda_ms(call, reps)
        slots, n_bytes = work(mode, rays, mods[mode], costs)
        bound_ms, by = common.bound(slots, n_bytes)
        out[mode] = {"T": mods[mode], "ms": ms, "wrapper_ms": wrapper_ms,
                     "launches": gather.launches - before,
                     "ns_per_fetch": ms * 1e6 / (FETCHES * rays),
                     "g_fetch_per_s": FETCHES * rays / (ms * 1e-3) / 1e9,
                     "slots": slots, "bytes": n_bytes,
                     "slots_per_fetch": slots / (FETCHES * rays),
                     "bound_ms": bound_ms, "bound_by": by, "share": bound_ms / ms,
                     "library_ms": lib_ms.get(mods[mode]) if mode != "base" else None}
    out["torch_take"] = {t: ms for t, ms in lib_ms.items()}
    return out


def run(costs, reps=20, replay_scale=None):
    """The three kernels at the script's shapes, each held bit for bit
    against its plain version there and on edge_inputs, torch.take beside
    them; and, given replay_scale = (atlas entries, elements), again at the
    replay's scale.  costs: P1's `slot_costs` (issue_peak.run), whose
    select, convert and div price the bound.  Returns (result dict,
    kernels-line rows)."""
    dev = common.require_card()
    p = plan()
    cut = min(T, p["smem_entries"])
    out = {"probe": "gather", **common.device_info(), "plan": p, "T": T,
           "smem_T": cut, "tpu_xla_ns_per_fetch": 24.0,
           "costs": {k: costs[k] for k in ("select", "convert", "div")}}
    out["edge"] = {"rays": EDGE_N, "held": hold_edge(dev, p["smem_entries"])}
    table, idx = (torch.from_numpy(a).to(dev) for a in inputs())
    lib = library(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(lib, gather_reference(table, idx)):
        raise RuntimeError("P6: torch.take disagrees with the plain version")
    del lib
    gather.launches = 0
    mods = {"ldg": T, "smem": cut, "base": T}
    lib_ms = {t: common.cuda_ms(lambda: library(table, idx, t), reps)
              for t in sorted(set(mods.values()))}
    res = _measure(table, idx, mods, costs, reps, lib_ms)
    out.update(res)
    out["clocks_after"] = common.clocks()
    rows = []
    for mode in MODES:
        plain_ms = common.cuda_ms(
            lambda: gather_reference(table, idx, mods[mode], mode != "base"), 1, 0)
        r = res[mode]
        rows.append(common.row(
            f"gather_{mode}", SOURCE, "scripts/probe_vmem_gather.py:92",
            r["launches"], 0.0, r["ms"], plain_ms, r["slots"], r["bytes"],
            r["library_ms"]))
    if replay_scale is not None:
        out["replay_scale"] = at_scale(*replay_scale, costs)
    return out, rows


def at_scale(entries, elements, costs, reps=10):
    """The three kernels over a table of `entries` and `elements` rays
    (rounded up to whole rows of 128), each held bit for bit against its
    plain version, torch.take beside them (smem at its cut); costs as for
    run."""
    dev = common.require_card()
    n = -(-elements // 128) * 128
    table, idx = (torch.from_numpy(a).to(dev) for a in inputs(n, entries))
    mods = {"ldg": entries, "smem": min(entries, plan()["smem_entries"]),
            "base": entries}
    lib_ms = {t: common.cuda_ms(lambda: library(table, idx, t), reps)
              for t in sorted(set(mods.values()))}
    out = {"T": entries, "table_bytes": 4 * table.numel(),
           **_measure(table, idx, mods, costs, reps, lib_ms)}
    return out


def profile_check(reps=20):
    """base at the script's shape, timed by the graph timer and by
    torch.profiler's kernel events over `reps` calls: {"kernel_ms",
    "kernels", "calls", "graph_ms"}.  chip_smoke.py runs it in a process
    of its own (`main(["--profile"])`): there its profiler sessions before
    P6 would lose events."""
    dev = common.require_card()
    table, idx = (torch.from_numpy(a).to(dev) for a in inputs())
    call = lambda: gather(table, idx, "base")
    graph_ms, _ = common.graph_ms(call, reps)
    kernel_ms, n = common.profiled_kernel_ms(call, reps, "gather_base_kernel")
    return {"kernel_ms": kernel_ms, "kernels": n, "calls": reps, "graph_ms": graph_ms}


def main(argv):
    from . import issue_peak

    if argv[:1] == ["--profile"]:
        print(json.dumps(profile_check()))
        return
    p1, _ = issue_peak.run()
    out, rows = run(p1["slot_costs"],
                    replay_scale=tuple(int(a) for a in argv[:2]) if argv else None)
    out["kernels"] = rows
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main(sys.argv[1:])
