"""What every probe shares: the card's identity, CUDA-event timing (of the
calls, and of the kernels alone through a CUDA graph or the profiler),
clock samples, and the launch of a probe kernel through the probes'
library."""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops.cuda_build import load_probe_library, stream_of

# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# 67 TFLOP/s in float32 outside the tensor cores, counting an fma as two
# operations, so 33.5 T FP32 instruction-lanes (issue slots) a second; and
# 3.35 TB/s of HBM3
PEAK_SLOTS_PER_S = 67e12 / 2
PEAK_BYTES_PER_S = 3.35e12


def require_card():
    """The CUDA device, or RuntimeError: a measurement never falls back to
    the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the CUDA device and found none")
    return torch.device("cuda:0")


def smi(query):
    """nvidia-smi's CSV answer for `query` (e.g. "name,power.limit")."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_info():
    """The card's name as torch sees it and name + power limit as
    nvidia-smi reports them."""
    require_card()
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi("name,power.limit")}


def clocks():
    """SM clock and power draw now, e.g. "1980 MHz, 512.30 W"."""
    return smi("clocks.sm,power.draw")


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of `reps` calls of fn after `warmup` calls, timed
    with CUDA events around the whole run."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, replays=3):
    """(mean milliseconds of one call of fn as the device runs it, the
    graph's runs): fn runs once, then `reps` calls are captured in one
    CUDA graph (a launch on the current stream goes into the capture, and
    launches nothing), replayed once to warm up and then `replays` times
    between two CUDA events, over reps * replays.  The host's work in fn
    (checks, allocation, the launch call) runs at capture only."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays), 1 + replays


# Idle seconds at each end of a profiler session.  On an H100, sessions
# of 20 short calls in fresh processes without them now and then lost
# device events (2 of 240 lost all 20); with them none of 240 lost any
# (scripts/torch_profiler_edges.py).
PROFILE_PAD_S = 0.05


def profiled_events(fn, calls, pad_s=PROFILE_PAD_S):
    """The device events torch.profiler records over `calls` calls of fn,
    after one call outside the session, with `pad_s` seconds of idle
    between the session's start and the first call and between the last
    call's end and the session's stop: the profiler drops kernels that
    lie close to either edge."""
    import time

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profiled_kernel_ms(fn, calls, name):
    """(mean device milliseconds, count) of the kernels whose name holds
    `name` among `profiled_events(fn, calls)`.  A session that follows
    large ones (hundreds of thousands of device events) in the same
    process can lose events, so a check that counts them runs in a
    process of its own."""
    durs = [e.time_range.elapsed_us() for e in profiled_events(fn, calls)
            if name in e.name]
    return (sum(durs) / len(durs) / 1e3 if durs else None), len(durs)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(t):
    return stream_of(t.device)


def launch(entry, argtypes, *args, lib=None):
    """Call entry `entry` (declared with `argtypes`, returning int) of
    `lib`, the probes' library unless given; raise if it reports a CUDA
    error (cudaGetLastError() after the launch)."""
    fn = getattr(lib or load_probe_library(), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def bound(ops_slots, n_bytes):
    """(bound ms, "operations" or "bytes"): the larger of the issue-slot
    time at the published FP32 rate and the byte time at the HBM rate."""
    t_ops = ops_slots / PEAK_SLOTS_PER_S * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
        ops_slots, n_bytes, library_ms=None):
    """One entry of chip_smoke.py's kernels line."""
    b_ms, by = bound(ops_slots, n_bytes)
    return {"name": name, "route": "cuda",
            "source": f"raytracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def cuobjdump_sass(path):
    """The SASS of a built library, as `cuobjdump -sass` prints it (the
    CUDA toolkit's cuobjdump, on PATH or under CUDA_HOME)."""
    exe = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    return subprocess.run([exe, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)([^;]*);")


def loop_issue(sass, kernel, per):
    """(instructions, count of `per`) of one pass of the main loop of the
    kernel whose name holds `kernel`, read from `cuobjdump_sass` text.  The
    main loop is the backward branch whose body holds the most `per`
    instructions (the widest on a tie) among the innermost such loops: a
    loop whose body holds the head of another loop that holds `per` (an
    outer loop over chunks around an unrolled inner loop and its
    remainder) runs it a varying number of times a pass, and is not
    taken; branches back to one head are one loop.  Its instructions are
    those a pass issues on its shortest path: the body less every stretch
    that a forward branch inside it jumps over (a division's slow path, an
    update that a pass does not make).  Every instruction takes one issue
    slot of a warp scheduler, so instructions / `per` is the issue cost of
    one `per`-op's work, a full warp's lane at the FP32 rate."""
    body, branches, loops = _loops(sass, kernel, per)
    _, _, lo, hi = max(L for L in loops if not any(
        L[2] < M[2] <= L[3] for M in loops))
    return _short_path(body, branches, lo, hi, per)


def kind_loops(sass, kernel, per):
    """[(instructions, count of `per`)] of one pass of each innermost loop
    of the kernel whose name holds `kernel` that holds `per`, in address
    order, each counted as `loop_issue` counts its loop: W3's loops over
    the objects of each kind (which hold its FP multiplies; the staging
    copies hold none)."""
    body, branches, loops = _loops(sass, kernel, per)
    inner = sorted((L for L in loops if not any(
        L[2] < M[2] <= L[3] for M in loops)), key=lambda L: L[2])
    return [_short_path(body, branches, lo, hi, per) for _, _, lo, hi in inner]


def shaded_pass(sass, kernel, per="FMUL"):
    """(instructions, instructions) of one pass of the widest loop holding
    `per` of the kernel whose name holds `kernel` (a W4 entry's loop over
    the rays), each counted as `loop_issue` counts a pass: on its
    shortest path, and on its shortest path with the forward branch that
    skips the most of it not taken.  For W4 the first is a ray of another
    material type (its word read, the rest skipped), the second a ray it
    shades on its cheapest branches: a lower count of that ray's issue
    slots (a loop inside the pass counted once)."""
    body, branches, loops = _loops(sass, kernel, per)
    _, _, lo, hi = max(loops, key=lambda L: L[3] - L[2])
    fwd = [(a, t) for a, t in branches if lo <= a < t <= hi]
    skip = max(fwd, key=lambda b: sum(1 for x, _, _ in body if b[0] < x < b[1]))
    short = _short_path(body, branches, lo, hi, per)[0]
    shaded = _short_path(body, [b for b in branches if b != skip], lo, hi, per)[0]
    return short, shaded


def queued_pass(sass, kernel, per="FMUL"):
    """(instructions, instructions) of a W4 entry that queues its rays
    (csrc/wavefront_shade.cu `shade_queued`: an outer loop over tiles of
    rays, each tile's words read and its rays of the type queued, around a
    loop of shading rounds, which may hold loops of its own, as the
    diffuse entry's caps sum): one tile's queueing pass a thread (the
    outer loop, the widest loop holding `per`, its instructions outside
    the round loop, on its shortest path with the forward branch that
    skips the most of them not taken) and one shading round a thread (the
    round loop, the widest loop holding `per` inside the outer one, as
    `shaded_pass` counts a shaded ray: on its shortest path with the
    branch that skips the most of it not taken; a loop inside it counted
    once)."""
    body, branches, loops = _loops(sass, kernel, per)
    _, _, olo, ohi = max(loops, key=lambda L: (L[1], L[0]))
    inner = [L for L in loops if olo < L[2] and L[3] <= ohi]
    if not inner:
        raise ValueError(f"{kernel}: no shading loop inside its tile loop")
    _, _, ilo, ihi = max(inner, key=lambda L: (L[1], L[0]))

    def with_widest_skip(lo, hi, counted):
        fwd = [(a, t) for a, t in branches if lo <= a < t <= hi]
        skip = max(fwd, key=lambda b: sum(1 for x, _, _ in body
                                          if b[0] < x < b[1] and counted(x)),
                   default=None)
        skipped = set()
        for a, t in fwd:
            if (a, t) != skip:
                skipped.update(x for x, _, _ in body if a < x < t)
        return sum(1 for x, _, _ in body
                   if lo <= x <= hi and counted(x) and x not in skipped)

    queue = with_widest_skip(olo, ohi, lambda x: not ilo <= x <= ihi)
    shaded = with_widest_skip(ilo, ihi, lambda x: True)
    return queue, shaded


def _loops(sass, kernel, per):
    """(instructions, backward branches, loops) of a kernel's SASS: each
    instruction (address, op, operands); each loop (count of `per` in its
    body, width, head, backward branch), branches back to one head one
    loop, only those that hold `per`."""
    body, cur = [], False
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = kernel in m.group(1)
            continue
        m = _SASS.search(line) if cur else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not body:
        raise ValueError(f"no SASS of a kernel named like {kernel!r}")
    branches = []
    for addr, op, rest in body:
        t = re.search(r"(0x[0-9a-f]+)\s*$", rest.strip())
        if op == "BRA" and t:
            branches.append((addr, int(t.group(1), 16)))
    heads = {}
    for hi, lo in branches:
        if lo < hi:
            heads[lo] = max(hi, heads.get(lo, hi))
    loops = [(sum(op == per for a, op, _ in body if lo <= a <= hi), hi - lo, lo, hi)
             for lo, hi in heads.items()]
    loops = [L for L in loops if L[0] > 0]
    if not loops:
        raise ValueError(f"{kernel}: no loop holding {per}")
    return body, branches, loops


def _short_path(body, branches, lo, hi, per):
    """(instructions, count of `per`) of the loop [lo, hi] on its shortest
    path: less every stretch that a forward branch inside it jumps over."""
    skipped = set()
    for a, t in branches:
        if lo <= a < t <= hi:
            skipped.update(x for x, _, _ in body if a < x < t)
    inside = [(a, op) for a, op, _ in body if lo <= a <= hi]
    return (sum(a not in skipped for a, _ in inside),
            sum(op == per for _, op in inside))

