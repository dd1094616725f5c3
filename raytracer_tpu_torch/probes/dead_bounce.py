"""P5: what a warp pays for lanes whose path has ended.

Counterpart of scripts/probe_when_skip.py (`run` :63, pallas_call :68);
kernel in csrc/probe_skip.cu.  The script's toy (20 planes of state, 6
bounces of sin / sqrt work, the kill rule of :39-56) at n = 4 M, in two
forms: "warp" runs a bounce for the whole warp when any lane is alive
(pl.when(any_alive) per tile, at a warp's width), "thread" lets each lane
leave as it dies.  Inputs: the script's three (all alive, tail dead: dead
after bounce 1, all dead: dead after bounce 0) and a fourth where every
odd lane dies after bounce 0.

    python -m raytracer_tpu_torch.probes.dead_bounce

Beside the toy, what the solid kernel K1 makes of its dead lanes on a
real chunk: its bounce-loop lane efficiency (lane-iterations with a ray
over all lane-iterations), as the kernel counts it, against the plain
version's, from the alive masks of a kernel with one ray per thread
(warps of 32 consecutive rays, each running until its longest path ends).
"""

from __future__ import annotations

import ctypes
import json

import torch

from . import common

TILE = 256 * 128                 # the script's (256, 128) tile
NPLANES, BOUNCES = 20, 6
SOURCE = "probe_skip.cu"
# name: (kill_after, half): the script's kill_after = BOUNCES, 1, 0 and
# the fourth input
INPUTS = {"all_alive": (BOUNCES, False), "tail_dead": (1, False),
          "all_dead": (0, False), "half_dead": (BOUNCES, True)}
# kernel against plain version: sinf against torch.sin and the order of
# 6 bounces' rounding, relative
CHECK_RTOL = 1e-6


def size(n=4_000_000):
    """Elements of the script's grid for n rays: whole tiles."""
    return -(-n // TILE) * TILE


def bounce_reference(x, kill_after, half=False, form="warp"):
    """The plain version: (n,) -> plane 0 after the bounces.  form "warp":
    a lane's planes move at a bounce when any lane of its 32 is alive;
    "thread": when the lane is."""
    dev, f32 = x.device, torch.float32
    k = lambda v: torch.tensor(v, dtype=f32, device=dev)
    n = x.numel()
    if form == "warp" and n % 32:
        raise ValueError("the warp form needs whole warps")
    planes = [x + k(0.0) for _ in range(NPLANES)]
    alive = x > 0
    odd = (torch.arange(n, device=dev) & 1) == 1
    for b in range(BOUNCES):
        run = (alive.view(-1, 32).any(dim=1).repeat_interleave(32)
               if form == "warp" else alive)
        acc = torch.zeros(n, dtype=f32, device=dev)
        for j, p in enumerate(planes):
            v = p * k(1.0001) + torch.sin(p) * k(0.25)
            v = v + torch.sqrt(v.abs() + k(1e-3))
            planes[j] = torch.where(run, v, p)
            acc = acc + v
        kill = odd if half else torch.zeros_like(alive)
        if b >= kill_after:
            kill = torch.ones_like(alive)
        alive = torch.where(run, alive & ~kill & (acc == acc), alive)
    return planes[0]


def bounces(x, kill_after, half=False, form="warp"):
    """The toy over x: the kernel for a CUDA tensor, the plain version for
    a CPU tensor.  `bounces.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return bounce_reference(x, kill_after, half, form)
    common.require_card()
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 vector")
    out = torch.empty_like(x)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    common.launch("probe_skip_launch", [ci, vp, vp, ci, ci, ctypes.c_longlong, vp],
                  int(form == "warp"), common.ptr(x), common.ptr(out),
                  kill_after, int(half), x.numel(), common.stream(x))
    bounces.launches += 1
    return out


bounces.launches = 0


def run(n=4_000_000, reps=5, sin_slots=1.0, sqrt_slots=1.0):
    """Both forms on the four inputs at n rays, each held against its
    plain version; sin_slots, sqrt_slots: P1's slot costs, for the bound.
    Returns (result dict, kernels-line rows)."""
    dev = common.require_card()
    x = torch.ones(size(n), dtype=torch.float32, device=dev)
    out = {"probe": "dead_bounce", **common.device_info(), "n": x.numel()}
    errs, ms = {}, {}
    for form in ("warp", "thread"):
        for name, (kill_after, half) in INPUTS.items():
            a = bounces(x, kill_after, half, form)
            b = bounce_reference(x, kill_after, half, form)
            torch.cuda.synchronize()
            if not bool(torch.isclose(a, b, rtol=CHECK_RTOL, atol=0.0).all()):
                raise RuntimeError(f"P5 {form} {name}: kernel and plain version differ")
            errs[f"{form}_{name}"] = float((a - b).abs().max())
    bounces.launches = 0
    for form in ("warp", "thread"):
        for name, (kill_after, half) in INPUTS.items():
            ms[f"{form}_{name}"] = common.cuda_ms(
                lambda: bounces(x, kill_after, half, form), reps)
    launches = bounces.launches
    out["ms"] = ms
    out["max_abs_err"] = errs
    full = ms["warp_all_alive"] / BOUNCES
    out["per_bounce_ms"] = full
    # what a dead lane costs: the half-dead input against all alive, where
    # half the lanes stop after bounce 0 (1 would mean a dead lane costs
    # as much as a live one)
    out["thread_half_dead_over_all_alive"] = ms["thread_half_dead"] / ms["thread_all_alive"]
    out["warp_half_dead_over_all_alive"] = ms["warp_half_dead"] / ms["warp_all_alive"]
    out["warp_tail_dead_over_all_alive"] = ms["warp_tail_dead"] / ms["warp_all_alive"]
    out["warp_all_dead_over_all_alive"] = ms["warp_all_dead"] / ms["warp_all_alive"]
    out["clocks_after"] = common.clocks()
    plain_ms = common.cuda_ms(lambda: bounce_reference(x, BOUNCES), 1, 0)
    # per plane and bounce: mul, add, mul, abs-add, add, acc add + sin + sqrt
    slots = x.numel() * BOUNCES * NPLANES * (6 + sin_slots + sqrt_slots)
    rows = [common.row(f"dead_{form}", SOURCE, "scripts/probe_when_skip.py:68",
                       launches // 2, max(v for k, v in errs.items() if k.startswith(form)),
                       ms[f"{form}_all_alive"], plain_ms, slots, 8 * x.numel())
            for form in ("warp", "thread")]
    return out, rows


def plain_lane_efficiency(args):
    """The bounce-loop lane efficiency of one K1 chunk if each thread
    traced one ray: rays alive at a bounce's start over 32 x the live
    warps at it, summed over bounces (the plain version's `counts=` hook).
    args: solid_trace_chunk's arguments."""
    from ..ops.solid_trace import solid_trace_chunk_reference

    events = {}
    solid_trace_chunk_reference(*args, counts=events)
    return events["ray_bounces"] / (32 * events["warp_bounces"])


def kernel_lane_efficiency(args):
    """K1's own bounce-loop lane efficiency on one chunk: lane-iterations
    with a ray over all lane-iterations of its warps, as the kernel counts
    them when asked (off the render path).  args: solid_trace_chunk's
    arguments, on the card."""
    from ..ops.solid_trace import _launch

    seed, tables, cam, w, h, spp, mb, split_k, sampler, proj = args
    if cam.device.type != "cuda":
        raise ValueError("the kernel's lane count needs CUDA tensors")
    stats = torch.zeros(2, dtype=torch.int64, device=cam.device)
    _launch(seed, tables, cam, w, h, spp, mb, sampler, split_k, proj, lane_stats=stats)
    busy, total = (int(v) for v in stats)
    return busy / total


def main():
    out, rows = run()
    out["kernels"] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main()
