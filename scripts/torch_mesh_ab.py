#!/usr/bin/env python3
"""Time the mesh frames of two checkouts of the PyTorch port on one CUDA
device, in turns, and say where each frame's device time goes.

    python3 scripts/torch_mesh_ab.py [--out OUT.json] [--frames A,B]
        [--renders N] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (scripts/torch_frame_ab.py `in_turns`), so "A B B A"
times A and B in alternation.  The frames: the three mesh examples of
examples/torch_mesh.py (icosphere, beach ball, instance field) and the
normal-mapped scene of examples/torch_features.py (or those --frames
names), each at 400x300 x 16 spp through Scene.render on the wavefront.
A child renders each frame once to warm up (W1, where the root has it,
is built then) and RENDERS (or --renders) times timed (a device sync
after each), with the device's peak memory over the timed renders and
the SHA-256 of the last timed image (equal hashes: frames equal bit for
bit); then one render under torch.profiler: the device
span, busy time and idle share (torch_render_profile.py
`device_breakdown`), the device time of each "wavefront.*" bounce stage
(`wavefront_stages`), of the clustered sweep's range (the pair search
and W1, or the plain fold), of W1's kernels (the root's
`mesh_sweep.KERNELS`) and of W2's (`mesh_pairs.KERNELS`, where the root
has them), the sweep's (cluster, ray) pairs and its rate in triangle
tests a second, and its host syncs a bounce.  It prints one JSON line;
the parent's last line is `in_turns`'.
"""

import argparse
import hashlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

from torch_frame_ab import in_turns
from torch_render_profile import device_breakdown, wavefront_stages

FRAMES = (("icosphere", "torch_mesh", "icosphere"),
          ("beach_ball", "torch_mesh", "beach_ball"),
          ("instances", "torch_mesh", "instances"),
          ("normal_mapped", "torch_features", "normal_mapped"))
W, H, SPP = 400, 300, 16
RENDERS = 3


def child(root, frames=None, renders=RENDERS):
    import importlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.geometry import intersect
    try:
        from raytracer_tpu_torch.ops.mesh_sweep import KERNELS
    except ImportError:           # a checkout from before W1
        KERNELS = ()
    try:
        from raytracer_tpu_torch.ops.mesh_pairs import KERNELS as W2_KERNELS
    except ImportError:           # a checkout from before W2
        W2_KERNELS = ()

    dev = torch.device("cuda:0")
    obj_dir = tempfile.mkdtemp()
    out = {"root": str(root), "frames": {}}
    for name, module, fn in FRAMES:
        if frames and name not in frames:
            continue
        sc = getattr(importlib.import_module(module), fn)(W, H, obj_dir=obj_dir)
        render = lambda: sc.render(samples_per_pixel=SPP, output="linear",
                                   return_stats=True, device=dev, seed=7)
        render()
        walls = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(renders):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stats = render()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        before = dict(intersect.SWEEP_STATS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        path = Path(obj_dir) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        span, busy, per_name = device_breakdown(events)
        settings = sc._settings_for_render()[2]
        fan = 1 << settings.split_k
        bounces = plan_chunks(SPP * sc._diffuse_fan() * fan, W, H,
                              fan)[1] * settings.max_bounces
        by_stage = wavefront_stages(events)[0]
        pairs = intersect.SWEEP_STATS["pairs"] - before["pairs"]
        syncs = intersect.SWEEP_STATS["syncs"] - before["syncs"]
        sweep_us = by_stage.get("clustered_sweep", 0.0)
        w1_us = sum(t for k, (t, _) in per_name.items()
                    if any(w in k for w in KERNELS))
        w2_us = sum(t for k, (t, _) in per_name.items()
                    if any(w in k for w in W2_KERNELS))
        out["frames"][name] = {
            "walls_s": walls, "median_s": statistics.median(walls),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                img, dtype=np.float32).tobytes()).hexdigest(),
            "peak_gib": peak, "rays_traced": int(stats["rays_traced"]),
            "profiled_wall_s": prof_wall, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span if span else None,
            "stages_ms": {k: v / 1e3 for k, v in sorted(by_stage.items(),
                                                          key=lambda kv: -kv[1])},
            "sweep_ms": sweep_us / 1e3, "sweep_share": sweep_us / busy if busy else None,
            "w1_ms": w1_us / 1e3, "w1_share": w1_us / busy if busy else None,
            "w2_ms": w2_us / 1e3, "pairs": pairs, "syncs": syncs,
            "bounces": bounces, "syncs_per_bounce": syncs / bounces,
            "gtests_per_s_range": pairs * 256 / sweep_us / 1e3 if sweep_us else None,
            "gtests_per_s_w1": pairs * 256 / w1_us / 1e3 if w1_us else None,
            "top_kernels_ms": {k[:80]: t / 1e3 for k, (t, _) in sorted(
                per_name.items(), key=lambda kv: -kv[1][0])[:6]}}
        del sc
        torch.cuda.empty_cache()
    print(json.dumps(out))


def show(frames):
    """A child's frames as text: wall, peak, busy, the sweep's, W1's and
    W2's device time, the idle share and the host syncs a bounce."""
    return " | ".join(
        f"{k} {v['median_s']:.4f} s ({', '.join(f'{x:.4f}' for x in v['walls_s'])}), "
        f"peak {v['peak_gib']:.2f} GiB, busy {v['busy_ms']:.1f} ms, sweep "
        f"{v['sweep_ms']:.1f} ms ({100 * (v['sweep_share'] or 0):.1f}% of busy), "
        f"W1 {v['w1_ms']:.1f} ms, W2 {v['w2_ms']:.2f} ms, idle "
        f"{100 * (v['idle_share'] or 0):.1f}%, {v['syncs_per_bounce']:.2f} "
        f"syncs a bounce, image SHA-256 {v['sha256'][:16]}"
        for k, v in frames.items())


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--frames", default="",
                    help="comma-separated frame names (default: all)")
    ap.add_argument("--renders", type=int, default=RENDERS)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    frames = [f for f in args.frames.split(",") if f]
    if args.child is not None:
        child(args.child.resolve(), frames, args.renders)
        return 0
    return in_turns(__file__, args.roots,
                    ["--frames", args.frames, "--renders", str(args.renders)],
                    show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
