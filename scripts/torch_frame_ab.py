#!/usr/bin/env python3
"""Time frames of two checkouts of the PyTorch port on one CUDA device, in
turns.

    python3 scripts/torch_frame_ab.py [--renders N] [--frames A,B]
        [--out OUT.json] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (a package can be imported once per process), so
"A B B A" times A and B in alternation.  A child builds that root's
kernels, renders each frame once to warm up and N times timed
(Scene.render with output="linear" and seed 7, a device sync after each),
with the device's peak memory over the timed renders, then once under
torch.profiler: the device span, busy time and idle share
(torch_render_profile.py `device_breakdown`), the device time of each
"wavefront.*" bounce stage (`wavefront_stages`) with the number of
nearest_hit calls, and of the analytic sweep's, the shading blocks', the
hit attributes' and the bounce tail's kernels (the root's
`analytic_sweep.KERNELS`, `wavefront_shade.KERNELS`, `hit_attrs.KERNELS`
and `bounce_tail.KERNELS`, where it has them),
and the device events;
and the SHA-256 of the last timed image (equal hashes: frames equal bit
for bit).  It prints one JSON line.
The frames (FRAMES; --frames picks some by name, all by default):
chip_smoke.py's main paths, the reference Cornell box at 400x400 x 256
spp (the solid kernel) and example 2 at 400x300 x 64 spp (the record
kernel); the 98-object grid of examples/torch_wavefront.py at 400x300 x
64 spp (past the kernels' gates: the wavefront); and the Cornell box at
400x400 x 64 spp under RenderSettings(use_pallas="never") (the
wavefront).  The last line of the parent is one JSON object with the
card's name and power limit, every child's result and, per root, the
median over its children of each frame's median; also written to
OUT.json if given.  `in_turns` is this driver, shared with
scripts/torch_mesh_ab.py.
"""

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from torch_render_profile import device_breakdown, wavefront_stages

# (name, examples module, builder, width, height, spp, use_pallas or None)
FRAMES = (("cornell", "torch_cornellbox", "build_cornell", 400, 400, 256, None),
          ("example2", "torch_textured", "example2", 400, 300, 64, None),
          ("grid", "torch_wavefront", "grid", 400, 300, 64, None),
          ("cornell_wavefront", "torch_cornellbox", "build_cornell", 400, 400,
           64, "never"))
GRID_SPHERES = 96                     # the grid: 96 spheres, 98 objects


def build(module, fn, w, h, use_pallas):
    """A frame's scene, built by the root's examples/ with its package."""
    import importlib

    make = getattr(importlib.import_module(module), fn)
    sc = make(GRID_SPHERES, w, h) if fn == "grid" else make(w, h)
    if use_pallas is not None:
        import raytracer_tpu_torch as T
        sc.settings = T.RenderSettings(use_pallas=use_pallas)
    return sc


def profiled(torch, render, tmp):
    """One render under torch.profiler: its device span, busy time, idle
    share, the device ms of each "wavefront.*" stage, the nearest_hit
    calls (its ranges on the device), the device ms of the analytic
    sweep's kernels, of the shading blocks', of the hit attributes' and of
    the bounce tail's (none before the root had them) and the device
    events."""
    from torch.profiler import ProfilerActivity, profile
    try:
        from raytracer_tpu_torch.ops.analytic_sweep import KERNELS
    except ImportError:           # a checkout from before the kernel
        KERNELS = ()
    try:
        from raytracer_tpu_torch.ops.wavefront_shade import KERNELS as W4
    except ImportError:           # a checkout from before W4
        W4 = ()
    try:
        from raytracer_tpu_torch.ops.hit_attrs import KERNELS as W5
    except ImportError:           # a checkout from before W5
        W5 = ()
    try:
        from raytracer_tpu_torch.ops.bounce_tail import KERNELS as W6
    except ImportError:           # a checkout from before W6
        W6 = ()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = Path(tmp) / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    span, busy, per_name = device_breakdown(events)
    stages = wavefront_stages(events)[0]
    calls = sum(1 for e in events if e.get("cat") == "gpu_user_annotation"
                and e.get("name") == "wavefront.nearest_hit")
    kernel_us = sum(t for k, (t, _) in per_name.items()
                    if any(w in k for w in KERNELS))
    w4_us = sum(t for k, (t, _) in per_name.items() if any(w in k for w in W4))
    w5_us = sum(t for k, (t, _) in per_name.items() if any(w in k for w in W5))
    w6_us = sum(t for k, (t, _) in per_name.items() if any(w in k for w in W6))
    return {"profiled_wall_s": wall, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span if span else None,
            "stages_ms": {k: v / 1e3 for k, v in sorted(
                stages.items(), key=lambda kv: -kv[1])},
            "nearest_hit_calls": calls, "analytic_kernel_ms": kernel_us / 1e3,
            "w4_kernel_ms": w4_us / 1e3, "w5_kernel_ms": w5_us / 1e3,
            "w6_kernel_ms": w6_us / 1e3,
            "device_events": sum(c for _, c in per_name.values())}


def child(root, renders, frames=None):
    import tempfile

    import numpy as np
    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.ops import cuda_build

    cuda_build.build_all(("kernels",))
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp()
    out = {"root": str(root), "frames": {}}
    for name, module, fn, w, h, spp, use_pallas in FRAMES:
        if frames and name not in frames:
            continue
        sc = build(module, fn, w, h, use_pallas)
        render = lambda: sc.render(samples_per_pixel=spp, output="linear",
                                   return_stats=True, device=dev, seed=7)
        render()
        walls, stats = [], None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(renders):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stats = render()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["frames"][name] = {
            "walls_s": walls, "median_s": statistics.median(walls),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                img, dtype=np.float32).tobytes()).hexdigest(),
            "rays_traced": int(stats["rays_traced"]),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            **profiled(torch, render, tmp)}
        del sc
        torch.cuda.empty_cache()
    print(json.dumps(out))


def show(frames):
    """A child's frames as text: each frame's median and walls, peak
    memory, busy time and idle share, device events, nearest_hit's, the
    attributes', the shading ranges', the start's and the update's device
    time, and the image's hash."""
    return " | ".join(
        f"{k} {v['median_s']:.4f} s ({', '.join(f'{x:.4f}' for x in v['walls_s'])}), "
        f"peak {v['peak_gib']:.2f} GiB, busy {v['busy_ms']:.1f} ms, idle "
        f"{100 * (v['idle_share'] or 0):.1f}%, {v['device_events']} device "
        f"events, nearest_hit "
        f"{v['stages_ms'].get('nearest_hit', 0.0):.1f} ms in "
        f"{v['nearest_hit_calls']} calls, analytic kernel "
        f"{v['analytic_kernel_ms']:.2f} ms, attributes "
        f"{v['stages_ms'].get('attributes', 0.0):.1f} ms (W5 kernel "
        f"{v.get('w5_kernel_ms', 0.0):.2f} ms), shading "
        f"{', '.join(f'{s[6:]} {t:.1f}' for s, t in v['stages_ms'].items() if s.startswith('shade.'))}"
        f" ms (W4 kernels {v['w4_kernel_ms']:.2f} ms), start "
        f"{v['stages_ms'].get('start', 0.0):.1f} ms, update "
        f"{v['stages_ms'].get('update', 0.0):.1f} ms (W6 kernels "
        f"{v.get('w6_kernel_ms', 0.0):.2f} ms), image SHA-256 "
        f"{v['sha256'][:16]}"
        for k, v in frames.items())


def in_turns(script, roots, args, show, out_path, metric="median_s",
             items="frames"):
    """Run `script --child ROOT *args` for each root in the order given,
    one process each, printing show(its `items`: frames, or held inputs)
    as it ends; print and return the parent's last line: the card's name
    and power limit, every child's result and, per root, the median over
    its children of each item's `metric` (also written to out_path if
    given).  Exit code 1 without a CUDA device, the child's own if one
    fails."""
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in roots:
        res = subprocess.run([sys.executable, script, "--child",
                              str(root.resolve()), *args],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{root}: {show(runs[-1][items])}", flush=True)
    summary = {}
    for run in runs:
        for name, v in run[items].items():
            summary.setdefault(run["root"], {}).setdefault(name, []).append(
                v[metric])
    summary = {root: {k: statistics.median(v) for k, v in by_item.items()}
               for root, by_item in summary.items()}
    out = {"device": smi, "runs": runs, f"median_of_{metric}": summary}
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--renders", type=int, default=5)
    ap.add_argument("--frames", default="",
                    help="comma-separated frame names (default: all)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    frames = [f for f in args.frames.split(",") if f]
    unknown = set(frames) - {f[0] for f in FRAMES}
    if unknown:
        ap.error(f"unknown frames {sorted(unknown)}")
    if args.child is not None:
        child(args.child.resolve(), args.renders, frames)
        return 0
    return in_turns(__file__, args.roots,
                    ["--renders", str(args.renders), "--frames", args.frames],
                    show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
