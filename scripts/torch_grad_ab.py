#!/usr/bin/env python3
"""Time the inverse-rendering gradient of two checkouts of the PyTorch port
on one CUDA device, in turns, and say whether repeated backward passes
agree bit for bit.

    python3 scripts/torch_grad_ab.py [--repeats N] [--spp S] [--deterministic]
        [--profile] [--out OUT.json] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (scripts/torch_frame_ab.py `in_turns`), so "A B B A"
times A and B in alternation.  A child takes chip_smoke.py's diff phase:
differentiable_render of examples/torch_inverse_rendering.py's scene at
96x72 x S spp (8 unless given; from 32 on a render is two chunks or more,
each under torch.utils.checkpoint), seed 0 (the glass sphere, and the
same scene with it as a 1,280-face icosphere mesh), and of
examples/torch_primitives.py's primitives, and runs forward + backward of
the mean squared image with respect to the refraction indices (the
primitives: diffuse_color, glossy_color and glossy_n_re in one pass, the
W4 diffuse and glossy blocks' backward) once to warm up and N times timed
(a device sync after each): the walls, their median, the device's peak
memory over the timed passes (torch.cuda.max_memory_allocated), the
gradient's first element, the SHA-256 of the first pass's gradient (the
tables' gradients flattened one after another; equal hashes across roots:
gradients equal bit for bit) and whether every pass equals the first bit
for bit (and the largest difference).  --profile adds one pass under
torch.profiler: its wall, the device's busy time and events, the host's
operator events and the host ms of the ten host operators that take the
most (their events' own spans, nested ones inside) and the device
time and events of each stage's backward (the "wavefront.backward.*"
profiler ranges of W4's blocks, W5's attributes and W6's start and
update, csrc's backward kernels or the plain VJP inside each), and each
backward kernel's device ms a launch and launches (its events by name).
--deterministic runs the timed passes
again under torch.use_deterministic_algorithms(True, warn_only=True) and
adds their walls, their agreement and the warnings raised: the ops whose
CUDA kernels have no deterministic form.  The last line of the parent is
`in_turns`'.
"""

import argparse
import hashlib
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

from torch_frame_ab import in_turns
from torch_render_profile import device_breakdown, wavefront_stages

W, H = 96, 72


def passes(torch, grad, n):
    """(walls, gradients) of n timed calls of grad."""
    walls, gs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs.append(grad())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, gs


def agree(torch, gs):
    """(every gradient equals the first bit for bit, largest difference)."""
    return (all(bool(torch.equal(gs[0], g)) for g in gs[1:]),
            max(float((gs[0] - g).abs().max()) for g in gs[1:]))


def profiled(torch, grad):
    """One call of grad under torch.profiler (see the module doc)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    events = json.loads(Path(path).read_text())["traceEvents"]
    os.unlink(path)
    span, busy, per_name = device_breakdown(events)
    stages, counts = wavefront_stages(events)
    host = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            n = e["name"][:60]
            host[n] = host.get(n, 0.0) + e.get("dur", 0.0) / 1e3
    return {"profiled_wall_s": wall, "busy_ms": busy / 1e3,
            "device_events": sum(c for _, c in per_name.values()),
            "host_ops": sum(1 for e in events if e.get("cat") == "cpu_op"),
            "host_ms": dict(sorted(host.items(), key=lambda kv: -kv[1])[:10]),
            "backward_ms": {k[len("backward."):]: v / 1e3 for k, v in stages.items()
                            if k.startswith("backward.")},
            "backward_events": {k[len("backward."):]: v for k, v in counts.items()
                                if k.startswith("backward.")},
            "backward_kernels": {k: (t / 1e3, c) for k, (t, c) in per_name.items()
                                 if "_bwd_kernel" in k}}


def child(root, repeats, spp, deterministic, profile=False):
    import tempfile

    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from torch_inverse_rendering import TRUE_N, build_mesh_scene, build_scene
    from torch_primitives import primitives

    dev = torch.device("cuda:0")
    obj_dir = tempfile.mkdtemp()
    out = {"root": str(root), "frames": {}}
    for name, make, tables in (
            ("sphere", lambda: build_scene(TRUE_N, W, H), ("refr_n_re",)),
            ("mesh", lambda: build_mesh_scene(TRUE_N, W, H, obj_dir), ("refr_n_re",)),
            ("primitives colour", lambda: primitives(W, H),
             ("diffuse_color", "glossy_color", "glossy_n_re"))):
        fn, data = differentiable_render(make(), spp, seed=0, device=dev)

        def grad():
            xs = [getattr(data.mats, k).clone().requires_grad_(True) for k in tables]
            loss = torch.mean(fn(update_materials(data, **dict(zip(tables, xs)))) ** 2)
            return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, xs)])

        grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, gs = passes(torch, grad, repeats)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        equal, diff = agree(torch, gs)
        res = {"walls_s": walls, "median_s": statistics.median(walls),
               "peak_gib": peak,
               "g00": float(gs[0][0]),
               "sha256": hashlib.sha256(gs[0].cpu().numpy().tobytes()).hexdigest(),
               "bit_equal": equal, "max_diff": diff}
        if profile:
            res["profile"] = profiled(torch, grad)
        if deterministic:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    d_walls, d_gs = passes(torch, grad, repeats)
                finally:
                    torch.use_deterministic_algorithms(False)
            res.update(det_walls_s=d_walls, det_bit_equal=agree(torch, d_gs)[0],
                       det_warnings=sorted({str(w.message)[:200] for w in caught}))
        out["frames"][name] = res
        del fn, data
        torch.cuda.empty_cache()
    print(json.dumps(out))


def show(frames):
    """A child's scenes as text: the median wall and the agreement."""
    return " | ".join(
        f"{k} forward + backward {v['median_s']:.4f} s "
        f"({', '.join(f'{x:.4f}' for x in v['walls_s'])}), peak "
        f"{v['peak_gib']:.3f} GiB, bit-equal "
        f"{v['bit_equal']} (max diff {v['max_diff']:.3e}), gradient SHA-256 "
        f"{v['sha256'][:16]}"
        + (f", profiled {v['profile']['profiled_wall_s']:.4f} s, busy "
           f"{v['profile']['busy_ms']:.2f} ms, {v['profile']['device_events']} "
           f"device events, {v['profile']['host_ops']} host ops, backward device ms "
           + ", ".join(f"{s} {t:.3f} ({v['profile']['backward_events'][s]} events)"
                       for s, t in sorted(v['profile']['backward_ms'].items()))
           + ", backward kernels " + ", ".join(
               f"{k.split('(')[0].split(' ')[-1]} {t / c:.4f} ms a launch ({c})"
               for k, (t, c) in sorted(v['profile'].get('backward_kernels', {}).items()))
           if "profile" in v else "")
        + (f", deterministic mode {statistics.median(v['det_walls_s']):.4f} s, "
           f"bit-equal {v['det_bit_equal']}, warnings {v['det_warnings']}"
           if "det_walls_s" in v else "")
        for k, v in frames.items())


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.repeats, args.spp, args.deterministic,
              args.profile)
        return 0
    extra = ["--repeats", str(args.repeats), "--spp", str(args.spp)]
    if args.deterministic:
        extra.append("--deterministic")
    if args.profile:
        extra.append("--profile")
    return in_turns(__file__, args.roots, extra, show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
