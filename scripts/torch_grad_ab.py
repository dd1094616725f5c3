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
W4 diffuse and glossy blocks' backward; --scenes names other gradients of
`gradients`: Cornell's and the primitives' IoR, textures and geometry
tables) once to warm up and N times timed
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


def leaf(data, path):
    """The float leaf `path` of a SceneData: "textures.<k>", "geom.<field>"
    or a material table's name."""
    group, _, field = path.rpartition(".")
    if group == "textures":
        return data.textures[int(field)]
    return getattr(data.geom if group == "geom" else data.mats, field)


def with_leaves(data, paths, xs):
    """data with the leaves `paths` (`leaf`) replaced by xs."""
    import dataclasses

    texs, geom, mats = list(data.textures), {}, {}
    for p, x in zip(paths, xs):
        group, _, field = p.rpartition(".")
        if group == "textures":
            texs[int(field)] = x
        else:
            (geom if group == "geom" else mats)[field] = x
    return dataclasses.replace(data, textures=tuple(texs),
                               geom=dataclasses.replace(data.geom, **geom),
                               mats=dataclasses.replace(data.mats, **mats))


def _examples(name):
    """This checkout's examples/<name>.py, loaded under another module name
    (a child imports its root's examples; the scenes built here need not
    be there)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_here_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gradients(obj_dir):
    """{name: (scene maker, the leaves the gradient takes)}: the IoR steps
    of the glass sphere, its icosphere twin ("mesh"), Cornell and the
    primitives; the primitives' colour step; the primitives' floor texture,
    every texture of examples/torch_features.py `lit_textures`, the
    sphere's centres and radii, the icosphere's corners and corner normals,
    and the enclosed normal-mapped scene's map and diffuse colours."""
    import raytracer_tpu_torch as T
    from torch_cornellbox import build_cornell
    from torch_inverse_rendering import TRUE_N, build_mesh_scene, build_scene
    from torch_primitives import primitives

    ior = ("refr_n_re",)
    corners = tuple(f"geom.tri_{k}" for k in ("p1", "p2", "p3", "vn1", "vn2", "vn3"))
    lit = lambda: _examples("torch_features").lit_textures(W, H, m=T)
    return {
        "sphere": (lambda: build_scene(TRUE_N, W, H), ior),
        "mesh": (lambda: build_mesh_scene(TRUE_N, W, H, obj_dir), ior),
        "primitives colour": (lambda: primitives(W, H),
                              ("diffuse_color", "glossy_color", "glossy_n_re")),
        "Cornell": (lambda: build_cornell(W, W), ior),
        "primitives": (lambda: primitives(W, H), ior),
        "primitives texture": (lambda: primitives(W, H), ("textures.0",)),
        "lit textures": (lit, tuple(f"textures.{k}" for k in range(4))),
        "sphere tables": (lambda: build_scene(TRUE_N, W, H),
                          ("geom.sphere_center", "geom.sphere_radius")),
        "icosphere tables": (lambda: build_mesh_scene(TRUE_N, W, H, obj_dir), corners),
        "normal-mapped": (lambda: _examples("torch_features").normal_mapped(
                              W, H, m=T, obj_dir=obj_dir, enclosed=True),
                          ("textures.0", "diffuse_color")),
    }


DEFAULT_SCENES = ("sphere", "mesh", "primitives colour")


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
            max((float((gs[0] - g).abs().max()) for g in gs[1:]), default=0.0))


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


def child(root, repeats, spp, deterministic, profile=False, scenes=DEFAULT_SCENES):
    import tempfile

    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.diff import differentiable_render

    dev = torch.device("cuda:0")
    grads = gradients(tempfile.mkdtemp())
    out = {"root": str(root), "frames": {}}
    for name in scenes:
        make, paths = grads[name]
        fn, data = differentiable_render(make(), spp, seed=0, device=dev)

        def grad():
            xs = [leaf(data, p).clone().requires_grad_(True) for p in paths]
            loss = torch.mean(fn(with_leaves(data, paths, xs)) ** 2)
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
    ap.add_argument("--scenes", default=",".join(DEFAULT_SCENES),
                    help="the gradients to take, by name (`gradients`), comma-separated")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.repeats, args.spp, args.deterministic,
              args.profile, args.scenes.split(","))
        return 0
    extra = ["--repeats", str(args.repeats), "--spp", str(args.spp),
             "--scenes", args.scenes]
    if args.deterministic:
        extra.append("--deterministic")
    if args.profile:
        extra.append("--profile")
    return in_turns(__file__, args.roots, extra, show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
