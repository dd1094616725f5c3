#!/usr/bin/env python3
"""Time the Cornell and example 2 frames of two checkouts of the PyTorch
port on one CUDA device, in turns.

    python3 scripts/torch_frame_ab.py [--renders N] [--out OUT.json] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (a package can be imported once per process), so
"A B B A" times A and B in alternation.  A child builds that root's
kernels, renders each frame once to warm up and N times timed
(Scene.render with its defaults and output="linear", a device sync after
each), and prints one JSON line: the frames' walls, their medians and
rays_traced.  The frames are chip_smoke.py's main paths: the reference
Cornell box at 400x400 x 256 spp (the solid kernel) and example 2 at
400x300 x 64 spp (the record kernel).  The last line of the parent is one
JSON object with the card's name and power limit, every child's result
and, per root, the median over its children of each frame's median;
also written to OUT.json if given.  `in_turns` is this driver, shared
with scripts/torch_mesh_ab.py.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FRAMES = (("cornell", "torch_cornellbox", "build_cornell", 400, 400, 256),
          ("example2", "torch_textured", "example2", 400, 300, 64))


def child(root, renders):
    import importlib

    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.ops import cuda_build

    cuda_build.build_all(("kernels",))
    dev = torch.device("cuda:0")
    out = {"root": str(root), "frames": {}}
    for name, module, fn, w, h, spp in FRAMES:
        sc = getattr(importlib.import_module(module), fn)(w, h)
        walls, stats = [], None
        for _ in range(1 + renders):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = sc.render(samples_per_pixel=spp, output="linear",
                                 return_stats=True, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["frames"][name] = {"walls_s": walls[1:],
                               "median_s": statistics.median(walls[1:]),
                               "rays_traced": stats["rays_traced"]}
    print(json.dumps(out))


def show(frames):
    """A child's frames as text: each frame's median and walls."""
    return " | ".join(
        f"{k} {v['median_s']:.4f} s ({', '.join(f'{x:.4f}' for x in v['walls_s'])})"
        for k, v in frames.items())


def in_turns(script, roots, args, show, out_path):
    """Run `script --child ROOT *args` for each root in the order given,
    one process each, printing show(its frames) as it ends; print and
    return the parent's last line: the card's name and power limit, every
    child's result and, per root, the median over its children of each
    frame's "median_s" (also written to out_path if given).  Exit code 1
    without a CUDA device, the child's own if one fails."""
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
        print(f"{root}: {show(runs[-1]['frames'])}", flush=True)
    summary = {}
    for run in runs:
        for name, v in run["frames"].items():
            summary.setdefault(run["root"], {}).setdefault(name, []).append(
                v["median_s"])
    summary = {root: {k: statistics.median(v) for k, v in frames.items()}
               for root, frames in summary.items()}
    out = {"device": smi, "runs": runs, "median_of_medians_s": summary}
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--renders", type=int, default=5)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.renders)
        return 0
    return in_turns(__file__, args.roots, ["--renders", str(args.renders)],
                    show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
