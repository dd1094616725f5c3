#!/usr/bin/env python3
"""Time the inverse-rendering gradient of two checkouts of the PyTorch port
on one CUDA device, in turns, and say whether repeated backward passes
agree bit for bit.

    python3 scripts/torch_grad_ab.py [--repeats N] [--deterministic]
        [--out OUT.json] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (scripts/torch_frame_ab.py `in_turns`), so "A B B A"
times A and B in alternation.  A child takes chip_smoke.py's diff phase:
differentiable_render of examples/torch_inverse_rendering.py's scene at
96x72 x 8 spp, seed 0 (the glass sphere, and the same scene with it as a
1,280-face icosphere mesh), and runs forward + backward of the mean
squared image with respect to the refraction indices once to warm up and
N times timed (a device sync after each): the walls, their median, the
gradient's first element and whether every pass equals the first bit for
bit (and the largest difference).  --deterministic runs the timed passes
again under torch.use_deterministic_algorithms(True, warn_only=True) and
adds their walls, their agreement and the warnings raised: the ops whose
CUDA kernels have no deterministic form.  The last line of the parent is
`in_turns`'.
"""

import argparse
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

from torch_frame_ab import in_turns

W, H, SPP = 96, 72, 8


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


def child(root, repeats, deterministic):
    import tempfile

    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from torch_inverse_rendering import TRUE_N, build_mesh_scene, build_scene

    dev = torch.device("cuda:0")
    obj_dir = tempfile.mkdtemp()
    out = {"root": str(root), "frames": {}}
    for name, make in (("sphere", lambda: build_scene(TRUE_N, W, H)),
                       ("mesh", lambda: build_mesh_scene(TRUE_N, W, H, obj_dir))):
        fn, data = differentiable_render(make(), SPP, seed=0, device=dev)
        n0 = data.mats.refr_n_re

        def grad():
            x = n0.clone().requires_grad_(True)
            loss = torch.mean(fn(update_materials(data, refr_n_re=x)) ** 2)
            return torch.autograd.grad(loss, x)[0]

        grad()
        walls, gs = passes(torch, grad, repeats)
        equal, diff = agree(torch, gs)
        res = {"walls_s": walls, "median_s": statistics.median(walls),
               "g00": float(gs[0][0, 0]), "bit_equal": equal, "max_diff": diff}
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
        f"({', '.join(f'{x:.4f}' for x in v['walls_s'])}), bit-equal "
        f"{v['bit_equal']} (max diff {v['max_diff']:.3e})"
        + (f", deterministic mode {statistics.median(v['det_walls_s']):.4f} s, "
           f"bit-equal {v['det_bit_equal']}, warnings {v['det_warnings']}"
           if "det_walls_s" in v else "")
        for k, v in frames.items())


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), args.repeats, args.deterministic)
        return 0
    extra = ["--repeats", str(args.repeats)]
    if args.deterministic:
        extra.append("--deterministic")
    return in_turns(__file__, args.roots, extra, show, args.out)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
