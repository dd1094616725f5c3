#!/usr/bin/env python3
"""Time W3's occluded entry (csrc/analytic_sweep.cu, wrapper
raytracer_tpu_torch/ops/analytic_sweep.py `_occluded_launch`) of
checkouts of the PyTorch port on one CUDA device, in turns, at
chip_smoke.py's held shadow-ray inputs.

    python3 scripts/torch_w3_ab.py [--out OUT.json] ROOT ...

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (scripts/torch_frame_ab.py `in_turns`), so "A B B A"
times A and B in alternation.  A child makes this checkout's held inputs
(chip_smoke.py HELD_SHADOW, `held_shadow_rays`) with the root's package;
on each it holds the root's wrapper equal to the root's plain loops
(`intersect._analytic_occluded`) on every ray, times it in ROUNDS rounds
through a CUDA graph of REPS calls (`probes/common.py` `graph_ms`: the
device time of everything the wrapper launches), with CUDA events around
the calls (`cuda_ms`) and by the host's clock around the calls and a
sync, times the plain loops, and lists the device events torch.profiler
records a call (torch_render_profile.py `device_events`).  The bound is
the same for every root: chip_smoke.py's recount (`occluded_tests`,
`occluded_bytes`) at the issue slots of each kind's test read off this
checkout's occluded kernel (`probes/common.py` `kind_loops`), passed to
the children.  The parent's last line is `in_turns`', with each input's
median graph ms over a root's children.
"""

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

from torch_frame_ab import in_turns

HERE = Path(__file__).resolve().parents[1]
REPS = 20
ROUNDS = 3
PROFILE_CALLS = 10


def occluded_slots():
    """Issue slots of a sphere / plane / box / disc / cylinder test in this
    checkout's occluded kernel, off its SASS."""
    sys.path.insert(0, str(HERE))
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.probes import common

    sass = common.cuobjdump_sass(cuda_build.build("kernels"))
    loops = common.kind_loops(sass, "analytic_occluded_kernel", "FMUL")
    return [issued for issued, _ in loops[:5]]


def child(root, slots):
    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    spec = importlib.util.spec_from_file_location("held", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import analytic_sweep
    from raytracer_tpu_torch.probes import common
    from torch_render_profile import device_events

    dev = torch.device("cuda:0")
    out = {"root": str(root), "slots": slots, "inputs": {}}
    for name, uniform in smoke.HELD_SHADOW:
        geom, O, L, shadow, md = smoke.held_shadow_rays(torch, dev, name, uniform)
        want = intersect._analytic_occluded(O, L, geom, shadow, md)
        fn = lambda: analytic_sweep._occluded_launch(O, L, geom, shadow, md)
        before = analytic_sweep.analytic_occluded.launches
        if not torch.equal(fn(), want):
            raise RuntimeError(f"{root}: W3 occluded on the {name} shadow rays "
                               "differs from the plain loops")
        launches = analytic_sweep.analytic_occluded.launches - before
        times = [common.graph_ms(fn, REPS)[0] for _ in range(ROUNDS)]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / REPS
        kind_tests = smoke.occluded_tests(torch, geom, O, L, shadow, md)
        n_bytes = smoke.occluded_bytes(geom, O, L, shadow, md)
        bound_ms, bound_by = common.bound(
            sum(n * c for n, c in zip(kind_tests, slots)), n_bytes)
        ms = statistics.mean(times)
        out["inputs"][f"{name}, {'one row' if uniform else 'one a ray'}"] = {
            "rays": O.shape[0], "occluded": int(want.sum()),
            "launches_a_call": launches, "ms": ms, "rounds_ms": times,
            "event_ms": common.cuda_ms(fn, REPS), "wall_ms": wall_ms,
            "plain_ms": common.cuda_ms(
                lambda: intersect._analytic_occluded(O, L, geom, shadow, md), 3),
            "kind_tests": kind_tests, "tests": sum(kind_tests),
            "gtests_per_s": sum(kind_tests) / ms / 1e6, "bytes": n_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
            **device_events(torch, fn, PROFILE_CALLS)}
        del geom, O, L, md, want, fn
        torch.cuda.empty_cache()
    print(json.dumps(out))


def show(inputs):
    """A child's inputs as text: graph ms and share, events and wall ms,
    device events a call."""
    return " | ".join(
        f"{k}: {v['ms']:.5f} ms ({v['share']:.3f} of {v['bound_ms']:.5f}, "
        f"{v['bound_by']}), events {v['event_ms']:.4f}, wall {v['wall_ms']:.4f}, "
        f"plain {v['plain_ms']:.2f} ms, {json.dumps(v['events_a_call'])}"
        for k, v in inputs.items())


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--slots", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(), [int(x) for x in args.slots.split(",")])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    return in_turns(__file__, args.roots,
                    ["--slots", ",".join(map(str, occluded_slots()))], show,
                    args.out, metric="ms", items="inputs")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
