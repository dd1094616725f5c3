#!/usr/bin/env python3
"""Time W4's entries (csrc/wavefront_shade.cu, wrappers
raytracer_tpu_torch/ops/wavefront_shade.py) of checkouts of the PyTorch
port on one CUDA device, in turns, at every bounce of one chunk of Cornell
rendered on the wavefront; or time builds of this checkout's queued
entries (diffuse, refractive).

    python3 scripts/torch_w4_ab.py [--out OUT.json] ROOT ...
    python3 scripts/torch_w4_ab.py --variants [diffuse] [refractive] [--out OUT.json]

Each ROOT is a checkout (or `git archive` of one) that holds
raytracer_tpu_torch/ and examples/; the roots run in the order given, one
child process each (scripts/torch_frame_ab.py `in_turns`), so "A B B A"
times A and B in alternation.  A child renders Cornell at 400x400 on the
wavefront (chip_smoke.py WAVE_CORNELL, WAVE_SPP, seed 7) with the root's
package and captures each W4 call of its first chunk (4.16 M rays, every
bounce) where core/integrator.py `trace` makes it, then ends the render.
At each call it holds the root's W4 equal to the root's plain dispatch,
every field of every ray bit for bit (a share of exactly 1.0, required),
and records the rays of the entry's type, the warps of 32 rays that hold
one, the lane efficiency (those rays over 32 lanes of those warps), W4's
time through a CUDA graph (`probes/common.py` `graph_ms`, ROUNDS rounds of
REPS calls), the plain block's and its merge's by events, and the bound
and share, and beside the bound the bytes the entry's rows occupy counted
by 32-byte sectors (chip_smoke.py `w4_sectors`: a scattered row costs
its whole sector, a partly written sector a fill) and the share of their
time; the queued entries (chip_smoke.py W4_QUEUED: diffuse, refractive)
are timed again on the same rays with their type's rays moved to the
front (this checkout's `ws.pick_rays`, their output their own bit for
bit, required), which separates divergence from latency and occupancy.  The bound is the same for every root: the bytes of
chip_smoke.py `w4_bytes` over this checkout's issue slots
(chip_smoke.py `w4_ops`, off its SASS), passed to the children.  A child
also reads the registers, stack, local and shared memory of each W4
kernel of the root's library (`cuobjdump -res-usage`) and the resident
blocks an SM they allow.  The parent's last line is `in_turns`', with
each bounce's median graph ms over a root's children.

--variants builds this checkout's kernels once for each macro of the
named entries' VARIANTS (both without a name; `cuda_build.load_library
(defines)`), holds each build's entry bit for bit against the default
build at every bounce of the chunk, and times the builds in turns (each
bounce: the first build to the last, then back), with each build's
registers, local memory and resident blocks an SM (`ws.info`), its
`cuobjdump -res-usage` line and ptxas's lines.
"""

import argparse
import ast
import importlib.util
import json
import statistics
import sys
from pathlib import Path

from torch_frame_ab import in_turns

HERE = Path(__file__).resolve().parents[1]
REPS = 5
ROUNDS = 3
# each queued entry's __launch_bounds__ minimum of blocks an SM, its
# default first
VARIANTS = {
    "diffuse": ("W4_DIFF_MIN_BLOCKS=5", "W4_DIFF_MIN_BLOCKS=4", "W4_DIFF_MIN_BLOCKS=6",
                "W4_DIFF_MIN_BLOCKS=8"),
    "refractive": ("W4_REFR_MIN_BLOCKS=4", "W4_REFR_MIN_BLOCKS=1", "W4_REFR_MIN_BLOCKS=3",
                   "W4_REFR_MIN_BLOCKS=5")}
SM_REGS, SM_SMEM, SM_BLOCK_SMEM, SM_THREADS = 65536, 233472, 1024, 2048


def smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def borrowed(ws, name):
    """The root's function `name` of ops/wavefront_shade.py, or, where the
    root has none (a checkout from before it), this checkout's, run in
    the root's module."""
    if hasattr(ws, name):
        return getattr(ws, name)
    tree = ast.parse((HERE / "raytracer_tpu_torch" / "ops" /
                      "wavefront_shade.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == name)
    ns = dict(vars(ws))
    exec(compile(ast.Module([fn], []), "wavefront_shade.py", "exec"), ns)
    return ns[name]


def chunk_calls(torch, ws, dev):
    """[(entry, bounce, call)] of every W4 call of the first chunk of
    Cornell on the wavefront, each call (type, ShadeCtx, draws, packed
    words, mask, a copy of the merged output it was handed)."""
    import raytracer_tpu_torch as T
    from torch_cornellbox import build_cornell

    sm = smoke()
    fields = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
    calls, seen = [], set()

    class ChunkDone(Exception):
        pass

    def spy(mt, real):
        def call(ctx, draws, packed, m, acc):
            key = (real.__name__, ctx.bounce)
            if key in seen:
                raise ChunkDone
            seen.add(key)
            calls.append((real.__name__, ctx.bounce, (mt, ctx, draws, packed, m,
                          ws.Merged(*(getattr(acc, f).clone() for f in fields)))))
            return real(ctx, draws, packed, m, acc)
        return call

    real = dict(ws._WRAPPER)
    for mt, w in real.items():
        setattr(ws, w.__name__, spy(mt, w))
    try:
        sc = build_cornell(*sm.WAVE_CORNELL)
        sc.settings = T.RenderSettings(use_pallas="never")
        with torch.no_grad():
            sc.render(samples_per_pixel=sm.WAVE_SPP, output="linear", device=dev,
                      seed=7)
    except ChunkDone:
        pass
    finally:
        for w in real.values():
            setattr(ws, w.__name__, w)
    return calls


def equal_bits(torch, a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            same = (x.view(torch.int32) == y.view(torch.int32)) | (
                torch.isnan(x) & torch.isnan(y))
        else:
            same = x == y
        if not bool(same.all()):
            return False
    return True


def graph_run(torch, ws, call, out, lib=None):
    """A function that launches the call's W4 entry from `lib` into `out`
    (the tensors it reads and writes kept alive with it)."""
    entry, rays, block, keep = ws.prepare(*call[:4], out)
    keep.append(out)
    dev = call[1].P.device

    def run():
        # the current stream, read at each call: a CUDA graph's capture
        # runs on a stream of its own
        return ws._call(lib, entry, ws.ctypes.byref(rays), ws.ctypes.byref(block),
                        ws.cuda_build.stream_of(dev), entries=ws.ENTRIES), keep
    return run


def resources(ws, cuda_build):
    """{kernel: registers, stack, local and shared bytes, resident blocks
    an SM} of the root's W4 kernels, off its built library."""
    out = {}
    for name, r in smoke().resource_usage(cuda_build.library_path("kernels")).items():
        k = next((k for k in ws.KERNELS if k in name), None)
        if k is None:
            continue
        regs = -(-r["REG"] // 8) * 8
        by_regs = SM_REGS // (regs * 256) if regs else SM_THREADS // 256
        by_smem = SM_SMEM // (r.get("SHARED", 0) + SM_BLOCK_SMEM)
        out[k] = dict(r, blocks_per_sm=min(by_regs, by_smem, SM_THREADS // 256))
    return out


def child(root, slots):
    import torch

    sys.path[:0] = [str(root), str(root / "examples")]
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    cuda_build.build_all(("kernels",))
    sm = smoke()
    pick = borrowed(ws, "pick_rays")
    dev = torch.device("cuda:0")
    fields = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
    out = {"root": str(root), "resources": resources(ws, cuda_build),
           "bounces": {}}
    calls = chunk_calls(torch, ws, dev)
    while calls:
        key, b, call = calls.pop(0)
        mt, ctx, draws, packed, m, acc = call
        with torch.no_grad():
            got = ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
                *(getattr(acc, f).clone() for f in fields)))
            if not equal_bits(torch, got, acc.merge(ws._plain(mt, ctx, draws, None),
                                                    m), fields):
                raise RuntimeError(f"{root}: W4 {key} bounce {b} differs from "
                                   "the plain dispatch")
            run = graph_run(torch, ws, call, got)
            times = [common.graph_ms(run, REPS)[0] for _ in range(ROUNDS)]
            res = {}
            if key in sm.W4_QUEUED:
                order = torch.argsort((~m).to(torch.int8), stable=True)
                front = pick(call, order)
                got_f = ws._kernel_shade(*front[:5], ws.Merged(
                    *(getattr(front[5], f).clone() for f in fields)))
                if not equal_bits(torch, got_f, ws.Merged(
                        *(getattr(got, f)[order] for f in fields)), fields):
                    raise RuntimeError(f"{root}: W4 {key} bounce {b} with its "
                                       "rays in front: not their own output")
                run_f = graph_run(torch, ws, front, got_f)
                res["front_rounds_ms"] = [common.graph_ms(run_f, REPS)[0]
                                          for _ in range(ROUNDS)]
                res["front_ms"] = statistics.mean(res["front_rounds_ms"])
                del front, got_f, run_f
            typed, n = int(m.sum()), m.shape[0]
            warps = sm.warps_holding(torch, m)
            n_bytes = sm.w4_bytes(mt, ctx, draws, m, None, None)
            each, own = slots[key]
            bound_ms, by = common.bound(n * each + typed * own, n_bytes)
            sectors, sector_ms = sm.w4_sectors(torch, key, ctx, draws, m)
            ms = statistics.mean(times)
            out["bounces"][f"{key[6:]} {b}"] = dict(
                res, rays=n, typed=typed, warps=warps,
                lane_efficiency=typed / (32 * warps) if warps else 0.0,
                ms=ms, rounds_ms=times,
                plain_ms=common.cuda_ms(
                    lambda: acc.merge(ws._plain(mt, ctx, draws, None), m), 1),
                bytes=n_bytes, bound_ms=bound_ms, bound_by=by,
                share=bound_ms / ms, sector_bytes=sectors, sector_ms=sector_ms,
                sector_share=sector_ms / ms)
        del call, ctx, draws, packed, m, acc, got, run
        torch.cuda.empty_cache()
    print(json.dumps(out))


def show(bounces):
    """A child's bounces as text: rays of the type, lane efficiency, graph
    ms and share (and with the rays in front)."""
    return " | ".join(
        f"{k}: {v['typed']} rays, eff {v['lane_efficiency']:.3f}, "
        f"{v['ms']:.4f} ms ({v['share']:.3f} of {v['bound_ms']:.4f}; sectors "
        f"{v['sector_bytes'] / 1e6:.1f} MB, {v['sector_ms']:.4f} ms, share "
        f"{v['sector_ms'] / v['ms']:.3f})"
        + (f", in front {v['front_ms']:.4f}" if "front_ms" in v else "")
        for k, v in bounces.items())


def this_slots():
    """{entry: (slots a ray of any type, slots a ray of the entry's type
    more)} of this checkout's W4 kernels (chip_smoke.py `w4_ops`)."""
    import torch

    sys.path[:0] = [str(HERE), str(HERE / "examples")]
    sm = smoke()
    out = {}
    for key in sm.W4_ENTRIES:
        base = sm.w4_ops(torch, key, 1, 0)[0]
        out[key] = (base, sm.w4_ops(torch, key, 1, 1)[0] - base)
    return out


def variants(entries, out_path):
    """Time this checkout's queued entries (`entries`: "diffuse",
    "refractive") built with each macro of their VARIANTS, in turns, at
    every bounce of the chunk (see the module doc)."""
    import torch

    sys.path[:0] = [str(HERE), str(HERE / "examples")]
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    sm = smoke()
    dev = torch.device("cuda:0")
    fields = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
    out = {"device": sm.nvidia_smi(), "builds": {}, "bounces": {}}
    libs = {}
    for entry in entries:
        kernel = f"shade_{entry}_kernel"
        for v in VARIANTS[entry]:
            libs[v] = cuda_build.load_library((v,))
            use = sm.resource_usage(cuda_build.build("kernels", (v,)))
            out["builds"][v] = {
                "info": ws.info(sm.w4_type(f"shade_{entry}"), lib=libs[v]),
                "res_usage": next(r for k, r in use.items() if f"{kernel}E" in k),
                "ptxas": [ln for ln in sm.build_lines(cuda_build.build_log)
                          if ln.startswith(kernel)]}
    for key, b, call in chunk_calls(torch, ws, dev):
        entry = key[6:]
        if entry not in entries:
            continue
        mt, ctx, draws, packed, m, acc = call
        names = VARIANTS[entry]
        with torch.no_grad():
            want = ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
                *(getattr(acc, f).clone() for f in fields)))
            runs = {}
            for v in names:
                got = ws.Merged(*(getattr(acc, f).clone() for f in fields))
                ws._launch(mt, ctx, draws, packed, got, lib=libs[v])
                if not equal_bits(torch, got, want, fields):
                    raise RuntimeError(f"{v}: {entry} bounce {b} differs from the "
                                       "default build")
                runs[v] = graph_run(torch, ws, call, got, libs[v])
            times = {v: [] for v in names}
            for r in range(2 * ROUNDS):
                for v in (names if r % 2 == 0 else names[::-1]):
                    times[v].append(common.graph_ms(runs[v], REPS)[0])
            out["bounces"][f"{entry} {b}"] = {
                "typed": int(m.sum()), "rays": m.shape[0],
                **{v: {"ms": statistics.mean(t), "rounds_ms": t}
                   for v, t in times.items()}}
            print(f"{entry} bounce {b}: {int(m.sum())} rays | " + " | ".join(
                f"{v} {statistics.mean(t):.4f} ms" for v, t in times.items()),
                flush=True)
        del call, ctx, draws, packed, m, acc, want, runs
        torch.cuda.empty_cache()
    for v, bi in out["builds"].items():
        print(f"{v}: {bi['info']} | {bi['res_usage']} | {' | '.join(bi['ptxas'])}",
              flush=True)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--variants", nargs="*", choices=tuple(VARIANTS),
                    help="time builds of these queued entries (default: both)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--slots", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child.resolve(),
              {k: tuple(v) for k, v in json.loads(args.slots).items()})
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.variants is not None:
        return variants(args.variants or tuple(VARIANTS), args.out)
    return in_turns(__file__, args.roots, ["--slots", json.dumps(this_slots())],
                    show, args.out, metric="ms", items="bounces")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
