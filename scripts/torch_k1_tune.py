#!/usr/bin/env python3
"""Time a render kernel at the chunk shapes of its main paths, on one CUDA
device, and compare builds of it.

    python3 scripts/torch_k1_tune.py [--kernel k1|k2] [--variants] [--root DIR] [OUT.json]

--kernel k1 (the default) times the solid kernel, `solid_trace_chunk`, at
the chunk shape of the Cornell box (400x400, 26 spp, 4.16 M rays) and of
the dispersion example (400x300, 34 spp); --kernel k2 times the record
kernel, `record_trace_chunk` (tracing, texel fetches and the path
integral in one pass), at the chunk shapes of example 2 (400x300, 32 spp,
3.84 M rays) and of the primitives example (400x300, 34 spp).  Seed (99,
4242, 0), CUDA events (three rounds of KERNEL_REPS launches after a
warm-up) and the peak device memory of one launch; prints the kernel's
registers, local memory and static SASS instruction counts (cuobjdump
-sass).  --root takes the
raytracer_tpu_torch package and examples/ of another checkout (for
example an older commit unpacked under build/), so that two versions are
timed on one card in one call (its `record_trace_chunk` or
`solid_trace_chunk`, whatever it launches); everything else needs this
checkout's package:

- the kernel's bit-equality with its plain version on both chunks (L and
  rays_traced; on K2 the plain version is the records of
  record_trace_chunk_reference, replayed); on K1 the bounce-loop lane
  efficiency of both: the plain version's from its alive masks (`counts=`
  hook, warps of 32 consecutive rays), the kernel's from its own count of
  lane-iterations with a ray (probes/dead_bounce.py);
- --variants: the kernel rebuilt with other compile-time constants
  (VARIANTS; K1: block size, __launch_bounds__ minimum blocks per SM, free
  lanes before a refill, refractive hits before their shading pass; K2:
  block size and minimum blocks per SM), each held bit for bit against
  the default build on both chunks, then timed in turns with it, with its
  registers, spills (ptxas -v) and occupancy.

The last line is one JSON object (also written to OUT.json if given).
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNEL_REPS, ROUNDS = 10, 3
SEED = (99, 4242, 0)
# (scene, width, height, spp of the render whose chunk is timed)
SCENES = (("cornell", 400, 400, 256), ("dispersion", 400, 300, 256))
K2_SCENES = (("example2", 400, 300, 64), ("primitives", 400, 300, 64))
# K2_BLOCK, K2_MIN_BLOCKS; the default build is the first
K2_VARIANTS = ((256, 4),
               (128, 1), (128, 4), (128, 5), (128, 6), (128, 7), (128, 8),
               (128, 9), (128, 10), (64, 8), (64, 16), (256, 2))
# K1_BLOCK, K1_MIN_BLOCKS, K1_REFILL_MIN, K1_REFR_MIN; the default build
# is the first
VARIANTS = ((128, 8, 20, 8),
            # occupancy: block size and minimum blocks per SM
            (128, 1, 20, 8), (128, 6, 20, 8), (128, 7, 20, 8), (128, 9, 20, 8),
            (128, 10, 20, 8), (64, 16, 20, 8), (256, 4, 20, 8),
            # free lanes before a refill
            (128, 8, 1, 8), (128, 8, 4, 8), (128, 8, 8, 8), (128, 8, 12, 8),
            (128, 8, 16, 8), (128, 8, 24, 8), (128, 8, 32, 8),
            # refractive hits before their shading pass
            (128, 8, 20, 1), (128, 8, 20, 4), (128, 8, 20, 16),
            # every lane refilled at once, no deferral; and the first
            # build of this design (4 blocks of 128 an SM)
            (128, 8, 1, 1), (128, 1, 8, 1))


def sass_counts(lib_path, name="solid_trace_kernel"):
    """{opcode: static count} of the kernel `name` in a built library,
    and the total."""
    exe = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {}, False
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = name in m.group(1)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    counts = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    return {"total": sum(counts.values()), "ops": counts}


def ptxas_lines(log, name="solid_trace_kernel"):
    """ptxas -v's registers / stack / spill lines of kernel `name`."""
    lines, cur = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = name in ln
        elif cur and ("registers" in ln or "spill" in ln):
            lines.append(ln.split("info    :")[-1].strip())
    return lines


def cuda_ms(torch, fn, reps):
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_chunks(torch, dev, scenes):
    """{scene: solid_trace_chunk arguments} at each scene's chunk shape."""
    import torch_primitives
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.scene import plan_chunks
    from torch_cornellbox import build_cornell

    chunks = {}
    for name, w, h, spp in scenes:
        sc = build_cornell(w, h) if name == "cornell" else torch_primitives.BUILDERS[name](w, h)
        _, tables, s = sc._settings_for_render()
        fan = 1 << s.split_k
        chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, w, h, fan)
        chunks[name] = (torch.tensor(SEED, dtype=torch.int32, device=dev), tables.to(dev),
                        cam_vec(sc.camera.params()).to(dev), w, h, chunk, s.max_bounces,
                        s.split_k, s.sampler, s.projection)
    return chunks


def k2_chunks(torch, dev, scenes):
    """{scene: record_trace_chunk arguments} at each scene's chunk shape."""
    import torch_primitives
    import torch_textured
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.scene import plan_chunks

    chunks = {}
    for name, w, h, spp in scenes:
        sc = (torch_textured.example2(w, h) if name == "example2"
              else torch_primitives.BUILDERS[name](w, h))
        static, tables, s = sc._settings_for_render()
        fan = 1 << s.split_k
        chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, w, h, fan)
        chunks[name] = (torch.tensor(SEED, dtype=torch.int32, device=dev), static,
                        tables.to(dev), cam_vec(sc.camera.params()).to(dev), w, h,
                        chunk, s.max_bounces, s.split_k, s.sampler, s.projection)
    return chunks


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2"), default="k1")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("out", nargs="?", type=Path)
    opt = ap.parse_args()
    root, variants, k2 = opt.root.resolve(), opt.variants, opt.kernel == "k2"
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "examples"))
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_tune: no CUDA device", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st

    mod = rt if k2 else st
    this = hasattr(mod, "kernel_info")      # this checkout's package
    kname = "record_trace_kernel" if k2 else "solid_trace_kernel"
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": str(root), "kernel": opt.kernel,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__}
    chunks = k2_chunks(torch, dev, K2_SCENES) if k2 else k1_chunks(torch, dev, SCENES)
    first = next(iter(chunks.values()))
    lib = cuda_build.load_library()
    default_path = cuda_build.library_path("kernels")
    res["sass"] = sass_counts(default_path, kname)
    res["ptxas"] = ptxas_lines(cuda_build.build_log, kname)

    def launch(args, lib=None, lane_stats=None):
        if k2:
            return (rt.record_trace_chunk(*args) if lib is None
                    else rt._launch(*args, lib=lib))
        if lib is None and lane_stats is None:
            return st.solid_trace_chunk(*args)
        seed, tables, cam, w, h, spp, mb, split_k, sampler, proj = args
        return st._launch(seed, tables, cam, w, h, spp, mb, sampler, split_k, proj,
                          lane_stats=lane_stats, lib=lib)

    def plain(args):
        if not k2:
            return st.solid_trace_chunk_reference(*args)
        g, f, n = rt.record_trace_chunk_reference(*args)
        seed, static, tables, cam, w, h, spp, mb = args[:8]
        return rt.replay(g, f, static, tables, mb, spp * w * h), n

    def info(vlib=None):
        return (rt.kernel_info(first[1], first[2], vlib) if k2
                else st.kernel_info(first[1], vlib))

    if this:
        res["kernel_info"] = info()
        from raytracer_tpu_torch.probes import dead_bounce
        for name, args in chunks.items():
            L_k, n_k = launch(args)
            L_p, n_p = plain(args)
            torch.cuda.synchronize()
            res[name] = {"rays": L_k.shape[0], "chunk_spp": args[6 if k2 else 5],
                         "bit_equal": (L_k == L_p).all(dim=1).float().mean().item(),
                         "rays_traced": [int(n_k), int(n_p)]}
            if not k2:
                res[name].update(
                    lane_efficiency_plain=dead_bounce.plain_lane_efficiency(args),
                    lane_efficiency_kernel=dead_bounce.kernel_lane_efficiency(args))
            del L_k, L_p
            torch.cuda.empty_cache()
    builds = {"default": None}
    if variants and this:
        res["variants"] = {}
        if k2:
            defs = {f"block{b}_min{m}": (f"K2_BLOCK={b}", f"K2_MIN_BLOCKS={m}")
                    for b, m in K2_VARIANTS[1:]}
        else:
            defs = {f"block{b}_min{m}_refill{r}_refr{f}": (
                        f"K1_BLOCK={b}", f"K1_MIN_BLOCKS={m}", f"K1_REFILL_MIN={r}",
                        f"K1_REFR_MIN={f}")
                    for b, m, r, f in VARIANTS[1:]}
        with ThreadPoolExecutor(len(defs)) as ex:        # one nvcc per source each
            list(ex.map(lambda d: cuda_build.build("kernels", d), defs.values()))
        for key, defines in defs.items():
            vlib = cuda_build.load_library(defines)
            path = cuda_build.library_path("kernels", defines=defines)
            same, eff = {}, {}
            for name, args in chunks.items():
                (L0, n0), (L1, n1) = launch(args), launch(args, vlib)
                torch.cuda.synchronize()
                same[name] = bool(torch.equal(L0, L1)) and int(n0) == int(n1)
                del L0, L1
                if not k2:
                    stats = torch.zeros(2, dtype=torch.int64, device=dev)
                    launch(args, vlib, stats)
                    eff[name] = int(stats[0]) / int(stats[1])
            if not all(same.values()):
                raise SystemExit(f"variant {key} differs from the default build: {same}")
            res["variants"][key] = {"defines": defines, "kernel_info": info(vlib),
                                    "ptxas": ptxas_lines(cuda_build.build_logs.get(path, ""),
                                                         kname),
                                    "sass_total": sass_counts(path, kname)["total"],
                                    "bit_equal_to_default": same}
            if eff:
                res["variants"][key]["lane_efficiency_kernel"] = eff
            builds[key] = vlib
    # times: every build on both chunks, in turns, ROUNDS rounds
    times = {b: {name: [] for name in chunks} for b in builds}
    for name, args in chunks.items():
        for b, vlib in builds.items():
            launch(args, vlib)                 # warm-up
        for r in range(ROUNDS):
            order = list(builds.items())
            for b, vlib in (order if r % 2 == 0 else order[::-1]):
                times[b][name].append(cuda_ms(torch, lambda: launch(args, vlib), KERNEL_REPS))
    # peak device memory of one launch of the default build, above what
    # its inputs hold
    for name, args in chunks.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = launch(args)
        torch.cuda.synchronize()
        res.setdefault(name, {})["peak_mib"] = (
            torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        del out
    for b in builds:
        for name in chunks:
            t = times[b][name]
            entry = {"ms": statistics.mean(t), "ms_rounds": t}
            if b == "default":
                res.setdefault(name, {}).update(entry)
            else:
                res["variants"][b][name] = entry
    line = json.dumps(res)
    if opt.out:
        opt.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
