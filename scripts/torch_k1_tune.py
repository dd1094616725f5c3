#!/usr/bin/env python3
"""Time the solid kernel (K1) at the chunk shapes of its two main paths,
on one CUDA device, and compare builds of it.

    python3 scripts/torch_k1_tune.py [--variants] [--root DIR] [OUT.json]

Times `solid_trace_chunk` at the chunk shape of the Cornell box (400x400,
26 spp, 4.16 M rays) and of the dispersion example (400x300, 34 spp),
seed (99, 4242, 0), with CUDA events (three rounds of KERNEL_REPS
launches after a warm-up), and prints the kernel's registers, local
memory and static SASS instruction counts (cuobjdump -sass).  --root
takes the raytracer_tpu_torch package and examples/ of another checkout
(for example an older commit unpacked under build/), so that two
versions are timed on one card in one call; everything else needs this
checkout's package:

- the kernel's bit-equality with its plain version on both chunks (L and
  rays_traced), and the bounce-loop lane efficiency of both: the plain
  version's from its alive masks (`counts=` hook, warps of 32
  consecutive rays), the kernel's from its own count of lane-iterations
  with a ray (probes/dead_bounce.py);
- --variants: K1 rebuilt with other compile-time constants (VARIANTS:
  block size, __launch_bounds__ minimum blocks per SM, free lanes before
  a refill, refractive hits before their shading pass),
  each held bit for bit against the default build on both chunks, then
  timed in turns with it, with its registers, spills (ptxas -v) and
  occupancy.

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("out", nargs="?", type=Path)
    opt = ap.parse_args()
    root, variants = opt.root.resolve(), opt.variants
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "examples"))
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_tune: no CUDA device", file=sys.stderr)
        return 1
    import torch_primitives
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import solid_trace as st
    from torch_cornellbox import build_cornell

    this = hasattr(st, "kernel_info")       # this checkout's package
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "torch": torch.__version__}
    chunks = {}
    for name, w, h, spp in SCENES:
        sc = build_cornell(w, h) if name == "cornell" else torch_primitives.BUILDERS[name](w, h)
        _, tables, s = sc._settings_for_render()
        fan = 1 << s.split_k
        chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, w, h, fan)
        chunks[name] = (torch.tensor(SEED, dtype=torch.int32, device=dev), tables.to(dev),
                        cam_vec(sc.camera.params()).to(dev), w, h, chunk, s.max_bounces,
                        s.split_k, s.sampler, s.projection)
    lib = cuda_build.load_library()
    default_path = cuda_build.library_path("kernels")
    res["sass"] = sass_counts(default_path)
    res["ptxas"] = ptxas_lines(cuda_build.build_log)

    def launch(args, lib=None, lane_stats=None):
        if lib is None and lane_stats is None:
            return st.solid_trace_chunk(*args)
        seed, tables, cam, w, h, spp, mb, split_k, sampler, proj = args
        return st._launch(seed, tables, cam, w, h, spp, mb, sampler, split_k, proj,
                          lane_stats=lane_stats, lib=lib)

    if this:
        res["kernel_info"] = st.kernel_info(chunks["cornell"][1])
        from raytracer_tpu_torch.probes import dead_bounce
        for name, args in chunks.items():
            L_k, n_k = launch(args)
            L_p, n_p = st.solid_trace_chunk_reference(*args)
            torch.cuda.synchronize()
            res[name] = {"rays": L_k.shape[0], "chunk_spp": args[5],
                         "bit_equal": (L_k == L_p).all(dim=1).float().mean().item(),
                         "rays_traced": [int(n_k), int(n_p)],
                         "lane_efficiency_plain": dead_bounce.plain_lane_efficiency(args),
                         "lane_efficiency_kernel": dead_bounce.kernel_lane_efficiency(args)}
            del L_k, L_p
            torch.cuda.empty_cache()
    builds = {"default": None}
    if variants and this:
        res["variants"] = {}
        defs = {f"block{b}_min{m}_refill{r}_refr{f}": (
                    f"K1_BLOCK={b}", f"K1_MIN_BLOCKS={m}", f"K1_REFILL_MIN={r}",
                    f"K1_REFR_MIN={f}")
                for b, m, r, f in VARIANTS[1:]}
        with ThreadPoolExecutor(len(defs)) as ex:        # one nvcc per source each
            list(ex.map(lambda d: cuda_build.build("kernels", d), defs.values()))
        for key, defines in defs.items():
            vlib = cuda_build.load_library(defines)
            path = cuda_build.library_path("kernels", defines=defines)
            info = st.kernel_info(chunks["cornell"][1], vlib)
            same, eff = {}, {}
            for name, args in chunks.items():
                (L0, n0), (L1, n1) = launch(args), launch(args, vlib)
                torch.cuda.synchronize()
                same[name] = bool(torch.equal(L0, L1)) and int(n0) == int(n1)
                del L0, L1
                stats = torch.zeros(2, dtype=torch.int64, device=dev)
                launch(args, vlib, stats)
                eff[name] = int(stats[0]) / int(stats[1])
            if not all(same.values()):
                raise SystemExit(f"variant {key} differs from the default build: {same}")
            res["variants"][key] = {"defines": defines, "kernel_info": info,
                                    "ptxas": ptxas_lines(cuda_build.build_logs.get(path, "")),
                                    "sass_total": sass_counts(path)["total"],
                                    "bit_equal_to_default": same,
                                    "lane_efficiency_kernel": eff}
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
