#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels (raytracer_tpu_torch/csrc: the solid kernel and
the record kernel, one nvcc per source, started together) from the
checkout and drives both render paths:

- solid: holds the solid kernel against its plain PyTorch version,
  renders the reference Cornell box at 400x400 x 256 spp through
  Scene.render (5,120 paths per pixel in 197 chunks of 26 spp), checks
  the image against the plain version, and at the chunk shape (4.16 M
  rays) holds the kernel against the plain version ray by ray and times
  both;
- record: holds the record kernel (records and replayed radiance)
  against its plain version on examples 1-4 at 32x32 x 16 spp, renders
  example 2 at 400x300 x 64 spp through Scene.render (512 paths per pixel
  with the x8 Fresnel-split fan, 16 chunks of 32 spp), checks the image
  against plain-version chunks, and at the chunk shape (3.84 M rays)
  holds kernel + replay against the plain version and times the kernel,
  the replay and the plain version.

Each phase prints one line; any failure exits non-zero before the last
line, which is {"ok": true, "device": {...}}.  Without a CUDA device it
exits 1.  Imports neither jax nor raytracer_tpu.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, SPP = 400, 400, 256             # the main path (bench.py's Cornell)
CHECK_W, CHECK_H, CHECK_SPP = 64, 64, 16   # kernel vs plain: 65,536 rays
MATCH_RTOL, MATCH_ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999
REF_SPP = 20                          # plain-version chunk of the image check
TIMED_RENDERS = 3
KERNEL_REPS = 20
# the record path: example 2 at its own settings
REC_W, REC_H, REC_SPP = 400, 300, 64
REC_CHECK = 32, 32, 16                # kernel vs plain on examples 1-4
REC_REF_CHUNKS = 2                    # plain-version chunks of the image check
REC_KERNEL_REPS = 10


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def nvcc_version(cuda_build):
    res = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[-1]


def cuda_ms(fn, reps):
    """Mean milliseconds of `reps` calls of fn, timed with CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_records(rec_k, rec_p):
    """Share of equal group words, per-element match rate of the shading
    floats, and both rays_traced counts."""
    import torch
    (g_k, f_k, n_k), (g_p, f_p, n_p) = rec_k, rec_p
    torch.cuda.synchronize()
    words = (g_k == g_p).float().mean().item()
    floats = torch.isclose(f_k, f_p, rtol=MATCH_RTOL,
                           atol=MATCH_ATOL).float().mean().item()
    return words, floats, int(n_k), int(n_p)


def compare(L_k, L_p, n_k, n_p):
    """Per-ray match rate, max abs error, bit-equal share and both counts."""
    import torch
    torch.cuda.synchronize()
    match = torch.isclose(L_k, L_p, rtol=MATCH_RTOL, atol=MATCH_ATOL).all(dim=1)
    return (match.float().mean().item(), (L_k - L_p).abs().max().item(),
            (L_k == L_p).all(dim=1).float().mean().item(), int(n_k), int(n_p))


def scene_inputs(build_cornell, width, height, device):
    from raytracer_tpu_torch.core.camera import cam_vec

    sc = build_cornell(width, height)
    _, tables, settings = sc._settings_for_render()
    return sc, tables.to(device), cam_vec(sc.camera.params()).to(device), settings


def record_phases(torch, dev):
    """The record path's phases; returns the record kernel's row of the
    kernels line."""
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import record_trace as rt
    import torch_textured

    # ---- record kernel vs plain version on examples 1-4 ----
    W, H, spp = REC_CHECK
    for k, build in torch_textured.EXAMPLES.items():
        sc = build(W, H, **({"blur": 0.0} if k == 4 else {}))
        static, tables, settings = sc._settings_for_render()
        tables = tables.to(dev)
        cam = cam_vec(sc.camera.params()).to(dev)
        seed = torch.tensor([20260916 + k, 4242, 0], dtype=torch.int32,
                            device=dev)
        args = (seed, static, tables, cam, W, H, spp, settings.max_bounces,
                settings.split_k)
        rec_k, rec_p = rt.record_paths(*args), rt.record_trace_chunk_reference(*args)
        words, floats, n_k, n_p = compare_records(rec_k, rec_p)
        n = W * H * spp
        L_k = rt.replay(*rec_k[:2], static, tables, settings.max_bounces, n)
        L_p = rt.replay(*rec_p[:2], static, tables, settings.max_bounces, n)
        rate, max_err, bit_eq, _, _ = compare(L_k, L_p, n_k, n_p)
        print(f"record kernel vs plain, example {k}{' (blur 0)' if k == 4 else ''}: "
              f"{n} rays, max_bounces {settings.max_bounces}, split_k "
              f"{settings.split_k}, replay rounds {rt.replay_rounds(static)} | "
              f"words equal {words:.6f}, floats match {floats:.6f} | L match "
              f"{rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e} | "
              f"rays_traced {n_k} vs {n_p}", flush=True)
        require(words >= MATCH_RATE and floats >= MATCH_RATE and rate >= MATCH_RATE,
                f"example {k}: records or L disagree with the plain version")
        require(n_k == n_p, f"example {k}: rays_traced {n_k} != {n_p}")
        require(bool(torch.isfinite(L_k).all()), f"example {k}: non-finite L")

    # ---- the record path's main path: example 2 through Scene.render ----
    sc = torch_textured.example2(REC_W, REC_H)
    static, tables, settings = sc._settings_for_render()
    require(static.pallas_tex_ok and settings.split_k == 3,
            "example 2 does not take the record path with split_k 3")
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(REC_SPP * fan, REC_W, REC_H, fan)
    require((chunk, n_chunks) == (32, 16), f"chunk plan {(chunk, n_chunks)}")
    rt.record_paths.launches = 0
    walls, stats = [], None
    for _ in range(1 + TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = sc.render(samples_per_pixel=REC_SPP, output="linear",
                               return_stats=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = rt.record_paths.launches
    require(launches == n_chunks * (1 + TIMED_RENDERS),
            f"{launches} record kernel launches for {1 + TIMED_RENDERS} renders")
    wall = statistics.median(walls[1:])
    mrays = stats["rays_traced"] / wall / 1e6
    require(img.shape == (REC_H, REC_W, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(torch.from_numpy(img)).all()), "non-finite image")
    img_mean = float(img.mean())
    # plain-version chunks of the same frame; the mean of each block of
    # 2^split_k consecutive samples (one of every branch pattern) is one
    # unbiased observation
    tables = tables.to(dev)
    cam = cam_vec(sc.camera.params()).to(dev)
    blocks = []
    for i in range(REC_REF_CHUNKS):
        ref_seed = torch.tensor([777 + i, 31337, i * chunk], dtype=torch.int32,
                                device=dev)
        rec = rt.record_trace_chunk_reference(
            ref_seed, static, tables, cam, REC_W, REC_H, chunk,
            settings.max_bounces, settings.split_k)
        L_ref = rt.replay(*rec[:2], static, tables, settings.max_bounces,
                          chunk * REC_W * REC_H)
        L_ref = torch.where(torch.isfinite(L_ref), L_ref, 0.0)
        blocks.append(L_ref.view(chunk // fan, -1).mean(dim=1).double())
        del rec, L_ref
    blocks = torch.cat(blocks)
    ref_mean = blocks.mean().item()
    se = (blocks.std() / len(blocks) ** 0.5).item()
    print(f"record main path: Scene.render example 2 {REC_W}x{REC_H} x {REC_SPP} "
          f"spp (x{fan} split fan), {n_chunks} chunks of {chunk} spp, {launches} "
          f"record kernel launches in {1 + TIMED_RENDERS} renders | wall "
          f"{wall:.4f} s (median of {TIMED_RENDERS}; "
          f"{', '.join(f'{w:.4f}' for w in walls)}) | rays_traced "
          f"{stats['rays_traced']} | {mrays:.1f} Mrays/s | image mean "
          f"{img_mean:.6f}, plain {REC_REF_CHUNKS} x {chunk}-spp chunks "
          f"{ref_mean:.6f} +- {se:.6f} ({len(blocks)} blocks)", flush=True)
    require(abs(img_mean - ref_mean) < 4 * se,
            f"image mean {img_mean} vs plain {ref_mean} (4 SE = {4 * se})")

    # ---- record kernel + replay vs plain at the chunk shape (3.84 M rays) ----
    n = chunk * REC_W * REC_H
    B = settings.max_bounces
    seed = torch.tensor([99, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, static, tables, cam, REC_W, REC_H, chunk, B, settings.split_k)
    kernel = lambda: rt.record_paths(*args)
    plain = lambda: rt.record_trace_chunk_reference(*args)
    rec_k, rec_p = kernel(), plain()                 # also the warm-up
    words, floats, n_k, n_p = compare_records(rec_k, rec_p)
    L_k = rt.replay(*rec_k[:2], static, tables, B, n)
    L_p = rt.replay(*rec_p[:2], static, tables, B, n)
    rate, max_err, bit_eq, _, _ = compare(L_k, L_p, n_k, n_p)
    print(f"record kernel + replay vs plain at the chunk shape: {n} rays | words "
          f"equal {words:.6f}, floats match {floats:.6f} | L match {rate:.6f}, "
          f"bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e} | rays_traced "
          f"{n_k} vs {n_p}", flush=True)
    require(words >= MATCH_RATE and floats >= MATCH_RATE and rate >= MATCH_RATE,
            f"chunk-shape match: words {words}, floats {floats}, L {rate}")
    require(n_k == n_p, f"chunk-shape rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), "non-finite kernel output")
    del rec_p, L_k, L_p
    replay = lambda: rt.replay(*rec_k[:2], static, tables, B, n)
    torch.cuda.reset_peak_memory_stats(dev)
    plain_ms = [cuda_ms(plain, 1)]
    kernel_ms = [cuda_ms(kernel, REC_KERNEL_REPS), cuda_ms(kernel, REC_KERNEL_REPS)]
    replay_ms = [cuda_ms(replay, REC_KERNEL_REPS), cuda_ms(replay, REC_KERNEL_REPS)]
    plain_ms.append(cuda_ms(plain, 1))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms, r_ms, p_ms = (statistics.mean(x) for x in (kernel_ms, replay_ms, plain_ms))
    print(f"record chunk timing: {chunk} spp x {REC_W}x{REC_H} = {n} rays, "
          f"{B} bounces | kernel {ms:.3f} ms ({', '.join(f'{x:.3f}' for x in kernel_ms)}) "
          f"| replay {r_ms:.3f} ms ({', '.join(f'{x:.3f}' for x in replay_ms)}) | "
          f"plain record {p_ms:.1f} ms ({', '.join(f'{x:.1f}' for x in plain_ms)}) | "
          f"peak {peak_gib:.2f} GiB", flush=True)
    return {"name": "record_trace", "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/record_trace.cu",
            "replaces": "raytracer_tpu/ops/pallas_record.py:182",
            "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": p_ms}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import solid_trace as st
    from torch_cornellbox import build_cornell

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # ---- phase 1: device ----
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc_version(cuda_build)}", flush=True)

    # ---- phase 2: build the kernels from the checkout ----
    t0 = time.perf_counter()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.build_log.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.2f} s | {' | '.join(ptxas)}", flush=True)

    # ---- phase 3: kernel vs plain version, Cornell 64x64 x 16 spp ----
    _, tables, cam, settings = scene_inputs(build_cornell, CHECK_W, CHECK_H, dev)
    seed = torch.tensor([20260916, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, tables, cam, CHECK_W, CHECK_H, CHECK_SPP, settings.max_bounces)
    L_k, n_k = st.solid_trace_chunk(*args)
    L_p, n_p = st.solid_trace_chunk_reference(*args)
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    print(f"kernel vs plain: {L_k.shape[0]} rays, max_bounces "
          f"{settings.max_bounces}, match {rate:.6f} (rtol {MATCH_RTOL}, atol "
          f"{MATCH_ATOL}), bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e}, "
          f"rays_traced {n_k} vs {n_p}", flush=True)
    require(rate >= MATCH_RATE, f"match rate {rate} < {MATCH_RATE}")
    require(n_k == n_p, f"rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), "non-finite kernel output")

    # ---- phase 4: the solid main path through Scene.render ----
    sc, tables, cam, settings = scene_inputs(build_cornell, W, H, dev)
    chunk, n_chunks = plan_chunks(SPP * sc._diffuse_fan(), W, H)
    require((chunk, n_chunks) == (26, 197), f"chunk plan {(chunk, n_chunks)}")
    st.solid_trace_chunk.launches = 0
    walls, stats = [], None
    for _ in range(1 + TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = sc.render(samples_per_pixel=SPP, output="linear",
                               return_stats=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = st.solid_trace_chunk.launches
    require(launches == n_chunks * (1 + TIMED_RENDERS),
            f"{launches} kernel launches for {1 + TIMED_RENDERS} renders")
    wall = statistics.median(walls[1:])
    mrays = stats["rays_traced"] / wall / 1e6
    require(img.shape == (H, W, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(torch.from_numpy(img)).all()), "non-finite image")
    img_mean = float(img.mean())
    # the plain version on one 20-spp chunk of the same frame
    ref_seed = torch.tensor([777, 31337, 0], dtype=torch.int32, device=dev)
    L_ref, _ = st.solid_trace_chunk_reference(ref_seed, tables, cam, W, H,
                                              REF_SPP, settings.max_bounces)
    L_ref = torch.where(torch.isfinite(L_ref), L_ref, 0.0)
    per_sample = L_ref.view(REF_SPP, -1).mean(dim=1).double()
    ref_mean = per_sample.mean().item()
    se = (per_sample.std() / REF_SPP ** 0.5).item()
    print(f"main path: Scene.render {W}x{H} x {SPP} spp, {n_chunks} chunks of "
          f"{chunk} spp, {launches} kernel launches in {1 + TIMED_RENDERS} "
          f"renders | wall {wall:.4f} s (median of {TIMED_RENDERS}; "
          f"{', '.join(f'{w:.4f}' for w in walls)}) | rays_traced "
          f"{stats['rays_traced']} | {mrays:.1f} Mrays/s | image mean "
          f"{img_mean:.6f}, plain {REF_SPP}-spp chunk {ref_mean:.6f} +- "
          f"{se:.6f}", flush=True)
    require(abs(img_mean - ref_mean) < 4 * se,
            f"image mean {img_mean} vs plain {ref_mean} (4 SE = {4 * se})")
    del L_ref, per_sample

    # ---- phase 5: kernel vs plain at the chunk shape (4.16 M rays) ----
    seed = torch.tensor([99, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, tables, cam, W, H, chunk, settings.max_bounces)
    kernel = lambda: st.solid_trace_chunk(*args)
    plain = lambda: st.solid_trace_chunk_reference(*args)
    (L_k, n_k), (L_p, n_p) = kernel(), plain()     # also the warm-up
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    print(f"kernel vs plain at the chunk shape: {L_k.shape[0]} rays, match "
          f"{rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e}, "
          f"rays_traced {n_k} vs {n_p}", flush=True)
    require(rate >= MATCH_RATE, f"chunk-shape match rate {rate} < {MATCH_RATE}")
    require(n_k == n_p, f"chunk-shape rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), "non-finite kernel output")
    del L_k, L_p
    torch.cuda.reset_peak_memory_stats(dev)
    plain_ms = [cuda_ms(plain, 1)]
    kernel_ms = [cuda_ms(kernel, KERNEL_REPS), cuda_ms(kernel, KERNEL_REPS)]
    plain_ms.append(cuda_ms(plain, 1))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    print(f"chunk timing: {chunk} spp x {W}x{H} = {chunk * W * H} rays | "
          f"kernel {ms:.3f} ms ({', '.join(f'{x:.3f}' for x in kernel_ms)}) | "
          f"plain {p_ms:.1f} ms ({', '.join(f'{x:.1f}' for x in plain_ms)}) | "
          f"peak {peak_gib:.2f} GiB", flush=True)

    solid_row = {
        "name": "solid_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/solid_trace.cu",
        "replaces": "raytracer_tpu/ops/pallas_trace.py:508",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": p_ms}
    del tables, cam
    torch.cuda.empty_cache()
    record_row = record_phases(torch, dev)

    print(json.dumps({"kernels": [solid_row, record_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
