"""Command-line interface: render scene files without writing a script.

Counterpart of raytracer_tpu/cli.py (sightpy has no CLI: every render is
a script run top to bottom)::

    python -m raytracer_tpu_torch render scene.py --spp 64 -o out.png
    python -m raytracer_tpu_torch render scene.py --spp 16 --denoise
    python -m raytracer_tpu_torch render scene.json --spp 16 --device cpu
    python -m raytracer_tpu_torch aovs scene.py -o aovs_{}.png
    python -m raytracer_tpu_torch ods scene.py --ipd 0.2
    python -m raytracer_tpu_torch animate scene.py --fps 24 -o frames/
    python -m raytracer_tpu_torch bake scene.py -o env.hdr
    python -m raytracer_tpu_torch convert scene.py -o scene.json
    python -m raytracer_tpu_torch devices

A scene file is a ``.json`` document (the schema of scene_io.py) or a
Python file whose ``Sc`` attribute or ``build_scene(**kwargs)`` (called
with --width / --height when given) is a ``raytracer_tpu_torch.Scene``;
any other scene (the JAX package's, say) raises, naming the file.
``animate`` and ``render --motion-blur`` also need the file's
``update_scene(scene, t)``.  Every command renders on the CUDA device
unless ``--device cpu`` asks for the CPU; ``--profile-dir`` writes a
torch.profiler trace; ``--sharded`` renders over every visible CUDA
device (``parallel.sharded.render_sharded``; one CPU shard with
``--device cpu``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def _load_scene(path, width=None, height=None):
    """(scene, module): the file's prebuilt ``Sc`` unless a resolution
    override needs ``build_scene(width=..., height=...)``."""
    import inspect

    from .core.scene import Scene

    path = Path(path)
    if not path.exists():
        raise SystemExit(f"scene file not found: {path}")
    if path.suffix.lower() == ".json":
        from .scene_io import load_scene_file

        try:
            return load_scene_file(path, width=width, height=height), None
        except ValueError as e:
            raise SystemExit(f"{path.name}: {e}")
    sys.path.insert(0, str(path.resolve().parent))
    # a unique registry key: a scene file named like an installed module
    # must not replace it in sys.modules
    mod_name = f"_raytracer_tpu_torch_scene_{path.stem}"
    spec = importlib.util.spec_from_file_location(mod_name, str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    kwargs = {}
    if width is not None:
        kwargs["width"] = width
    if height is not None:
        kwargs["height"] = height
    if hasattr(mod, "Sc") and not kwargs:
        sc = mod.Sc
    elif hasattr(mod, "build_scene"):
        if kwargs:
            params = inspect.signature(mod.build_scene).parameters
            accepts_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                             for p in params.values())
            missing = [k for k in kwargs if k not in params]
            if missing and not accepts_kw:
                raise SystemExit(
                    f"{path.name}: build_scene() does not accept "
                    f"{sorted(missing)} overrides")
        sc = mod.build_scene(**kwargs)
    elif hasattr(mod, "Sc"):
        raise SystemExit(
            f"{path.name} exposes a prebuilt Sc; --width/--height need "
            "a build_scene(width=..., height=...) entry point")
    else:
        raise SystemExit(
            f"{path.name} exposes neither `Sc` nor `build_scene()`")
    if not isinstance(sc, Scene):
        raise SystemExit(
            f"{path.name}: the scene is a {type(sc).__module__}."
            f"{type(sc).__name__}, not a raytracer_tpu_torch.Scene (build it "
            "with `from raytracer_tpu_torch import *`)")
    return sc, mod


def _add_common(p):
    p.add_argument("scene", help="scene file: .py exposing Sc or "
                                 "build_scene(), or a .json scene document")
    p.add_argument("--spp", type=int, default=16,
                   help="samples per pixel (reference estimator semantics)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=None,
                   help="override width (needs build_scene(width=...))")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: the scene file's path with a "
                        ".png suffix)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to render (default: the CUDA device)")


def _update_fn(args, mod, what):
    update = getattr(mod, "update_scene", None)
    if update is None:
        raise SystemExit(f"{Path(args.scene).name}: {what} needs an "
                         "update_scene(scene, t) function")
    return update


def _cmd_render(args):
    sc, mod = _load_scene(args.scene, args.width, args.height)
    out = args.out or str(Path(args.scene).with_suffix(".png"))
    stats = None
    custom_display = args.tonemap != "srgb" or args.exposure != 0.0
    if custom_display and (args.hdr or args.sharded or args.motion_blur
                           or args.denoise):
        raise SystemExit("--tonemap/--exposure apply to plain PNG renders "
                         "only (not --hdr/--sharded/--motion-blur/--denoise)")
    if args.preview and (args.sharded or args.motion_blur or args.denoise):
        raise SystemExit("--preview does not combine with "
                         "--sharded/--motion-blur/--denoise")
    t0 = time.time()
    if args.motion_blur:
        update = _update_fn(args, mod, "--motion-blur")
        for flag in ("denoise", "target_noise", "checkpoint", "profile_dir",
                     "clamp"):
            if getattr(args, flag):
                raise SystemExit(
                    f"--motion-blur does not combine with --{flag}")
        from .animation import render_motion_blur

        a, b = (float(x) for x in args.shutter.split(","))
        result = render_motion_blur(
            sc, args.spp, update, shutter=(a, b), slices=args.slices,
            seed=args.seed, output="linear" if args.hdr else "srgb",
            device=args.device)
        wall = time.time() - t0
        if args.hdr:
            from .utils.image_io import save_hdr

            out = str(Path(out).with_suffix(".hdr"))
            save_hdr(result, out)
        else:
            result.save(out)
        print(json.dumps({"out": out, "wall_s": round(wall, 3),
                          "spp": args.spp, "motion_blur": True}))
        return
    if args.sharded:
        import numpy as np
        import torch
        from PIL import Image

        for flag in ("denoise", "target_noise", "checkpoint", "profile_dir",
                     "hdr", "clamp"):
            if getattr(args, flag):
                raise SystemExit(f"--sharded does not combine with --{flag}")
        from .parallel.sharded import make_mesh, render_sharded

        devices = [torch.device("cpu")] if args.device == "cpu" else None
        a = np.asarray(render_sharded(sc, samples_per_pixel=args.spp,
                                      mesh=make_mesh(devices=devices),
                                      seed=args.seed))
        wall = time.time() - t0
        Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8)).save(out)
        print(json.dumps({"out": out, "wall_s": round(wall, 3),
                          "spp": args.spp, "sharded": True,
                          "device": args.device}))
        return
    if args.denoise:
        for flag in ("target_noise", "checkpoint", "profile_dir"):
            if getattr(args, flag):
                raise SystemExit(f"--denoise does not combine with --{flag}")
        result = sc.render_denoised(
            samples_per_pixel=args.spp, seed=args.seed, clamp=args.clamp,
            output="linear" if args.hdr else "pil", device=args.device)
    else:
        kw = dict(samples_per_pixel=args.spp, seed=args.seed,
                  progress_bar=args.progress, clamp=args.clamp,
                  tonemap=args.tonemap, exposure=args.exposure,
                  device=args.device)
        if args.target_noise is not None:
            kw["target_noise"] = args.target_noise
        if args.checkpoint:
            kw["checkpoint_path"] = args.checkpoint
        if args.profile_dir:
            kw["profile_dir"] = args.profile_dir
        if args.preview:
            kw["preview_path"] = args.preview
            kw["preview_every"] = args.preview_every
        if args.hdr:
            result = sc.render(output="linear", **kw)
        else:
            result, stats = sc.render(return_stats=True, **kw)
    wall = time.time() - t0
    if args.hdr:
        from .utils.image_io import save_hdr

        out = str(Path(out).with_suffix(".hdr"))
        save_hdr(result, out)
    else:
        result.save(out)
    line = {"out": out, "wall_s": round(wall, 3), "spp": args.spp,
            "device": args.device}
    if stats:
        line["samples_per_pixel_traced"] = int(stats["samples"])
        line["mrays_per_s"] = round(stats["mrays_per_s"], 1)
    print(json.dumps(line))


def _aov_display(name, plane):
    """An AOV plane as an 8-bit RGB array: normals mapped from [-1, 1],
    planes outside [0, 1] stretched to it (cli.py:244-259)."""
    import numpy as np

    a = np.asarray(plane, np.float32)
    if a.ndim == 2:
        a = a[..., None].repeat(3, -1)
    lo, hi = float(a.min()), float(a.max())
    if name == "normal":
        a = a * 0.5 + 0.5
    elif hi > 1.0 or lo < 0.0:
        a = (a - lo) / max(hi - lo, 1e-9)
    return (np.clip(a, 0, 1) * 255).astype(np.uint8)


def _cmd_aovs(args):
    from PIL import Image

    sc, _ = _load_scene(args.scene, args.width, args.height)
    aovs = sc.render_aovs(samples_per_pixel=args.spp, seed=args.seed,
                          ao_samples=args.ao_samples, ao_radius=args.ao_radius,
                          device=args.device)
    pattern = args.out or str(Path(args.scene).with_suffix("")) + "_{}.png"
    if "{}" not in pattern:
        raise SystemExit("--out for aovs must contain '{}' (plane name)")
    outs = []
    for name, plane in aovs.items():
        out = pattern.format(name)
        Image.fromarray(_aov_display(name, plane)).save(out)
        outs.append(out)
    print(json.dumps({"planes": list(aovs), "files": outs}))


def _cmd_ods(args):
    from .vr import render_ods

    sc, _ = _load_scene(args.scene, args.width, args.height)
    out = args.out or str(Path(args.scene).with_suffix("")) + "_ods.png"
    t0 = time.time()
    img = render_ods(sc, samples_per_pixel=args.spp, ipd=args.ipd,
                     seed=args.seed, layout=args.layout, clamp=args.clamp,
                     device=args.device)
    wall = time.time() - t0
    img.save(out)
    print(json.dumps({"out": out, "wall_s": round(wall, 3), "spp": args.spp,
                      "ipd": args.ipd, "layout": args.layout}))


def _cmd_animate(args):
    from .animation import create_animation, create_animation_using_opencv

    path = Path(args.scene)
    sc, mod = _load_scene(args.scene, args.width, args.height)
    update = _update_fn(args, mod, "animate")
    out = args.out or str(path.with_suffix(".avi"))
    t0 = time.time()
    if out.endswith((".avi", ".mp4")):
        fps = create_animation_using_opencv(
            sc, args.spp, args.fps, args.t0, args.t1, update, out,
            device=args.device)
    else:                                   # --out is a frames directory
        fps = create_animation(sc, args.spp, args.fps, args.t0, args.t1,
                               update, path.with_suffix("").name,
                               frames_dir=out, device=args.device)
    print(json.dumps({"out": out, "wall_s": round(time.time() - t0, 3),
                      "frames_per_s": round(fps, 2)}))


def _cmd_bake(args):
    """Bake the scene into an equirect environment map (.hdr)."""
    from .utils.image_io import save_hdr

    sc, _ = _load_scene(args.scene)
    center = tuple(float(x) for x in args.center.split(","))
    if len(center) != 3:
        raise SystemExit("--center must be x,y,z")
    t0 = time.time()
    env = sc.render_environment(width=args.width or 512,
                                height=args.height or 256,
                                samples_per_pixel=args.spp, center=center,
                                seed=args.seed, device=args.device)
    out = args.out or str(Path(args.scene).with_suffix(".hdr"))
    save_hdr(env, out)
    print(json.dumps({"out": out, "wall_s": round(time.time() - t0, 3),
                      "shape": list(env.shape)}))


def _cmd_convert(args):
    """Export a Python scene file as a JSON scene document."""
    from .scene_io import save_scene_file

    sc, _ = _load_scene(args.scene, args.width, args.height)
    out = args.out or str(Path(args.scene).with_suffix(".json"))
    try:
        save_scene_file(sc, out)
    except ValueError as e:
        raise SystemExit(f"{Path(args.scene).name}: {e}")
    print(json.dumps({"out": out, "objects": len(sc.scene_primitives),
                      "lights": len(sc.Light_list)}))


def _cmd_devices(_args):
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "backend": "cuda" if n else "cpu",
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch",
        description="PyTorch / CUDA ray tracer (sightpy-compatible scenes)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene file to PNG/HDR")
    _add_common(pr)
    pr.add_argument("--denoise", action="store_true",
                    help="AOV-guided variance-weighted a-trous denoise")
    pr.add_argument("--target-noise", type=float, default=None,
                    help="adaptive sampling: stop at this display-space "
                         "standard error (spp becomes the budget cap)")
    pr.add_argument("--clamp", type=float, default=None,
                    help="per-sample linear radiance ceiling (fireflies)")
    pr.add_argument("--hdr", action="store_true",
                    help="write linear Radiance .hdr instead of PNG")
    pr.add_argument("--checkpoint", default=None,
                    help="accumulator checkpoint path (resume on rerun)")
    pr.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace here")
    pr.add_argument("--progress", action="store_true")
    pr.add_argument("--sharded", action="store_true",
                    help="render over every visible CUDA device (one CPU "
                         "shard with --device cpu)")
    pr.add_argument("--motion-blur", action="store_true",
                    help="integrate over an open shutter via the scene "
                         "file's update_scene(scene, t)")
    pr.add_argument("--shutter", default="0,1",
                    help="shutter interval as t0,t1 (with --motion-blur)")
    pr.add_argument("--slices", type=int, default=None,
                    help="shutter slices (default min(32, spp))")
    pr.add_argument("--tonemap", default="srgb",
                    choices=("srgb", "aces", "reinhard"),
                    help="display mapping (default: the reference's sRGB "
                         "pipeline; aces/reinhard roll highlights off)")
    pr.add_argument("--exposure", type=float, default=0.0,
                    help="exposure in stops")
    pr.add_argument("--preview", default=None,
                    help="progressive preview PNG path, refreshed as "
                         "chunks accumulate")
    pr.add_argument("--preview-every", type=int, default=4,
                    help="chunks between preview refreshes")
    pr.set_defaults(fn=_cmd_render)

    pn = sub.add_parser(
        "animate", help="render an animation; the scene file must also "
                        "expose update_scene(scene, t)")
    _add_common(pn)
    pn.add_argument("--fps", type=float, default=24.0)
    pn.add_argument("--t0", type=float, default=0.0)
    pn.add_argument("--t1", type=float, default=1.0)
    pn.set_defaults(fn=_cmd_animate)

    pa = sub.add_parser("aovs", help="render denoiser feature planes")
    _add_common(pa)
    pa.add_argument("--ao-samples", type=int, default=0,
                    help="add an ambient-occlusion plane with this many "
                         "hemisphere samples per hit")
    pa.add_argument("--ao-radius", type=float, default=None,
                    help="AO occlusion radius in world units "
                         "(default: unbounded sky visibility)")
    pa.set_defaults(fn=_cmd_aovs)

    po = sub.add_parser("ods", help="render a stereo 360 (omni-directional "
                                    "stereo) frame for VR playback")
    _add_common(po)
    po.add_argument("--ipd", type=float, default=0.064,
                    help="interpupillary distance in world units")
    po.add_argument("--layout",
                    choices=("top-bottom", "side-by-side", "anaglyph"),
                    default="top-bottom",
                    help="stereo packing of the output frame")
    po.add_argument("--clamp", type=float, default=None,
                    help="per-sample firefly ceiling (as render --clamp)")
    po.set_defaults(fn=_cmd_ods)

    pb = sub.add_parser("bake", help="bake the scene into an equirect "
                                     "environment .hdr")
    _add_common(pb)
    pb.add_argument("--center", default="0,0,0",
                    help="bake viewpoint as x,y,z (default origin)")
    pb.set_defaults(fn=_cmd_bake)

    pc = sub.add_parser("convert", help="export a scene file as a JSON "
                                        "scene document")
    _add_common(pc)
    pc.set_defaults(fn=_cmd_convert)

    pd = sub.add_parser("devices", help="print the torch CUDA devices")
    pd.set_defaults(fn=_cmd_devices)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
