"""Inverse rendering through the PyTorch / CUDA port: recover a glass IoR
by gradient descent (examples/inverse_rendering.py with torch.optim.Adam
in place of optax).

Renders a target at IoR 1.52, then runs Adam on the pixel MSE from 1.20
straight through the wavefront (raytracer_tpu_torch/diff.py), one
forward and backward pass a step.

    python examples/torch_inverse_rendering.py                 # 96x72 @ 8 spp
    python examples/torch_inverse_rendering.py --quick --device cpu

Prints a line every ten steps, then one JSON line (steps, the mean step
wall after the first, the recovered IoR); --out DIR writes
INVERSE_target.png / _start.png / _final.png there.  `build_scene(n, W,
H, m=)` builds the scene with either package, `build_mesh_scene` the
same scene with the glass sphere as a clustered icosphere mesh.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import raytracer_tpu_torch as T  # noqa: E402
from raytracer_tpu_torch.diff import (differentiable_render,  # noqa: E402
                                      safe_value_and_grad, update_materials)

TRUE_N, START_N = 1.52, 1.20


def build_scene(n, width, height, m=None):
    """A glass sphere before two emissive lobes in a dark enclosure
    (examples/inverse_rendering.py build_scene)."""
    m = m or T
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=width, screen_height=height, field_of_view=35)
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(n + 1e-6j, n + 1e-6j,
                                                   n + 1e-6j)),
                    center=m.vec3(0, 0, 0), radius=0.55, shadow=False,
                    max_ray_depth=3))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.9, 0.55, 0.25)),
                    center=m.vec3(-14, 6, -8), radius=12.0, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.2, 0.45, 0.9)),
                    center=m.vec3(14, -6, -8), radius=12.0, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.05, 0.05, 0.07)),
                    center=m.vec3(0, 0, 0), radius=40.0, shadow=False))
    return sc


def build_mesh_scene(n, width, height, obj_dir, subdiv=3, m=None):
    """build_scene with the glass sphere as a smooth icosphere mesh of the
    same radius (20 * 4**subdiv faces; 1,280 by default, past
    TRI_CLUSTER_THRESHOLD, so the wavefront sweeps it in clusters).  The
    OBJ file is written into obj_dir."""
    import torch_mesh

    m = m or T
    path = str(Path(obj_dir) / f"icosphere{subdiv}.obj")
    torch_mesh.write_icosphere_obj(path, subdiv=subdiv)
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=width, screen_height=height, field_of_view=35)
    sc.add(m.TriangleMesh(path, center=m.vec3(0, 0, 0), scale=0.55,
                          material=m.Refractive(n=m.vec3(n + 1e-6j, n + 1e-6j,
                                                         n + 1e-6j)),
                          shadow=False, max_ray_depth=3, smooth=True))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.9, 0.55, 0.25)),
                    center=m.vec3(-14, 6, -8), radius=12.0, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.2, 0.45, 0.9)),
                    center=m.vec3(14, -6, -8), radius=12.0, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.05, 0.05, 0.07)),
                    center=m.vec3(0, 0, 0), radius=40.0, shadow=False))
    return sc


def save(img, path):
    from PIL import Image

    srgb = T.srgb_linear_to_srgb(torch.clamp_min(img.detach().cpu(), 0.0))
    Image.fromarray((np.clip(srgb.numpy(), 0, 1) * 255).astype(np.uint8)
                    ).save(path)


def recover(width=96, height=72, spp=8, steps=60, lr=2e-2, device=None,
            out=None, log=print):
    """Adam on the IoR from START_N; returns a dict of the run."""
    fn, data = differentiable_render(build_scene(TRUE_N, width, height), spp,
                                     seed=0, device=device)
    with torch.no_grad():
        target = fn(data)

    def loss(n):
        n_re = n.expand_as(data.mats.refr_n_re)
        return torch.mean((fn(update_materials(data, refr_n_re=n_re))
                           - target) ** 2)

    n = torch.tensor(START_N, dtype=torch.float32,
                     device=data.ambient_color.device)
    if out is not None:
        save(target, Path(out) / "INVERSE_target.png")
        with torch.no_grad():
            save(fn(update_materials(data, refr_n_re=n.expand_as(
                data.mats.refr_n_re))), Path(out) / "INVERSE_start.png")
    opt = torch.optim.Adam([n.requires_grad_(True)], lr=lr)
    vg = safe_value_and_grad(loss)
    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        v, g = vg(n.detach())
        opt.zero_grad()
        n.grad = g
        opt.step()
        if n.is_cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  n={float(n.detach()):.4f}  loss={float(v):.3e}  "
                f"grad={float(g):+.2e}  {walls[-1]:.3f} s")
    if out is not None:
        with torch.no_grad():
            save(fn(update_materials(data, refr_n_re=n.detach().expand_as(
                data.mats.refr_n_re))), Path(out) / "INVERSE_final.png")
    return dict(steps=steps, width=width, height=height, spp=spp,
                step_s=float(np.mean(walls[1:] if steps > 1 else walls)),
                first_step_s=walls[0], recovered_n=float(n.detach()),
                true_n=TRUE_N, start_n=START_N)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    W, H, spp = (32, 24, 2) if args.quick else (96, 72, 8)
    res = recover(W, H, spp, args.steps, device=args.device, out=args.out)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
