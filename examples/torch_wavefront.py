"""A scene past the kernels' gates, through the PyTorch / CUDA port's
wavefront: the grid of scripts/probe_obj_cap.py.

`grid(n)` builds n diffuse spheres in a square grid on a ground plane
under an emissive sky sphere, so n + 2 objects: from n = 47 on the scene
has more than the kernels' 48 objects and renders on the wavefront
(core/integrator.py); at n = 46 it is inside the gate and renders on the
solid kernel unless RenderSettings(use_pallas="never").  Each sphere has
its own diffuse material (random colours from a seeded generator), with
diffuse_rays=1.

    python examples/torch_wavefront.py 96    # grid_96_torch.png, 16 spp

`lamp_cluster(k)` builds k small importance-sampled lamps in one cluster
over a diffuse floor: a diffuse bounce samples the cosine lobe or one of
k light caps, and from the floor a direction falls inside many of the
overlapping caps at once, so the mixture's pdf sums k terms of which
many are not zero (core/rng.py `caps_pdf_value`).

`grid` takes the package to build with (`m=`, default: the port), so the
tests build the same scene with the JAX package.  Pillow is needed only
to write the image file.
"""
import importlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def grid(n, width=400, height=300, n_materials=None, m=None):
    """n diffuse spheres, a ground plane and an emissive sky
    (scripts/probe_obj_cap.py:25-50)."""
    m = m if m is not None else importlib.import_module("raytracer_tpu_torch")
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 3.0, 9), look_at=m.vec3(0, 0, 0),
                  screen_width=width, screen_height=height, field_of_view=35)
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(1)
    n_materials = n_materials or n
    mats = [m.Diffuse(diff_color=m.rgb(*rng.uniform(0.2, 0.9, 3)),
                      diffuse_rays=1) for _ in range(n_materials)]
    for i in range(n):
        gx, gz = i % side, i // side
        x = (gx - (side - 1) / 2) * 1.2
        z = (gz - (side - 1) / 2) * 1.2
        sc.add(m.Sphere(material=mats[i % n_materials],
                        center=m.vec3(x, 0.0, z), radius=0.45, max_ray_depth=3))
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.65),
                                      diffuse_rays=1),
                   center=m.vec3(0, -0.5, 0), width=60.0, height=60.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(1.1, 1.1, 1.2)),
                    center=m.vec3(0, 0, 0), radius=50.0, shadow=False))
    return sc


def lamp_cluster(k, width=400, height=300, m=None):
    """k emissive spheres, each importance-sampled, jittered about one
    point 2.5 over a diffuse floor, behind them a diffuse wall."""
    m = m if m is not None else importlib.import_module("raytracer_tpu_torch")
    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=m.vec3(0, 1.5, 6), look_at=m.vec3(0, 0.5, 0),
                  screen_width=width, screen_height=height, field_of_view=50)
    rng = np.random.default_rng(2)
    for _ in range(k):
        c = rng.uniform(-0.3, 0.3, 3)
        sc.add(m.Sphere(material=m.Emissive(color=m.rgb(*rng.uniform(2, 6, 3))),
                        center=m.vec3(c[0], 2.5 + c[1], c[2]),
                        radius=float(rng.uniform(0.1, 0.3))),
               importance_sampled=True)
    floor = m.Diffuse(diff_color=m.rgb(0.7, 0.7, 0.7), diffuse_rays=1)
    sc.add(m.Plane(material=floor, center=m.vec3(0, 0, 0), width=20.0,
                   height=20.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.5, 0.3, 0.2),
                                      diffuse_rays=1),
                   center=m.vec3(0, 2, -3), width=20.0, height=20.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    return sc


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    img = grid(n).render(samples_per_pixel=16, progress_bar=True)
    img.save(f"grid_{n}_torch.png")
