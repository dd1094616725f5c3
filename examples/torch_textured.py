"""sightpy's examples 1-4 through the PyTorch / CUDA port (the scenes of
example1.py - example4.py, line for line), with _assets.py's procedural
fallbacks: a checkerboard floor and the procedural sky instead of the
bundled images, so no asset files and no Pillow are needed (except for
blur > 0, which Pillow computes).

    python examples/torch_textured.py 2    # writes example2_torch.png

Every scene function takes the package to build with (default: the
port), so the tests build the same scene with the JAX package.  All four
scenes render through the record kernel (records and replay in the plain
version on the CPU).
"""
import importlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _pkg(m):
    return m if m is not None else importlib.import_module("raytracer_tpu_torch")


def _floor_texture(m, repeat):
    checkerboard = importlib.import_module(
        m.__name__ + ".textures.procedural").checkerboard
    return m.image(checkerboard(), repeat=repeat)


def example1(width=400, height=300, m=None):
    """Two metal spheres on a checkered floor (example1.py)."""
    m = _pkg(m)
    gold_metal = m.Glossy(diff_color=m.rgb(1.0, 0.572, 0.184),
                          n=m.vec3(0.15 + 3.58j, 0.4 + 2.37j, 1.54 + 1.91j),
                          roughness=0.0, spec_coeff=0.2, diff_coeff=0.8)
    bluish_metal = m.Glossy(diff_color=m.rgb(0.0, 0, 0.1),
                            n=m.vec3(1.3 + 1.91j, 1.3 + 1.91j, 1.4 + 2.91j),
                            roughness=0.2, spec_coeff=0.5, diff_coeff=0.3)
    floor = m.Glossy(diff_color=_floor_texture(m, 80.0),
                     n=m.vec3(1.2 + 0.3j, 1.2 + 0.3j, 1.1 + 0.3j),
                     roughness=0.2, spec_coeff=0.3, diff_coeff=0.9)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    angle = -np.pi / 2 * 0.3
    sc.add_Camera(look_from=m.vec3(2.5 * np.sin(angle), 0.25,
                                   2.5 * np.cos(angle) - 1.5),
                  look_at=m.vec3(0.0, 0.25, -3.0), screen_width=width,
                  screen_height=height)
    sc.add_DirectionalLight(Ldir=m.vec3(0.52, 0.45, -0.5),
                            color=m.rgb(0.15, 0.15, 0.15))
    sc.add(m.Sphere(material=gold_metal, center=m.vec3(-0.75, 0.1, -3.0),
                    radius=0.6, max_ray_depth=3))
    sc.add(m.Sphere(material=bluish_metal, center=m.vec3(1.25, 0.1, -3.0),
                    radius=0.6, max_ray_depth=3))
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, -3.0), width=120.0,
                   height=120.0, u_axis=m.vec3(1.0, 0, 0),
                   v_axis=m.vec3(0, 0, -1.0), max_ray_depth=3))
    sc.add_Background(m.procedural_sky())
    return sc


def example2(width=400, height=300, m=None):
    """Three coloured glass spheres (example2.py)."""
    m = _pkg(m)
    blue_glass = m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5 + 4e-8j, 1.5 + 0.0j))
    green_glass = m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5 + 0.0j, 1.5 + 4e-8j))
    red_glass = m.Refractive(n=m.vec3(1.5 + 0.0j, 1.5 + 5e-8j, 1.5 + 5e-8j))
    floor = m.Glossy(diff_color=_floor_texture(m, 80.0),
                     n=m.vec3(1.2 + 0.3j, 1.2 + 0.3j, 1.1 + 0.3j),
                     roughness=0.2, spec_coeff=0.3, diff_coeff=0.9)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    angle = np.pi / 2 * 0.3
    sc.add_Camera(look_from=m.vec3(2.5 * np.sin(angle), 0.25,
                                   2.5 * np.cos(angle) - 1.5),
                  look_at=m.vec3(0.0, 0.25, -1.5), screen_width=width,
                  screen_height=height)
    sc.add_DirectionalLight(Ldir=m.vec3(0.52, 0.45, -0.5),
                            color=m.rgb(0.15, 0.15, 0.15))
    for mat, x in ((blue_glass, -1.2), (green_glass, 0.0), (red_glass, 1.2)):
        sc.add(m.Sphere(material=mat, center=m.vec3(x, 0.0, -1.5), radius=0.5,
                        shadow=False, max_ray_depth=3))
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, -3.0), width=120.0,
                   height=120.0, u_axis=m.vec3(1.0, 0, 0),
                   v_axis=m.vec3(0, 0, -1.0), max_ray_depth=3))
    sc.add_Background(m.procedural_sky())
    return sc


def example3(width=400, height=300, m=None):
    """A rotated glass cuboid on a checkered floor (example3.py)."""
    m = _pkg(m)
    floor = m.Glossy(diff_color=_floor_texture(m, 2.0),
                     roughness=0.2, spec_coeff=0.3, diff_coeff=0.7,
                     n=m.vec3(2.2, 2.2, 2.2))
    green_glass = m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5 + 0.0j, 1.5 + 4e-8j))
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0.0, 0.25, 1.0),
                  look_at=m.vec3(0.0, 0.25, -3.0), screen_width=width,
                  screen_height=height)
    sc.add_DirectionalLight(Ldir=m.vec3(0.0, 0.5, 0.5),
                            color=m.rgb(0.5, 0.5, 0.5))
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, -3.0), width=6.0,
                   height=6.0, u_axis=m.vec3(1.0, 0, 0),
                   v_axis=m.vec3(0, 0, -1.0), max_ray_depth=5))
    cb = m.Cuboid(material=green_glass, center=m.vec3(0.00, 0.0001, -0.8),
                  width=0.9, height=1.0, length=0.4, shadow=False,
                  max_ray_depth=5)
    cb.rotate(θ=30, u=m.vec3(0, 1, 0))
    sc.add(cb)
    sc.add_Background(m.procedural_sky())
    return sc


def example4(width=400, height=300, m=None, blur=10.0):
    """A thin-film soap bubble against a blurred sky with a lightmap
    (example4.py).  blur=0 skips the Pillow blur; the lightmap is then
    the raw sky."""
    m = _pkg(m)
    sc = m.Scene(ambient_color=m.rgb(0.01, 0.01, 0.01))
    angle = -np.pi * 0.5
    sc.add_Camera(screen_height=height, screen_width=width,
                  look_from=m.vec3(4.0 * np.sin(angle), 0.00,
                                   4.0 * np.cos(angle)),
                  look_at=m.vec3(0.0, 0.05, 0.0))
    soap_bubble = m.ThinFilmInterference(thickness=330, noise=60.0)
    sc.add(m.Sphere(material=soap_bubble, center=m.vec3(1.0, 0.0, 1.5),
                    radius=1.7, shadow=False, max_ray_depth=5))
    sc.add_Background(m.procedural_sky(), light_intensity=5.0, blur=blur)
    return sc


EXAMPLES = {1: example1, 2: example2, 3: example3, 4: example4}
SPP = {1: 6, 2: 64, 3: 64, 4: 64}      # the examples' own sample counts


if __name__ == "__main__":
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    img = EXAMPLES[k]().render(samples_per_pixel=SPP[k])
    img.save(f"example{k}_torch.png")
