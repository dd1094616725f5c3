"""The repo's primitive, dispersion and camera examples through the PyTorch
/ CUDA port, scene for scene:

- `primitives`: examples/example_primitives.py (Disc, Cylinder), line for
  line; the record kernel (its floor is image-textured);
- `dispersion`: examples/example_dispersion.py (a hero-wavelength glass
  sphere); the solid kernel;
- `still_life`: examples/example_motion_blur.py's scene, static (no
  `render_motion_blur`); the record kernel;
- `fisheye`, `panorama`: the still life under the fisheye camera of
  examples/example_fisheye.py and the equirect camera of
  examples/example_panorama.py; `orthographic`: under an orthographic
  camera;
- `example2_solid`: examples/torch_textured.py's example 2 with the
  floor's checkerboard replaced by its mean colour and no background, a
  Whitted-style solid scene (glossy with a directional light and shadow
  rays, three refractive spheres at split_k = 3); the solid kernel;
- `shapes`: triangles, discs and cylinders with every solid material and
  a point and a spot light, built for the port's tests; the solid kernel.

    python examples/torch_primitives.py primitives   # primitives_torch.png

Every builder takes the package to build with (`m=`, default: the port),
so the tests build the same scene with the JAX package.  Pillow is needed
only to write the image file.
"""
import importlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _pkg(m):
    return m if m is not None else importlib.import_module("raytracer_tpu_torch")


def _checker(n=256, sq=32):
    t = (np.indices((n, n)).sum(axis=0) // sq) % 2
    return (0.25 + 0.65 * t)[..., None].repeat(3, -1).astype(np.float32)


def primitives(width=400, height=300, m=None):
    """A brushed-metal ring, a glass cylinder and a matte open tube on a
    checkered floor (example_primitives.py)."""
    m = _pkg(m)
    sc = m.Scene(ambient_color=m.rgb(0.03, 0.03, 0.035))
    sc.add_Camera(look_from=m.vec3(0, 0.9, 2.6), look_at=m.vec3(0, 0.15, -2.2),
                  screen_width=width, screen_height=height, field_of_view=55)
    sc.add_DirectionalLight(Ldir=m.vec3(0.45, 0.6, 0.4),
                            color=m.rgb(0.25, 0.25, 0.24))
    sc.add_SpotLight(pos=m.vec3(-1.8, 2.6, -0.6),
                     direction=m.vec3(0.55, -1.0, -0.55),
                     color=m.rgb(0.05, 0.05, 0.05), angle=26, inner_angle=16)

    floor = m.Glossy(diff_color=m.image(_checker(), repeat=4),
                     n=m.vec3(1.4, 1.4, 1.4), roughness=0.25,
                     diff_coeff=0.9, spec_coeff=0.1)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, -2.2), width=14,
                   height=14, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))

    gold = m.Glossy(diff_color=m.rgb(1.0, 0.572, 0.184),
                    n=m.vec3(0.15 + 3.58j, 0.4 + 2.37j, 1.54 + 1.91j),
                    roughness=0.0, diff_coeff=0.35, spec_coeff=0.65)
    ring = m.Disc(material=gold, center=m.vec3(-0.05, 0.35, -3.1), radius=0.8,
                  inner_radius=0.5, normal=m.vec3(0.1, 0.15, 1.0))
    sc.add(ring)

    glass = m.Refractive(n=m.vec3(1.5 + 0j, 1.52 + 0j, 1.54 + 0j))
    sc.add(m.Cylinder(material=glass, center=m.vec3(0.75, 0.05, -2.2),
                      radius=0.35, height=1.1, max_ray_depth=5))

    matte = m.Diffuse(diff_color=m.rgb(0.85, 0.3, 0.25), diffuse_rays=8)
    tube = m.Cylinder(material=matte, center=m.vec3(-1.1, -0.1, -1.9),
                      radius=0.28, height=0.8, capped=False)
    tube.rotate(25, m.vec3(0, 0, 1))
    sc.add(tube)
    return sc


def dispersion(width=400, height=300, exaggerate=3.0, m=None):
    """A BK7-ish glass sphere splitting white light in front of bright bars
    (example_dispersion.py); exaggerate scales the channel spread."""
    m = _pkg(m)
    n0 = 1.5168
    dr, dg, db = -0.0062, -0.0013, 0.0067     # BK7 spread about n_d
    k = exaggerate
    n = m.vec3(n0 + k * dr + 1e-8j, n0 + k * dg + 1e-8j, n0 + k * db + 1e-8j)

    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=m.vec3(0.0, 0.1, 1.8), look_at=m.vec3(0, 0, -1),
                  screen_width=width, screen_height=height, field_of_view=40)
    sc.add(m.Sphere(material=m.Refractive(n=n, dispersion=True),
                    center=m.vec3(0, 0, -0.2), radius=0.55, shadow=False,
                    max_ray_depth=4))
    bars = m.Plane(material=m.Emissive(color=m.rgb(4.0, 4.0, 4.0)),
                   center=m.vec3(0, 0, -4.0), width=0.12, height=6.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0))
    sc.add(bars)
    for dx in (-1.0, -0.5, 0.5, 1.0):
        sc.add(m.Plane(material=m.Emissive(color=m.rgb(4.0, 4.0, 4.0)),
                       center=m.vec3(dx, 0, -4.0), width=0.12, height=6.0,
                       u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.05, 0.05, 0.06)),
                   center=m.vec3(0, 0, -4.01), width=40.0, height=40.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.35, 0.35, 0.4)),
                    center=m.vec3(0, 0, 0), radius=30.0, shadow=False))
    return sc


def _still_checker(n=512, sq=64):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy // sq + xx // sq) % 2).astype(np.float32)
    img = np.stack([0.25 + 0.55 * c] * 3, -1)
    img[..., 2] *= 0.9
    return img


def still_life(width=400, height=300, m=None):
    """Two glossy balls on a checkered floor under the procedural sky
    (example_motion_blur.py's scene at the shutter's opening)."""
    m = _pkg(m)
    sc = m.Scene(ambient_color=m.rgb(0.12, 0.12, 0.14))
    sc.add_Camera(look_from=m.vec3(0, 0.6, 2.6), look_at=m.vec3(0, 0.0, -0.5),
                  screen_width=width, screen_height=height, field_of_view=32)
    sc.add_DirectionalLight(Ldir=m.vec3(0.4, 0.7, 0.6),
                            color=m.rgb(1.0, 0.95, 0.9))
    floor = m.Glossy(diff_color=m.image(_still_checker(), repeat=2.0),
                     n=m.vec3(1.2 + 0.1j, 1.2 + 0.1j, 1.2 + 0.1j),
                     roughness=0.4, spec_coeff=0.2, diff_coeff=0.9)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.4, -1), width=12,
                   height=12, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    ball = m.Glossy(diff_color=m.rgb(0.85, 0.25, 0.2),
                    n=m.vec3(1.4 + 0.3j, 1.4 + 0.3j, 1.3 + 0.3j),
                    roughness=0.15, spec_coeff=0.5, diff_coeff=0.7)
    sc.add(m.Sphere(material=ball, center=m.vec3(-0.9, 0.05, -0.8),
                    radius=0.45))
    still = m.Glossy(diff_color=m.rgb(0.25, 0.45, 0.8),
                     n=m.vec3(1.3 + 0.2j, 1.3 + 0.2j, 1.3 + 0.2j),
                     roughness=0.2, spec_coeff=0.4, diff_coeff=0.8)
    sc.add(m.Sphere(material=still, center=m.vec3(0.9, -0.05, -1.4),
                    radius=0.35))
    sc.add_Background(m.procedural_sky())
    return sc


def fisheye(width=400, height=400, m=None):
    """The still life through a circular 180-degree equidistant fisheye
    (example_fisheye.py)."""
    m = _pkg(m)
    sc = still_life(m=m)
    sc.camera = m.Camera(look_from=m.vec3(0, 0.45, 0.9),
                         look_at=m.vec3(0, 0.2, -1), screen_width=width,
                         screen_height=height, field_of_view=180.0,
                         projection="fisheye")
    return sc


def panorama(width=512, height=256, m=None):
    """The still life as a 360x180 equirect panorama (example_panorama.py)."""
    m = _pkg(m)
    sc = still_life(m=m)
    sc.camera = m.Camera(look_from=m.vec3(0, 0.35, 0.6),
                         look_at=m.vec3(0, 0.3, -1), screen_width=width,
                         screen_height=height, projection="equirect")
    return sc


def orthographic(width=400, height=300, m=None):
    """The still life through an orthographic camera: parallel rays over
    the pinhole's footprint at the balls' distance."""
    m = _pkg(m)
    sc = still_life(m=m)
    sc.camera = m.Camera(look_from=m.vec3(0, 0.6, 2.6),
                         look_at=m.vec3(0, 0.0, -0.5), screen_width=width,
                         screen_height=height, focal_distance=3.2,
                         field_of_view=40, projection="orthographic")
    return sc


def example2_solid(width=400, height=300, m=None):
    """Example 2 as a solid scene: the floor's checkerboard becomes its
    mean colour and the sky goes, so the solid kernel takes it (glossy,
    a directional light with shadow rays, three refractive spheres under
    the deterministic Fresnel split)."""
    m = _pkg(m)
    checker = importlib.import_module(
        m.__name__ + ".textures.procedural").checkerboard()
    mean = np.asarray(checker, np.float64).reshape(-1, 3).mean(axis=0)
    blue_glass = m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5 + 4e-8j, 1.5 + 0.0j))
    green_glass = m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5 + 0.0j, 1.5 + 4e-8j))
    red_glass = m.Refractive(n=m.vec3(1.5 + 0.0j, 1.5 + 5e-8j, 1.5 + 5e-8j))
    floor = m.Glossy(diff_color=m.rgb(*mean),
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
    return sc


def shapes(width=400, height=400, m=None):
    """Triangles (one rotated), an importance-sampled emissive disc, an
    annulus, a capped glass cylinder and a rotated open tube; diffuse,
    glossy, refractive and emissive materials; a point and a spot light
    whose shadow rays cross every kind; the solid kernel.

    The camera stands close to the cylinders: the reference's cylinder
    solves its quadratic in the object's frame, and from a few units away
    the cancellation in |o|^2 - r^2 places hits up to ~3e-6 inside the
    surface, past the 1e-6 offset of the next ray, so rounding decides
    whether that ray re-hits the cylinder."""
    m = _pkg(m)
    sc = m.Scene(ambient_color=m.rgb(0.04, 0.04, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.5, 1.3), look_at=m.vec3(0, 0.0, -0.6),
                  screen_width=width, screen_height=height, field_of_view=70)
    sc.add_PointLight(pos=m.vec3(1.2, 2.0, 0.5), color=m.rgb(2.0, 2.0, 1.8))
    sc.add_SpotLight(pos=m.vec3(-1.5, 2.2, 0.0), direction=m.vec3(0.5, -1, -0.4),
                     color=m.rgb(1.0, 1.2, 1.5), angle=35.0, inner_angle=20.0)
    grey = m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.55))
    sc.add(m.Triangle(material=grey, center=m.vec3(0, -0.5, -1),
                      p1=m.vec3(-3, -0.5, 2), p2=m.vec3(3, -0.5, 2),
                      p3=m.vec3(0, -0.5, -5)))
    wall = m.Triangle(material=m.Glossy(diff_color=m.rgb(0.7, 0.3, 0.25),
                                        n=m.vec3(1.5, 1.5, 1.5),
                                        roughness=0.3, spec_coeff=0.4,
                                        diff_coeff=0.6),
                      center=m.vec3(0, 0.5, -2.2), p1=m.vec3(-2, -0.5, -2.2),
                      p2=m.vec3(2, -0.5, -2.2), p3=m.vec3(0, 1.8, -2.2))
    wall.rotate(theta=20, u=m.vec3(0, 1, 0))
    sc.add(wall)
    sc.add(m.Disc(material=m.Emissive(color=m.rgb(4.0, 4.0, 3.5)),
                  center=m.vec3(0, 1.7, -1), radius=0.5,
                  normal=m.vec3(0, -1, 0)), importance_sampled=True)
    sc.add(m.Disc(material=m.Glossy(diff_color=m.rgb(0.9, 0.7, 0.3),
                                    n=m.vec3(0.2 + 3.0j, 0.4 + 2.4j, 1.4 + 1.9j),
                                    roughness=0.0, spec_coeff=0.6,
                                    diff_coeff=0.4),
                  center=m.vec3(0.0, 0.3, -1.4), radius=0.5, inner_radius=0.25,
                  normal=m.vec3(0.3, 0.2, 1.0), u_axis=m.vec3(1, 0, 0)))
    sc.add(m.Cylinder(material=m.Refractive(n=m.vec3(1.5, 1.5, 1.5)),
                      center=m.vec3(0.45, -0.1, -0.6), radius=0.3, height=0.8,
                      max_ray_depth=4))
    tube = m.Cylinder(material=m.Diffuse(diff_color=m.rgb(0.3, 0.5, 0.8)),
                      center=m.vec3(-0.45, -0.2, -0.5), radius=0.3,
                      height=0.6, capped=False)
    tube.rotate(theta=35, u=m.vec3(1, 0, 1))
    sc.add(tube)
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.3, 0.35, 0.4)),
                    center=m.vec3(0, 0, 0), radius=30.0, shadow=False))
    return sc


BUILDERS = {"primitives": primitives, "dispersion": dispersion,
            "still_life": still_life, "fisheye": fisheye,
            "panorama": panorama, "orthographic": orthographic,
            "example2_solid": example2_solid, "shapes": shapes}
SPP = {"primitives": 64, "dispersion": 256, "still_life": 64, "fisheye": 64,
       "panorama": 64, "orthographic": 64, "example2_solid": 64, "shapes": 64}


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "primitives"
    img = BUILDERS[name]().render(samples_per_pixel=SPP[name])
    img.save(f"{name}_torch.png")
