"""The wavefront's features through the PyTorch / CUDA port: environment
importance sampling, custom materials, normal maps, the stereo 360 (ODS)
frame and motion blur.

- `env_is(...)`: examples/example_env_is.py, a diffuse and glossy still
  life lit by a tiny 3000x sun in an equirect sky, with or without the
  environment's alias tables (`importance_sampled`);
- `custom_material(...)`: examples/example_custom_material.py, an
  Iridescent and a ToonMirror sphere (user shaders) over a glossy floor;
  the shaders are torch code for the port and the JAX example's own jnp
  classes for the JAX package;
- `normal_mapped(...)`: a bumpy normal map on a sphere, a plane, a box
  and a UV-sphere mesh with vt records, over a diffuse floor;
- `vr(...)`: examples/example_vr.py, an equirect interior for
  `render_ods`;
- `motion_blur(...)` and `fly(scene, t)`: examples/example_motion_blur.py,
  a glossy ball streaking over a checkered floor (an image texture, so
  each slice renders through the record kernel).

Each scene function takes the package to build with (`m=`, default: the
port), so the tests build the same scene with the JAX package.

    python examples/torch_features.py env_is     # env_is_torch.png, 16 spp

Pillow is needed only to write the image file.
"""
import dataclasses
import importlib
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import raytracer_tpu_torch as T  # noqa: E402
import torch_mesh  # noqa: E402


def _package(m):
    return m if m is not None else T


def sun_sky(H=256, W=512, sun_uv=(0.7, 0.72), sun_r=0.012, sun=3000.0):
    """Linear equirect sky: a soft gradient and a tiny sun disk
    (examples/example_env_is.py:27), authored with display rows (v = 0 the
    nadir) and permuted into the fetch's storage rows."""
    img = np.zeros((H, W, 3), np.float32)
    horizon = np.array([0.35, 0.38, 0.45], np.float32)
    zenith = np.array([0.05, 0.10, 0.25], np.float32)
    uu = (np.arange(W) + 0.5) / W
    vv = (np.arange(H) + 0.5) / H
    up = np.clip((vv - 0.5) * 2.0, 0.0, 1.0)
    img[:] = horizon + (zenith - horizon) * up[:, None, None]
    du = np.minimum(np.abs(uu[None, :] - sun_uv[0]),
                    1.0 - np.abs(uu[None, :] - sun_uv[0]))
    dv = np.abs(vv[:, None] - sun_uv[1])
    disk = du ** 2 + dv ** 2 <= sun_r ** 2
    img[disk] = np.array([sun, sun * 0.92, sun * 0.80], np.float32)
    store = np.empty_like(img)
    store[(-np.arange(H)) % H] = img
    return store


def env_is(width=400, height=300, importance_sampled=True, sky=None, m=None):
    """examples/example_env_is.py's still life under `sky` (default
    sun_sky())."""
    m = _package(m)
    sc = m.Scene(ambient_color=m.rgb(0.0, 0.0, 0.0))
    sc.add_Camera(look_from=m.vec3(0, 0.8, 3.2), look_at=m.vec3(0, 0.1, 0),
                  screen_width=width, screen_height=height, field_of_view=35)
    white = m.Diffuse(diff_color=m.rgb(0.75, 0.75, 0.75), diffuse_rays=1)
    red = m.Diffuse(diff_color=m.rgb(0.75, 0.25, 0.2), diffuse_rays=1)
    chrome = m.Glossy(diff_color=m.rgb(0.5, 0.5, 0.55),
                      n=m.vec3(1.5 + 2.0j, 1.5 + 2.0j, 1.4 + 2.2j),
                      roughness=0.05, spec_coeff=0.6, diff_coeff=0.4)
    sc.add(m.Plane(material=white, center=m.vec3(0, -0.5, 0), width=40,
                   height=40, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=red, center=m.vec3(-0.9, 0.05, 0.2), radius=0.55))
    sc.add(m.Sphere(material=chrome, center=m.vec3(0.7, 0.1, -0.4),
                    radius=0.6))
    sc.add_Background(sun_sky() if sky is None else sky, spherical=True,
                      linear=True, importance_sampled=importance_sampled)
    return sc


class Iridescent(T.CustomMaterial):
    """Hue cycles with the view angle |N.D|; the path ends at the hit
    (examples/example_custom_material.py:29, in torch)."""

    def __init__(self, brightness=1.0):
        super().__init__()
        self.brightness = float(brightness)

    def shade(self, ctx):
        f = torch.abs((ctx.D * ctx.N).sum(-1, keepdim=True))
        col = self.brightness * torch.cat(
            [0.5 + 0.5 * torch.cos(6.2832 * (f + 0.00)),
             0.5 + 0.5 * torch.cos(6.2832 * (f + 0.33)),
             0.5 + 0.5 * torch.cos(6.2832 * (f + 0.67))], dim=-1)
        return dataclasses.replace(T.default_shade_out(ctx), add=col)


class ToonMirror(T.CustomMaterial):
    """Banded Lambert toward a key direction plus a mirror continuation
    (examples/example_custom_material.py:44, in torch)."""

    def __init__(self, color=(0.2, 0.45, 0.8), key_dir=(0.4, 0.8, 0.45),
                 bands=3, mirror=0.35):
        super().__init__()
        self.color = tuple(color)
        s = sum(x * x for x in key_dir) ** 0.5
        self.key_dir = tuple(x / s for x in key_dir)
        self.bands = int(bands)
        self.mirror = float(mirror)

    def shade(self, ctx):
        n, dev = ctx.P.shape[0], ctx.P.device
        key = torch.tensor(self.key_dir, dtype=torch.float32, device=dev)
        lam = torch.clamp((ctx.N * key).sum(-1), 0.0, 1.0)
        toon = torch.ceil(lam * self.bands) / self.bands
        add = toon[..., None] * torch.tensor(self.color, dtype=torch.float32,
                                             device=dev)
        d = ctx.D - ctx.N * (2.0 * (ctx.D * ctx.N).sum(-1, keepdim=True))
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return dataclasses.replace(
            T.default_shade_out(ctx), add=add,
            beta_mult=torch.full((n, 3), self.mirror, dtype=ctx.P.dtype,
                                 device=dev),
            new_origin=ctx.P + ctx.N * ctx.eps[..., None], new_dir=d,
            cont=ctx.depth < ctx.obj_max_depth,
            is_reflection=torch.ones((n,), dtype=torch.bool, device=dev))


def custom_material(width=400, height=300, m=None):
    """examples/example_custom_material.py: the shaders are this file's
    torch classes for the port, the example's jnp classes for JAX."""
    m = _package(m)
    if m is T:
        irid, toon = Iridescent, ToonMirror
    else:
        ex = importlib.import_module("example_custom_material")
        irid, toon = ex.Iridescent, ex.ToonMirror
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.35, 1), look_at=m.vec3(0, 0.25, -3),
                  screen_width=width, screen_height=height)
    sc.add_DirectionalLight(Ldir=m.vec3(0.4, 0.8, 0.45),
                            color=m.rgb(0.2, 0.2, 0.2))
    sc.add(m.Sphere(material=irid(), center=m.vec3(-0.8, 0.1, -3.0),
                    radius=0.55, max_ray_depth=3))
    sc.add(m.Sphere(material=toon(), center=m.vec3(0.8, 0.1, -3.0),
                    radius=0.55, max_ray_depth=3))
    sc.add(m.Plane(material=m.Glossy(diff_color=m.rgb(0.65, 0.62, 0.6),
                                     n=m.vec3(1.5, 1.5, 1.5), roughness=0.3,
                                     spec_coeff=0.2, diff_coeff=0.8),
                   center=m.vec3(0, -0.45, -3), width=12.0, height=12.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   max_ray_depth=3))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(8.0, 8.0, 8.5)),
                    center=m.vec3(2.5, 4.0, -1.0), radius=1.2, shadow=False))
    return sc


def bump_normalmap(n=64, bumps=6, strength=0.35):
    """A tangent-space normal map of a grid of round bumps, encoded in
    [0, 1] (0.5 = flat)."""
    x = (np.arange(n) + 0.5) / n * bumps * 2 * np.pi
    gx = strength * np.cos(x)[None, :] * np.sin(x)[:, None]
    gy = strength * np.sin(x)[None, :] * np.cos(x)[:, None]
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (nrm * 0.5 + 0.5).astype(np.float32)


def normal_mapped(width=400, height=300, m=None, obj_dir=None,
                  filter="nearest", enclosed=False):
    """A normal-mapped sphere, plane (the floor), box and UV-sphere mesh,
    diffuse and glossy, under a directional light and an emissive sphere
    that the diffuse mixture importance-samples.  enclosed: inside a dim
    emissive sphere of radius 30, added first: no ray misses, and object
    0 (whose attributes a miss takes) carries no map."""
    m = _package(m)
    nm = bump_normalmap()
    sc = m.Scene(ambient_color=m.rgb(0.03, 0.03, 0.04))
    sc.add_Camera(look_from=m.vec3(0, 1.2, 4.0), look_at=m.vec3(0, 0.1, 0),
                  screen_width=width, screen_height=height, field_of_view=40)
    sc.add_DirectionalLight(Ldir=m.vec3(0.5, 0.8, 0.4),
                            color=m.rgb(0.9, 0.9, 0.85))

    if enclosed:
        sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.2, 0.22, 0.25)),
                        center=m.vec3(0, 0, 0), radius=30.0, shadow=False))

    def mat(kind, color, repeat=1.0):
        if kind == "diffuse":
            mt = m.Diffuse(diff_color=m.rgb(*color), diffuse_rays=1)
        else:
            mt = m.Glossy(diff_color=m.rgb(*color), n=m.vec3(1.5, 1.5, 1.5),
                          roughness=0.2, spec_coeff=0.3, diff_coeff=0.8)
        mt.set_normalmap(nm, repeat=repeat, filter=filter)
        return mt

    sc.add(m.Plane(material=mat("diffuse", (0.6, 0.6, 0.55), 4.0),
                   center=m.vec3(0, -0.6, 0), width=12, height=12,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=mat("glossy", (0.8, 0.3, 0.2)),
                    center=m.vec3(-1.2, 0.0, 0.0), radius=0.6))
    sc.add(m.Cuboid(material=mat("diffuse", (0.3, 0.5, 0.8), 2.0),
                    center=m.vec3(1.2, -0.2, -0.3), width=0.8, height=0.8,
                    length=0.8))
    path = str(Path(obj_dir or tempfile.mkdtemp()) / "uvsphere8x12.obj")
    torch_mesh.write_uv_sphere_obj(path, n_theta=8, n_phi=12)
    sc.add(m.TriangleMesh(path, center=m.vec3(0.1, 0.0, -1.0),
                          material=mat("glossy", (0.3, 0.7, 0.3)),
                          smooth=True))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(6, 6, 5.5)),
                    center=m.vec3(0, 3.5, 1.0), radius=0.5, shadow=False),
           importance_sampled=True)
    return sc


def lit_textures(width=32, height=32, m=None):
    """tests/test_torch_scenes.py's lit_textures at width x height: a
    diffuse image texture (nearest), a glossy one (bilinear), an emissive
    image (importance-sampled), a solid diffuse box, a point and a spot
    light with shadow rays, and the procedural sky: the textures of every
    block that reads one, for their gradients."""
    m = _package(m)
    proc = importlib.import_module(m.__name__ + ".textures.procedural")
    checker = proc.checkerboard(64, squares=4)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.04, 0.03))
    sc.add_Camera(look_from=m.vec3(0, 1.0, 3.0), look_at=m.vec3(0, 0.3, 0),
                  screen_width=width, screen_height=height, field_of_view=60)
    sc.add_PointLight(pos=m.vec3(1.5, 2.5, 1.0), color=m.rgb(3, 3, 3))
    sc.add_SpotLight(pos=m.vec3(-1.5, 2.5, 1.0), direction=m.vec3(0.5, -1, -0.3),
                     color=m.rgb(2, 2, 3), angle=35.0)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.image(checker, repeat=4.0),
                                      diffuse_rays=4),
                   center=m.vec3(0, 0, 0), width=8.0, height=8.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=m.Glossy(
                        diff_color=m.image(proc.wood(64), repeat=2.0, filter="bilinear"),
                        n=m.vec3(1.5, 1.5, 1.5), roughness=0.3, spec_coeff=0.4,
                        diff_coeff=0.6),
                    center=m.vec3(0.6, 0.5, 0.0), radius=0.5, max_ray_depth=2))
    sc.add(m.Sphere(material=m.Emissive(color=m.image(checker * 3.0)),
                    center=m.vec3(-0.8, 0.6, -0.5), radius=0.35),
           importance_sampled=True)
    box = m.Cuboid(material=m.Diffuse(diff_color=m.rgb(0.7, 0.3, 0.2)),
                   center=m.vec3(-0.2, 0.25, 0.8), width=0.4, height=0.5, length=0.3)
    box.rotate(θ=20, u=m.vec3(0, 1, 0))
    sc.add(box)
    sc.add_Background(m.procedural_sky(128, 96))
    return sc


def instanced_mapped(width=16, height=12, m=None, obj_dir=None):
    """Three instances of a normal-mapped UV sphere (vt records, its map
    bilinear) beside a normal-mapped plane (repeat 3): the tangents rotate
    into world space."""
    m = _package(m)
    path = Path(obj_dir or tempfile.mkdtemp()) / "uv8x12.obj"
    torch_mesh.write_uv_sphere_obj(path, 8, 12)
    nm = bump_normalmap(32)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.8, 4), look_at=m.vec3(0, 0, 0),
                  screen_width=width, screen_height=height)
    sc.add_DirectionalLight(Ldir=m.vec3(0.3, 1, 0.5), color=m.rgb(1, 1, 1))
    floor = m.Diffuse(diff_color=m.rgb(0.5, 0.5, 0.5), diffuse_rays=1)
    floor.set_normalmap(nm, repeat=3.0)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.8, 0), width=10,
                   height=10, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    mat = m.Glossy(diff_color=m.rgb(0.7, 0.3, 0.2), n=m.vec3(1.5, 1.5, 1.5),
                   roughness=0.2, spec_coeff=0.3, diff_coeff=0.8)
    mat.set_normalmap(nm, filter="bilinear")
    grp = m.MeshInstances(m.TriangleMesh(str(path), center=m.vec3(0, 0, 0),
                                         material=mat, smooth=True))
    for i in range(3):
        grp.add(translate=(-1.2 + 1.2 * i, 0.1 * i, -0.3 * i), theta=40.0 * i,
                axis=(0, 1, 0.2), scale=0.5 + 0.1 * i)
    sc.add(grp)
    return sc


def vr(width=512, height=256, m=None):
    """examples/example_vr.py: an equirect interior with near and far
    markers."""
    m = _package(m)
    sc = m.Scene(ambient_color=(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=m.vec3(0.0, 0.1, 0.0),
                  look_at=m.vec3(1.0, 0.1, 0.0), screen_width=width,
                  screen_height=height, projection="equirect")
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.7, 0.7, 0.7)),
                   center=m.vec3(0, -0.5, 0), width=20.0, height=20.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, 1)))
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.9, 0.25, 0.2)),
                    center=m.vec3(1.2, 0.0, 0.0), radius=0.35))
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.2, 0.4, 0.9)),
                    center=m.vec3(0.0, 0.0, 1.5), radius=0.4))
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.3, 0.8, 0.3)),
                    center=m.vec3(-6.0, 0.5, 0.0), radius=1.0))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(6, 6, 6)),
                    center=m.vec3(0, 4.0, -2.0), radius=1.0),
           importance_sampled=True)
    return sc


def checker(n=512, sq=64):
    """The checkered floor texture (examples/example_motion_blur.py:24)."""
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy // sq + xx // sq) % 2).astype(np.float32)
    img = np.stack([0.25 + 0.55 * c] * 3, -1)
    img[..., 2] *= 0.9
    return img


def motion_blur(width=400, height=300, m=None):
    """examples/example_motion_blur.py: the red ball (object 1) moves
    under `fly`; the sky is procedural_sky()."""
    m = _package(m)
    sc = m.Scene(ambient_color=m.rgb(0.12, 0.12, 0.14))
    sc.add_Camera(look_from=m.vec3(0, 0.6, 2.6), look_at=m.vec3(0, 0.0, -0.5),
                  screen_width=width, screen_height=height, field_of_view=32)
    sc.add_DirectionalLight(Ldir=m.vec3(0.4, 0.7, 0.6),
                            color=m.rgb(1.0, 0.95, 0.9))
    floor = m.Glossy(diff_color=m.image(checker(), repeat=2.0),
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


def fly(scene, t):
    """The red ball crosses about a fifth of the frame with a slight arc
    (examples/example_motion_blur.py:56)."""
    scene.scene_primitives[1].center = np.asarray(
        [-0.9 + 0.55 * t, 0.05 + 0.2 * t - 0.25 * t * t, -0.8], np.float32)


def many_lights(width=160, height=120, n_lights=1200, textured=False,
                m=None):
    """A Glossy sphere lit by `n_lights` dim point lights on a spiral
    around it: 1,200 lights take 53,220 bytes of the solid kernel's shared
    memory, past the 48 KB a block gets without opting in.  textured: the
    sphere's colour is the checker image, so the scene takes the record
    kernel."""
    m = _package(m)
    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=m.vec3(0, 0, 3), look_at=m.vec3(0, 0, 0),
                  screen_width=width, screen_height=height, field_of_view=40)
    k = np.arange(n_lights)
    phi = k * 2.399963229728653            # the golden angle
    z = 1.0 - (k + 0.5) / n_lights * 2.0
    r = np.sqrt(1.0 - z * z)
    w = 1.5 / n_lights
    for x, y, zz, i in zip(r * np.cos(phi), r * np.sin(phi), z, k):
        sc.add_PointLight(pos=m.vec3(3 * x, 3 * y, 3 * zz + 1.0),
                          color=m.rgb(w * (0.6 + 0.4 * (i % 3 == 0)),
                                      w * (0.6 + 0.4 * (i % 3 == 1)),
                                      w * (0.6 + 0.4 * (i % 3 == 2))))
    col = m.image(checker(64, 8), repeat=2.0) if textured else m.rgb(0.8, 0.7,
                                                                      0.6)
    sc.add(m.Sphere(material=m.Glossy(diff_color=col,
                                      n=m.vec3(1.5 + 0.1j, 1.5 + 0.1j,
                                               1.5 + 0.1j),
                                      roughness=0.2, spec_coeff=0.3,
                                      diff_coeff=0.8),
                    center=m.vec3(0, 0, 0), radius=1.0))
    return sc


SCENES = {"env_is": env_is, "custom_material": custom_material,
          "normal_mapped": normal_mapped, "vr": vr,
          "motion_blur": motion_blur, "many_lights": many_lights}

if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "env_is"
    if name == "vr":
        img = T.render_ods(vr(), samples_per_pixel=16, ipd=0.2)
    elif name == "motion_blur":
        img = T.render_motion_blur(motion_blur(), 16, fly, slices=8)
    else:
        img = SCENES[name]().render(samples_per_pixel=16, progress_bar=True)
    img.save(f"{name}_torch.png")
