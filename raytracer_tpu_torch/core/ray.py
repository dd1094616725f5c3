"""Ray bundles and the functional entry points of the wavefront.

Counterpart of raytracer_tpu/core/ray.py (which mirrors sightpy's `Ray` /
`get_raycolor`, sightpy/ray.py:7-163).  A `Ray` holds (N, 3) origins and
directions; `get_raycolor` traces it through a scene with the wavefront
integrator, `get_distances` gives its depth AOV, and `first_hit` its
nearest hits as a `Hit`.  Each compiles the scene and runs on the card
unless the caller passes device="cpu"; without a card the default
raises.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device, what="this call"):
    """torch.device of `device`; None means the CUDA device.  A CUDA
    device raises when there is none: the CPU is used only when asked
    for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the CUDA device by default and found none; "
            "pass device='cpu' to run on the CPU")
    return device


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class Ray:
    """A bundle of rays (raytracer_tpu/core/ray.py:26).  origin, dir: (N, 3)
    tensors or arrays; n: an optional (N, 3) or (3,) complex medium IoR
    (default: the scene's).  The counters exist for sightpy's API; the
    integrator starts every path at depth 0."""

    def __init__(self, origin, dir, n=None, depth=0, reflections=0,
                 transmissions=0, diffuse_reflections=0):
        self.origin = origin
        self.dir = dir
        self.n = n
        self.depth = depth
        self.reflections = reflections
        self.transmissions = transmissions
        self.diffuse_reflections = diffuse_reflections

    @staticmethod
    def where(cond, x, y):
        c = torch.as_tensor(cond)[..., None]
        pick = lambda a, b: torch.where(c, torch.as_tensor(a), torch.as_tensor(b))
        n = (pick(x.n, y.n) if x.n is not None and y.n is not None else x.n)
        return Ray(pick(x.origin, y.origin), pick(x.dir, y.dir), n,
                   max(x.depth, y.depth), max(x.reflections, y.reflections),
                   max(x.transmissions, y.transmissions),
                   max(x.diffuse_reflections, y.diffuse_reflections))

    @staticmethod
    def concatenate(rays):
        cat = lambda xs: torch.cat([torch.as_tensor(x) for x in xs])
        n = (cat([r.n for r in rays]) if all(r.n is not None for r in rays)
             else None)
        return Ray(cat([r.origin for r in rays]), cat([r.dir for r in rays]),
                   n, rays[0].depth, max(r.reflections for r in rays),
                   max(r.transmissions for r in rays),
                   max(r.diffuse_reflections for r in rays))

    def __len__(self):
        return self.origin.shape[0]


class Hit:
    """Nearest hits of a bundle (raytracer_tpu/core/ray.py:105): distance
    (N,) (FARAWAY on a miss), orientation (N,), and point, normal, uv and
    the compiled object id, zero on a miss.  Object ids run spheres,
    planes, boxes, discs, cylinders, triangles, each in the scene's order,
    not the position in Scene.scene_primitives; every face of a
    TriangleMesh has its own id (in leaf order when the mesh is
    clustered), and a MeshInstances group one per instance and face."""

    def __init__(self, distance, orientation, point=None, normal=None,
                 uv=None, obj_id=None):
        self.distance = distance
        self.orientation = orientation
        self.point = point
        self.normal = normal
        self.uv = uv
        self.obj_id = obj_id

    def get_uv(self):
        return self.uv

    def get_normal(self):
        return self.normal


def _compile(scene, device):
    from .compile import compile_wavefront

    static, data = compile_wavefront(scene)
    return static, data.to(device)


def get_raycolor(ray: Ray, scene, seed=0, max_bounces=None, device=None):
    """Trace a ray bundle through `scene`; (N, 3) float32 linear radiance
    on the device (raytracer_tpu/core/ray.py:63).  seed seeds the
    generator of the paths' draws."""
    from .compile import derive_max_bounces
    from .integrator import RenderSettings, trace

    device = resolve_device(device, "get_raycolor")
    static, data = _compile(scene, device)
    if max_bounces is None:
        max_bounces = derive_max_bounces(static)
    O, D = _f32(ray.origin, device), _f32(ray.dir, device)
    if ray.n is not None:
        n = np.asarray(ray.n)
        n_re = _f32(np.real(n), device).expand(O.shape)
        n_im = _f32(np.imag(n), device).expand(O.shape)
    else:
        n_re, n_im = data.scene_n_re, data.scene_n_im
    g = torch.Generator(device=device).manual_seed(int(seed))
    L, _ = trace(g, O, D, n_re, n_im, data, static,
                 RenderSettings(max_bounces=max_bounces))
    return L


def get_distances(ray: Ray, scene, device=None):
    """Depth AOV of a ray bundle, (N, 3) (raytracer_tpu/core/ray.py:92)."""
    from .integrator import trace_distances

    device = resolve_device(device, "get_distances")
    _, data = _compile(scene, device)
    return trace_distances(_f32(ray.origin, device), _f32(ray.dir, device),
                           data)


def first_hit(ray: Ray, scene, device=None) -> Hit:
    """The nearest hit of every ray of the bundle against `scene`
    (raytracer_tpu/core/ray.py:149), with uv always computed."""
    device = resolve_device(device, "first_hit")
    static, data = _compile(scene, device)
    O, D = _f32(ray.origin, device), _f32(ray.dir, device)
    t, orient, obj, a = _first_hit_impl(O, D, data, static)
    return Hit(distance=t, orientation=orient, point=a.P, normal=a.N, uv=a.uv,
               obj_id=obj.to(torch.int32))


def _first_hit_impl(O, D, data, static):
    """(t, orient, obj, attrs) of the nearest hits, attrs the first-hit
    pass's ops/hit_attrs.py Attrs (W5 on the card): the point, the
    geometric normal and uv, zero on a miss (raytracer_tpu/core/ray.py:136),
    with the material word's fields and the nudge, which the AOV pass
    reads."""
    from ..geometry.intersect import nearest_hit
    from ..ops import hit_attrs

    t, orient, obj = nearest_hit(O, D, data.geom)
    return t, orient, obj, hit_attrs.attributes(O, D, t, orient, obj, data, static,
                                                force_uv=True, first_hit=True)
