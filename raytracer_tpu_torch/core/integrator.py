"""Render settings and the wavefront path integrator on torch tensors.

Counterpart of raytracer_tpu/core/integrator.py.  One fixed-size
wavefront of rays iterates over bounces:

  bounce k:  nearest hit over every primitive table  ->  hit attributes
             -> every present material type shades every ray (masked)
             -> radiance / throughput update  ->  continuation rays

as the JAX package's `trace` does (:192), with the same carry, the same
update order and the same scale-aware nudge.  The loop runs all
`max_bounces` (the JAX package's lax.scan), out of place (torch.where;
no tensor is written after a later op read it), with no host sync.
Its random draws come from one torch.Generator, the same number of
full-width draws in the same order every bounce whatever the rays hit
(`_draw`), so one seed gives one image.  Each stage of a bounce runs
under a torch.profiler range, "wavefront.nearest_hit", ".attributes",
".draws", ".start", ".shade.<type>" and ".update", which a profiled
render reports per stage (scripts/torch_render_profile.py).  The
attributes (the hit point, the shading normal, uv, the material word and
the nudge) come from ops/hit_attrs.py `attributes` (W5 on the card);
normal maps perturb the shading normal there, before the blocks (inside
W5 on the card; the plain stage's `_apply_normal_maps`, :120).  The start of each
bounce's merged shading output, with the emissive and environment
blocks, and the update come from ops/bounce_tail.py (W6 on the card); a
CustomMaterial's `shade` runs as one more block per slot, drawing from
the chunk's generator (ShadeCtx.generator) after the built-in draws.
`trace_distances` is the depth AOV (:347).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from ..geometry.intersect import nearest_hit
from ..materials import shade
from ..materials.base import (MAT_CUSTOM, MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV,
                              MAT_GLOSSY, MAT_REFRACTIVE, MAT_THINFILM)
from ..ops import bounce_tail, hit_attrs, wavefront_shade
from ..utils.constants import NUDGE_EPS, WAVELENGTHS_NM
from .safemath import div

USE_PALLAS = ("auto", "always", "never")


@dataclass(frozen=True)
class RenderSettings:
    """Knobs of one render.

    max_bounces: path length budget; at the default, Scene.render derives
    it from the scene (compile.derive_max_bounces).
    nudge_eps: the surface offset of continuation rays, scaled by the hit
    point's largest coordinate where that is above 1.
    split_k: deterministic Fresnel-split levels (0 = stochastic); at 0,
    Scene.render derives it from the scene (compile.derive_split_k).
    sampler: "r2" (per-pixel rotated R2 lattice, core/lds.py) or "iid".
    projection: the camera projection, set from Camera.projection.
    collect_stats: count the rays traced (a device tensor).
    use_pallas: "auto" renders a scene inside a kernel's gate through that
    kernel (on the CPU its plain version) and any other scene on the
    wavefront; "always" raises where the gate fails; "never" takes the
    wavefront.
    unroll: accepted for parity with the JAX package, where it is the
    bounce scan's unroll factor (lax.scan); unused here, where the bounce
    loop is a Python loop.
    """

    max_bounces: int = 8
    nudge_eps: float = NUDGE_EPS
    split_k: int = 0
    sampler: str = "r2"
    projection: str = "pinhole"
    collect_stats: bool = False
    unroll: int = 1
    use_pallas: str = "auto"

    def __post_init__(self):
        if self.use_pallas not in USE_PALLAS:
            raise ValueError(f"use_pallas must be one of {USE_PALLAS}, got "
                             f"{self.use_pallas!r}")


@dataclass
class ShadeCtx:
    """What a shading block reads about the wavefront (integrator.py:86).

    generator: the chunk's torch.Generator, on the rays' device, where
    the JAX context has a PRNG key: a CustomMaterial's shader draws from
    it (the built-in blocks take their draws as arguments)."""

    data: Any            # SceneData
    static: Any          # SceneStatic
    bounce: int
    D: Any               # (N, 3) incoming directions
    n_re: Any            # (N, 3) current medium IoR
    n_im: Any
    depth: Any           # (N,) int32
    diffuse_reflections: Any
    t: Any               # (N,) hit distance
    P: Any               # (N, 3) hit points
    N: Any               # (N, 3) shading normal, facing the ray
    uv: Any              # (N, 2)
    orient: Any          # (N,) +1 entering, -1 leaving
    mat_slot: Any        # (N,) int32
    obj_max_depth: Any   # (N,) int32
    obj_mc: Any          # (N,) bool
    eps: Any             # (N,) nudge offsets
    pattern: Any = None      # (N,) int32 split pattern, bit j the j-th split
    split_cnt: Any = None    # (N,) int32 splits taken so far
    split_k: int = 0
    # (u_mix, u_phi, u_r2) of the first diffuse bounce (core/lds.py dims
    # 6, 4, 5), or None
    strat_u: Any = None
    wavelengths: Any = WAVELENGTHS_NM
    generator: Any = None


def _draw(generator, static, n):
    """The bounce's draws, in a fixed order over the present material
    types: diffuse (u_mix, u_phi, u_r2) and with targets a target pick;
    refractive u and with dispersion a hero channel; thin film u.  Each is
    a full (n,) tensor, drawn whatever the rays hit."""
    dev = generator.device
    u = lambda: torch.rand(n, generator=generator, dtype=torch.float32,
                           device=dev)
    ri = lambda hi: torch.randint(0, hi, (n,), generator=generator, device=dev)
    draws = {}
    for mt in static.mat_types_present:
        if mt == MAT_DIFFUSE:
            uu = (u(), u(), u())
            draws[mt] = (uu, ri(static.n_is_targets) if static.n_is_targets
                         else None)
        elif mt == MAT_REFRACTIVE:
            draws[mt] = (u(), ri(3) if static.has_dispersion else None)
        elif mt == MAT_THINFILM:
            draws[mt] = (u(),)
    return draws


def _dispatch(static, mat_type, mat_slot):
    """(name, shader) per block after the bounce's start, in the JAX
    package's order (integrator.py:247-260): the present types but the
    emissive and environment ones, which the start merges
    (ops/bounce_tail.py), a CustomMaterial type unrolled into one block per
    slot.  A shader takes (ctx, draws, packed words, the merged output so
    far) and returns the merged output with its block's rays (its per-ray
    mask) shaded: the diffuse, refractive and glossy blocks through their
    W4 wrappers (ops/wavefront_shade.py), thin film and the custom blocks
    as their plain block merged with torch.where."""
    out = []
    for mt in static.mat_types_present:
        if mt == MAT_CUSTOM:
            for slot, cm in enumerate(static.custom_mats):
                m = (mat_type == mt) & (mat_slot == slot)
                out.append(("custom", lambda ctx, d, p, acc, cm=cm, m=m:
                            acc.merge(cm.shade(ctx), m)))
        elif mt == MAT_DIFFUSE:
            out.append(("diffuse", lambda ctx, d, p, acc, m=mat_type == mt:
                        wavefront_shade.shade_diffuse(ctx, d, p, m, acc)))
        elif mt == MAT_REFRACTIVE:
            out.append(("refractive", lambda ctx, d, p, acc, m=mat_type == mt:
                        wavefront_shade.shade_refractive(ctx, d, p, m, acc)))
        elif mt == MAT_GLOSSY:
            out.append(("glossy", lambda ctx, d, p, acc, m=mat_type == mt:
                        wavefront_shade.shade_glossy(ctx, d, p, m, acc)))
        elif mt == MAT_THINFILM:
            out.append(("thinfilm", lambda ctx, d, p, acc, m=mat_type == mt:
                        acc.merge(shade.shade_thinfilm(ctx, *d[MAT_THINFILM]), m)))
        elif mt not in (MAT_EMISSIVE, MAT_ENV):
            raise ValueError(f"unknown material type {mt}")
    return out


def trace(generator, origin, direction, n_re, n_im, data, static, settings,
          pattern=None, strat_u=None):
    """Trace a wavefront of rays to the end (integrator.py:192).

    origin, direction (N, 3); n_re, n_im (N, 3) or (3,): the starting
    medium.  pattern: (N,) int32 split patterns (when settings.split_k >
    0); strat_u: optional (u_mix, u_phi, u_r2) of the first diffuse
    bounce.  The generator lives on the rays' device.  Returns (radiance
    (N, 3), stats): stats["rays_traced"], a 0-dim int64 device tensor,
    when settings.collect_stats.
    """
    n = origin.shape[0]
    dev = origin.device
    stats = {}
    if static.n_objects == 0:
        if settings.collect_stats:
            stats["rays_traced"] = torch.tensor(n, dtype=torch.int64, device=dev)
        return torch.zeros((n, 3), dtype=origin.dtype, device=dev), stats
    if pattern is None:
        pattern = torch.zeros((n,), dtype=torch.int32, device=dev)
    f3 = lambda v: torch.full((n, 3), v, dtype=origin.dtype, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    c = bounce_tail.Carry(
        L=f3(0.0), beta=f3(1.0), alive=torch.ones((n,), dtype=torch.bool, device=dev),
        depth=zi, diffuse_refl=zi, split_cnt=zi, O=origin, D=direction,
        n_re=n_re.expand(n, 3), n_im=n_im.expand(n, 3),
        rays_traced=(torch.zeros((), dtype=torch.int64, device=dev)
                     if settings.collect_stats else None))

    for bounce in range(settings.max_bounces):
        with record_function("wavefront.nearest_hit"):
            t, orient, obj = nearest_hit(c.O, c.D, data.geom)
        with record_function("wavefront.attributes"):
            # W5 on the card: one launch (ops/hit_attrs.py)
            a = hit_attrs.attributes(c.O, c.D, t, orient, obj, data, static, settings)
        with record_function("wavefront.draws"):
            draws = _draw(generator, static, n)
        ctx = ShadeCtx(data=data, static=static, bounce=bounce, D=c.D,
                       n_re=c.n_re, n_im=c.n_im, depth=c.depth,
                       diffuse_reflections=c.diffuse_refl, t=t, P=a.P, N=a.N,
                       uv=a.uv, orient=orient, mat_slot=a.mat_slot,
                       obj_max_depth=a.obj_max_depth, obj_mc=a.obj_mc, eps=a.eps,
                       pattern=pattern, split_cnt=c.split_cnt,
                       split_k=settings.split_k, strat_u=strat_u,
                       generator=generator)
        with record_function("wavefront.start"):
            # W6 on the card: the merged output with the emissive and
            # environment rays shaded, one launch; W4 writes its blocks'
            # rays into it in place
            acc = bounce_tail.bounce_start(ctx, a.packed, a.mat_type)
        for name, shader in _dispatch(static, a.mat_type, a.mat_slot):
            with record_function(f"wavefront.shade.{name}"):
                acc = shader(ctx, draws, a.packed, acc)
        with record_function("wavefront.update"):
            # W6 on the card: one launch
            c = bounce_tail.bounce_update(c, a.miss, acc)

    if settings.collect_stats:
        stats["rays_traced"] = c.rays_traced
    return c.L, stats


def trace_distances(origin, direction, data, max_r_distance=10.0):
    """Depth AOV (integrator.py:347): min(t, max_r_distance) /
    max_r_distance in all three channels, (N, 3)."""
    t, _, _ = nearest_hit(origin, direction, data.geom)
    r = div(torch.clamp_max(t, max_r_distance), max_r_distance)
    return torch.stack([r, r, r], dim=-1)
