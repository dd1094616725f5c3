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
".draws", ".shade.<type>" and ".update", which a profiled render reports
per stage (scripts/torch_render_profile.py).  The attributes (the hit
point, the shading normal, uv, the material word and the nudge) come from
ops/hit_attrs.py `attributes` (W5 on the card); normal maps perturb the
shading normal before the blocks (ops/hit_attrs.py
`_apply_normal_maps`, :120); a
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
from ..ops import hit_attrs, wavefront_shade
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


_NAMES = {MAT_EMISSIVE: "emissive", MAT_GLOSSY: "glossy",
          MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
          MAT_THINFILM: "thinfilm", MAT_ENV: "env", MAT_CUSTOM: "custom"}


def _dispatch(static, mat_type, mat_slot):
    """(name, shader) per block, in the JAX package's order
    (integrator.py:247-260): the present types, a CustomMaterial type
    unrolled into one block per slot.  A shader takes (ctx, draws, packed
    words, the merged output so far) and returns the merged output with
    its block's rays (its per-ray mask) shaded: the diffuse, refractive
    and glossy blocks through their W4 wrappers (ops/wavefront_shade.py),
    the others as their plain block merged with torch.where."""
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
        else:
            m = mat_type == mt
            out.append((_NAMES.get(mt, mt), lambda ctx, d, p, acc, mt=mt, m=m:
                        acc.merge(_shade(mt, ctx, d), m)))
    return out


def _shade(mt, ctx, draws):
    if mt == MAT_EMISSIVE:
        return shade.shade_emissive(ctx)
    if mt == MAT_GLOSSY:
        return shade.shade_glossy(ctx)
    if mt == MAT_DIFFUSE:
        return shade.shade_diffuse(ctx, *draws[mt])
    if mt == MAT_REFRACTIVE:
        return shade.shade_refractive(ctx, *draws[mt])
    if mt == MAT_THINFILM:
        return shade.shade_thinfilm(ctx, *draws[mt])
    if mt == MAT_ENV:
        return shade.shade_env(ctx)
    raise ValueError(f"unknown material type {mt}")


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
    L, beta = f3(0.0), f3(1.0)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    depth = diffuse_refl = split_cnt = zi
    O, D = origin, direction
    n_re, n_im = n_re.expand(n, 3), n_im.expand(n, 3)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)

    for bounce in range(settings.max_bounces):
        with record_function("wavefront.nearest_hit"):
            t, orient, obj = nearest_hit(O, D, data.geom)
        with record_function("wavefront.attributes"):
            # W5 on the card: one launch (ops/hit_attrs.py)
            a = hit_attrs.attributes(O, D, t, orient, obj, data, static, settings)
            P, N_shad, uv, miss, eps, packed = a.P, a.N, a.uv, a.miss, a.eps, a.packed
            mat_type, mat_slot = a.mat_type, a.mat_slot
            obj_max_depth, obj_mc = a.obj_max_depth, a.obj_mc
        with record_function("wavefront.draws"):
            draws = _draw(generator, static, n)
        # W4 writes its blocks' rays into the merged output in place
        acc = wavefront_shade.Merged.start(P, D, n_re, n_im)
        ctx = ShadeCtx(data=data, static=static, bounce=bounce, D=D,
                       n_re=n_re, n_im=n_im, depth=depth,
                       diffuse_reflections=diffuse_refl, t=t, P=P, N=N_shad,
                       uv=uv, orient=orient, mat_slot=mat_slot,
                       obj_max_depth=obj_max_depth, obj_mc=obj_mc, eps=eps,
                       pattern=pattern, split_cnt=split_cnt,
                       split_k=settings.split_k, strat_u=strat_u,
                       generator=generator)
        for name, shader in _dispatch(static, mat_type, mat_slot):
            with record_function(f"wavefront.shade.{name}"):
                acc = shader(ctx, draws, packed, acc)
        add, beta_mult, cont = acc.add, acc.beta_mult, acc.cont
        new_O, new_D, new_n_re, new_n_im = (acc.new_origin, acc.new_dir,
                                            acc.new_n_re, acc.new_n_im)
        inc_diff, inc_split = acc.is_diffuse, acc.did_split

        with record_function("wavefront.update"):
            shaded = alive & ~miss
            L = L + torch.where(shaded[..., None], beta * add, 0.0)
            if settings.collect_stats:
                rays_traced = rays_traced + alive.sum()
            alive = shaded & cont
            a3 = alive[..., None]
            beta = torch.where(a3, beta * beta_mult, beta)
            # dead rays keep their last O / D and are swept again each bounce
            O = torch.where(a3, new_O, O)
            D = torch.where(a3, new_D, D)
            n_re = torch.where(a3, new_n_re, n_re)
            n_im = torch.where(a3, new_n_im, n_im)
            depth = depth + alive.to(torch.int32)
            diffuse_refl = diffuse_refl + (alive & inc_diff).to(torch.int32)
            split_cnt = split_cnt + (shaded & inc_split).to(torch.int32)

    if settings.collect_stats:
        stats["rays_traced"] = rays_traced
    return L, stats


def trace_distances(origin, direction, data, max_r_distance=10.0):
    """Depth AOV (integrator.py:347): min(t, max_r_distance) /
    max_r_distance in all three channels, (N, 3)."""
    t, _, _ = nearest_hit(origin, direction, data.geom)
    r = div(torch.clamp_max(t, max_r_distance), max_r_distance)
    return torch.stack([r, r, r], dim=-1)
