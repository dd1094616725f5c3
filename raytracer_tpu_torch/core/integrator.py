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
per stage (scripts/torch_render_profile.py).  Normal maps perturb the
shading normal before the blocks (`_apply_normal_maps`, :120); a
CustomMaterial's `shade` runs as one more block per slot, drawing from
the chunk's generator (ShadeCtx.generator) after the built-in draws.
`trace_distances` is the depth AOV (:347).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function

from ..geometry.attrs import hit_attributes
from ..geometry.intersect import nearest_hit
from ..materials import shade
from ..materials.base import (MAT_CUSTOM, MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV,
                              MAT_GLOSSY, MAT_REFRACTIVE, MAT_THINFILM)
from ..utils.constants import MISS_THRESHOLD, NUDGE_EPS, WAVELENGTHS_NM
from .compile import (KINDS, PACKED_DEPTH_SHIFT, PACKED_MC_SHIFT,
                      PACKED_SLOT_SHIFT)
from .safemath import div, safe_norm, take

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


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _take(table, idx):
    """table[idx] with idx clamped into the table (jnp.take mode=clip),
    with a reproducible gradient (safemath.take)."""
    return take(
        table, torch.clamp(idx, 0, max(table.shape[0] - 1, 0)).reshape(-1).long()
    ).reshape(idx.shape + table.shape[1:])


def _unit(v):
    return v / torch.clamp_min(safe_norm(v, keepdim=True), 1e-20)


def _apply_normal_maps(N_geo, P, uv, obj_id, data, static):
    """Tangent-space normal mapping (integrator.py:120, sightpy
    material.py:18-36): per normal-mapped object, fetch the map at uv,
    decode to [-1, 1], rotate by the object's (u, v, n) frame and
    renormalise.  Spheres take the frame of their uv parameterisation at
    each hit; mesh faces their compile-time uv tangent, carried into
    world space under MeshInstances and made orthonormal against the
    (interpolated) normal; planes and boxes their axes."""
    if not static.normal_maps:
        return N_geo
    N = N_geo
    tri_off = sum(static.kind_counts[k] for k in KINDS if k != "tri")
    geom = data.geom
    for ref in static.normal_maps:
        m = shade.fetch_texture(data.textures[ref.tex], uv, ref.repeat,
                                ref.bilinear) - 0.5
        if ref.basis_kind == "sphere":
            # T = dP/du (longitude), B = dP/dv = T x N; N_geo is the
            # sphere's normal on the rays this ref keeps
            s = torch.sqrt(torch.clamp_min(
                N_geo[..., 0] ** 2 + N_geo[..., 2] ** 2, 1e-12))
            T = torch.stack([-N_geo[..., 2] / s, torch.zeros_like(s),
                             N_geo[..., 0] / s], dim=-1)
            B = _cross(T, N_geo)
            Nm = _unit(2.0 * (m[..., 0:1] * T + m[..., 1:2] * B
                              + m[..., 2:3] * N_geo))
            N = torch.where((obj_id == ref.obj)[..., None], Nm, N)
            continue
        if ref.basis_kind == "tri":
            row = obj_id - tri_off
            R_i = None
            if geom.tri_virt_row.shape[0]:
                virt = torch.clamp(row, 0, geom.tri_virt_row.shape[0] - 1)
                row = _take(geom.tri_virt_row, virt)
                R_i = _take(geom.inst_rot, _take(geom.tri_virt_inst, virt))
            else:
                row = torch.clamp(row, 0, max(geom.tri_tan.shape[0] - 1, 0))
            mask = (obj_id >= tri_off) & (_take(geom.tri_nm_slot, row)
                                          == ref.local_id)
            T = _take(geom.tri_tan, row)
            if R_i is not None:
                T = (R_i * T[..., None, :]).sum(-1)
            T = _unit(T - N_geo * (T * N_geo).sum(-1, keepdim=True))
            B = _take(geom.tri_tan_sign, row)[..., None] * _cross(N_geo, T)
            Nm = _unit(2.0 * (m[..., 0:1] * T + m[..., 1:2] * B
                              + m[..., 2:3] * N_geo))
            N = torch.where(mask[..., None], Nm, N)
            continue
        if ref.basis_kind == "plane":
            i = ref.local_id
            # columns u, v, n
            basis = torch.stack([geom.plane_u_axis[i], geom.plane_v_axis[i],
                                 geom.plane_normal[i]], dim=-1)
        else:   # box: the inverse basis' columns are the box's axes
            basis = geom.box_basis[ref.local_id].T
        Nm = _unit((m * 2.0) @ basis.T)
        N = torch.where((obj_id == ref.obj)[..., None], Nm, N)
    return N


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
    """(name, shader, per-ray mask) per block, in the JAX package's order
    (integrator.py:247-260): the present types, a CustomMaterial type
    unrolled into one block per slot."""
    out = []
    for mt in static.mat_types_present:
        if mt == MAT_CUSTOM:
            for slot, cm in enumerate(static.custom_mats):
                out.append(("custom", lambda ctx, d, cm=cm: cm.shade(ctx),
                            (mat_type == mt) & (mat_slot == slot)))
        else:
            out.append((_NAMES.get(mt, mt),
                        lambda ctx, d, mt=mt: _shade(mt, ctx, d),
                        mat_type == mt))
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
    packed_t = data.obj.packed
    n_obj = packed_t.shape[0]

    for bounce in range(settings.max_bounces):
        with record_function("wavefront.nearest_hit"):
            t, orient, obj = nearest_hit(O, D, data.geom)
        with record_function("wavefront.attributes"):
            miss = t >= MISS_THRESHOLD
            P = O + D * t[..., None]
            N_geo, uv = hit_attributes(P, obj, data.geom, static)
            N_shad = _apply_normal_maps(N_geo, P, uv, obj, data, static)
            N_shad = N_shad * orient[..., None]
            packed = packed_t.index_select(0, torch.clamp(obj, 0, n_obj - 1))
            mat_type = packed & 0x7
            mat_slot = (packed >> PACKED_SLOT_SHIFT) & 0x3FF
            obj_max_depth = (packed >> PACKED_DEPTH_SHIFT) & 0x3FF
            obj_mc = ((packed >> PACKED_MC_SHIFT) & 1).to(torch.bool)
            # the scale-aware nudge: an absolute 1e-6 vanishes in float32
            # at Cornell-box coordinates
            eps = settings.nudge_eps * torch.clamp_min(
                torch.amax(torch.abs(P), dim=-1), 1.0)
        with record_function("wavefront.draws"):
            draws = _draw(generator, static, n)
        add, beta_mult = f3(0.0), f3(1.0)
        new_O, new_D, new_n_re, new_n_im = P, D, n_re, n_im
        z = torch.zeros((n,), dtype=torch.bool, device=dev)
        cont = inc_diff = inc_split = z
        ctx = ShadeCtx(data=data, static=static, bounce=bounce, D=D,
                       n_re=n_re, n_im=n_im, depth=depth,
                       diffuse_reflections=diffuse_refl, t=t, P=P, N=N_shad,
                       uv=uv, orient=orient, mat_slot=mat_slot,
                       obj_max_depth=obj_max_depth, obj_mc=obj_mc, eps=eps,
                       pattern=pattern, split_cnt=split_cnt,
                       split_k=settings.split_k, strat_u=strat_u,
                       generator=generator)
        for name, shader, m in _dispatch(static, mat_type, mat_slot):
            with record_function(f"wavefront.shade.{name}"):
                out = shader(ctx, draws)
            m3 = m[..., None]
            add = torch.where(m3, out.add, add)
            beta_mult = torch.where(m3, out.beta_mult, beta_mult)
            new_O = torch.where(m3, out.new_origin, new_O)
            new_D = torch.where(m3, out.new_dir, new_D)
            new_n_re = torch.where(m3, out.new_n_re, new_n_re)
            new_n_im = torch.where(m3, out.new_n_im, new_n_im)
            cont = torch.where(m, out.cont, cont)
            inc_diff = torch.where(m, out.is_diffuse, inc_diff)
            if out.did_split is not None:   # optional for custom shaders
                inc_split = torch.where(m, out.did_split, inc_split)

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
