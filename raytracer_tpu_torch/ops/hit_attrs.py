"""W5: the wavefront's hit attributes (csrc/hit_attrs.cu).

`core/integrator.py` `trace` takes each bounce's attributes from
`attributes` here: the hit point, the shading normal, uv, whether the ray
missed, the packed material word and its four fields, and the nudge
offset of its continuation.  `core/ray.py`'s first-hit pass, which the
AOV planes share, takes them from it too (the point, the geometric normal
and uv zero on a miss).  On CUDA tensors it
launches W5, one launch a bounce (a failed build or launch raises;
nothing falls back); on CPU tensors it runs W5's plain version,
`plain_attributes`: geometry/attrs.py `hit_attributes` (every present
kind's formula over every ray, merged by torch.where), the normal maps
(`_apply_normal_maps`: every ref's mapped normal over every ray, merged
by torch.where), the orientation, the word's decode and the nudge, which
W5 equals bit for bit.  `attributes.launches` counts the kernels it
launched.

W5 computes each ray's own kind alone.  It reads the analytic objects as
one (objects, 16) float32 table in object-id order (`attr_table`, each
kind's parameters copied, made once per geometry and kept on it by
`mesh_sweep.kept`), and the triangle, corner, instance and packed tables
by pointer (`scene_struct`, kept likewise).  Where the scene maps
normals, a ray also finds the last ref whose mask holds and computes that
ref's mapped normal from the geometric one, before orienting it: the refs
as a table of a row each (`map_tables`: object, basis kind, local id, a
plane's or a box's basis, the maps' texels and descriptors in W4's form,
`wavefront_shade.texture_tables`), the mesh tangents by pointer.  Where
autograd records the stage (grad enabled and an input requiring grad:
the rays, a geometry table, a map's texture), the kernel runs inside
`_Attrs`, whose backward is a kernel too (`attrs_vjp`: csrc/hit_attrs.cu
`hit_attrs_bwd`, one launch), the gradients of O, D and t, of the
geometry's tables (its TABLES instance's per-ray rows, reduced by
`safemath.take_backward`) and, through the normal maps (its MAPS
instance), of the maps' textures (their taps' rows): the plain stage's
vector-Jacobian product (`plain_attrs_vjp`) bit for bit; the plain
stage runs in the tests alone.  The orientation is +-1 from a bool
(geometry/intersect.py `_orient`) and takes no gradient.
`backward_launches()` counts the backward kernel.

The `_launch` function and `attrs_vjp` take `lib=`: the tests pass the CPU
stand-in's build of the source (csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..core.compile import (KINDS, PACKED_DEPTH_SHIFT, PACKED_MC_SHIFT,
                            PACKED_SLOT_SHIFT, TexRef)
from ..core.safemath import safe_norm, take, take_backward
from ..geometry.attrs import hit_attributes
from ..materials import shade
from ..utils.constants import MISS_THRESHOLD, NUDGE_EPS
from . import cuda_build
from . import wavefront_shade as ws
from .analytic_sweep import _rows
from .mesh_sweep import _call, kept
from .plain_grad import plain_vjp

_V, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# W5's kernel by name, as a profile lists it (both instances)
KERNELS = ("hit_attrs_kernel",)
ROW = 16                  # floats an analytic object takes in W5's table
# a normal map's basis kind as W5 reads it (csrc/hit_attrs.cu MAP_*)
MAP_KINDS = {"sphere": 0, "plane": 1, "box": 2, "tri": 3}


class Scene(ctypes.Structure):
    _fields_ = [("rows", _V), ("counts", _L * len(KINDS)), ("tri_p1", _V),
                ("tri_p2", _V), ("tri_p3", _V), ("tri_normal", _V), ("vn1", _V),
                ("vn2", _V), ("vn3", _V), ("uv1", _V), ("uv2", _V), ("uv3", _V),
                ("virt_row", _V), ("virt_inst", _V), ("inst_rot", _V),
                ("inst_trans", _V), ("inst_inv_scale", _V), ("packed", _V),
                ("n_obj", _L), ("n_maps", _L), ("map_i", _V), ("map_basis", _V),
                ("map_tex", ws.Textures), ("tri_tan", _V), ("tri_tan_sign", _V),
                ("tri_nm_slot", _V), ("tan_rows", _L)]


class Rays(ctypes.Structure):
    _fields_ = [("O", _V), ("D", _V), ("t", _V), ("orient", _V), ("obj", _V),
                ("n", _L), ("need_uv", _I), ("first_hit", _I),
                ("nudge", _F), ("miss_at", _F), ("P", _V), ("N", _V), ("uv", _V),
                ("eps", _V), ("miss", _V), ("mc", _V), ("packed", _V),
                ("mat_type", _V), ("mat_slot", _V), ("max_depth", _V)]


# The geometry tables whose gradients W5's backward writes as per-ray rows
# (csrc/hit_attrs.cu `Table`, in its order): name, kind, the output
# (N: the normal, uv) that reaches it.  A triangle table's reach depends
# on the corners and instances (`_table_reach`); cyl_capped is compared,
# not differentiated, and the tables the stage does not read take none.
TABLES = (
    ("sphere_center", "sphere", "N uv"), ("sphere_radius", "sphere", "N uv"),
    ("plane_normal", "plane", "N"), ("plane_center", "plane", "uv"),
    ("plane_half_w", "plane", "uv"), ("plane_half_h", "plane", "uv"),
    ("plane_uv_shift", "plane", "uv"), ("plane_u_axis", "plane", "uv"),
    ("plane_v_axis", "plane", "uv"),
    ("box_basis", "box", "N uv"), ("box_whl", "box", "uv"), ("box_center", "box", "N uv"),
    ("disc_normal", "disc", "N"), ("disc_center", "disc", "uv"),
    ("disc_r_out", "disc", "uv"), ("disc_u_axis", "disc", "uv"),
    ("disc_v_axis", "disc", "uv"),
    ("cyl_axis", "cyl", "N uv"), ("cyl_u_axis", "cyl", "N uv"),
    ("cyl_v_axis", "cyl", "N uv"), ("cyl_radius", "cyl", "uv"),
    ("cyl_half_h", "cyl", "uv"), ("cyl_center", "cyl", "N uv"),
    ("tri_normal", "tri", ""), ("tri_p1", "tri", ""), ("tri_p2", "tri", ""),
    ("tri_p3", "tri", ""), ("tri_vn1", "tri", ""), ("tri_vn2", "tri", ""),
    ("tri_vn3", "tri", ""), ("tri_uv1", "tri", ""), ("tri_uv2", "tri", ""),
    ("tri_uv3", "tri", ""), ("inst_rot", "tri", ""), ("inst_trans", "tri", ""),
    ("inst_inv_scale", "tri", ""))
_TABLE_AT = {name: k for k, (name, _, _) in enumerate(TABLES)}


class RaysBwd(ctypes.Structure):
    _fields_ = [("O", _V), ("D", _V), ("t", _V), ("orient", _V), ("obj", _V),
                ("n", _L), ("need_uv", _I), ("first_hit", _I), ("nudge", _F),
                ("miss_at", _F), ("gP", _V), ("gN", _V), ("guv", _V), ("geps", _V),
                ("dO", _V), ("dD", _V), ("dt", _V), ("tab", _V * len(TABLES)),
                ("map_taps", ws.TapRows), ("map_rows", _V)]


ENTRIES = {
    "hit_attrs": [ctypes.POINTER(Scene), ctypes.POINTER(Rays), _V,
                  ctypes.POINTER(_I)],
    "hit_attrs_bwd": [ctypes.POINTER(Scene), ctypes.POINTER(RaysBwd), _V,
                      ctypes.POINTER(_I)],
    "hit_attrs_math": [_I, _V, _V, _L, _V, _V, ctypes.POINTER(_I)],
}
# the float32 of MISS_THRESHOLD, as `t >= MISS_THRESHOLD` compares
MISS_AT = float(torch.tensor(MISS_THRESHOLD, dtype=torch.float32))


@dataclass
class Attrs:
    """A bounce's attributes, each (N, ...) on the rays' device.  N is the
    shading normal (normal-mapped where the scene maps normals, times the
    orientation), or, from the first-hit pass, the geometric normal."""
    P: Any            # (N, 3) float32 hit points
    N: Any            # (N, 3) float32
    uv: Any           # (N, 2) float32, zero unless sampled or forced
    miss: Any         # (N,) bool
    mat_type: Any     # (N,) int32
    mat_slot: Any     # (N,) int32
    obj_max_depth: Any   # (N,) int32
    obj_mc: Any       # (N,) bool
    eps: Any          # (N,) float32 nudge offsets
    packed: Any       # (N,) int32 material words


FLOAT_FIELDS = ("P", "N", "uv", "eps")
OTHER_FIELDS = ("miss", "packed", "mat_type", "mat_slot", "obj_max_depth",
                "obj_mc")


# ---------------------------------------------------------------------------
# the plain version (the stage as core/integrator.py ran it, op by op)
# ---------------------------------------------------------------------------


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


def _nudge_uv(static, settings, force_uv):
    """(nudge_eps, need_uv) of a call."""
    nudge = settings.nudge_eps if settings is not None else NUDGE_EPS
    return nudge, bool(static.needs_uv or force_uv)


def _plain_core(O, D, t, orient, obj, data, static, nudge, need_uv, first_hit):
    """(P, N, uv, eps) as W5 writes them: the hit point, the shading normal
    (the geometric one normal-mapped, times the orientation; the geometric
    one alone in the first-hit pass), uv (the three zero on a miss in the
    first-hit pass) and the nudge."""
    P = O + D * t[..., None]
    if first_hit:
        miss = (t >= MISS_THRESHOLD)[..., None]
        P = torch.where(miss, 0.0, P)
    N, uv = hit_attributes(P, obj, data.geom, static, force_uv=need_uv)
    if first_hit:
        N, uv = torch.where(miss, 0.0, N), torch.where(miss, 0.0, uv)
    else:
        N = _apply_normal_maps(N, P, uv, obj, data, static) * orient[..., None]
    # the scale-aware nudge: an absolute 1e-6 vanishes in float32 at
    # Cornell-box coordinates
    eps = nudge * torch.clamp_min(torch.amax(torch.abs(P), dim=-1), 1.0)
    return P, N, uv, eps


def _decode(t, obj, data):
    """(miss, packed, mat_type, mat_slot, obj_max_depth, obj_mc)."""
    packed_t = data.obj.packed
    packed = packed_t.index_select(0, torch.clamp(obj, 0, packed_t.shape[0] - 1))
    return (t >= MISS_THRESHOLD, packed, packed & 0x7,
            (packed >> PACKED_SLOT_SHIFT) & 0x3FF,
            (packed >> PACKED_DEPTH_SHIFT) & 0x3FF,
            ((packed >> PACKED_MC_SHIFT) & 1).to(torch.bool))


def plain_attributes(O, D, t, orient, obj, data, static, settings=None,
                     force_uv=False, first_hit=False):
    """W5's plain version: the attribute stage in plain torch (see
    `attributes`)."""
    P, N, uv, eps = _plain_core(O, D, t, orient, obj, data, static,
                                *_nudge_uv(static, settings, force_uv), first_hit)
    miss, packed, mat_type, mat_slot, depth, mc = _decode(t, obj, data)
    return Attrs(P=P, N=N, uv=uv, miss=miss, mat_type=mat_type, mat_slot=mat_slot,
                 obj_max_depth=depth, obj_mc=mc, eps=eps, packed=packed)


# ---------------------------------------------------------------------------
# the scene as W5 reads it
# ---------------------------------------------------------------------------


def attr_table(geom):
    """(analytic objects, 16) float32: each analytic object as W5 reads
    it, in object-id order, four float4 words a row (csrc/hit_attrs.cu
    `Scene`); the tables' values copied, none computed."""
    g = geom
    with torch.no_grad():
        col = lambda x, i: x[:, i]
        z1 = lambda x: x.new_zeros((x.shape[0],))
        parts = [
            _rows(g.sphere_center, g.sphere_radius),
            _rows(g.plane_center, g.plane_half_w, g.plane_normal, g.plane_half_h,
                  g.plane_u_axis, col(g.plane_uv_shift, 0), g.plane_v_axis,
                  col(g.plane_uv_shift, 1)),
            _rows(*(x for i in range(3) for x in (g.box_basis[:, i, :],
                                                  g.box_whl[:, i])),
                  g.box_center),
            _rows(g.disc_center, g.disc_r_out, g.disc_normal, z1(g.disc_r_out),
                  g.disc_u_axis, z1(g.disc_r_out), g.disc_v_axis),
            _rows(g.cyl_center, g.cyl_radius, g.cyl_axis, g.cyl_half_h,
                  g.cyl_u_axis, g.cyl_capped.to(g.cyl_radius.dtype), g.cyl_v_axis),
        ]
        return torch.cat(parts).detach().to(torch.float32).contiguous()


def _analytic_srcs(geom):
    return (geom.sphere_center, geom.sphere_radius, geom.plane_center,
            geom.plane_half_w, geom.plane_normal, geom.plane_half_h,
            geom.plane_u_axis, geom.plane_v_axis, geom.plane_uv_shift,
            geom.box_basis, geom.box_whl, geom.box_center, geom.disc_center,
            geom.disc_r_out, geom.disc_normal, geom.disc_u_axis,
            geom.disc_v_axis, geom.cyl_center, geom.cyl_radius, geom.cyl_axis,
            geom.cyl_half_h, geom.cyl_u_axis, geom.cyl_capped, geom.cyl_v_axis)


_TRI = ("tri_p1", "tri_p2", "tri_p3", "tri_normal")
_CORNERS = ("tri_vn1", "tri_vn2", "tri_vn3", "tri_uv1", "tri_uv2", "tri_uv3")
_INST = ("inst_rot", "inst_trans", "inst_inv_scale")


def _ptr(x):
    return x.data_ptr() if x is not None and x.numel() else None


def _map_srcs(data, static):
    """The tensors the normal maps' tables come from."""
    if not static.normal_maps:
        return ()
    g = data.geom
    return (g.plane_u_axis, g.plane_v_axis, g.plane_normal, g.box_basis, g.tri_tan,
            g.tri_tan_sign, g.tri_nm_slot,
            *(data.textures[k] for k in sorted({r.tex for r in static.normal_maps})))


def map_tables(data, static):
    """{name: tensor} of the normal maps as W5 reads them (csrc/hit_attrs.cu
    `Scene`), a row a ref in static.normal_maps order: "map_i" (refs, 4)
    int32 (object id, -1 for a mesh ref; basis kind, MAP_KINDS; local id;
    0); "map_basis" (refs, 9) float32, a plane's or a box's M, row-major,
    with the plain branch's (m * 2.0) @ basis.T = (m * 2.0) @ M (a plane's
    rows u axis, v axis, normal; a box's its basis; zero for a sphere or a
    mesh); "texels", "desc_i", "desc_f" the refs' textures as
    `wavefront_shade.texture_tables` gives them, descriptor row r ref r's;
    and, with a mesh ref, "tri_tan", "tri_tan_sign" (float32) and
    "tri_nm_slot" (int32), of one row count.  Values copied, none computed.
    Empty without maps."""
    refs = static.normal_maps
    if not refs:
        return {}
    g = data.geom
    dev = g.plane_normal.device
    with torch.no_grad():
        basis = torch.zeros((len(refs), 9), dtype=torch.float32, device=dev)
        for i, r in enumerate(refs):
            if r.basis_kind == "plane":
                basis[i] = torch.stack([g.plane_u_axis[r.local_id],
                                        g.plane_v_axis[r.local_id],
                                        g.plane_normal[r.local_id]]).reshape(-1)
            elif r.basis_kind == "box":
                basis[i] = g.box_basis[r.local_id].reshape(-1)
        map_i = torch.tensor([[r.obj, MAP_KINDS[r.basis_kind], r.local_id, 0]
                              for r in refs], dtype=torch.int32, device=dev)
        texels, desc_i, desc_f = ws.texture_tables(
            g, map_i, [TexRef(i, r.tex, r.repeat, r.bilinear)
                       for i, r in enumerate(refs)], data.textures, "w5_maps")
        out = dict(map_i=map_i, map_basis=basis, texels=texels, desc_i=desc_i,
                   desc_f=desc_f)
        if any(r.basis_kind == "tri" for r in refs):
            rows = {g.tri_tan.shape[0], g.tri_tan_sign.shape[0],
                    g.tri_nm_slot.shape[0]}
            if (g.tri_virt_row.shape[0] not in (0, static.kind_counts["tri"])
                    or len(rows) != 1):
                raise ValueError("W5: the tangent or instance tables do not match "
                                 "the scene's triangles")
            out.update(tri_tan=g.tri_tan.detach().to(torch.float32).contiguous(),
                       tri_tan_sign=g.tri_tan_sign.detach().to(torch.float32)
                       .contiguous(),
                       tri_nm_slot=g.tri_nm_slot.detach().to(torch.int32)
                       .contiguous())
        return out


def scene_struct(data, static):
    """(the Scene struct W5 reads, the tensors it points into): made at a
    geometry's first call and kept on it while its tables, the packed
    words and the maps' textures are the same tensors at the same
    version."""
    geom = data.geom
    srcs = (*_analytic_srcs(geom), *(getattr(geom, f) for f in _TRI + _CORNERS
                                     + _INST), geom.tri_virt_row,
            geom.tri_virt_inst, data.obj.packed, *_map_srcs(data, static))

    def make():
        counts = [static.kind_counts[k] for k in KINDS]
        table = attr_table(geom)
        if table.shape[0] != sum(counts[:-1]):
            raise ValueError("W5: the analytic tables do not match the scene's "
                             "kind counts")
        f32 = lambda x: x.detach().to(torch.float32).contiguous()
        i32 = lambda x: x.detach().to(torch.int32).contiguous()
        tri = {f: f32(getattr(geom, f)) for f in _TRI}
        corners = ({f: f32(getattr(geom, f)) for f in _CORNERS}
                   if geom.tri_vn1.shape[0] else {})
        inst = {}
        if geom.tri_virt_row.shape[0]:
            inst = {f: f32(getattr(geom, f)) for f in _INST}
            inst.update(virt_row=i32(geom.tri_virt_row),
                        virt_inst=i32(geom.tri_virt_inst))
        packed = i32(data.obj.packed)
        maps = map_tables(data, static)
        struct = Scene(
            rows=_ptr(table), counts=(_L * len(KINDS))(*counts),
            **{f: _ptr(x) for f, x in tri.items()},
            **{f[4:]: _ptr(x) for f, x in corners.items()},
            **{f: _ptr(x) for f, x in inst.items()},
            packed=_ptr(packed), n_obj=packed.shape[0],
            n_maps=len(static.normal_maps),
            tan_rows=maps["tri_tan"].shape[0] if "tri_tan" in maps else 0,
            map_tex=ws.Textures(*(_ptr(maps.get(k))
                                  for k in ("texels", "desc_i", "desc_f"))),
            **{f: _ptr(maps.get(f)) for f in ("map_i", "map_basis", "tri_tan",
                                              "tri_tan_sign", "tri_nm_slot")})
        return struct, (table, tri, corners, inst, packed, maps)

    # the refs name the entry: one geometry may meet statics of other maps
    name = "_w5_scene" + "".join(f"_{r.obj}.{r.tex}.{r.repeat}.{r.basis_kind}."
                                 f"{r.local_id}.{r.bilinear}"
                                 for r in static.normal_maps)
    return kept(geom, name, srcs, make)


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


def _rays_in(O, D, t, orient, obj):
    """The rays as W5 reads them, detached and contiguous; raise unless
    float32 (obj int64) and of one ray count."""
    for name, x in (("O", O), ("D", D), ("t", t), ("orient", orient)):
        if x.dtype != torch.float32:
            raise TypeError(f"W5 takes float32 rays: {name} is {x.dtype}")
    if obj.dtype != torch.int64:
        raise TypeError(f"W5 takes int64 object ids, got {obj.dtype}")
    n = t.shape[0]
    if O.shape != (n, 3) or D.shape != (n, 3) or orient.shape != (n,) \
            or obj.shape != (n,):
        raise ValueError("W5 takes O, D (N, 3) and t, orient, obj (N,)")
    return [x.detach().contiguous() for x in (O, D, t, orient, obj)]


def _launch(O, D, t, orient, obj, data, static, nudge, need_uv, first_hit,
            lib=None):
    """W5 from `lib` on the rays: an Attrs as `attributes` gives it.  Adds
    its launches to `attributes.launches` (`_COUNTED`)."""
    O, D, t, orient, obj = _rays_in(O, D, t, orient, obj)
    n, dev = t.shape[0], t.device
    struct, keep = scene_struct(data, static)
    if keep[0].device != dev:
        raise ValueError(f"W5: the scene is on {keep[0].device}, the rays on {dev}")
    f = lambda *s: torch.empty((n, *s), dtype=torch.float32, device=dev)
    i = lambda: torch.empty((n,), dtype=torch.int32, device=dev)
    b = lambda: torch.empty((n,), dtype=torch.bool, device=dev)
    out = Attrs(P=f(3), N=f(3), uv=f(2), miss=b(), mat_type=i(), mat_slot=i(),
                obj_max_depth=i(), obj_mc=b(), eps=f(), packed=i())
    if n == 0:
        return out
    rays = Rays(O=O.data_ptr(), D=D.data_ptr(), t=t.data_ptr(),
                orient=orient.data_ptr(), obj=obj.data_ptr(), n=n,
                need_uv=int(need_uv), first_hit=int(first_hit), nudge=nudge,
                miss_at=MISS_AT,
                P=out.P.data_ptr(), N=out.N.data_ptr(), uv=out.uv.data_ptr(),
                eps=out.eps.data_ptr(), miss=out.miss.data_ptr(),
                mc=out.obj_mc.data_ptr(), packed=out.packed.data_ptr(),
                mat_type=out.mat_type.data_ptr(), mat_slot=out.mat_slot.data_ptr(),
                max_depth=out.obj_max_depth.data_ptr())
    _COUNTED.launches += _call(lib, "hit_attrs", ctypes.byref(struct),
                                 ctypes.byref(rays), cuda_build.stream_of(dev),
                                 entries=ENTRIES)
    return out


# ---------------------------------------------------------------------------
# autograd: the kernel forward, the backward kernel
# ---------------------------------------------------------------------------


def _geom_floats(geom):
    """The names of geom's float tables (what the attributes can take a
    gradient through), found at a geometry's first call and kept on it."""
    return kept(geom, "_w5_floats", (), lambda: tuple(
        f.name for f in dataclasses.fields(geom)
        if getattr(geom, f.name).is_floating_point()))


# the tables each map basis kind reads (`_apply_normal_maps`)
_MAP_TABLES = {"plane": ("plane_u_axis", "plane_v_axis", "plane_normal"),
               "box": ("box_basis",), "tri": ("tri_tan", "tri_tan_sign", "inst_rot")}
# the kinds whose normal depends on P (a triangle's where it blends its
# corners' normals)
_N_OF_P = ("sphere", "box", "cyl")


def plain_attrs_vjp(grads, xs, obj, data, static, modes, names, texs, wants):
    """The plain stage's vector-Jacobian product (ops/plain_grad.py
    `plain_vjp`): the gradients of xs (O, D, t, orient, the geometry's
    tables `names`, the maps' textures `texs`; None where not wanted or
    reached) from those of P, N, uv and eps (FLOAT_FIELDS); modes: (nudge,
    need_uv, first_hit)."""
    def plain(leaves):
        d, k = data, 4 + len(names)
        if names or texs:
            textures = list(data.textures)
            for i, x in zip(texs, leaves[k:]):
                textures[i] = x
            d = dataclasses.replace(
                data, textures=tuple(textures), geom=dataclasses.replace(
                    data.geom, **dict(zip(names, leaves[4:k]))))
        return _plain_core(*leaves[:4], obj, d, static, *modes)

    return plain_vjp(grads, xs, wants, plain)


def _table_reach(name, kind, reach, static, geom, need_uv, n_grad, uv_grad):
    """Whether the plain stage's gather of geometry table `name` (a row of
    TABLES) takes a gradient: its kind present and an output gradient
    reaching it (n_grad: N's, uv_grad: uv's, taken with uv computed)."""
    if not static.kind_counts[kind]:
        return False
    uv = uv_grad and need_uv
    if kind != "tri":
        return (n_grad and "N" in reach) or (uv and "uv" in reach)
    interp = geom.tri_vn1.shape[0] > 0
    inst = geom.tri_virt_row.shape[0] > 0
    if name == "tri_normal":
        return n_grad and not interp
    if name in ("tri_vn1", "tri_vn2", "tri_vn3"):
        return n_grad and interp
    if name in ("tri_uv1", "tri_uv2", "tri_uv3"):
        return uv and interp
    if name == "inst_rot":
        return inst and (n_grad or uv)
    # the corners and the instances' other tables: the barycentric solve
    solve = uv or (n_grad and interp)
    return solve and (inst or not name.startswith("inst_"))


def _table_rows(name, obj, geom, static):
    """The rows of table `name` that the plain stage's gather of it reads,
    a ray each: the ray's object id less its kind's offset, clamped into
    the kind; a triangle table's through the virtual ids' rows, an
    instance table's through their instances."""
    kind = TABLES[_TABLE_AT[name]][1]
    off = 0
    for k in KINDS:
        if k == kind:
            break
        off += static.kind_counts[k]
    local = torch.clamp(obj - off, 0, static.kind_counts[kind] - 1)
    if kind != "tri" or not geom.tri_virt_row.shape[0]:
        return local
    if name.startswith("inst_"):
        return geom.tri_virt_inst.index_select(0, local).long()
    return geom.tri_virt_row.index_select(0, local).long()


def attrs_vjp(grads, O, D, t, orient, obj, data, static, modes, wants, lib=None,
              names=(), texs=()):
    """The stage's vector-Jacobian product from W5's backward kernel (`lib`;
    csrc/hit_attrs.cu `hit_attrs_bwd`), one launch: the gradients of O, D,
    t and orient (orient takes none), of the geometry's tables `names` and
    of the maps' textures `texs` (wants: one each of those), from those of
    P, N, uv and eps (grads, one a FLOAT_FIELDS; None where none comes), as
    `plain_attrs_vjp` gives them, bit for bit.  A table of TABLES takes the
    kernel's per-ray rows (its TABLES instance), reduced by
    core/safemath.py `take_backward` over the rows its gather reads, a
    table the normal maps read the maps' contributions too
    (`_map_table_grads`), and a map's texture its taps' rows
    (`ws.texture_grads`); the others take none."""
    out = [None] * (4 + len(names) + len(texs))
    got = _attrs_rows(grads, O, D, t, orient, obj, data, static, modes, wants, lib, names,
                      texs)
    if got is None:
        return out
    out[:3], rows, taps, wanted, map_rows = got
    geom = data.geom
    # a table's gradient: the maps' contributions (their refs last first),
    # then the gather of the attributes' formulas
    parts = _map_table_grads(map_rows, obj, data, static) if map_rows is not None else {}
    for x, r in rows.items():
        parts.setdefault(x, []).append(take_backward(_table_rows(x, obj, geom, static), r,
                                                     getattr(geom, x).shape))
    for x, ps in parts.items():
        if x in names and wants[4 + names.index(x)]:
            g = ps[0]
            for p in ps[1:]:
                g = g + p
            out[4 + names.index(x)] = g
    if taps[0] is not None:
        refs = ws.tex_refs(data.textures, static.normal_maps)
        for k, g in ws.texture_grads(refs, *taps, wanted).items():
            out[4 + len(names) + texs.index(k)] = g
    return out


def _map_read(static, geom):
    """The geometry tables the normal maps read (`_apply_normal_maps`)."""
    out = set()
    for r in static.normal_maps:
        out.update(_MAP_TABLES.get(r.basis_kind, ()))
    if not geom.tri_virt_row.shape[0]:
        out.discard("inst_rot")
    return out


def _map_table_grads(rows, obj, data, static):
    """{table: its gradients' contributions from the normal maps, in the
    engine's order (the refs last first)} from the MAPS instance's rows
    (`RaysBwd.map_rows`).  A plane's or a box's basis takes the gradient of
    (m 2) @ basis.T (a sum over every ray, cuBLAS's) and a mesh's rotated
    tangent its rotation's (a sum over the rotation's middle dimension):
    both from ATen's own ops on the kernel's rows and the gathered tables,
    as the plain stage takes them; the gathers' by `take_backward`."""
    geom, out = data.geom, {}
    tri_off = sum(static.kind_counts[k] for k in KINDS if k != "tri")
    for ref, r in reversed(list(zip(static.normal_maps, rows))):
        if ref.basis_kind in ("plane", "box"):
            a, gv = r[:, :3].contiguous(), r[:, 3:].contiguous()
            with torch.enable_grad():
                if ref.basis_kind == "plane":
                    xs = [getattr(geom, x).detach().requires_grad_()
                          for x in _MAP_TABLES["plane"]]
                    i = ref.local_id
                    basis = torch.stack([xs[0][i], xs[1][i], xs[2][i]], dim=-1)
                else:
                    xs = [geom.box_basis.detach().requires_grad_()]
                    basis = xs[0][ref.local_id].T
                gs = torch.autograd.grad(a @ basis.T, xs, gv)
            for x, g in zip(_MAP_TABLES[ref.basis_kind], gs):
                out.setdefault(x, []).append(g)
            continue
        if ref.basis_kind != "tri":
            continue
        row = obj - tri_off
        gt = r[:, :3].contiguous()
        if geom.tri_virt_row.shape[0]:
            virt = torch.clamp(row, 0, geom.tri_virt_row.shape[0] - 1)
            row = geom.tri_virt_row.index_select(0, virt).long()
            inst = torch.clamp(geom.tri_virt_inst.index_select(0, virt).long(), 0,
                               geom.inst_rot.shape[0] - 1)
            rows_t = torch.clamp(row, 0, max(geom.tri_tan.shape[0] - 1, 0))
            with torch.enable_grad():
                R = geom.inst_rot.index_select(0, inst).detach().requires_grad_()
                T = geom.tri_tan.index_select(0, rows_t).detach().requires_grad_()
                gR, gt = torch.autograd.grad((R * T[..., None, :]).sum(-1), (R, T), gt)
            out.setdefault("inst_rot", []).append(
                take_backward(inst, gR, geom.inst_rot.shape))
        else:
            row = torch.clamp(row, 0, max(geom.tri_tan.shape[0] - 1, 0))
        rows_t = torch.clamp(row, 0, max(geom.tri_tan.shape[0] - 1, 0))
        out.setdefault("tri_tan", []).append(take_backward(rows_t, gt, geom.tri_tan.shape))
        rows_s = torch.clamp(row, 0, max(geom.tri_tan_sign.shape[0] - 1, 0))
        out.setdefault("tri_tan_sign", []).append(
            take_backward(rows_s, r[:, 3].contiguous(), geom.tri_tan_sign.shape))
    return out


def _attrs_rows(grads, O, D, t, orient, obj, data, static, modes, wants, lib=None,
                names=(), texs=()):
    """W5's backward kernel on the arguments of `attrs_vjp`, one launch: (the
    gradients of O, D and t, {table: its per-ray rows}, the maps' taps'
    (rows, idx), the wanted map textures), None where no output gradient
    comes or nothing wanted is reached.  Adds its launches to
    `attrs_vjp.launches` (its TABLES and MAPS instances' to
    `attrs_vjp.table_launches` and `.map_launches` too)."""
    nudge, need_uv, first_hit = modes
    if wants[3]:
        raise ValueError("W5's backward takes no orientation gradient")
    maps = bool(static.normal_maps) and not first_hit
    gP, gN, guv, geps = grads
    counts, geom = static.kind_counts, data.geom
    if not need_uv:
        guv = None
    # uv takes a gradient from its output's, and from a bilinear map's fetch
    uv_grad = guv is not None or (maps and gN is not None
                                  and any(r.bilinear for r in static.normal_maps))
    tabs = [x for x, w in zip(names, wants[4:]) if w and x in _TABLE_AT
            and _table_reach(x, *TABLES[_TABLE_AT[x]][1:], static, geom, need_uv,
                             gN is not None, uv_grad)]
    interp = geom.tri_vn1.shape[0] > 0
    if not (any(counts[k] for k in _N_OF_P) or (counts["tri"] and interp) or tabs
            or maps):
        gN = None               # no normal depends on P or reaches a table
    wanted = ({k for k, w in zip(texs, wants[4 + len(names):]) if w}
              if maps and gN is not None else set())
    mtabs = ([x for x, w in zip(names, wants[4:]) if w and x in _map_read(static, geom)]
             if maps and gN is not None else [])
    if all(g is None for g in (gP, gN, guv, geps)) or not (any(wants[:3]) or tabs
                                                           or wanted or mtabs):
        return None
    O, D, t, orient, obj = _rays_in(O, D, t, orient, obj)
    n, dev = t.shape[0], t.device
    taps = ws.tap_buffers(ws.tex_refs(data.textures, static.normal_maps), wanted, n, dev)
    map_rows = (torch.empty((len(static.normal_maps), n, 6), dtype=torch.float32,
                            device=dev) if mtabs else None)
    out = [torch.empty(s, dtype=torch.float32, device=dev) if w else None
           for s, w in zip(((n, 3), (n, 3), (n,)), wants)]
    rows = {x: torch.empty((n, *getattr(geom, x).shape[1:]), dtype=torch.float32,
                           device=dev) for x in tabs}
    if n:
        struct, keep = scene_struct(data, static)
        if keep[0].device != dev:
            raise ValueError(f"W5: the scene is on {keep[0].device}, the rays on {dev}")
        g = [None if x is None else _grad_rows(x, w) for x, w in
             ((gP, (n, 3)), (gN, (n, 3)), (guv, (n, 2)), (geps, (n,)))]
        tab = [None] * len(TABLES)
        for x, r in rows.items():
            tab[_TABLE_AT[x]] = r.data_ptr()
        rays = RaysBwd(O=O.data_ptr(), D=D.data_ptr(), t=t.data_ptr(),
                       orient=orient.data_ptr(), obj=obj.data_ptr(), n=n,
                       need_uv=int(need_uv), first_hit=int(first_hit), nudge=nudge,
                       miss_at=MISS_AT, **dict(zip(("gP", "gN", "guv", "geps"),
                                                   (_ptr(x) for x in g))),
                       **dict(zip(("dO", "dD", "dt"), (_ptr(x) for x in out[:3]))),
                       tab=(_V * len(TABLES))(*tab),
                       map_taps=ws.TapRows(*(_ptr(x) for x in taps)),
                       map_rows=_ptr(map_rows))
        launched = _call(lib, "hit_attrs_bwd", ctypes.byref(struct), ctypes.byref(rays),
                         cuda_build.stream_of(dev), entries=ENTRIES)
        attrs_vjp.launches += launched
        if maps:
            attrs_vjp.map_launches += launched
        elif rows:
            attrs_vjp.table_launches += launched
    return out, rows, taps, wanted, map_rows


attrs_vjp.launches = attrs_vjp.table_launches = attrs_vjp.map_launches = 0


def _grad_rows(g, shape):
    """An output gradient as the backward kernel reads it: float32,
    contiguous, of the output's shape."""
    if g.dtype != torch.float32 or tuple(g.shape) != shape:
        raise TypeError(f"W5's backward takes float32 gradients of shape {shape}")
    return g.detach().contiguous()


class _Attrs(torch.autograd.Function):
    """W5 forward (xs: O, D, t, orient, then the geometry's float tables
    that require grad, named in `call`, then the maps' textures that
    require grad, their indices in `call`); its integer and bool outputs
    non-differentiable.  Backward: W5's backward kernel (`attrs_vjp`, the
    tables' and the maps' textures' gradients included)."""

    @staticmethod
    def forward(fctx, call, *xs):
        obj, data, static, modes, names, texs, lib = call
        out = _launch(*xs[:4], obj, data, static, *modes, lib=lib)
        others = [getattr(out, f) for f in OTHER_FIELDS]
        fctx.mark_non_differentiable(*others)
        fctx.data, fctx.static, fctx.modes = data, static, modes
        fctx.names, fctx.texs, fctx.lib = names, texs, lib
        fctx.set_materialize_grads(False)        # see ops/plain_grad.py
        fctx.save_for_backward(obj, *xs)
        return (*(getattr(out, f) for f in FLOAT_FIELDS), *others)

    @staticmethod
    def backward(fctx, *grads):
        obj, *xs = fctx.saved_tensors
        grads, wants = grads[:len(FLOAT_FIELDS)], fctx.needs_input_grad[1:]
        with torch.profiler.record_function("wavefront.backward.attributes"):
            got = attrs_vjp(grads, *xs[:4], obj, fctx.data, fctx.static, fctx.modes,
                            wants, fctx.lib, fctx.names, fctx.texs)
        # the integer and bool outputs take no gradient
        return (None, *got)


def backward_pair(fn, call, xs, grads, wants, lib=None):
    """(kernel, plain) for a backward of `_Attrs` (fn) that ops/plain_grad.py
    `recording` recorded (its forward's call and inputs xs, its output
    gradients, the inputs' needs_input_grad): functions of no argument
    giving the inputs' gradients from W5's backward kernel (`lib`) and
    from the plain stage's VJP, for the holds of one against the other."""
    obj, data, static, modes, names, texs, _ = call
    g = grads[:len(FLOAT_FIELDS)]
    plain = lambda: plain_attrs_vjp(g, xs, obj, data, static, modes, names, texs,
                                    wants)
    return lambda: attrs_vjp(g, *xs[:4], obj, data, static, modes, wants, lib,
                             names, texs), plain


def _kernel_attributes(O, D, t, orient, obj, data, static, settings=None,
                       force_uv=False, first_hit=False, lib=None):
    """W5 on the rays, from `lib`, through `_Attrs` where autograd records
    the stage."""
    modes = (*_nudge_uv(static, settings, force_uv), first_hit)
    geom, names, texs = data.geom, (), ()
    if torch.is_grad_enabled():
        names = tuple(f for f in _geom_floats(geom) if getattr(geom, f).requires_grad)
        if not first_hit:
            texs = tuple(k for k in sorted({r.tex for r in static.normal_maps})
                         if data.textures[k].requires_grad)
    xs = ([O, D, t, orient] + [getattr(geom, f) for f in names]
          + [data.textures[k] for k in texs])
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        res = _Attrs.apply((obj, data, static, modes, names, texs, lib), *xs)
        return Attrs(**dict(zip(FLOAT_FIELDS + OTHER_FIELDS, res)))
    return _launch(O, D, t, orient, obj, data, static, *modes, lib=lib)


def attributes(O, D, t, orient, obj, data, static, settings=None, force_uv=False,
               first_hit=False):
    """The attributes of each ray's nearest hit (t, orient, obj from
    `intersect.nearest_hit`: obj 0 on a miss), as an Attrs: P = O + D t,
    the shading normal (the geometric one of the ray's object, normal-mapped
    where the scene maps it, times the orientation), uv (zero unless the
    scene samples it or force_uv), miss (t >= MISS_THRESHOLD), the packed
    material word (core/compile.py PACKED_*) with its material type, slot,
    depth cap and medium-change bit, and eps, settings.nudge_eps (NUDGE_EPS
    without settings) times max(1, max |P|).  first_hit: the first-hit
    pass's attributes, N the geometric normal, uv always, P, N and uv zero
    on a miss.
    W5 on CUDA tensors, `plain_attributes` on CPU tensors."""
    if O.device.type == "cpu":
        return plain_attributes(O, D, t, orient, obj, data, static, settings,
                                force_uv, first_hit)
    return _kernel_attributes(O, D, t, orient, obj, data, static, settings,
                              force_uv, first_hit)


attributes.launches = 0
# the function whose count a launch adds to (a spy may replace the module's
# `attributes`)
_COUNTED = attributes


def launches():
    """W5's forward launches."""
    return _COUNTED.launches


def backward_launches(tables=False, maps=False):
    """W5's backward launches (tables: those of its TABLES instance, maps:
    of its MAPS instance)."""
    if maps:
        return attrs_vjp.map_launches
    return attrs_vjp.table_launches if tables else attrs_vjp.launches


def reset_launches():
    """Zero the forward and backward counts."""
    _COUNTED.launches = attrs_vjp.launches = attrs_vjp.table_launches = 0
    attrs_vjp.map_launches = 0


INFO = ("registers", "local_bytes", "blocks_per_sm", "sms", "block")


def info(lib=None, maps=False, backward=False, tables=False):
    """What W5's kernel (maps: its instance for normal-mapped scenes;
    backward: its backward kernel, tables: the backward's TABLES instance,
    with maps: its MAPS instance) was built to, read on the card
    (`hit_attrs_info`): registers and local memory (bytes: spills and
    stack) a thread, resident blocks an SM, the SMs and threads a block."""
    fn = (lib or cuda_build.load_library()).hit_attrs_info
    fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], _I
    out = (_I * len(INFO))()
    err = fn((4 if maps else 3 if tables else 2) if backward else int(maps), out)
    if err:
        raise RuntimeError(f"hit_attrs_info: CUDA error {err}")
    return dict(zip(INFO, out))


def math(op, x, y=None, lib=None):
    """W5's own atan2(x, y) (op "atan2"), asin(x) (op "asin") or, as its
    backward takes it, rsqrt(x) (op "rsqrt") of float32 tensors, or its
    x @ y of an (N, 3) x and a (3, 3) y (op "mm3", the maps' plane and box
    branch) and that product's backward into x from x's gradient, x @ y^T
    (op "mm3_bwd"), as its kernels compute them (`hit_attrs_math`): for
    the holds against torch.atan2, torch.asin, torch.rsqrt, torch.matmul
    and its autograd."""
    x = x.contiguous()
    if x.dtype != torch.float32 or (y is not None and y.dtype != torch.float32):
        raise TypeError("W5's math takes float32 tensors")
    code = {"atan2": 0, "asin": 1, "mm3": 2, "rsqrt": 3, "mm3_bwd": 4}[op]
    if code in (0, 2, 4):
        y = y.contiguous()
    if code in (2, 4) and (x.dim() != 2 or x.shape[1] != 3 or y.shape != (3, 3)):
        raise ValueError("W5's mm3 takes an (N, 3) and a (3, 3) tensor")
    out = torch.empty_like(x)
    _call(lib, "hit_attrs_math", code, x.data_ptr(),
          y.data_ptr() if code in (0, 2, 4) else None,
          x.shape[0] if code in (2, 4) else x.numel(),
          out.data_ptr(), cuda_build.stream_of(x.device), entries=ENTRIES)
    return out
