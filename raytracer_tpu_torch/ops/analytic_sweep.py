"""W3: the wavefront's analytic sweep (csrc/analytic_sweep.cu).

`geometry/intersect.py` `nearest_hit` and `occluded` sweep the analytic
objects (spheres, planes, boxes, discs, cylinders) through the two
wrappers here.  On CUDA tensors a wrapper launches W3 (a failed build or
launch raises; nothing falls back); on CPU tensors it runs W3's plain
version, intersect.py's `_analytic_nearest` and `_analytic_occluded`,
which W3 equals bit for bit.  Each wrapper's `.launches` counts the
kernels it launched.

W3 reads the objects as one (objects, 16) float32 table in object-id
order (`object_table`: each kind's parameters, and the per-object
constants of its test computed with the plain version's own torch
expressions), made once per geometry (`scene_tables`, kept on the
GeometryTables object while the tensors it comes from keep their
version), and takes the plain sweep's block size, `object_block(N)`, for
its tie and NaN rule.  The occluded entry reads the casting objects'
rows alone (`casting_tables`, made once per geometry and shadow mask),
and takes a direction and max_dist that every ray shares (the expand of
one row, as materials/shade.py passes a directional light's) as that one
row, uncopied.  W3 has no backward: `nearest_hit` recomputes the
winners' t in plain torch where autograd needs it
(`intersect.analytic_winner_t`).

The `_*_launch` functions take `lib=`: the tests pass the CPU stand-in's
build of the source (csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry import intersect as isect
from ..utils.constants import FARAWAY
from . import cuda_build
from .mesh_sweep import _call, _check, _p, kept

_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)
_KINDS = [_I] * 5
ENTRIES = {
    "analytic_nearest": [_V, *_KINDS, _I, _V, _V, _L, _V, _V, _V, _V, _N],
    "analytic_occluded": [_V, *_KINDS, _V, _V, _I, _L, _V, _I, _V, _V, _N],
}
ROW = 16                  # floats an object takes in W3's table
# W3's kernels by name, as a profile lists them
KERNELS = ("analytic_nearest_kernel", "analytic_occluded_kernel")


def kind_counts(geom):
    """Objects of each analytic kind: spheres, planes, boxes, discs,
    cylinders (object-id order)."""
    return [geom.sphere_radius.shape[0], geom.plane_half_w.shape[0],
            geom.box_basis.shape[0], geom.disc_r_out.shape[0],
            geom.cyl_radius.shape[0]]


def _rows(*cols):
    """An (M, 16) block of rows from (M, k) columns, zero-padded."""
    x = torch.cat([c if c.dim() == 2 else c[:, None] for c in cols], dim=1)
    return torch.cat([x, x.new_zeros((x.shape[0], ROW - x.shape[1]))], dim=1)


def object_table(geom):
    """(objects, 16) float32: each analytic object as W3 reads it, in
    object-id order, four float4 words a row:
    - sphere: (center, radius * radius);
    - plane: (center, half_w), (normal, half_h), (u_axis, 0), (v_axis, 0);
    - box: (basis row i, lb_local[i]) for i = 0, 1, 2, (rt_local, 0);
    - disc: (center, r_out * r_out), (normal, r_in * r_in);
    - cylinder: (u_axis, off(u_axis)), (axis, off(axis)), (v_axis,
      off(v_axis)), (radius * radius, half_h, capped, 0), off(a) = a .
      center as intersect_cylinders computes it.
    The constants are the plain intersectors' own torch expressions."""
    g = geom
    with torch.no_grad():
        z1 = lambda m: g.sphere_center.new_zeros((m, 1))

        def off(a, c):
            return a[:, 0] * c[:, 0] + a[:, 1] * c[:, 1] + a[:, 2] * c[:, 2]

        parts = [
            _rows(g.sphere_center, g.sphere_radius * g.sphere_radius),
            _rows(g.plane_center, g.plane_half_w, g.plane_normal,
                  g.plane_half_h, g.plane_u_axis, z1(g.plane_u_axis.shape[0]),
                  g.plane_v_axis),
            _rows(*(x for i in range(3) for x in (g.box_basis[:, i, :],
                                                  g.box_lb_local[:, i])),
                  g.box_rt_local),
            _rows(g.disc_center, g.disc_r_out * g.disc_r_out, g.disc_normal,
                  g.disc_r_in * g.disc_r_in),
            _rows(g.cyl_u_axis, off(g.cyl_u_axis, g.cyl_center), g.cyl_axis,
                  off(g.cyl_axis, g.cyl_center), g.cyl_v_axis,
                  off(g.cyl_v_axis, g.cyl_center), g.cyl_radius * g.cyl_radius,
                  g.cyl_half_h, g.cyl_capped.to(g.cyl_radius.dtype)),
        ]
        return torch.cat(parts).to(torch.float32).contiguous()


def scene_tables(geom):
    """`object_table(geom)`, made at a geometry's first sweep and kept on
    it while the analytic tables keep their version."""
    srcs = tuple(x for _, tabs, _ in isect._type_blocks(geom, skip_tris=True)
                 for x in tabs)
    return kept(geom, "_w3_table", srcs, lambda: object_table(geom))


def _rays(O, D):
    """(O, D) detached and contiguous; raise unless both are float32."""
    if O.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("W3 takes float32 rays")
    return O.detach().contiguous(), D.detach().contiguous()


def _uniform(x):
    """(x detached, its row step): (x's one row, 0) where every row of x is
    that row (an expand, stride 0 along rays), else (x contiguous, 1)."""
    x = x.detach()
    if x.dim() >= 1 and x.shape[0] > 1 and x.stride(0) == 0:
        return x[:1].contiguous(), 0
    return x.contiguous(), 1


def casting_tables(geom, shadow_obj_mask):
    """(rows, counts): the rows of `scene_tables(geom)` whose
    shadow_obj_mask bit is set, in object-id order, and how many of each
    kind: what W3's occluded entry sweeps.  Made with one host copy of the
    mask, and `kept` on geom while the table and the mask are the same
    tensors at the same version."""
    table = scene_tables(geom)

    def make():
        counts = kind_counts(geom)
        mask = shadow_obj_mask[:sum(counts)]
        if mask.dtype != torch.bool or mask.shape[0] != sum(counts):
            raise ValueError("shadow_obj_mask must be bool, one entry an object")
        bits = mask.cpu()
        starts = [sum(counts[:k]) for k in range(len(counts))]
        cast = [int(bits[a:a + c].sum()) for a, c in zip(starts, counts)]
        ids = torch.nonzero(bits).flatten().to(table.device)
        return table.index_select(0, ids).contiguous(), cast

    return kept(geom, "_w3_casting", (table, shadow_obj_mask), make)


def _nearest_launch(O, D, geom, lib=None):
    """(t, orient, obj_id) of each ray by W3's nearest entry from `lib`
    (see `analytic_nearest`), with the plain sweep's tie and NaN rule for
    its blocks of `intersect.object_block(N)` objects.  Adds its launches
    to analytic_nearest.launches."""
    n, dev = O.shape[0], O.device
    counts = kind_counts(geom)
    t = torch.full((n,), FARAWAY, dtype=torch.float32, device=dev)
    orient = torch.ones((n,), dtype=torch.float32, device=dev)
    obj_id = torch.zeros((n,), dtype=torch.int64, device=dev)
    if n == 0 or not sum(counts):
        return t, orient, obj_id
    O, D = _rays(O, D)
    table = scene_tables(geom)
    _check(table, O, D)
    analytic_nearest.launches += _call(
        lib, "analytic_nearest", _p(table), *counts, isect.object_block(n),
        _p(O), _p(D), n, _p(t), _p(orient), _p(obj_id),
        cuda_build.stream_of(dev), entries=ENTRIES)
    return t, orient, obj_id


def _occluded_launch(O, D, geom, shadow_obj_mask, max_dist, lib=None):
    """W3's shadow-ray answer from `lib` (see `analytic_occluded`): the
    casting objects alone; D and max_dist passed as their one row where
    every ray shares it.  Adds its launches to analytic_occluded.launches
    (none where no analytic object casts)."""
    n, dev = O.shape[0], O.device
    if n == 0 or not sum(kind_counts(geom)):
        return torch.zeros((n,), dtype=torch.bool, device=dev)
    if O.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("W3 takes float32 rays")
    rows, counts = casting_tables(geom, shadow_obj_mask)
    if not sum(counts):
        return torch.zeros((n,), dtype=torch.bool, device=dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)    # every ray written
    O = O.detach().contiguous()
    D, d_step = _uniform(D)
    md, md_step = _uniform(max_dist)
    md = md.to(torch.float32)
    if D.shape[-1] != 3 or D.shape[0] != (n if d_step else 1) \
            or md.shape[0] != (n if md_step else 1):
        raise ValueError("W3 takes D (N, 3) and max_dist (N,)")
    _check(rows, O, D, md)
    analytic_occluded.launches += _call(
        lib, "analytic_occluded", _p(rows), *counts, _p(O), _p(D), d_step, n,
        _p(md), md_step, _p(occ), cuda_build.stream_of(dev), entries=ENTRIES)
    return occ


def analytic_nearest(O, D, geom):
    """(t, orient, obj_id) of each ray's nearest analytic object, each
    (N,): t and orient float32, obj_id int64; FARAWAY, 1 and 0 on a miss
    (intersect.py `_analytic_nearest`)."""
    if O.device.type == "cpu":
        return isect._analytic_nearest(O, D, geom)
    return _nearest_launch(O, D, geom)


def analytic_occluded(O, D, geom, shadow_obj_mask, max_dist):
    """True where an analytic object whose shadow_obj_mask bit is set (the
    mask in object-id order; its triangle part is not read) lies nearer
    than max_dist (intersect.py `_analytic_occluded`).  D (N, 3) and
    max_dist (N,) may be the expand of one row, which the card's W3 reads
    as that row."""
    if O.device.type == "cpu":
        return isect._analytic_occluded(O, D, geom, shadow_obj_mask, max_dist)
    return _occluded_launch(O, D, geom, shadow_obj_mask, max_dist)


WRAPPERS = (analytic_nearest, analytic_occluded)
for _w in WRAPPERS:
    _w.launches = 0


def launches():
    """W3's launches over its two wrappers."""
    return sum(w.launches for w in WRAPPERS)


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0
