"""Hit attributes on torch tensors: the geometric normal and the texture
uv of each ray's winning object.

Counterpart of raytracer_tpu/geometry/attrs.py: each present kind's
formula runs over the whole wavefront with its ids clamped into the
kind's table, and `torch.where` keeps the rays that hit that kind.  The
uv is computed only when the scene samples it (SceneStatic.needs_uv) or
the caller asks for it.  Mesh triangles with corner normals and uvs
blend them at the hit (smooth shading, mesh textures), and under
MeshInstances a triangle's virtual id maps to a (row, instance) pair
whose object space the hit is solved in (attrs.py:172-243).
"""

from __future__ import annotations

import math

import torch

from ..core.compile import KINDS
from ..core.safemath import div, rdiv, safe_norm, take


def _gather(table, idx):
    """table[idx], with a reproducible gradient (safemath.take)."""
    return take(table, idx)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sphere_attrs(P, local_id, geom, need_uv):
    """Normal and spherical uv (attrs.py:30)."""
    c = _gather(geom.sphere_center, local_id)
    r = _gather(geom.sphere_radius, local_id)
    N = (P - c) / r[..., None]
    if not need_uv:
        return N, None
    phi = torch.atan2(N[..., 2], N[..., 0])
    theta = torch.asin(torch.clamp(N[..., 1], -1.0, 1.0))
    u = div(phi + math.pi, 2.0 * math.pi)
    v = div(theta + math.pi / 2.0, math.pi)
    return N, torch.stack([u, v], dim=-1)


def plane_attrs(P, local_id, geom, need_uv):
    """Normal and planar uv with uv_shift (attrs.py:44)."""
    N = _gather(geom.plane_normal, local_id)
    if not need_uv:
        return N, None
    M_C = P - _gather(geom.plane_center, local_id)
    w = _gather(geom.plane_half_w, local_id)
    h = _gather(geom.plane_half_h, local_id)
    shift = _gather(geom.plane_uv_shift, local_id)
    u = div(_dot(_gather(geom.plane_u_axis, local_id), M_C) / w + 1.0, 2.0) \
        + shift[..., 0]
    v = div(_dot(_gather(geom.plane_v_axis, local_id), M_C) / h + 1.0, 2.0) \
        + shift[..., 1]
    return N, torch.stack([u, v], dim=-1)


def box_attrs(P, local_id, geom, need_uv):
    """Face normal by the largest scaled local coordinate, and the 4 x 3
    cube-cross uv (attrs.py:62); every uv term divides by the width, as
    in sightpy."""
    basis = _gather(geom.box_basis, local_id)            # (N, 3, 3)
    whl = _gather(geom.box_whl, local_id)
    M_C = P - _gather(geom.box_center, local_id)
    P_l = torch.stack([_dot(basis[:, i, :], M_C) for i in range(3)], dim=-1)
    absP = torch.abs(P_l) / whl
    Pmax = torch.amax(absP, dim=-1, keepdim=True)
    N_l = torch.where(Pmax == absP, torch.sign(P_l), 0.0)
    # local -> world: the box's axes are the basis rows
    N = (basis[:, 0, :] * N_l[..., 0:1] + basis[:, 1, :] * N_l[..., 1:2]
         + basis[:, 2, :] * N_l[..., 2:3])
    if not need_uv:
        return N, None
    w_d, h_d, l_d = P_l[..., 0], P_l[..., 1], P_l[..., 2]
    s = rdiv(2.0 * 0.985, whl[..., 0])
    faces = (N_l[..., 1] == -1.0, N_l[..., 1] == 1.0, N_l[..., 0] == 1.0,
             N_l[..., 0] == -1.0, N_l[..., 2] == 1.0, N_l[..., 2] == -1.0)
    half = lambda x: div(x * s + 1.0, 2.0)
    us = (half(w_d) + 1.0, half(w_d) + 1.0, half(l_d) + 2.0,
          half(-l_d) + 0.0, half(-w_d) + 3.0, half(w_d) + 1.0)
    vs = (half(-l_d) + 0.0, half(l_d) + 2.0, half(h_d) + 1.0,
          half(h_d) + 1.0, half(h_d) + 1.0, half(h_d) + 1.0)
    u = torch.zeros_like(w_d)
    v = torch.zeros_like(w_d)
    # jnp.select: the first true condition wins, so apply them last to first
    for f, uu, vv in reversed(list(zip(faces, us, vs))):
        u = torch.where(f, uu, u)
        v = torch.where(f, vv, v)
    return N, torch.stack([div(u, 4.0), div(v, 3.0)], dim=-1)


def disc_attrs(P, local_id, geom, need_uv):
    """Constant normal and planar uv over the bounding square
    (attrs.py:124)."""
    N = _gather(geom.disc_normal, local_id)
    if not need_uv:
        return N, None
    M_C = P - _gather(geom.disc_center, local_id)
    r = _gather(geom.disc_r_out, local_id)
    u = div(_dot(_gather(geom.disc_u_axis, local_id), M_C) / r + 1.0, 2.0)
    v = div(_dot(_gather(geom.disc_v_axis, local_id), M_C) / r + 1.0, 2.0)
    return N, torch.stack([u, v], dim=-1)


def cylinder_attrs(P, local_id, geom, need_uv):
    """Radial side normal or axial cap normal, the cap winning where
    |y| / half_h >= rho / r; uv (azimuth, height) on the side, planar on
    the caps (attrs.py:141)."""
    ax = _gather(geom.cyl_axis, local_id)
    ua = _gather(geom.cyl_u_axis, local_id)
    va = _gather(geom.cyl_v_axis, local_id)
    r = _gather(geom.cyl_radius, local_id)
    hh = _gather(geom.cyl_half_h, local_id)
    capped = _gather(geom.cyl_capped, local_id) > 0.5
    M_C = P - _gather(geom.cyl_center, local_id)
    x, y, z = _dot(ua, M_C), _dot(ax, M_C), _dot(va, M_C)
    rho = torch.sqrt(torch.clamp_min(x * x + z * z, 1e-20))
    is_cap = capped & (torch.abs(y) / hh >= rho / r)
    N_side = (x[..., None] * ua + z[..., None] * va) / rho[..., None]
    N_cap = torch.sign(y)[..., None] * ax
    N = torch.where(is_cap[..., None], N_cap, N_side)
    if not need_uv:
        return N, None
    u_side = div(torch.atan2(z, x) + math.pi, 2.0 * math.pi)
    v_side = div(y / hh + 1.0, 2.0)
    u = torch.where(is_cap, div(x / r + 1.0, 2.0), u_side)
    v = torch.where(is_cap, div(z / r + 1.0, 2.0), v_side)
    return N, torch.stack([u, v], dim=-1)


def _mat_rows(R, X):
    """R @ x for each row x of X, R (N, 3, 3)."""
    return torch.stack([_dot(R[:, j, :], X) for j in range(3)], dim=-1)


def triangle_attrs(P, local_id, geom, need_uv):
    """The face normal and (u, v) = the barycentric weights of p2, p3
    (attrs.py:175).  With corner normals and uvs (tri_vn* / tri_uv*
    non-empty) the normal is the barycentric blend of the corner normals,
    normalised, and uv the blend of the corner uvs; flat faces' corners
    reproduce the flat result.  Under MeshInstances local_id is a virtual
    id: the hit is pulled into its instance's object space, ((P - t) @ R)
    / s, for the barycentric solve, and the normal rotated back by R."""
    R = None
    if geom.tri_virt_row.shape[0]:
        row = _gather(geom.tri_virt_row, local_id)
        inst = _gather(geom.tri_virt_inst, local_id)
        R = _gather(geom.inst_rot, inst)                        # (N, 3, 3)
        Pt = P - _gather(geom.inst_trans, inst)
        inv_s = _gather(geom.inst_inv_scale, inst)
        P = torch.stack([_dot(R[:, :, j], Pt) for j in range(3)],
                        dim=-1) * inv_s[..., None]
    else:
        row = local_id

    def to_world(N_obj):
        return N_obj if R is None else _mat_rows(R, N_obj)

    N = _gather(geom.tri_normal, row)
    interp = geom.tri_vn1.shape[0] > 0
    if not (need_uv or interp):
        return to_world(N), None
    p1 = _gather(geom.tri_p1, row)
    e1 = _gather(geom.tri_p2, row) - p1
    e2 = _gather(geom.tri_p3, row) - p1
    d = P - p1
    d11, d12, d22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    dp1, dp2 = _dot(d, e1), _dot(d, e2)
    det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
    u = (d22 * dp1 - d12 * dp2) / det
    v = (d11 * dp2 - d12 * dp1) / det
    if not interp:
        return to_world(N), torch.stack([u, v], dim=-1)
    w1, w2, w3 = (1.0 - u - v)[..., None], u[..., None], v[..., None]
    Ns = (w1 * _gather(geom.tri_vn1, row) + w2 * _gather(geom.tri_vn2, row)
          + w3 * _gather(geom.tri_vn3, row))
    N = Ns / safe_norm(Ns, keepdim=True)
    if not need_uv:
        return to_world(N), None
    uv = (w1 * _gather(geom.tri_uv1, row) + w2 * _gather(geom.tri_uv2, row)
          + w3 * _gather(geom.tri_uv3, row))
    return to_world(N), uv


_ATTRS = dict(sphere=sphere_attrs, plane=plane_attrs, box=box_attrs,
              disc=disc_attrs, cyl=cylinder_attrs, tri=triangle_attrs)


def hit_attributes(P, obj_id, geom, static, force_uv=False):
    """Geometric normal (N, 3) and uv (N, 2) of each ray's object
    (attrs.py:245).  uv is zero unless the scene samples it or force_uv."""
    need_uv = static.needs_uv or force_uv
    normal = torch.zeros_like(P)
    uv = torch.zeros(P.shape[:-1] + (2,), dtype=P.dtype, device=P.device)
    off = 0
    for kind in KINDS:
        count = static.kind_counts[kind]
        if not count:
            continue
        m = (obj_id >= off) & (obj_id < off + count)
        n_t, uv_t = _ATTRS[kind](P, torch.clamp(obj_id - off, 0, count - 1),
                                 geom, need_uv)
        normal = torch.where(m[..., None], n_t, normal)
        if need_uv:
            uv = torch.where(m[..., None], uv_t, uv)
        off += count
    return normal, uv
