"""Ray-primitive intersection on torch tensors, for the wavefront.

Counterpart of raytracer_tpu/geometry/intersect.py.  Each primitive kind
is a struct of arrays (core/compile.py GeometryTables), and one function
intersects M objects of a kind with N rays, giving (M, N) distances
(FARAWAY on a miss) and orientations (+1 entering, -1 leaving).  The
formulas are the JAX package's; every intermediate is an (M, N) plane of
one coordinate, with dot products summed x + y + z in that order, so
that the CPU and the card round alike.

Where XLA fuses a kind's sweep into one pass, eager torch materialises
every (M, N) intermediate.  `nearest_hit` and `occluded` therefore sweep
each kind in blocks of at most `object_block(N)` objects with a running
minimum, and triangles in `_tri_block_size(N)` blocks with the JAX
package's packed-code reduce.  The winner on ties is the JAX package's:
the first minimum inside a sphere / plane / box / disc / cylinder table
(argmin), the last row inside a triangle block (its max-code reduce),
and a strict `<` across blocks and kinds.

Object ids run spheres, planes, boxes, discs, cylinders, triangles.
The clustered triangle sweep (`_clustered_*`, `_inst_ray_tile`) is
ROADMAP.md item 4: the compiler refuses scenes that need it.
"""

from __future__ import annotations

import torch

from ..core.safemath import safe_sqrt
from ..utils.constants import FARAWAY, UPDOWN, UPWARDS

# elements of one (block, N) intermediate of the object sweeps
BLOCK_ELEMS = 1 << 25


def object_block(n_rays):
    """Objects per block of the analytic sweeps at n_rays rays."""
    return max(1, BLOCK_ELEMS // max(n_rays, 1))


def planes(X):
    """(x, y, z) rows (1, N) of an (N, 3) tensor, contiguous; a tuple of
    three such rows passes through."""
    if isinstance(X, tuple):
        return X
    return tuple(X[:, i].contiguous()[None, :] for i in range(3))


def _col(a, i):
    """Column i of an (M, 3) table as an (M, 1) plane."""
    return a[:, i:i + 1]


def _dot(a, X):
    """(M, 3) rows . ray planes -> (M, N)."""
    return _col(a, 0) * X[0] + _col(a, 1) * X[1] + _col(a, 2) * X[2]


def _orient(cond):
    """UPWARDS where cond, else UPDOWN, float32."""
    return torch.where(cond, float(UPWARDS), float(UPDOWN))


def intersect_spheres(O, D, center, radius):
    """Spheres (intersect.py:25): the perpendicular-distance form of the
    quadratic, which avoids b^2 - 4c's cancellation in float32 but takes
    tca = -D.oc as exact only for |D| = 1: from afar a last-bit norm error
    of D moves the hit by more than the next ray's nudge (ROADMAP.md §3)."""
    O, D = planes(O), planes(D)
    oc = [O[i] - _col(center, i) for i in range(3)]                  # (M, N)
    tca = -(D[0] * oc[0] + D[1] * oc[1] + D[2] * oc[2])
    perp = [oc[i] + tca * D[i] for i in range(3)]
    d2 = perp[0] * perp[0] + perp[1] * perp[1] + perp[2] * perp[2]
    disc = (radius * radius)[:, None] - d2
    sq = safe_sqrt(disc)
    h0 = tca - sq
    h1 = tca + sq
    h = torch.where((h0 > 0) & (h0 < h1), h0, h1)
    ndd = ((O[0] + D[0] * h - _col(center, 0)) * D[0]
           + (O[1] + D[1] * h - _col(center, 1)) * D[1]
           + (O[2] + D[2] * h - _col(center, 2)) * D[2])
    valid = (disc > 0) & (h > 0) & (ndd != 0)
    return torch.where(valid, h, FARAWAY), _orient(ndd < 0)


def intersect_planes(O, D, center, normal, u_axis, v_axis, half_w, half_h):
    """Finite rectangles (intersect.py:57)."""
    O, D = planes(O), planes(D)
    ndd = _dot(normal, D)
    ndd = torch.where(ndd == 0.0, ndd + 0.0001, ndd)
    cmo = [_col(center, i) - O[i] for i in range(3)]
    ndco = _col(normal, 0) * cmo[0] + _col(normal, 1) * cmo[1] \
        + _col(normal, 2) * cmo[2]
    t = ndco / ndd
    mc = [O[i] + D[i] * t - _col(center, i) for i in range(3)]
    u = _col(u_axis, 0) * mc[0] + _col(u_axis, 1) * mc[1] + _col(u_axis, 2) * mc[2]
    v = _col(v_axis, 0) * mc[0] + _col(v_axis, 1) * mc[1] + _col(v_axis, 2) * mc[2]
    inside = ((torch.abs(u) <= half_w[:, None]) & (torch.abs(v) <= half_h[:, None])
              & (ndco * ndd > 0))
    return torch.where(inside, torch.abs(t), FARAWAY), _orient(ndd < 0)


def intersect_boxes(O, D, basis, lb_local, rt_local):
    """Oriented boxes by the slab test in each box's basis (intersect.py:79);
    basis (M, 3, 3) has the box's axes as rows."""
    O, D = planes(O), planes(D)
    tmin = tmax = None
    for i in range(3):
        row = basis[:, i, :]
        o_l, d_l = _dot(row, O), _dot(row, D)
        frac = 1.0 / d_l
        t_lo = (_col(lb_local, i) - o_l) * frac
        t_hi = (_col(rt_local, i) - o_l) * frac
        lo, hi = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    miss = (tmax < 0) | (tmin > tmax)
    inside = tmin < 0
    t = torch.where(miss, FARAWAY, torch.where(inside, tmax, tmin))
    return t, _orient(~inside)


def intersect_discs(O, D, center, normal, r_out, r_in):
    """Discs and annuli (intersect.py:103): the rectangle test with a
    radial band."""
    O, D = planes(O), planes(D)
    ndd = _dot(normal, D)
    ndd = torch.where(ndd == 0.0, ndd + 0.0001, ndd)
    cmo = [_col(center, i) - O[i] for i in range(3)]
    ndco = _col(normal, 0) * cmo[0] + _col(normal, 1) * cmo[1] \
        + _col(normal, 2) * cmo[2]
    t = ndco / ndd
    mc = [O[i] + D[i] * t - _col(center, i) for i in range(3)]
    rho2 = mc[0] * mc[0] + mc[1] * mc[1] + mc[2] * mc[2]
    hit = ((rho2 <= (r_out * r_out)[:, None]) & (rho2 >= (r_in * r_in)[:, None])
           & (ndco * ndd > 0))
    return torch.where(hit, torch.abs(t), FARAWAY), _orient(ndd < 0)


def intersect_cylinders(O, D, center, axis, u_axis, v_axis, radius, half_h,
                        capped):
    """Finite, optionally capped cylinders (intersect.py:124), solved in
    each cylinder's frame (x along u_axis, y along the axis, z along
    v_axis); the orientation from the local normal at the winning hit."""
    O, D = planes(O), planes(D)

    def off(a):
        return (a[:, 0] * center[:, 0] + a[:, 1] * center[:, 1]
                + a[:, 2] * center[:, 2])[:, None]

    ox = _dot(u_axis, O) - off(u_axis)
    oy = _dot(axis, O) - off(axis)
    oz = _dot(v_axis, O) - off(v_axis)
    dx, dy, dz = _dot(u_axis, D), _dot(axis, D), _dot(v_axis, D)
    r2 = (radius * radius)[:, None]
    hh = half_h[:, None]
    cap_on = (capped > 0.5)[:, None]

    a = dx * dx + dz * dz
    a_s = torch.where(a < 1e-12, 1e-12, a)
    hb = ox * dx + oz * dz
    c = ox * ox + oz * oz - r2
    disc = hb * hb - a_s * c
    sq = safe_sqrt(disc)
    t0 = (-hb - sq) / a_s
    t1 = (-hb + sq) / a_s
    side_ok = disc > 0

    def side_valid(t):
        return side_ok & (t > 0) & (torch.abs(oy + dy * t) <= hh)

    dy_s = torch.where(torch.abs(dy) < 1e-12, 1e-12, dy)

    def cap(y_plane):
        t = (y_plane - oy) / dy_s
        x = ox + dx * t
        z = oz + dz * t
        return t, cap_on & (t > 0) & (x * x + z * z <= r2)

    t_top, v_top = cap(hh)
    t_bot, v_bot = cap(-hh)
    t = torch.where(side_valid(t0), t0, FARAWAY)
    t = torch.minimum(t, torch.where(side_valid(t1), t1, FARAWAY))
    t = torch.minimum(t, torch.where(v_top, t_top, FARAWAY))
    t = torch.minimum(t, torch.where(v_bot, t_bot, FARAWAY))

    x = ox + dx * t
    y = oy + dy * t
    z = oz + dz * t
    rho_hat = safe_sqrt((x * x + z * z) / r2)
    is_cap = cap_on & (torch.abs(y) / hh >= rho_hat)
    nd = torch.where(is_cap, torch.sign(y) * dy, x * dx + z * dz)
    return t, _orient(nd < 0)


def intersect_triangles(O, D, p1, normal, centroid, n31, n12, n23, p2, p3):
    """Triangles by edge-normal inside tests (intersect.py:187), each test
    n . (O + t D - p) expanded to (n . O - n . p) + t (n . D)."""
    O, D = planes(O), planes(D)
    n_dot_o, n_dot_d = _dot(normal, O), _dot(normal, D)
    ndd = torch.where(n_dot_d == 0.0, n_dot_d + 0.0001, n_dot_d)
    nc = (normal * centroid).sum(dim=-1)[:, None]
    ndco = nc - n_dot_o
    t = ndco / ndd

    def edge_ok(n_edge, p_anchor):
        e = (n_edge * p_anchor).sum(dim=-1)[:, None]
        return (_dot(n_edge, O) - e) + t * _dot(n_edge, D) >= 0

    inside = (edge_ok(n31, p1) & edge_ok(n12, p2) & edge_ok(n23, p3)
              & (ndco * ndd > 0))
    return torch.where(inside, torch.abs(t), FARAWAY), _orient(ndd < 0)


def _tri_tables(geom):
    return (geom.tri_p1, geom.tri_normal, geom.tri_centroid, geom.tri_n31,
            geom.tri_n12, geom.tri_n23, geom.tri_p2, geom.tri_p3)


def _tri_block_size(n_rays):
    """Triangles per block of the sweep (intersect.py:410)."""
    return max(128, min(2048, ((1 << 26) // max(n_rays, 1)) & ~7))


def _blocked_tri_scan(O, D, geom, body_reduce, state):
    """Fold body_reduce((t, o, base), state) over triangle blocks
    (intersect.py:421).  The JAX package pads the last block with
    degenerate rows that always miss; a shorter last block is the same."""
    tabs = _tri_tables(geom)
    T = tabs[0].shape[0]
    B = _tri_block_size(O[0].shape[-1])
    for base in range(0, T, B):
        t, o = intersect_triangles(O, D, *(x[base:base + B] for x in tabs))
        state = body_reduce(t, o, base, state)
    return state


def _type_blocks(geom, skip_tris=False):
    """(intersector, tables, count) per present kind, in object-id order
    (intersect.py:444); an intersector takes (O, D, *tables)."""
    kinds = [
        (intersect_spheres, (geom.sphere_center, geom.sphere_radius)),
        (intersect_planes, (geom.plane_center, geom.plane_normal,
                            geom.plane_u_axis, geom.plane_v_axis,
                            geom.plane_half_w, geom.plane_half_h)),
        (intersect_boxes, (geom.box_basis, geom.box_lb_local,
                           geom.box_rt_local)),
        (intersect_discs, (geom.disc_center, geom.disc_normal,
                           geom.disc_r_out, geom.disc_r_in)),
        (intersect_cylinders, (geom.cyl_center, geom.cyl_axis,
                               geom.cyl_u_axis, geom.cyl_v_axis,
                               geom.cyl_radius, geom.cyl_half_h,
                               geom.cyl_capped)),
    ]
    if not skip_tris:
        kinds.append((intersect_triangles, _tri_tables(geom)))
    return [(fn, tabs, tabs[0].shape[0]) for fn, tabs in kinds
            if tabs[0].shape[0]]


def _blocks(tabs, count, B):
    """(first object, table slices) of each block of B objects of a kind."""
    for lo in range(0, count, B):
        yield lo, tuple(x[lo:lo + B] for x in tabs)


def nearest_hit(O, D, geom):
    """(t, orient, obj_id) of the nearest hit of each ray, each (N,);
    obj_id int64, 0 on a miss (intersect.py:480)."""
    n = O.shape[0]
    Op, Dp = planes(O), planes(D)
    best_t = torch.full((n,), FARAWAY, dtype=O.dtype, device=O.device)
    best_o = torch.ones((n,), dtype=O.dtype, device=O.device)
    best_id = torch.zeros((n,), dtype=torch.int64, device=O.device)
    off = 0
    for fn, tabs, count in _type_blocks(geom, skip_tris=True):
        for lo, blk in _blocks(tabs, count, object_block(n)):
            t, o = fn(Op, Dp, *blk)                       # (B, N)
            tm, am = torch.min(t, dim=0)                  # first minimum
            om = torch.gather(o, 0, am[None, :])[0]
            better = tm < best_t
            best_t = torch.where(better, tm, best_t)
            best_o = torch.where(better, om, best_o)
            best_id = torch.where(better, am + (off + lo), best_id)
        off += count
    if not geom.tri_p1.shape[0]:
        return best_t, best_o, best_id

    def reduce_nearest(t, o, base, state):
        # winner and orientation by a max over packed codes of the rows at
        # the minimum (intersect.py:522-530)
        bt, bcode = state
        tm = torch.amin(t, dim=0)
        row2 = (torch.arange(t.shape[0], dtype=torch.int64, device=t.device)
                * 2)[:, None]
        code = (base * 2 + row2) + (o < 0).to(torch.int64)
        cm = torch.amax(torch.where(t == tm[None, :], code, -1), dim=0)
        better = tm < bt
        return torch.where(better, tm, bt), torch.where(better, cm, bcode)

    tri_t, tri_code = _blocked_tri_scan(
        Op, Dp, geom, reduce_nearest,
        (torch.full_like(best_t, FARAWAY), torch.full_like(best_id, -1)))
    better = tri_t < best_t
    tri_o = _orient((tri_code & 1) == 0)
    best_t = torch.where(better, tri_t, best_t)
    best_o = torch.where(better, tri_o, best_o)
    best_id = torch.where(better, (tri_code >> 1) + off, best_id)
    return best_t, best_o, best_id


def occluded(O, D, geom, shadow_obj_mask, max_dist):
    """True where a shadow-casting object lies nearer than max_dist along
    D (intersect.py:546); shadow_obj_mask (num_objects,) bool in object-id
    order, max_dist (N,)."""
    n = O.shape[0]
    Op, Dp = planes(O), planes(D)
    md = max_dist[None, :]
    hit = torch.zeros((n,), dtype=torch.bool, device=O.device)
    off = 0
    for fn, tabs, count in _type_blocks(geom):
        B = _tri_block_size(n) if fn is intersect_triangles else object_block(n)
        for lo, blk in _blocks(tabs, count, B):
            t, _ = fn(Op, Dp, *blk)
            m = shadow_obj_mask[off + lo:off + lo + t.shape[0]]
            hit = hit | torch.any((t < md) & m[:, None], dim=0)
        off += count
    return hit


def intersect_all(O, D, geom):
    """(t, orient), each (num_objects, N), every object against every ray,
    rows in object-id order (intersect.py:581); one (1, N) row of misses
    for an empty scene."""
    parts = [fn(O, D, *tabs) for fn, tabs, _ in _type_blocks(geom)]
    if not parts:
        n = O.shape[0]
        return (torch.full((1, n), FARAWAY, dtype=O.dtype, device=O.device),
                torch.ones((1, n), dtype=O.dtype, device=O.device))
    return (torch.cat([t for t, _ in parts]), torch.cat([o for _, o in parts]))
