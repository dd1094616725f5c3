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

Scenes of TRI_CLUSTER_THRESHOLD triangles or more, and scenes with
MeshInstances, carry clusters of TRI_CLUSTER_SIZE leaf-ordered triangles
with one inflated box each (core/compile.py), and their triangles take
the two-level sweep of intersect.py:226-411: rays in tiles of RAY_TILE,
each tile's clusters visited front to back by their nearest entry, an
instance's clusters tested with the rays pulled into its object space.
Where XLA branches per (tile, cluster) pair on the device (lax.cond),
eager torch would sync per pair, so the pair search finds in one pass
every (cluster record, ray) pair whose box test the ray passes, and each
physical cluster then sweeps its pairs, all tiles and all the instances
that share it at once.  On CUDA tensors the search is the hand-written
kernel W2 (ops/mesh_pairs.py, csrc/mesh_pairs.cu: one small copy to the
host, one sync a sweep); on CPU tensors its plain version here,
`_cluster_pairs` (one nonzero and one small copy to the host: two syncs a
sweep), which W2 equals element for element.  A triangle hit lies in its
cluster's box, whose entry is conservative, so a ray that misses the
box, or enters it behind its nearest hit so far (`limit`), cannot change
the result, and leaving it out gives the JAX package's answer.  The sequential scan keeps, per
ray, the smallest t and on a tie the record first in its tile's visit
order (its strict `<`); the blocks fold into the same (t, rank) minimum,
so their order does not matter.  SWEEP_STATS counts the clustered
sweeps, their syncs, the physical clusters run and the pairs swept; each
sweep runs under the profiler range "wavefront.clustered_sweep".

The triangle sweeps, clustered and flat, go through the wrappers of
ops/mesh_sweep.py: on CUDA tensors the hand-written kernel W1
(csrc/mesh_sweep.cu), on CPU tensors the plain versions here
(`_clustered_nearest`, `_clustered_occluded`, `_flat_nearest`,
`_flat_occluded`), which W1 equals bit for bit.  W1 has no backward:
where autograd needs the hit distance, `nearest_hit` recomputes it for
each ray's winning triangle only (`winner_t`), bit-equal to W1's.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..core.safemath import rdiv, safe_sqrt
from ..utils.constants import FARAWAY, UPDOWN, UPWARDS

# elements of one (block, N) intermediate of the object sweeps
BLOCK_ELEMS = 1 << 25
# triangles a cluster, and rays a tile of the clustered sweep
# (intersect.py:238, 241)
TRI_CLUSTER_SIZE = 256
RAY_TILE = 32768
# (record, ray) pairs of one box pass: rays go in groups of whole tiles
# so that its (records, rays) mask stays within this many bools
PAIR_MASK_ELEMS = 1 << 30
# host counters of the clustered sweeps (read and reset by profilers)
SWEEP_STATS = dict(sweeps=0, syncs=0, clusters=0, pairs=0)


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


def _reduce_nearest(t, o, base, state):
    """The flat sweep's fold: winner and orientation by a max over packed
    codes of the rows at the block's minimum (intersect.py:522-530), a
    strict `<` across blocks."""
    bt, bcode = state
    tm = torch.amin(t, dim=0)
    row2 = (torch.arange(t.shape[0], dtype=torch.int64, device=t.device)
            * 2)[:, None]
    code = (base * 2 + row2) + (o < 0).to(torch.int64)
    cm = torch.amax(torch.where(t == tm[None, :], code, -1), dim=0)
    better = tm < bt
    return torch.where(better, tm, bt), torch.where(better, cm, bcode)


def _flat_nearest(O, D, geom):
    """(t, packed code) of each ray's nearest triangle over every row, in
    blocks of _tri_block_size(N) rows: code = row * 2 + (orient < 0), -1
    and FARAWAY on a miss.  The plain version of W1's flat nearest."""
    n = O.shape[0]
    return _blocked_tri_scan(
        planes(O), planes(D), geom, _reduce_nearest,
        (torch.full((n,), FARAWAY, dtype=O.dtype, device=O.device),
         torch.full((n,), -1, dtype=torch.int64, device=O.device)))


def _flat_occluded(O, D, geom, tri_mask, max_dist):
    """True where a triangle row whose tri_mask bit is set lies nearer
    than max_dist, in blocks of _tri_block_size(N) rows.  The plain
    version of W1's flat occluded."""
    n = O.shape[0]
    Op, Dp = planes(O), planes(D)
    md = max_dist[None, :]
    hit = torch.zeros((n,), dtype=torch.bool, device=O.device)
    for lo, blk in _blocks(_tri_tables(geom), geom.tri_p1.shape[0],
                           _tri_block_size(n)):
        t, _ = intersect_triangles(Op, Dp, *blk)
        m = tri_mask[lo:lo + t.shape[0]]
        hit = hit | torch.any((t < md) & m[:, None], dim=0)
    return hit


def needs_grad(O, D, geom):
    """Whether autograd records a function of the triangle sweep's t:
    grad is enabled and the rays, a triangle table or an instance table
    require it."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (O, D, *_tri_tables(geom), geom.inst_rot,
                                  geom.inst_trans, geom.inst_inv_scale))


def winner_rows(geom, code, rec=None):
    """(physical row, instance or None) of each ray's winning triangle
    (packed code; rays that missed get row 0).  rec: each ray's winning
    cluster record (W1's clustered nearest), whose first physical row,
    first virtual id and instance place the winner; None for the flat
    sweep, whose code is the row."""
    v = torch.clamp_min(code, 0) >> 1
    if rec is None:
        return v, None
    r = torch.clamp_min(rec, 0)
    row = (geom.tri_cl_start.index_select(0, r).to(torch.int64) + v
           - geom.tri_cl_virt.index_select(0, r).to(torch.int64))
    row = torch.where(code >= 0, row, 0)
    inst = (geom.tri_cl_inst.index_select(0, r).to(torch.int64)
            if geom.inst_rot.shape[0] else None)
    return row, inst


def winner_t(O, D, geom, code, row, inst=None):
    """t of each ray (N,) against its winning triangle, physical `row` in
    the object space of instance `inst` (None: world; see winner_rows),
    recomputed with intersect_triangles' operations so that autograd sees
    it: the triangle sweep's t bit for bit, with its gradient; FARAWAY
    where code < 0.  Rays that missed are given a harmless ray, so that
    their dropped t keeps a finite gradient of 0."""
    hit = code >= 0
    normal = geom.tri_normal.index_select(0, row)
    centroid = geom.tri_centroid.index_select(0, row)
    h = hit[:, None]
    Oc = torch.where(h, O, 0.0).t()
    Dc = torch.where(h, D, 1.0).t()
    if inst is not None:
        Oc, Dc = _inst_rays(geom, inst, Oc, Dc)
    n_dot_o = normal[:, 0] * Oc[0] + normal[:, 1] * Oc[1] + normal[:, 2] * Oc[2]
    n_dot_d = normal[:, 0] * Dc[0] + normal[:, 1] * Dc[1] + normal[:, 2] * Dc[2]
    ndd = torch.where(n_dot_d == 0.0, n_dot_d + 0.0001, n_dot_d)
    ndco = (normal * centroid).sum(dim=-1) - n_dot_o
    return torch.where(hit, torch.abs(ndco / ndd), FARAWAY)


def _ray_tiles(n):
    """(rays a tile, tiles) of the clustered sweep (intersect.py:245): a
    ray's tile decides its clusters' visit order."""
    R = min(RAY_TILE, ((n + 255) // 256) * 256)
    return R, -(-n // R)


def _safe_inv(d):
    """1 / d with |d| below 1e-12 replaced by +1e-12 (intersect.py:278)."""
    return rdiv(1.0, torch.where(torch.abs(d) < 1e-12, 1e-12, d))


def _cluster_entry(lo, hi, Op, Ip):
    """(C, R) conservative entry distance of R rays (origin planes Op,
    inverse-direction planes Ip, each (1, R)) into C boxes, +inf where a
    ray misses a box (intersect.py:263)."""
    tmin = tmax = None
    for a in range(3):
        t0 = (lo[:, a:a + 1] - Op[a]) * Ip[a]
        t1 = (hi[:, a:a + 1] - Op[a]) * Ip[a]
        lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
        tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
    live = (tmax >= 0) & (tmin <= tmax)
    return torch.where(live, torch.clamp_min(tmin, 0.0), float("inf"))


def _ray_groups(n, C):
    """(first ray, end, tile) of each group of whole tiles of a clustered
    sweep of n rays over C records (PAIR_MASK_ELEMS); a ray's tile is the
    JAX package's whatever its group."""
    R, nt = _ray_tiles(n)
    g = max(1, PAIR_MASK_ELEMS // (C * R)) * R
    return [(lo, min(lo + g, n), R) for lo in range(0, nt * R, g)]


def _cluster_pairs(O, D, geom, limit, R):
    """The (cluster record, ray) pairs of a clustered sweep: W2's plain
    version (ops/mesh_pairs.py).

    Rays are padded to whole tiles as in the JAX package (origin 1e30,
    direction 1: they miss every box).  A pair is kept where the ray
    enters the record's box before `limit` (per ray).  The records are
    taken grouped by their physical cluster (an instanced mesh's cluster
    serves one record an instance), so that one sweep covers every
    instance of a cluster.  Returns a dict: Op, Dp the (3, Npad) origin
    and direction planes; rays, recs the kept pairs' ray and record
    (K,), ordered by physical cluster; rank (tiles * C,) the position of
    each record in its tile's visit order, at tile * C + record; groups,
    a host list of (first row, pair range) per physical cluster that has
    pairs; R, the tile."""
    n = O.shape[0]
    nt = -(-n // R)
    Op, Dp = _pad_rays(O, D, nt * R)
    with torch.no_grad():
        # which pairs to sweep is piecewise constant in the scene's
        # parameters: autograd records none of it (diff.py)
        return _pair_search(Op, Dp, limit, geom, n, nt, R)


def _pad_rays(O, D, npad):
    """(3, npad) origin and direction planes of rays (O, D), (n, 3),
    padded as in the JAX package (origin 1e30, direction 1: they miss
    every box)."""
    n, dev = O.shape[0], O.device
    Op = torch.cat([O, torch.full((npad - n, 3), 1e30, dtype=O.dtype,
                                  device=dev)]).t().contiguous()
    Dp = torch.cat([D, torch.ones((npad - n, 3), dtype=D.dtype,
                                  device=dev)]).t().contiguous()
    return Op, Dp


def _pair_search(Op, Dp, limit, geom, n, nt, R):
    """The body of _cluster_pairs after the padding (no autograd)."""
    npad, dev = nt * R, Op.device
    lim = torch.cat([limit, torch.zeros((npad - n,), dtype=limit.dtype,
                                        device=dev)])
    C = geom.tri_cl_lo.shape[0]
    # the rows of `keep`: records grouped by their first physical row
    rec_of_row = torch.argsort(geom.tri_cl_start, stable=True)
    lo = geom.tri_cl_lo.index_select(0, rec_of_row)
    hi = geom.tri_cl_hi.index_select(0, rec_of_row)
    keep = torch.empty((C, npad), dtype=torch.bool, device=dev)
    minent = torch.empty((C, nt), dtype=Op.dtype, device=dev)
    g = max(1, BLOCK_ELEMS // (C * R))       # tiles whose boxes go at once
    for k0 in range(0, nt, g):
        k1 = min(nt, k0 + g)
        sl = slice(k0 * R, k1 * R)
        Ip = tuple(_safe_inv(Dp[a, sl])[None, :] for a in range(3))
        entry = _cluster_entry(lo, hi, tuple(Op[a, sl][None, :]
                                             for a in range(3)), Ip)
        keep[:, sl] = entry < lim[sl][None, :]
        minent[:, k0:k1] = torch.amin(entry.view(C, k1 - k0, R), dim=2)
    # front to back: each tile's records by their nearest entry over the
    # tile, ties in record order (jnp.argsort is stable)
    minent = torch.empty_like(minent).index_copy_(0, rec_of_row, minent)
    order = torch.argsort(minent.t(), dim=1, stable=True)          # (nt, C)
    steps = torch.arange(C, dtype=torch.int64, device=dev).expand(nt, C)
    rank = torch.empty_like(order).scatter_(1, order, steps).reshape(-1)
    pairs = torch.nonzero(keep)                                  # one sync
    counts = torch.bincount(pairs[:, 0], minlength=C)
    meta = torch.stack([counts, geom.tri_cl_start.index_select(
        0, rec_of_row).to(counts.dtype)]).tolist()              # one sync
    groups, off = [], 0
    for row, (cnt, start) in enumerate(zip(*meta)):
        if cnt and groups and groups[-1][0] == start:
            groups[-1][2] += cnt
        elif cnt:
            groups.append([start, off, off + cnt])
        off += cnt
    SWEEP_STATS["sweeps"] += 1
    SWEEP_STATS["syncs"] += 2
    SWEEP_STATS["pairs"] += off
    return dict(Op=Op, Dp=Dp, rays=pairs[:, 1],
                recs=rec_of_row.index_select(0, pairs[:, 0]), rank=rank,
                groups=groups, R=R)


def _cluster_blocks(geom, sw):
    """Blocks of at most BLOCK_ELEMS / TRI_CLUSTER_SIZE pairs of one
    physical cluster: (rays (kb,), records (kb,), the rays' origin and
    direction planes in each record's object space, the cluster's B
    triangle rows, each pair's first virtual id).  A ray may appear once
    per record, so more than once in a block of instances.  The last
    cluster of a region is completed by the rows after it, degenerate
    padding or real triangles, both harmless (intersect.py:302)."""
    B = TRI_CLUSTER_SIZE
    tabs = tuple(torch.cat([x, torch.zeros((B,) + x.shape[1:], dtype=x.dtype,
                                           device=x.device)])
                 for x in _tri_tables(geom))
    kb = max(1, BLOCK_ELEMS // B)
    instanced = geom.inst_rot.shape[0] > 0
    virt_all = geom.tri_cl_virt.to(torch.int64)
    for start, a, b in sw["groups"]:
        SWEEP_STATS["clusters"] += 1
        blk = tuple(x[start:start + B] for x in tabs)
        for lo in range(a, b, kb):
            r, rec = sw["rays"][lo:min(lo + kb, b)], sw["recs"][lo:min(lo + kb, b)]
            Oc, Dc = sw["Op"].index_select(1, r), sw["Dp"].index_select(1, r)
            if instanced:
                Oc, Dc = _inst_rays(geom, geom.tri_cl_inst.index_select(0, rec),
                                    Oc, Dc)
            yield (r, rec, (Oc[0:1], Oc[1:2], Oc[2:3]),
                   (Dc[0:1], Dc[1:2], Dc[2:3]), blk, virt_all.index_select(0, rec))


def _inst_rays(geom, inst, Oc, Dc):
    """(3, K) ray planes pulled into the object space of each ray's
    instance (K,), ((O - t) @ R) * (1 / s) and (D @ R) * (1 / s)
    (intersect.py:283): a rigid map with a uniform scale keeps the ray's
    t, so object-space distances compare with world ones."""
    Rm = geom.inst_rot.index_select(0, inst)                     # (K, 3, 3)
    tr = geom.inst_trans.index_select(0, inst)
    si = geom.inst_inv_scale.index_select(0, inst)
    o = [Oc[i] - tr[:, i] for i in range(3)]
    Oo = torch.stack([(o[0] * Rm[:, 0, j] + o[1] * Rm[:, 1, j]
                       + o[2] * Rm[:, 2, j]) * si for j in range(3)])
    Do = torch.stack([(Dc[0] * Rm[:, 0, j] + Dc[1] * Rm[:, 1, j]
                       + Dc[2] * Rm[:, 2, j]) * si for j in range(3)])
    return Oo, Do


def _clustered_nearest(O, D, geom, limit):
    """(t, packed code) of each ray's nearest triangle, code = virtual id
    * 2 + (orient < 0), -1 on a miss (intersect.py:317).  Triangles
    entered at or past `limit` may be left out (see the module's
    docstring): the caller's nearer hit wins there anyway."""
    parts = [_nearest_group(O[a:b], D[a:b], geom, limit[a:b], R)
             for a, b, R in _ray_groups(O.shape[0], geom.tri_cl_lo.shape[0])]
    return (torch.cat([t for t, _ in parts]),
            torch.cat([c for _, c in parts]))


def _nearest_group(O, D, geom, limit, R):
    """_clustered_nearest of one group of whole tiles of R rays.  Each
    block folds into the running best by (t, visit rank): the smaller t,
    on a tie the record first in its tile's visit order."""
    n = O.shape[0]
    sw = _cluster_pairs(O, D, geom, limit, R)
    npad, dev = sw["Op"].shape[1], O.device
    C = geom.tri_cl_lo.shape[0]
    never = torch.iinfo(torch.int64).max
    bt = torch.full((npad,), FARAWAY, dtype=O.dtype, device=dev)
    bcode = torch.full((npad,), -1, dtype=torch.int64, device=dev)
    brank = torch.full((npad,), never, dtype=torch.int64, device=dev)
    row2 = torch.arange(TRI_CLUSTER_SIZE, dtype=torch.int64, device=dev)[:, None] * 2
    for r, rec, Oc, Dc, blk, virt in _cluster_blocks(geom, sw):
        t, o = intersect_triangles(Oc, Dc, *blk)               # (B, kb)
        tm = torch.amin(t, dim=0)
        code = (virt * 2)[None, :] + row2 + (o < 0).to(torch.int64)
        cm = torch.amax(torch.where(t == tm[None, :], code, -1), dim=0)
        rk = sw["rank"].index_select(
            0, torch.div(r, sw["R"], rounding_mode="floor") * C + rec)
        new_t = bt.scatter_reduce(0, r, tm, "amin")
        tie = (tm == new_t.index_select(0, r)) & (tm < FARAWAY)
        old_rank = torch.where(bt == new_t, brank, never)
        new_rank = old_rank.scatter_reduce(0, r, torch.where(tie, rk, never),
                                           "amin")
        won = tie & (rk == new_rank.index_select(0, r))
        pair_code = torch.full_like(bcode, -1).scatter_reduce(
            0, r, torch.where(won, cm, -1), "amax")
        bcode = torch.where(pair_code >= 0, pair_code, bcode)
        bt, brank = new_t, new_rank
    return bt[:n], bcode[:n]


def _clustered_occluded(O, D, geom, tri_mask, max_dist, hit0):
    """Any shadow-casting triangle nearer than max_dist (intersect.py:370);
    tri_mask is indexed by virtual triangle id, each record's rows
    virtually contiguous from its first virtual id.  Rays already hit
    (hit0) or entering a box at or past max_dist are left out."""
    return torch.cat([
        _occluded_group(O[a:b], D[a:b], geom, tri_mask, max_dist[a:b],
                        hit0[a:b], R)
        for a, b, R in _ray_groups(O.shape[0], geom.tri_cl_lo.shape[0])])


def _occluded_group(O, D, geom, tri_mask, max_dist, hit0, R):
    """_clustered_occluded of one group of whole tiles of R rays."""
    B = TRI_CLUSTER_SIZE
    n, dev = O.shape[0], O.device
    sw = _cluster_pairs(O, D, geom, torch.where(hit0, 0.0, max_dist), R)
    pad = sw["Op"].shape[1] - n
    md = torch.cat([max_dist, torch.zeros((pad,), dtype=max_dist.dtype,
                                          device=dev)])
    mask = torch.cat([tri_mask, torch.zeros((B,), dtype=torch.bool, device=dev)])
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    hits = torch.zeros((n + pad,), dtype=torch.int32, device=dev)
    for r, _, Oc, Dc, blk, virt in _cluster_blocks(geom, sw):
        t, _ = intersect_triangles(Oc, Dc, *blk)               # (B, kb)
        m = mask[virt[None, :] + rows]                          # (B, kb)
        occ = torch.any((t < md.index_select(0, r)[None, :]) & m, dim=0)
        hits = hits.index_add(0, r, occ.to(torch.int32))
    return hit0 | (hits[:n] > 0)


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
    from ..ops import mesh_sweep

    rec = None
    if geom.tri_cl_lo.shape[0]:
        with record_function("wavefront.clustered_sweep"):
            tri_t, tri_code, rec = mesh_sweep.clustered_nearest(O, D, geom,
                                                                best_t)
    else:
        tri_t, tri_code = mesh_sweep.flat_nearest(O, D, geom)
    if O.device.type != "cpu" and needs_grad(O, D, geom):
        # W1 has no backward: its winners' t again, in plain torch
        tri_t = winner_t(O, D, geom, tri_code,
                         *winner_rows(geom, tri_code, rec))
    better = tri_t < best_t
    return (torch.where(better, tri_t, best_t),
            torch.where(better, _orient((tri_code & 1) == 0), best_o),
            torch.where(better, (tri_code >> 1) + off, best_id))


def occluded(O, D, geom, shadow_obj_mask, max_dist):
    """True where a shadow-casting object lies nearer than max_dist along
    D (intersect.py:546); shadow_obj_mask (num_objects,) bool in object-id
    order, max_dist (N,)."""
    n = O.shape[0]
    Op, Dp = planes(O), planes(D)
    md = max_dist[None, :]
    hit = torch.zeros((n,), dtype=torch.bool, device=O.device)
    off = 0
    for fn, tabs, count in _type_blocks(geom, skip_tris=True):
        for lo, blk in _blocks(tabs, count, object_block(n)):
            t, _ = fn(Op, Dp, *blk)
            m = shadow_obj_mask[off + lo:off + lo + t.shape[0]]
            hit = hit | torch.any((t < md) & m[:, None], dim=0)
        off += count
    T = geom.tri_p1.shape[0]
    if not T:
        return hit
    from ..ops import mesh_sweep

    if geom.tri_cl_lo.shape[0]:
        # the triangle part of the id space (virtual under instancing)
        # runs to the end of the mask
        with record_function("wavefront.clustered_sweep"):
            return mesh_sweep.clustered_occluded(
                O, D, geom, shadow_obj_mask[off:], max_dist, hit)
    return hit | mesh_sweep.flat_occluded(O, D, geom,
                                          shadow_obj_mask[off:off + T],
                                          max_dist)


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
