"""W1: the wavefront's triangle sweep (csrc/mesh_sweep.cu).

`geometry/intersect.py` `nearest_hit` and `occluded` sweep triangles
through the four wrappers here: the clustered sweep (a scene's cluster
records and the (record, ray) pairs of `mesh_pairs.cluster_pairs`) and
the flat sweep (every row for every ray), each for the nearest hit and
for shadow rays.  On CUDA tensors a wrapper launches W1 (a failed build
or launch raises; nothing falls back); on CPU tensors it runs W1's plain
version, intersect.py's `_clustered_nearest`, `_clustered_occluded`,
`_flat_nearest` and `_flat_occluded`, which W1 equals bit for bit.  Each
wrapper's `.launches` counts the kernels it launched.

On CUDA tensors the pairs come from W2 (ops/mesh_pairs.py), on CPU
tensors from its plain version; W1 takes them, grouped by physical
cluster, and the triangle rows as one
(T, 16) table (`row_table`: normal, n . centroid, and each edge normal
with its constant, computed with the plain version's own torch
expressions).  W1 has no backward: `nearest_hit` recomputes the winners'
t in plain torch where autograd needs it (`intersect.winner_t`), which is
why the clustered nearest also returns each ray's winning record.

The `_*_launch` functions take `lib=` (and the clustered ones
`pairs_lib=`, W2's): the tests pass the CPU stand-in's build of the
source (csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry import intersect as isect
from . import cuda_build

_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)
_PAIRS = [_V, _V, _V, _I, _V, _V, _V, _V, _V, _V, _V, _V, _L]
ENTRIES = {
    "mesh_cluster_nearest": _PAIRS + [_V, _I, _I, _V, _V, _V, _V, _V, _V, _V, _N],
    "mesh_cluster_occluded": _PAIRS + [_V, _V, _L, _V, _V, _N],
    "mesh_flat_nearest": [_V, _I, _I, _V, _V, _L, _V, _V, _V, _N],
    "mesh_flat_occluded": [_V, _I, _V, _V, _L, _V, _V, _V, _V, _N],
}
ROW = 16                  # floats a row of the table W1 reads
# W1's kernels by name, as a profile lists them
KERNELS = ("cluster_nearest_kernel", "cluster_finish_kernel",
           "cluster_occluded_kernel", "flat_nearest_kernel",
           "flat_occluded_kernel")


def _call(lib, entry, *args, entries=ENTRIES):
    """Call the entry `entry` of `lib` (the render kernels' library unless
    given), declared as `entries` says, with args and a ctypes int it sets
    to the kernels it launched; raise on a CUDA error.  Returns that
    count."""
    fn = getattr(lib or cuda_build.load_library(), entry)
    if fn.argtypes is None:
        fn.argtypes = entries[entry]
        fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return launched.value


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _check(*ts):
    """Raise unless every tensor lies on the first one's device and is
    contiguous."""
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous():
            raise ValueError("a sweep kernel's inputs must be contiguous and on "
                             "one device")


def row_table(geom, pad=0):
    """(T + pad, 16) float32: each triangle row as W1 reads it, (normal,
    n . centroid), (n31, n31 . p1), (n12, n12 . p2), (n23, n23 . p3), the
    constants by intersect_triangles' own expressions, then `pad`
    degenerate zero rows (which every ray misses, as the plain version's
    padding)."""
    with torch.no_grad():
        p1, n, c, n31, n12, n23, p2, p3 = isect._tri_tables(geom)
        rows = torch.cat([n, (n * c).sum(dim=-1)[:, None],
                          n31, (n31 * p1).sum(dim=-1)[:, None],
                          n12, (n12 * p2).sum(dim=-1)[:, None],
                          n23, (n23 * p3).sum(dim=-1)[:, None]], dim=1)
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, ROW))])
        return rows.contiguous()


def cluster_tables(geom):
    """The record and instance tables as W1 reads them: (start, virt,
    inst or None, rot, trans, inv_scale)."""
    i32 = lambda x: x.to(torch.int32).contiguous()
    f32 = lambda x: x.detach().to(torch.float32).contiguous()
    inst = i32(geom.tri_cl_inst) if geom.inst_rot.shape[0] else None
    return (i32(geom.tri_cl_start), i32(geom.tri_cl_virt), inst,
            f32(geom.inst_rot), f32(geom.inst_trans), f32(geom.inst_inv_scale))


def kept(geom, name, srcs, make):
    """make(), kept on geom as `name` while srcs are the same tensors and
    none has changed (in place included), so a render's bounces make it
    once.  The entry holds srcs, so no id in its key is reused while it
    is kept."""
    key = tuple((id(x), x._version) for x in srcs)
    old = geom.__dict__.get(name)
    if old is None or old[0] != key:
        old = (key, make(), srcs)
        object.__setattr__(geom, name, old)
    return old[1]


def scene_tables(geom):
    """(row table, record tables) of geom as W1 reads them: `row_table`
    padded by one cluster of degenerate rows (the flat sweep reads its
    first T) and `cluster_tables`, made at a geometry's first sweep and
    `kept` on it."""
    srcs = (*isect._tri_tables(geom), geom.tri_cl_start, geom.tri_cl_virt,
            geom.tri_cl_inst, geom.inst_rot, geom.inst_trans,
            geom.inst_inv_scale)
    return kept(geom, "_w1_tables", srcs,
                lambda: (row_table(geom, isect.TRI_CLUSTER_SIZE),
                         cluster_tables(geom)))


def _pair_args(sw, tables):
    """(the pair tensors, W1's pair arguments) for one group's pair search
    `sw`; the caller holds the tensors until the call, as the arguments
    are bare pointers."""
    rays, recs = sw["rays"].contiguous(), sw["recs"].contiguous()
    _check(sw["Op"], sw["Dp"], rays, recs, *(t for t in tables if t is not None))
    return (rays, recs), [_p(rays), _p(recs), rays.shape[0],
                          *(_p(t) for t in tables), _p(sw["Op"]), _p(sw["Dp"]),
                          sw["Op"].shape[1]]


def _groups(O, D, geom, limit, pairs_lib=None):
    """(first ray, end, the group's pair search) of each group of whole
    tiles of a clustered sweep (intersect.py `_ray_groups`), by
    `mesh_pairs.cluster_pairs` (W2 from pairs_lib, if given); the rays
    leave autograd here."""
    from . import mesh_pairs

    O, D, limit = O.detach(), D.detach(), limit.detach()
    for a, b, R in isect._ray_groups(O.shape[0], geom.tri_cl_lo.shape[0]):
        yield a, b, mesh_pairs.cluster_pairs(O[a:b], D[a:b], geom, limit[a:b],
                                             R, lib=pairs_lib)


def nearest_pairs(sw, rows, tables, C, lib=None):
    """W1's clustered nearest over one pair search `sw`
    (`mesh_pairs.cluster_pairs`): (t, code, winning record) of its padded
    rays; rows, tables: `scene_tables(geom)`, C: the records.  Adds its
    launches to clustered_nearest.launches."""
    dev, npad = sw["Op"].device, sw["Op"].shape[1]
    (rays, _), args = _pair_args(sw, tables)
    K = rays.shape[0]
    rank = sw["rank"].contiguous()
    keys = torch.empty((npad,), dtype=torch.int64, device=dev)
    pair_key = torch.empty((max(K, 1),), dtype=torch.int64, device=dev)
    pair_code = torch.empty_like(pair_key)
    t = torch.empty((npad,), dtype=torch.float32, device=dev)
    code = torch.empty((npad,), dtype=torch.int64, device=dev)
    rec = torch.empty_like(code)
    _check(rows, rank)
    clustered_nearest.launches += _call(
        lib, "mesh_cluster_nearest", _p(rows), *args, _p(rank), C, sw["R"],
        _p(keys), _p(pair_key), _p(pair_code), _p(t), _p(code), _p(rec),
        cuda_build.stream_of(dev))
    return t, code, rec


def occluded_pairs(sw, rows, tables, max_dist, tri_mask, lib=None):
    """W1's clustered occluded over one pair search `sw` (see
    nearest_pairs): the number of pairs of each padded ray that found an
    occluder (int32); max_dist: (padded rays,) float32.  Adds its
    launches to clustered_occluded.launches."""
    dev, npad = sw["Op"].device, sw["Op"].shape[1]
    _, args = _pair_args(sw, tables)
    hits = torch.empty((npad,), dtype=torch.int32, device=dev)
    _check(rows, max_dist, tri_mask)
    clustered_occluded.launches += _call(
        lib, "mesh_cluster_occluded", _p(rows), *args, _p(max_dist),
        _p(tri_mask), tri_mask.shape[0], _p(hits), cuda_build.stream_of(dev))
    return hits


def _cluster_nearest_launch(O, D, geom, limit, lib=None, pairs_lib=None):
    """(t, code, winning record) of each ray by W1 from `lib` over pairs
    from `pairs_lib` (see `clustered_nearest` and `_groups`)."""
    rows, tables = scene_tables(geom)
    C = geom.tri_cl_lo.shape[0]
    parts = [(b - a, nearest_pairs(sw, rows, tables, C, lib))
             for a, b, sw in _groups(O, D, geom, limit, pairs_lib)]
    if not parts:
        empty = torch.empty((0,), dtype=torch.int64, device=O.device)
        return O.new_empty((0,)), empty, empty
    return tuple(torch.cat([x[i][:n] for n, x in parts]) for i in range(3))


def _cluster_occluded_launch(O, D, geom, tri_mask, max_dist, hit0, lib=None,
                             pairs_lib=None):
    """The shadow-ray answer of W1 from `lib` over pairs from `pairs_lib`
    (see `clustered_occluded` and `_groups`)."""
    rows, tables = scene_tables(geom)
    mask = tri_mask.contiguous()
    out = []
    for a, b, sw in _groups(O, D, geom, torch.where(hit0, 0.0, max_dist),
                            pairs_lib):
        n = b - a
        md = torch.cat([max_dist[a:b].detach().to(torch.float32),
                        max_dist.new_zeros((sw["Op"].shape[1] - n,))])
        hits = occluded_pairs(sw, rows, tables, md, mask, lib)
        out.append(hit0[a:b] | (hits[:n] > 0))
    return torch.cat(out) if out else hit0.clone()


def _flat_nearest_launch(O, D, geom, lib=None):
    """(t, code) of each ray by W1's flat nearest from `lib` (see
    `flat_nearest`), with the plain sweep's tie rule for its blocks of
    `intersect._tri_block_size(N)` rows.  Adds its launches to
    flat_nearest.launches."""
    n, dev = O.shape[0], O.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    code = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return t, code
    rows = scene_tables(geom)[0]
    O, D = O.detach().contiguous(), D.detach().contiguous()
    _check(rows, O, D)
    flat_nearest.launches += _call(
        lib, "mesh_flat_nearest", _p(rows), geom.tri_p1.shape[0],
        isect._tri_block_size(n), _p(O), _p(D), n, _p(t), _p(code),
        cuda_build.stream_of(dev))
    return t, code


def _flat_occluded_launch(O, D, geom, tri_mask, max_dist, lib=None):
    """W1's flat shadow-ray answer from `lib` (see `flat_occluded`); adds
    its launches to flat_occluded.launches."""
    n, dev = O.shape[0], O.device
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    rows = scene_tables(geom)[0]
    O, D = O.detach().contiguous(), D.detach().contiguous()
    md = max_dist.detach().to(torch.float32).contiguous()
    mask = tri_mask.contiguous()
    _check(rows, O, D, md, mask)
    flat_occluded.launches += _call(
        lib, "mesh_flat_occluded", _p(rows), geom.tri_p1.shape[0], _p(O),
        _p(D), n, _p(md), _p(mask), _p(occ), cuda_build.stream_of(dev))
    return occ


def clustered_nearest(O, D, geom, limit):
    """(t, packed code, winning record) of each ray's nearest triangle in
    the clustered sweep: code = virtual id * 2 + (orient < 0), -1 and
    FARAWAY on a miss; records entered at or past `limit` may be left out
    (intersect.py `_clustered_nearest`).  The record is W1's only (-1 on
    a miss), None from the plain version, whose t autograd already
    follows."""
    if O.device.type == "cpu":
        return (*isect._clustered_nearest(O, D, geom, limit), None)
    return _cluster_nearest_launch(O, D, geom, limit)


def clustered_occluded(O, D, geom, tri_mask, max_dist, hit0):
    """hit0, or a shadow-casting triangle (tri_mask by virtual id) nearer
    than max_dist, in the clustered sweep (intersect.py
    `_clustered_occluded`)."""
    if O.device.type == "cpu":
        return isect._clustered_occluded(O, D, geom, tri_mask, max_dist, hit0)
    return _cluster_occluded_launch(O, D, geom, tri_mask, max_dist, hit0)


def flat_nearest(O, D, geom):
    """(t, packed code) of each ray's nearest triangle row, code = row * 2
    + (orient < 0), -1 and FARAWAY on a miss (intersect.py
    `_flat_nearest`)."""
    if O.device.type == "cpu":
        return isect._flat_nearest(O, D, geom)
    return _flat_nearest_launch(O, D, geom)


def flat_occluded(O, D, geom, tri_mask, max_dist):
    """True where a triangle row whose tri_mask bit is set lies nearer
    than max_dist (intersect.py `_flat_occluded`)."""
    if O.device.type == "cpu":
        return isect._flat_occluded(O, D, geom, tri_mask, max_dist)
    return _flat_occluded_launch(O, D, geom, tri_mask, max_dist)


WRAPPERS = (clustered_nearest, clustered_occluded, flat_nearest, flat_occluded)
for _w in WRAPPERS:
    _w.launches = 0


def launches():
    """W1's launches over its four wrappers."""
    return sum(w.launches for w in WRAPPERS)


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0
