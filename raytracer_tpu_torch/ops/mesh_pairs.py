"""W2: the clustered sweep's pair search (csrc/mesh_pairs.cu).

W1's clustered entries (ops/mesh_sweep.py) sweep the (cluster record,
ray) pairs of one group of whole tiles of rays, with each tile's visit
ranks; `cluster_pairs` makes them.  On CUDA tensors it launches W2 (a
failed build or launch raises; nothing falls back) and copies one small
tensor to the host, the pair count and the physical clusters that have
pairs: one host sync a sweep.  On CPU tensors it runs W2's plain version,
`geometry/intersect.py` `_cluster_pairs` (its nonzero and its `tolist`:
two syncs), whose rays, records, ranks and counts W2 equals element for
element.  `cluster_pairs.launches` counts the kernels W2 launched.

The record boxes W2 reads, in the plain version's row order (the
records sorted stably by their first physical row), are made once per
geometry (`pair_tables`).  The `_*` functions take `lib=`: the tests pass
the CPU stand-in's build of the source (csrc/emu) with CPU tensors;
chip_smoke.py times `_search` and `_write` apart, as the one host sync
lies between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry import intersect as isect
from . import cuda_build, mesh_sweep
from .mesh_sweep import _check, _p

_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)
ENTRIES = {
    "mesh_pairs_search": [_V, _V, _V, _I, _V, _V, _V, _L, _I, _V, _V, _V, _V,
                          _V, _V, _V, _N],
    "mesh_pairs_write": [_V, _V, _I, _L, _V, _V, _V, _V, _N],
}
BLOCK = 256               # rays a block of the count and write launches
SCAN_SEG = 4096           # counts a block of the scan takes
# (record, ray) slots of one search at most: the pair count and every
# slot are int32 in W2 and W1 (`intersect._ray_groups` keeps a group
# within this wherever one tile of rays fits)
PAIR_SLOTS = 1 << 30
# W2's kernels by name, as a profile lists them
KERNELS = ("pair_count_kernel", "scan_reduce_kernel", "scan_top_kernel",
           "scan_apply_kernel", "pair_rank_kernel", "pair_write_kernel")


def pair_tables(geom):
    """(boxes (C, 6) float32: each record's lo and hi, rec_of_row (C,)
    int32, start_of_row (C,) int32) in the plain search's row order, the
    records sorted stably by their first physical row; kept on geom as
    `mesh_sweep.scene_tables` are."""
    def make():
        with torch.no_grad():
            rec_of_row = torch.argsort(geom.tri_cl_start, stable=True)
            boxes = torch.cat([geom.tri_cl_lo, geom.tri_cl_hi], dim=1)
            return (boxes.index_select(0, rec_of_row).to(torch.float32).contiguous(),
                    rec_of_row.to(torch.int32).contiguous(),
                    geom.tri_cl_start.index_select(0, rec_of_row)
                    .to(torch.int32).contiguous())

    return mesh_sweep.kept(geom, "_w2_tables", (geom.tri_cl_lo, geom.tri_cl_hi,
                                                geom.tri_cl_start), make)


def _prepare(O, D, geom, limit, R):
    """The inputs and buffers of one search of rays (O, D) under `limit`
    in tiles of R: the padded planes Op, Dp (as `_cluster_pairs` pads
    them) and limit, the tables, scratch (the ballots of each record row
    and warp of rays: C * npad / 8 bytes), rank and the (K, clusters)
    stats."""
    if any(x.dtype != torch.float32 for x in (O, D, limit)):
        raise TypeError("W2 takes float32 rays and limits")
    n, dev = O.shape[0], O.device
    nt = -(-n // R)
    npad = nt * R
    tables = pair_tables(geom)
    C = tables[0].shape[0]
    if R % BLOCK or C * npad > PAIR_SLOTS:
        raise ValueError(f"W2 takes tiles of a multiple of {BLOCK} rays and at "
                         f"most {PAIR_SLOTS} (record, ray) slots: {C} records "
                         f"x {npad} rays")
    with torch.no_grad():
        Op, Dp = isect._pad_rays(O, D, npad)
        lim = torch.cat([limit, limit.new_zeros((npad - n,))])
    n_counts = C * (npad // BLOCK)
    i32 = dict(dtype=torch.int32, device=dev)
    sw = dict(Op=Op, Dp=Dp, lim=lim, R=R, C=C, tables=tables,
              counts=torch.empty((n_counts,), **i32),
              sums=torch.empty((-(-n_counts // SCAN_SEG),), **i32),
              minent=torch.empty((nt * C,), **i32),
              ballots=torch.empty((C * (npad // 32),), **i32),
              rank=torch.empty((nt * C,), dtype=torch.int64, device=dev),
              stats=torch.empty((2,), **i32))
    _check(Op, Dp, lim, *tables, sw["counts"], sw["ballots"], sw["rank"])
    return sw


def _search(sw, lib=None):
    """Launch W2's count, scan and rank on a `_prepare`d search: sw's
    counts then hold each (row, block)'s first slot, ballots the kept
    lanes, rank the visit ranks, stats (K, clusters).  Adds its launches
    to cluster_pairs.launches."""
    boxes, rec_of_row, start_of_row = sw["tables"]
    cluster_pairs.launches += mesh_sweep._call(
        lib, "mesh_pairs_search", _p(boxes), _p(rec_of_row), _p(start_of_row),
        sw["C"], _p(sw["Op"]), _p(sw["Dp"]), _p(sw["lim"]), sw["Op"].shape[1],
        sw["R"], _p(sw["counts"]), _p(sw["sums"]), _p(sw["minent"]),
        _p(sw["ballots"]), _p(sw["rank"]), _p(sw["stats"]),
        cuda_build.stream_of(sw["Op"].device), entries=ENTRIES)


def _write(sw, lib=None):
    """Launch W2's write of the pairs into sw's rays and recs (K > 0),
    after `_search`."""
    cluster_pairs.launches += mesh_sweep._call(
        lib, "mesh_pairs_write", _p(sw["ballots"]), _p(sw["tables"][1]),
        sw["C"], sw["Op"].shape[1], _p(sw["counts"]), _p(sw["rays"]),
        _p(sw["recs"]), cuda_build.stream_of(sw["Op"].device), entries=ENTRIES)


def _pairs_launch(O, D, geom, limit, R, lib=None):
    """W2 from `lib` (see `cluster_pairs`)."""
    sw = _prepare(O, D, geom, limit, R)
    _search(sw, lib)
    K, clusters = sw["stats"].tolist()                 # the one host sync
    sw["rays"] = torch.empty((K,), dtype=torch.int64, device=O.device)
    sw["recs"] = torch.empty_like(sw["rays"])
    if K:
        _write(sw, lib)
    for key in ("counts", "sums", "minent", "ballots", "stats"):
        del sw[key]                     # free the scratch before W1 runs
    sw["clusters"] = clusters
    isect.SWEEP_STATS["sweeps"] += 1
    isect.SWEEP_STATS["syncs"] += 1
    isect.SWEEP_STATS["pairs"] += K
    isect.SWEEP_STATS["clusters"] += clusters
    return sw


def cluster_pairs(O, D, geom, limit, R, lib=None):
    """The (cluster record, ray) pairs of a clustered sweep of rays (O, D),
    (n, 3), one group of whole tiles of R rays (`intersect._ray_groups`),
    as `intersect._cluster_pairs` gives them (Op, Dp, rays, recs, rank,
    R), with "clusters", the physical clusters that have pairs (added to
    SWEEP_STATS with the search's own counts).  W2 on CUDA tensors, or
    with `lib`; the plain search on CPU tensors without one."""
    if O.device.type == "cpu" and lib is None:
        sw = isect._cluster_pairs(O, D, geom, limit, R)
        sw["clusters"] = len(sw["groups"])
        isect.SWEEP_STATS["clusters"] += sw["clusters"]
        return sw
    return _pairs_launch(O, D, geom, limit, R, lib)


cluster_pairs.launches = 0
