"""P3 and P4: ray x triangle nearest hit, blocked, warp-parallel, looped
and unrolled.

Counterparts of scripts/probe_pairwise.py (`run` :104, pallas_call :130),
scripts/probe_pairwise2.py (`run` :97, pallas_call :120) and
scripts/probe_mesh_sweep.py (`run` :83, pallas_call :87); kernels in
csrc/probe_tri.cu.  The scripts' triangles and rays (np.random.
default_rng(0)) and their arithmetic: ndd == 0 -> + 1e-4, the hit needs
ndco * ndd > 0, t = |tt|, the first triangle to reach the least t wins,
the id kept as float32.

    python -m raytracer_tpu_torch.probes.tri_sweep
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from . import common

FARAWAY = 1.0e30
ROWS = 128                       # ray rows of the scripts' (ROWS, 128) tiles
TB = 128                         # triangles per parameter block
SOURCE = "probe_tri.cu"


def tri_params(p1, p2, p3):
    """(T, 24) parameters [p1 p2 p3 n cen n31 n12 n23] of the triangles
    with corners p1, p2, p3 (T, 3) (probe_pairwise.py:109-118)."""
    n = np.cross(p2 - p1, p3 - p1)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    cen = (p1 + p2 + p3) / 3
    n31 = np.cross(p3 - p1, n)
    n12 = np.cross(p1 - p2, n)
    n23 = np.cross(p2 - p3, n)
    return np.concatenate([p1, p2, p3, n, cen, n31, n12, n23], axis=1)


def _blocks(params):
    """(T, 24) parameters as the (T/128, 24, 128) float32 mesh."""
    return np.ascontiguousarray(
        params.reshape(-1, TB, 24).transpose(0, 2, 1)).astype(np.float32)


def pairwise_inputs(T=5120, n_rays=ROWS * 128):
    """(mesh (T/128, 24, 128), o (3, n), d (3, n)) float32 of
    probe_pairwise.py:105-128: triangles in a box in front of rays from
    the origin."""
    rng = np.random.default_rng(0)
    Tpad = -(-T // 128) * 128
    p1 = rng.random((Tpad, 3), np.float32) * 2 - 1 + [0, 0, -4]
    p2 = p1 + rng.random((Tpad, 3), np.float32) * 0.4
    p3 = p1 + rng.random((Tpad, 3), np.float32) * 0.4
    mesh = _blocks(tri_params(p1, p2, p3))
    o = np.zeros((3, n_rays), np.float32)
    d = rng.standard_normal((3, n_rays)).astype(np.float32)
    d[2] -= 2.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return mesh, o, d


AIMED, MISSES = 8, 16        # edge_inputs' rays at triangle 0 / pointing away
# mesh blocks, rays of the edge input on the card: 41 is prime, so the
# plan's slices of several blocks cut it unevenly, and 16,000 rays (off
# the ray tiles) leave tri_thread's plan more than one block a slice
EDGE_SHAPE = (41, 16000)


def edge_inputs(n_blocks=EDGE_SHAPE[0], n_rays=EDGE_SHAPE[1]):
    """pairwise_inputs with P3's edge cases: triangle 0 moved in front of
    the others and copied into triangle 1 (a tie inside a lane of
    tri_warp) and into the last triangle (a tie across any split of the
    mesh), so the lowest id must win; the first AIMED rays aimed at
    points inside it; the last MISSES rays pointing away from every
    triangle ((FARAWAY, -1), zero normal).  Take n_rays off the multiples
    of the kernels' ray tiles (512, 128) and n_blocks off the multiples
    of their slices."""
    mesh, o, d = pairwise_inputs(n_blocks * TB, n_rays)
    prm = mesh.transpose(0, 2, 1).reshape(-1, 24)
    p = prm[0, :9].reshape(1, 3, 3) + np.float32([0, 0, 2.5])
    prm[0] = prm[1] = prm[-1] = tri_params(p[:, 0], p[:, 1], p[:, 2])[0]
    w = np.random.default_rng(1).dirichlet((4, 4, 4), AIMED).astype(np.float32)
    aim = w @ prm[0, :9].reshape(3, 3)
    d[:, :AIMED] = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).T
    away = np.random.default_rng(2).standard_normal((3, MISSES)).astype(np.float32) * 0.1
    away[2] = 1.0
    d[:, -MISSES:] = away / np.linalg.norm(away, axis=0, keepdims=True)
    return _blocks(prm), o, d


def edge_cases_hold(out):
    """True if (t, id, n) of edge_inputs shows its cases: the aimed rays
    on triangle 0 (not a copy), the rays pointing away on nothing."""
    t, tid, nrm = out
    return (bool((tid[:AIMED] == 0).all()) and bool((tid[-MISSES:] == -1).all())
            and bool((t[-MISSES:] == FARAWAY).all())
            and bool((nrm[:, -MISSES:] == 0).all()))


def ragged(plan, n_blocks):
    """True if the plan (ray groups, slices, mesh blocks a slice) cuts
    n_blocks into several slices whose last one is short."""
    _, slices, per = plan
    return slices > 1 and slices * per > n_blocks


def sweep_inputs(T=512, tile=ROWS * 128):
    """(mesh (T, 15), o (3, tile), d (3, tile)) of probe_mesh_sweep.py:84-86:
    random rows, rays from the origin along (1, 1, 1)."""
    mesh = np.random.default_rng(0).random((T, 15)).astype(np.float32)
    return mesh, np.zeros((3, tile), np.float32), np.ones((3, tile), np.float32)


def pairwise_reference(mesh, o, d):
    """The plain version of P3: (t (n,), id (n,) float32, n (3, n)): per
    block of 128 triangles every (ray, triangle) pair, the block's least t
    and its first triangle, kept where strictly less than the blocks
    before (probe_pairwise.py:44-92)."""
    dev, f32 = mesh.device, torch.float32
    k = lambda v: torch.tensor(v, dtype=f32, device=dev)
    n_rays = o.shape[1]
    ox, oy, oz = (o[c][:, None] for c in range(3))
    dx, dy, dz = (d[c][:, None] for c in range(3))
    best_t = torch.full((n_rays,), FARAWAY, dtype=f32, device=dev)
    best_i = torch.full((n_rays,), -1.0, dtype=f32, device=dev)
    nrm = torch.zeros((3, n_rays), dtype=f32, device=dev)
    for b in range(mesh.shape[0]):
        col = lambda j: mesh[b, j][None, :]
        ndd = col(9) * dx + col(10) * dy + col(11) * dz
        ndd = torch.where(ndd == 0.0, ndd + k(1e-4), ndd)
        ndco = (col(9) * (col(12) - ox) + col(10) * (col(13) - oy)
                + col(11) * (col(14) - oz))
        tt = ndco / ndd
        mx, my, mz = ox + dx * tt, oy + dy * tt, oz + dz * tt
        inside = ((col(15) * (mx - col(0)) + col(16) * (my - col(1))
                   + col(17) * (mz - col(2)) >= 0)
                  & (col(18) * (mx - col(3)) + col(19) * (my - col(4))
                     + col(20) * (mz - col(5)) >= 0)
                  & (col(21) * (mx - col(6)) + col(22) * (my - col(7))
                     + col(23) * (mz - col(8)) >= 0)
                  & (ndco * ndd > 0))
        t = torch.where(inside, tt.abs(), k(FARAWAY))
        tmin, first = t.min(dim=1)          # min returns the first index
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, (first + b * TB).to(f32), best_i)
        for c in range(3):
            nrm[c] = torch.where(better, mesh[b, 9 + c][first], nrm[c])
    return best_t, best_i, nrm


def sweep_reference(mesh, o, d, grid):
    """The plain version of P4: (grid, 3, tile) float32, each grid step
    [t + orient, nx + ny + nz, id] of the nearest row (strict <, rows in
    order) for every ray of the tile (probe_mesh_sweep.py:31-78)."""
    dev, f32 = mesh.device, torch.float32
    tile = o.shape[1]
    ox, oy, oz = o
    dx, dy, dz = d
    k = lambda v: torch.tensor(v, dtype=f32, device=dev)
    bt = torch.full((tile,), FARAWAY, dtype=f32, device=dev)
    bo = torch.ones(tile, dtype=f32, device=dev)
    bid = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    nx = ny = nz = torch.zeros(tile, dtype=f32, device=dev)
    for i in range(mesh.shape[0]):
        g = mesh[i]
        ndd = g[9] * dx + g[10] * dy + g[11] * dz
        ndd = torch.where(ndd == 0.0, ndd + k(1e-4), ndd)
        ndco = g[9] * (g[12] - ox) + g[10] * (g[13] - oy) + g[11] * (g[14] - oz)
        tt = ndco / ndd
        t_i = torch.where(ndco * ndd > 0, tt.abs(), k(FARAWAY))
        o_i = torch.where(ndd < 0, k(1.0), k(-1.0))
        m = t_i < bt
        bt, bo = torch.where(m, t_i, bt), torch.where(m, o_i, bo)
        bid = torch.where(m, i, bid)
        nx, ny, nz = (torch.where(m, g[j], v) for j, v in ((9, nx), (10, ny), (11, nz)))
    out = torch.stack([bt + bo, nx + ny + nz, bid.to(f32)])
    return out[None].expand(grid, 3, tile).contiguous()


_V, _I = ctypes.c_void_p, ctypes.c_int


def _check(*ts):
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != ts[0].device:
            raise ValueError("inputs must be contiguous float32 on one device")


def nearest(mesh, o, d, warp=False):
    """P3: (t, id, n) of every ray's nearest triangle: for CUDA tensors the
    kernels (rays in threads, 4 a thread, or with warp=True triangles in
    lanes, 4 a lane, over ray x triangle-slice blocks that fill the card;
    then the merge), for CPU tensors the plain version.
    `nearest.launches` counts kernel launches (two a call)."""
    if mesh.device.type == "cpu":
        return pairwise_reference(mesh, o, d)
    common.require_card()
    return _nearest_launch(mesh, o, d, warp)[0]


def _nearest_launch(mesh, o, d, warp, lib=None):
    """Launch P3's sweep and merge from `lib` (the probes' library unless
    given; the tests pass the CPU stand-in's build, csrc/emu, with CPU
    tensors) and add the launches it reports to `nearest.launches`;
    returns ((t, id, n), (ray groups, slices, mesh blocks a slice)), the
    grid that probe_tri_launch planned."""
    _check(mesh, o, d)
    if mesh.dim() != 3 or mesh.shape[1:] != (24, TB) or o.shape != d.shape:
        raise ValueError("mesh must be (blocks, 24, 128), o and d (3, n)")
    if mesh.data_ptr() % 16:
        raise ValueError("mesh must be 16-byte aligned")
    n, dev = o.shape[1], o.device
    keys = torch.empty((mesh.shape[0], n), dtype=torch.int64, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tid, nrm = torch.empty_like(t), torch.empty((3, n), dtype=torch.float32, device=dev)
    info = (_I * 4)()
    common.launch("probe_tri_launch",
                  [_I, _V, _I, _V, _V, _I, _V, _V, _V, _V, _V, ctypes.POINTER(_I)],
                  int(warp), common.ptr(mesh), mesh.shape[0], common.ptr(o),
                  common.ptr(d), n, common.ptr(keys), common.ptr(t), common.ptr(tid),
                  common.ptr(nrm), common.stream(o), info, lib=lib)
    nearest.launches += info[3]
    return (t, tid, nrm), tuple(info[:3])


def sweep(mesh, o, d, grid, unrolled=False):
    """P4: the (grid, 3, tile) sweep output: the kernel (run-time loop, or
    unrolled for 64 or 512 rows) for CUDA tensors, the plain version for
    CPU tensors.  `sweep.launches` counts kernel launches."""
    if mesh.device.type == "cpu":
        return sweep_reference(mesh, o, d, grid)
    common.require_card()
    return _sweep_launch(mesh, o, d, grid, unrolled)


def _sweep_launch(mesh, o, d, grid, unrolled, lib=None):
    """Launch P4's kernel from `lib` (as _nearest_launch) and count it in
    `sweep.launches`."""
    _check(mesh, o, d)
    tile = o.shape[1]
    out = torch.empty((grid, 3, tile), dtype=torch.float32, device=o.device)
    common.launch("probe_sweep_launch", [_I, _V, _I, _V, _V, _I, _I, _V, _V],
                  int(unrolled), common.ptr(mesh), mesh.shape[0], common.ptr(o),
                  common.ptr(d), tile, grid, common.ptr(out), common.stream(o), lib=lib)
    sweep.launches += 1
    return out


nearest.launches = 0
sweep.launches = 0


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# single-slot operations of one test besides its division (csrc/probe_tri.cu
# tri_t with the running-best update; sweep_row)
PAIR_SLOTS, ROW_SLOTS = 58, 28


def run(div_slots=1.0, reps=20):
    """P3 and P4 at the scripts' sizes (and P3 at 16x the rays, where the
    rays alone fill the card, and on edge_inputs, whose planned split must
    cut its mesh unevenly); each kernel held bit for bit against its plain
    version.  div_slots: the slot cost of a division (P1), for the bound.
    Returns (result dict, kernels-line rows)."""
    dev = common.require_card()
    out = {"probe": "tri_sweep", **common.device_info()}
    rows = []
    # ---- P3: 16,384 rays x 5,120 triangles ----
    sizes = {"script": ROWS * 128, "filled": 16 * ROWS * 128}
    edge = [torch.from_numpy(a).to(dev) for a in edge_inputs()]
    edge_ref = pairwise_reference(*edge)
    if not edge_cases_hold(edge_ref):
        raise RuntimeError("P3: the edge input's plain version lost its cases")
    for warp, name in ((False, "thread"), (True, "warp")):
        k_out, plan = _nearest_launch(*edge, warp)
        torch.cuda.synchronize()
        if not _equal(k_out, edge_ref):
            raise RuntimeError(f"P3 {name}: kernel and plain version differ on the "
                               "edge input")
        if not ragged(plan, edge[0].shape[0]):
            raise RuntimeError(f"P3 {name}: the edge input's plan {plan} does not "
                               "cut its mesh unevenly")
        res = {"edge": {"rays": edge[1].shape[1], "triangles": edge[0].shape[0] * TB,
                        "plan": plan}}
        for size, n_rays in sizes.items():
            mesh, o, d = (torch.from_numpy(a).to(dev)
                          for a in pairwise_inputs(5120, n_rays))
            before = nearest.launches
            k_out, plan = _nearest_launch(mesh, o, d, warp)
            per_call = nearest.launches - before
            p_out = pairwise_reference(mesh, o, d)
            torch.cuda.synchronize()
            if not _equal(k_out, p_out):
                raise RuntimeError(f"P3 {name}: kernel and plain version differ")
            tests = n_rays * mesh.shape[0] * TB
            slots = tests * (PAIR_SLOTS + div_slots)
            n_bytes = 4 * (mesh.numel() + o.numel() + d.numel()) + 4 * 5 * n_rays
            if size == "script":
                hits = int((k_out[1] >= 0).sum())
                nearest.launches = 0
            ms = common.cuda_ms(lambda: nearest(mesh, o, d, warp), reps)
            bound_ms, _ = common.bound(slots, n_bytes)
            res[size] = {"rays": n_rays, "triangles": mesh.shape[0] * TB,
                         "plan": plan, "launches_per_call": per_call,
                         "ms": ms, "gtri_tests_per_s": tests / (ms * 1e-3) / 1e9,
                         "bound_ms": bound_ms, "share": bound_ms / ms}
            if size == "script":
                launches = nearest.launches
                plain_ms = common.cuda_ms(lambda: pairwise_reference(mesh, o, d), 1, 0)
                rows.append(common.row(
                    f"tri_{name}", SOURCE,
                    "scripts/probe_pairwise.py:130" if not warp
                    else "scripts/probe_pairwise2.py:120",
                    launches, 0.0, ms, plain_ms, slots, n_bytes))
        res["hits"] = hits
        out[f"p3_{name}"] = res
    # ---- P4: 512 rows, 8 x 16,384 rays, looped and unrolled ----
    mesh, o, d = (torch.from_numpy(a).to(dev) for a in sweep_inputs(512))
    grid = 8
    ref = sweep_reference(mesh, o, d, grid)
    for unrolled, name in ((False, "loop"), (True, "unrolled")):
        k_out = sweep(mesh, o, d, grid, unrolled)
        torch.cuda.synchronize()
        if not torch.equal(k_out, ref):
            raise RuntimeError(f"P4 {name}: kernel and plain version differ")
        sweep.launches = 0
        ms = common.cuda_ms(lambda: sweep(mesh, o, d, grid, unrolled), reps)
        tests = grid * o.shape[1] * mesh.shape[0]
        out[f"p4_{name}"] = {"ms": ms, "gtri_tests_per_s": tests / (ms * 1e-3) / 1e9}
        plain_ms = common.cuda_ms(lambda: sweep_reference(mesh, o, d, grid), 1, 0)
        rows.append(common.row(
            f"sweep_{name}", SOURCE, "scripts/probe_mesh_sweep.py:87",
            sweep.launches, 0.0, ms, plain_ms,
            tests * (ROW_SLOTS + div_slots), 4 * (mesh.numel() + o.numel() + d.numel() + ref.numel())))
    out["clocks_after"] = common.clocks()
    return out, rows


def main():
    out, rows = run()
    out["kernels"] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main()
