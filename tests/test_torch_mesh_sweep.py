"""The wavefront's triangle sweep around W1 (ops/mesh_sweep.py,
csrc/mesh_sweep.cu), without JAX.

On the CPU: the four wrappers take their plain versions for CPU tensors
and launch nothing; `intersect.winner_t`, the recompute that carries
autograd past W1 (which has no backward), gives each ray's t against its
winning triangle bit for bit as the plain sweep does, and the same
gradient with respect to the rays and the triangle and instance tables
(within 1e-6), on the clustered icosphere, a field of scaled instances
and a flat icosphere (examples/torch_mesh.py at 16x12).  `sweep_geom`,
the synthetic scene of the edge cases, is shared with
tests/test_torch_mesh_sweep_emu.py.

On the card (`cuda`-marked, skipped here):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_sweep.py

holds W1 against its plain versions bit for bit on the same scenes and on
the edge scene, shows that `nearest_hit` and `occluded` on CUDA tensors
sweep triangles only through W1 (the plain test raises) and take their
pairs only from W2 (the plain pair search raises; W2's pairs and ranks
equal the plain search's first), and holds the gradient through W1
against the plain version's.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.compile import GeometryTables, compile_wavefront
from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import mesh_sweep
from raytracer_tpu_torch.utils.constants import FARAWAY

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_mesh  # noqa: E402

GRAD_TOL = 1e-6
# float32 table gradients through two graphs: rounding of sums whose terms
# cancel (test_winner_t_gradient_is_the_plain_sweeps), of the largest element
TABLE_TOL_F32 = 1e-4
N_RAYS = 1536

# ---------------------------------------------------------------------------
# the edge scene: 600 physical rows in two regions, five cluster records
# ---------------------------------------------------------------------------

REGION0, REGION1 = 400, 200            # physical rows of the two regions
ROW_DUP = (266, 356)                   # a row copied inside one cluster
FLAT_DUP = (10, 138)                   # a row copied 128 rows on
# (first physical row, first virtual id, instance) of each record: record
# 1 runs past region 0 into region 1's rows, records 2 and 3 are two
# scaled instances of region 1 (record 2 past the last row, into the
# padding), record 4 is record 0 again with a larger box, so that it ties
# with record 0 at every t and wins by its visit rank where it comes first
RECORDS = ((0, 0, 0), (256, 256, 0), (400, 400, 1), (400, 656, 2), (0, 912, 0))
N_VIRT = 912 + 256
# instances: (axis, degrees, scale, translation); instance 0 the identity
INSTANCES = (((0, 1, 0), 0.0, 1.0, (0, 0, 0)),
             ((1, 1, 0), 30.0, 2.0, (3.0, 0.0, 0.0)),
             ((0, 0, 1), 60.0, 0.5, (-3.0, 0.5, 0.0)))


def _rotation(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.radians(deg)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _tri_tables(P1, P2, P3):
    """The compile's per-row tables (core/compile.py: unit normal, edge
    normals n31, n12, n23, centroid) of float64 corners, as float32."""
    nr = np.cross(P2 - P1, P3 - P1)
    n = nr / np.maximum(np.linalg.norm(nr, axis=-1, keepdims=True), 1e-20)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return dict(tri_p1=f(P1), tri_p2=f(P2), tri_p3=f(P3), tri_normal=f(n),
                tri_centroid=f((P1 + P2 + P3) / 3.0),
                tri_n31=f(np.cross(P3 - P1, n)), tri_n12=f(np.cross(P1 - P2, n)),
                tri_n23=f(np.cross(P2 - P3, n)))


def _empty_geometry():
    """GeometryTables with every table empty."""
    return GeometryTables(**{f.name: torch.zeros((0, 3)) for f in
                             dataclasses.fields(GeometryTables)})


def sweep_geom(seed=0):
    """(clustered GeometryTables, flat GeometryTables, the world corners of
    every record's rows): the edge scene.  Random triangles of ~0.4 in
    [-1, 1]^3, with row ROW_DUP[1] a copy of ROW_DUP[0] (a tie inside
    record 1) and row FLAT_DUP[1] a copy of FLAT_DUP[0] (a tie across the
    flat sweep's blocks of 128); each record's box is the world box of the
    rows it tests, grown by 1e-3 (record 4's by 0.5)."""
    rng = np.random.default_rng(seed)
    T = REGION0 + REGION1
    c = rng.uniform(-1, 1, (T, 1, 3))
    P = c + rng.uniform(-0.25, 0.25, (T, 3, 3))
    for a, b in (ROW_DUP, FLAT_DUP):
        P[b] = P[a]
    tabs = _tri_tables(P[:, 0], P[:, 1], P[:, 2])
    rot = np.stack([_rotation(ax, deg) for ax, deg, _, _ in INSTANCES])
    scale = np.array([s for _, _, s, _ in INSTANCES])
    trans = np.array([t for _, _, _, t in INSTANCES], np.float64)
    lo, hi, world = [], [], []
    for k, (start, _, inst) in enumerate(RECORDS):
        rows = P[start:min(start + isect.TRI_CLUSTER_SIZE, T)]
        w = (scale[inst] * rows) @ rot[inst].T + trans[inst]
        grow = 0.5 if k == 4 else 1e-3
        lo.append(w.reshape(-1, 3).min(0) - grow)
        hi.append(w.reshape(-1, 3).max(0) + grow)
        world.append(w)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    flat = dataclasses.replace(_empty_geometry(), **tabs)
    geom = dataclasses.replace(
        flat, tri_cl_lo=f(lo), tri_cl_hi=f(hi),
        tri_cl_start=i32([r[0] for r in RECORDS]),
        tri_cl_virt=i32([r[1] for r in RECORDS]),
        tri_cl_inst=i32([r[2] for r in RECORDS]),
        inst_rot=f(rot), inst_trans=f(trans), inst_inv_scale=f(1.0 / scale))
    return geom, flat, world


def sweep_rays(world, n=N_RAYS, seed=1):
    """(O, D) float32 (n, 3): a third of the rays aimed at the centroid of
    a random row of a random record (the duplicated rows among them), a
    third at random points of the scene, a third in random directions
    (most of them miss everything).  The first eighth start inside the
    boxes of records 0 and 4, the rest 2.5-6 units from the middle, outside
    both: in a tile of 256 rays without an inside origin record 4 comes
    before record 0 in the visit order, in the first tile after it."""
    rng = np.random.default_rng(seed)
    O = rng.normal(size=(n, 3))
    O *= rng.uniform(2.5, 6.0, (n, 1)) / np.linalg.norm(O, axis=1, keepdims=True)
    O[: n // 8] = rng.uniform(-1, 1, (n // 8, 3))
    q = n // 3
    rec = rng.integers(0, len(world), q)
    row = rng.integers(0, world[0].shape[0], q)
    row[:16] = ROW_DUP[0] - 256         # record 1's copy
    rec[:16] = 1
    row[16:32] = FLAT_DUP[0]            # records 0 and 4's copy
    rec[16:32] = 0
    row = np.minimum(row, np.array([w.shape[0] - 1 for w in world])[rec])
    target = np.empty((n, 3))
    target[:q] = np.stack([world[r][j].mean(0) for r, j in zip(rec, row)])
    target[q:2 * q] = rng.uniform(-1.5, 1.5, (q, 3))
    target[2 * q:] = O[2 * q:] + rng.normal(size=(n - 2 * q, 3))
    D = target - O
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return (torch.from_numpy(O.astype(np.float32)),
            torch.from_numpy(D.astype(np.float32)))


def sweep_limits(n=N_RAYS, seed=2):
    """(limit, tri_mask, max_dist, hit0): a pair-search limit that cuts
    pairs (FARAWAY, 0 or 0.5-4 units), a shadow mask by virtual id with
    a third of the bits false, distances of 0.5-8 (some FARAWAY and inf),
    and one ray in ten already occluded."""
    rng = np.random.default_rng(seed)
    limit = np.where(rng.random(n) < 0.5, FARAWAY, rng.uniform(0.5, 4.0, n))
    limit[rng.random(n) < 0.05] = 0.0
    md = rng.uniform(0.5, 8.0, n)
    md[rng.random(n) < 0.05] = FARAWAY
    md[rng.random(n) < 0.05] = np.inf
    t = lambda a, d=torch.float32: torch.from_numpy(np.asarray(a)).to(d)
    return (t(limit), t(rng.random(N_VIRT) < 0.67, torch.bool), t(md),
            t(rng.random(n) < 0.1, torch.bool))


# ---------------------------------------------------------------------------
# the mesh examples at 16x12
# ---------------------------------------------------------------------------

SCENES = {
    "icosphere": lambda d: torch_mesh.icosphere(16, 12, obj_dir=d),
    "instances": lambda d: torch_mesh.instances(16, 12, count=6, subdiv=2,
                                                obj_dir=d),
    "flat": lambda d: torch_mesh.icosphere(16, 12, subdiv=2, obj_dir=d),
}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory, one_thread):
    """{name: GeometryTables with the scene's triangles only}."""
    d = tmp_path_factory.mktemp("obj")
    return {k: tris_only(compile_wavefront(build(d))[1].geom)
            for k, build in SCENES.items()}


ANALYTIC = ("sphere_", "plane_", "box_", "disc_", "cyl_")


def tris_only(geom):
    """geom without its analytic objects: nearest_hit's t is then the
    triangle sweep's, and a triangle's object id its packed code's row."""
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name)[:0] for f in dataclasses.fields(geom)
        if f.name.startswith(ANALYTIC)})


def scene_rays(geom, n=1024, seed=0):
    """(O, D): rays from around the mesh toward points of its triangles (a
    quarter from inside its bounds)."""
    rng = np.random.default_rng(seed)
    P = geom.tri_centroid.numpy()
    if geom.inst_rot.shape[0]:
        vr, vi = geom.tri_virt_row.numpy(), geom.tri_virt_inst.numpy()
        R, t = geom.inst_rot.numpy(), geom.inst_trans.numpy()
        s = 1.0 / geom.inst_inv_scale.numpy()
        P = np.einsum("kij,kj->ki", R[vi], s[vi, None] * P[vr]) + t[vi]
    real = np.abs(P).sum(1) > 0
    P = P[real]
    lo, hi = P.min(0), P.max(0)
    O = (lo + hi) / 2 + rng.uniform(-2, 2, (n, 3)) * (hi - lo).max()
    O[: n // 4] = rng.uniform(lo, hi, (n // 4, 3))
    D = P[rng.integers(0, P.shape[0], n)] + rng.normal(0, 0.02, (n, 3)) - O
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return (torch.from_numpy(O.astype(np.float32)),
            torch.from_numpy(D.astype(np.float32)))


def plain_rows(geom, code):
    """(row, instance) of each winner from its virtual id, through the
    compile's virtual tables (a scene's records never run into another
    region's rows: each region is padded to whole clusters)."""
    v = torch.clamp_min(code, 0) >> 1
    if not geom.inst_rot.shape[0]:
        return v, None
    return (geom.tri_virt_row.index_select(0, v).to(torch.int64),
            geom.tri_virt_inst.index_select(0, v).to(torch.int64))


def plain_sweep(O, D, geom):
    """The plain nearest-triangle sweep of the scene: (t, code)."""
    if geom.tri_cl_lo.shape[0]:
        limit = torch.full((O.shape[0],), FARAWAY, dtype=O.dtype, device=O.device)
        return isect._clustered_nearest(O, D, geom, limit)
    return isect._flat_nearest(O, D, geom)


def with_grad(geom, names):
    """geom with fresh leaf copies of the tables `names` that require grad."""
    return dataclasses.replace(geom, **{
        k: getattr(geom, k).detach().clone().requires_grad_(True) for k in names})


GRAD_TABLES = ("tri_normal", "tri_centroid", "tri_p1", "tri_n31", "inst_rot",
               "inst_trans", "inst_inv_scale")


def _grads(t, hit, w, O, D, geom):
    loss = (torch.where(hit, t, 0.0) * w).sum()
    leaves = [D, O] + [getattr(geom, k) for k in GRAD_TABLES
                       if getattr(geom, k).requires_grad]
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("name", list(SCENES))
def test_winner_t_is_the_plain_sweeps_t(scenes, name):
    geom = scenes[name]
    assert bool(geom.tri_cl_lo.shape[0]) == (name != "flat")
    O, D = scene_rays(geom)
    t, code = plain_sweep(O, D, geom)
    hit = code >= 0
    assert 0.3 < float(hit.float().mean()) < 1.0
    t_w = isect.winner_t(O, D, geom, code, *plain_rows(geom, code))
    assert torch.equal(t_w, t)


def as_double(geom):
    """geom with its float tables in float64."""
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name).double() for f in dataclasses.fields(geom)
        if getattr(geom, f.name).is_floating_point()})


def grad_pair(O0, D0, geom, w, sweep, rows):
    """The gradients of sum(w t) over the hits with respect to D, O and the
    tables of GRAD_TABLES that the scene has, through the plain sweep's
    fold and through winner_t at its winners."""
    names = [k for k in GRAD_TABLES if getattr(geom, k).numel()]
    out = []
    for recompute in (False, True):
        O, D = O0.clone().requires_grad_(True), D0.clone().requires_grad_(True)
        g = with_grad(geom, names)
        t, code = sweep(O, D, g)
        if recompute:
            t = isect.winner_t(O, D, g, code, *rows(g, code))
        out.append(_grads(t, code >= 0, w, O, D, g))
    return out


def hold_grads(plain, other, table_tol):
    """D's and O's gradients within GRAD_TOL, the tables' within
    table_tol of the largest element of each; a table gradient of None
    (no path to t) matches None or zeros."""
    assert any(float(x.abs().max()) > 0 for x in plain if x is not None)
    for i, (a, b) in enumerate(zip(plain, other)):
        if a is None:
            assert b is None or float(b.abs().max()) == 0.0
        elif i < 2:
            torch.testing.assert_close(b, a, rtol=GRAD_TOL, atol=GRAD_TOL)
        else:
            assert float((a - b).abs().max()) <= table_tol * float(a.abs().max())


@pytest.mark.parametrize("name", list(SCENES))
def test_winner_t_gradient_is_the_plain_sweeps(scenes, name):
    """d(sum w t) over the hits with respect to the rays and the tables,
    through the plain sweep's fold and through winner_t at its winners.
    A table's gradient sums each hitting ray's terms, which cancel
    (n . (centroid - O) is taken as n . centroid - n . O) and which the two
    graphs add in other orders, so in float32 they differ by rounding
    (~1e-5 of the largest element); the rays' gradients have no such sum.
    So: in float32 D's and O's gradients within 1e-6, and in float64
    every gradient within 1e-6."""
    geom = scenes[name]
    O, D = scene_rays(geom, n=512, seed=3)
    w = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.5, 512))
    hold_grads(*grad_pair(O, D, geom, w.float(), plain_sweep, plain_rows),
               table_tol=TABLE_TOL_F32)
    plain, other = grad_pair(O.double(), D.double(), as_double(geom), w,
                             plain_sweep, plain_rows)
    for a, b in zip(plain, other):
        if a is None:
            assert b is None or float(b.abs().max()) == 0.0
        else:
            torch.testing.assert_close(b, a, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_cpu_wrappers_take_the_plain_versions(scenes):
    """For CPU tensors the wrappers launch nothing and give the plain
    versions' answers; nearest_hit and occluded give what they did."""
    geom = scenes["icosphere"]
    O, D = scene_rays(geom, n=256)
    limit = torch.full((256,), FARAWAY)
    md = torch.full((256,), 1e6)
    mask = torch.ones((geom.tri_p1.shape[0],), dtype=torch.bool)
    hit0 = torch.zeros((256,), dtype=torch.bool)
    mesh_sweep.reset_launches()
    t, code, rec = mesh_sweep.clustered_nearest(O, D, geom, limit)
    assert rec is None
    want = isect._clustered_nearest(O, D, geom, limit)
    assert torch.equal(t, want[0]) and torch.equal(code, want[1])
    assert torch.equal(mesh_sweep.clustered_occluded(O, D, geom, mask, md, hit0),
                       isect._clustered_occluded(O, D, geom, mask, md, hit0))
    flat = scenes["flat"]
    mask = torch.ones((flat.tri_p1.shape[0],), dtype=torch.bool)
    for a, b in zip(mesh_sweep.flat_nearest(O, D, flat),
                    isect._flat_nearest(O, D, flat)):
        assert torch.equal(a, b)
    assert torch.equal(mesh_sweep.flat_occluded(O, D, flat, mask, md),
                       isect._flat_occluded(O, D, flat, mask, md))
    assert mesh_sweep.launches() == 0


def test_scene_tables_are_made_once_per_geometry(scenes):
    """W1's tables are made at a geometry's first sweep and kept on it;
    an in-place change to a triangle table makes them again."""
    g = scenes["icosphere"]
    geom = dataclasses.replace(g, tri_normal=g.tri_normal.clone())
    T = geom.tri_p1.shape[0]
    rows, tables = mesh_sweep.scene_tables(geom)
    assert rows.shape == (T + isect.TRI_CLUSTER_SIZE, mesh_sweep.ROW)
    assert torch.equal(rows[:T], mesh_sweep.row_table(geom))
    assert float(rows[T:].abs().max()) == 0.0
    again = mesh_sweep.scene_tables(geom)
    assert again[0] is rows and again[1] is tables
    geom.tri_normal.mul_(-1.0)
    rows2 = mesh_sweep.scene_tables(geom)[0]
    assert rows2 is not rows
    assert torch.equal(rows2, mesh_sweep.row_table(geom, isect.TRI_CLUSTER_SIZE))


def test_kept_makes_again_for_another_tensor_at_the_same_version():
    """`kept` keys on each source's identity as well as its version: a
    source replaced by another tensor whose version counter reads the same
    makes the value again; the same tensors at the same versions do not."""
    holder = type("Holder", (), {})()
    a, b = torch.zeros(3), torch.ones(3)
    assert a._version == b._version
    made = []

    def make():
        made.append(len(made))
        return made[-1]

    assert mesh_sweep.kept(holder, "_t", (a, b), make) == 0
    assert mesh_sweep.kept(holder, "_t", (a, b), make) == 0
    assert mesh_sweep.kept(holder, "_t", (b, a), make) == 1
    c = torch.zeros(3)
    assert c._version == a._version
    assert mesh_sweep.kept(holder, "_t", (c, a), make) == 2
    c.add_(1.0)
    assert mesh_sweep.kept(holder, "_t", (c, a), make) == 3


SASS = """
        Function : _Z12other_kernelPf
        /*0000*/                   FCHK P0, R1, R2 ;
        /*0010*/               @P0 BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_113sweep_kernelEPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R0, R1, R2 ;
        /*0020*/                   FCHK P0, R0, R1 ;
        /*0030*/              @!P0 BRA 0x60 ;
        /*0040*/                   MOV R10, 0x60 ;
        /*0050*/                   CALL.REL.NOINC 0x100 ;
        /*0060*/                   FCHK P1, R0, R3 ;
        /*0070*/               @P1 BRA 0x90 ;
        /*0080*/                   FSEL R4, R0, R4, P2 ;
        /*0090*/              @!P2 BRA !P3, 0x10 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0 ;
"""


def test_loop_issue_counts_the_short_path():
    """W1's bound reads the issue slots of a test off the SASS of its
    loop (probes/common.py `loop_issue`): the loop's instructions less
    what its forward branches skip, over the tests (FCHK) a pass makes."""
    from raytracer_tpu_torch.probes import common

    # 0x10-0x90: 9 instructions, 0x40-0x50 (the slow path) and 0x80 (the
    # update) skipped
    assert common.loop_issue(SASS, "sweep_kernel", "FCHK") == (6, 2)
    with pytest.raises(ValueError):
        common.loop_issue(SASS, "sweep_kernel", "MUFU")
    with pytest.raises(ValueError):
        common.loop_issue(SASS, "absent_kernel", "FCHK")


NESTED_SASS = """
        Function : _ZN12_GLOBAL__N_117pair_count_kernelEPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/               @P0 BRA 0x90 ;
        /*0030*/                   FADD R2, R1, R3 ;
        /*0040*/                   VOTE.ANY R4, PT, P1 ;
        /*0050*/                   FADD R2, R1, R5 ;
        /*0060*/                   VOTE.ANY R6, PT, P2 ;
        /*0070*/                   IADD3 R7, R7, 0x2, RZ ;
        /*0080*/               @P3 BRA 0x30 ;
        /*0090*/              @!P4 BRA 0xc0 ;
        /*00a0*/                   FADD R2, R1, R3 ;
        /*00b0*/                   VOTE.ANY R4, PT, P1 ;
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00d0*/              @!P5 BRA 0x10 ;
        /*00e0*/                   EXIT ;
"""


def test_loop_issue_takes_the_innermost_loop():
    """W2's count kernel loops over chunks of records around an unrolled
    loop over the chunk's records and its remainder: the outer loop holds
    the most ballots (VOTE) but runs the inner one a varying number of
    times a pass, so the inner loop is read (0x30-0x80: 6 instructions, 2
    ballots)."""
    from raytracer_tpu_torch.probes import common

    assert common.loop_issue(NESTED_SASS, "pair_count_kernel", "VOTE") == (6, 2)


def test_edge_scene_holds_its_cases(monkeypatch):
    """The edge scene's plain sweep meets the cases it is built for: misses,
    a tie inside a cluster won by the later row, winners in both
    instances' own virtual ranges, the tie of records 0 and 4 won by each
    where it comes first in the visit order (tiles of 256 rays), and in
    one flat block the later copy of a row."""
    monkeypatch.setattr(isect, "RAY_TILE", 256)
    geom, flat, world = sweep_geom()
    O, D = sweep_rays(world)
    limit = torch.full((N_RAYS,), FARAWAY)
    t, code = isect._clustered_nearest(O, D, geom, limit)
    v = code >> 1
    assert bool((code < 0).any()) and bool((code >= 0).any())
    assert bool((v == ROW_DUP[1]).any()) and not bool((v == ROW_DUP[0]).any())
    assert bool(((v >= 512) & (v < 600)).any())          # record 2 alone
    assert bool(((v >= 656) & (v < 912)).any())          # record 3
    assert bool((v >= RECORDS[4][1]).any())              # record 4 by rank
    assert bool(((v >= 0) & (v < 256)).any())            # record 0 by rank
    t_f, code_f = isect._flat_nearest(O, D, flat)
    assert bool((code_f >> 1 == FLAT_DUP[1]).any())   # one block of 2048 rows


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (W1 has no CPU mode)")
    return torch.device("cuda")


def _card_hold(geom, O, D, limit, mask, md, hit0, dev):
    """W1 against its plain version on the card, bit for bit: the four
    entries (flat ones where the scene has no clusters)."""
    g = geom.to(dev)
    O, D, limit, mask, md, hit0 = (x.to(dev) for x in (O, D, limit, mask, md, hit0))
    if g.tri_cl_lo.shape[0]:
        t, code, rec = mesh_sweep.clustered_nearest(O, D, g, limit)
        want = isect._clustered_nearest(O, D, g, limit)
        occ = mesh_sweep.clustered_occluded(O, D, g, mask, md, hit0)
        occ_want = isect._clustered_occluded(O, D, g, mask, md, hit0)
        t_w = isect.winner_t(O, D, g, code, *isect.winner_rows(g, code, rec))
    else:
        t, code = mesh_sweep.flat_nearest(O, D, g)
        want = isect._flat_nearest(O, D, g)
        occ = mesh_sweep.flat_occluded(O, D, g, mask, md)
        occ_want = isect._flat_occluded(O, D, g, mask, md)
        t_w = isect.winner_t(O, D, g, code, *isect.winner_rows(g, code))
    torch.cuda.synchronize()
    assert torch.equal(t, want[0])
    assert torch.equal(code, want[1])
    assert torch.equal(occ, occ_want)
    assert torch.equal(t_w, t)


@pytest.mark.cuda
def test_w1_on_the_card_matches_plain_on_the_edge_scene(card, monkeypatch):
    monkeypatch.setattr(isect, "RAY_TILE", 256)
    geom, flat, world = sweep_geom()
    O, D = sweep_rays(world)
    limit, mask, md, hit0 = sweep_limits()
    mesh_sweep.reset_launches()
    _card_hold(geom, O, D, limit, mask, md, hit0, card)
    _card_hold(flat, O, D, limit, mask[:flat.tri_p1.shape[0]], md, hit0, card)
    assert mesh_sweep.launches() == 2 + 1 + 1 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_w1_on_the_card_matches_plain_on_the_meshes(card, scenes, name):
    geom = scenes[name]
    O, D = scene_rays(geom, n=4096, seed=5)
    n = O.shape[0]
    _card_hold(geom, O, D, torch.full((n,), FARAWAY),
               torch.ones((max(geom.tri_virt_row.shape[0], geom.tri_p1.shape[0]),),
                          dtype=torch.bool),
               torch.full((n,), 1e6), torch.zeros((n,), dtype=torch.bool), card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_card_sweeps_triangles_only_through_w1(card, scenes, name, monkeypatch):
    """nearest_hit and occluded on CUDA tensors with the plain triangle
    test raising: only W1 tests triangles there."""
    geom = scenes[name].to(card)
    O, D = (x.to(card) for x in scene_rays(scenes[name], n=2048, seed=6))
    want = isect.nearest_hit(O, D, geom)
    mask = torch.ones((int(geom.tri_p1.shape[0]) + 8 + max(
        int(geom.tri_virt_row.shape[0]), 0),), dtype=torch.bool, device=card)

    def plain(*args, **kw):
        raise AssertionError("the plain triangle sweep ran on the card")

    monkeypatch.setattr(isect, "intersect_triangles", plain)
    mesh_sweep.reset_launches()
    got = isect.nearest_hit(O, D, geom)
    isect.occluded(O, D, geom, mask, torch.full((2048,), 1e6, device=card))
    assert mesh_sweep.launches() >= 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_card_gradient_through_w1_is_the_plain_sweeps(card, scenes, name):
    """nearest_hit's t on the card with grad is W1's winners recomputed
    (winner_t): t bit for bit the plain sweep's on the card, and its
    gradient the plain sweep's (float32, as on the CPU)."""
    geom = scenes[name].to(card)
    O, D = (x.to(card) for x in scene_rays(scenes[name], n=512, seed=3))
    w = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.5, 512)
                         .astype(np.float32)).to(card)
    before = mesh_sweep.launches()
    ts = []

    def through_w1(O, D, g):
        t, _, _ = isect.nearest_hit(O, D, g)
        ts.append(t.detach())
        return t, torch.where(t < FARAWAY, 0, -1)

    names = [k for k in GRAD_TABLES if getattr(geom, k).numel()]
    O1, D1 = O.clone().requires_grad_(True), D.clone().requires_grad_(True)
    g = with_grad(geom, names)
    t, code = through_w1(O1, D1, g)
    kernel = _grads(t, code >= 0, w, O1, D1, g)
    assert mesh_sweep.launches() > before
    plain, _ = grad_pair(O, D, geom, w, plain_sweep, lambda g, c: plain_rows(g, c))
    with torch.no_grad():
        t_plain, _ = plain_sweep(O, D, geom)
    assert torch.equal(ts[0], t_plain)
    hold_grads(plain, kernel, table_tol=TABLE_TOL_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["edge"] + [k for k in SCENES if k != "flat"])
def test_card_pairs_come_only_from_w2(card, scenes, name, monkeypatch):
    """W2's pairs, ranks and counts on the card equal the plain search's;
    and with the plain search raising, nearest_hit and occluded on CUDA
    tensors give what they gave: the card's clustered sweeps take their
    pairs only from W2, one host sync a sweep."""
    from raytracer_tpu_torch.ops import mesh_pairs

    if name == "edge":
        monkeypatch.setattr(isect, "RAY_TILE", 256)
        geom, _, world = sweep_geom()
        O, D = sweep_rays(world)
    else:
        geom = scenes[name]
        O, D = scene_rays(geom, n=2048, seed=7)
    geom, O, D = geom.to(card), O.to(card), D.to(card)
    n = O.shape[0]
    limit = torch.full((n,), FARAWAY, device=card)
    for a, b, R in isect._ray_groups(n, geom.tri_cl_lo.shape[0]):
        got = mesh_pairs.cluster_pairs(O[a:b], D[a:b], geom, limit[a:b], R)
        want = isect._cluster_pairs(O[a:b], D[a:b], geom, limit[a:b], R)
        for key in ("rays", "recs", "rank"):
            assert torch.equal(got[key], want[key]), key
        assert got["clusters"] == len(want["groups"])
    mask = torch.ones((max(int(geom.tri_virt_row.shape[0]),
                           int(geom.tri_p1.shape[0]), 2048),),
                      dtype=torch.bool, device=card)
    md = torch.full((n,), 1e6, device=card)
    want = (isect.nearest_hit(O, D, geom), isect.occluded(O, D, geom, mask, md))

    def plain(*args, **kw):
        raise AssertionError("the plain pair search ran on the card")

    monkeypatch.setattr(isect, "_pair_search", plain)
    mesh_pairs.cluster_pairs.launches = 0
    before = dict(isect.SWEEP_STATS)
    got = (isect.nearest_hit(O, D, geom), isect.occluded(O, D, geom, mask, md))
    assert mesh_pairs.cluster_pairs.launches >= 2 * 5
    d = {k: isect.SWEEP_STATS[k] - before[k] for k in before}
    assert d["syncs"] == d["sweeps"] >= 2
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
