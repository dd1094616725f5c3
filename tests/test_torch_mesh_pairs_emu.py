"""W2, the clustered sweep's pair search, run on the CPU through the
stand-in CUDA runtime.

g++ compiles csrc/mesh_pairs.cu (with csrc/mesh_sweep.cu, so that W1 can
sweep W2's pairs) against csrc/emu/cuda_runtime.h into a library of its
own, which `mesh_pairs.cluster_pairs` and W1's clustered wrappers take as
`lib=` / `pairs_lib=` with CPU tensors.  W2's pairs (rays, records), the
visit ranks, the pair count K and the physical clusters with pairs are
held equal, element for element, to the plain search
(`intersect._cluster_pairs`):

- on the three mesh examples of examples/torch_mesh.py (icosphere, beach
  ball, the field of 48 instances: 240 records) at 16x16, their camera
  rays under the analytic objects' nearest hit and their first hits'
  shadow rays under (hit0 ? 0 : max_dist), as the wavefront passes them;
- on the edge scene of tests/test_torch_mesh_sweep.py (`sweep_geom`), one
  case at a time: origins on a box face, whose entry is -0.0 before the
  clamp; rays whose limit equals their entry into a box (left out: the
  cut is strict); records tied on their least entry over a tile, at +inf
  and at a finite value; padded rays; a limit of 0; NaN and infinite
  origins and directions, and zero direction components; tiles of 256 rays;
  groups of tiles (PAIR_MASK_ELEMS); a library staging 3 and 7 records at
  a time in shared memory (PAIRS_CHUNK), fewer than the records.

Each source mutation of `MUTANTS` (a `<=` cut, a -0.0 entry, ties by the
reverse record index, the earlier warps' pairs counted from the other
end: a valid pair list in another order, fminf for torch.minimum's NaN
rule) makes some case fail.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/mesh_pairs.cu \\
        raytracer_tpu_torch/csrc/mesh_sweep.cu -o build/mesh_pairs_emu.so
"""

import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import generate_rays
from raytracer_tpu_torch.core.compile import compile_wavefront
from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import mesh_pairs, mesh_sweep
from raytracer_tpu_torch.utils.constants import FARAWAY, SKYBOX_DISTANCE

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT / "examples"))
import torch_mesh  # noqa: E402
from test_torch_mesh_sweep import (sweep_geom, sweep_limits,  # noqa: E402
                                   sweep_rays)

FRAME = 16                             # the mesh examples at 16x16
MESHES = {
    "icosphere": lambda d: torch_mesh.icosphere(FRAME, FRAME, obj_dir=d),
    "beach_ball": lambda d: torch_mesh.beach_ball(FRAME, FRAME, obj_dir=d),
    "instances": lambda d: torch_mesh.instances(FRAME, FRAME, obj_dir=d),
}
SMALL_CHUNKS = (3, 7)                  # PAIRS_CHUNK of the chunk cases
# source mutations, each a list of (old, new) edits, that some case must
# catch
MUTANTS = {
    "cut_le": [("e < r.lim", "e <= r.lim")],
    "negative_zero": [("(tn > 0.0f ? tn : 0.0f)", "(tn >= 0.0f ? tn : 0.0f)")],
    "ties_reversed": [("(k < c)", "(k > c)")],
    "warps_reversed": [("for (int w = 0; w < warp; ++w)",
                        "for (int w = warp + 1; w < PAIRS_WARPS; ++w)")],
    "nan_dropped": [("return (a < b || a != a) ? a : b;", "return fminf(a, b);"),
                    ("return (a > b || a != a) ? a : b;", "return fmaxf(a, b);")],
}


def build(out, defines=(), source=None):
    """g++ build of mesh_pairs.cu (or the text `source` in its place) and
    mesh_sweep.cu against the stand-in runtime into `out`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W2 for the CPU")
    src = CSRC / "mesh_pairs.cu"
    if source is not None:
        src = out.with_suffix(".cu")
        src.write_text(source)
    subprocess.run([gxx, *GXX_FLAGS, *(f"-D{d}" for d in defines), "-I",
                    str(CSRC / "emu"), "-x", "c++", str(src),
                    str(CSRC / "mesh_sweep.cu"), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emu") / "mesh_pairs_emu.so")


@pytest.fixture(scope="module")
def chunk_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("emu_chunk")
    return {c: build(d / f"mesh_pairs_chunk{c}.so", (f"PAIRS_CHUNK={c}",))
            for c in SMALL_CHUNKS}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """{name: (GeometryTables, [(what, O, D, limit)])}: each mesh
    example's camera rays (16x16, one sample) under the analytic objects'
    nearest hit, and its hits' shadow rays toward the directional light
    under (hit0 ? 0 : SKYBOX_DISTANCE)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("obj")
    out = {}
    for name, make in MESHES.items():
        sc = make(d)
        data = compile_wavefront(sc)[1]
        geom = data.geom
        O, D = generate_rays(torch.Generator().manual_seed(3),
                             sc.camera.params(), FRAME, FRAME, 1)
        analytic = analytic_only(geom)
        limit = isect.nearest_hit(O, D, analytic)[0]
        t, orient, _ = isect.nearest_hit(O, D, geom)
        hit = t < FARAWAY
        P = (O + D * t[:, None])[hit]
        Os = P + 1e-4 * data.lights.dir_l[0]
        Ls = data.lights.dir_l[0].expand(Os.shape).contiguous()
        md = torch.full((Os.shape[0],), SKYBOX_DISTANCE)
        hit0 = isect.occluded(Os, Ls, analytic, data.obj.shadow, md)
        out[name] = (geom, [("camera", O, D, limit),
                            ("shadow", Os, Ls, torch.where(hit0, 0.0, md))])
    torch.set_num_threads(n)
    return out


def analytic_only(geom):
    """geom without its triangles, clusters and instances."""
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name)[:0] for f in dataclasses.fields(geom)
        if f.name.startswith(("tri_", "inst_"))})


def search_both(lib, O, D, geom, limit):
    """[(W2's search, the plain search)] of each group of whole tiles,
    and the stats each side added to SWEEP_STATS."""
    out, stats = [], []
    for a, b, R in isect._ray_groups(O.shape[0], geom.tri_cl_lo.shape[0]):
        args = (O[a:b], D[a:b], geom, limit[a:b], R)
        pair = []
        for side in (lib, None):
            before = dict(isect.SWEEP_STATS)
            pair.append(mesh_pairs.cluster_pairs(*args, lib=side))
            stats.append({k: isect.SWEEP_STATS[k] - before[k] for k in before})
        out.append(tuple(pair))
    return out, stats


def differences(lib, O, D, geom, limit):
    """What differs between W2 from `lib` and the plain search: a list of
    names, empty when every group's pairs, ranks, K and clusters agree."""
    groups, stats = search_both(lib, O, D, geom, limit)
    bad = []
    for got, want in groups:
        for key in ("Op", "Dp", "rays", "recs", "rank"):
            a, b = got[key], want[key]
            if a.is_floating_point():               # NaN rays: their bits
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape or not torch.equal(a, b):
                bad.append(key)
        if got["clusters"] != len(want["groups"]):
            bad.append("clusters")
    for w2, plain in zip(stats[::2], stats[1::2]):
        if w2["pairs"] != plain["pairs"] or w2["clusters"] != plain["clusters"]:
            bad.append("stats")
    return bad


def hold(lib, O, D, geom, limit):
    """W2 equal to the plain search in every group; returns the groups."""
    assert differences(lib, O, D, geom, limit) == []
    return search_both(lib, O, D, geom, limit)[0]


# ---------------------------------------------------------------------------
# the edge cases, on the edge scene
# ---------------------------------------------------------------------------


def edge():
    """(geom, O, D, limit) of the edge scene (tests/test_torch_mesh_sweep.py)."""
    geom, _, world = sweep_geom()
    O, D = sweep_rays(world)
    return geom, O, D, sweep_limits()[0]


def on_face(geom, n=256, seed=7):
    """(O, D): n rays whose origins lie on the +x face of record 0's box
    (x = hi exactly, y and z inside), going into it: (hi - o) * (1 / dx)
    = 0 * a negative number = -0.0, the entry before the clamp, while the
    rays start inside record 4's larger box (entry +0.0): the two records
    tie at 0 in the tile, record 0 first."""
    rng = np.random.default_rng(seed)
    lo, hi = geom.tri_cl_lo[0].numpy(), geom.tri_cl_hi[0].numpy()
    O = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    O[:, 0] = hi[0]
    D = rng.normal(size=(n, 3))
    D[:, 0] = -np.abs(D[:, 0]) - 0.1
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return torch.from_numpy(O), torch.from_numpy(D.astype(np.float32))


def away(n=256, seed=8):
    """(O, D): n rays from 10 units out going further out: they miss every
    box, so every record's least entry over their tile is +inf."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(n, 3))
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return (torch.from_numpy((10.0 * D).astype(np.float32)),
            torch.from_numpy(D.astype(np.float32)))


def tied_boxes(geom):
    """geom with record 2's box made record 1's: the two tie on their
    entry into every ray."""
    lo, hi = geom.tri_cl_lo.clone(), geom.tri_cl_hi.clone()
    lo[2], hi[2] = lo[1], hi[1]
    return dataclasses.replace(geom, tri_cl_lo=lo, tri_cl_hi=hi)


def at_entry(geom, O, D):
    """A limit equal, for each ray that enters a box, to its entry into
    the first box it enters (FARAWAY elsewhere)."""
    Ip = tuple(isect._safe_inv(D[:, a])[None, :] for a in range(3))
    entry = isect._cluster_entry(geom.tri_cl_lo, geom.tri_cl_hi,
                                 tuple(O[:, a][None, :] for a in range(3)), Ip)
    live = entry < float("inf")
    first = torch.argmax(live.to(torch.int8), dim=0)
    e = entry.gather(0, first[None, :])[0]
    return torch.where(live.any(0), e, FARAWAY)


def case(name, monkeypatch):
    """(geom, O, D, limit) of the edge case `name`, with RAY_TILE set for
    it."""
    geom, O, D, limit = edge()
    if name != "one_tile":
        monkeypatch.setattr(isect, "RAY_TILE", 256)
    if name == "face":
        Of, Df = on_face(geom)
        O, D = torch.cat([Of, O[:256]]), torch.cat([Df, D[:256]])
        limit = torch.full((512,), FARAWAY)
    elif name == "limit_at_entry":
        limit = at_entry(geom, O, D)
    elif name == "ties_inf":
        Oa, Da = away()
        O, D = torch.cat([O[:256], Oa]), torch.cat([D[:256], Da])
        limit = torch.full((512,), FARAWAY)
    elif name == "ties_finite":
        geom = tied_boxes(geom)
    elif name == "padded":
        O, D, limit = O[:300], D[:300], limit[:300]
    elif name == "limit_0":
        limit = torch.zeros_like(limit)
    elif name == "non_finite":
        O, D = non_finite(O, D)
    return geom, O, D, limit


def non_finite(O, D):
    """(O, D) with some components NaN or infinite, and some directions 0
    or below 1e-12 on an axis: torch.minimum / maximum carry a NaN, which
    makes the entry +inf, where the card's fminf would drop it."""
    O, D = O.clone(), D.clone()
    nan, inf = float("nan"), float("inf")
    O[0:40:4, 0] = nan
    D[1:40:4, 1] = nan
    O[2:40:4, 2] = inf
    D[3:40:4, 0] = -inf
    O[40:80:2, 1] = -inf
    D[40:80:2, 1] = inf
    D[80:100, 2] = 0.0
    D[100:120, 0] = -1e-13
    return O, D


CASES = ("plain_mix", "face", "limit_at_entry", "ties_inf", "ties_finite",
         "padded", "limit_0", "non_finite", "one_tile")


@pytest.mark.parametrize("name", CASES)
def test_w2_equals_the_plain_search_on_the_edge_cases(emu_lib, name, monkeypatch):
    geom, O, D, limit = case(name, monkeypatch)
    groups = hold(emu_lib, O, D, geom, limit)
    (got, want), = groups
    C = geom.tri_cl_lo.shape[0]
    npad = got["Op"].shape[1]
    nt = npad // got["R"]
    rank = got["rank"].view(nt, C)
    if name == "face":
        # the face tile: records 0 and 4 tie at 0, record 0 first
        m = isect._cluster_entry(geom.tri_cl_lo, geom.tri_cl_hi,
                                 tuple(want["Op"][a, :256][None, :] for a in range(3)),
                                 tuple(isect._safe_inv(want["Dp"][a, :256])[None, :]
                                       for a in range(3))).amin(dim=1)
        assert float(m[0]) == 0.0 and float(m[4]) == 0.0
        assert int(rank[0, 0]) < int(rank[0, 4])
        # the unclamped entry is -0.0 there
        t = (geom.tri_cl_hi[0, 0] - want["Op"][0, :256]) * isect._safe_inv(
            want["Dp"][0, :256])
        assert bool(torch.signbit(t).all()) and float(t.abs().max()) == 0.0
    elif name == "limit_at_entry":
        plain = search_both(emu_lib, O, D, geom, torch.nextafter(
            limit, torch.full_like(limit, float("inf"))))[0][0][1]
        assert plain["rays"].shape[0] > want["rays"].shape[0]
    elif name == "ties_inf":
        # the second tile misses everything: ranks by record index
        assert torch.equal(rank[1], torch.arange(C))
    elif name == "ties_finite":
        assert bool((rank[:, 1] < rank[:, 2]).all())
        assert bool((rank[:, 2] == rank[:, 1] + 1).any())
    elif name == "padded":
        assert npad > O.shape[0] and bool((got["rays"] < O.shape[0]).all())
    elif name == "limit_0":
        assert got["rays"].shape[0] == 0 and got["clusters"] == 0
    elif name == "non_finite":
        # rays with a NaN keep no pair; rays along an axis keep some
        bad = torch.isnan(O).any(1) | torch.isnan(D).any(1)
        assert bool(bad.any()) and not bool(bad[got["rays"]].any())
        assert bool(((got["rays"] >= 80) & (got["rays"] < 120)).any())
    elif name == "one_tile":
        assert nt == 1
    else:
        assert nt > 1 and got["clusters"] >= 2


def test_w2_launches_and_syncs(emu_lib, monkeypatch):
    """W2 makes 6 launches and one host sync a search (5 where no pair is
    kept: no write); the plain search launches nothing and syncs twice."""
    geom, O, D, limit = case("plain_mix", monkeypatch)
    R = isect._ray_groups(O.shape[0], geom.tri_cl_lo.shape[0])[0][2]
    for lim, launches in ((limit, 6), (torch.zeros_like(limit), 5)):
        before = mesh_pairs.cluster_pairs.launches
        syncs = isect.SWEEP_STATS["syncs"]
        mesh_pairs.cluster_pairs(O, D, geom, lim, R, lib=emu_lib)
        assert mesh_pairs.cluster_pairs.launches - before == launches
        assert isect.SWEEP_STATS["syncs"] - syncs == 1
    before = mesh_pairs.cluster_pairs.launches
    syncs = isect.SWEEP_STATS["syncs"]
    mesh_pairs.cluster_pairs(O, D, geom, limit, R)
    assert mesh_pairs.cluster_pairs.launches == before
    assert isect.SWEEP_STATS["syncs"] - syncs == 2


def test_w2_groups_of_tiles_and_w1_over_its_pairs(emu_lib, monkeypatch):
    """Groups of one tile each (PAIR_MASK_ELEMS): every group's search
    equal; and W1's clustered nearest and occluded over W2's pairs equal
    the plain fold, with the plain search raising (neither wrapper calls
    it when given W2)."""
    geom, O, D, limit = case("plain_mix", monkeypatch)
    _, mask, md, hit0 = sweep_limits()
    C = geom.tri_cl_lo.shape[0]
    monkeypatch.setattr(isect, "PAIR_MASK_ELEMS", C * 256)
    assert len(isect._ray_groups(O.shape[0], C)) == O.shape[0] // 256
    assert len(hold(emu_lib, O, D, geom, limit)) > 1
    want_near = isect._clustered_nearest(O, D, geom, limit)
    want_occ = isect._clustered_occluded(O, D, geom, mask, md, hit0)

    def plain(*args, **kw):
        raise AssertionError("the plain pair search ran")

    monkeypatch.setattr(isect, "_pair_search", plain)
    t, code, _ = mesh_sweep._cluster_nearest_launch(O, D, geom, limit,
                                                    lib=emu_lib, pairs_lib=emu_lib)
    assert torch.equal(t, want_near[0]) and torch.equal(code, want_near[1])
    occ = mesh_sweep._cluster_occluded_launch(O, D, geom, mask, md, hit0,
                                              lib=emu_lib, pairs_lib=emu_lib)
    assert torch.equal(occ, want_occ)


@pytest.mark.parametrize("chunk", SMALL_CHUNKS)
def test_w2_chunks_of_records(chunk_libs, meshes, chunk, monkeypatch):
    """Boxes staged PAIRS_CHUNK records at a time, fewer than the records,
    the last chunk short: the instance field's camera rays (240 records;
    7 a chunk) and the edge scene in tiles of 256 (5 records; 3 a
    chunk)."""
    geom, O, D, limit = case("plain_mix", monkeypatch)
    if chunk < geom.tri_cl_lo.shape[0]:
        hold(chunk_libs[chunk], O, D, geom, limit)
    geom, cases = meshes["instances"]
    _, O, D, limit = cases[0]
    assert geom.tri_cl_lo.shape[0] == 240
    hold(chunk_libs[chunk], O, D, geom, limit)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("what", ["camera", "shadow"])
def test_w2_equals_the_plain_search_on_the_meshes(emu_lib, meshes, name, what):
    geom, cases = meshes[name]
    _, O, D, limit = next(c for c in cases if c[0] == what)
    (got, want), = hold(emu_lib, O, D, geom, limit)
    assert got["rays"].shape[0] > 0
    assert geom.tri_cl_lo.shape[0] > 1


def test_w2_refuses_what_it_cannot_hold(emu_lib, monkeypatch):
    """More (record, ray) slots than int32 pair slots raise in the wrapper;
    an entry given a tile that is no multiple of 256 reports an error."""
    geom, O, D, limit = edge()
    monkeypatch.setattr(mesh_pairs, "PAIR_SLOTS", geom.tri_cl_lo.shape[0] * 256)
    with pytest.raises(ValueError, match="slots"):
        mesh_pairs.cluster_pairs(O, D, geom, limit, 512, lib=emu_lib)
    monkeypatch.undo()
    sw = mesh_pairs._prepare(O, D, geom, limit, 512)
    sw["R"] = 384
    with pytest.raises(RuntimeError, match="CUDA error"):
        mesh_pairs._search(sw, emu_lib)
    with pytest.raises(TypeError):
        mesh_pairs.cluster_pairs(O.double(), D, geom, limit, 512, lib=emu_lib)


def test_pair_tables_are_kept_per_geometry():
    geom, _, _, _ = edge()
    boxes, rec_of_row, start_of_row = mesh_pairs.pair_tables(geom)
    order = torch.argsort(geom.tri_cl_start, stable=True)
    assert torch.equal(rec_of_row.long(), order)
    assert torch.equal(boxes[:, :3], geom.tri_cl_lo[order])
    assert torch.equal(boxes[:, 3:], geom.tri_cl_hi[order])
    assert torch.equal(start_of_row, geom.tri_cl_start[order])
    assert mesh_pairs.pair_tables(geom)[0] is boxes
    geom.tri_cl_lo.sub_(1.0)
    assert mesh_pairs.pair_tables(geom)[0] is not boxes


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w2_fails(mutant, tmp_path, monkeypatch):
    text = (CSRC / "mesh_pairs.cu").read_text()
    for old, new in MUTANTS[mutant]:
        assert old in text
        text = text.replace(old, new)
    lib = build(tmp_path / f"{mutant}.so", source=text)
    caught = []
    for name in CASES:
        with monkeypatch.context() as m:
            if differences(lib, *_args(case(name, m))):
                caught.append(name)
    assert caught, f"no case catches the mutant {mutant}"


def _args(c):
    geom, O, D, limit = c
    return O, D, geom, limit
