"""W3, the wavefront's analytic sweep, run on the CPU through the stand-in
CUDA runtime.

g++ compiles csrc/analytic_sweep.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h (a std::thread per CUDA thread, the blocks one
after another) into a library of its own, which the wrapper's
`_nearest_launch` / `_occluded_launch` take as `lib=` with CPU tensors.
Both entries are held element for element against the plain loops
(geometry/intersect.py `_analytic_nearest`, `_analytic_occluded`): t and
orientation bit for bit (-0.0 included), object ids and shadow answers
equal.  The arithmetic is IEEE without contraction on both sides
(-ffp-contract=off); torch's vectorised CPU sqrt is not correctly rounded
(one ulp off on ~0.6% of lanes) where the card's, and g++'s sqrtf, are,
so the plain loops here take `safe_sqrt`'s root in float64, rounded once
to float32: the correctly rounded float32 root, as on the card.

The edge scene (`edge_scene`): every kind, two identical spheres (a tie
inside a block, and across blocks when blocks are one object), a plane
and a disc in one place (a tie across kinds: the plane's lower id wins),
an axis-aligned box and rays that start on one of its slab planes while
running parallel to it (0 * inf: a NaN t, which drops the whole block of
the plain loop, so a second box in its block is hit only when blocks are
one object), rays that start on a box face and run inward (t = -0.0), a
capped cylinder 50 units off, rays that miss everything, max_dist equal
to the ray's nearest t on some rays (not occluded: the cut is strict),
a shadow mask with false bits; at the block sizes of the plain loop
1, 2, 5 and its default (one block a kind), and with libraries staging 3
and 7 objects at a time in shared memory (ANALYTIC_CHUNK), fewer than
the scene's 28.

The occluded entry is also held on the cases of `OCCLUDED_CASES`: a
direction and max_dist passed as the expand of one row (stride 0: the
wrapper hands the kernel that row, a view into a larger buffer whose other
rows differ, so a read by ray index is caught), passed a ray each, a mask
with no bit set (no launch), with every bit set, and a non-casting object
nearer than a casting one (the table holds the casting objects alone).

Each source mutation of `MUTANTS` (fminf / fmaxf for torch's NaN-carrying
minimum and maximum, `<=` across blocks, no NaN rule for a block, a
reordered dot product) makes some case fail, and so does each of
`OCCLUDED_MUTANTS` (a uniform direction or max_dist read by ray index;
the wrapper's casting table made from a mask read off by one).  One mutation of the
plain version's list cannot: the plane test's `fabsf(t)` for `t`.  Its
hit condition `ndco * ndd > 0` makes t = ndco / ndd positive (or +0 on
underflow, +inf on overflow) wherever it returns t, so |t| and t have
the same bits on every input (`test_the_plane_signed_t_mutant_is_equivalent`).

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/analytic_sweep.cu -o build/analytic_emu.so
"""

import ctypes
import inspect
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.compile import compile_wavefront
from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import analytic_sweep
from raytracer_tpu_torch.utils.constants import FARAWAY

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")
N_RAYS = 2048
SMALL_CHUNKS = (3, 7)                  # ANALYTIC_CHUNK of the chunk cases
# objects a block of the plain loop: BLOCK_ELEMS // N_RAYS (None: default)
BLOCKS = (None, 1, 2, 5)
MUTANTS = {
    "fminf": [("return a != a ? a : (b != b ? b : fminf(a, b));",
               "return fminf(a, b);"),
              ("return a != a ? a : (b != b ? b : fmaxf(a, b));",
               "return fmaxf(a, b);")],
    "le_across_blocks": [("if (!s.blk_nan && s.blk_t < s.t) {",
                          "if (!s.blk_nan && s.blk_t <= s.t) {")],
    "no_nan_rule": [("if (!s.blk_nan && s.blk_t < s.t) {",
                     "if (s.blk_t < s.t) {")],
    "dot_reordered": [("const float tca = -(r.dx * ocx + r.dy * ocy + r.dz * ocz);",
                       "const float tca = -(r.dz * ocz + r.dy * ocy + r.dx * ocx);")],
}
# the occluded entry's: source edits of the kernel, or ("wrapper", edits
# of ops/analytic_sweep.py `casting_tables`)
OCCLUDED_MUTANTS = {
    "uniform_D_by_ray": [("if (d_step) {", "if (d_step || true) {")],
    "uniform_md_by_ray": [("s.md = md_step ? max_dist[i] : uni[3];",
                           "s.md = max_dist[i];")],
    "mask_off_by_one": ("wrapper", [("bits = mask.cpu()",
                                     "bits = torch.roll(mask.cpu(), 1)")]),
}
OCCLUDED_CASES = ("uniform", "per_ray", "no_bit", "every_bit",
                  "non_caster_nearer")
PLANE_SIGNED_T = [("fabsf(v) <= b.w && ndco * ndd > 0.0f) ? fabsf(t)",
                   "fabsf(v) <= b.w && ndco * ndd > 0.0f) ? t")]


def build(out, defines=(), source=None):
    """g++ build of analytic_sweep.cu (or the text `source` in its place)
    against the stand-in runtime into `out`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W3 for the CPU")
    src = CSRC / "analytic_sweep.cu"
    if source is not None:
        src = out.with_suffix(".cu")
        src.write_text(source)
    subprocess.run([gxx, *GXX_FLAGS, *(f"-D{d}" for d in defines), "-I",
                    str(CSRC / "emu"), "-x", "c++", str(src), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{staged objects a chunk: library}: the default and two small."""
    d = tmp_path_factory.mktemp("emu")
    out = {256: build(d / "analytic_emu.so")}
    for c in SMALL_CHUNKS:
        out[c] = build(d / f"analytic_chunk{c}.so", (f"ANALYTIC_CHUNK={c}",))
    return out


def exact_sqrt(x, eps=1e-30):
    """safemath.safe_sqrt with the correctly rounded float32 root (float64,
    rounded once), as the card's torch and W3 take it."""
    r = torch.sqrt(torch.clamp_min(x, eps).double()).to(x.dtype)
    return torch.where(x > 0, r, torch.zeros_like(r))


@pytest.fixture(autouse=True)
def card_rounding(monkeypatch):
    monkeypatch.setattr(isect, "safe_sqrt", exact_sqrt)


# ---------------------------------------------------------------------------
# the edge scene
# ---------------------------------------------------------------------------

TWIN = (0, 1)                         # identical spheres: ids 0 and 1
PLANE_TIE, DISC_TIE = 17, 24          # the plane and the disc in one place
NAN_BOX, NAN_BOX_PARTNER = 19, 20     # one block of two when blocks are 2
ZERO_BOX = 21
FAR_CYLINDER = 27


def edge_scene():
    """GeometryTables: 16 spheres, 3 planes, 4 boxes, 2 discs and 3
    cylinders (28 objects; ids as the constants above say)."""
    m = T
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0.5, 4), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    mat = m.Diffuse(diff_color=m.rgb(0.5, 0.5, 0.5))
    for _ in TWIN:
        sc.add(m.Sphere(material=mat, center=m.vec3(-1.0, 0.3, 0.0), radius=0.4))
    rng = np.random.default_rng(11)
    for i in range(13):
        c = rng.uniform([-2.0, -0.8, -2.0], [2.0, 1.2, 0.5])
        sc.add(m.Sphere(material=mat, center=m.vec3(*c),
                        radius=float(rng.uniform(0.1, 0.3))))
    sc.add(m.Sphere(material=mat, center=m.vec3(0.0, 0.0, -60.0), radius=3.0))
    sc.add(m.Plane(material=mat, center=m.vec3(0, -1, 0), width=8.0, height=8.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Plane(material=mat, center=m.vec3(2.5, -0.2, 0.5), width=0.8,
                   height=0.8, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    tilted = m.Plane(material=mat, center=m.vec3(0.3, 0.5, -1.5), width=2.0,
                     height=1.5, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0))
    tilted.rotate(θ=25, u=m.vec3(1, 1, 0))
    sc.add(tilted)
    # the NaN box and its partner straddle x = -2.75; the -0.0 box; a
    # rotated one
    sc.add(m.Cuboid(material=mat, center=m.vec3(-2.5, 0.0, 0.0), width=0.5,
                    height=0.5, length=0.5))
    sc.add(m.Cuboid(material=mat, center=m.vec3(-2.75, 0.0, -1.5), width=0.5,
                    height=0.6, length=0.4))
    sc.add(m.Cuboid(material=mat, center=m.vec3(-1.5, 1.4, 1.5), width=0.4,
                    height=0.4, length=0.4))
    box = m.Cuboid(material=mat, center=m.vec3(0.2, -0.4, 0.6), width=0.6,
                   height=0.5, length=0.4)
    box.rotate(θ=30, u=m.vec3(0, 1, 0))
    sc.add(box)
    sc.add(m.Disc(material=mat, center=m.vec3(-0.6, -0.2, 1.0), radius=0.4,
                  inner_radius=0.1, normal=m.vec3(0.2, 1, 0.3)))
    sc.add(m.Disc(material=mat, center=m.vec3(2.5, -0.2, 0.5), radius=0.5,
                  normal=m.vec3(0, 1, 0)))
    sc.add(m.Cylinder(material=mat, center=m.vec3(0.9, -0.3, 0.2), radius=0.25,
                      height=0.7, axis=m.vec3(0.1, 1, 0.2)))
    sc.add(m.Cylinder(material=mat, center=m.vec3(-1.3, -0.4, -0.6), radius=0.2,
                      height=0.6, capped=False))
    sc.add(m.Cylinder(material=mat, center=m.vec3(1.0, 0.5, -50.0), radius=1.0,
                      height=2.0, axis=m.vec3(0.3, 1, 0.1)))
    geom = compile_wavefront(sc)[1].geom
    assert analytic_sweep.kind_counts(geom) == [16, 3, 4, 2, 3]
    return geom


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def edge_rays(geom, n=N_RAYS, seed=1):
    """(O, D, groups): float32 rays, and the index range of each group of
    cases."""
    rng = np.random.default_rng(seed)
    O, D, groups = [], [], {}

    def add(name, o, d):
        a = sum(x.shape[0] for x in O)
        O.append(np.asarray(o, np.float32))
        D.append(np.asarray(d, np.float32))
        groups[name] = (a, a + O[-1].shape[0])

    k = 200
    o = rng.uniform([-3, -0.5, 2], [3, 2, 5], (k, 3))
    add("twins", o, _unit(np.array([-1.0, 0.3, 0.0]) + rng.normal(0, 0.15, (k, 3)) - o))
    o = rng.uniform([1.5, 0.5, -0.5], [3.5, 2.5, 1.5], (k, 3))
    add("plane_disc", o, _unit(np.array([2.5, -0.2, 0.5]) + rng.uniform(
        [-0.35, 0, -0.35], [0.35, 0, 0.35], (k, 3)) - o))
    # origin on the x = -2.75 slab plane of the NaN box, direction with
    # x exactly 0 (parallel to it), toward its partner (same x, nearer -z)
    lb_x = float(geom.box_lb_local[NAN_BOX - 19, 0])
    k = 24
    o = np.stack([np.full(k, lb_x), rng.uniform(-0.1, 0.1, k),
                  rng.uniform(2.0, 3.0, k)], axis=1)
    d = np.stack([np.zeros(k), rng.uniform(-0.05, 0.05, k), -np.ones(k)], axis=1)
    add("nan", o, d / np.sqrt((d * d).sum(1, keepdims=True)))
    # origin on the +x face of the zero box, running inward
    zb = ZERO_BOX - 19
    rt, lb = geom.box_rt_local[zb].numpy(), geom.box_lb_local[zb].numpy()
    o = np.stack([np.full(k, rt[0]), rng.uniform(lb[1] + 0.05, rt[1] - 0.05, k),
                  rng.uniform(lb[2] + 0.05, rt[2] - 0.05, k)], axis=1)
    add("negative_zero", o, _unit(np.array([-1.0, 0.0, 0.0])
                                  + rng.uniform(-0.3, 0.3, (k, 3)) * [0, 1, 1]))
    k = 200
    o = rng.uniform([-0.5, 0.0, -5.0], [0.5, 1.0, -4.0], (k, 3))   # past the rest
    add("far_cylinder", o, _unit(np.array([1.0, 0.5, -50.0])
                                 + rng.uniform(-1.2, 1.2, (k, 3)) - o))
    k = 100
    add("miss", rng.uniform([-3, 3, -3], [3, 4, 3], (k, 3)),
        _unit(rng.normal(0, 0.3, (k, 3)) + [0, 1, 0]))
    k = n - sum(x.shape[0] for x in O)
    o = rng.uniform([-3, -1.5, -3], [3, 2.5, 5], (k, 3))
    aim = rng.uniform([-2.5, -1.0, -2.0], [2.5, 1.2, 1.2], (k, 3)) - o
    add("random", o, _unit(np.where(rng.uniform(size=(k, 1)) < 0.2,
                                    rng.normal(size=(k, 3)), aim)))
    return (torch.from_numpy(np.concatenate(O)), torch.from_numpy(np.concatenate(D)),
            groups)


def edge_shadow(geom, O, D, seed=2):
    """(mask over the 28 objects with false bits, max_dist, where it is t): max_dist the
    ray's nearest t on every third ray that hits, random elsewhere."""
    rng = np.random.default_rng(seed)
    n_obj = sum(analytic_sweep.kind_counts(geom))
    mask = torch.from_numpy(rng.uniform(size=n_obj + 5) < 0.7)
    mask[list(TWIN)] = True
    t = isect._analytic_nearest(O, D, geom)[0]
    md = torch.from_numpy(rng.uniform(0.1, 8.0, O.shape[0]).astype(np.float32))
    equal = (t < FARAWAY) & (torch.arange(O.shape[0]) % 3 == 0)
    return mask, torch.where(equal, t, md), equal


@pytest.fixture(scope="module")
def scene():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    geom = edge_scene()
    O, D, groups = edge_rays(geom)
    yield geom, O, D, groups
    torch.set_num_threads(n)


def _block(B, monkeypatch):
    """Make the plain loop's (and so the wrapper's) blocks B objects."""
    if B is not None:
        monkeypatch.setattr(isect, "BLOCK_ELEMS", B * N_RAYS)
    return isect.object_block(N_RAYS)


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def differences(lib, geom, O, D, mask, md):
    """What W3 from `lib` and the plain loops disagree on: a list of
    names, empty when t and orient (bits), ids and occluded all agree."""
    got = analytic_sweep._nearest_launch(O, D, geom, lib=lib)
    want = isect._analytic_nearest(O, D, geom)
    bad = [name for name, a, b in zip(("t", "orient", "id"), got, want)
           if not torch.equal(_bits(a), _bits(b))]
    occ = analytic_sweep._occluded_launch(O, D, geom, mask, md, lib=lib)
    if not torch.equal(occ, isect._analytic_occluded(O, D, geom, mask, md)):
        bad.append("occluded")
    return bad


@pytest.mark.parametrize("chunk", [256, *SMALL_CHUNKS])
@pytest.mark.parametrize("B", BLOCKS, ids=lambda b: f"B{b or 'default'}")
def test_w3_equals_the_plain_loops(libs, scene, chunk, B, monkeypatch):
    geom, O, D, _ = scene
    _block(B, monkeypatch)
    mask, md, _ = edge_shadow(geom, O, D)
    n0, o0 = analytic_sweep.analytic_nearest.launches, \
        analytic_sweep.analytic_occluded.launches
    assert differences(libs[chunk], geom, O, D, mask, md) == []
    assert analytic_sweep.analytic_nearest.launches - n0 == 1
    assert analytic_sweep.analytic_occluded.launches - o0 == 1


def test_edge_scene_holds_its_cases(scene, monkeypatch):
    """The plain loops on the edge scene show each case the holds need."""
    geom, O, D, g = scene
    t, orient, obj = isect._analytic_nearest(O, D, geom)
    ends = np.cumsum(analytic_sweep.kind_counts(geom))
    kinds = set(np.searchsorted(ends, obj[t < FARAWAY].numpy(), side="right"))
    assert kinds == {0, 1, 2, 3, 4}
    assert bool((orient < 0).any()) and bool((orient > 0).any())
    sl = lambda k: slice(*g[k])
    assert bool((obj[sl("twins")] == TWIN[0]).any())
    assert not bool((obj == TWIN[1]).any())                # the tie: id 0
    assert float((obj[sl("plane_disc")] == PLANE_TIE).float().mean()) > 0.5
    assert not bool((obj[sl("plane_disc")] == DISC_TIE).any())
    tz = t[sl("negative_zero")]
    assert bool((obj[sl("negative_zero")] == ZERO_BOX).all())
    assert bool(((tz == 0) & torch.signbit(tz)).all())      # t = -0.0
    assert int((obj[sl("far_cylinder")] == FAR_CYLINDER).sum()) >= 20
    assert bool((t[sl("miss")] == FARAWAY).all())
    # the NaN box's t is NaN on its rays; its partner wins only in blocks
    # of one object
    a, b = g["nan"]
    tb, _ = isect.intersect_boxes(O[a:b], D[a:b], geom.box_basis,
                                  geom.box_lb_local, geom.box_rt_local)
    assert bool(torch.isnan(tb[NAN_BOX - 19]).all())
    assert bool((tb[NAN_BOX_PARTNER - 19] < FARAWAY).all())
    assert not bool((obj[a:b] == NAN_BOX_PARTNER).any())   # one block of boxes
    for B, partner in ((1, True), (2, False), (5, False)):
        with monkeypatch.context() as m:
            m.setattr(isect, "BLOCK_ELEMS", B * N_RAYS)
            won = isect._analytic_nearest(O, D, geom)[2][a:b] == NAN_BOX_PARTNER
        assert bool(won.all()) if partner else not bool(won.any())
    # occlusion: the strict cut at the nearest t, and the mask's false bits
    mask, md, equal = edge_shadow(geom, O, D)
    occ = isect._analytic_occluded(O, D, geom, mask, md)
    # (a NaN block's nearer objects, which the nearest hit drops, occlude)
    clean = equal.clone()
    clean[a:b] = False
    assert bool(clean.any()) and not bool(occ[clean].any())
    assert bool(occ.any()) and not bool(occ.all())
    every = torch.ones_like(mask)
    assert not torch.equal(isect._analytic_occluded(O, D, geom, every, md), occ)
    assert sum(analytic_sweep.kind_counts(geom)) > max(SMALL_CHUNKS)


def test_a_refused_launch_raises_and_counts_nothing(libs, scene):
    geom, O, D, _ = scene
    table = analytic_sweep.object_table(geom)
    t, orient = torch.empty(4), torch.empty(4)
    obj = torch.empty(4, dtype=torch.int64)
    p = analytic_sweep._p
    before = analytic_sweep.launches()
    with pytest.raises(RuntimeError, match="CUDA error"):       # B = 0
        analytic_sweep._call(libs[256], "analytic_nearest", p(table),
                             *analytic_sweep.kind_counts(geom), 0, p(O), p(D),
                             4, p(t), p(orient), p(obj), None,
                             entries=analytic_sweep.ENTRIES)
    with pytest.raises(TypeError):
        analytic_sweep._nearest_launch(O.double(), D.double(), geom, lib=libs[256])
    assert analytic_sweep.launches() == before


def occluded_case(geom, O, D, case, seed=3):
    """(D, mask, max_dist) of one of OCCLUDED_CASES on the edge scene's rays
    O (directions D):
    - uniform: one direction and one max_dist for every ray, each the
      expand of row 0 of a buffer whose other rows differ;
    - per_ray: the rays' own directions, edge_shadow's mask and max_dist;
    - no_bit / every_bit: those directions and max_dist, a mask with no
      bit / every bit set;
    - non_caster_nearer: every bit set but the twin spheres' and the
      plane that shares its place with a disc, max_dist past the scene."""
    rng = np.random.default_rng(seed)
    n = O.shape[0]
    mask, md, _ = edge_shadow(geom, O, D)
    if case == "uniform":
        buf = _unit(rng.normal(size=(n, 3))).astype(np.float32)
        buf[0] = _unit(np.array([-0.5, -0.5, -0.7]))
        md_buf = rng.uniform(0.1, 8.0, n).astype(np.float32)
        md_buf[0] = 6.0
        return (torch.from_numpy(buf)[:1].expand(n, 3), mask,
                torch.from_numpy(md_buf)[:1].expand(n))
    if case == "no_bit":
        mask = torch.zeros_like(mask)
    elif case == "every_bit":
        mask = torch.ones_like(mask)
    elif case == "non_caster_nearer":
        mask = torch.ones_like(mask)
        mask[[*TWIN, PLANE_TIE]] = False
        md = torch.full((n,), 100.0)
    return D, mask, md


def occluded_differs(lib, geom, O, D, mask, md):
    """Whether W3's occluded entry from `lib` and the plain loops disagree
    on some ray."""
    got = analytic_sweep._occluded_launch(O, D, geom, mask, md, lib=lib)
    return not torch.equal(got, isect._analytic_occluded(O, D, geom, mask, md))


@pytest.mark.parametrize("chunk", [256, *SMALL_CHUNKS])
@pytest.mark.parametrize("case", OCCLUDED_CASES)
def test_w3_occluded_equals_the_plain_loops(libs, scene, case, chunk):
    geom, O, D, _ = scene
    D, mask, md = occluded_case(geom, O, D, case)
    want = isect._analytic_occluded(O, D, geom, mask, md)
    before = analytic_sweep.analytic_occluded.launches
    assert not occluded_differs(libs[chunk], geom, O, D, mask, md)
    launched = analytic_sweep.analytic_occluded.launches - before
    assert launched == (0 if case == "no_bit" else 1)
    if case == "uniform":
        assert D.stride(0) == 0 and md.stride(0) == 0
        assert 0.05 < float(want.float().mean()) < 0.95
    if case == "no_bit":
        assert not bool(want.any())
    if case == "non_caster_nearer":
        # rays whose nearest object casts no shadow and that a casting
        # object behind it occludes
        t, _, obj = isect._analytic_nearest(O, D, geom)
        assert int(((t < FARAWAY) & ~mask[obj] & want).sum()) > 20


def test_casting_tables_hold_the_casting_rows_in_id_order(scene):
    geom = scene[0]
    mask = torch.zeros(40, dtype=torch.bool)
    mask[[3, 1, 17, 20, 21, 27]] = True
    rows, counts = analytic_sweep.casting_tables(geom, mask)
    assert counts == [2, 1, 2, 0, 1]
    table = analytic_sweep.scene_tables(geom)
    assert torch.equal(rows, table[[1, 3, 17, 20, 21, 27]])
    assert analytic_sweep.casting_tables(geom, mask)[0] is rows     # kept
    mask[5] = True                              # in place: a new version
    assert analytic_sweep.casting_tables(geom, mask)[1] == [3, 1, 2, 0, 1]
    with pytest.raises(ValueError):
        analytic_sweep.casting_tables(geom, mask[:10])


def _mutant(tmp_path, name, edits):
    text = (CSRC / "analytic_sweep.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return build(tmp_path / f"{name}.so", source=text)


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w3_fails(mutant, scene, tmp_path, monkeypatch):
    geom, O, D, _ = scene
    lib = _mutant(tmp_path, mutant, MUTANTS[mutant])
    mask, md, _ = edge_shadow(geom, O, D)
    caught = []
    for B in BLOCKS:
        with monkeypatch.context() as m:
            if B is not None:
                m.setattr(isect, "BLOCK_ELEMS", B * N_RAYS)
            if differences(lib, geom, O, D, mask, md):
                caught.append(B)
    assert caught, f"no case catches the mutant {mutant}"


@pytest.mark.parametrize("mutant", list(OCCLUDED_MUTANTS))
def test_an_occluded_mutant_fails(mutant, libs, scene, tmp_path, monkeypatch):
    geom, O, D, _ = scene
    edits = OCCLUDED_MUTANTS[mutant]
    lib = libs[256]
    if edits[0] == "wrapper":
        src = inspect.getsource(analytic_sweep.casting_tables)
        for old, new in edits[1]:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
        space = dict(vars(analytic_sweep))
        exec(src, space)
        monkeypatch.setattr(analytic_sweep, "casting_tables",
                            space["casting_tables"])
    else:
        lib = _mutant(tmp_path, mutant, edits)
    caught = [case for case in OCCLUDED_CASES
              if occluded_differs(lib, geom, O, *occluded_case(geom, O, D, case))]
    assert caught, f"no case catches the mutant {mutant}"


def test_the_plane_signed_t_mutant_is_equivalent(scene, tmp_path):
    """The plane test returning t for |t| gives the same bits: where the
    test returns t, ndco * ndd > 0, so t = ndco / ndd is positive, +0 or
    +inf.  Held on every ray of the edge scene, the planes' grazing and
    parallel rays included."""
    geom, O, D, _ = scene
    lib = _mutant(tmp_path, "plane_signed_t", PLANE_SIGNED_T)
    mask, md, _ = edge_shadow(geom, O, D)
    assert differences(lib, geom, O, D, mask, md) == []
    # the extremes: t underflows to +0, overflows to +inf
    ndco = torch.tensor([1e-30, -1e-30, 3e38, -3e38], dtype=torch.float32)
    ndd = torch.tensor([1e20, -1e20, 1e-3, -1e-3], dtype=torch.float32)
    t = ndco / ndd
    assert bool((ndco * ndd > 0).all())
    assert torch.equal(_bits(torch.abs(t)), _bits(t))
