"""W5, the wavefront's hit attributes, run on the CPU through the stand-in
CUDA runtime.

g++ compiles csrc/hit_attrs.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h with W5_TORCH_CPU (the source then restates
torch's CPU sum of three and takes atan2 and asin through float64) into a
library of its own, which ops/hit_attrs.py `_kernel_attributes` takes as
`lib=` with CPU tensors.  Its output is held against the plain stage
(`plain_attributes`), every field of every ray: floats equal or both
NaN, integers and bools equal.  Torch's CPU sqrt, atan2 and asin are not
correctly rounded (sqrt is off by an ulp on ~0.7% of lanes), so the plain
stage runs here with those ops through float64, rounded once
(`exact_math`), as W5_TORCH_CPU computes them: the holds are then exact.
Beside them, `test_w5_uv_within_ulps_of_torchs_own_math` holds W5
against the plain stage under torch's own CPU atan2 and asin (the root
still through float64): uv within ULPS units in the last place, every
other field exact.

The inputs: every attribute call of 16x16 renders of ten scenes (the
98-object grid, Cornell and the primitives and shapes scenes on the
wavefront, the icosphere, the beach ball's smooth normals and corner
uvs, a field of instances, the normal-mapped scene with nearest and with
bilinear maps, three normal-mapped mesh instances beside a mapped
plane), each held as captured, with uv forced, and as the first-hit
pass; the normal maps' cases (`map_inputs`: every basis kind, nearest
and bilinear, repeat other than 1, two refs on one object, where the
last must win, a map of quarter steps whose texels of 0.5 give zero
products, misses on the mapped object 0 at their far uv, NaN and
overflowing distances); and an edge scene
of every kind (two spheres, a plane, an axis-aligned box at the origin,
a disc, a capped cylinder, two triangles) with rays placed on its cases:
a box hit at its centre whose local coordinates are all -0 (torch.sign
of -0 is +0), on an edge and a corner where faces tie, a cylinder hit
where the cap and the side tie, every object id next to the ids of the
other kinds, misses (object 0 at t = FARAWAY), NaN distances and random
hits.  Each source mutation of MUTANTS makes some case fail; they build
in parallel in one fixture.  A render through W5 equals the plain
render, and the inverse-rendering gradient through `_Attrs` (W5 forward
and backward kernels) equals the plain stage's, two passes equal; so
does the gradient of a normal-mapped render (the backward's plain route
for a table the maps read) with respect to its map's texture and its
floor's u axis.  The maps' 3 x 3 product is MKL's here,
which sums a row as W5's `mm3` does from 11 rows on (every input here
has more); `test_w5_mm3_is_torchs_product` holds it.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DW5_TORCH_CPU -I raytracer_tpu_torch/csrc/emu \\
        -I raytracer_tpu_torch/csrc -x c++ \\
        raytracer_tpu_torch/csrc/hit_attrs.cu -o build/w5_emu.so
"""

import contextlib
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.compile import KINDS, compile_wavefront
from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import hit_attrs as ha
from raytracer_tpu_torch.utils.constants import FARAWAY

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT / "examples"))
import torch_cornellbox  # noqa: E402
import torch_features  # noqa: E402
import torch_inverse_rendering  # noqa: E402
import torch_mesh  # noqa: E402
import torch_primitives  # noqa: E402
import torch_wavefront  # noqa: E402

GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread", "-DW5_TORCH_CPU")
W, H = 16, 16
ULPS = 4
NEVER = T.RenderSettings(use_pallas="never")
FIELDS = ha.FLOAT_FIELDS + ha.OTHER_FIELDS
# (force_uv, first_hit) of each hold of a call: as called, uv forced, the
# first-hit pass
MODES = ((False, False), (True, False), (True, True))
# the maps' choice of ref, as csrc/hit_attrs.cu writes it
WINNER = ("    int r = (int)S.n_maps - 1;\n"
          "    while (r >= 0 && !map_holds(S, r, o, tri_off, slot)) --r;\n"
          "    if (r >= 0) map_normal(S, r, o, tri_off, uv, N);")
MUTANTS = {
    # the plain dot products contracted
    "contracted_dot": [("  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];",
                        "  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));")],
    # safemath.div taken as a product with the divisor's reciprocal
    "reciprocal_div": [("  uv[0] = (phi + PI_F) / TWO_PI_F;",
                        "  uv[0] = (phi + PI_F) * (1.0f / TWO_PI_F);")],
    # torch.sign keeping the sign of -0 (torch gives +0)
    "sign_negative_zero": [("  return (float)((0.0f < x) - (x < 0.0f));",
                            "  return copysignf((float)((0.0f < x) - (x < 0.0f)), x);")],
    # a miss written as zeros, not object 0's attributes
    "miss_zeroed": [("  if (!zeroed) geometric(S, P, o, R.need_uv != 0, N, uv);",
                     "  if (!zeroed && !miss) geometric(S, P, o, R.need_uv != 0, N, uv);")],
    # a cylinder's cap / side tie given to the side
    "cap_tie": [("fabsf(y) / hh >= rho / r", "fabsf(y) / hh > rho / r")],
    # the first ref whose mask holds winning (the plain stage's last wins)
    "first_ref_wins": [(WINNER, "    int r = 0;\n"
                        "    while (r < (int)S.n_maps && !map_holds(S, r, o, tri_off, slot)) ++r;\n"
                        "    if (r < (int)S.n_maps) map_normal(S, r, o, tri_off, uv, N);")],
    # every ref whose mask holds applied in turn, each from the running
    # normal (the plain stage maps the geometric one)
    "running_normal": [(WINNER, "    for (int r = 0; r < (int)S.n_maps; ++r)\n"
                        "      if (map_holds(S, r, o, tri_off, slot)) "
                        "map_normal(S, r, o, tri_off, uv, N);")],
    # the mapped normal not renormalised
    "no_renormalise": [("  unit3(v);\n  for (int c = 0; c < 3; ++c) N[c] = v[c];",
                        "  for (int c = 0; c < 3; ++c) N[c] = v[c];")],
    # the 3 x 3 product unfused
    "unfused_mm3": [("fmaf(a[2], M[6 + c], fmaf(a[1], M[3 + c], fmaf(a[0], M[c], 0.0f)))",
                     "(a[0] * M[c] + a[1] * M[3 + c]) + a[2] * M[6 + c]")],
}


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W5 for the CPU")
    return gxx


def _source(edits=()):
    """The source with its texture fetch (csrc/texture_fetch.cuh) written
    in, so that a mutant may edit either, with `edits` made."""
    text = (CSRC / "hit_attrs.cu").read_text().replace(
        '#include "texture_fetch.cuh"\n',
        (CSRC / "texture_fetch.cuh").read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: W5 ("w5") and each mutant of MUTANTS, g++ builds
    against the stand-in runtime, all started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w5emu")
    procs = {}
    for name, edits in [("w5", ())] + list(MUTANTS.items()):
        src = d / f"{name}.cu"
        src.write_text(_source(edits))
        procs[name] = subprocess.Popen(
            [gxx, *GXX_FLAGS, "-I", str(CSRC / "emu"), "-x", "c++", str(src),
             "-o", str(d / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log.decode()[-3000:]
        out[name] = ctypes.CDLL(str(d / f"{name}.so"))
    return out


def _f64(fn):
    def g(*args, **kw):
        return fn(*(a.double() if isinstance(a, torch.Tensor) else a
                    for a in args), **kw).float()
    return g


@contextlib.contextmanager
def exact_math(names=("sqrt", "atan2", "asin")):
    """torch.sqrt, atan2 and asin (or those named) through float64, rounded
    once to float32 (as W5_TORCH_CPU computes them; its sqrtf is correctly
    rounded)."""
    saved = {k: getattr(torch, k) for k in names}
    for k in names:
        setattr(torch, k, _f64(saved[k]))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch, k, v)


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------


def _scenes(obj_dir):
    def never(sc):
        sc.settings = NEVER
        return sc
    return {
        "grid": lambda: torch_wavefront.grid(96, W, H),
        "cornell": lambda: never(torch_cornellbox.build_cornell(W, H)),
        "primitives": lambda: never(torch_primitives.primitives(W, H)),
        "shapes": lambda: never(torch_primitives.shapes(W, H)),
        "icosphere": lambda: torch_mesh.icosphere(W, H, subdiv=2, obj_dir=obj_dir),
        "beach_ball": lambda: torch_mesh.beach_ball(W, H, obj_dir=obj_dir),
        "instances": lambda: torch_mesh.instances(W, H, count=6, subdiv=1,
                                                  obj_dir=obj_dir),
        "normal_mapped": lambda: torch_features.normal_mapped(W, H,
                                                              obj_dir=obj_dir),
        "normal_mapped_bilinear": lambda: torch_features.normal_mapped(
            W, H, obj_dir=obj_dir, filter="bilinear"),
        "instanced_mapped": lambda: torch_features.instanced_mapped(
            W, H, obj_dir=obj_dir),
    }


SCENES = ("grid", "cornell", "primitives", "shapes", "icosphere", "beach_ball",
          "instances", "normal_mapped", "normal_mapped_bilinear",
          "instanced_mapped")


@contextlib.contextmanager
def stage_replaced(make):
    """trace's and the first-hit pass's `hit_attrs.attributes` replaced by
    make(real)."""
    real = ha.attributes
    ha.attributes = make(real)
    try:
        yield
    finally:
        ha.attributes = real


def capture(sc, seed=3):
    """[(args, kwargs)] of every attribute call of a 1-spp render of sc on
    the CPU."""
    calls = []

    def spy(real):
        def f(*args, **kw):
            calls.append((args, kw))
            return real(*args, **kw)
        return f

    with stage_replaced(spy):
        sc.render(samples_per_pixel=1, device="cpu", seed=seed, output="linear")
    return calls


def edge_scene(m=T):
    """Every kind, textured (uv sampled): two spheres, a plane, an
    axis-aligned 2 x 2 x 2 box at the origin, an annulus, a capped
    y-axis cylinder of radius 1 and height 2, two triangles."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0.5, 6), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    tex = m.image(np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3))
    mat = m.Diffuse(diff_color=tex)
    sc.add(m.Sphere(material=mat, center=m.vec3(-2.5, 0.3, 0), radius=0.5))
    sc.add(m.Sphere(material=mat, center=m.vec3(2.5, 1.5, -1), radius=0.7))
    sc.add(m.Plane(material=mat, center=m.vec3(0, -1.5, 0), width=8.0, height=6.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   uv_shift=(0.25, 0.1)))
    sc.add(m.Cuboid(material=mat, center=m.vec3(0, 0, 0), width=2.0, height=2.0,
                    length=2.0))
    sc.add(m.Disc(material=mat, center=m.vec3(2.0, -0.5, 1.0), radius=0.5,
                  inner_radius=0.1, normal=m.vec3(0.2, 1, 0.3)))
    sc.add(m.Cylinder(material=mat, center=m.vec3(0, 0, -4), radius=1.0,
                      height=2.0, axis=m.vec3(0, 1, 0)))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0.3, -0.5),
                      p1=m.vec3(-0.5, 2.0, -0.4), p2=m.vec3(0.4, 2.2, -0.6),
                      p3=m.vec3(0.0, 2.8, -0.5)))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0.3, -0.5),
                      p1=m.vec3(0.5, 2.9, -1.0), p2=m.vec3(-0.5, 3.0, -0.9),
                      p3=m.vec3(0.0, 2.3, -1.1)))
    return sc


def edge_inputs():
    """(static, data, rays, labels): the edge scene's tables and rays
    (O, D, t, orient, obj) placed on its cases (see the module doc), each
    labelled; a ray whose hit point is placed has D = 0 (or -0) and t = 1,
    so that P = O + D t is O exactly."""
    static, data = compile_wavefront(edge_scene())
    g = data.geom
    counts = static.kind_counts
    off = {}
    at = 0
    for k in ("sphere", "plane", "box", "disc", "cyl", "tri"):
        off[k] = at
        at += counts[k]
    rows = []       # (O, D, t, obj, label)
    z, nz = [0.0, 0.0, 0.0], [-0.0, -0.0, -0.0]
    # the box's centre, local coordinates -0 (the box is at the origin)
    rows.append((nz, nz, 1.0, off["box"], "box -0"))
    whl = g.box_whl[0].tolist()
    # an edge and a corner: faces tie
    rows.append(([whl[0] / 2, whl[1] / 2, 0.1 * whl[2]], z, 1.0, off["box"], "box edge"))
    rows.append(([-whl[0] / 2, whl[1] / 2, -whl[2] / 2], z, 1.0, off["box"],
                 "box corner"))
    # the cylinder: cap and side tie (|y| / half_h == rho / r)
    c, ax = g.cyl_center[0], g.cyl_axis[0]
    ua, r, hh = g.cyl_u_axis[0], float(g.cyl_radius[0]), float(g.cyl_half_h[0])
    rows.append(((c + ax * hh + ua * r).tolist(), z, 1.0, off["cyl"], "cylinder tie"))
    rows.append(((c - ax * hh * 0.5 + ua * r).tolist(), z, 1.0, off["cyl"],
                 "cylinder side"))
    # every object id, next to the other kinds' ids, at points near them
    rng = np.random.default_rng(4)
    for o in list(range(at)) + list(range(at - 1, -1, -1)):
        rows.append((rng.uniform(-2, 2, 3).tolist(), rng.normal(size=3).tolist(),
                     float(rng.uniform(0.1, 2.0)), o, "boundary"))
    # misses: object 0 at t = FARAWAY
    for _ in range(8):
        d = rng.normal(size=3)
        rows.append((rng.uniform(-2, 2, 3).tolist(), (d / np.linalg.norm(d)).tolist(),
                     FARAWAY, 0, "miss"))
    # NaN distances
    for o in range(at):
        rows.append(([0.1, 0.2, 0.3], [0.3, -0.2, 0.9], float("nan"), o, "nan"))
    O = torch.tensor([r[0] for r in rows], dtype=torch.float32)
    D = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    t = torch.tensor([r[2] for r in rows], dtype=torch.float32)
    obj = torch.tensor([r[3] for r in rows], dtype=torch.int64)
    orient = torch.from_numpy(np.where(rng.random(len(rows)) < 0.5, 1.0, -1.0)
                              .astype(np.float32))
    # random rays and their real nearest hits
    n = 2048
    Or = torch.from_numpy(rng.uniform([-3, -2, -5], [3, 3, 6], (n, 3)).astype(np.float32))
    aim = torch.from_numpy(rng.uniform([-3, -1.5, -5], [3, 3, 1.5], (n, 3))
                           .astype(np.float32)) - Or
    # a quarter aimed at the disc from above it
    q = n // 4
    Or[:q] = torch.from_numpy(rng.uniform([0, 1, -1], [4, 3, 3], (q, 3))
                              .astype(np.float32))
    aim[:q] = g.disc_center[0] + torch.from_numpy(
        rng.uniform(-0.5, 0.5, (q, 3)).astype(np.float32)) - Or[:q]
    Dr = aim / torch.linalg.vector_norm(aim, dim=-1, keepdim=True)
    tr, orr, objr = isect.nearest_hit(Or, Dr, g)
    labels = [r[4] for r in rows] + ["random"] * n
    rays = (torch.cat([O, Or]), torch.cat([D, Dr]), torch.cat([t, tr]),
            torch.cat([orient, orr]), torch.cat([obj, objr]))
    return static, data, rays, labels


def map_inputs(obj_dir):
    """(static, data, rays, labels): the normal-mapped scene (16x16; object
    0 its mapped sphere; its box and floor rotated off the axes) with a
    second texture, a map of quarter steps
    whose texels of exactly 0.5 decode to m = 0, and three more refs on
    it: a box ref before the scene's own (which, last, wins), a bilinear
    sphere ref at repeat 3 and a bilinear mesh ref at repeat 0.5 on the
    scene's map slot after theirs (which win); the plane keeps its own
    nearest map at repeat 4.  The rays: seeded rays from around the camera
    aimed into the scene, their real nearest hits (misses are object 0 at
    t = FARAWAY, so the mapped sphere's map at the miss's uv); object 0 at
    FARAWAY along more directions, at a NaN distance and at 1e38 (P
    overflows)."""
    sc = torch_features.normal_mapped(W, H, obj_dir=obj_dir)
    for p in sc.scene_primitives:
        # bases off the axes, whose products all round (an axis-aligned
        # basis makes a fused and an unfused 3 x 3 product agree)
        if isinstance(p, (T.Cuboid, T.Plane)):
            p.rotate(theta=25.0 if isinstance(p, T.Cuboid) else 6.0,
                     axis=T.vec3(0.3, 1.0, 0.2) if isinstance(p, T.Cuboid)
                     else T.vec3(1.0, 0.0, 0.5))
    static, data = compile_wavefront(sc)
    rng = np.random.default_rng(12)
    steps = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (8, 8, 3))
    tex = len(data.textures)
    data = dataclasses.replace(data, textures=(*data.textures,
                                               torch.from_numpy(steps)))
    ref = {r.basis_kind: r for r in static.normal_maps}
    again = lambda k, **kw: dataclasses.replace(ref[k], tex=tex, **kw)
    static = dataclasses.replace(static, normal_maps=(
        again("box", repeat=1.0), *static.normal_maps,
        again("sphere", repeat=3.0, bilinear=True),
        again("tri", repeat=0.5, bilinear=True)))
    n = 4096
    O = torch.from_numpy((np.array([0.0, 1.2, 4.0]) + rng.uniform(-0.5, 0.5, (n, 3)))
                         .astype(np.float32))
    aim = torch.from_numpy(rng.uniform([-2.5, -0.7, -2.5], [2.5, 1.2, 1.0], (n, 3))
                           .astype(np.float32)) - O
    D = aim / torch.linalg.vector_norm(aim, dim=-1, keepdim=True)
    t, orient, obj = isect.nearest_hit(O, D, data.geom)
    labels = np.where(t.numpy() >= 1e29, "miss", "random").tolist()
    k = 64
    Dm = torch.from_numpy(rng.normal(size=(k, 3)).astype(np.float32))
    Dm = Dm / torch.linalg.vector_norm(Dm, dim=-1, keepdim=True)
    far = torch.cat([torch.full((k - 8,), FARAWAY), torch.full((4,), float("nan")),
                     torch.full((4,), 1e38)])
    labels += ["miss"] * (k - 8) + ["nan"] * 4 + ["overflow"] * 4
    rays = (torch.cat([O, O[:k]]), torch.cat([D, Dm]), torch.cat([t, far]),
            torch.cat([orient, torch.ones(k)]),
            torch.cat([obj, torch.zeros(k, dtype=obj.dtype)]))
    return static, data, rays, labels


def map_winners(obj, data, static):
    """(rays, refs) bool: where each ref's mask holds (the plain stage's)."""
    tri_off = sum(static.kind_counts[k] for k in KINDS if k != "tri")
    slot = data.geom.tri_nm_slot[torch.clamp(obj - tri_off, 0,
                                             data.geom.tri_nm_slot.shape[0] - 1)]
    return torch.stack([(obj >= tri_off) & (slot == r.local_id)
                        if r.basis_kind == "tri" else obj == r.obj
                        for r in static.normal_maps], -1)


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """{scene: [the positional arguments of each attribute call]}, the
    renders made once with one torch thread; "edge": the edge inputs;
    "maps": the normal maps' cases."""
    obj_dir = tmp_path_factory.mktemp("obj")
    with one_thread():
        out = {name: [a for a, _ in capture(make())]
               for name, make in _scenes(obj_dir).items()}
    static, data, rays, _ = edge_inputs()
    out["edge"] = [(*rays, data, static, T.RenderSettings())]
    static, data, rays, _ = map_inputs(obj_dir)
    out["maps"] = [(*rays, data, static, T.RenderSettings())]
    return out


def field_differences(got, want):
    """{field: rays that differ}: integers and bools unequal, floats of
    other bits (+0 and -0 differ) and not both NaN."""
    bad = {}
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.is_floating_point():
            same = (a.view(torch.int32) == b.view(torch.int32)) | (
                torch.isnan(a) & torch.isnan(b))
        else:
            same = a == b
        rows = int((~same).reshape(same.shape[0], -1).any(-1).sum())
        if rows:
            bad[f] = rows
    return bad


def differences(args_list, lib, first=False, math=exact_math):
    """[(call, mode, {field: rays})] where W5 from lib and the plain stage
    disagree (only the first if `first`)."""
    out = []
    for k, args in enumerate(args_list):
        for force_uv, first_hit in MODES:
            with math():
                want = ha.plain_attributes(*args, force_uv=force_uv,
                                           first_hit=first_hit)
                got = ha._kernel_attributes(*args, force_uv=force_uv,
                                            first_hit=first_hit, lib=lib)
            bad = field_differences(got, want)
            if bad:
                out.append((k, (force_uv, first_hit), bad))
                if first:
                    return out
    return out


# ---------------------------------------------------------------------------
# the holds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", SCENES + ("edge", "maps"))
def test_w5_equals_the_plain_stage(libs, calls, scene):
    before = ha.launches()
    with one_thread():
        assert differences(calls[scene], libs["w5"]) == []
    assert ha.launches() - before == len(calls[scene]) * len(MODES)


def test_the_scenes_hold_their_cases(calls):
    """Each input drives what it is held for."""
    kinds = lambda name: {k for k, c in calls[name][0][6].kind_counts.items() if c}
    assert {"sphere", "plane", "box"} <= kinds("cornell")
    assert {"plane", "disc", "cyl"} <= kinds("primitives")
    assert "tri" in kinds("shapes")
    assert calls["beach_ball"][0][6].tri_interp
    inst = calls["instances"][0][5].geom
    assert inst.tri_virt_row.shape[0] > 0 and inst.inst_rot.shape[0] > 1
    assert calls["normal_mapped"][0][6].normal_maps
    assert not calls["grid"][0][6].needs_uv and calls["primitives"][0][6].needs_uv
    # misses (object 0's attributes at t = FARAWAY) in the open scenes
    missed = {s for s in SCENES if any(bool((a[2] >= 1e29).any()) for a in calls[s])}
    assert len(missed) >= 3, missed
    static, data, rays, labels = edge_inputs()
    O, D, t, orient, obj = rays
    g = data.geom
    lab = np.asarray(labels)
    with exact_math():
        P = O + D * t[:, None]
        # the box centre: every local coordinate -0
        k = int(np.flatnonzero(lab == "box -0")[0])
        M = P[k] - g.box_center[0]
        Pl = torch.stack([g.box_basis[0, i, 0] * M[0] + g.box_basis[0, i, 1] * M[1]
                          + g.box_basis[0, i, 2] * M[2] for i in range(3)])
        assert bool((Pl == 0).all()) and bool(torch.signbit(Pl).all())
        # the edge and the corner: two and three faces
        got = ha.plain_attributes(*rays, data, static, T.RenderSettings())
        for name, faces in (("box edge", 2), ("box corner", 3)):
            k = int(np.flatnonzero(lab == name)[0])
            assert int((got.N[k] * orient[k] != 0).sum()) == faces, name
        # the cylinder's tie, and its side
        for name, tie in (("cylinder tie", True), ("cylinder side", False)):
            k = int(np.flatnonzero(lab == name)[0])
            M = P[k] - g.cyl_center[0]
            dot = lambda a: (a[0] * M[0] + a[1] * M[1]) + a[2] * M[2]
            x, y, zz = dot(g.cyl_u_axis[0]), dot(g.cyl_axis[0]), dot(g.cyl_v_axis[0])
            rho = torch.sqrt(torch.clamp_min(x * x + zz * zz, 1e-20))
            assert bool(torch.abs(y) / g.cyl_half_h[0] == rho / g.cyl_radius[0]) == tie
    # every kind among the boundary rays and the random hits
    ids = obj[lab == "boundary"]
    assert sorted(set(ids.tolist())) == list(range(static.n_objects))
    hit = t < 1e29
    assert all(int(((obj >= a) & (obj < a + c) & hit).sum()) > 10 for a, c in
               _offsets(static))
    assert int((lab == "miss").sum()) and int((lab == "nan").sum())


def test_the_map_inputs_hold_their_cases(tmp_path):
    """The maps' cases: rays won by a ref of every basis kind, with both
    filters and repeats other than 1, rays where two refs hold (the last
    must win) under either order, texels of 0.5 (m = 0), misses on the
    mapped object 0 whose normal the map moves, NaN and overflowing
    distances; instanced mesh refs in "instanced_mapped"."""
    static, data, rays, labels = map_inputs(tmp_path)
    O, D, t, orient, obj = rays
    lab = np.asarray(labels)
    held = map_winners(obj, data, static)
    refs = static.normal_maps
    last = torch.where(held, torch.arange(len(refs)), -1).amax(-1)
    won = {refs[int(i)] for i in last[last >= 0]}
    assert {r.basis_kind for r in won} == {"sphere", "plane", "box", "tri"}
    assert {r.bilinear for r in won} == {False, True}
    assert {r.repeat for r in won} - {1.0}
    two = held.sum(-1) >= 2
    assert int(two.sum()) > 100
    # the box's later ref wins, the sphere's and the mesh's earlier lose
    assert {refs[int(i)].tex for i in last[two]} == {0, len(data.textures) - 1}
    assert bool((data.textures[-1] == 0.5).any())
    with exact_math():
        got = ha.plain_attributes(*rays, data, static, T.RenderSettings())
        bare = ha.plain_attributes(*rays, data, dataclasses.replace(
            static, normal_maps=()), T.RenderSettings())
    miss = torch.from_numpy(lab == "miss")
    assert int(miss.sum()) > 50 and bool((obj[miss] == 0).all())
    moved = ~(got.N == bare.N).all(-1)
    assert int((moved & miss).sum()) > 10 and int((moved & ~miss).sum()) > 1000
    assert int((lab == "nan").sum()) and int((lab == "overflow").sum())
    g = compile_wavefront(torch_features.instanced_mapped(W, H, obj_dir=tmp_path))
    assert g[1].geom.tri_virt_row.shape[0] and any(
        r.basis_kind == "tri" for r in g[0].normal_maps)


def test_w5_mm3_is_torchs_product(libs):
    """W5's 3 x 3 product (`hit_attrs_math` op 2) against torch's (N, 3) @
    (3, 3) here, both layouts of the (3, 3) operand, on rows with signed
    zeros, and its backward into the left factor (op 4) against autograd's:
    bit for bit from 11 rows on."""
    rng = np.random.default_rng(3)
    for n in (11, 17, 256, 4096):
        m = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        zero = rng.random((n, 3)) < 0.3
        m = np.where(zero, np.where(rng.random((n, 3)) < 0.5, -0.0, 0.0), m)
        a = torch.from_numpy(m.astype(np.float32)) * 2.0
        B = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
        B[0, 1], B[1, 2] = 0.0, -0.0
        with one_thread():
            for M in (B, B.T.contiguous().T):
                want = a @ M
                got = ha.math("mm3", a, M, lib=libs["w5"])
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n
                # the backward into the left factor (the maps' backward)
                g = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
                x = a.clone().requires_grad_()
                ga, = torch.autograd.grad(x @ M, x, g)
                got = ha.math("mm3_bwd", g, M, lib=libs["w5"])
                assert torch.equal(got.view(torch.int32), ga.view(torch.int32)), n


def _offsets(static):
    out, at = [], 0
    for k in ("sphere", "plane", "box", "disc", "cyl", "tri"):
        c = static.kind_counts[k]
        out.append((at, c))
        at += c
    return out


def test_w5_uv_within_ulps_of_torchs_own_math(libs, calls):
    """W5 against the plain stage under torch's own CPU atan2 and asin
    (its sqrt correctly rounded), uv forced: uv within ULPS units in the
    last place of 1.0 (uv's scale; an ulp of atan2 near -pi is many of
    its own past phi + pi) where finite, every other field exact."""
    held = moved = 0
    with one_thread():
        for scene in ("cornell", "primitives", "edge"):
            for args in calls[scene]:
                with exact_math(("sqrt",)):
                    want = ha.plain_attributes(*args, force_uv=True)
                    got = ha._kernel_attributes(*args, force_uv=True,
                                                lib=libs["w5"])
                bad = field_differences(got, want)
                assert set(bad) <= {"uv"}, (scene, bad)
                ok = torch.isfinite(want.uv)
                d = (got.uv[ok] - want.uv[ok]).abs()
                assert d.numel() == 0 or float(d.max()) <= ULPS * 2.0 ** -23, scene
                moved += int((d > 0).sum())
                held += int(ok.sum())
    assert held > 5000 and moved > 0


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w5_fails(libs, calls, mutant):
    with one_thread():
        caught = next((s for s in ("edge", "maps") + SCENES
                       if differences(calls[s], libs[mutant], first=True)), None)
    assert caught, f"no case catches the mutant {mutant}"


def test_a_refused_launch_raises_and_counts_nothing(libs, calls):
    before = ha.launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ha._call(libs["w5"], "hit_attrs", ctypes.byref(ha.Scene()),
                 ctypes.byref(ha.Rays()), None, entries=ha.ENTRIES)
    args = calls["cornell"][0]
    with pytest.raises(TypeError):       # float64 rays
        ha._kernel_attributes(args[0].double(), *args[1:], lib=libs["w5"])
    with pytest.raises(TypeError):       # int32 object ids
        ha._kernel_attributes(*args[:4], args[4].int(), *args[5:], lib=libs["w5"])
    assert ha.launches() == before


def test_the_stage_runs_the_plain_version_on_cpu_tensors(calls):
    """On CPU tensors `attributes` is the plain stage itself, and launches
    nothing."""
    before = ha.launches()
    for args in calls["cornell"] + calls["normal_mapped"]:
        assert field_differences(ha.attributes(*args),
                                 ha.plain_attributes(*args)) == {}
    assert ha.launches() == before


def test_the_scene_struct_is_kept_per_geometry(calls):
    static, data = calls["edge"][0][6], calls["edge"][0][5]
    struct, keep = ha.scene_struct(data, static)
    table = keep[0]
    assert table.shape == (sum(c for _, c in _offsets(static)[:-1]), ha.ROW)
    # the box row: (basis row i, whl[i]) for i = 0, 1, 2, then its centre
    b = _offsets(static)[2][0]
    g = data.geom
    assert torch.equal(table[b, 0:3], g.box_basis[0, 0])
    assert float(table[b, 3]) == float(g.box_whl[0, 0])
    assert torch.equal(table[b, 12:15], g.box_center[0])
    assert ha.scene_struct(data, static)[0] is struct
    with torch.no_grad():
        data.geom.box_center.add_(0.0)      # a new version: made again
    assert ha.scene_struct(data, static)[0] is not struct


# ---------------------------------------------------------------------------
# routing and autograd through the emu library
# ---------------------------------------------------------------------------


def routed(lib):
    """The stage sent to `lib` on CPU tensors."""
    def route(real):
        def f(*args, **kw):
            return ha._kernel_attributes(*args, **kw, lib=lib)
        return f
    return stage_replaced(route)


@pytest.mark.parametrize("scene", ["cornell", "normal_mapped"])
def test_a_render_through_w5_equals_the_plain_render(libs, scene, tmp_path):
    make = _scenes(tmp_path)[scene]
    with one_thread(), exact_math():
        want = make().render(samples_per_pixel=2, device="cpu", seed=5,
                             output="linear")
        before = ha.launches()
        with routed(libs["w5"]):
            got = make().render(samples_per_pixel=2, device="cpu", seed=5,
                                output="linear")
        launched = ha.launches() - before
    assert launched > 0
    assert (got == want).all()


def test_the_first_hit_pass_through_w5_is_the_plain_ones(libs):
    """Scene.first_hit (the AOV pass's `_first_hit_impl`) through W5:
    every field equal to the plain pass's, misses zero."""
    sc = edge_scene()
    rng = np.random.default_rng(9)
    O = rng.uniform([-3, -2, -5], [3, 3, 6], (512, 3)).astype(np.float32)
    D = rng.normal(size=(512, 3)).astype(np.float32)
    ray = T.Ray(O, D / np.linalg.norm(D, axis=1, keepdims=True))
    with one_thread(), exact_math():
        want = T.first_hit(ray, sc, device="cpu")
        before = ha.launches()
        with routed(libs["w5"]):
            got = T.first_hit(ray, sc, device="cpu")
        assert ha.launches() - before == 1
    miss = want.distance >= 1e29
    assert 0 < int(miss.sum()) < 512
    for f in ("distance", "orientation", "point", "normal", "uv", "obj_id"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool((want.normal[miss] == 0).all())


def _gradient(lib=None, seed=0):
    from raytracer_tpu_torch.diff import differentiable_render

    # 4x4 x 32 spp at split_k 3: two chunks of 128 paths a pixel, each
    # under torch.utils.checkpoint
    sc = torch_inverse_rendering.build_scene(1.3, 4, 4)
    fn, data = differentiable_render(sc, 32, seed=seed, device="cpu")
    x = data.mats.refr_n_re.clone().requires_grad_()
    with exact_math(), (routed(lib) if lib else contextlib.nullcontext()):
        loss = (fn(dataclasses.replace(data, mats=dataclasses.replace(
            data.mats, refr_n_re=x))) ** 2).mean()
        g, = torch.autograd.grad(loss, x)
    return loss.detach(), g


def _map_gradient(tmp, lib=None):
    from raytracer_tpu_torch.diff import differentiable_render

    # 8x8 x 2 spp of the normal-mapped scene, one chunk under
    # torch.utils.checkpoint, with its lamp first, every mapped surface
    # diffuse and two bounces: its gradient finite (a miss maps object 0's
    # normal at t = 10^30, whose sphere frame overflows, and the glossy
    # blocks and third bounces give infinite gradients that the maps'
    # normalisations turn into NaN, plain or not)
    sc = torch_features.normal_mapped(8, 8, obj_dir=tmp)
    sc.scene_primitives.insert(0, sc.scene_primitives.pop())
    nm = torch_features.bump_normalmap()
    for p, repeat in zip(sc.scene_primitives[1:], (4.0, 1.0, 2.0, 1.0)):
        p.material = T.Diffuse(diff_color=T.rgb(0.5, 0.5, 0.5), diffuse_rays=1)
        p.material.set_normalmap(nm, repeat=repeat)
    sc.settings = T.RenderSettings(max_bounces=2)
    fn, data = differentiable_render(sc, 2, seed=1, device="cpu")
    tex = data.textures[0].clone().requires_grad_()
    axis = data.geom.plane_u_axis.clone().requires_grad_()
    d = dataclasses.replace(data, textures=(tex, *data.textures[1:]),
                            geom=dataclasses.replace(data.geom, plane_u_axis=axis))
    with exact_math(), (routed(lib) if lib else contextlib.nullcontext()):
        loss = (fn(d) ** 2).mean()
        g = torch.autograd.grad(loss, (tex, axis))
    return loss.detach(), g


def _same_bits(a, b):
    """a and b of the same bits, NaN where the other is NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def test_the_map_gradient_through_w5_is_the_plain_stages(libs, tmp_path):
    """The gradient of a normal-mapped render with respect to its map's
    texture and its floor's u axis, with the attributes through `_Attrs`
    (W5 forward; the backward's counted plain route, the u axis being a
    table the maps read: the maps are recomputed in it), against the plain
    stage's autograd gradient, bit for bit (the
    texels that a degenerate frame makes NaN in the plain stage NaN
    too); two passes through W5 bit for bit."""
    with one_thread():
        before = ha.launches()
        loss_p, g_p = _map_gradient(tmp_path)
        plain_launches = ha.launches() - before
        loss_a, g_a = _map_gradient(tmp_path, libs["w5"])
        launched = ha.launches() - before
        _, g_b = _map_gradient(tmp_path, libs["w5"])
    assert plain_launches == 0 and launched > 0
    assert torch.equal(loss_a, loss_p)
    tex, axis = g_p
    assert int((torch.isfinite(tex) & (tex != 0)).sum()) > 100
    assert bool(torch.isfinite(axis).all() and (axis != 0).all())
    assert all(_same_bits(a, b) for a, b in zip(g_a, g_p))
    assert all(_same_bits(a, b) for a, b in zip(g_b, g_a))


def test_the_gradient_through_w5_is_the_plain_stages(libs):
    """The inverse-rendering IoR gradient with the attributes through
    `_Attrs` (W5 forward and W5's backward kernel: the refracted
    directions carry the gradient into P) equals the plain stage's bit for
    bit, and two backward passes agree bit for bit."""
    with one_thread():
        before = ha.launches()
        loss_p, g_p = _gradient()
        plain_launches = ha.launches() - before
        loss_a, g_a = _gradient(libs["w5"])
        launched = ha.launches() - before
        _, g_b = _gradient(libs["w5"])
    assert plain_launches == 0 and launched > 0
    assert torch.equal(loss_a, loss_p)
    assert bool((g_p != 0).all())
    assert torch.equal(g_a, g_p)
    assert torch.equal(g_b, g_a)
