"""W5's backward kernel, run on the CPU through the stand-in CUDA runtime.

g++ compiles csrc/hit_attrs.cu against csrc/emu/cuda_runtime.h with
W5_TORCH_CPU, as tests/test_torch_hit_attrs_emu.py builds it: the source
then sums three (and two) in the CPU's order and takes the backward of
atan2, asin and sqrt through float64, as the plain stage's ops run here
(`exact_math`: torch.sqrt, atan2 and asin through float64, so their
backward is float64's between two casts).  ops/hit_attrs.py `attrs_vjp`
takes the library as `lib=` with CPU tensors; the gradients of O, D and t
it writes are held against the plain stage's VJP (`plain_attrs_vjp`,
ops/plain_grad.py `plain_vjp`) by their bits (+0 and -0 differ; NaN
equals NaN), and one the plain VJP leaves None must be None.

The inputs, each held as called, with uv forced and as the first-hit
pass: the attribute calls of 16x16 renders of every kind (the grid,
Cornell, the primitives and shapes scenes, the icosphere, the beach ball's
smooth normals and corner uvs, a field of instances), the edge scene's
rays (tests/test_torch_hit_attrs_emu.py `edge_inputs`: a box hit at -0,
on an edge and a corner, a cylinder's cap-side tie, every object id beside
the other kinds', misses, NaN distances) and hit points whose |P| ties in
two or three components past 1 (the nudge's amax splits its gradient
among them), each with output gradients drawn from a numpy seed (mixed
scales, -0, +0 and NaN among them, some None); and the backward calls of
16x16 IoR gradients of the glass sphere, its icosphere twin and Cornell,
recorded (`plain_grad.recording`) with W5's forward from the stand-in and
replayed through both.  Each mutant of MUTANTS makes some case fail.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DW5_TORCH_CPU -I raytracer_tpu_torch/csrc/emu \\
        -I raytracer_tpu_torch/csrc -x c++ \\
        raytracer_tpu_torch/csrc/hit_attrs.cu -o build/w5_emu.so
"""

import contextlib
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.diff import differentiable_render, update_materials
from raytracer_tpu_torch.ops import hit_attrs as ha
from raytracer_tpu_torch.ops.plain_grad import recording

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hit_attrs_emu import (CSRC, GXX_FLAGS, MODES, _gxx,  # noqa: E402
                                      _scenes, _source, capture, edge_inputs,
                                      exact_math, map_inputs, one_thread, routed)
import torch_cornellbox  # noqa: E402
import torch_features  # noqa: E402
import torch_inverse_rendering  # noqa: E402

MUTANTS = {
    # the nudge's amax handing each tied maximum the whole gradient
    "amax_tie_split_dropped": [("    const float ga = gc / cnt;",
                                "    const float ga = gc;")],
    # t's torch.sum in another order
    "gt_sum_order": [("  if (B.dt) B.dt[i] = tsum3(G[0] * D[0], G[1] * D[1], G[2] * D[2]);",
                      "  if (B.dt) B.dt[i] = tsum3(G[0] * D[0], G[2] * D[2], G[1] * D[1]);")],
    # the first-hit pass's where(miss, 0, P) handing the miss the gradient
    "first_hit_where_swapped": [
        ("  for (int c = 0; c < 3; ++c) G[c] = zeroed ? 0.0f : acc_val(gp[c]);",
         "  for (int c = 0; c < 3; ++c) G[c] = zeroed ? acc_val(gp[c]) : 0.0f;")],
    # P's nudge term added after the kinds'
    "eps_after_kinds": [("  if (B.geps) {\n    // eps", "  if (false) {\n    // eps"),
                        ("  float G[3];\n", "  if (B.geps) {\n    float a[3];\n"
                         "    for (int c = 0; c < 3; ++c) a[c] = fabsf(P[c]);\n"
                         "    const float m = t_max3(a[0], a[1], a[2]);\n"
                         "    const float gc = m >= 1.0f ? __ldg(B.geps + i) * B.nudge : 0.0f;\n"
                         "    const float cnt = (float)((m == a[0]) + (m == a[1]) + (m == a[2]));\n"
                         "    for (int c = 0; c < 3; ++c)\n"
                         "      acc_add(gp[c], ((gc / cnt) * (m == a[c] ? 1.0f : 0.0f)) * "
                         "t_sign(P[c]));\n  }\n  float G[3];\n")],
    # only the ray's own kind's formula adding to P (the others add zeros or NaN)
    "other_kinds_skipped": [("    if (reached)\n      for (int c = 0; c < 3; ++c) acc_add(gp[c], g[c]);",
                             "    if (reached && mine)\n"
                             "      for (int c = 0; c < 3; ++c) acc_add(gp[c], g[c]);")],
    # the cylinder's three dots, x's first
    "cylinder_dots_x_first": [("  dot_bwd(b, acc_val(Z), va);\n  dot_bwd(b, acc_val(Y), ax);\n"
                               "  dot_bwd(b, acc_val(X), ua);",
                               "  dot_bwd(b, acc_val(X), ua);\n  dot_bwd(b, acc_val(Y), ax);\n"
                               "  dot_bwd(b, acc_val(Z), va);")],
    # the smooth normal's Ns * Ns products added as one doubled term
    "norm_square_doubled": [("    m.gNs[c] = (m.gNs[c] + q) + q;",
                             "    m.gNs[c] = m.gNs[c] + 2.0f * q;")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: W5 ("w5") and each mutant of MUTANTS, g++ builds
    against the stand-in runtime, all started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w5bwd")
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


def bits_differ(a, b):
    """Whether a and b differ: None against a tensor, shapes, or floats of
    other bits (+0 and -0 differ) and not both NaN."""
    if a is None or b is None:
        return (a is None) != (b is None)
    if a.shape != b.shape:
        return True
    return not bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())


def draw_grads(rng, n):
    """The output gradients of P, N, uv and eps for n rays (each None for
    about one in four): normals at one of three scales, with -0, +0 and
    NaN among them."""
    out = []
    for shape in ((n, 3), (n, 3), (n, 2), (n,)):
        if rng.random() < 0.25:
            out.append(None)
            continue
        g = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 1e3])).astype(np.float32)
        g[rng.random(shape) < 0.05] = -0.0
        g[rng.random(shape) < 0.05] = 0.0
        g[rng.random(shape) < 0.01] = np.nan
        out.append(torch.from_numpy(g))
    return out


def tie_rays(static, data, rng, n=256):
    """Rays whose hit point is placed (D = 0, t = 1: P = O) where |P| ties
    in two or three components at 1 and past it, with signs and -0 mixed,
    on every object id."""
    O = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    a = rng.choice(np.float32([1.0, 1.5, 2.0, 3.25]), n)
    sign = lambda: rng.choice(np.float32([-1.0, 1.0]), n)
    O[:, 0] = a * sign()
    O[:, 1] = a * sign()
    O[n // 2:, 2] = a[n // 2:] * sign()[n // 2:]
    D = np.zeros((n, 3), np.float32)
    D[::3] = -0.0
    total = sum(static.kind_counts.values())
    obj = np.arange(n) % total
    orient = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (O, D, np.ones(n, np.float32), orient,
                                               obj.astype(np.int64)))


def held_leaves(data, static):
    """(the geometry's float tables, the maps' textures) a case may want a
    gradient of."""
    return (ha._geom_floats(data.geom), tuple(sorted({r.tex for r in static.normal_maps})))


def recorded_calls(lib):
    """{label: the recorded backward calls of `_Attrs`} of 16x16 x 2 spp
    gradients (one chunk, under torch.utils.checkpoint) through W5's
    forward from lib: the IoR gradients of the glass sphere, its icosphere
    twin and Cornell, and the sphere's with respect to its spheres'
    centres and radii and the icosphere's with respect to its triangle
    tables (`table_gradient`)."""
    out = {}
    obj_dir = Path(__import__("tempfile").mkdtemp())
    for label in ("sphere", "icosphere", "cornell"):
        fn, data = differentiable_render(RECORDED[label](obj_dir), 2, seed=3, device="cpu")
        x = data.mats.refr_n_re.clone().requires_grad_()
        with exact_math(), recording([], ha._Attrs) as calls, routed(lib):
            loss = (fn(update_materials(data, refr_n_re=x)) ** 2).mean()
            torch.autograd.grad(loss, x)
        out[label] = calls
    for label in ("sphere", "icosphere", "mapped"):
        with recording([], ha._Attrs) as calls:
            table_gradient(label, lib, obj_dir)
        out[f"{label} tables"] = calls
    return out


RECORDED = {
    "sphere": lambda d: torch_inverse_rendering.build_scene(1.3, 16, 16),
    "icosphere": lambda d: torch_inverse_rendering.build_mesh_scene(1.3, 16, 16, d,
                                                                    subdiv=1),
    "cornell": lambda d: torch_cornellbox.build_cornell(16, 16),
    "mapped": lambda d: torch_features.normal_mapped(16, 16, obj_dir=d, enclosed=True),
}
# the geometry tables (and textures) each scene's table gradient takes
GEOM_TABLES = {"sphere": ("sphere_center", "sphere_radius"),
               "icosphere": ("tri_p1", "tri_p2", "tri_p3", "tri_vn1", "tri_vn2",
                             "tri_vn3"),
               "mapped": ("sphere_center", "plane_u_axis", "box_basis", "tri_tan",
                          "tri_tan_sign", "textures.0")}


def table_gradient(label, lib, obj_dir, plain_backward=False):
    """d loss / d the geometry tables (or textures) GEOM_TABLES[label] of a
    16x16 x 2 spp render of RECORDED[label] on the CPU, W5 from lib (None:
    the plain stage; plain_backward: W5's forward from lib, its backward
    the plain VJP inside `_Attrs`, `_plain_backward`)."""
    fn, data = differentiable_render(RECORDED[label](obj_dir), 2, seed=3, device="cpu")
    geom = {k: getattr(data.geom, k).clone().requires_grad_()
            for k in GEOM_TABLES[label] if not k.startswith("textures.")}
    texs = list(data.textures)
    for k in GEOM_TABLES[label]:
        if k.startswith("textures."):
            texs[int(k[9:])] = texs[int(k[9:])].clone().requires_grad_()
    data = dataclasses.replace(data, geom=dataclasses.replace(data.geom, **geom),
                               textures=tuple(texs))
    xs = [geom[k] if k in geom else texs[int(k[9:])] for k in GEOM_TABLES[label]]
    real = ha._Attrs.backward
    if plain_backward:
        ha._Attrs.backward = staticmethod(_plain_backward)
    try:
        with exact_math(), (routed(lib) if lib is not None else contextlib.nullcontext()):
            loss = (fn(data) ** 2).mean()
            return torch.autograd.grad(loss, xs)
    finally:
        ha._Attrs.backward = real


def _plain_backward(fctx, *grads):
    """`_Attrs`' backward through the plain stage's VJP (its forward's saved
    inputs)."""
    obj, *xs = fctx.saved_tensors
    return (None, *ha.plain_attrs_vjp(grads[:len(ha.FLOAT_FIELDS)], xs, obj, fctx.data,
                                      fctx.static, fctx.modes, fctx.names, fctx.texs,
                                      fctx.needs_input_grad[1:]))


@pytest.fixture(scope="module")
def cases(libs, tmp_path_factory):
    """[(label, kernel(lib) -> gradients, plain gradients)]."""
    rng = np.random.default_rng(25)
    out = []
    obj_dir = tmp_path_factory.mktemp("obj")
    with one_thread():
        inputs = []
        for name, make in _scenes(obj_dir).items():
            inputs += [(name, args[:7]) for args, kw in capture(make()) if not kw]
        static, data, rays, _ = edge_inputs()
        inputs.append(("edge", (*rays, data, static)))
        inputs.append(("ties", (*tie_rays(static, data, rng), data, static)))
        static, data, rays, _ = map_inputs(obj_dir)
        inputs.append(("maps", (*rays, data, static)))
        with exact_math():
            for name, (O, D, t, orient, obj, data, static) in inputs:
                names, texs = held_leaves(data, static)
                xs = ([O, D, t, orient] + [getattr(data.geom, f) for f in names]
                      + [data.textures[k] for k in texs])
                for force_uv, first_hit in MODES:
                    modes = (*ha._nudge_uv(static, None, force_uv), first_hit)
                    grads = draw_grads(rng, t.shape[0])
                    # the rays' gradients, and the tables' and the maps'
                    # textures' half the time
                    more = rng.random() < 0.5
                    wants = ((*(bool(w) for w in rng.random(3) < 0.8), False)
                             + tuple(bool(w) and more
                                     for w in rng.random(len(names) + len(texs)) < 0.8))
                    if first_hit:
                        wants = wants[:4 + len(names)] + (False,) * len(texs)
                    out.append((f"{name} {force_uv}.{first_hit}",
                                lambda lib, a=(grads, O, D, t, orient, obj, data,
                                               static, modes, wants), nm=names, tx=texs:
                                ha.attrs_vjp(*a, lib, nm, tx),
                                ha.plain_attrs_vjp(grads, xs, obj, data, static, modes,
                                                   names, texs, wants)))
            for label, calls in recorded_calls(libs["w5"]).items():
                for k, (fn, call, xs, grads, wants) in enumerate(calls):
                    kernel, plain = ha.backward_pair(fn, call, xs, grads, wants)
                    out.append((f"{label} recorded {k}",
                                lambda lib, r=(fn, call, xs, grads, wants):
                                ha.backward_pair(*r, lib)[0](), plain()))
    return out


def failures(cases, lib, first=False):
    """[(case, input index)] where the kernel from lib and the plain VJP
    disagree."""
    bad = []
    with one_thread(), exact_math():
        for label, kernel, want in cases:
            for i, (a, b) in enumerate(zip(kernel(lib), want)):
                if bits_differ(a, b):
                    bad.append((label, i))
                    if first:
                        return bad
    return bad


def test_w5_backward_equals_the_plain_vjp(libs, cases):
    before = ha.backward_launches()
    assert failures(cases, libs["w5"]) == []
    assert ha.backward_launches() > before


def test_the_cases_hold_what_they_are_for(cases):
    """The recorded gradients of each scene reach the kernel with a nonzero
    gradient; the ties split the nudge's gradient; every kind is held."""
    labels = [c[0] for c in cases]
    for scene in ("sphere", "icosphere", "cornell"):
        rec = [c for c in cases if c[0].startswith(f"{scene} recorded")]
        assert rec and any(c[2][0] is not None and bool((c[2][0] != 0).any())
                           for c in rec), scene
    for scene in ("sphere", "icosphere", "mapped"):
        rec = [c for c in cases if c[0].startswith(f"{scene} tables recorded")]
        assert rec and any(any(g is not None and bool((g != 0).any()) for g in c[2][4:])
                           for c in rec), scene
    # every table of TABLES takes a nonzero gradient in some case
    reached = set()
    for label, kernel, want in cases:
        if len(want) > 4 and not label.endswith("recorded"):
            reached |= {k for k, g in enumerate(want[4:])
                        if g is not None and bool((g != 0).any())}
    assert len(reached) > 20, reached
    for name in ("grid", "cornell", "primitives", "shapes", "icosphere",
                 "beach_ball", "instances", "normal_mapped", "normal_mapped_bilinear",
                 "instanced_mapped", "edge", "ties", "maps"):
        assert any(lab.startswith(name + " ") for lab in labels), name


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant


def test_a_table_gradient_takes_the_kernel(libs):
    """The ray inputs alone, and with a geometry table requiring grad, take
    the kernel, one launch a backward call, no plain route."""
    static, data, rays, _ = edge_inputs()
    O, D, t, orient, obj = (x.clone() for x in rays)
    O.requires_grad_()
    ha.reset_launches()
    with one_thread(), exact_math(), routed(libs["w5"]):
        a = ha.attributes(O, D, t, orient, obj, data, static)
        torch.autograd.grad(a.P.sum() + a.N.sum(), O)
        assert ha.backward_launches() == 1
        geom = data.geom
        r = geom.sphere_radius.clone().requires_grad_()
        data2 = dataclasses.replace(data, geom=dataclasses.replace(geom, sphere_radius=r))
        a = ha.attributes(O, D, t, orient, obj, data2, static)
        got = torch.autograd.grad(a.N.sum(), (O, r))
    assert ha.backward_launches() == 2
    assert bool((got[1] != 0).any())


@pytest.mark.parametrize("label", list(GEOM_TABLES))
def test_a_table_gradient_through_the_kernel_is_the_plain_stages(libs, label, tmp_path):
    """The sphere's gradient with respect to its spheres' centres and radii,
    the icosphere's with respect to its corners and their normals and the
    enclosed normal-mapped scene's with respect to its spheres' centres and
    its map, with W5's backward from the kernel (its TABLES and MAPS
    instances), equal the plain stage's bit for bit, with no plain route.
    (The map's four refs add their fetches' gradients inside each call of
    `_Attrs`, then autograd adds the calls': the mapped scene is held
    against `_Attrs` with the plain VJP, the plain stage adding every fetch
    of the render in one buffer.)"""
    with one_thread():
        plain = (table_gradient(label, libs["w5"], tmp_path, plain_backward=True)
                 if label == "mapped" else table_gradient(label, None, tmp_path))
        ha.reset_launches()
        got = table_gradient(label, libs["w5"], tmp_path)
    assert ha.backward_launches() > 0
    assert all(bool((g != 0).any()) for g in plain)
    assert not any(bits_differ(a, b) for a, b in zip(got, plain))


def test_a_table_the_maps_read_takes_the_maps_instance(libs, tmp_path):
    """A normal-mapped scene whose map texture, or whose plane axis too (a
    table its maps read), requires grad takes the MAPS instance, one
    launch a backward call, its gradients the plain VJP's bit for bit."""
    static, data, rays, _ = map_inputs(tmp_path)
    O, D, t, orient, obj = (x.clone() for x in rays)
    k = static.normal_maps[-1].tex
    tex = data.textures[k].clone().requires_grad_()
    texs = list(data.textures)
    texs[k] = tex
    data = dataclasses.replace(data, textures=tuple(texs))
    u = data.geom.plane_u_axis.clone().requires_grad_()
    data2 = dataclasses.replace(data, geom=dataclasses.replace(data.geom, plane_u_axis=u))
    ha.reset_launches()
    got = []
    with one_thread(), exact_math(), routed(libs["w5"]):
        a = ha.attributes(O, D, t, orient, obj, data, static)
        torch.autograd.grad(a.N.sum(), tex)
        for route in (None, _plain_backward):
            real = ha._Attrs.backward
            if route is not None:
                ha._Attrs.backward = staticmethod(route)
            try:
                a = ha.attributes(O, D, t, orient, obj, data2, static)
                got.append(torch.autograd.grad((a.N * a.N.detach()).sum(), (tex, u)))
            finally:
                ha._Attrs.backward = real
    assert ha.backward_launches(maps=True) == 2 == ha.backward_launches()
    assert all(bool((g != 0).any()) for g in got[0])
    assert not any(bits_differ(x, y) for x, y in zip(*got))
