"""W6, the wavefront's bounce tail, run on the CPU through the stand-in CUDA
runtime.

g++ compiles csrc/bounce_tail.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h (with -DCUDA_EMU_SMS=6: a grid of up to six
blocks, each adding its alive rays into rays_traced, the last of them
writing the sum) into a library of its own, which ops/bounce_tail.py
`_kernel_start` / `_kernel_update` take as `lib=` with CPU tensors.  Its
output is held against the plain stages (`plain_start`, `plain_update`),
every field of every ray: floats by their bits (+0 and -0 differ) or both
NaN, bools and integers equal.  The CPU's torch rounds these stages'
operations as the card's does (products, sums, selects, the texture
fetch's truncations), so the source needs no CPU variant and the holds are
exact.

The inputs: every start and update call of 16x16 renders of the grid,
Cornell on the wavefront, the icosphere, examples 2 and 4 on the wavefront
(a cube-cross sky; a sky with a lightmap) and an emitter scene (solid,
nearest and bilinear repeated emissive textures, a sky with a lightmap
whose texels hold -0 and NaN); and an edge set of updates from a numpy
seed: NaN and -0 in add, missed and dead rays, every bool pattern, a
medium one row for every ray (the view of row 0 of a buffer whose other
rows differ, as `trace` passes the expand of one row), rays_traced summed
over six blocks.  Each source mutation of MUTANTS makes some case fail
(tests/test_torch_bounce_tail_mutants_emu.py, a file of its own so that
two workers share the stand-in's launches).  A render through W6 equals the
plain render, and the inverse-rendering gradient (the IoR and the emissive
colours) through `_Start` and `_Update` (W6 forward and backward
kernels) equals the plain stages', two passes equal.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DCUDA_EMU_SMS=6 -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/bounce_tail.cu -o build/w6_emu.so
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
from raytracer_tpu_torch.materials.base import MAT_EMISSIVE, MAT_ENV
from raytracer_tpu_torch.ops import bounce_tail as bt
from raytracer_tpu_torch.ops import wavefront_shade as ws

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))
import torch_cornellbox  # noqa: E402
import torch_inverse_rendering  # noqa: E402
import torch_mesh  # noqa: E402
import torch_textured  # noqa: E402
import torch_wavefront  # noqa: E402
from test_torch_scenes import _procedural  # noqa: E402

GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread", "-DCUDA_EMU_SMS=6", "-DW6_TORCH_CPU")
W, H = 16, 16
NEVER = T.RenderSettings(use_pallas="never")
START_FIELDS = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
UPDATE_FIELDS = bt.CARRY_FLOATS + bt.CARRY_OTHERS
MUTANTS = {
    # the lightmap added at the camera's bounce too
    "lightmap_at_depth0": [("const bool past = S.depth[i] != 0;",
                            "const bool past = true;")],
    # the where() of 0.0 dropped (c + 0 turns -0 into +0)
    "lightmap_skips_zero": [("c[k] = c[k] + (past ? li * lm[k] : 0.0f);",
                             "if (past) c[k] = c[k] + li * lm[k];")],
    # a bilinear texture fetched nearest
    "nearest_for_bilinear": [("  if (!(d[3] & 2)) {", "  if (true) {")],
    # a ray's add handed to its neighbour's elements
    "add_of_neighbour": [("start_element(S, i, k, adds[t][k]);",
                          "start_element(S, i, k, adds[(t + 1) % TAIL_BLOCK][k]);")],
    # L adds beta * add on rays that were not shaded
    "unmasked_radiance": [("__ldg(U.L + j) + (shaded ? b * __ldg(U.add + j) : 0.0f)",
                           "__ldg(U.L + j) + b * __ldg(U.add + j)")],
    # the split count on the continuing rays, not the shaded ones
    "split_on_alive": [("shaded && __ldg(U.did_split + i) != 0",
                        "next && __ldg(U.did_split + i) != 0")],
    # a medium every ray shares read by ray index
    "medium_by_ray": [("__ldg(U.n_re + U.re_step * i + k)", "__ldg(U.n_re + 3 * i + k)")],
    # rays_traced counting the shaded rays, not the alive ones
    "traced_shaded": [("  return alive;\n}", "  return shaded;\n}")],
    # rays_traced written by the first block, not the last
    "first_block_writes": [("if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;",
                            "if (atomicAdd(ticket, 1u) != 0) return;")],
}


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W6 for the CPU")
    return gxx


def _source(edits=()):
    """The source with its texture fetch (csrc/texture_fetch.cuh) written
    in, so that an edit may change either, and `edits` made."""
    text = (CSRC / "bounce_tail.cu").read_text().replace(
        '#include "texture_fetch.cuh"\n',
        (CSRC / "texture_fetch.cuh").read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def build_libs(tmp_path_factory, builds):
    """{name: library} of `builds` ((name, source edits) each), g++ builds
    against the stand-in runtime, all started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w6emu")
    procs = {}
    for name, edits in builds:
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


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"w6": W6 built for the stand-in runtime}."""
    return build_libs(tmp_path_factory, [("w6", ())])


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


def emitters(m=T, width=W, height=H):
    """Emissive spheres (solid, a nearest image, a bilinear image repeated
    3 times), a glossy mirror and a sky with a lightmap whose texels hold
    -0 (turned to +0 where the lightmap's where() of 0.0 is added) and a
    NaN."""
    proc = _procedural(m)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.04, 0.03))
    sc.add_Camera(look_from=m.vec3(0, 0.3, 1.9), look_at=m.vec3(0, 0.2, 0),
                  screen_width=width, screen_height=height, field_of_view=70)
    checker = proc.checkerboard(32) * 2.0
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.8, 0.3, 0.2),
                                      n=m.vec3(1.5, 1.5, 1.5), roughness=0.0,
                                      spec_coeff=0.4, diff_coeff=0.6),
                    center=m.vec3(-0.55, 0.2, 0.0), radius=0.55, max_ray_depth=4))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(2.0, 1.8, 1.5)),
                    center=m.vec3(0.0, 1.0, -0.8), radius=0.3, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.image(checker)),
                    center=m.vec3(0.6, 0.6, -0.3), radius=0.3))
    sc.add(m.Sphere(material=m.Emissive(color=m.image(checker, repeat=3.0,
                                                      filter="bilinear")),
                    center=m.vec3(0.55, -0.1, -0.1), radius=0.4))
    sky = np.array(m.procedural_sky(32, 16), np.float32)
    sky[::3, ::2] = -0.0
    sky[5, 7] = np.nan
    sc.add_Background(sky, light_intensity=2.0, blur=0.0, linear=True)
    return sc


def _scenes(obj_dir):
    def never(sc):
        sc.settings = NEVER
        return sc
    return {
        "grid": lambda: torch_wavefront.grid(96, W, H),
        "cornell": lambda: never(torch_cornellbox.build_cornell(W, H)),
        "icosphere": lambda: torch_mesh.icosphere(W, H, subdiv=2, obj_dir=obj_dir),
        "example2": lambda: never(torch_textured.example2(W, H)),
        "example4": lambda: never(torch_textured.example4(W, H, blur=0.0)),
        "emitters": lambda: never(emitters()),
    }


SCENES = ("grid", "cornell", "icosphere", "example2", "example4", "emitters")


@contextlib.contextmanager
def stages_replaced(make_start, make_update):
    """trace's `bounce_start` and `bounce_update` replaced by make(real)."""
    real = bt.bounce_start, bt.bounce_update
    bt.bounce_start, bt.bounce_update = make_start(real[0]), make_update(real[1])
    try:
        yield
    finally:
        bt.bounce_start, bt.bounce_update = real


def capture(sc, seed=3):
    """([start args], [update args]) of every call of a 1-spp render of sc
    on the CPU."""
    starts, updates = [], []

    def spy(calls):
        def make(real):
            def f(*args):
                calls.append(args)
                return real(*args)
            return f
        return make

    with stages_replaced(spy(starts), spy(updates)):
        sc.render(samples_per_pixel=1, device="cpu", seed=seed, output="linear")
    return starts, updates


def random_update(seed, n=3000, shared_medium=False):
    """The arrays of an update of n rays from a numpy seed: values of mixed
    signs and scales, NaN and -0 in add, every bool pattern; the medium one
    row for every ray where shared_medium."""
    rng = np.random.default_rng(seed)
    f3 = lambda s=1.0: (rng.normal(size=(n, 3)) * s).astype(np.float32)
    b = lambda p: rng.random(n) < p
    i = lambda: rng.integers(0, 6, n).astype(np.int32)
    add = f3(3.0)
    add[rng.random((n, 3)) < 0.02] = np.nan
    add[rng.random((n, 3)) < 0.02] = -0.0
    medium = (np.broadcast_to(np.float32([1.0, 1.1, 1.2]), (n, 3)) if shared_medium
              else f3())
    return dict(L=np.abs(f3()), beta=np.abs(f3()), alive=b(0.7), miss=b(0.2),
                add=add, beta_mult=f3(), cont=b(0.6), new_origin=f3(10.0),
                new_dir=f3(), new_n_re=f3(), new_n_im=f3(0.01), is_diffuse=b(0.5),
                did_split=b(0.3), O=f3(10.0), D=f3(), n_re=medium, n_im=medium * 0.5,
                depth=i(), diffuse_refl=i(), split_cnt=i(),
                rays_traced=np.int64(rng.integers(0, 10**9)))


def update_args(a, shared_medium=False):
    """(Carry, miss, Merged) of random_update's arrays; a shared medium is
    row 0 of a buffer whose other rows differ, expanded (stride 0)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    if shared_medium:
        for k in ("n_re", "n_im"):
            buf = t[k] + torch.arange(t[k].shape[0], dtype=torch.float32)[:, None]
            t[k] = buf[:1].expand(t[k].shape)
    c = bt.Carry(**{f.name: t[f.name] for f in dataclasses.fields(bt.Carry)})
    acc = ws.Merged(*(t[f] for f in START_FIELDS))
    return c, t["miss"], acc


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """{case: ([start args], [update args])}: the renders' calls, made once
    with one torch thread, and "edge": the random updates (seeds 0-3, two
    of them with the medium one row, one of 3 rays, one counting nothing)."""
    obj_dir = tmp_path_factory.mktemp("obj")
    with one_thread():
        out = {name: capture(make()) for name, make in _scenes(obj_dir).items()}
    edge = [update_args(random_update(s, shared_medium=s % 2 == 1), s % 2 == 1)
            for s in range(4)]
    edge.append(update_args(random_update(4, n=3)))
    c, miss, acc = update_args(random_update(5))
    edge.append((dataclasses.replace(c, rays_traced=None), miss, acc))
    out["edge"] = ([], edge)
    return out


def field_differences(got, want, fields):
    """{field: rays that differ}: integers and bools unequal, floats of
    other bits (+0 and -0 differ) and not both NaN."""
    bad = {}
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            if (a is None) != (b is None):
                bad[f] = -1
            continue
        if a.is_floating_point():
            same = (a.view(torch.int32) == b.view(torch.int32)) | (
                torch.isnan(a) & torch.isnan(b))
        else:
            same = a == b
        rows = int((~same).reshape(max(same.shape[0] if same.dim() else 1, 1),
                                   -1).any(-1).sum())
        if rows:
            bad[f] = rows
    return bad


def differences(case, lib, first=False):
    """[(stage, call, {field: rays})] where W6 from lib and the plain
    stages disagree on the case's calls (only the first if `first`)."""
    starts, updates = case
    out = []
    for k, (ctx, packed, mat_type) in enumerate(starts):
        bad = field_differences(bt._kernel_start(ctx, packed, mat_type, lib=lib),
                                bt.plain_start(ctx, mat_type), START_FIELDS)
        if bad:
            out.append(("start", k, bad))
            if first:
                return out
    for k, args in enumerate(updates):
        bad = field_differences(bt._kernel_update(*args, lib=lib),
                                bt.plain_update(*args), UPDATE_FIELDS)
        if bad:
            out.append(("update", k, bad))
            if first:
                return out
    return out


# ---------------------------------------------------------------------------
# the holds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SCENES + ("edge",))
def test_w6_equals_the_plain_stages(libs, calls, case):
    before = bt.launches()
    with one_thread():
        assert differences(calls[case], libs["w6"]) == []
    got = bt.launches()
    starts, updates = calls[case]
    assert got["bounce_start"] - before["bounce_start"] == len(starts)
    assert got["bounce_update"] - before["bounce_update"] == len(updates) - sum(
        args[0].L.shape[0] == 0 for args in updates)


def test_the_inputs_hold_their_cases(calls):
    """Each input drives what it is held for."""
    def present(case):
        return set(calls[case][0][0][0].static.mat_types_present)
    for case in ("cornell", "grid", "example2", "example4", "emitters"):
        assert MAT_EMISSIVE in present(case) or MAT_ENV in present(case), case
    assert MAT_ENV in present("example2") and MAT_ENV in present("example4")
    static = calls["emitters"][0][0][0].static
    assert any(r.bilinear and r.repeat > 1 for r in static.emissive_tex)
    assert any(not r.bilinear for r in static.emissive_tex)
    assert all(e.lightmap is not None for e in static.env_slots)
    # the emitter scene's sky rays at depth 0 and past it
    depths = set()
    for ctx, _, mat_type in calls["emitters"][0]:
        depths |= set(ctx.depth[mat_type == MAT_ENV].clamp(max=1).tolist())
    assert depths == {0, 1}
    # the first bounce's medium is the expand of one row
    assert calls["cornell"][1][0][0].n_re.stride(0) == 0
    # missed rays, dead rays that hit again, NaN and -0 in add
    edge = calls["edge"][1]
    c, miss, acc = edge[0]
    assert bool(miss.any()) and bool((~c.alive & ~miss).any())
    assert bool(acc.add.isnan().any()) and bool(torch.signbit(acc.add[acc.add == 0]).any())
    assert edge[1][0].n_re.stride(0) == 0


def test_a_refused_launch_raises_and_counts_nothing(libs, calls):
    before = bt.launches()
    for entry, struct in (("bounce_start", bt.Start()), ("bounce_update", bt.Update())):
        with pytest.raises(RuntimeError, match="CUDA error"):
            bt._call(libs["w6"], entry, ctypes.byref(struct), None, entries=bt.ENTRIES)
    c, miss, acc = calls["edge"][1][0]
    with pytest.raises(TypeError):       # float64 radiance
        bt._kernel_update(dataclasses.replace(c, L=c.L.double()), miss, acc,
                          lib=libs["w6"])
    with pytest.raises(TypeError):       # an int32 count
        bt._kernel_update(dataclasses.replace(c, rays_traced=c.rays_traced.int()), miss,
                          acc, lib=libs["w6"])
    ctx, packed, mat_type = calls["cornell"][0][0]
    with pytest.raises(TypeError):       # int64 words
        bt._kernel_start(ctx, packed.long(), mat_type, lib=libs["w6"])
    assert bt.launches() == before


# ---------------------------------------------------------------------------
# routing and autograd through the emu library
# ---------------------------------------------------------------------------


def routed(lib):
    """The stages sent to `lib` on CPU tensors."""
    def start(real):
        return lambda *args: bt._kernel_start(*args, lib=lib)

    def update(real):
        return lambda *args: bt._kernel_update(*args, lib=lib)
    return stages_replaced(start, update)


@pytest.mark.parametrize("scene", ["cornell", "example4"])
def test_a_render_through_w6_equals_the_plain_render(libs, scene, tmp_path):
    make = _scenes(tmp_path)[scene]
    with one_thread():
        want, ws_ = make().render(samples_per_pixel=2, device="cpu", seed=5,
                                  output="linear", return_stats=True)
        before = bt.launches()
        with routed(libs["w6"]):
            got, gs = make().render(samples_per_pixel=2, device="cpu", seed=5,
                                    output="linear", return_stats=True)
        launched = bt.launches()
    assert launched["bounce_start"] > before["bounce_start"]
    assert launched["bounce_update"] > before["bounce_update"]
    assert (got == want).all()
    assert int(gs["rays_traced"]) == int(ws_["rays_traced"])


def _gradient(lib=None, seed=0):
    from raytracer_tpu_torch.diff import differentiable_render, update_materials

    # 4x4 x 32 spp at split_k 3: two chunks of 128 paths a pixel, each
    # under torch.utils.checkpoint
    sc = torch_inverse_rendering.build_scene(1.3, 4, 4)
    fn, data = differentiable_render(sc, 32, seed=seed, device="cpu")
    x = data.mats.refr_n_re.clone().requires_grad_()
    e = data.mats.emissive_color.clone().requires_grad_()
    with routed(lib) if lib else contextlib.nullcontext():
        loss = (fn(update_materials(data, refr_n_re=x, emissive_color=e)) ** 2).mean()
        gx, ge = torch.autograd.grad(loss, (x, e))
    return loss.detach(), gx, ge


def test_the_gradient_through_w6_is_the_plain_stages(libs):
    """The inverse-rendering gradient of the IoR and of the emissive
    colours with the start and the update through `_Start` and `_Update`
    (W6 forward and W6's backward kernels) equals the plain stages' bit
    for bit, and two backward passes agree bit for bit."""
    with one_thread():
        before = bt.launches()
        loss_p, gx_p, ge_p = _gradient()
        plain = bt.launches()
        loss_a, gx_a, ge_a = _gradient(libs["w6"])
        launched = bt.launches()
        _, gx_b, ge_b = _gradient(libs["w6"])
    assert plain == before
    assert all(launched[k] > before[k] for k in launched)
    assert torch.equal(loss_a, loss_p)
    assert bool((gx_p != 0).all()) and bool((ge_p != 0).any())
    assert torch.equal(gx_a, gx_p) and torch.equal(ge_a, ge_p)
    assert torch.equal(gx_b, gx_a) and torch.equal(ge_b, ge_a)
