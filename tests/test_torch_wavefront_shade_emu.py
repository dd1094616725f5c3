"""W4, the wavefront's shading blocks, run on the CPU through the stand-in
CUDA runtime.

g++ compiles csrc/wavefront_shade.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h with W4_TORCH_CPU (the source then restates
torch's CPU ops: sums in its cascade sum's order, true division by Python
numbers, x86's clamp of signed zeros) into a library of its own, which
ops/wavefront_shade.py `_kernel_shade` takes as `lib=` with CPU tensors.
The bounces are those of small renders on the CPU (16x16, the
wavefront), each diffuse, refractive and glossy call captured where
core/integrator.py `trace` makes it (the module's three wrappers), with
its ShadeCtx,
draws, packed words, mask and merged output so far; W4's merged output
is held against the plain dispatch's (the plain block merged with
torch.where), every field of every ray: bools equal, floats equal or both
NaN.  The scenes: the 98-object grid (diffuse, stratified first bounce),
Cornell (diffuse with two importance-sampled caps, refractive), the
icosphere and the beach ball (glossy, a bilinear image texture, a
directional light with shadow rays, triangles through W1's plain
version), the importance-sampled environment (diffuse with the alias
tables, glossy without lights), dispersion (the hero channel), the
solid example 2 (split_k 3: the deterministic Fresnel split), the shapes
scene (a point and a spot light), the primitives (a nearest image
texture, a spot and a directional light) and a cluster of 131
importance-sampled lamps (a caps pdf summing 131 terms, many of them not
zero, in the order of torch's cascade sum).

Torch's CPU sqrt, cos, sin, exp, pow, atan2 and asin are not libm's (its
vectorised kernels are within an ulp or so; sqrt is off by one ulp on
~0.7% of lanes), so the plain blocks run here with those ops through
float64, rounded once (`exact_math`), and W4_TORCH_CPU computes them the
same way: the holds are then exact on every field.  Beside them,
`test_w4_within_ulps_of_torchs_own_math` holds the refractive and glossy
entries against the plain blocks under torch's own CPU exp and pow (the
root still through float64), the fields expf and powf enter within ULPS
units in the last place and every other field exact; the diffuse block
is left out of that hold, since a last-bit change of a direction can
move a cap test or an environment cell.

Each source mutation of MUTANTS makes some case fail.  The routing and
autograd tests run `trace` with the wrappers sent to the emu library:
a render equals the plain dispatch's bit for bit, and so does the
inverse-rendering gradient through `_Shade` (two chunks under
torch.utils.checkpoint), two backward passes equal.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DW4_TORCH_CPU -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/wavefront_shade.cu -o build/w4_emu.so
"""

import contextlib
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.materials import shade
from raytracer_tpu_torch.materials.base import (MAT_DIFFUSE, MAT_GLOSSY,
                                                MAT_REFRACTIVE)
from raytracer_tpu_torch.ops import wavefront_shade as ws

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
             "-pthread", "-DW4_TORCH_CPU")
W, H = 16, 16
ULPS = 4
NAMES = {MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
         MAT_GLOSSY: "glossy"}
NEVER = T.RenderSettings(use_pallas="never")
MUTANTS = {
    # the CPU's torch.sum order
    "sum_order": [("  return ((0.0f + x0) + x1) + x2;\n#else",
                   "  return ((0.0f + x0) + x2) + x1;\n#else")],
    # the Schlick continuation contracted
    "schlick_fma": [("beta[c] = F0 + (1.0f - F0) * schlick;",
                     "beta[c] = fmaf(1.0f - F0, schlick, F0);")],
    # the stratified draws at the wrong bounce
    "strat_bounce": [("if (B.s_mix != nullptr && dr == 0) {",
                      "if (B.s_mix != nullptr && dr == 1) {")],
    # a bilinear texture fetched nearest
    "nearest_for_bilinear": [("if (!(d[3] & 2)) {", "if (true) {")],
    # the split pattern's bit one level off
    "split_bit": [("bit = ((R.pattern[i] >> (cnt < 30 ? cnt : 30)) & 1) == 1;",
                   "bit = ((R.pattern[i] >> (cnt < 29 ? cnt + 1 : 30)) & 1) == 1;")],
    # the hero channel ignored
    "no_hero": [("      if (disp) {\n", "      if (false) {\n")],
    # the environment's alias taken on the wrong branch
    "alias_branch": [("if (!take) k = B.env_alias[k];",
                      "if (take) k = B.env_alias[k];")],
    # the spot light's smoothstep cone reassociated
    "cone": [("const float cone = (x * x) * (3.0f - 2.0f * x);",
              "const float cone = x * (x * (3.0f - 2.0f * x));")],
    # a texture's rows not flipped (v up)
    "texture_rows": [("(long long)t_rem(wrap_neg(iv), H) * W",
                      "(long long)t_rem(iv, H) * W")],
    # the lanes of the CPU's vector sum added in reverse
    "cpu_sum_lanes": [("  for (int l = 0; l < W4_CPU_VEC; ++l) s = s + lanes[l];",
                       "  for (int l = W4_CPU_VEC - 1; l >= 0; --l) s = s + lanes[l];")],
    # the directional lights' shadow rays ignored
    "no_shadow": [("      const float see = B.occ != nullptr\n"
                   "          ? 1.0f - (float)B.occ[(long long)light * R.n + i] : 1.0f;\n"
                   "      float lv[3];\n"
                   "      for (int c = 0; c < 3; ++c) lv[c] = B.dir_color[3 * l + c] * NdotL;",
                   "      const float see = 1.0f;\n"
                   "      float lv[3];\n"
                   "      for (int c = 0; c < 3; ++c) lv[c] = B.dir_color[3 * l + c] * NdotL;")],
}


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W4 for the CPU")
    return gxx


def _source(edits=()):
    text = (CSRC / "wavefront_shade.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: W4 ("w4") and each mutant of MUTANTS, g++ builds
    against the stand-in runtime, all started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4emu")
    procs = {}
    for name, edits in [("w4", ())] + list(MUTANTS.items()):
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
def exact_math(names=("sqrt", "cos", "sin", "exp", "pow", "atan2", "asin")):
    """torch.sqrt, cos, sin, exp, pow, atan2 and asin (or those named)
    through float64, rounded once to float32 (as W4_TORCH_CPU computes
    them)."""
    saved = {k: getattr(torch, k) for k in names}
    for k in names:
        setattr(torch, k, _f64(saved[k]))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch, k, v)


# ---------------------------------------------------------------------------
# the bounces
# ---------------------------------------------------------------------------


def _scenes(obj_dir):
    def never(sc):
        sc.settings = NEVER
        return sc
    return {
        "grid": lambda: torch_wavefront.grid(96, W, H),
        "cornell": lambda: never(torch_cornellbox.build_cornell(W, H)),
        "icosphere": lambda: torch_mesh.icosphere(W, H, subdiv=2, obj_dir=obj_dir),
        "beach_ball": lambda: torch_mesh.beach_ball(W, H, obj_dir=obj_dir),
        "env_is": lambda: torch_features.env_is(W, H),
        "dispersion": lambda: never(torch_primitives.dispersion(W, H)),
        "split": lambda: never(torch_primitives.example2_solid(W, H)),
        "shapes": lambda: never(torch_primitives.shapes(W, H)),
        "primitives": lambda: never(torch_primitives.primitives(W, H)),
        "lamps": lambda: torch_wavefront.lamp_cluster(LAMPS, W, H),
    }


SCENES = ("grid", "cornell", "icosphere", "beach_ball", "env_is", "dispersion",
          "split", "shapes", "primitives", "lamps")
LAMPS = 131


@contextlib.contextmanager
def wrappers_replaced(make):
    """trace's three W4 wrappers replaced by make(type, real wrapper)."""
    real = dict(ws._WRAPPER)
    for mt, w in real.items():
        setattr(ws, w.__name__, make(mt, w))
    try:
        yield
    finally:
        for w in real.values():
            setattr(ws, w.__name__, w)


def capture(sc, seed=3):
    """[(type, ctx, draws, packed, mask, merged so far)] of every W4-typed
    block call of one 1-spp render of sc on the CPU."""
    calls = []

    def spy(mt, real):
        def f(ctx, draws, packed, m, acc):
            calls.append((mt, ctx, draws, packed, m, acc))
            return real(ctx, draws, packed, m, acc)
        return f

    with wrappers_replaced(spy):
        sc.render(samples_per_pixel=1, device="cpu", seed=seed, output="linear")
    return calls


@pytest.fixture(scope="module")
def bounces(tmp_path_factory):
    """{scene: captured calls}, made once with one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obj_dir = tmp_path_factory.mktemp("obj")
    try:
        yield {name: capture(make()) for name, make in _scenes(obj_dir).items()}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain(bounces):
    """{scene: the plain dispatch's merged output of each captured call}
    (exact_math)."""
    return {name: [plain_out(c) for c in calls] for name, calls in bounces.items()}


def _copy(acc):
    return ws.Merged(*(getattr(acc, f).clone() for f in
                       ws.FLOAT_FIELDS + ws.BOOL_FIELDS))


def plain_out(call, math=exact_math):
    mt, ctx, draws, packed, m, acc = call
    with math():
        return acc.merge(ws._plain(mt, ctx, draws, None), m)


def w4_out(call, lib):
    mt, ctx, draws, packed, m, acc = call
    return ws._kernel_shade(mt, ctx, draws, packed, m, _copy(acc), lib=lib)


def field_differences(got, want):
    """{field: rays that differ}: bools unequal, floats unequal and not
    both NaN."""
    bad = {}
    for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        same = a == b
        if a.is_floating_point():
            same = same | (torch.isnan(a) & torch.isnan(b))
        rows = int((~same).reshape(same.shape[0], -1).any(-1).sum())
        if rows:
            bad[f] = rows
    return bad


def differences(calls, wants, lib, first=False):
    """[(bounce, block, {field: rays})] of the calls where W4 from lib and
    the plain dispatch's outputs `wants` disagree (only the first if
    `first`)."""
    out = []
    for call, want in zip(calls, wants):
        bad = field_differences(w4_out(call, lib), want)
        if bad:
            out.append((call[1].bounce, NAMES[call[0]], bad))
            if first:
                break
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_w4_equals_the_plain_dispatch(libs, bounces, plain, scene):
    calls = bounces[scene]
    before = {mt: w.launches for mt, w in ws._WRAPPER.items()}
    assert differences(calls, plain[scene], libs["w4"]) == []
    for mt, w in ws._WRAPPER.items():
        assert w.launches - before[mt] == sum(1 for c in calls if c[0] == mt)


def _typed(calls, mt):
    return sum(int(c[4].sum()) for c in calls if c[0] == mt)


def test_the_scenes_hold_their_cases(bounces, plain):
    """Each scene drives what it is held for."""
    b = bounces
    assert _typed(b["grid"], MAT_DIFFUSE) > 200
    assert any(c[1].strat_u is not None for c in b["grid"])
    cornell = b["cornell"][0][1]
    assert cornell.static.n_is_targets == 2
    assert _typed(b["cornell"], MAT_DIFFUSE) > 1000
    assert _typed(b["cornell"], MAT_REFRACTIVE) > 1000
    for name in ("icosphere", "beach_ball"):
        st = b[name][0][1].static
        assert st.n_dir_lights == 1 and st.has_shadow_objects
        assert _typed(b[name], MAT_GLOSSY) > 200
    assert any(r.bilinear for r in b["beach_ball"][0][1].static.glossy_tex)
    # some glossy rays of the beach ball are in the light's shadow
    shadowed = 0
    for mt, ctx, draws, packed, m, acc in b["beach_ball"]:
        nudged, rays = shade.light_rays(ctx)
        occ = shade.light_occlusion(ctx, nudged, rays)
        shadowed += int((occ[0] & m).sum())
    assert shadowed > 0
    env = b["env_is"][0][1].static
    assert tuple(env.env_is_shape) != (0, 0) and env.n_is_targets == 0
    assert _typed(b["env_is"], MAT_DIFFUSE) > 100
    disp = b["dispersion"]
    assert disp[0][1].static.has_dispersion
    assert _typed(disp, MAT_REFRACTIVE) > 1000
    shapes = b["shapes"][0][1].static
    assert shapes.n_point_lights == 1 and shapes.n_spot_lights == 1
    assert _typed(b["shapes"], MAT_GLOSSY) > 20
    prim = b["primitives"][0][1].static
    assert any(not r.bilinear for r in prim.glossy_tex)
    assert _typed(b["primitives"], MAT_GLOSSY) > 20
    # the lamps: rays whose caps pdf sums many terms that are not zero
    lamps = [c for c in b["lamps"] if c[0] == MAT_DIFFUSE]
    assert lamps[0][1].static.n_is_targets == LAMPS
    assert _typed(b["lamps"], MAT_DIFFUSE) > 200
    many = 0
    for mt, ctx, draws, packed, m, acc in lamps:
        o = plain_out((mt, ctx, draws, packed, m, acc))
        ax, cos_max = rng.caps_geometry(ctx.P + ctx.N * ctx.eps[..., None],
                                        ctx.data.is_center, ctx.data.is_radius)
        inside = ((o.new_dir[:, None, :] * ax).sum(-1) > cos_max).sum(-1)
        many += int(((inside >= 8) & m).sum())
    assert many > 50
    split = [c for c in b["split"] if c[0] == MAT_REFRACTIVE]
    assert split and split[0][1].split_k == 3
    outs = [o for c, o in zip(b["split"], plain["split"]) if c[0] == MAT_REFRACTIVE]
    assert sum(int((o.did_split & c[4]).sum()) for c, o in zip(split, outs)) > 100


def test_texture_tables_are_kept_per_data(bounces):
    ctx = next(c[1] for c in bounces["beach_ball"] if c[0] == MAT_GLOSSY)
    mats, refs = ctx.data.mats, ctx.static.glossy_tex
    tt = ws.texture_tables(mats, mats.glossy_color, refs, ctx.data.textures)
    texels, di, df = tt
    ref = refs[-1]
    tex = ctx.data.textures[ref.tex]
    assert di[ref.slot].tolist() == [0, tex.shape[0], tex.shape[1], 3]
    assert df[ref.slot].tolist() == [float(torch.tensor(tex.shape[1] * ref.repeat)),
                                     float(torch.tensor(tex.shape[0] * ref.repeat))]
    assert torch.equal(texels[:tex.numel()], tex.reshape(-1))
    others = [s for s in range(di.shape[0]) if s != ref.slot]
    assert all(int(di[s, 3]) == 0 for s in others)
    assert ws.texture_tables(mats, mats.glossy_color, refs, ctx.data.textures) is tt
    assert ws.texture_tables(mats, mats.glossy_color, (), ctx.data.textures) is None


def _ulps(a, b):
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return (ia - ib).abs()


def test_w4_within_ulps_of_torchs_own_math(libs, bounces):
    """The refractive and glossy entries against the plain blocks run with
    torch's own CPU exp and pow (its sqrt correctly rounded): beta_mult
    (expf, powf) and the glossy add (powf) within ULPS units in the last
    place, every other field exact."""
    held = 0
    for scene in ("cornell", "dispersion", "beach_ball", "split"):
        for call in bounces[scene]:
            if call[0] == MAT_DIFFUSE:
                continue
            got = w4_out(call, libs["w4"])
            want = plain_out(call, math=lambda: exact_math(("sqrt",)))
            loose = {"beta_mult"} | ({"add"} if call[0] == MAT_GLOSSY else set())
            bad = field_differences(got, want)
            assert set(bad) <= loose, (scene, NAMES[call[0]], bad)
            m = call[4]
            for f in loose:
                a, b = getattr(got, f)[m], getattr(want, f)[m]
                ok = torch.isfinite(b)
                d = _ulps(a[ok], b[ok])
                assert d.numel() == 0 or int(d.max()) <= ULPS, (scene, f)
            held += int(m.sum())
    assert held > 5000


def test_flow_is_the_plain_blocks_dataflow(bounces):
    """`_flow`, read on the meta device off one ray, names the float fields
    whose plain-block output requires grad, for inputs requiring grad in
    a few patterns, on the first calls of each scene."""
    held = 0
    for calls in bounces.values():
        for mt, ctx, draws, packed, m, acc in calls[:2]:
            xs = ws._inputs(mt, ctx)
            occ = None
            if mt == MAT_GLOSSY:
                occ = shade.light_occlusion(ctx, *shade.light_rays(ctx))
            for k in range(3):
                flags = tuple(isinstance(x, torch.Tensor) and x.is_floating_point()
                              and (i + k) % 3 == 0 for i, x in enumerate(xs))
                ctx.static.__dict__.pop("_w4_flow", None)
                got = ws._flow(mt, ctx, draws, occ, flags)
                with torch.enable_grad():
                    leaves = [x.detach().requires_grad_() if f else x
                              for x, f in zip(xs, flags)]
                    o = ws._plain(mt, ws._rebuild(mt, ctx, leaves), draws, occ)
                assert got == {f for f in ws.FLOAT_FIELDS
                               if getattr(o, f).requires_grad}, (NAMES[mt], k)
                held += 1
    assert held >= 50


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w4_fails(libs, bounces, plain, mutant):
    caught = any(differences(bounces[s], plain[s], libs[mutant], first=True)
                 for s in SCENES)
    assert caught, f"no case catches the mutant {mutant}"


def test_a_refused_launch_raises_and_counts_nothing(libs, bounces):
    before = ws.launches()
    for entry, cls in ws._BLOCKS.values():
        with pytest.raises(RuntimeError, match="CUDA error"):
            ws._call(libs["w4"], entry, ctypes.byref(ws.Rays()),
                     ctypes.byref(cls()), None, entries=ws.ENTRIES)
    call = next(c for c in bounces["cornell"] if c[0] == MAT_DIFFUSE)
    mt, ctx, draws, packed, m, acc = call
    with pytest.raises(TypeError):       # float64 rays
        ws._kernel_shade(mt, ctx.__class__(**{**ctx.__dict__, "P": ctx.P.double()}),
                         draws, packed, m, _copy(acc), lib=libs["w4"])
    assert ws.launches() == before


def test_the_wrappers_run_the_plain_block_on_cpu_tensors(bounces):
    """On CPU tensors a wrapper is the plain dispatch itself, and launches
    nothing."""
    before = ws.launches()
    for scene in ("cornell", "beach_ball"):
        for mt, ctx, draws, packed, m, acc in bounces[scene]:
            got = ws._WRAPPER[mt](ctx, draws, packed, m, acc)
            want = acc.merge(ws._plain(mt, ctx, draws, None), m)
            assert field_differences(got, want) == {}
    assert ws.launches() == before


# ---------------------------------------------------------------------------
# routing and autograd through the emu library
# ---------------------------------------------------------------------------


def routed(lib):
    """trace's W4 wrappers sent to `lib` on CPU tensors."""
    def route(mt, real):
        def f(ctx, draws, packed, m, acc):
            return ws._kernel_shade(mt, ctx, draws, packed, m, acc, lib=lib)
        return f
    return wrappers_replaced(route)


@pytest.mark.parametrize("scene", ["cornell", "beach_ball"])
def test_a_render_through_w4_equals_the_plain_render(libs, scene, tmp_path):
    make = _scenes(tmp_path)[scene]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with exact_math():
            want = make().render(samples_per_pixel=2, device="cpu", seed=5,
                                 output="linear")
            before = ws.launches()
            with routed(libs["w4"]):
                got = make().render(samples_per_pixel=2, device="cpu", seed=5,
                                    output="linear")
            launched = ws.launches() - before
    finally:
        torch.set_num_threads(n)
    assert launched > 0
    assert (got == want).all()


def _gradient(lib=None, seed=0):
    from raytracer_tpu_torch.diff import differentiable_render, update_materials

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


def test_the_gradient_through_w4_is_the_plain_blocks(libs):
    """The inverse-rendering IoR gradient with the refractive block through
    `_Shade` (W4 forward, the plain block's backward) equals the plain
    dispatch's bit for bit, and two backward passes agree bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        before = ws.shade_refractive.launches
        loss_p, g_p = _gradient()
        plain_launches = ws.shade_refractive.launches - before
        loss_a, g_a = _gradient(libs["w4"])
        launched = ws.shade_refractive.launches - before
        _, g_b = _gradient(libs["w4"])
    finally:
        torch.set_num_threads(n)
    assert plain_launches == 0 and launched > 0
    assert torch.equal(loss_a, loss_p)
    assert bool((g_p != 0).all())
    assert torch.equal(g_a, g_p)
    assert torch.equal(g_b, g_a)
