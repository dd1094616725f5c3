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

The diffuse and refractive entries, which queue their rays through one
device template (`shade_queued`), are held on a bounce's rays picked into
type patterns (Cornell's and the 131 lamps' diffuse calls, Cornell's and
the split scene's refractive ones).  A second build without W4_TORCH_CPU
(the card's arithmetic) holds the diffuse entry's caps sum in registers
(`reg_sum`, `ws.caps_sum`) equal to the general restatement of ATen's
plan (`aten_sum`) for every K from 1 to 127, and the general one, where
ATen splits a row across blocks (few rows of 131,072 or more terms), equal
to scripts/torch_op_rounding.py's restatement of that order for the
stand-in's two SMs; a third build, the stand-in reporting the H100's 132
SMs, holds it so on rows that ATen splits across more blocks than a warp
has lanes, where the order of the last block's two trees shows.  The
source mutants, each of which must make some of
these cases fail, are held in tests/test_torch_wavefront_shade_mutants_emu.py
(built apart, so that the two files run on two workers).  The routing and
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
# the card's arithmetic: the caps sum in ATen's order
CARD_FLAGS = tuple(f for f in GXX_FLAGS if f != "-DW4_TORCH_CPU")
# the SMs the H100 has, which the stand-in then reports to ATen's plan
H100_SMS = 132
W, H = 16, 16
ULPS = 4
NAMES = {MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
         MAT_GLOSSY: "glossy"}
NEVER = T.RenderSettings(use_pallas="never")


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W4 for the CPU")
    return gxx


def _source(edits=()):
    """The source with its headers (csrc/aten_sum.cuh, the sums; csrc/
    torch_math.cuh, torch's elementwise ops; csrc/texture_fetch.cuh, the
    texture fetch) written in, so that an edit may change any of them, and
    `edits` made."""
    text = (CSRC / "wavefront_shade.cu").read_text()
    for header in ("aten_sum.cuh", "torch_math.cuh", "texture_fetch.cuh"):
        text = text.replace(f'#include "{header}"\n',
                            (CSRC / header).read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def build_libs(tmp_path_factory, builds, flags=GXX_FLAGS):
    """{name: library}: a g++ build against the stand-in runtime of each
    (name, source edits, more flags...) of `builds`, all started
    together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4emu")
    procs = {}
    for name, edits, *more in builds:
        src = d / f"{name}.cu"
        src.write_text(_source(edits))
        procs[name] = subprocess.Popen(
            [gxx, *flags, *more, "-I", str(CSRC / "emu"), "-x", "c++", str(src),
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
    """{"w4": W4}, a g++ build against the stand-in runtime (its source
    mutants are built in tests/test_torch_wavefront_shade_mutants_emu.py)."""
    return build_libs(tmp_path_factory, [("w4", ())])


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
# the queued entries (refractive, diffuse) on type patterns
# ---------------------------------------------------------------------------

# (rays, positions of the entry's rays) of each pattern; the stand-in
# gives a grid of two blocks, so past 2 x 1,024 rays a block takes several
# tiles of 1,024 and carries rays over from one to the next
PATTERNS = ("none", "one", "scattered", "runs", "all", "ragged", "small")
# the scenes whose call with the most rays of each queued entry's type is
# picked into the patterns: Cornell's two caps and the split scene's
# refractive rays, Cornell's and the 131 lamps' diffuse rays
PATTERN_SCENES = {MAT_REFRACTIVE: ("cornell", "split"),
                  MAT_DIFFUSE: ("cornell", "lamps")}


def _typed_at(name, rng):
    if name == "none":
        return torch.zeros(3000, dtype=torch.bool)
    if name == "one":
        at = torch.zeros(3000, dtype=torch.bool)
        at[1777] = True
        return at
    if name == "scattered":                   # ~1.5%
        return torch.from_numpy(rng.random(6000) < 0.015)
    if name == "runs":                        # runs of 30-130 rays, ~14%
        at = torch.zeros(6000, dtype=torch.bool)
        while int(at.sum()) < 840:
            s = int(rng.integers(0, 6000))
            at[s:s + int(rng.integers(30, 131))] = True
        return at
    if name == "all":                         # 2,100: no multiple of 32
        return torch.ones(2100, dtype=torch.bool)
    if name == "ragged":                      # 4,133 = 4 tiles + 37
        return torch.from_numpy(rng.random(4133) < 0.14)
    return torch.from_numpy(rng.random(19) < 0.4)      # small: n < 32


@pytest.fixture(scope="module")
def patterns(bounces):
    """{(type, scene, pattern): (call, the plain dispatch's output)}: the
    call of each queued entry's type with the most rays of that type in
    each of its PATTERN_SCENES, its rays picked into each pattern
    (`ws.pick_rays`: a ray of the type where the pattern has one, another
    type's elsewhere, each from the call's own rays of that kind)."""
    import numpy as np

    out = {}
    for mt, scenes in PATTERN_SCENES.items():
        for scene in scenes:
            call = max((c for c in bounces[scene] if c[0] == mt),
                       key=lambda c: int(c[4].sum()))
            m = call[4]
            rng = np.random.default_rng(11)
            typed, other = m.nonzero()[:, 0], (~m).nonzero()[:, 0]
            for name in PATTERNS:
                at = _typed_at(name, rng)
                idx = torch.empty(at.shape[0], dtype=torch.int64)
                k = int(at.sum())
                idx[at] = typed[torch.from_numpy(rng.integers(0, typed.shape[0], k))]
                idx[~at] = other[torch.from_numpy(
                    rng.integers(0, other.shape[0], at.shape[0] - k))]
                picked = ws.pick_rays(call, idx)
                assert torch.equal(picked[4], at)
                out[mt, scene, name] = picked, plain_out(picked)
    return out


def _pattern_holds(libs, patterns, mt, scene, pattern):
    call, want = patterns[mt, scene, pattern]
    before = ws._WRAPPER[mt].launches
    assert field_differences(w4_out(call, libs["w4"]), want) == {}
    assert ws._WRAPPER[mt].launches - before == 1


@pytest.mark.parametrize("scene", ["cornell", "split"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_refractive_queue_on_a_type_pattern(libs, patterns, scene, pattern):
    """The refractive entry on a bounce's rays picked into a type pattern
    (none of the type, one ray, ~1.5% scattered, runs of ~14%, all of it,
    a count that is no multiple of a tile or a warp, fewer than 32 rays):
    every field of every ray as the plain dispatch's, in one launch."""
    _pattern_holds(libs, patterns, MAT_REFRACTIVE, scene, pattern)


@pytest.mark.parametrize("scene", ["cornell", "lamps"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_diffuse_queue_on_a_type_pattern(libs, patterns, scene, pattern):
    """The diffuse entry, which queues its rays through the same device
    template, on Cornell's (two caps) and the 131 lamps' diffuse rays
    picked into each type pattern: every field of every ray as the plain
    dispatch's, in one launch."""
    _pattern_holds(libs, patterns, MAT_DIFFUSE, scene, pattern)


# ---------------------------------------------------------------------------
# the card's caps sum in registers, built without W4_TORCH_CPU
# ---------------------------------------------------------------------------

SUM_ROWS = (16, 37, 1000)


@pytest.fixture(scope="module")
def sum_libs(tmp_path_factory):
    """{"card": W4 built with the card's arithmetic (no W4_TORCH_CPU),
    "h100": the same with the stand-in reporting the H100's SMs}, for
    `ws.caps_sum` (its mutants are built in
    tests/test_torch_wavefront_shade_mutants_emu.py)."""
    return build_libs(tmp_path_factory, [("card", ()),
                                         ("h100", (), f"-DCUDA_EMU_SMS={H100_SMS}")],
                      CARD_FLAGS)


def _sum_rows(n, K, seed):
    """(n, K) float32 rows of mixed signs and magnitudes, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K)) * 10.0 ** rng.uniform(-3, 3, (n, K))
    return torch.from_numpy(x.astype(np.float32))


def _sum_bits_differ(lib, n, K):
    x = _sum_rows(n, K, 1000 * n + K)
    a = ws.caps_sum(x, lib=lib)
    b = ws.caps_sum(x, wide=True, lib=lib)
    return not torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", SUM_ROWS)
def test_the_register_sum_equals_the_general_sum(sum_libs, n):
    """The caps pdf's sum in registers (`reg_sum`, every plan below K =
    128) against the general restatement of ATen's plan (`aten_sum`) on n
    rows, bit for bit, for every K from 1 to 127."""
    assert [K for K in range(1, 128) if _sum_bits_differ(sum_libs["card"], n, K)] == []


def test_the_register_sum_refuses_a_wide_plan(sum_libs):
    """From K = 128 torch's plan loads four values at a time: the register
    sum refuses it, the general one takes it."""
    x = _sum_rows(40, 128, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ws.caps_sum(x, lib=sum_libs["card"])
    assert ws.caps_sum(x, wide=True, lib=sum_libs["card"]).shape == (40,)


# (rows, K) where ATen splits each row across blocks on the stand-in's two
# SMs: 3, 4, 2 and 2 blocks a row
SPLIT_SUMS = [(3, 131_072), (2, 131_075), (8, 150_000), (5, 200_000)]


def _rounding():
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_op_rounding

    return torch_op_rounding


def _split_sum_differs(lib, n, K, sms=2):
    """Whether the general caps sum of `lib` (built for `sms` SMs)
    differs, on (n, K) rows where torch.sum splits each row across blocks,
    from scripts/torch_op_rounding.py `aten_sum` for those SMs."""
    rounding = _rounding()
    plan = rounding.sum_plan(K, n, sms=sms)
    assert plan[3] > 1, plan
    x = _sum_rows(n, K, 7 * n + K)
    got = ws.caps_sum(x, wide=True, lib=lib)
    want = rounding.aten_sum(torch, x, sms=sms)
    return not torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n, K", SPLIT_SUMS)
def test_the_split_sum_is_atens_order(sum_libs, n, K):
    """Where torch.sum splits a row across blocks (`sum_plan`'s ctas > 1),
    the general caps sum (each block's sum by the block's threads, staged,
    then added as ATen's last block adds them) equals
    scripts/torch_op_rounding.py `aten_sum`, the same order restated in
    torch ops (which that script holds against torch.sum on the card), for
    the stand-in's two SMs."""
    assert not _split_sum_differs(sum_libs["card"], n, K)


# (rows, K) where ATen splits each row across more blocks than a warp has
# lanes on the H100 (33 blocks of 32 lanes): the last block's thread
# x + y bx then holds a staged sum for warps past the first, and its
# trees' order (the warps' then the lanes', or the lanes' then the
# warps') shows in the sum.  One case: the stand-in runs its 528 blocks
# of 512 threads in ~20 s (the card tests also hold 2 x 2,200,000)
H100_SPLIT_SUMS = [(16, 300_000)]


@pytest.mark.parametrize("n, K", H100_SPLIT_SUMS)
def test_the_split_sum_past_the_lanes_is_atens_order(sum_libs, n, K):
    """On rows split across more blocks than a warp has lanes, with the
    stand-in reporting the H100's SMs, the general caps sum equals
    scripts/torch_op_rounding.py `aten_sum` (the warps' tree, then the
    lanes'), where the other order of those trees gives other bits."""
    rounding = _rounding()
    _, bx, _, ctas = rounding.sum_plan(K, n, sms=H100_SMS)
    assert ctas > bx, (ctas, bx)
    x = _sum_rows(n, K, 7 * n + K)
    other = rounding.aten_sum(torch, x, sms=H100_SMS, last="xy")
    want = rounding.aten_sum(torch, x, sms=H100_SMS)
    assert not torch.equal(other.view(torch.int32), want.view(torch.int32))
    assert not _split_sum_differs(sum_libs["h100"], n, K, H100_SMS)


QUEUED_SASS = """
        Function : _ZN2w423shade_refractive_kernelENS_4RaysENS_10RefractiveE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*0020*/               @P0 BRA 0x70 ;
        /*0030*/                   LDG.E R4, [R5.64] ;
        /*0040*/                   VOTE.ANY R6, PT, P1 ;
        /*0050*/              @!P2 BRA 0x60 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   ISETP.GE.AND P3, PT, R7, 0x100, PT ;
        /*0080*/              @!P3 BRA 0xe0 ;
        /*0090*/                   ISETP.GE.AND P4, PT, R8, R9, PT ;
        /*00a0*/               @P4 BRA 0xd0 ;
        /*00b0*/                   FMUL R10, R11, R12 ;
        /*00c0*/                   FMUL R10, R10, R12 ;
        /*00d0*/               @P5 BRA 0x70 ;
        /*00e0*/              @!P6 BRA 0x10 ;
        /*00f0*/                   EXIT ;
"""


def test_queued_pass_counts_a_tile_and_a_round():
    """The refractive entry's bound reads off its SASS (probes/common.py
    `queued_pass`) one tile's queueing pass, the outer loop outside its
    inner loop with the tile branch taken (0x10-0x60 and 0xe0: 7), and
    one shading round, the inner loop with its shading taken (0x70-0xd0:
    7)."""
    from raytracer_tpu_torch.probes import common

    assert common.queued_pass(QUEUED_SASS, "shade_refractive_kernel") == (7, 7)
    with pytest.raises(ValueError):
        common.queued_pass(QUEUED_SASS.replace("@!P6 BRA 0x10", "@!P6 BRA 0x70"),
                           "shade_refractive_kernel")


ROUND_LOOP_SASS = """
        Function : _ZN2w420shade_diffuse_kernelENS_4RaysENS_7DiffuseENS_7SumPlanE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
        /*0020*/               @P0 BRA 0x70 ;
        /*0030*/                   LDG.E R4, [R5.64] ;
        /*0040*/                   VOTE.ANY R6, PT, P1 ;
        /*0050*/              @!P2 BRA 0x60 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   ISETP.GE.AND P3, PT, R7, 0x100, PT ;
        /*0080*/              @!P3 BRA 0x100 ;
        /*0090*/                   FMUL R10, R11, R12 ;
        /*00a0*/                   FADD R10, R10, R12 ;
        /*00b0*/               @P4 BRA 0x90 ;
        /*00c0*/                   ISETP.GE.AND P5, PT, R8, R9, PT ;
        /*00d0*/               @P5 BRA 0xf0 ;
        /*00e0*/                   FMUL R13, R10, R12 ;
        /*00f0*/               @P6 BRA 0x70 ;
        /*0100*/              @!P6 BRA 0x10 ;
        /*0110*/                   EXIT ;
"""


def test_queued_pass_counts_a_round_around_its_own_loops():
    """The diffuse entry's shading round holds loops of its own (the caps
    sum): `queued_pass` takes the widest loop inside the tile loop as the
    round (0x70-0xf0, its sum loop counted once, the branch over 0xe0
    taken: 9), not the innermost (0x90-0xb0), and the tile's queueing
    pass as for the refractive entry (0x10-0x60 and 0x100: 7)."""
    from raytracer_tpu_torch.probes import common

    assert common.queued_pass(ROUND_LOOP_SASS, "shade_diffuse_kernel") == (7, 9)


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
