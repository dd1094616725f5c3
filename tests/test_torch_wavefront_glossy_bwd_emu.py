"""W4's glossy backward kernel, run on the CPU through the stand-in CUDA
runtime.

g++ compiles csrc/wavefront_glossy_bwd.cu (its headers written in, so that
a mutant may edit them) against csrc/emu/cuda_runtime.h with W4_TORCH_CPU:
the source then restates torch's CPU ops (csrc/torch_math.cuh) and pow's
and sqrt's backward through float64, as the plain block runs here under
`exact_math`.  ops/wavefront_shade.py `glossy_vjp` takes the library as
`lib=` with CPU tensors; every gradient it returns (the merged fields'
pass-through gradients, then those of the block's inputs) is held against
the plain block's VJP (`plain_shade_vjp`) by its bits: +0 and -0 differ,
NaN equals NaN, and one the plain VJP leaves None must be None.

The cases: the glossy calls of 16x16 renders of the primitives (a
directional and a spot light, shadow rays, the gold ring's roughness 0, a
nearest checker on the floor), the primitives with two more directional
lights and a point light (each kind of light, and a light table of more
than one row), and mirrors that cast no shadow (no shadow rays) under a
point and a directional light, with a bilinear checker (uv's gradient):
each with output gradients drawn from a numpy seed (mixed scales, -0, +0
and NaN among them, some None) and a random subset of wanted inputs, the
textures among them (their gradients from the kernel's texel taps' rows); a
call of each scene with every gradient wanted, and with its rays picked
(`ws.pick_rays`), and with a third of its normals facing away from the
ray; and the backward calls of the primitives' 16x16
gradient with respect to glossy_color and glossy_n_re, and the mirrors'
with respect to their texture and glossy_color, recorded
(`plain_grad.recording`) and replayed through both.  Each mutant of
MUTANTS makes some case fail.

W4's forward (csrc/wavefront_shade.cu) is not built here: the gradients
are recorded with `ws._launch` replaced by the plain block merged in place
(tests/test_torch_wavefront_shade_bwd_emu.py `plain_forward`).
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

import raytracer_tpu_torch as T
from raytracer_tpu_torch.diff import differentiable_render, update_materials
from raytracer_tpu_torch.materials import shade
from raytracer_tpu_torch.materials.base import MAT_GLOSSY
from raytracer_tpu_torch.ops import wavefront_shade as ws
from raytracer_tpu_torch.ops.plain_grad import recording

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import _procedural  # noqa: E402
from test_torch_wavefront_shade_bwd_emu import (bits_differ, one_thread,  # noqa: E402
                                                plain_forward)
from test_torch_wavefront_shade_emu import (CSRC, GXX_FLAGS, _gxx, capture,  # noqa: E402
                                            exact_math, wrappers_replaced)
import torch_primitives  # noqa: E402

W = H = 16
HEADERS = ("grad_acc.cuh", "texture_fetch.cuh", "torch_math.cuh")

MUTANTS = {
    # the lights' terms first light first (the engine runs the add chain's
    # last term first)
    "lights_in_order": [("  for (int l = lights - 1; l >= 0; --l) {",
                         "  for (int l = 0; l < lights; ++l) {")],
    # pow's exponent gradient without its mask at base 0 (log 0 = -inf)
    "pow_exponent_unmasked": [
        ("  *ga = (float)(gd * (bd == 0.0 && ad >= 0.0 ? 0.0 : pow(bd, ad) * log(bd)));",
         "  *ga = (float)(gd * (pow(bd, ad) * log(bd)));")],
    # the diffuse colour's buffer taking the ambient term's share first
    "ambient_first": [("      t[c] = Gl[c] * B.ambient[c];\n    }\n    put3_at(dcb, fl, F_DCB, t);\n",
                       "    }\n"),
                      ("#pragma unroll 1\n    for (int l = lights - 1; l >= 0; --l) {",
                       "    for (int c = 0; c < 3; ++c) t[c] = Gl[c] * B.ambient[c];\n"
                       "    if (act) put3_at(dcb, fl, F_DCB, t);\n"
                       "#pragma unroll 1\n    for (int l = lights - 1; l >= 0; --l) {")],
    # the cone's t taking 3 - 2t's share last, not first
    "cone_t_order": [("          put(tb, -(coneb * (tc * tc)) * 2.0f);\n", ""),
                     ("          put(tb, g269 * tc);\n          put(tb, g269 * tc);\n",
                      "          put(tb, g269 * tc);\n          put(tb, g269 * tc);\n"
                      "          put(tb, -(coneb * (tc * tc)) * 2.0f);\n")],
    # a tile row off by one element: the mask of an element's ray read at
    # the next element's
    "tile_row_off_by_one": [("      const bool mk = B.m[r0 + e / 3] != 0;",
                             "      const bool mk = B.m[r0 + (e + 1) / 3] != 0;")],
    # one packed flag bit shared by two buffers: N's and P's (m_re's and
    # m_im's take their first gradients together: sharing theirs is
    # equivalent)
    "flag_bit_shared": [("F_LN = 2u, F_LP = 4u,", "F_LN = 2u, F_LP = 2u,")],
}


def _source(edits=()):
    text = (CSRC / "wavefront_glossy_bwd.cu").read_text()
    for header in HEADERS:
        text = text.replace(f'#include "{header}"\n',
                            (CSRC / header).read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: the backward kernel ("w4g") and each mutant of
    MUTANTS, g++ builds against the stand-in runtime, all started
    together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4gbwd")
    procs = {}
    for name, edits in [("w4g", ())] + list(MUTANTS.items()):
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


def never(sc):
    sc.settings = T.RenderSettings(use_pallas="never")
    return sc


def lights(m=T, width=W, height=H):
    """The primitives with two more directional lights and a point light."""
    sc = torch_primitives.primitives(width, height, m=m)
    sc.add_DirectionalLight(Ldir=m.vec3(-0.3, 0.8, 0.5), color=m.rgb(0.1, 0.12, 0.15))
    sc.add_DirectionalLight(Ldir=m.vec3(0.1, 0.9, -0.4), color=m.rgb(0.05, 0.04, 0.03))
    sc.add_PointLight(pos=m.vec3(0.5, 1.5, -1.0), color=m.rgb(0.3, 0.3, 0.3))
    return sc


def mirrors(m=T, width=W, height=H):
    """Glossy spheres and a floor with a bilinear checker, none casting a
    shadow, under a point and a directional light."""
    proc = _procedural(m)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.06))
    sc.add_Camera(look_from=m.vec3(0, 0.6, 2.4), look_at=m.vec3(0, 0.1, 0),
                  screen_width=width, screen_height=height, field_of_view=50)
    sc.add_DirectionalLight(Ldir=m.vec3(0.3, 0.8, 0.4), color=m.rgb(0.4, 0.4, 0.35))
    sc.add_PointLight(pos=m.vec3(-1.0, 1.5, 1.0), color=m.rgb(0.5, 0.45, 0.4))
    floor = m.Glossy(diff_color=m.image(proc.checkerboard(32), repeat=2.0,
                                        filter="bilinear"),
                     n=m.vec3(1.5, 1.5, 1.5), roughness=0.3, diff_coeff=0.8,
                     spec_coeff=0.2)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, 0), width=10, height=10,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1), shadow=False))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.7, 0.3, 0.2),
                                      n=m.vec3(1.2 + 2.0j, 1.1 + 2.2j, 1.0 + 2.4j),
                                      roughness=0.1, spec_coeff=0.5, diff_coeff=0.5),
                    center=m.vec3(-0.5, 0.0, -0.3), radius=0.5, shadow=False))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.2, 0.4, 0.8),
                                      n=m.vec3(1.6, 1.6, 1.6), roughness=0.0,
                                      spec_coeff=0.7, diff_coeff=0.3),
                    center=m.vec3(0.6, 0.1, 0.1), radius=0.4, shadow=False))
    return sc


SCENES = {
    "primitives": lambda: never(torch_primitives.primitives(W, H)),
    "lights": lambda: never(lights()),
    "mirrors": lambda: never(mirrors()),
}
NW = len(ws.WRITTEN[MAT_GLOSSY])
NI = len(ws._GLOSS_INPUTS)


def draw_grads(rng, n, none=0.3, nan=True):
    """The output gradients of the four fields the entry writes for n rays
    (each None with probability `none`): normals at one of three scales,
    with -0, +0 and (where `nan`) NaN among them."""
    out = []
    for _ in range(NW):
        if rng.random() < none:
            out.append(None)
            continue
        g = (rng.normal(size=(n, 3)) * rng.choice([1e-3, 1.0, 1e3])).astype(np.float32)
        g[rng.random((n, 3)) < 0.05] = -0.0
        g[rng.random((n, 3)) < 0.05] = 0.0
        if nan:
            g[rng.random((n, 3)) < 0.01] = np.nan
        out.append(torch.from_numpy(g))
    if all(g is None for g in out):
        out[int(rng.integers(NW))] = torch.from_numpy(
            rng.normal(size=(n, 3)).astype(np.float32))
    return out


def _wants(rng, n_tex, p=0.7):
    """A random subset of the pass-through and input gradients wanted, the
    textures' among them."""
    return tuple(bool(w) for w in rng.random(NW + NI + n_tex) < p)


def occlusion(ctx):
    with torch.no_grad():
        nudged, rays = shade.light_rays(ctx)
        return shade.light_occlusion(ctx, nudged, rays)


def routed(bwd_lib):
    """trace's W4 wrappers through `_Shade` on CPU tensors, the glossy
    block's backward from `bwd_lib` (None: the plain VJP)."""
    def route(mt, real):
        def f(ctx, draws, packed, m, acc):
            return ws._kernel_shade(mt, ctx, draws, packed, m, acc,
                                    bwd_lib={MAT_GLOSSY: bwd_lib} if bwd_lib else None)
        return f
    return wrappers_replaced(route)


def table_gradient(make, bwd_lib=None, calls=None, spp=1):
    """d loss / d (glossy_color, glossy_n_re) of a 16x16 render of make()
    on the CPU, its W4 calls through `_Shade` (`routed`), the backward calls
    of `_Shade` appended to `calls` where given."""
    fn, data = differentiable_render(make(), spp, seed=3, device="cpu")
    xs = [getattr(data.mats, k).clone().requires_grad_() for k in ("glossy_color",
                                                                   "glossy_n_re")]
    rec = recording(calls, ws._Shade) if calls is not None else contextlib.nullcontext()
    with exact_math(), plain_forward(), routed(bwd_lib), rec:
        img = fn(update_materials(data, glossy_color=xs[0], glossy_n_re=xs[1]))
        return torch.autograd.grad((img ** 2).mean(), xs)


def texture_gradient(make, bwd_lib=None, calls=None, spp=1):
    """d loss / d (every texture, glossy_color) of a 16x16 render of
    make() on the CPU, as `table_gradient`."""
    fn, data = differentiable_render(make(), spp, seed=3, device="cpu")
    xs = [t.clone().requires_grad_() for t in data.textures]
    x = data.mats.glossy_color.clone().requires_grad_()
    rec = recording(calls, ws._Shade) if calls is not None else contextlib.nullcontext()
    with exact_math(), plain_forward(), routed(bwd_lib), rec:
        img = fn(update_materials(dataclasses.replace(data, textures=tuple(xs)),
                                  glossy_color=x))
        return torch.autograd.grad((img ** 2).mean(), [*xs, x], allow_unused=True)


def _with_normals_flipped(call, rng):
    """The call with a third of its normals facing away from the ray: N.H
    and N.V at or below 0 (the Blinn-Phong power's base clamped to 0)."""
    mt, ctx, draws, packed, m, acc = call
    flip = torch.from_numpy(rng.random(ctx.N.shape[0]) < 0.33)[:, None]
    return mt, dataclasses.replace(ctx, N=torch.where(flip, -ctx.N, ctx.N)), draws, packed, m, acc


@pytest.fixture(scope="module")
def cases(libs):
    """[(label, kernel(lib) -> gradients, plain gradients, GlossSaved)]."""
    rng = np.random.default_rng(27)
    out = []

    def add(label, call, grads, wants):
        mt, ctx, draws, packed, m, _ = call
        occ = occlusion(ctx)
        s = ws.gloss_saved(ctx, draws, packed, m, occ)
        out.append((label, lambda lib, a=(grads, s, wants): ws.glossy_vjp(*a, lib),
                    ws.plain_shade_vjp(mt, ctx, None, m, occ, grads, wants), s))

    with one_thread(), exact_math():
        for name, make in SCENES.items():
            calls = [c for c in capture(make()) if c[0] == MAT_GLOSSY]
            n_tex = len(calls[0][1].data.textures)
            for k, call in enumerate(calls[:4]):
                add(f"{name} {k} drawn", call, draw_grads(rng, call[4].shape[0]),
                    _wants(rng, n_tex))
            call = calls[len(calls) // 2]
            n = call[4].shape[0]
            add(f"{name} all", call, draw_grads(rng, n, none=0.0),
                (True,) * (NW + NI + n_tex))
            idx = torch.from_numpy(rng.permutation(n)[:max(n // 2, 1)])
            add(f"{name} picked", ws.pick_rays(calls[0], idx),
                draw_grads(rng, idx.shape[0]), _wants(rng, n_tex))
            add(f"{name} flipped", _with_normals_flipped(call, rng),
                draw_grads(rng, n, none=0.0, nan=False),
                (True,) * (NW + NI + n_tex))
        out += recorded_cases(libs["w4g"])
    return out


def recorded_cases(lib):
    """The recorded glossy calls (as `cases` lists them) of the primitives'
    table gradient and of the mirrors' gradient with respect to their
    bilinear texture (`texture_gradient`), through the kernel from lib."""
    out = []
    for label, grad, scene in (("primitives", table_gradient, "primitives"),
                               ("textures", texture_gradient, "mirrors")):
        calls = []
        grad(SCENES[scene], lib, calls)
        for k, (fn, call, xs, grads, wants) in enumerate(calls):
            if call[0] != MAT_GLOSSY:
                continue
            kernel, plain = ws.backward_pair(fn, call, xs, grads, wants)
            out.append((f"{label} recorded {k}",
                        lambda lib, r=(fn, call, xs, grads, wants):
                        ws.backward_pair(*r, lib)[0](), plain(),
                        ws.gloss_saved(*call[1:5], call[6])))
    return out


def texture_cases(rng):
    """The glossy calls of the primitives (a nearest texture) and the
    mirrors (a bilinear one) with every texture's gradient wanted, output
    gradients drawn from rng (as `cases` lists them)."""
    out = []
    for name in ("primitives", "mirrors"):
        calls = [c for c in capture(SCENES[name]()) if c[0] == MAT_GLOSSY]
        for k, call in enumerate(calls[:2]):
            mt, ctx, draws, packed, m, _ = call
            occ = occlusion(ctx)
            grads = draw_grads(rng, m.shape[0], none=0.0)
            wants = (True,) * (NW + NI + len(ctx.data.textures))
            s = ws.gloss_saved(ctx, draws, packed, m, occ)
            out.append((f"{name} textures {k}", lambda lib, a=(grads, s, wants):
                        ws.glossy_vjp(*a, lib),
                        ws.plain_shade_vjp(mt, ctx, None, m, occ, grads, wants), s))
    return out


def failures(cases, lib, first=False):
    """[(case, gradient index)] where the kernel from lib and the plain VJP
    disagree."""
    bad = []
    with one_thread(), exact_math():
        for label, kernel, want, _ in cases:
            for i, (a, b) in enumerate(zip(kernel(lib), want)):
                if bits_differ(a, b):
                    bad.append((label, i))
                    if first:
                        return bad
    return bad


def test_w4_glossy_backward_equals_the_plain_vjp(libs, cases):
    before = ws.backward_launches()["shade_glossy_bwd"]
    assert failures(cases, libs["w4g"]) == []
    got = ws.backward_launches()["shade_glossy_bwd"] - before
    assert len(cases) // 2 < got <= len(cases)


def test_the_cases_hold_what_they_are_for(cases):
    """Each kind of light, a light table of several rows, no shadow rays,
    roughness 0 and normals facing away on the block's rays, a bilinear
    texture's uv and the recorded gradients' tables are among the held
    cases."""
    seen = dict.fromkeys(("dir", "point", "spot", "rows", "no_shadow", "rough0",
                          "bilinear", "facing_away", "nearest_texture",
                          "bilinear_texture"), 0)
    uv = NW + ws._GLOSS_INPUTS.index("uv")
    for label, _, want, s in cases:
        if any(g is not None and bool((g != 0).any()) for g in want[NW + NI:]):
            seen["bilinear_texture" if s.bilinear else "nearest_texture"] += 1
        nd, np_, ns = s.kinds
        seen["dir"] += nd
        seen["point"] += np_
        seen["spot"] += ns
        seen["rows"] += int(max(s.kinds) > 1)
        seen["no_shadow"] += int(s.occ is None)
        rough = s.rough[shade.slot_rows(s.mat_slot, s.rough)]
        seen["rough0"] += int(((rough == 0) & s.m).sum())
        seen["bilinear"] += int(s.bilinear and want[uv] is not None)
        seen["facing_away"] += int((((s.N * s.D).sum(-1) > 0) & s.m).sum())
    assert all(v > 0 for v in seen.values()), seen
    k = NW + ws._GLOSS_INPUTS.index("glossy_color")
    for label in ("primitives", "textures"):
        rec = [c for c in cases if c[0].startswith(f"{label} recorded")]
        assert rec and any(c[2][k] is not None and bool((c[2][k] != 0).any())
                           for c in rec), label


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant


def test_the_gradient_through_the_kernel_is_the_plain_blocks(libs):
    """The primitives' glossy_color and glossy_n_re gradients with the
    glossy backward from the kernel equal those through the plain VJP bit
    for bit, in one launch a backward call and no plain glossy route."""
    make = SCENES["primitives"]
    with one_thread():
        ws.reset_launches()
        plain = table_gradient(make)
        assert ws.backward_launches()["shade_glossy_bwd"] == 0
        assert ws.plain_routes["glossy"] > 0
        ws.reset_launches()
        calls = []
        got = table_gradient(make, libs["w4g"], calls)
    n_calls = sum(1 for c in calls if c[1][0] == MAT_GLOSSY)
    assert n_calls > 0 and ws.backward_launches()["shade_glossy_bwd"] == n_calls
    assert ws.plain_routes["glossy"] == 0
    for a, b in zip(got, plain):
        assert bool((b != 0).any())
        assert not bits_differ(a, b)


def test_a_texture_gradient_through_the_kernel_is_the_plain_blocks(libs):
    """The mirrors' gradient with respect to their bilinear texture and
    glossy_color, with the glossy backward from the kernel (its taps'
    rows), equals the one through the plain VJP bit for bit, in one launch
    a backward call and no plain glossy route."""
    make = SCENES["mirrors"]
    with one_thread():
        ws.reset_launches()
        plain = texture_gradient(make)
        assert ws.plain_routes["glossy"] > 0
        ws.reset_launches()
        calls = []
        got = texture_gradient(make, libs["w4g"], calls)
    n_calls = sum(1 for c in calls if c[1][0] == MAT_GLOSSY)
    assert n_calls > 0 and ws.backward_launches()["shade_glossy_bwd"] == n_calls
    assert not any(ws.plain_routes.values())
    assert plain[0] is not None and bool((plain[0] != 0).any())
    assert not any(bits_differ(a, b) for a, b in zip(got, plain))


def test_a_refused_launch_raises_and_counts_nothing(libs):
    before = ws.backward_launches()["shade_glossy_bwd"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ws._call(libs["w4g"], "shade_glossy_bwd", ctypes.byref(ws.GlossBwd()), None,
                 entries=ws.ENTRIES)
    assert ws.backward_launches()["shade_glossy_bwd"] == before
