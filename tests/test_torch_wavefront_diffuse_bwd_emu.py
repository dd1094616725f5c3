"""W4's diffuse backward kernel, run on the CPU through the stand-in CUDA
runtime.

g++ compiles csrc/wavefront_diffuse_bwd.cu (its headers written in, so that
a mutant may edit them) against csrc/emu/cuda_runtime.h with W4_TORCH_CPU:
the source then restates torch's CPU ops (csrc/torch_math.cuh), its sums
(csrc/aten_sum.cuh: the caps pdf's cascade sum, the sum over K of the
caps geometry's origin gradient) and sqrt's backward through float64, as
the plain block runs here under `exact_math`.  ops/wavefront_shade.py
`diffuse_vjp` takes the library as `lib=` with CPU tensors; every gradient
it returns (the merged fields' pass-through gradients, then those of the
block's inputs) is held against the plain block's VJP (`plain_shade_vjp`)
by its bits: +0 and -0 differ, NaN equals NaN, and one the plain VJP
leaves None must be None.

The cases: the diffuse calls of 16x16 renders of the cosine lobe alone
(the primitives' tube), two caps (Cornell, also with the i.i.d. sampler:
no stratified draws), 131 importance-sampled lamps (past ATen's 128 of
its four-wide loads), the environment's alias sample (the sun-and-sky
still life) and both, with image textures on the floor (bilinear) and the
sphere (nearest; one texture, two refs): each with output gradients
drawn from a numpy seed (mixed scales, -0, +0 and NaN among them, some
None) and a random subset of wanted inputs, the textures among them (their
gradients from the kernel's texel taps' rows); a call of each scene with every gradient wanted, and
with its rays picked (`ws.pick_rays`); a lamps call with the caps' radii
widened to 1.5 (a direction inside most caps: the sums over the caps of
many terms); and the backward calls of 16x16
gradients with respect to the diffuse colour (Cornell, the mixed scene)
and of the mixed scene's with respect to its textures recorded (`plain_grad.recording`) and replayed through both.  Each mutant
of MUTANTS makes some case fail.

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
from raytracer_tpu_torch.materials.base import MAT_DIFFUSE
from raytracer_tpu_torch.ops import wavefront_shade as ws
from raytracer_tpu_torch.ops.plain_grad import recording

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import _procedural  # noqa: E402
from test_torch_wavefront_shade_bwd_emu import (bits_differ, one_thread,  # noqa: E402
                                                plain_forward)
from test_torch_wavefront_shade_emu import (CSRC, GXX_FLAGS, _gxx, capture,  # noqa: E402
                                            exact_math, wrappers_replaced)
import torch_cornellbox  # noqa: E402
import torch_features  # noqa: E402
import torch_primitives  # noqa: E402
import torch_wavefront  # noqa: E402

W = H = 16
NEVER = T.RenderSettings(use_pallas="never")
HEADERS = ("aten_sum.cuh", "grad_acc.cuh", "texture_fetch.cuh", "torch_math.cuh")

MUTANTS = {
    # the nudged origin's buffer taking the caps sample's share before the
    # caps pdf's
    "origin_order": [("    if (pdf_grad && caps) put3(Bo, o_pdf);\n    if (smp) put3(Bo, o_smp);",
                      "    if (smp) put3(Bo, o_smp);\n    if (pdf_grad && caps) put3(Bo, o_pdf);")],
    # the jitter's where handing each branch the other's gradient
    "jv_branches_swapped": [("const float ga = ev.take ? jvb : 0.0f, gb = ev.take ? 0.0f : jvb;",
                             "const float ga = ev.take ? 0.0f : jvb, gb = ev.take ? jvb : 0.0f;")],
    # seg = (1 - w) / components: the division left out of w's gradient
    "seg_undivided": [("  if (segb.has) put(wb, -t_div_scalar(segb.v, (float)((caps ? 1 : 0) + "
                       "(env ? 1 : 0))));",
                       "  if (segb.has) put(wb, -segb.v);")],
    # sy's buffer taking the stack's share last, not first
    "sy_stack_last": [("    put(syb, genv[1]);\n", ""),
                      ("    put(syb, g77 * ev.sy);\n    put(syb, g77 * ev.sy);\n",
                       "    put(syb, g77 * ev.sy);\n    put(syb, g77 * ev.sy);\n"
                       "    put(syb, genv[1]);\n")],
}


def _source(edits=()):
    text = (CSRC / "wavefront_diffuse_bwd.cu").read_text()
    for header in HEADERS:
        text = text.replace(f'#include "{header}"\n',
                            (CSRC / header).read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: the backward kernel ("w4d") and each mutant of
    MUTANTS, g++ builds against the stand-in runtime, all started
    together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4dbwd")
    procs = {}
    for name, edits in [("w4d", ())] + list(MUTANTS.items()):
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


def never(sc, **kw):
    sc.settings = T.RenderSettings(use_pallas="never", **kw)
    return sc


def mixed(m=T, width=W, height=H):
    """The sun-and-sky still life (its sky importance-sampled) with an
    importance-sampled lamp, a bilinear checker on the floor and a nearest
    one on the red sphere: the cosine lobe, the caps and the environment
    in one mixture, and the colour's texture wheres."""
    proc = _procedural(m)
    checker = proc.checkerboard(32)
    sc = m.Scene(ambient_color=m.rgb(0.0, 0.0, 0.0))
    sc.add_Camera(look_from=m.vec3(0, 0.8, 3.2), look_at=m.vec3(0, 0.1, 0),
                  screen_width=width, screen_height=height, field_of_view=35)
    floor = m.Diffuse(diff_color=m.image(checker, repeat=3.0, filter="bilinear"),
                      diffuse_rays=1)
    red = m.Diffuse(diff_color=m.image(checker), diffuse_rays=1)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, 0), width=40, height=40,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=red, center=m.vec3(-0.9, 0.05, 0.2), radius=0.55))
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.3, 0.6, 0.4), diffuse_rays=1),
                    center=m.vec3(0.7, 0.1, -0.4), radius=0.6))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(4.0, 3.5, 3.0)),
                    center=m.vec3(0.2, 1.6, 0.3), radius=0.3), importance_sampled=True)
    sc.add_Background(torch_features.sun_sky(), spherical=True, linear=True,
                      importance_sampled=True)
    return sc


SCENES = {
    "cosine": lambda: never(torch_primitives.primitives(W, H)),
    "caps": lambda: never(torch_cornellbox.build_cornell(W, H)),
    "caps_iid": lambda: never(torch_cornellbox.build_cornell(W, H), sampler="iid"),
    "lamps": lambda: torch_wavefront.lamp_cluster(131, W, H),
    "env": lambda: torch_features.env_is(W, H),
    "mixed": lambda: never(mixed()),
}
NW = len(ws.WRITTEN[MAT_DIFFUSE])
NI = len(ws._DIFF_INPUTS)


def draw_grads(rng, n, none=0.3, nan=True):
    """The output gradients of the three fields the entry writes for n rays
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


def routed(bwd_lib):
    """trace's W4 wrappers through `_Shade` on CPU tensors, the diffuse
    block's backward from `bwd_lib` (None: the plain VJP)."""
    def route(mt, real):
        def f(ctx, draws, packed, m, acc):
            return ws._kernel_shade(mt, ctx, draws, packed, m, acc,
                                    bwd_lib={MAT_DIFFUSE: bwd_lib} if bwd_lib else None)
        return f
    return wrappers_replaced(route)


def color_gradient(make, bwd_lib=None, calls=None, spp=1):
    """d loss / d diffuse_color of a 16x16 render of make() on the CPU, its
    W4 calls through `_Shade` (`routed`), the backward calls of `_Shade`
    appended to `calls` where given."""
    fn, data = differentiable_render(make(), spp, seed=3, device="cpu")
    x = data.mats.diffuse_color.clone().requires_grad_()
    rec = recording(calls, ws._Shade) if calls is not None else contextlib.nullcontext()
    with exact_math(), plain_forward(), routed(bwd_lib), rec:
        loss = (fn(update_materials(data, diffuse_color=x)) ** 2).mean()
        g, = torch.autograd.grad(loss, x)
    return g


def texture_gradient(make, bwd_lib=None, calls=None, spp=1):
    """d loss / d (every texture, diffuse_color) of a 16x16 render of
    make() on the CPU, as `color_gradient`."""
    fn, data = differentiable_render(make(), spp, seed=3, device="cpu")
    xs = [t.clone().requires_grad_() for t in data.textures]
    x = data.mats.diffuse_color.clone().requires_grad_()
    rec = recording(calls, ws._Shade) if calls is not None else contextlib.nullcontext()
    with exact_math(), plain_forward(), routed(bwd_lib), rec:
        loss = (fn(update_materials(dataclasses.replace(data, textures=tuple(xs)),
                                    diffuse_color=x)) ** 2).mean()
        return torch.autograd.grad(loss, [*xs, x], allow_unused=True)


RECORDED = ("caps", "mixed")


@pytest.fixture(scope="module")
def cases(libs):
    """[(label, kernel(lib) -> gradients, plain gradients, DiffSaved)]."""
    rng = np.random.default_rng(26)
    out = []

    def add(label, call, grads, wants):
        mt, ctx, draws, packed, m, _ = call
        s = ws.diff_saved(ctx, draws, packed, m)
        out.append((label, lambda lib, a=(grads, s, wants): ws.diffuse_vjp(*a, lib),
                    ws.plain_shade_vjp(mt, ctx, draws[mt], m, None, grads, wants), s))

    with one_thread(), exact_math():
        for name, make in SCENES.items():
            calls = [c for c in capture(make()) if c[0] == MAT_DIFFUSE]
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
            if name == "lamps":
                # radii of 1.5: a direction inside most of the 131 caps, so
                # that most terms of the sums over the caps are not zero
                mt, ctx, draws, packed, m, acc = call
                wide = dataclasses.replace(ctx, data=dataclasses.replace(
                    ctx.data, is_radius=torch.full_like(ctx.data.is_radius, 1.5)))
                add("lamps wide", (mt, wide, draws, packed, m, acc),
                    draw_grads(rng, n, none=0.0, nan=False),
                    (True,) * (NW + NI + n_tex))
        out += recorded_cases(libs["w4d"])
    return out


def recorded_cases(lib):
    """The recorded diffuse calls (as `cases` lists them) of the colour
    gradients of RECORDED and of the mixed scene's gradient with respect
    to its textures (`texture_gradient`), through the kernel from lib."""
    out = []
    for scene, grad in [(s, color_gradient) for s in RECORDED] + [("textures",
                                                                   texture_gradient)]:
        calls = []
        grad(SCENES.get(scene, SCENES["mixed"]), lib, calls)
        for k, (fn, call, xs, grads, wants) in enumerate(calls):
            if call[0] != MAT_DIFFUSE:
                continue
            kernel, plain = ws.backward_pair(fn, call, xs, grads, wants)
            out.append((f"{scene} recorded {k}",
                        lambda lib, r=(fn, call, xs, grads, wants):
                        ws.backward_pair(*r, lib)[0](), plain(),
                        ws.diff_saved(*call[1:5])))
    return out


def texture_cases(rng):
    """The diffuse calls of the mixed scene (a bilinear and a nearest ref
    on one texture) with every texture's gradient wanted, output gradients
    drawn from rng (as `cases` lists them)."""
    out = []
    calls = [c for c in capture(SCENES["mixed"]()) if c[0] == MAT_DIFFUSE]
    for k, call in enumerate(calls[:3]):
        mt, ctx, draws, packed, m, _ = call
        grads = draw_grads(rng, m.shape[0], none=0.0)
        wants = (True,) * (NW + NI + len(ctx.data.textures))
        s = ws.diff_saved(ctx, draws, packed, m)
        out.append((f"mixed textures {k}", lambda lib, a=(grads, s, wants):
                    ws.diffuse_vjp(*a, lib),
                    ws.plain_shade_vjp(mt, ctx, draws[mt], m, None, grads, wants), s))
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


def test_w4_diffuse_backward_equals_the_plain_vjp(libs, cases):
    before = ws.backward_launches()["shade_diffuse_bwd"]
    assert failures(cases, libs["w4d"]) == []
    # one launch a case, none where nothing wanted is reached
    got = ws.backward_launches()["shade_diffuse_bwd"] - before
    assert len(cases) // 2 < got <= len(cases)


def test_the_cases_hold_what_they_are_for(cases):
    """Each branch of the mixture, caps past 128, the stratified and the
    i.i.d. draws, the bilinear texture's uv and the recorded gradients'
    tables are among the held cases."""
    seen = dict.fromkeys(("cosine", "caps", "env", "both", "past_128", "strat", "iid",
                          "bilinear", "texture", "two_refs"), 0)
    for label, _, want, s in cases:
        texs = [g for g in want[NW + NI:] if g is not None and bool((g != 0).any())]
        seen["texture"] += len(texs)
        seen["two_refs"] += int(bool(texs) and len({r[0] for r in s.refs}) < len(s.refs))
        caps, env = s.is_center is not None, s.env_prob is not None
        seen["cosine"] += int(not caps and not env)
        seen["caps"] += int(caps and not env)
        seen["env"] += int(env and not caps)
        seen["both"] += int(caps and env)
        seen["past_128"] += int(caps and s.is_center.shape[0] > 128)
        seen["strat"] += int(s.s_mix is not None)
        seen["iid"] += int(s.s_mix is None)
        seen["bilinear"] += int(s.bilinear and want[NW + ws._DIFF_INPUTS.index("uv")]
                                is not None)
    assert all(v > 0 for v in seen.values()), seen
    for scene in (*RECORDED, "textures"):
        rec = [c for c in cases if c[0].startswith(f"{scene} recorded")]
        k = NW + ws._DIFF_INPUTS.index("diffuse_color")
        assert rec and any(c[2][k] is not None and bool((c[2][k] != 0).any())
                           for c in rec), scene


def test_the_rows_route_of_split_sums_equals_the_plain_vjp(libs, cases, monkeypatch):
    """Where the engine's sum_to over K splits across blocks (thousands of
    caps on the card: `ws._outer_rows`), the kernel writes the nudged
    origin's shares as (N, K, 3) rows and the wrapper sums them by ATen's
    own op, then P's, eps's and N's last share: taken here on every case
    with caps (the route forced), every gradient bit for bit as before."""
    taken = []
    monkeypatch.setattr(ws, "_outer_rows", lambda *a: taken.append(a) or True)
    held = [c for c in cases if c[3].is_center is not None]
    assert held and failures(held, libs["w4d"]) == []
    assert taken


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant


def test_the_gradient_through_the_kernel_is_the_plain_blocks(libs):
    """Cornell's diffuse-colour gradient with the diffuse backward from the
    kernel equals the one through the plain VJP bit for bit, in one launch
    a backward call and no plain diffuse route."""
    make = SCENES["caps"]
    with one_thread():
        ws.reset_launches()
        plain = color_gradient(make)
        assert ws.backward_launches()["shade_diffuse_bwd"] == 0
        assert ws.plain_routes["diffuse"] > 0
        ws.reset_launches()
        calls = []
        got = color_gradient(make, libs["w4d"], calls)
    n_calls = sum(1 for c in calls if c[1][0] == MAT_DIFFUSE)
    assert n_calls > 0 and ws.backward_launches()["shade_diffuse_bwd"] == n_calls
    assert ws.plain_routes["diffuse"] == 0
    assert bool((plain != 0).any())
    assert not bits_differ(got, plain)


def test_a_texture_gradient_through_the_kernel_is_the_plain_blocks(libs):
    """The mixed scene's gradient with respect to its textures (a bilinear
    and a nearest ref on one texture) and diffuse_color, with the diffuse
    backward from the kernel (its taps' rows), equals the one through the
    plain VJP bit for bit, in one launch a backward call and no plain
    diffuse route."""
    make = SCENES["mixed"]
    with one_thread():
        ws.reset_launches()
        plain = texture_gradient(make)
        assert ws.plain_routes["diffuse"] > 0
        ws.reset_launches()
        calls = []
        got = texture_gradient(make, libs["w4d"], calls)
    n_calls = sum(1 for c in calls if c[1][0] == MAT_DIFFUSE)
    assert n_calls > 0 and ws.backward_launches()["shade_diffuse_bwd"] == n_calls
    assert not any(ws.plain_routes.values())
    assert plain[0] is not None and bool((plain[0] != 0).any())
    assert not any(bits_differ(a, b) for a, b in zip(got, plain))


@pytest.fixture(scope="module")
def card_libs(tmp_path_factory):
    """The source built with the card's arithmetic (no W4_TORCH_CPU):
    "one_pass", as it is, and "per_output", its origin's sums over the caps
    taken an output at a time (`outer_sum`) in place of the one pass of
    `outer_sum3`."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4dcard")
    edits = {"one_pass": (), "per_output": [("  if (M.by == 1) {\n    float a0[3]",
                                             "  if (false) {\n    float a0[3]")]}
    flags = [f for f in GXX_FLAGS if f != "-DW4_TORCH_CPU"]
    procs = {}
    for name, e in edits.items():
        src = d / f"{name}.cu"
        src.write_text(_source(e))
        procs[name] = subprocess.Popen(
            [gxx, *flags, "-I", str(CSRC / "emu"), "-x", "c++", str(src), "-o",
             str(d / f"{name}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log.decode()[-3000:]
        out[name] = ctypes.CDLL(str(d / f"{name}.so"))
    return out


def test_the_origin_sums_in_one_pass_are_the_per_output_sums(card_libs):
    """Built with the card's arithmetic, the origin's sums over the caps in
    one pass (`outer_sum3`, three outputs' accumulators rotating together)
    give every gradient the bits of the sums an output at a time (ATen's
    per-thread order, `outer_sum`), on Cornell's two caps and the 131
    lamps, every gradient wanted; the lamps' radii widened to 1.5 so that
    a direction falls inside most caps and most of the 131 terms of a sum
    are not zero."""
    rng = np.random.default_rng(5)
    with one_thread():
        for name in ("caps", "lamps"):
            call = next(c for c in capture(SCENES[name]()) if c[0] == MAT_DIFFUSE)
            mt, ctx, draws, packed, m, _ = call
            if name == "lamps":
                ctx = dataclasses.replace(ctx, data=dataclasses.replace(
                    ctx.data, is_radius=torch.full_like(ctx.data.is_radius, 1.5)))
            s = ws.diff_saved(ctx, draws, packed, m)
            n_tex = len(ctx.data.textures)
            grads = draw_grads(rng, m.shape[0], none=0.0)
            wants = (True,) * (NW + NI) + (False,) * n_tex
            a = ws.diffuse_vjp(grads, s, wants, card_libs["one_pass"])
            b = ws.diffuse_vjp(grads, s, wants, card_libs["per_output"])
            assert not any(bits_differ(x, y) for x, y in zip(a, b)), name
            k = NW + ws._DIFF_INPUTS.index("P")
            assert a[k] is not None and bool(torch.isfinite(a[k]).any()), name


def test_a_refused_launch_raises_and_counts_nothing(libs):
    before = ws.backward_launches()["shade_diffuse_bwd"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ws._call(libs["w4d"], "shade_diffuse_bwd", ctypes.byref(ws.DiffBwd()), None,
                 entries=ws.ENTRIES)
    assert ws.backward_launches()["shade_diffuse_bwd"] == before
