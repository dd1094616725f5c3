"""W4's refractive backward kernel, run on the CPU through the stand-in CUDA
runtime.

g++ compiles csrc/wavefront_shade_bwd.cu (its headers written in, so that
a mutant may edit them) against csrc/emu/cuda_runtime.h with W4_TORCH_CPU:
the source then sums three in the CPU's order, takes
x86's clamp of a NaN or a tie of zeros, and computes sqrt and exp (and
their backward) through float64, as the plain block runs here under
`exact_math` (tests/test_torch_wavefront_shade_emu.py).
ops/wavefront_shade.py `refractive_vjp` takes the library as `lib=` with
CPU tensors; every gradient it returns (the merged fields' pass-through
gradients, then those of the block's inputs) is held against the plain
block's VJP (`plain_shade_vjp`, ops/plain_grad.py `plain_vjp`) by its
bits: +0 and -0 differ, NaN equals NaN, and one the plain VJP leaves None
must be None.

The cases: the refractive calls of 16x16 renders of the glass sphere (the
inverse-rendering scene: split patterns, det rays weighted 2F or 2T),
Cornell, the dispersion scene (the hero channel) and the solid example 2
(split_k 3), each with output gradients drawn from a numpy seed (mixed
scales, -0, +0 and NaN among them, some None) and a random subset of
wanted inputs; beside them, a call of each scene with every gradient
wanted, with a third of its rays at their object's max depth, and with
its rays picked (`ws.pick_rays`; the medium every ray shares kept as one
row); the sphere's with each input wanted alone; and
the backward calls of 16x16 gradients (the sphere's IoR, the dispersion
scene's refr_n_im, Cornell's IoR) recorded (`plain_grad.recording`) and
replayed through both.  The cases hold rays entering and leaving, total
internal reflection and a one-row medium (`test_the_cases_hold_what_they_
are_for`).  Each mutant of MUTANTS makes some case fail; EQUIVALENT lists
edits that cannot change a bit, each with its reason, and asserts they
agree.

W4's forward (csrc/wavefront_shade.cu) is not built here: the gradients
are recorded with `ws._launch` replaced by the plain block merged in
place, which tests/test_torch_wavefront_shade_emu.py holds bit for bit
against the kernel, so that this file's g++ builds are of the backward's
source alone.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DW4_TORCH_CPU -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/wavefront_shade_bwd.cu -o build/w4b_emu.so
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
from raytracer_tpu_torch.materials.base import MAT_REFRACTIVE
from raytracer_tpu_torch.ops import wavefront_shade as ws
from raytracer_tpu_torch.ops.plain_grad import recording

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_shade_emu import (CSRC, GXX_FLAGS, _gxx,  # noqa: E402
                                            capture, exact_math, wrappers_replaced)
import torch_cornellbox  # noqa: E402
import torch_inverse_rendering  # noqa: E402
import torch_primitives  # noqa: E402

W = H = 16
NEVER = T.RenderSettings(use_pallas="never")

MUTANTS = {
    # the CPU's sum of three in another order
    "tsum3_order": [("  return ((0.0f + x0) + x1) + x2;",
                     "  return ((0.0f + x0) + x2) + x1;")],
    # cos_i * cos_i's two products added as one doubled term
    "cos_i_square_doubled": [("    put(b18, g37 * cos_i);\n    put(b18, g37 * cos_i);",
                              "    put(b18, 2.0f * (g37 * cos_i));")],
    # a select's +0 pads left out
    "select_pads_dropped": [
        ("  for (int c = 0; c < 3; ++c) put_ch(v, fl, bit, c, c == k ? g : 0.0f);",
         "  put_ch(v, fl, bit, k, g);")],
    # the first gradient a buffer takes added to 0 (-0 turned +0)
    "first_added_to_zero": [("  v[c] = (fl & b) ? v[c] + x : x;",
                             "  v[c] = (fl & b) ? v[c] + x : 0.0f + x;")],
    # exp's backward from its float result, not float64's
    "exp_bwd_in_float": [("  return (float)((double)g * exp((double)x));",
                          "  return g * (float)exp((double)x);")],
    # a quotient's divisor gradient as -g a / d^2
    "divisor_grad_squared": [("  float d3b = -b108 * ((f.s107 / f.d3) / f.d3);",
                              "  float d3b = -b108 * (f.s107 / (f.d3 * f.d3));")],
    # new_n_re's where handing the gradient to the other branch
    "n_re_where_swapped": [("      put_ch(sh[S_B4] + e0, fl, F_B4, c, take ? G3[c] : 0.0f);",
                            "      put_ch(sh[S_B4] + e0, fl, F_B4, c, take ? 0.0f : G3[c]);")],
    # the hero weight left out of beta_mult's gradient
    "hero_weight_dropped": [
        ("      const float g = B.hero != nullptr ? G0[c] * hw : G0[c];",
         "      const float g = G0[c];")],
    # A0's gradient taking the root's square before |A|'s sum
    "A0_order": [("  magb = magb + g49;\n  A0b = A0b + g49;\n", "  magb = magb + g49;\n"),
                 ("  A0b = A0b + g45 * f.A0;\n  A0b = A0b + g45 * f.A0;\n",
                  "  A0b = A0b + g45 * f.A0;\n  A0b = A0b + g45 * f.A0;\n"
                  "  A0b = A0b + g49;\n")],
    # the rays outside the block's mask given their output gradient
    "mask_ignored": [("        sh[S_G0 + f][e] = mk ? g : 0.0f;", "        sh[S_G0 + f][e] = g;")],
    # a tile row off by one element: the mask of an element's ray read at
    # the next element's
    "tile_row_off_by_one": [("      const bool mk = B.m[r0 + e / 3] != 0;",
                             "      const bool mk = B.m[r0 + (e + 1) / 3] != 0;")],
    # one packed flag bit shared by two buffers: n2's two wheres'
    "flag_bit_shared": [("  F_B6 = 1u << 15,", "  F_B6 = 1u << 12,")],
}

EQUIVALENT = {
    # safe_sqrt's where before its clamp_min: where x <= 0 the where hands
    # +0 and the clamp's mask (x >= 1e-30) would zero the gradient anyway,
    # and where 0 < x < 1e-30 the mask alone zeroes it; the where can never
    # decide a bit
    "safe_sqrt_where_dropped": [("  const float g136 = x134 > 0.0f ? -g139 : 0.0f;",
                                 "  const float g136 = -g139;")],
    # s2's two contributions: two terms add in either order to the same bits
    "s2_terms_swapped": [("    const float g38 = tsum3(o.p42[0], o.p42[1], o.p42[2]) + "
                          "tsum3(o.p39[0], o.p39[1], o.p39[2]);",
                          "    const float g38 = tsum3(o.p39[0], o.p39[1], o.p39[2]) + "
                          "tsum3(o.p42[0], o.p42[1], o.p42[2]);")],
}


HEADERS = ("grad_acc.cuh", "torch_math.cuh")


def _source(edits=()):
    text = (CSRC / "wavefront_shade_bwd.cu").read_text()
    for header in HEADERS:
        text = text.replace(f'#include "{header}"\n',
                            (CSRC / header).read_text().replace("#pragma once\n", ""))
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: the backward kernel ("w4b") and each mutant of
    MUTANTS and EQUIVALENT, g++ builds against the stand-in runtime, all
    started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp("w4bwd")
    procs = {}
    for name, edits in [("w4b", ())] + list(MUTANTS.items()) + list(EQUIVALENT.items()):
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


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def bits_differ(a, b):
    """Whether a and b differ: None against a tensor, shapes, or floats of
    other bits (+0 and -0 differ) and not both NaN."""
    if a is None or b is None:
        return (a is None) != (b is None)
    if a.shape != b.shape:
        return True
    return not bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())


def never(sc):
    sc.settings = NEVER
    return sc


SCENES = {
    "sphere": lambda: never(torch_inverse_rendering.build_scene(1.3, W, H)),
    "cornell": lambda: never(torch_cornellbox.build_cornell(W, H)),
    "dispersion": lambda: never(torch_primitives.dispersion(W, H)),
    "split": lambda: never(torch_primitives.example2_solid(W, H)),
}
NW = len(ws.WRITTEN[MAT_REFRACTIVE])
NI = len(ws._REFR_INPUTS)


def draw_grads(rng, n, none=0.3):
    """The output gradients of the five fields the entry writes for n rays
    (each None with probability `none`): normals at one of three scales,
    with -0, +0 and NaN among them."""
    out = []
    for _ in range(NW):
        if rng.random() < none:
            out.append(None)
            continue
        g = (rng.normal(size=(n, 3)) * rng.choice([1e-3, 1.0, 1e3])).astype(np.float32)
        g[rng.random((n, 3)) < 0.05] = -0.0
        g[rng.random((n, 3)) < 0.05] = 0.0
        g[rng.random((n, 3)) < 0.01] = np.nan
        out.append(torch.from_numpy(g))
    if all(g is None for g in out):
        out[int(rng.integers(NW))] = torch.from_numpy(
            rng.normal(size=(n, 3)).astype(np.float32))
    return out


def _wants(rng, p=0.7):
    """A random subset of the pass-through and input gradients wanted."""
    return tuple(bool(w) for w in rng.random(NW + NI) < p)


@contextlib.contextmanager
def plain_forward():
    """`ws._launch` replaced by the plain block merged into the output in
    place (what W4's forward writes, bit for bit)."""
    real = ws._launch

    def launch(mt, ctx, draws, packed, out, occ=None, lib=None):
        with torch.no_grad():
            merged = out.merge(ws._plain(mt, ctx, draws, occ), (packed & 7) == mt)
            for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
                getattr(out, f).copy_(getattr(merged, f))

    ws._launch = launch
    try:
        yield
    finally:
        ws._launch = real


def routed(bwd_lib):
    """trace's W4 wrappers through `_Shade` on CPU tensors, its refractive
    backward from `bwd_lib` (None: the plain VJP; the diffuse and glossy
    blocks' the plain VJP)."""
    def route(mt, real):
        def f(ctx, draws, packed, m, acc):
            return ws._kernel_shade(mt, ctx, draws, packed, m, acc,
                                    bwd_lib={MAT_REFRACTIVE: bwd_lib} if bwd_lib else None)
        return f
    return wrappers_replaced(route)


def ior_gradient(make, table, bwd_lib=None, calls=None, spp=2):
    """d loss / d table (refr_n_re or refr_n_im) of a 16x16 render of
    make() on the CPU, its W4 calls through `_Shade` (`routed`), the
    backward calls of `_Shade` appended to `calls` where given."""
    fn, data = differentiable_render(make(), spp, seed=3, device="cpu")
    x = getattr(data.mats, table).clone().requires_grad_()
    rec = recording(calls, ws._Shade) if calls is not None else contextlib.nullcontext()
    with exact_math(), plain_forward(), routed(bwd_lib), rec:
        loss = (fn(update_materials(data, **{table: x})) ** 2).mean()
        g, = torch.autograd.grad(loss, x)
    return g


RECORDED = {"sphere": ("sphere", "refr_n_re"), "dispersion": ("dispersion", "refr_n_im"),
            "cornell": ("cornell", "refr_n_re")}


def _with_depth_at_max(call, rng):
    """The call with a third of its rays at their object's max depth."""
    mt, ctx, draws, packed, m, acc = call
    at = torch.from_numpy(rng.random(ctx.depth.shape[0]) < 0.33)
    depth = torch.where(at, ctx.obj_max_depth.to(ctx.depth.dtype), ctx.depth)
    return mt, dataclasses.replace(ctx, depth=depth), draws, packed, m, acc


@pytest.fixture(scope="module")
def cases(libs):
    """[(label, kernel(lib) -> gradients, plain gradients, RefrSaved)]."""
    rng = np.random.default_rng(25)
    out = []

    def add(label, call, grads, wants):
        mt, ctx, draws, packed, m, _ = call
        s = ws.refr_saved(ctx, draws, packed, m)
        out.append((label, lambda lib, a=(grads, s, wants): ws.refractive_vjp(*a, lib),
                    ws.plain_shade_vjp(mt, ctx, draws[mt], m, None, grads, wants), s))

    with one_thread(), exact_math():
        for name, make in SCENES.items():
            calls = [c for c in capture(make()) if c[0] == MAT_REFRACTIVE]
            for k, call in enumerate(calls):
                add(f"{name} {k} drawn", call, draw_grads(rng, call[4].shape[0]),
                    _wants(rng))
            call = calls[len(calls) // 2]
            n = call[4].shape[0]
            add(f"{name} all", call, draw_grads(rng, n, none=0.0), (True,) * (NW + NI))
            add(f"{name} depth", _with_depth_at_max(call, rng), draw_grads(rng, n),
                _wants(rng))
            idx = torch.from_numpy(rng.permutation(n)[:max(n // 2, 1)])
            add(f"{name} picked", ws.pick_rays(calls[0], idx),
                draw_grads(rng, idx.shape[0]), _wants(rng))
            if name == "sphere":
                # each input wanted alone, every output gradient given
                for i in range(NI):
                    wants = tuple(j == NW + i for j in range(NW + NI))
                    add(f"{name} alone {ws._REFR_INPUTS[i]}", call,
                        draw_grads(rng, n, none=0.0), wants)
        for label, (scene, table) in RECORDED.items():
            calls = []
            ior_gradient(SCENES[scene], table, libs["w4b"], calls)
            for k, (fn, call, xs, grads, wants) in enumerate(calls):
                if call[0] != MAT_REFRACTIVE:
                    continue
                kernel, plain = ws.backward_pair(fn, call, xs, grads, wants)
                out.append((f"{label} recorded {k}",
                            lambda lib, r=(fn, call, xs, grads, wants):
                            ws.backward_pair(*r, lib)[0](), plain(),
                            ws.refr_saved(*call[1:5])))
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


def test_w4_refractive_backward_equals_the_plain_vjp(libs, cases):
    before = ws.backward_launches()["shade_refractive_bwd"]
    assert failures(cases, libs["w4b"]) == []
    # one launch a case, none where nothing wanted is reached
    got = ws.backward_launches()["shade_refractive_bwd"] - before
    assert len(cases) // 2 < got <= len(cases)


def test_the_cases_hold_what_they_are_for(cases):
    """Rays entering and leaving, total internal reflection, det rays, the
    hero channel, a one-row medium and rays at their max depth are among
    the held block rays; the recorded gradients reach the kernel nonzero;
    every input is wanted alone."""
    seen = dict.fromkeys(("entering", "leaving", "tir", "det", "hero", "one_row",
                          "max_depth"), 0)
    for label, _, want, s in cases:
        m = s.m
        seen["entering"] += int(((s.orient == 1.0) & m).sum())
        seen["leaving"] += int(((s.orient != 1.0) & m).sum())
        seen["one_row"] += int(s.n_re.shape[0] > 1 and s.n_re.stride(0) == 0)
        seen["hero"] += int(s.hero is not None and bool(m.any()))
        seen["max_depth"] += int(((s.depth == ((s.packed >> 13) & 0x3FF)) & m).sum())
        seen["det"] += int(s.split_k > 0 and bool(
            ((s.split_cnt < s.split_k) & ~(((s.packed >> 23) & 1) == 1) & m).any()))
        # sin2_t > 1 where the block's rays leave the denser medium
        n2 = torch.where((s.orient == 1.0)[:, None],
                         s.m_re[shade.slot_rows(s.mat_slot, s.m_re)], s.scene_re[None, :])
        cos_i = (-s.D * s.N).sum(-1)
        ratio = (s.n_re / n2).mean(-1)
        seen["tir"] += int(((ratio ** 2 * (1 - cos_i ** 2) > 1) & m).sum())
    assert all(v > 0 for v in seen.values()), seen
    for scene in RECORDED:
        rec = [c for c in cases if c[0].startswith(f"{scene} recorded")]
        assert rec and any(bool((g != 0).any()) for c in rec
                           for g in c[2][NW:] if g is not None), scene
    for x in ws._REFR_INPUTS:
        assert any(c[0].endswith(f"alone {x}") for c in cases), x


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant


@pytest.mark.parametrize("edit", list(EQUIVALENT))
def test_each_equivalent_edit_agrees(libs, cases, edit):
    assert failures(cases, libs[edit]) == [], edit


def test_the_gradient_through_the_kernel_is_the_plain_blocks(libs):
    """The sphere's IoR gradient with the refractive backward from the
    kernel equals the one through the plain VJP bit for bit, in one launch
    a backward call and no plain route; Cornell's diffuse backward calls
    take the plain VJP, counted."""
    make = SCENES["sphere"]
    with one_thread():
        ws.reset_launches()
        plain = ior_gradient(make, "refr_n_re", spp=1)
        assert sum(ws.backward_launches().values()) == 0
        assert ws.plain_routes["refractive"] > 0
        ws.reset_launches()
        calls = []
        got = ior_gradient(make, "refr_n_re", libs["w4b"], calls, spp=1)
    n_calls = sum(1 for c in calls if c[1][0] == MAT_REFRACTIVE)
    assert n_calls > 0 and ws.backward_launches()["shade_refractive_bwd"] == n_calls
    assert ws.plain_routes["refractive"] == 0
    assert bool((plain != 0).any())
    assert not bits_differ(got, plain)
    with one_thread():
        ws.reset_launches()
        ior_gradient(SCENES["cornell"], "refr_n_re", libs["w4b"], spp=1)
    assert ws.plain_routes["diffuse"] > 0 and ws.plain_routes["refractive"] == 0
    assert ws.backward_launches()["shade_refractive_bwd"] > 0


def test_a_refused_launch_raises_and_counts_nothing(libs):
    before = ws.backward_launches()["shade_refractive_bwd"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ws._call(libs["w4b"], "shade_refractive_bwd", ctypes.byref(ws.RefrBwd()), None,
                 entries=ws.ENTRIES)
    assert ws.backward_launches()["shade_refractive_bwd"] == before
