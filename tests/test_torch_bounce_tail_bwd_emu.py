"""W6's backward kernels, run on the CPU through the stand-in CUDA runtime.

g++ compiles csrc/bounce_tail.cu against csrc/emu/cuda_runtime.h with
W6_TORCH_CPU (torch.sum over three then adds in the CPU's order), as
tests/test_torch_bounce_tail_emu.py builds it.  ops/bounce_tail.py
`update_vjp` and `start_vjp` take the library as `lib=` with CPU tensors;
every gradient they write is held against the plain stages' VJP
(`plain_update_vjp`, `plain_start_vjp`, ops/plain_grad.py `plain_vjp`)
by its bits (+0 and -0 differ; NaN equals NaN), and a gradient the plain
VJP leaves None must be None.

The inputs: the random updates of the forward's tests (NaN and -0 in add,
missed and dead rays, every bool pattern, a medium one row for every ray)
and the start calls of 16x16 renders of Cornell, examples 2 and 4 (a sky
with a lightmap) and the emitter scene (solid, nearest and bilinear
emissive textures, one repeated; a lightmap whose texels hold -0 and NaN),
each with output gradients drawn from a numpy seed (values of mixed
scales, -0, +0 and NaN among them, some gradients None) and each subset
of inputs wanting a gradient, the textures among them (their gradients
from the start kernel's texel taps' rows); and the backward calls of a
16x16 inverse-rendering gradient (the IoR and the emissive colours) and
of the emitter scene's gradient (its emissive colours, the sky's light
intensity and every texture), recorded (`plain_grad.recording`) and replayed through
both.  Each mutant of MUTANTS makes some case fail; EQUIVALENT's make
none, and the test says why.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -DCUDA_EMU_SMS=6 -DW6_TORCH_CPU -I raytracer_tpu_torch/csrc/emu \\
        -x c++ raytracer_tpu_torch/csrc/bounce_tail.cu -o build/w6_emu.so
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.diff import differentiable_render, update_materials
from raytracer_tpu_torch.ops import bounce_tail as bt
from raytracer_tpu_torch.ops import wavefront_shade as ws
from raytracer_tpu_torch.ops.plain_grad import recording

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bounce_tail_emu import (_scenes, build_libs, capture,  # noqa: E402
                                        emitters, one_thread, random_update,
                                        routed, update_args)
import torch_inverse_rendering  # noqa: E402

# the update's beta takes the where's else branch, then beta_mult's
# product, then add's
BETA = ("    v = (next ? 0.0f : g) + gq * B.beta_mult[j];",)
MUTANTS = {
    # the first of beta's contributions added to 0 (the engine stores it)
    "beta_first_added": [(BETA[0], "    v = (0.0f + (next ? 0.0f : g)) + gq * B.beta_mult[j];")],
    # the update's where() handing O's gradient to the other branch
    "where_swapped": [("  where_bwd(B.gO, j, next, B.dnew_origin, B.dO);",
                       "  where_bwd(B.gO, j, next, B.dO, B.dnew_origin);")],
    # the start's emissive merge handing its input none of the gradient
    "em_branch_dropped": [("    v = m_env ? cur : 0.0f;\n    cur = m_env ? 0.0f : cur;",
                         "    v = m_env ? cur : 0.0f;\n    cur = m_env ? 0.0f : cur;\n"
                         "    cur = m_em ? 0.0f : cur;")],
    # fx's four terms of the bilinear fetch in the forward's order
    "bilinear_fx_order": [("  float gfx = g11 * fy, gfy = g11 * fx;",
                           "  float gfx = -(g00 * ay), gfy = g11 * fx;"),
                          ("  gfx = gfx + -(g00 * ay);", "  gfx = gfx + g11 * fy;")],
    # torch.sum over three (the light intensity's, the bilinear weights')
    # in the card's order
    "sum3_card_order": [("  return ((0.0f + x0) + x1) + x2;\n#else\n"
                           "  return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);",
                           "  return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);\n#else\n"
                           "  return ((0.0f + x0) + (0.0f + x2)) + (0.0f + x1);")],
}
EQUIVALENT = {
    # beta's three terms in another order: of g2 = where(next, 0, g),
    # g3 = where(next, g, 0) * beta_mult and g1 = where(shaded, gL, 0) * add
    # at most two are nonzero (one of g2, g3 is a where's +0, or 0 x
    # beta_mult: +-0 or NaN), and a sum of IEEE floats of which at most two
    # are nonzero is the same in every order (x + +-0 = x for x != 0; a
    # zero sum is -0 only where every term is -0; NaN anywhere is NaN)
    "beta_terms_reordered": [(BETA[0] + "\n    has = true;",
                              "    v = gq * B.beta_mult[j];\n    has = true;"),
                             ("      v = has ? v + t : t;\n    }\n    B.dbeta[j] = v;",
                              "      v = has ? v + t : t;\n    }\n"
                              "    if (B.gbeta) v = v + (next ? 0.0f : B.gbeta[j]);\n"
                              "    B.dbeta[j] = v;")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: W6 ("w6") and each mutant, all built together."""
    return build_libs(tmp_path_factory, [("w6", ())] + list(MUTANTS.items())
                      + list(EQUIVALENT.items()))


def bits_differ(a, b):
    """Whether a and b differ: None against a tensor, shapes, or floats of
    other bits (+0 and -0 differ) and not both NaN."""
    if a is None or b is None:
        return (a is None) != (b is None)
    if a.shape != b.shape:
        return True
    return not bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())


def draw_grads(rng, n, fields, width=3):
    """Output gradients of n rays, one a field (None for about one in four):
    normals at one of three scales, with -0, +0 and NaN among them."""
    out = []
    for _ in fields:
        if rng.random() < 0.25:
            out.append(None)
            continue
        g = (rng.normal(size=(n, width)) * rng.choice([1e-3, 1.0, 1e3])).astype(np.float32)
        g[rng.random((n, width)) < 0.05] = -0.0
        g[rng.random((n, width)) < 0.05] = 0.0
        g[rng.random((n, width)) < 0.01] = np.nan
        out.append(torch.from_numpy(g))
    return out


@pytest.fixture(scope="module")
def cases(libs, tmp_path_factory):
    """[(label, kernel(lib) -> gradients, plain gradients)]: the random
    updates and the renders' start calls, four draws of gradients and
    wants each, and the recorded backward calls of the two gradients."""
    rng = np.random.default_rng(24)
    out = []
    with one_thread():
        for seed in range(4):
            c, miss, acc = update_args(random_update(seed, n=600,
                                                     shared_medium=seed % 2 == 1),
                                       seed % 2 == 1)
            xs, others = bt._update_parts(c, miss, acc)
            saved = [c.beta, acc.add, acc.beta_mult, c.alive, miss, acc.cont]
            for trial in range(6):
                grads = draw_grads(rng, c.L.shape[0], bt.CARRY_FLOATS)
                wants = tuple(bool(w) for w in rng.random(len(xs)) < 0.7)
                out.append((f"update {seed}.{trial}",
                            lambda lib, g=grads, s=saved, w=wants: bt.update_vjp(
                                g, s, w, lib),
                            bt.plain_update_vjp(grads, xs, others, wants)))
        obj_dir = tmp_path_factory.mktemp("obj")
        scenes = _scenes(obj_dir)
        for name in ("cornell", "example2", "example4", "emitters"):
            starts, _ = capture(scenes[name]())
            for k, (ctx, _, mat_type) in enumerate(starts):
                xs = bt._start_inputs(ctx)
                for trial in range(2):
                    grads = draw_grads(rng, ctx.P.shape[0], ws.FLOAT_FIELDS)
                    grads[1] = None          # beta_mult takes no gradient
                    wants = tuple(bool(w) for w in rng.random(len(xs)) < 0.8)
                    args = (mat_type, ctx.mat_slot, ctx.depth)
                    out.append((f"start {name} {k}.{trial}",
                                lambda lib, g=grads, a=args, c=ctx, w=wants:
                                bt.start_vjp(g, *a, c.uv, c.data, c.static, w, lib),
                                bt.plain_start_vjp(grads, xs, *args, ctx.data,
                                                   ctx.static, wants)))
        for label, calls in recorded_calls(libs["w6"]).items():
            for k, (fn, call, xs, grads, wants) in enumerate(calls):
                kernel, plain = bt.backward_pair(fn, call, xs, grads, wants)
                out.append((f"{label} {fn.__name__} {k}",
                            lambda lib, f=fn, c=call, x=xs, g=grads, w=wants:
                            bt.backward_pair(f, c, x, g, w, lib)[0](), plain()))
    return out


def recorded_calls(lib):
    """{label: the recorded backward calls of `_Start` and `_Update`} of two
    gradients through W6's forward from lib (the holds replay each call
    through both backward passes):
    the inverse-rendering scene's IoR and emissive colours (4x4 x 32 spp,
    two chunks), and the emitter scene's emissive colours, sky light
    intensity (8x8 x 2 spp)."""
    out = {}
    sc = torch_inverse_rendering.build_scene(1.3, 4, 4)
    fn, data = differentiable_render(sc, 32, seed=0, device="cpu")
    x = data.mats.refr_n_re.clone().requires_grad_()
    e = data.mats.emissive_color.clone().requires_grad_()
    with recording([], bt._Start, bt._Update) as calls, routed(lib):
        loss = (fn(update_materials(data, refr_n_re=x, emissive_color=e)) ** 2).mean()
        torch.autograd.grad(loss, (x, e))
    out["inverse rendering"] = calls
    out["emitters"] = emitter_gradient(lib)[1]
    return out


def emitter_gradient(lib=None):
    """(the gradients, the recorded backward calls of `_Start` and
    `_Update`) of the emitter scene's 8x8 x 2 spp render with respect to
    its emissive colours, the sky's light intensity and every texture (the
    emissive ones, the sky's display texture that is its lightmap too),
    through W6 from lib (None: the plain stages)."""
    sc = emitters(width=8, height=8)
    fn, data = differentiable_render(sc, 2, seed=1, device="cpu")
    e = data.mats.emissive_color.clone().requires_grad_()
    li = data.mats.env_light_intensity.clone().requires_grad_()
    texs = [t.clone().requires_grad_() for t in data.textures]
    data = dataclasses.replace(data, textures=tuple(texs))
    ctx = routed(lib) if lib is not None else contextlib.nullcontext()
    with recording([], bt._Start, bt._Update) as calls, ctx:
        loss = (fn(update_materials(data, emissive_color=e,
                                    env_light_intensity=li)) ** 2).mean()
        got = torch.autograd.grad(loss, (e, li, *texs), allow_unused=True)
    return got, calls


def failures(cases, lib, first=False):
    """[(case, input index)] where the kernel from lib and the plain VJP
    disagree."""
    bad = []
    with one_thread():
        for label, kernel, want in cases:
            got = kernel(lib)
            for i, (a, b) in enumerate(zip(got, want)):
                if bits_differ(a, b):
                    bad.append((label, i))
                    if first:
                        return bad
    return bad


def test_w6_backward_equals_the_plain_vjp(libs, cases):
    before = bt.backward_launches()
    assert failures(cases, libs["w6"]) == []
    got = bt.backward_launches()
    assert all(got[k] > before[k] for k in got)


def test_the_cases_hold_what_they_are_for(cases):
    """The recorded gradients reach both kernels; the draws reach the uv
    through a bilinear texture, both tables and every ray input."""
    labels = [c[0] for c in cases]
    for fn in ("_Start", "_Update"):
        for g in ("inverse rendering", "emitters"):
            assert any(lab.startswith(f"{g} {fn}") for lab in labels), (g, fn)
    starts = [c for c in cases if c[0].startswith("start emitters")]
    # P, D, n_re, n_im, uv, the two tables, the textures (the emissive
    # refs', the sky's display texture and lightmap in one)
    for i in range(7 + 2):
        assert any(c[2][i] is not None and bool((c[2][i] != 0).any())
                   for c in starts), i
    for name in ("example2", "example4"):      # a display texture, a lightmap
        assert any(any(g is not None and bool((g != 0).any()) for g in c[2][7:])
                   for c in cases if c[0].startswith(f"start {name}")), name


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant


@pytest.mark.parametrize("mutant", list(EQUIVALENT))
def test_the_equivalent_mutants_agree(libs, cases, mutant):
    assert failures(cases, libs[mutant]) == []


def test_a_texture_gradient_through_the_kernel_is_the_plain_stages(libs):
    """The emitter scene's gradient with respect to its textures (nearest
    and bilinear emissive refs of one texture, the sky's display texture
    that is its lightmap too), emissive colours and light intensity, with
    W6's start backward from the kernel (its taps' rows), equals the one
    through the plain stages bit for bit, one launch a backward call."""
    with one_thread():
        plain, _ = emitter_gradient()
        before = bt.backward_launches()["bounce_start_bwd"]
        got, calls = emitter_gradient(libs["w6"])
    n_starts = sum(1 for c in calls if c[0] is bt._Start)
    assert n_starts and bt.backward_launches()["bounce_start_bwd"] - before == n_starts
    assert all(g is not None and bool((g != 0).any()) for g in plain[2:4])
    assert not any(bits_differ(a, b) for a, b in zip(got, plain))


def test_update_saves_only_what_its_backward_reads(libs):
    """`_Update` saves beta, add, beta_mult and the three masks its kernel
    reads, not the update's other inputs."""
    c, miss, acc = update_args(random_update(0, n=8))
    c = bt.Carry(**{k: (v.requires_grad_() if k in ("L", "beta") else v)
                    for k, v in vars(c).items()})
    xs, others = bt._update_parts(c, miss, acc)
    res = bt._Update.apply((others, libs["w6"]), *xs)
    node = res[0].grad_fn
    saved = [t for t in node.saved_tensors]
    assert len(saved) == len(bt._UPDATE_SAVED)
    assert all(a is b or torch.equal(a, b)
               for a, b in zip(saved, (c.beta, acc.add, acc.beta_mult, c.alive, miss,
                                       acc.cont)))
