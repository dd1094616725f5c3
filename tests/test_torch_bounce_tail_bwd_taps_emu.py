"""Mutants of W6's start backward's texel taps, run on the CPU through the
stand-in CUDA runtime.

csrc/bounce_tail.cu `bounce_start_bwd` writes, where a texture the start
reads takes a gradient, the taps' rows of the emissive refs, the
environments' display textures and their lightmaps, which
ops/bounce_tail.py `start_vjp` reduces.  The holds of the kernel against
the plain VJP are in tests/test_torch_bounce_tail_bwd_emu.py; here each
mutant of MUTANTS, built with g++ like that file's, must make one of the
start calls of example 4 (a sky with a lightmap) and the emitter scene
(nearest and bilinear emissive refs of one texture, a sky that is its own
lightmap), every texture's gradient wanted, differ from the plain VJP.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from raytracer_tpu_torch.ops import bounce_tail as bt
from raytracer_tpu_torch.ops import wavefront_shade as ws

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bounce_tail_bwd_emu import draw_grads, failures  # noqa: E402
from test_torch_bounce_tail_emu import _scenes, build_libs, capture, one_thread  # noqa: E402

MUTANTS = {
    # the lightmap's tap without the slot's light intensity
    "lightmap_tap_unscaled": [("        for (int k = 0; k < 3; ++k) t[k] = gl[k] * li;",
                               "        for (int k = 0; k < 3; ++k) t[k] = gl[k];")],
    # an emissive ref's taps given the where's other branch
    "em_taps_else_branch": [
        ("        tap_rows(S.em_ref_tex, r, u, v, gc, S.taps, plane, S.n, i);",
         "        tap_rows(S.em_ref_tex, r, u, v, cur, S.taps, plane, S.n, i);")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_libs(tmp_path_factory, [("w6", ())] + list(MUTANTS.items()))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    rng = np.random.default_rng(129)
    out = []
    scenes = _scenes(tmp_path_factory.mktemp("obj"))
    with one_thread():
        for name in ("example4", "emitters"):
            starts, _ = capture(scenes[name]())
            for k, (ctx, _, mat_type) in enumerate(starts[:3]):
                xs = bt._start_inputs(ctx)
                grads = draw_grads(rng, ctx.P.shape[0], ws.FLOAT_FIELDS)
                grads[1] = None
                grads[0] = draw_grads(rng, ctx.P.shape[0], ("add",))[0]
                wants = (True,) * len(xs)
                args = (mat_type, ctx.mat_slot, ctx.depth)
                out.append((f"start {name} {k}",
                            lambda lib, g=grads, a=args, c=ctx, w=wants:
                            bt.start_vjp(g, *a, c.uv, c.data, c.static, w, lib),
                            bt.plain_start_vjp(grads, xs, *args, ctx.data, ctx.static,
                                               wants)))
    return out


def test_the_texture_cases_hold(libs, cases):
    assert failures(cases, libs["w6"]) == []


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant
