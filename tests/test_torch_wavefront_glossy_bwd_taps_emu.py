"""Mutants of W4's glossy backward's texel taps, run on the CPU through the
stand-in CUDA runtime.

As tests/test_torch_wavefront_diffuse_bwd_taps_emu.py for
csrc/wavefront_glossy_bwd.cu: each mutant of MUTANTS must make one of the
texture cases (the primitives' nearest checker, the mirrors' bilinear
one, every gradient wanted) differ from the plain VJP.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_diffuse_bwd_taps_emu import build  # noqa: E402
from test_torch_wavefront_glossy_bwd_emu import _source, failures, texture_cases  # noqa: E402
from test_torch_wavefront_shade_bwd_emu import one_thread  # noqa: E402
from test_torch_wavefront_shade_emu import exact_math  # noqa: E402

MUTANTS = {
    # a nearest fetch's tap at (v, u) in place of (u, v)
    "nearest_tap_transposed": [
        ("    tap_row(R, plane, n, i, H, W, (int)(u * su), (int)(v * sv), G, 1.0f, false);",
         "    tap_row(R, plane, n, i, H, W, (int)(v * sv), (int)(u * su), G, 1.0f, false);")],
    # a ref's taps given the where's other branch
    "taps_else_branch": [("      tap_rows(B.ref_tex, r, u, v, gc, B.taps, plane, B.n, i);",
                          "      tap_rows(B.ref_tex, r, u, v, colb, B.taps, plane, B.n, i);")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build(tmp_path_factory, _source, [("w4g", ())] + list(MUTANTS.items()),
                 tag="w4gtaps")


@pytest.fixture(scope="module")
def cases():
    with one_thread(), exact_math():
        return texture_cases(np.random.default_rng(128))


def test_the_texture_cases_hold(libs, cases):
    assert failures(cases, libs["w4g"]) == []


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant
