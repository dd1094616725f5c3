"""Mutants of W4's diffuse backward's texel taps, run on the CPU through the
stand-in CUDA runtime.

csrc/wavefront_diffuse_bwd.cu writes, where a colour texture takes a
gradient, each ref's taps' rows (csrc/texture_fetch.cuh `tap_rows`), which
ops/wavefront_shade.py `texture_grads` reduces.  The holds of the kernel
against the plain VJP are in tests/test_torch_wavefront_diffuse_bwd_emu.py;
here each mutant of MUTANTS, built with g++ like that file's, must make
one of the mixed scene's texture cases (a bilinear and a nearest ref on
one texture, every gradient wanted) differ from the plain VJP.  The
mutants have a file of their own so that `--dist loadfile` builds them
on another worker.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_diffuse_bwd_emu import _source, failures, texture_cases  # noqa: E402
from test_torch_wavefront_shade_bwd_emu import one_thread  # noqa: E402
from test_torch_wavefront_shade_emu import CSRC, GXX_FLAGS, _gxx, exact_math  # noqa: E402

MUTANTS = {
    # a bilinear fetch's second and third taps' weights swapped
    "tap_weights_swapped": [
        ("  tap_row(R, plane + 1, n, i, H, W, ix1, iy, G, fx * (1.0f - fy), true);",
         "  tap_row(R, plane + 1, n, i, H, W, ix1, iy, G, (1.0f - fx) * fy, true);")],
    # a ref's taps given the where's other branch (the gradient left for the
    # earlier refs and the table)
    "taps_else_branch": [("      tap_rows(B.ref_tex, r, u, v, gc, B.taps, plane, B.n, i);",
                          "      tap_rows(B.ref_tex, r, u, v, colb, B.taps, plane, B.n, i);")],
}


def build(tmp_path_factory, source, builds, flags=GXX_FLAGS, tag="mut"):
    """{name: library} of `builds` ((name, edits) each, source(edits) the
    text), g++ builds against the stand-in runtime, all started together."""
    gxx, d = _gxx(), tmp_path_factory.mktemp(tag)
    procs = {}
    for name, edits in builds:
        src = d / f"{name}.cu"
        src.write_text(source(edits))
        procs[name] = subprocess.Popen(
            [gxx, *flags, "-I", str(CSRC / "emu"), "-I", str(CSRC), "-x", "c++", str(src),
             "-o", str(d / f"{name}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for name, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log.decode()[-3000:]
        out[name] = ctypes.CDLL(str(d / f"{name}.so"))
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build(tmp_path_factory, _source, [("w4d", ())] + list(MUTANTS.items()),
                 tag="w4dtaps")


@pytest.fixture(scope="module")
def cases():
    with one_thread(), exact_math():
        return texture_cases(np.random.default_rng(127))


def test_the_texture_cases_hold(libs, cases):
    assert failures(cases, libs["w4d"]) == []


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant
