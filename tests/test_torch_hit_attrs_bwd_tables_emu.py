"""Mutants of W5's backward's geometry-table rows, run on the CPU through
the stand-in CUDA runtime.

csrc/hit_attrs.cu's backward writes, in its TABLES instance, each wanted
geometry table's per-ray rows, which ops/hit_attrs.py `attrs_vjp` reduces.
The holds of the kernel against the plain VJP are in
tests/test_torch_hit_attrs_bwd_emu.py; here each mutant of MUTANTS, built
with g++ like that file's, must make one of the attribute calls of the
icosphere, the beach ball (corner normals and uvs) and a field of
instances, every geometry table's gradient wanted, as called, with uv
forced and as the first-hit pass, differ from the plain VJP.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from raytracer_tpu_torch.ops import hit_attrs as ha

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hit_attrs_bwd_emu import draw_grads, failures  # noqa: E402
from test_torch_hit_attrs_emu import (GXX_FLAGS, MODES, _scenes, _source,  # noqa: E402
                                      capture, exact_math, one_thread)
from test_torch_wavefront_diffuse_bwd_taps_emu import build  # noqa: E402

MUTANTS = {
    # p1's buffer taking e1's share before e2's
    "p1_order": [("    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be2[c]);\n    acc_row3(gp1, t);\n"
                  "    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be1[c]);",
                  "    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be1[c]);\n    acc_row3(gp1, t);\n"
                  "    for (int c = 0; c < 3; ++c) t[c] = -acc_val(be2[c]);")],
    # the hit's columns of the rotation written as its rows
    "rot_columns_as_rows": [
        ("      for (int e = 0; e < 9; ++e) acc_add(rot[e], e % 3 == j ? acc_val(cc[e / 3]) : 0.0f);",
         "      for (int e = 0; e < 9; ++e) acc_add(rot[e], e / 3 == j ? acc_val(cc[e % 3]) : 0.0f);")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build(tmp_path_factory, _source, [("w5", ())] + list(MUTANTS.items()),
                 flags=GXX_FLAGS, tag="w5tabs")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    rng = np.random.default_rng(130)
    out = []
    scenes = _scenes(tmp_path_factory.mktemp("obj"))
    with one_thread():
        inputs = []
        for name in ("icosphere", "beach_ball", "instances"):
            inputs += [(name, args[:7]) for args, kw in capture(scenes[name]()) if not kw][:1]
        with exact_math():
            for name, (O, D, t, orient, obj, data, static) in inputs:
                names = ha._geom_floats(data.geom)
                xs = [O, D, t, orient] + [getattr(data.geom, f) for f in names]
                for force_uv, first_hit in MODES:
                    modes = (*ha._nudge_uv(static, None, force_uv), first_hit)
                    grads = draw_grads(rng, t.shape[0])
                    wants = (True, True, True, False) + (True,) * len(names)
                    out.append((f"{name} {force_uv}.{first_hit}",
                                lambda lib, a=(grads, O, D, t, orient, obj, data, static,
                                               modes, wants), nm=names:
                                ha.attrs_vjp(*a, lib, nm),
                                ha.plain_attrs_vjp(grads, xs, obj, data, static, modes,
                                                   names, (), wants)))
    return out


def test_the_table_cases_hold(libs, cases):
    assert failures(cases, libs["w5"]) == []


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant
