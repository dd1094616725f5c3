"""Mutants of W5's backward's MAPS instance (the normal maps' backward),
run on the CPU through the stand-in CUDA runtime.

csrc/hit_attrs.cu's backward takes, in its MAPS instance, the gradient of
the normal-mapped shading normal back through every ref's mapped normal
into the geometric normal, uv and the maps' texture taps.  The holds of
the kernel against the plain VJP are in tests/test_torch_hit_attrs_bwd_emu.py;
here each mutant of MUTANTS, built with g++ like that file's, must make one
of the attribute calls of the normal-mapped scenes (nearest and bilinear,
instanced meshes) or of the maps' edge cases
(tests/test_torch_hit_attrs_emu.py `map_inputs`), every gradient wanted,
as called and with uv forced, differ from the plain VJP.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from raytracer_tpu_torch.ops import hit_attrs as ha

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hit_attrs_bwd_emu import draw_grads, failures, held_leaves  # noqa: E402
from test_torch_hit_attrs_emu import (GXX_FLAGS, _scenes, _source,  # noqa: E402
                                      capture, exact_math, map_inputs, one_thread)
from test_torch_wavefront_diffuse_bwd_taps_emu import build  # noqa: E402

MUTANTS = {
    # _unit's buffer taking safe_norm's two products as one doubled term
    "unit_products_doubled": [("    gv[k] = (g[k] / c + q) + q;",
                               "    gv[k] = g[k] / c + 2.0f * q;")],
    # _cross's backward taking its components first to last
    "cross_components_in_order": [("  for (int k = 2; k >= 0; --k) {\n    const int i = (k + 1) % 3",
                                   "  for (int k = 0; k < 3; ++k) {\n    const int i = (k + 1) % 3")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build(tmp_path_factory, _source, [("w5", ())] + list(MUTANTS.items()),
                 flags=GXX_FLAGS, tag="w5maps")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    rng = np.random.default_rng(131)
    out = []
    obj_dir = tmp_path_factory.mktemp("obj")
    scenes = _scenes(obj_dir)
    with one_thread():
        inputs = []
        for name in ("normal_mapped", "normal_mapped_bilinear", "instanced_mapped"):
            inputs += [(name, args[:7]) for args, kw in capture(scenes[name]()) if not kw][:1]
        static, data, rays, _ = map_inputs(obj_dir)
        inputs.append(("maps", (*rays, data, static)))
        with exact_math():
            for name, (O, D, t, orient, obj, data, static) in inputs:
                names, texs = held_leaves(data, static)
                xs = ([O, D, t, orient] + [getattr(data.geom, f) for f in names]
                      + [data.textures[k] for k in texs])
                for force_uv in (False, True):
                    modes = (*ha._nudge_uv(static, None, force_uv), False)
                    grads = draw_grads(rng, t.shape[0])
                    wants = (True, True, True, False) + (True,) * (len(names) + len(texs))
                    out.append((f"{name} {force_uv}",
                                lambda lib, a=(grads, O, D, t, orient, obj, data, static,
                                               modes, wants), nm=names, tx=texs:
                                ha.attrs_vjp(*a, lib, nm, tx),
                                ha.plain_attrs_vjp(grads, xs, obj, data, static, modes,
                                                   names, texs, wants)))
    return out


def test_the_map_cases_hold(libs, cases):
    assert failures(cases, libs["w5"]) == []


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_each_mutant_fails(libs, cases, mutant):
    assert failures(cases, libs[mutant], first=True), mutant
