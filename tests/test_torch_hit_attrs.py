"""W5's plain version, the port's whole attribute stage
(ops/hit_attrs.py `attributes` on CPU tensors), against the JAX package's
(raytracer_tpu/core/integrator.py:221-236: `hit_attributes`
raytracer_tpu/geometry/attrs.py:245, `_apply_normal_maps` :120, the
packed word's decode and the nudge), ray by ray.

Both sides read the JAX compile's tables (carried over by
`interop.scene_data_from_jax`) and the same rays and hits: seeded numpy
rays, the JAX package's nearest hit of each (t, orientation, object id;
object 0 at t = FARAWAY on a miss).  The scenes: every analytic kind and
two triangles, textured (`all_kinds`); the beach ball's smooth normals and
corner uvs; a group of instances beside a plain triangle; the
normal-mapped scene.  Each is held as the bounce stage with uv as the
scene samples it, with uv forced, and as the first-hit pass (P zero on a
miss, the geometric normal).  The tolerance: the integer and bool fields
(miss, the word and its four fields) equal on every ray; P and the nudge
within 1e-6 relative; the normal within 1e-5 (relative, and absolute on
the hits) on at least 99.9% of the rays (XLA:CPU contracts a*b+c into
FMA, and at a miss's far point a box's face choice can flip); uv within
1e-4 relative (1e-5 absolute) on at least 99.5% of each kind's hits
(atan2 and asin are XLA:CPU approximations, and the box's face choice
flips where two scaled coordinates tie).  The uv of scenes that do not
sample it is zero on both sides.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
from raytracer_tpu.core import integrator as jint
from raytracer_tpu.core.compile import PACKED_DEPTH_SHIFT, PACKED_MC_SHIFT
from raytracer_tpu.core.compile import PACKED_SLOT_SHIFT
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.geometry import attrs as jattrs
from raytracer_tpu.geometry import intersect as jisect
from raytracer_tpu.utils.constants import MISS_THRESHOLD
from raytracer_tpu_torch.core.integrator import RenderSettings
from raytracer_tpu_torch.interop import scene_data_from_jax, static_from_jax
from raytracer_tpu_torch.ops import hit_attrs as ha

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh_compile import beach_ball, four_instances  # noqa: E402
from test_torch_normal_maps import mapped  # noqa: E402
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)
from test_torch_wavefront_intersect import all_kinds  # noqa: E402

N_RAYS = 4096
RATE = 0.999
UV_RATE = 0.995
NUDGE = 1e-6
SCENES = {"all_kinds": lambda m, d: all_kinds(m), "beach_ball": beach_ball,
          "instances": four_instances, "normal_mapped": mapped}
MODES = {"bounce": (False, False), "forced_uv": (True, False),
         "first_hit": (True, True)}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """{name: (JAX static, JAX data, port static, port data)}, compiled
    once."""
    d = tmp_path_factory.mktemp("obj")
    out = {}
    for name, build in SCENES.items():
        js, jd = jax_compile(build(J, d))
        out[name] = (js, jd, static_from_jax(js), scene_data_from_jax(jd))
    return out


def _rays(seed):
    """(O, D) float32: origins in a box around the scenes, aimed at points
    of their middle, a quarter of them anywhere."""
    rng = np.random.default_rng(seed)
    O = rng.uniform([-3, -1, -3], [3, 3, 5], (N_RAYS, 3))
    aim = rng.uniform([-2, -1, -2], [2, 1.5, 1], (N_RAYS, 3)) - O
    D = np.where(rng.uniform(size=(N_RAYS, 1)) < 0.25,
                 rng.normal(size=(N_RAYS, 3)), aim)
    D = D / np.linalg.norm(D, axis=1, keepdims=True)
    return O.astype(np.float32), D.astype(np.float32)


def jax_stage(O, D, t, orient, obj, jd, js, force_uv, first_hit):
    """The JAX package's attribute stage (integrator.py:221-236; the
    first-hit pass, ray.py:136, where first_hit) on its own hits."""
    P = O + D * t[..., None]
    miss = t >= MISS_THRESHOLD
    if first_hit:
        P = jnp.where(miss[..., None], 0.0, P)
    N, uv = jattrs.hit_attributes(P, obj, jd.geom, js, force_uv=force_uv)
    if first_hit:
        N = jnp.where(miss[..., None], 0.0, N)
        uv = jnp.where(miss[..., None], 0.0, uv)
    else:
        N = jint._apply_normal_maps(N, P, uv, obj, jd, js) * orient[..., None]
    packed = jnp.take(jd.obj.packed, obj, mode="clip")
    eps = NUDGE * jnp.maximum(1.0, jnp.max(jnp.abs(P), axis=-1))
    out = dict(P=P, N=N, uv=uv, miss=miss, packed=packed, mat_type=packed & 0x7,
               mat_slot=(packed >> PACKED_SLOT_SHIFT) & 0x3FF,
               obj_max_depth=(packed >> PACKED_DEPTH_SHIFT) & 0x3FF,
               obj_mc=((packed >> PACKED_MC_SHIFT) & 1).astype(bool), eps=eps)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_attributes_against_jax(compiled, one_torch_thread, name, mode):  # noqa: F811
    js, jd, ts, td = compiled[name]
    force_uv, first_hit = MODES[mode]
    O, D = _rays(7)
    jt, jo, jobj = jisect.nearest_hit(jnp.asarray(O), jnp.asarray(D), jd.geom)
    want = jax_stage(jnp.asarray(O), jnp.asarray(D), jt, jo, jobj, jd, js,
                     force_uv, first_hit)
    t = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    got = ha.attributes(t(O), t(D), t(jt), t(jo), t(jobj).long(), td, ts,
                        RenderSettings(nudge_eps=NUDGE), force_uv=force_uv,
                        first_hit=first_hit)
    got = {f: getattr(got, f).numpy() for f in ha.FLOAT_FIELDS + ha.OTHER_FIELDS}
    for f in ha.OTHER_FIELDS:
        assert got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]), f
    np.testing.assert_allclose(got["P"], want["P"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["eps"], want["eps"], rtol=1e-6)
    hit = np.asarray(jt) < 1e29
    # misses in the open scene (the mesh scenes have a sky sphere)
    assert hit.mean() > 0.2 and (name != "all_kinds" or hit.mean() < 0.98)
    close = np.isclose(got["N"], want["N"], rtol=1e-5, atol=1e-5).all(axis=1)
    assert close.mean() >= RATE, close.mean()
    np.testing.assert_allclose(got["N"][hit], want["N"][hit], rtol=1e-5, atol=1e-5)
    ids = np.asarray(jobj)
    need_uv = ts.needs_uv or force_uv
    if not need_uv:
        assert not got["uv"].any() and not want["uv"].any()
        return
    off = 0
    for kind in ("sphere", "plane", "box", "disc", "cyl", "tri"):
        c = ts.kind_counts[kind]
        sel = hit & (ids >= off) & (ids < off + c)
        off += c
        if c and sel.sum() > 10:
            ok = np.isclose(got["uv"][sel], want["uv"][sel], rtol=1e-4,
                            atol=1e-5).all(axis=1)
            assert ok.mean() >= UV_RATE, (kind, ok.mean())


def test_the_scenes_hold_their_cases(compiled):
    """Each scene drives what it is held for: every kind in all_kinds,
    smooth triangles with corner uvs, instances, normal maps."""
    kinds = {k for k, c in compiled["all_kinds"][2].kind_counts.items() if c}
    assert kinds == {"sphere", "plane", "box", "disc", "cyl", "tri"}
    assert compiled["beach_ball"][2].tri_interp
    assert compiled["instances"][3].geom.tri_virt_row.shape[0] > 0
    assert compiled["normal_mapped"][2].normal_maps
