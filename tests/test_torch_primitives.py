"""The port's triangles, discs, cylinders, glossy shading, Fresnel split and
dispersion against the JAX package.

- The host tables of the new primitives and materials equal the JAX
  compile bit for bit, and both packages route each scene to the same
  kernel.
- The solid kernel's plain version (`solid_trace_chunk_reference`) against
  `pallas_trace_chunk(..., interpret=True)` on three 16,384-ray chunks,
  one Pallas tile each: example 2 as a solid scene (glossy, a directional
  light with shadow rays, split_k 3), two dispersive glasses in one merged
  group beside a second dispersive group, and a scene of triangles, discs
  and cylinders with a point and a spot light.  The interpreter's XLA:CPU
  contracts a*b+c into FMA and approximates rsqrt and pow, so rays match
  at a rate (rtol 1e-4, atol 1e-5), not bit for bit; rays_traced is
  equal, or off only through the rays whose paths diverged.  Each case is
  one interpret call, cached per module.
- Whole renders of the dispersion and primitives examples at 16x12
  against JAX `Scene.render`, statistically (the chunk seeds differ).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.ops.pallas_trace import pallas_trace_chunk
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.compile import (OBJ_HU1, OBJ_HU2,
                                              compile_scene)
from raytracer_tpu_torch.interop import tables_from_jax
from raytracer_tpu_torch.ops import solid_trace as st

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (dispersive_pair, example2_solid,  # noqa: E402
                               primitives_dispersive, solid_primitives,
                               torch_primitives)

RTOL, ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999
SEED = np.array([1234, -5678, 96], np.int32)


def _example(name):
    def build(m):
        return torch_primitives.BUILDERS[name](16, 12, m=m)
    build.__name__ = name
    return build


HOST_SCENES = [_example(k) for k in ("primitives", "dispersion", "still_life",
                                     "fisheye", "panorama", "example2_solid")]
HOST_SCENES += [solid_primitives, dispersive_pair, primitives_dispersive]


@pytest.mark.parametrize("build", HOST_SCENES, ids=lambda f: f.__name__)
def test_tables_match_jax_exactly(build):
    static, tables = compile_scene(build(T))
    j_static, j_tables = tables_from_jax(*jax_compile(build(J)))
    assert static == j_static
    for name in tables.TENSORS:
        a, b = getattr(tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tables.obj_rows == j_tables.obj_rows
    assert tables.n_lights == j_tables.n_lights


@pytest.mark.parametrize("build", HOST_SCENES, ids=lambda f: f.__name__)
def test_routing_and_settings_match_jax(build):
    port, ref = build(T), build(J)
    static, _, settings = port._settings_for_render()
    j_static, _, j_settings = ref._settings_for_render(False)
    assert (static.pallas_ok, static.pallas_tex_ok) == (
        j_static.pallas_ok, j_static.pallas_tex_ok)
    assert static.pallas_ok or static.pallas_tex_ok
    assert (settings.max_bounces, settings.split_k, settings.projection) == (
        j_settings.max_bounces, j_settings.split_k, j_settings.projection)
    assert port._diffuse_fan() == ref._diffuse_fan()


def test_dispersive_groups_are_numbered_per_kernel():
    """The solid kernel merges the two depth-4 glasses into one group (one
    hero-wavelength draw); the record kernel keeps one group per slot."""
    _, tables = compile_scene(dispersive_pair(T))
    hu1 = [r[OBJ_HU1] for r in tables.obj_rows]
    hu2 = [r[OBJ_HU2] for r in tables.obj_rows]
    assert hu1 == [0, 0, 1, -1, -1] and hu2 == [0, 1, 2, -1, -1]
    assert st.hu_groups(tables.obj_rows) == [4, 2]


def _jax_cam_vec(cam):
    return jnp.concatenate([cam.origin, cam.fwd, cam.right, cam.up,
                            jnp.stack([cam.cam_w, cam.cam_h, cam.lens_radius,
                                       cam.focal, cam.half_fov])])


def hold_solid(build, spp, sampler):
    """One interpret call of the Pallas solid kernel and the plain version
    on the same tables, camera and seed."""
    sc = build(J)
    j_static, j_data = jax_compile(sc)
    _, _, settings = sc._settings_for_render(False)
    W, H = sc.camera.screen_width, sc.camera.screen_height
    assert spp * W * H == 16384 and j_static.pallas_ok
    L_j, n_j = pallas_trace_chunk(jnp.asarray(SEED), j_data,
                                  _jax_cam_vec(sc.camera.params()), j_static,
                                  W, H, spp, settings.max_bounces, True,
                                  settings.split_k, sampler, settings.projection)
    _, tables = tables_from_jax(j_static, j_data)
    L_t, n_t = st.solid_trace_chunk_reference(
        torch.from_numpy(SEED), tables, cam_vec(build(T).camera.params()),
        W, H, spp, settings.max_bounces, settings.split_k, sampler,
        settings.projection)
    return dict(L_j=np.asarray(L_j), n_j=int(n_j), L_t=L_t.numpy(),
                n_t=int(n_t), B=settings.max_bounces, split_k=settings.split_k)


def check_solid(c):
    match = np.isclose(c["L_t"], c["L_j"], rtol=RTOL, atol=ATOL).all(axis=1)
    assert match.mean() >= MATCH_RATE, (match.mean(), np.nonzero(~match)[0][:10])
    assert np.isfinite(c["L_t"]).all()
    m_t, m_j = c["L_t"].mean(), c["L_j"].mean()
    assert abs(m_t - m_j) <= 1e-3 * abs(m_j), (m_t, m_j)


SOLID_CASES = {  # scene, spp (spp * H * W = 16,384), sampler
    "example2_solid-split3-r2": (example2_solid, 64, "r2"),
    "dispersive_pair-iid": (dispersive_pair, 64, "iid"),
    "solid_primitives-r2": (solid_primitives, 64, "r2"),
}


@pytest.fixture(scope="module", params=list(SOLID_CASES))
def solid_case(request):
    return request.param, hold_solid(*SOLID_CASES[request.param])


def test_plain_version_matches_pallas_kernel(solid_case):
    name, c = solid_case
    check_solid(c)
    if name.startswith("example2"):
        assert c["split_k"] == 3


def test_rays_traced_equal(solid_case):
    """rays_traced equal, or off only through the rays whose paths
    diverged (a ray traces at most max_bounces rays): observed equal on
    the glossy and dispersive scenes, 33,334 against 33,329 on the
    cylinders, where 8 of 16,384 rays diverge."""
    _, c = solid_case
    diverged = ~np.isclose(c["L_t"], c["L_j"], rtol=RTOL, atol=ATOL).all(axis=1)
    assert abs(c["n_t"] - c["n_j"]) <= c["B"] * diverged.sum(), (c["n_t"], c["n_j"])


@pytest.mark.parametrize("name,spp", [("dispersion", 48), ("primitives", 12)])
def test_render_statistical(name, spp):
    """z-test on the linear image mean over three seeds, as
    tests/test_torch_render.py holds the Cornell box."""
    build = torch_primitives.BUILDERS[name]
    va, vb = [], []
    for s in (0, 1, 2):
        va.append(np.asarray(J.Scene.render(build(16, 12, m=J), spp, seed=s,
                                            output="linear")).mean())
        vb.append(T.Scene.render(build(16, 12, m=T), spp, seed=s,
                                 output="linear", device="cpu").mean())
    va, vb = np.asarray(va), np.asarray(vb)
    se = np.sqrt((va.std() ** 2 + vb.std() ** 2) / len(va))
    assert abs(va.mean() - vb.mean()) < max(4 * se, 0.02 * va.mean()), (va, vb, se)
