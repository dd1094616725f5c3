"""The solid kernel's plain version against the JAX Pallas kernel.

`solid_trace_chunk_reference` and `pallas_trace_chunk(..., interpret=True)`
get the same compiled tables (through `tables_from_jax`), camera and
seed_vec, so they trace the same paths ray by ray.  Chunks hold 16,384
rays, one Pallas tile of 128 x 128, so the kernel has no padding lanes
and both count the same rays.  Observed on the CPU with the seed below:
rays_traced identical in every case (47,196 / 34,555 / 32,768); per-ray
match (rtol 1e-4, atol 1e-5) 99.994% on Cornell (1 ray of 16,384 outside
the tolerance) and 100% on glass and IS-diffuse; bit-equal rays 93% /
54% / 86%, since the interpreter's XLA:CPU contracts a*b+c into FMA and
approximates rsqrt where the plain version does neither; mean L within
1.1e-7 relative.  The CUDA kernel is held against the plain version on the
card (tests/test_torch_scenes.py, chip_smoke.py).
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
from raytracer_tpu_torch.core.compile import compile_scene
from raytracer_tpu_torch.interop import tables_from_jax
from raytracer_tpu_torch.ops import solid_trace as st

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (cornell, glass, is_diffuse,  # noqa: E402
                               too_many_objects)

RTOL, ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999


def _jax_cam_vec(cam):
    return jnp.concatenate([cam.origin, cam.fwd, cam.right, cam.up,
                            jnp.stack([cam.cam_w, cam.cam_h, cam.lens_radius,
                                       cam.focal, cam.half_fov])])


CASES = [  # scene, spp (spp * H * W = 16,384), sampler
    (cornell, 64, "r2"),
    (glass, 256, "r2"),
    (is_diffuse, 256, "iid"),
]


@pytest.mark.parametrize("build,spp,sampler", CASES,
                         ids=[f"{c[0].__name__}-{c[2]}" for c in CASES])
def test_plain_version_matches_pallas_kernel(build, spp, sampler):
    sc = build(J)
    j_static, j_data = jax_compile(sc)
    _, _, settings = sc._settings_for_render(False)
    W, H = sc.camera.screen_width, sc.camera.screen_height
    assert spp * W * H == 16384
    seed = np.array([1234, -5678, 96], np.int32)
    L_j, n_j = pallas_trace_chunk(jnp.asarray(seed), j_data,
                                  _jax_cam_vec(sc.camera.params()), j_static,
                                  W, H, spp, settings.max_bounces, True, 0,
                                  sampler, "pinhole")
    L_j = np.asarray(L_j)

    _, tables = tables_from_jax(j_static, j_data)
    L_t, n_t = st.solid_trace_chunk_reference(
        torch.from_numpy(seed), tables, cam_vec(build(T).camera.params()),
        W, H, spp, settings.max_bounces, 0, sampler)
    L_t = L_t.numpy()

    assert int(n_t) == int(n_j)
    match = np.isclose(L_t, L_j, rtol=RTOL, atol=ATOL).all(axis=1)
    assert match.mean() >= MATCH_RATE, (match.mean(), np.nonzero(~match)[0])
    assert np.all(np.isfinite(L_t))
    m_t, m_j = L_t.mean(), L_j.mean()
    assert abs(m_t - m_j) <= 1e-3 * abs(m_j), (m_t, m_j)


def _cornell_inputs(width=16, height=16):
    sc = cornell(T)
    _, tables, settings = sc._settings_for_render()
    return tables, cam_vec(sc.camera.params()), settings


def test_cpu_tensors_take_the_plain_version():
    tables, cam, settings = _cornell_inputs()
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    before = st.solid_trace_chunk.launches
    L, n = st.solid_trace_chunk(seed, tables, cam, 16, 16, 2,
                                settings.max_bounces)
    L_ref, n_ref = st.solid_trace_chunk_reference(seed, tables, cam, 16, 16, 2,
                                                  settings.max_bounces)
    assert torch.equal(L, L_ref) and int(n) == int(n_ref)
    assert L.shape == (2 * 16 * 16, 3) and L.dtype == torch.float32
    assert st.solid_trace_chunk.launches == before


def test_out_of_slice_inputs_raise_before_work():
    """Fresnel splitting, the other projections, glossy shading and
    dispersion now run; a bad sampler, projection, split_k or device
    raises ValueError before any work, and a scene past the kernels' gate
    (49 objects) renders on the wavefront (ROADMAP.md item 3), not here."""
    tables, cam, settings = _cornell_inputs()
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    args = (seed, tables, cam, 16, 16, 2, settings.max_bounces)
    for kwargs in (dict(split_k=1), dict(projection="fisheye"),
                   dict(projection="equirect"), dict(projection="orthographic")):
        L, n = st.solid_trace_chunk(*args, **kwargs)
        assert L.shape == (2 * 16 * 16, 3) and torch.isfinite(L).all()
        assert int(n) >= 2 * 16 * 16
    for kwargs, what in ((dict(sampler="sobol"), "sampler"),
                         (dict(projection="stereo"), "projection"),
                         (dict(split_k=-1), "split_k")):
        with pytest.raises(ValueError, match=what):
            st.solid_trace_chunk(*args, **kwargs)
    with pytest.raises(ValueError, match="device"):
        st.solid_trace_chunk(seed.to("meta"), tables.to("meta"),
                             cam.to("meta"), 16, 16, 1, 4)

    # glossy (compiled by the JAX package) and dispersion
    sc = J.Scene()
    sc.add_Camera(look_from=J.vec3(0, 0, 2), look_at=J.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    sc.add_DirectionalLight(Ldir=J.vec3(0, -1, 0), color=J.rgb(1, 1, 1))
    sc.add(J.Sphere(material=J.Glossy(diff_color=J.rgb(0.5, 0.5, 0.5),
                                      n=J.vec3(1.5, 1.5, 1.5), roughness=0.2,
                                      spec_coeff=0.3, diff_coeff=0.7),
                    center=J.vec3(0, 0, 0), radius=0.5))
    _, glossy = tables_from_jax(*jax_compile(sc))
    sc = glass(T)
    sc.scene_primitives[0].material.dispersion = True
    _, disp = compile_scene(sc)
    for t in (glossy, disp):
        L, n = st.solid_trace_chunk(seed, t, cam, 8, 8, 1, 4)
        assert torch.isfinite(L).all() and int(n) >= 64
    img = too_many_objects(T).render(samples_per_pixel=1, device="cpu",
                                     output="linear")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_kernel_wrapper_checks_its_inputs():
    """The CUDA wrapper's checks run before anything is built or launched
    (here on CPU tensors, which the checks treat like any device's)."""
    tables, cam, settings = _cornell_inputs()
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    ok = (seed, tables, cam, 16, 16, 1, 4, "r2")
    with pytest.raises(TypeError, match="seed_vec"):
        st._launch(seed.long(), *ok[1:])
    with pytest.raises(ValueError, match="cam_vec"):
        st._launch(seed, tables, cam[:16], *ok[3:])
    with pytest.raises(ValueError, match="contiguous"):
        bad = tables.to("cpu")
        object.__setattr__(bad, "dif", torch.zeros(4, 3).t())
        st._launch(seed, bad, *ok[2:])
    with pytest.raises(ValueError, match="material slot"):
        bad = tables.to("cpu")
        object.__setattr__(bad, "dif", tables.dif[:1].clone())
        st._launch(seed, bad, *ok[2:])
    with pytest.raises(ValueError, match="chunk shape"):
        st._launch(seed, tables, cam, 16, 16, 0, 4, "r2")
