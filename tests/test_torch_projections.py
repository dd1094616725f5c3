"""The fisheye, equirect and orthographic cameras of the port against the
JAX package.

- Ray generation (`camera_rays`) against the Pallas kernels' own `_raygen`
  on the same draws, for every projection: origins and directions agree
  to float rounding (the angular projections take sin / cos, which
  XLA:CPU approximates).
- The solid kernel's plain version against `pallas_trace_chunk(...,
  interpret=True)` on the 16x16 Cornell box under each of the three
  projections, 16,384 rays a chunk (one interpret call each, cached per
  module); tests/test_torch_projections_record.py holds the record
  kernel the same way.
- `projection_mask` equals the JAX package's, and a fisheye render is
  exactly 0 outside the image circle.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu.core.camera import projection_mask as jax_projection_mask
from raytracer_tpu.ops.pallas_trace import _raygen
from raytracer_tpu_torch.core.camera import cam_vec, projection_mask
from raytracer_tpu_torch.ops import solid_trace as st

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_primitives import check_solid, hold_solid  # noqa: E402
from test_torch_scenes import (cornell_projection,  # noqa: E402
                               still_life_projection)

PROJECTIONS = ("pinhole", "fisheye", "equirect", "orthographic")


@pytest.mark.parametrize("projection", PROJECTIONS)
@pytest.mark.parametrize("scene", ["cornell", "still_life"])
def test_camera_rays_match_jax_raygen(projection, scene):
    build = (cornell_projection(projection) if scene == "cornell"
             else still_life_projection(projection, 24, 12))
    sc = build(T)
    if projection == "pinhole":
        sc.camera.aperture, sc.camera.focal_distance = 0.3, 2.0
    W, H, spp = sc.camera.screen_width, sc.camera.screen_height, 3
    cam = cam_vec(sc.camera.params())
    seed = torch.tensor([77, 5, 0], dtype=torch.int64)
    idx, rays, _, counter0 = st.camera_rays(seed, cam, W, H, spp, "iid",
                                            projection)
    assert counter0 == 4
    u = [st.hash_uniform(idx, seed[0], c).numpy() for c in range(1, 5)]
    pix = idx.numpy() % (W * H)
    cj = jnp.asarray(cam.numpy())
    want = _raygen(lambda j: cj[j], jnp.asarray(pix % W), jnp.asarray(pix // W),
                   W, H, *(jnp.asarray(x) for x in u), projection, pix.shape)
    for got, ref in zip(rays, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=5e-6 * (1 + np.abs(np.asarray(ref)).max()))


SOLID_CASES = {p: cornell_projection(p) for p in PROJECTIONS[1:]}


@pytest.fixture(scope="module", params=list(SOLID_CASES))
def solid_case(request):
    return hold_solid(SOLID_CASES[request.param], 64, "r2")


def test_plain_version_matches_pallas_kernel(solid_case):
    check_solid(solid_case)


def test_rays_traced_equal(solid_case):
    diverged = ~np.isclose(solid_case["L_t"], solid_case["L_j"], rtol=1e-4,
                           atol=1e-5).all(axis=1)
    assert abs(solid_case["n_t"] - solid_case["n_j"]) <= (
        solid_case["B"] * diverged.sum())


@pytest.mark.parametrize("projection", PROJECTIONS)
@pytest.mark.parametrize("width,height", [(16, 16), (40, 24), (7, 13)])
def test_projection_mask_matches_jax(projection, width, height):
    got = projection_mask(projection, width, height)
    want = jax_projection_mask(projection, width, height)
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_fisheye_render_is_black_outside_the_circle():
    """Out-of-circle pixels are traced and counted, and come out exactly
    0; the pixels inside do not."""
    sc = still_life_projection("fisheye", 24, 16)(T)
    img, stats = sc.render(samples_per_pixel=1, output="linear",
                           return_stats=True, device="cpu")
    mask = projection_mask("fisheye", 24, 16).reshape(16, 24)
    assert np.all(img[mask == 0] == 0.0) and (mask == 0).sum() > 0
    assert np.all(img[mask == 1].sum(axis=-1) > 0)
    assert stats["rays_traced"] >= stats["samples"] * 24 * 16
