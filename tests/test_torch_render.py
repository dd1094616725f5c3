"""The port's Scene.render against the JAX package's.

The chunk seeds come from threefry in JAX and from numpy's generator in
the port, so whole renders agree exactly only where the estimator has no
noise (the emissive scene) and statistically elsewhere; the chunk plan
and the tonemapping are compared exactly.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import scene as jax_scene
from raytracer_tpu.utils.colour import tonemap_display as jax_tonemap
from raytracer_tpu_torch.core.scene import plan_chunks
from raytracer_tpu_torch.utils.colour import tonemap_display

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import cornell, emissive, glass  # noqa: E402


@pytest.mark.parametrize("clamp", [None, 0.4])
def test_emissive_render_equals_jax_exactly(clamp):
    for output in ("linear", "pil"):
        got = T.Scene.render(emissive(T), 2, seed=3, output=output,
                             clamp=clamp, device="cpu")
        want = J.Scene.render(emissive(J), 2, seed=3, output=output,
                              clamp=clamp)
        assert np.array_equal(np.asarray(got), np.asarray(want)), output


def test_cornell_statistical():
    """z-test on the image mean, as tests/test_pallas_trace.py holds the
    JAX package's paths against each other."""
    va, vb = [], []
    for s in (0, 1, 2):
        va.append(np.asarray(J.Scene.render(cornell(J), 24, seed=s),
                             np.float32).mean() / 255.0)
        vb.append(np.asarray(T.Scene.render(cornell(T), 24, seed=s,
                                            device="cpu"),
                             np.float32).mean() / 255.0)
    va, vb = np.asarray(va), np.asarray(vb)
    se = np.sqrt((va.std() ** 2 + vb.std() ** 2) / len(va))
    assert abs(va.mean() - vb.mean()) < max(4 * se, 0.01), (va, vb, se)


PLANS = [  # scene, width, height, spp, batch_size
    (cornell, 400, 400, 256, None),
    (cornell, 16, 16, 24, None),
    (cornell, 100, 100, 100, None),
    (cornell, 64, 48, 3, 7),
    (emissive, 2048, 2048, 5, None),
    (glass, 8, 8, 100, 20),
]


@pytest.mark.parametrize("build,width,height,spp,batch", PLANS,
                         ids=[f"{p[0].__name__}-{p[1]}x{p[2]}x{p[3]}-{p[4]}"
                              for p in PLANS])
def test_chunk_plan_matches_jax(monkeypatch, build, width, height, spp, batch):
    """The JAX render loop runs with its chunk tracer stubbed out; the
    chunk sizes it asks for are the plan."""
    calls = []

    def fake_chunk(k_i, data, cam, static, settings, W, H, chunk, **kw):
        calls.append(chunk)
        return jnp.zeros((W * H, 3), jnp.float32), {"rays_traced": jnp.int32(0)}

    monkeypatch.setattr(jax_scene, "_render_chunk", fake_chunk)
    sc = build(J)
    sc.camera.screen_width, sc.camera.screen_height = width, height
    _, stats = sc.render(samples_per_pixel=spp, batch_size=batch,
                         output="linear", return_stats=True)
    port = build(T)
    _, _, settings = port._settings_for_render()
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(spp * port._diffuse_fan() * fan, width,
                                  height, fan, batch)
    assert calls == [chunk] * n_chunks
    assert stats["samples"] == chunk * n_chunks
    if (build, width, spp) == (cornell, 400, 256):
        assert (chunk, n_chunks) == (26, 197)


@pytest.mark.parametrize("operator", ["srgb", "aces", "reinhard"])
def test_tonemap_matches_jax(operator):
    x = np.random.default_rng(4).gamma(0.6, 0.8, (4096, 3)).astype(np.float32)
    x[:8] = 0.0
    for scale in (1.0, 2.0 ** -1.5):
        got = tonemap_display(torch.from_numpy(x), operator, scale).numpy()
        want = np.asarray(jax_tonemap(jnp.asarray(x), operator, scale))
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)


def test_render_stats_and_argument_checks():
    sc = cornell(T)
    img, stats = sc.render(samples_per_pixel=1, output="linear",
                           return_stats=True, device="cpu")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert stats["samples"] == 20 and stats["width"] == stats["height"] == 16
    assert stats["rays_traced"] >= 20 * 16 * 16
    for kwargs in (dict(output="png"), dict(tonemap="filmic")):
        with pytest.raises(ValueError):
            sc.render(1, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        sc.render(0, device="cpu")
    with pytest.raises(RuntimeError):
        T.Scene().render(1)
