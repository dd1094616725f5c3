"""Environment importance sampling in the port against the JAX package's.

The alias tables are host numpy in both packages, so the port's own copy
must give the JAX tables exactly: prob and alias equal, pdf bit for bit,
on examples/example_env_is.py's sun sky at its full 256x512 (a 128x256
cell grid) and on a small map.  The compile carries them into SceneData
(equal to the JAX package's) and SceneStatic.env_is_shape.  The
environment branch of the diffuse block is held per ray given the JAX
block's own uniforms, as tests/test_torch_wavefront_shade.py holds the
other blocks (rtol 1e-4 / atol 1e-5 on 99.8% of the rays: XLA:CPU
approximates the sampler's cos / sin and the pdf's atan2 / asin).  Whole
renders: a z-test against JAX over seeds, and within the port the
importance-sampled image against the plain one (same mean, less
variance).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import _env_is_tables as jax_tables
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.materials import shade as jshade
from raytracer_tpu.materials.base import MAT_DIFFUSE
from raytracer_tpu_torch.core.compile import _env_is_tables, compile_wavefront
from raytracer_tpu_torch.interop import scene_data_from_jax
from raytracer_tpu_torch.materials import shade as tshade

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from test_torch_wavefront_render import _z_hold  # noqa: E402
from test_torch_wavefront_shade import FIELDS, RATE, contexts  # noqa: E402
import torch_features  # noqa: E402


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("which", ["sun_sky", "small"])
def test_alias_tables_equal_jax(which):
    if which == "sun_sky":
        env = torch_features.sun_sky()
        assert env.shape == (256, 512, 3)
    else:
        r = np.random.default_rng(4)
        env = r.uniform(0.0, 2.0, (20, 36, 3)).astype(np.float32)
        env[3:5, 10:13] = 500.0
    prob, alias, pdf, hw = _env_is_tables(env)
    jprob, jalias, jpdf, jhw = jax_tables(env)
    assert hw == jhw == ((128, 256) if which == "sun_sky" else (20, 36))
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    assert np.array_equal(alias, jalias)
    assert np.array_equal(_bits(prob), _bits(jprob))
    assert np.array_equal(_bits(pdf), _bits(jpdf))
    # cached by the source array's identity
    assert _env_is_tables(env)[0] is prob


def env_scene(m):
    """examples/example_env_is.py at 16x12."""
    return torch_features.env_is(16, 12, m=m)


def env_and_caps(m):
    """The sun sky plus an importance-sampled emitter: the mixture's
    cosine, caps and environment components together."""
    sc = torch_features.env_is(16, 12, m=m)
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(4, 4, 4)),
                    center=m.vec3(0.0, 1.6, 0.3), radius=0.25, shadow=False),
           importance_sampled=True)
    return sc


@pytest.mark.parametrize("build", [env_scene, env_and_caps],
                         ids=["env", "env_and_caps"])
def test_scene_data_equals_jax(build):
    j_static, j_data = jax_compile(build(J))
    static, got = compile_wavefront(build(T))
    want = scene_data_from_jax(j_data)
    for f in ("env_is_prob", "env_is_alias", "env_is_pdf"):
        a, b = getattr(got, f).numpy(), getattr(want, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert static.env_is_shape == tuple(j_static.env_is_shape) == (128, 256)
    assert (static.pallas_ok, static.pallas_tex_ok) == (
        j_static.pallas_ok, j_static.pallas_tex_ok) == (False, False)


def test_black_map_keeps_the_plain_mixture():
    def scene(m):
        return torch_features.env_is(8, 6, sky=np.zeros((8, 16, 3),
                                                        np.float32), m=m)
    j_static, _ = jax_compile(scene(J))
    static, data = compile_wavefront(scene(T))
    assert static.env_is_shape == tuple(j_static.env_is_shape) == (0, 0)
    assert data.env_is_prob.shape == (0,)
    assert not static.pallas_tex_ok and not j_static.pallas_tex_ok


def _env_draws(ctx):
    """The diffuse block's uniforms and, with targets, the caps pick, as
    the JAX block draws them under environment importance sampling
    (shade.py:340-356, rng.py:276-281)."""
    n = ctx.t.shape
    tt = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    keys = jax.random.split(ctx.key, 3)
    u = tuple(tt(jax.random.uniform(k, n)) for k in keys)
    pick = None
    if ctx.static.n_is_targets > 0:
        k_caps = jax.random.split(ctx.key, 5)[2]
        k_pick = jax.random.split(k_caps, 3)[0]
        pick = tt(jax.random.randint(k_pick, n, 0,
                                     ctx.static.n_is_targets)).long()
    return u, pick


@pytest.mark.parametrize("build,strat", [(env_scene, False),
                                         (env_scene, True),
                                         (env_and_caps, False)],
                         ids=["env", "env-strat", "env_and_caps"])
def test_env_branch_of_shade_diffuse_per_ray(build, strat):
    jctx, tctx, mat_type, hit = contexts(build, strat=strat)
    assert tuple(jctx.static.env_is_shape) != (0, 0)
    want = jshade.shade_diffuse(jctx)
    got = tshade.shade_diffuse(tctx, *_env_draws(jctx))
    sel = hit & (mat_type == MAT_DIFFUSE)
    assert sel.sum() >= 20
    ok = np.ones(sel.sum(), bool)
    for f in FIELDS:
        a = getattr(got, f).numpy()[sel]
        b = np.asarray(getattr(want, f))[sel]
        if a.dtype == bool:
            ok &= a == b
        else:
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5, equal_nan=True)
            ok &= close.reshape(close.shape[0], -1).all(axis=1)
    assert ok.mean() >= RATE, ok.mean()
    # every continuation is a direction
    d = got.new_dir.numpy()[sel]
    assert np.isfinite(d).all()


def _mean(m, build, spp, seed, **kw):
    if m is J:
        img = build(J).render(spp, seed=seed, output="linear")
    else:
        img = build(T).render(spp, seed=seed, output="linear", device="cpu",
                               **kw)
    return np.asarray(img, np.float64)


def test_statistical_against_jax():
    va = [_mean(J, env_scene, 8, s).mean() for s in (0, 1, 2)]
    vb = [_mean(T, env_scene, 8, s).mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_importance_sampling_lowers_the_variance():
    """Within the port: the same image mean with and without the alias
    tables (4 standard errors over seeds), and a lower pixel variance of
    the importance-sampled estimate."""
    plain = lambda m: torch_features.env_is(16, 12, importance_sampled=False,
                                            m=m)
    a = [_mean(T, env_scene, 8, s) for s in (0, 1, 2, 3)]
    b = [_mean(T, plain, 8, s) for s in (0, 1, 2, 3)]
    _z_hold([x.mean() for x in a], [x.mean() for x in b])
    var = lambda imgs: np.var(np.stack(imgs), axis=0).mean()
    assert var(a) < var(b)

