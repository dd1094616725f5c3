"""CustomMaterial in the port against the JAX package's.

A custom material is the wavefront's shading hook: `shade(ctx) ->
ShadeOut`, dispatched per material slot after the built-in blocks
(integrator.py:247-286).  examples/torch_features.py's Iridescent and
ToonMirror are torch shaders; the JAX side renders the same scene with
examples/example_custom_material.py's jnp shaders.  That scene draws
nothing inside `trace` (glossy, custom and emissive blocks take no
uniforms), so `trace` on given rays holds per ray against the JAX
package's: rtol 1e-4 / atol 1e-5, the shading blocks' tolerance
(measured on three ray sets: max abs difference 4.2e-6, where XLA:CPU's
FMA contraction and approximate cos move the Iridescent hue and the
glossy floor's light), and whole renders hold by a z-test.  Also:
default_shade_out, the parameter fingerprint, the routing (never a
kernel), the bounce budget, and a shader that draws from ctx.generator
renders bit-equal repeats.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import integrator as jint
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.core.compile import derive_max_bounces as jax_max_bounces
from raytracer_tpu_torch.core import integrator as tint
from raytracer_tpu_torch.core.compile import (compile_wavefront,
                                              derive_max_bounces)
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.interop import scene_data_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from test_torch_wavefront_render import _z_hold  # noqa: E402
import torch_features  # noqa: E402


def custom(m):
    return torch_features.custom_material(16, 12, m=m)


def test_routes_to_the_wavefront_only():
    j_static, _ = jax_compile(custom(J))
    static, data = compile_wavefront(custom(T))
    assert (static.pallas_ok, static.pallas_tex_ok) == (
        j_static.pallas_ok, j_static.pallas_tex_ok) == (False, False)
    assert [type(c).__name__ for c in static.custom_mats] == [
        type(c).__name__ for c in j_static.custom_mats] == [
        "Iridescent", "ToonMirror"]
    assert static.mat_types_present == j_static.mat_types_present
    assert static.needs_uv and j_static.needs_uv
    assert derive_max_bounces(static) == jax_max_bounces(j_static)
    for s in ("auto", "never"):
        assert route(static, T.RenderSettings(use_pallas=s)) == "wavefront"
    with pytest.raises(ValueError, match="outside both kernels"):
        route(static, T.RenderSettings(use_pallas="always"))


def test_trace_per_ray_against_jax():
    n = 2048
    rng = np.random.default_rng(0)
    O = np.tile(np.array([0, 0.35, 1.0], np.float32), (n, 1))
    tgt = rng.uniform([-2, -0.6, -4], [2, 1.0, -2], (n, 3)).astype(np.float32)
    D = (tgt - O) / np.linalg.norm(tgt - O, axis=-1, keepdims=True)
    j_static, j_data = jax_compile(custom(J))
    settings = J.RenderSettings(max_bounces=jax_max_bounces(j_static))
    want, _ = jint.trace(jax.random.PRNGKey(0), jnp.asarray(O), jnp.asarray(D),
                         j_data.scene_n_re, j_data.scene_n_im, j_data,
                         j_static, settings)
    static, data = compile_wavefront(custom(T))
    assert np.array_equal(data.geom.sphere_center.numpy(),
                          scene_data_from_jax(j_data).geom.sphere_center.numpy())
    got, _ = tint.trace(torch.Generator().manual_seed(0), torch.from_numpy(O),
                        torch.from_numpy(D), data.scene_n_re, data.scene_n_im,
                        data, static,
                        T.RenderSettings(max_bounces=derive_max_bounces(static)))
    want = np.asarray(want)
    assert (want.max(-1) > 0.05).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_statistical_against_jax():
    va = [np.asarray(custom(J).render(4, seed=s), np.float32).mean() / 255
          for s in (0, 1, 2)]
    vb = [np.asarray(custom(T).render(4, seed=s, device="cpu"),
                     np.float32).mean() / 255 for s in (0, 1, 2)]
    _z_hold(va, vb)


class FlatColor(T.CustomMaterial):
    def __init__(self, color):
        super().__init__()
        self.color = tuple(color)

    def shade(self, ctx):
        col = torch.tensor(self.color, dtype=torch.float32,
                           device=ctx.P.device).expand(ctx.P.shape)
        return dataclasses.replace(T.default_shade_out(ctx), add=col)


class Speckle(T.CustomMaterial):
    """Emits a random grey per hit, drawn from the chunk's generator."""

    def shade(self, ctx):
        u = torch.rand(ctx.P.shape[0], generator=ctx.generator,
                       device=ctx.P.device)
        return dataclasses.replace(T.default_shade_out(ctx),
                                   add=u[:, None].expand(-1, 3).contiguous())


def _one_sphere(mat, W=16, H=12):
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 1), look_at=T.vec3(0, 0, -1),
                  screen_width=W, screen_height=H)
    sc.add(T.Sphere(material=mat, center=T.vec3(0, 0, -3), radius=1))
    return sc


def test_flat_custom_equals_emissive():
    """tests/test_custom_material.py's criterion: a flat custom shader is
    the Emissive material, here exactly (both draw nothing)."""
    a = _one_sphere(FlatColor((0.9, 0.4, 0.1))).render(2, seed=3, device="cpu",
                                                       output="linear")
    sc = _one_sphere(T.Emissive(color=T.rgb(0.9, 0.4, 0.1)))
    sc.settings = T.RenderSettings(use_pallas="never")
    b = sc.render(2, seed=3, device="cpu", output="linear")
    assert np.array_equal(a, b)


def test_generator_draws_repeat_bit_equal():
    sc = _one_sphere(Speckle())
    a = sc.render(3, seed=5, device="cpu", output="linear")
    b = sc.render(3, seed=5, device="cpu", output="linear")
    c = sc.render(3, seed=6, device="cpu", output="linear")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the speckle averages to 1/2 where the sphere covers a pixel
    assert 0.2 < a[6, 8].mean() < 0.8


def test_default_shade_out_and_fingerprint():
    j_static, j_data = jax_compile(custom(J))
    static, data = compile_wavefront(custom(T))
    n = 5
    P = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    jctx = jint.ShadeCtx(data=j_data, static=j_static, bounce=0, key=None,
                         D=jnp.asarray(P), n_re=jnp.ones((n, 3)),
                         n_im=jnp.zeros((n, 3)), depth=None,
                         diffuse_reflections=None, t=None, P=jnp.asarray(P),
                         N=None, uv=None, orient=None, mat_slot=None,
                         obj_max_depth=None, obj_mc=None, eps=None)
    tctx = tint.ShadeCtx(data=data, static=static, bounce=0,
                         D=torch.from_numpy(P), n_re=torch.ones(n, 3),
                         n_im=torch.zeros(n, 3), depth=None,
                         diffuse_reflections=None, t=None,
                         P=torch.from_numpy(P), N=None, uv=None, orient=None,
                         mat_slot=None, obj_max_depth=None, obj_mc=None,
                         eps=None)
    want = J.default_shade_out(jctx)
    got = T.default_shade_out(tctx)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    # plain parameters change the fingerprint, as in the JAX package
    sc = custom(T)
    before = compile_wavefront(sc)[0].custom_fp
    sc.scene_primitives[0].material.brightness = 0.5
    after = compile_wavefront(sc)[0].custom_fp
    assert before[0] != after[0] and before[1] == after[1]
    with pytest.raises(NotImplementedError, match="implement shade"):
        T.CustomMaterial().shade(tctx)
