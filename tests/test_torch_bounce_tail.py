"""The wavefront's bounce tail (ops/bounce_tail.py) against the JAX
package, on the CPU.

- The emissive and environment blocks (materials/shade.py
  `shade_emissive`, `shade_env`) against the JAX blocks, called with a
  JAX ShadeCtx on the same rays (tests/test_torch_wavefront_shade.py
  `contexts`): a solid slot's colour exact, an image texture's or a
  lightmap's texels within 1e-6 absolute (XLA:CPU may contract the
  bilinear weights' products into their sums), the environment at depth 0
  (no lightmap) and past it (with the lightmap).
- The plain start (`plain_start`: the merged output's start with those two
  blocks) against the JAX bounce's start and the same two merges
  (raytracer_tpu/core/integrator.py:239-287, restated here in jnp): `add`
  as the blocks, every other field exact.
- The plain update (`plain_update`) against the JAX bounce's update
  (integrator.py:289-310, restated here in jnp and jitted as the scan
  compiles it) on random carries from a numpy seed
  (tests/test_torch_bounce_tail_emu.py `random_update`): L within rtol 1e-6 /
  atol 1e-7 (XLA:CPU may contract L + beta * add into one FMA), every
  other field exact, rays_traced equal.
- A whole `trace` of a scene that draws nothing (glossy mirrors, a solid
  and a textured emissive sphere, a point light with shadow rays, a sky
  with a lightmap; several bounces) per ray against the JAX `trace` on the
  JAX compile's tables: L within rtol 1e-5 / atol 1e-6 (XLA:CPU contracts
  multiply-adds and approximates its transcendentals), rays_traced equal.
  Its textured emitter is a sphere, whose uv comes from atan2 and asin,
  which XLA and torch round differently in the last bits; a texel lookup
  multiplies uv's difference by W x repeat and the texture's contrast, so
  the emitter's texture is smooth here and the mirrors solid (a 32-texel
  checkerboard repeated 3 times put one ray 3e-5 off, and so did a wood
  texture on a mirror), and the sharp bilinear case is held in the block
  tests above, where both sides take the same uv.
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
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.core.integrator import RenderSettings as JSettings
from raytracer_tpu.core.integrator import trace as jax_trace
from raytracer_tpu.materials import shade as jshade
from raytracer_tpu.materials.base import MAT_EMISSIVE, MAT_ENV
from raytracer_tpu_torch.core import camera as tcam
from raytracer_tpu_torch.core.integrator import trace as torch_trace
from raytracer_tpu_torch.interop import scene_data_from_jax, static_from_jax
from raytracer_tpu_torch.materials import shade as tshade
from raytracer_tpu_torch.ops import bounce_tail as bt
from raytracer_tpu_torch.ops import wavefront_shade as ws

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bounce_tail_emu import random_update, update_args  # noqa: E402
from test_torch_scenes import (_procedural, lit_textures,  # noqa: E402
                               textured_scene)
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from test_torch_wavefront_shade import contexts, panorama_scene  # noqa: E402

TEXEL_ATOL = 1e-6


def drawless(m):
    """Nothing drawn past the camera rays: two glossy mirrors (one a
    metal), a solid and a bilinear-textured emissive sphere, a point light
    with shadow rays and the procedural sky with a lightmap."""
    proc = _procedural(m)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.04, 0.03))
    sc.add_Camera(look_from=m.vec3(0, 0.3, 1.9), look_at=m.vec3(0, 0.2, 0),
                  screen_width=16, screen_height=16, field_of_view=60)
    sc.add_PointLight(pos=m.vec3(1.5, 2.5, 1.0), color=m.rgb(3, 3, 3))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.8, 0.3, 0.2),
                                      n=m.vec3(1.5, 1.5, 1.5), roughness=0.0,
                                      spec_coeff=0.4, diff_coeff=0.6),
                    center=m.vec3(-0.55, 0.2, 0.0), radius=0.55, max_ray_depth=4))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.9, 0.6, 0.2),
                                      n=m.vec3(0.2 + 3.0j, 0.4 + 2.4j, 1.5 + 1.9j),
                                      roughness=0.0, spec_coeff=0.2,
                                      diff_coeff=0.8),
                    center=m.vec3(0.55, 0.2, -0.1), radius=0.55, max_ray_depth=4))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(2.0, 1.8, 1.5)),
                    center=m.vec3(0.0, 1.3, -0.8), radius=0.3, shadow=False))
    sc.add(m.Sphere(material=m.Emissive(color=m.image(proc.wood(32) * 2.0,
                                                      filter="bilinear")),
                    center=m.vec3(0.1, -0.5, 0.4), radius=0.3))
    sc.add_Background(m.procedural_sky(64, 32), light_intensity=2.0, blur=0.0)
    return sc


BLOCK_SCENES = [drawless, lit_textures, panorama_scene, textured_scene]
_CONTEXTS = {}


def _contexts(build):
    if build not in _CONTEXTS:
        _CONTEXTS[build] = contexts(build)
    return _CONTEXTS[build]


def _at_depth(jctx, tctx, past):
    """Both contexts with every ray at depth 0, or past it (1-4)."""
    n = tctx.depth.shape[0]
    d = (np.random.default_rng(5).integers(1, 5, n) if past else np.zeros(n)
         ).astype(np.int32)
    return (dataclasses.replace(jctx, depth=jnp.asarray(d)),
            dataclasses.replace(tctx, depth=torch.from_numpy(d)))


def _textured_slots(mt, static):
    """The slots of block mt whose colour is an image texture."""
    if mt == MAT_EMISSIVE:
        return {r.slot for r in static.emissive_tex}
    return {e.slot for e in static.env_slots}


def test_the_scenes_hold_their_cases():
    static = _contexts(drawless)[1].static
    assert {MAT_EMISSIVE, MAT_ENV} <= set(static.mat_types_present)
    assert set(static.mat_types_present) <= {1, 2, 6}      # nothing drawn
    assert any(r.bilinear for r in static.emissive_tex)
    assert static.env_slots and all(e.lightmap is not None for e in static.env_slots)
    assert _contexts(textured_scene)[1].static.env_slots[0].lightmap is None


@pytest.mark.parametrize("past", [False, True], ids=["depth0", "past"])
@pytest.mark.parametrize("build", BLOCK_SCENES, ids=[b.__name__ for b in BLOCK_SCENES])
def test_emissive_and_environment_blocks_per_ray(build, past, one_torch_thread):
    jctx, tctx, mat_type, hit = _contexts(build)
    jctx, tctx = _at_depth(jctx, tctx, past)
    present = jctx.static.mat_types_present
    held = 0
    for mt, name in ((MAT_EMISSIVE, "emissive"), (MAT_ENV, "env")):
        if mt not in present:
            continue
        want = np.asarray(getattr(jshade, f"shade_{name}")(jctx).add)
        got = getattr(tshade, f"shade_{name}")(tctx).add.numpy()
        sel = hit & (mat_type == mt)
        textured = np.isin(tctx.mat_slot.numpy(), list(_textured_slots(mt, tctx.static)))
        solid = sel & ~textured
        assert np.array_equal(got[solid], want[solid]), name
        np.testing.assert_allclose(got[sel & textured], want[sel & textured], rtol=0,
                                   atol=TEXEL_ATOL, err_msg=name)
        held += int(sel.sum())
    assert held >= 20


def jax_start(jctx, mat_type):
    """The JAX bounce's start with the emissive and environment blocks
    merged (raytracer_tpu/core/integrator.py:239-287)."""
    n = jctx.P.shape[0]
    f3 = lambda v: jnp.full((n, 3), v, jnp.float32)
    z = jnp.zeros((n,), bool)
    acc = dict(add=f3(0.0), beta_mult=f3(1.0), new_origin=jctx.P, new_dir=jctx.D,
               new_n_re=jctx.n_re, new_n_im=jctx.n_im, cont=z, is_diffuse=z,
               did_split=z)
    for mt, fn in ((MAT_EMISSIVE, jshade.shade_emissive), (MAT_ENV, jshade.shade_env)):
        if mt not in jctx.static.mat_types_present:
            continue
        out = fn(jctx)
        m = jnp.asarray(mat_type == mt)
        for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
            o = getattr(out, f)
            acc[f] = jnp.where(m[..., None] if o.ndim == 2 else m, o, acc[f])
    return acc


@pytest.mark.parametrize("past", [False, True], ids=["depth0", "past"])
@pytest.mark.parametrize("build", BLOCK_SCENES, ids=[b.__name__ for b in BLOCK_SCENES])
def test_plain_start_against_jax(build, past, one_torch_thread):
    jctx, tctx, mat_type, _ = _contexts(build)
    jctx, tctx = _at_depth(jctx, tctx, past)
    want = jax_start(jctx, mat_type)
    got = bt.plain_start(tctx, torch.from_numpy(mat_type.astype(np.int32)))
    for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(want[f])
        assert getattr(got, f).is_contiguous(), f
        if f == "add":
            np.testing.assert_allclose(a, b, rtol=0, atol=TEXEL_ATOL)
        else:
            assert np.array_equal(a, b), f


@jax.jit
def jax_update(L, beta, alive, miss, add, beta_mult, cont, new_O, new_D, new_n_re,
               new_n_im, is_diffuse, did_split, O, D, n_re, n_im, depth,
               diffuse_refl, split_cnt, rays_traced):
    """The JAX bounce's update (raytracer_tpu/core/integrator.py:289-310)."""
    shaded = alive & ~miss
    L = L + jnp.where(shaded[..., None], beta * add, 0.0)
    rays_traced = rays_traced + jnp.sum(alive.astype(jnp.int32))
    alive = shaded & cont
    a3 = alive[..., None]
    beta = jnp.where(a3, beta * beta_mult, beta)
    O = jnp.where(a3, new_O, O)
    D = jnp.where(a3, new_D, D)
    n_re = jnp.where(a3, new_n_re, n_re)
    n_im = jnp.where(a3, new_n_im, n_im)
    depth = depth + alive.astype(jnp.int32)
    diffuse_refl = diffuse_refl + (alive & is_diffuse).astype(jnp.int32)
    split_cnt = split_cnt + (shaded & did_split).astype(jnp.int32)
    return dict(L=L, beta=beta, alive=alive, depth=depth, diffuse_refl=diffuse_refl,
                split_cnt=split_cnt, O=O, D=D, n_re=n_re, n_im=n_im,
                rays_traced=rays_traced)


@pytest.mark.parametrize("shared_medium", [False, True], ids=["medium", "one_row"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_update_against_jax(seed, shared_medium, one_torch_thread):
    a = random_update(seed, shared_medium=shared_medium)
    want = jax_update(**{k: jnp.asarray(v) for k, v in a.items()
                         if k not in ("cont", "new_origin", "new_dir", "new_n_re",
                                      "new_n_im")},
                      cont=jnp.asarray(a["cont"]), new_O=jnp.asarray(a["new_origin"]),
                      new_D=jnp.asarray(a["new_dir"]),
                      new_n_re=jnp.asarray(a["new_n_re"]),
                      new_n_im=jnp.asarray(a["new_n_im"]))
    got = bt.plain_update(*update_args(a, shared_medium))
    for f in ("L", "beta", "alive", "depth", "diffuse_refl", "split_cnt", "O", "D",
              "n_re", "n_im", "rays_traced"):
        x, y = getattr(got, f).numpy(), np.asarray(want[f])
        if f == "L":
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
        else:
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f
    assert np.isnan(got.L.numpy()).any()         # NaN adds reach L


def test_a_drawless_trace_against_jax(one_torch_thread):
    sc = drawless(J)
    j_static, j_data = jax_compile(sc)
    static, data = static_from_jax(j_static), scene_data_from_jax(j_data)
    cam = sc.camera
    O, D = tcam.generate_rays(None, cam.params(), 16, 16, 4, strat_seed=7, sample0=0,
                              projection=cam.projection, device="cpu")
    n = O.shape[0]
    n_re, n_im = data.scene_n_re, data.scene_n_im
    want_L, want_stats = jax_trace(
        jax.random.PRNGKey(0), jnp.asarray(O.numpy()), jnp.asarray(D.numpy()),
        jnp.broadcast_to(jnp.asarray(n_re.numpy()), (n, 3)),
        jnp.broadcast_to(jnp.asarray(n_im.numpy()), (n, 3)), j_data, j_static,
        JSettings(max_bounces=6, collect_stats=True))
    got_L, got_stats = torch_trace(
        torch.Generator().manual_seed(0), O, D, n_re, n_im, data, static,
        T.RenderSettings(max_bounces=6, collect_stats=True))
    want_L = np.asarray(want_L)
    np.testing.assert_allclose(got_L.numpy(), want_L, rtol=1e-5, atol=1e-6)
    assert int(got_stats["rays_traced"]) == int(want_stats["rays_traced"])
    # a third of the rays go on past the camera's bounce, to the emitters,
    # the sky past it (the lightmap) and the mirrors' later reflections
    assert int(got_stats["rays_traced"]) > 1.35 * n and float(want_L.max()) > 0


def test_the_wrappers_run_the_plain_stages_on_cpu_tensors(one_torch_thread):
    """On CPU tensors the wrappers are the plain stages and launch
    nothing."""
    jctx, tctx, mat_type, _ = _contexts(drawless)
    before = bt.launches()
    mt = torch.from_numpy(mat_type.astype(np.int32))
    got = bt.bounce_start(tctx, None, mt)
    want = bt.plain_start(tctx, mt)
    for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    args = update_args(random_update(3))
    got, want = bt.bounce_update(*args), bt.plain_update(*args)
    for f in bt.CARRY_FLOATS + bt.CARRY_OTHERS:
        assert torch.equal(getattr(got, f).nan_to_num(), getattr(want, f).nan_to_num()), f
    assert bt.launches() == before
