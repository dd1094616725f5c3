"""The wavefront's six shading blocks against the JAX package's, per ray.

Each case builds one shading context from the same hits on both sides:
the JAX package's nearest hits and hit attributes of camera rays and of
secondary rays leaving those hits, with random path state (depth, diffuse
count, medium, split pattern and count) from a numpy seed.  A JAX block
draws its uniforms from its context's threefry key; the test draws them
from that key exactly as the block does and hands them to the port's
block, so the two compute the same function of the same numbers.  Held
on the rays whose object has the block's material: every output of a ray
equal within rtol 1e-4 / atol 1e-5 (XLA:CPU contracts FMA and
approximates transcendentals), on at least 99.8% of them.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
from raytracer_tpu.core import lds as jlds
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.core.compile import derive_split_k as jax_split_k
from raytracer_tpu.core.integrator import ShadeCtx as JCtx
from raytracer_tpu.materials import shade as jshade
from raytracer_tpu.materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV,
                                          MAT_GLOSSY, MAT_REFRACTIVE,
                                          MAT_THINFILM)
from raytracer_tpu_torch.core import camera as tcam
from raytracer_tpu_torch.core.integrator import ShadeCtx as TCtx
from raytracer_tpu_torch.geometry.attrs import hit_attributes
from raytracer_tpu_torch.geometry.intersect import nearest_hit
from raytracer_tpu_torch.interop import scene_data_from_jax, static_from_jax
from raytracer_tpu_torch.materials import shade as tshade

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (cornell, glass, is_diffuse,  # noqa: E402
                               lights_and_slots, lit_textures, textured_scene,
                               thinfilm_ibl, torch_primitives)
from test_torch_wavefront_compile import (grid49, groups37,  # noqa: E402,F401
                                          one_torch_thread)

RATE = 0.998


def panorama_scene(m):
    """A glossy and a diffuse sphere inside an equirect Panorama with a
    lightmap (the sphere environment kind)."""
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.3, 2.5), look_at=m.vec3(0, 0, 0),
                  screen_width=16, screen_height=12, field_of_view=70)
    sc.add_PointLight(pos=m.vec3(1, 2, 2), color=m.rgb(2, 2, 2))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.8, 0.3, 0.2),
                                      roughness=0.2, spec_coeff=0.4,
                                      diff_coeff=0.6, n=m.vec3(1.5, 1.5, 1.5)),
                    center=m.vec3(-0.5, 0, 0), radius=0.5, max_ray_depth=3))
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.3, 0.7, 0.3)),
                    center=m.vec3(0.7, -0.1, -0.3), radius=0.4))
    sc.add_Background(m.procedural_sky(64, 32), light_intensity=2.0,
                      spherical=True)
    return sc


def thin_film_plain(m):
    """A thin film without noise (the composed one-column table)."""
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0, 3), look_at=m.vec3(0, 0, 0),
                  screen_width=16, screen_height=16)
    sc.add(m.Sphere(material=m.ThinFilmInterference(thickness=400, noise=0.0),
                    center=m.vec3(0, 0, 0), radius=0.8, max_ray_depth=4))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.8, 0.7, 0.6)),
                    center=m.vec3(0, 0, 0), radius=20.0, shadow=False))
    return sc


def dispersion(m):
    return torch_primitives.dispersion(24, 18, m=m)


N_PRIMARY = 1024      # camera rays a case; as many secondary rays


def contexts(build, seed=0, strat=False, split=None):
    """(JAX ShadeCtx, port ShadeCtx, material type per ray, hit per ray)
    from one set of hits of scene `build`, on the JAX compile's tables.
    The hits come from the port's intersection (held against the JAX
    package's in test_torch_wavefront_intersect.py); both contexts get the
    same numbers.  Every case has the same ray count, so the JAX blocks'
    eager operations compile once for all of them."""
    sc = build(J)
    j_static, j_data = jax_compile(sc)
    static, data = static_from_jax(j_static), scene_data_from_jax(j_data)
    cam = sc.camera
    W, H = cam.screen_width, cam.screen_height
    spp = -(-N_PRIMARY // (W * H))
    O, D = tcam.generate_rays(None, cam.params(), W, H, spp, strat_seed=77,
                              sample0=0, projection=cam.projection,
                              device="cpu")
    O, D = O[:N_PRIMARY], D[:N_PRIMARY]
    rng = np.random.default_rng(seed)
    # secondary rays: from the camera rays' hits, random directions
    t1, _, _ = nearest_hit(O, D, data.geom)
    hit1 = (t1 < 1e29)[:, None]
    P1 = O + D * torch.clamp_max(t1, 1e3)[:, None]
    d2 = rng.normal(size=(N_PRIMARY, 3))
    d2 = torch.from_numpy((d2 / np.linalg.norm(d2, axis=1, keepdims=True))
                          .astype(np.float32))
    O = torch.cat([O, torch.where(hit1, P1 - 1e-3 * D, O)])
    D = torch.cat([D, d2])
    n = O.shape[0]

    t, orient, obj = nearest_hit(O, D, data.geom)
    P = O + D * t[..., None]
    N_geo, uv = hit_attributes(P, obj, data.geom, static)
    N = N_geo * orient[..., None]
    packed = data.obj.packed.numpy()[obj.numpy()]
    mat_type = packed & 7
    eps = 1e-6 * np.maximum(1.0, np.abs(P.numpy()).max(axis=-1))
    # random path state; a third of the rays inside the first refractive
    # material (or a made-up medium)
    n_s = data.scene_n_re.numpy()
    n_m = (data.mats.refr_n_re.numpy()[0] if data.mats.refr_n_re.shape[0]
           else n_s * 1.3)
    inside = rng.uniform(size=n) < 0.33
    split_k = jax_split_k(j_static) if split is None else split
    common = dict(
        bounce=1, depth=rng.integers(0, 5, n).astype(np.int32),
        diffuse_reflections=rng.integers(0, 3, n).astype(np.int32),
        t=t.numpy(), P=P.numpy(), N=N.numpy(), uv=uv.numpy(),
        orient=orient.numpy(), mat_slot=((packed >> 3) & 0x3FF).astype(np.int32),
        obj_max_depth=((packed >> 13) & 0x3FF).astype(np.int32),
        obj_mc=((packed >> 23) & 1).astype(bool), eps=eps.astype(np.float32),
        D=D.numpy(), n_re=np.where(inside[:, None], n_m, n_s).astype(np.float32),
        n_im=np.where(inside[:, None], 1e-7, 0.0).astype(np.float32),
        pattern=rng.integers(0, 1 << max(split_k, 1), n).astype(np.int32),
        split_cnt=rng.integers(0, max(split_k, 1) + 1, n).astype(np.int32),
        split_k=split_k)
    strat_u = None
    if strat:
        strat_u = tuple(np.asarray(u) for u in jlds.first_bounce_uniforms(
            32, 2 * N_PRIMARY, 1, jnp.float32(0), jnp.int32(5),
            jnp.int32(0)))
    jctx = JCtx(data=j_data, static=j_static,
                key=jax.random.PRNGKey(100 + seed),
                strat_u=(None if strat_u is None
                         else tuple(jnp.asarray(u) for u in strat_u)),
                **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in common.items()})
    tctx = TCtx(data=data, static=static,
                strat_u=(None if strat_u is None
                         else tuple(torch.from_numpy(np.array(u)) for u in strat_u)),
                **{k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                       else v) for k, v in common.items()})
    return jctx, tctx, mat_type, t.numpy() < 1e29


def jax_draws(mt, ctx):
    """The uniforms the JAX block `mt` draws from ctx.key, drawn as it does
    (shade.py:340-342, :436, :459, :537), as torch tensors."""
    n = ctx.t.shape
    tt = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    if mt == MAT_DIFFUSE:
        k_mix, k_phi, k_r2 = jax.random.split(ctx.key, 3)
        u = tuple(tt(jax.random.uniform(k, n)) for k in (k_mix, k_phi, k_r2))
        pick = None
        if ctx.static.n_is_targets > 0:
            # mixed_cosine_caps_sample splits the key again; caps_sample
            # picks with the first key of its own split
            k_caps = jax.random.split(ctx.key, 3)[2]
            k_pick = jax.random.split(k_caps, 3)[0]
            pick = tt(jax.random.randint(k_pick, n, 0, ctx.static.n_is_targets)).long()
        return (u, pick)
    if mt == MAT_REFRACTIVE:
        hero = None
        if ctx.static.has_dispersion:
            hero = tt(jax.random.randint(jax.random.fold_in(ctx.key, 77), n,
                                         0, 3)).long()
        return (tt(jax.random.uniform(ctx.key, n)), hero)
    if mt == MAT_THINFILM:
        return (tt(jax.random.uniform(ctx.key, n)),)
    return ()


BLOCKS = {MAT_EMISSIVE: "emissive", MAT_ENV: "env", MAT_GLOSSY: "glossy",
          MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
          MAT_THINFILM: "thinfilm"}

CASES = [  # (material type, scene, options)
    (MAT_EMISSIVE, glass, {}),
    (MAT_EMISSIVE, lit_textures, {}),
    (MAT_ENV, textured_scene, {}),
    (MAT_ENV, thinfilm_ibl, {}),
    (MAT_ENV, panorama_scene, {}),
    (MAT_GLOSSY, textured_scene, {}),
    (MAT_GLOSSY, lit_textures, {}),
    (MAT_GLOSSY, panorama_scene, {}),
    (MAT_GLOSSY, groups37, {}),
    (MAT_DIFFUSE, cornell, {}),
    (MAT_DIFFUSE, cornell, {"strat": True}),
    (MAT_DIFFUSE, lit_textures, {"strat": True}),
    (MAT_DIFFUSE, is_diffuse, {}),
    (MAT_DIFFUSE, grid49, {"strat": True}),
    (MAT_REFRACTIVE, glass, {}),
    (MAT_REFRACTIVE, glass, {"split": 0}),
    (MAT_REFRACTIVE, lights_and_slots, {}),
    (MAT_REFRACTIVE, lights_and_slots, {"split": 2}),
    (MAT_REFRACTIVE, dispersion, {}),
    (MAT_THINFILM, thinfilm_ibl, {}),
    (MAT_THINFILM, thin_film_plain, {}),
    (MAT_THINFILM, thin_film_plain, {"split": 0}),
]


def _ids(case):
    mt, build, opts = case
    return "-".join([BLOCKS[mt], build.__name__]
                    + [f"{k}{v}" for k, v in sorted(opts.items())])


FIELDS = ("add", "beta_mult", "new_origin", "new_dir", "new_n_re", "new_n_im",
          "cont", "is_reflection", "is_transmission", "is_diffuse", "did_split")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_shading_block_per_ray(case):
    mt, build, opts = case
    jctx, tctx, mat_type, hit = contexts(build, **opts)
    assert mt in jctx.static.mat_types_present
    name = BLOCKS[mt]
    want = getattr(jshade, f"shade_{name}")(jctx)
    got = getattr(tshade, f"shade_{name}")(tctx, *jax_draws(mt, jctx))
    # the rays this block shades: a hit on an object of its type
    sel = hit & (mat_type == mt)
    assert sel.sum() >= 20, sel.sum()
    ok = np.ones(sel.sum(), bool)
    for f in FIELDS:
        a = getattr(got, f).numpy()[sel]
        b = np.asarray(getattr(want, f))[sel]
        if a.dtype == bool:
            ok &= a == b
        else:
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5, equal_nan=True)
            ok &= close.reshape(close.shape[0], -1).all(axis=1)
    assert ok.mean() >= RATE, (ok.mean(), sel.sum())
