"""Differentiable rendering through the port (raytracer_tpu_torch/diff.py)
against the JAX package's (raytracer_tpu/diff.py, tests/test_diff.py).

Every test of tests/test_diff.py runs on the port: gradients with
respect to material tables finite and equal to central finite
differences (rtol 0.05), exact for the linear emissive colour, across a
4x2 mesh of CPU shards, through two checkpointed chunks; the spp checks;
safe_value_and_grad's scrub; safe_norm at 0; and an IoR recovered by
Adam.  Besides: each shading block's per-ray gradient against jax.grad
of the JAX block given the same uniforms (as
tests/test_torch_wavefront_shade.py holds the values; rtol 1e-3, atol
1e-4 on >= 99% of the block's rays, the table gradients summed over the
rays at rtol 2e-3); render_fn(data) equal to Scene.render(...,
output="linear") under use_pallas="never" bit for bit (the same chunks,
the same per-pixel sums in the same order, the same division); two
backward passes bit-equal (the checkpointed recompute draws the same
numbers).  16x16 frames, one torch thread.
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
from raytracer_tpu.materials import shade as jshade
from raytracer_tpu.materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV,
                                          MAT_GLOSSY, MAT_REFRACTIVE,
                                          MAT_THINFILM)
from raytracer_tpu_torch.core.safemath import safe_norm
from raytracer_tpu_torch.diff import (differentiable_render,
                                      differentiable_render_sharded,
                                      safe_value_and_grad, update_lights,
                                      update_materials)
from raytracer_tpu_torch.materials import shade as tshade
from raytracer_tpu_torch.parallel.sharded import make_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (cornell, glass, lights_and_slots,  # noqa: E402
                               lit_textures)
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from test_torch_wavefront_shade import (contexts, dispersion,  # noqa: E402
                                        jax_draws, thin_film_plain)

CPU = torch.device("cpu")


def glass_scene(n=1.5, wh=(16, 16), m=T):
    """tests/test_diff.py glass_scene: a glass sphere (a trace of
    absorption) in an emissive enclosure."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=wh[0], screen_height=wh[1], field_of_view=30)
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(n + 1e-6j, n + 1e-6j,
                                                   n + 1e-6j)),
                    center=m.vec3(0, 0, 0), radius=0.5, shadow=False,
                    max_ray_depth=3))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.8, 0.6, 0.4)),
                    center=m.vec3(0, 0, 0), radius=20.0, shadow=False))
    return sc


def _fd_check(fn, data, table="refr_n_re", g=None, eps=1e-3):
    """d loss / d table (loss the mean squared image; the table a material
    table or a leaf `_table` names) finite, not zero, and its entry [0, 0]
    (where g, the gradient, is given: its largest entry) within rtol 0.05
    of the central difference at eps."""
    def loss(x):
        return torch.mean(fn(_with_tables(data, {table: x})) ** 2)

    n0 = _table(data, table)
    if g is None:
        x = n0.clone().requires_grad_(True)
        g, = torch.autograd.grad(loss(x), x)
        at = (0, 0)
    else:
        at = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 1e-5          # not silently zero
    e = torch.zeros_like(n0)
    e[at] = eps
    with torch.no_grad():
        fd = (loss(n0 + e) - loss(n0 - e)) / (2 * eps)
    assert np.isclose(float(fd), float(g[at]), rtol=0.05), (table, fd, g[at])
    return g


def test_grad_finite_and_matches_fd():
    fn, data = differentiable_render(glass_scene(), 4, device=CPU)
    _fd_check(fn, data)


def test_grad_wrt_emissive_color_is_exact():
    # radiance is linear in the emitter colour: the gradient is the same
    # at any emitter value and scaling is exact
    fn, data = differentiable_render(glass_scene(), 2, device=CPU)

    def mean_img(em):
        return torch.mean(fn(update_materials(data, emissive_color=em)))

    em0 = data.mats.emissive_color
    with torch.no_grad():
        assert np.isclose(float(mean_img(2.0 * em0)),
                          2.0 * float(mean_img(em0)), rtol=1e-5)
    g = safe_value_and_grad(mean_img)(em0)[1]
    g2 = safe_value_and_grad(mean_img)(2.0 * em0)[1]
    assert torch.isfinite(g).all()
    assert np.allclose(g.numpy(), g2.numpy(), rtol=1e-5)


def test_sharded_grad_finite_and_matches_fd():
    # the data-parallel gradient: a 4x2 mesh of CPU shards, the shards'
    # sums added in order; autograd goes back through each shard
    mesh = make_mesh(4, 2, [CPU] * 8)
    fn, data = differentiable_render_sharded(glass_scene(), 8, mesh=mesh)
    _fd_check(fn, data)


def test_chunked_render_grad_matches_fd():
    # 32 camera samples x 8 split patterns = 256 eff spp: two chunks of
    # 128, each under torch.utils.checkpoint
    fn, data = differentiable_render(glass_scene(), 32, device=CPU)
    _fd_check(fn, data)
    fn1, _ = differentiable_render(glass_scene(), 8, device=CPU)
    with torch.no_grad():
        a, b = fn(data).numpy(), fn1(data).numpy()
    assert abs(a.mean() - b.mean()) < 0.02, (a.mean(), b.mean())


def test_spp_validation():
    with pytest.raises(ValueError, match="samples_per_pixel"):
        differentiable_render(glass_scene(), 0, device=CPU)
    with pytest.raises(ValueError, match="samples_per_pixel"):
        differentiable_render_sharded(glass_scene(), 0,
                                      mesh=make_mesh(4, 2, [CPU] * 8))


def test_safe_value_and_grad_scrubs_nonfinite():
    # a where-scrub repairs the forward value, not the backward pass
    denom = torch.tensor([1.0, 0.0])

    def f(x):
        y = x / denom
        return torch.sum(torch.where(torch.isfinite(y), y, 0.0))

    x0 = torch.tensor([2.0, 3.0])
    x = x0.clone().requires_grad_(True)
    v_plain = f(x)
    g_plain, = torch.autograd.grad(v_plain, x)
    assert torch.isfinite(v_plain) and not torch.isfinite(g_plain).all()
    v, g = safe_value_and_grad(f)(x0)
    assert float(v) == float(v_plain.detach())
    assert torch.isfinite(g).all()
    assert float(g[0]) == 1.0 and float(g[1]) == 0.0


def test_safe_norm_grad_finite_at_zero():
    # vector_norm's backward is 0/0 at the origin; safe_norm's is defined
    z = torch.zeros((4, 3), requires_grad=True)
    g, = torch.autograd.grad(safe_norm(z).sum(), z)
    assert torch.isfinite(g).all()
    # the hazard is real in the JAX package (jnp.linalg.norm's VJP)
    g_ref = jax.grad(lambda v: jnp.sum(jnp.linalg.norm(v, axis=-1)))(
        jnp.zeros((4, 3)))
    assert not np.all(np.isfinite(np.asarray(g_ref)))
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 3))
                         .astype(np.float32))
    assert np.allclose(safe_norm(v).numpy(),
                       torch.linalg.vector_norm(v, dim=-1).numpy(), rtol=1e-6)
    # and the JAX package's safe_norm gives the same values
    from raytracer_tpu.core.safemath import safe_norm as jsafe_norm

    assert np.allclose(safe_norm(v).numpy(),
                       np.asarray(jsafe_norm(jnp.asarray(v.numpy()))),
                       rtol=1e-6)


def test_recover_ior_by_gradient_descent():
    true_n = 1.5
    fn, data = differentiable_render(glass_scene(true_n), 4, device=CPU)
    with torch.no_grad():
        target = fn(data)
    n = torch.tensor(1.2, requires_grad=True)
    opt = torch.optim.Adam([n], lr=3e-2)
    for _ in range(60):
        opt.zero_grad()
        n_re = n.expand_as(data.mats.refr_n_re)
        loss = torch.mean((fn(update_materials(data, refr_n_re=n_re))
                           - target) ** 2)
        loss.backward()
        opt.step()
    assert abs(float(n.detach()) - true_n) < 0.03, float(n.detach())


def test_render_fn_is_scene_render_on_the_wavefront():
    # the same chunks, per-pixel sums added in the same order and one
    # division: equal bit for bit (no reordering of float32 sums)
    for spp in (4, 32):
        sc = glass_scene()
        fn, data = differentiable_render(sc, spp, seed=5, device=CPU)
        sc.settings = T.RenderSettings(use_pallas="never")
        want = sc.render(spp, seed=5, output="linear", device=CPU)
        with torch.no_grad():
            got = fn(data).numpy()
        assert np.array_equal(got, want), spp


def test_two_backward_passes_are_bit_equal():
    # two checkpointed chunks: each backward recomputes them
    fn, data = differentiable_render(glass_scene(), 32, device=CPU)
    vg = safe_value_and_grad(lambda n: torch.mean(
        fn(update_materials(data, refr_n_re=n)) ** 2))
    (v1, g1), (v2, g2) = vg(data.mats.refr_n_re), vg(data.mats.refr_n_re)
    assert torch.equal(g1, g2) and torch.equal(v1, v2)


def test_update_lights_replaces_a_light_table():
    sc = glass_scene()
    sc.add_PointLight(pos=T.vec3(0, 1, 1), color=T.rgb(1, 1, 1))
    _, data = differentiable_render(sc, 1, device=CPU)
    c = data.lights.point_color * 2.0
    d = update_lights(data, point_color=c)
    assert d.lights.point_color is c and d.mats is data.mats
    assert d.lights.point_pos is data.lights.point_pos


def test_value_and_grad_of_a_scene_data():
    # a dataclass argument: a gradient for each float table, zeros where
    # the image does not depend on it
    fn, data = differentiable_render(glass_scene(), 2, device=CPU)
    v, g = safe_value_and_grad(lambda d: fn(d).mean())(data)
    assert isinstance(g, type(data))
    assert float(g.mats.emissive_color.abs().sum()) > 0
    assert float(g.lights.point_color.abs().sum()) == 0
    assert torch.equal(g.obj.packed, data.obj.packed)    # not a float table


# ---------------------------------------------------------------------------
# each shading block's per-ray gradient against jax.grad of the JAX block
# ---------------------------------------------------------------------------

BLOCKS = {MAT_EMISSIVE: "emissive", MAT_ENV: "env", MAT_GLOSSY: "glossy",
          MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
          MAT_THINFILM: "thinfilm"}
def bilinear_emitter(m):
    """An emissive sphere filling the view, its colour a smooth 16 x 8
    image (a numpy seed) fetched bilinear at repeat 2: its add depends on
    uv (W6's start hands uv that gradient)."""
    rng = np.random.default_rng(11)
    tex = rng.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=8, screen_height=8, field_of_view=30)
    sc.add(m.Sphere(material=m.Emissive(color=m.image(tex, repeat=2.0,
                                                      filter="bilinear")),
                    center=m.vec3(0, 0, 0), radius=1.0, shadow=False))
    return sc


def env_is_16(m):
    """The sun-and-sky still life, its sky importance-sampled
    (examples/torch_features.py `env_is`), at 16x16."""
    import torch_features
    return torch_features.env_is(16, 16, m=m)


GRAD_CASES = [  # (block, scene, the material table differentiated, *more
    # ray inputs differentiated); the table may be a tuple of tables, each
    # a material table or "lights.<field>" or a field of the scene data
    (MAT_EMISSIVE, glass, "emissive_color"),
    (MAT_EMISSIVE, bilinear_emitter, "emissive_color", "uv"),
    (MAT_GLOSSY, lit_textures, "glossy_n_re"),
    (MAT_DIFFUSE, cornell, "diffuse_color"),
    (MAT_REFRACTIVE, glass, "refr_n_re"),
    (MAT_REFRACTIVE, dispersion, "refr_n_im"),
    (MAT_THINFILM, thin_film_plain, "tf_thickness"),
    # the tables W4's glossy and diffuse backward kernels write rows of: a
    # point and a spot light's colours beside the glossy colour; the
    # importance-sampled caps' centres and radii, with P and eps (the
    # nudged origin the caps' geometry starts from)
    (MAT_GLOSSY, lit_textures,
     ("glossy_color", "lights.point_color", "lights.spot_color")),
    (MAT_DIFFUSE, cornell, ("is_center", "is_radius"), "P", "eps"),
    # the environment's alias tables, gathered through core/safemath.py
    # `take` (core/rng.py)
    (MAT_DIFFUSE, env_is_16, ("env_is_pdf", "env_is_prob")),
    # the colour textures whose taps' rows W4's diffuse and glossy backward
    # and W6's start backward write: lit_textures' nearest checker (the
    # diffuse floor), bilinear wood (the glossy sphere), emissive checker
    # and procedural sky
    (MAT_DIFFUSE, lit_textures, ("textures.0",)),
    (MAT_GLOSSY, lit_textures, ("textures.1", "glossy_color"), "uv"),
    (MAT_EMISSIVE, lit_textures, ("textures.2",)),
    (MAT_ENV, lit_textures, ("textures.3",)),
]
OUTS = ("add", "beta_mult", "new_origin", "new_dir", "new_n_re", "new_n_im")
RAY_INPUTS = ("D", "N", "n_re")


def _case_id(c):
    tables = "" if isinstance(c[2], str) else "-" + "-".join(
        t.split(".")[-1] for t in c[2])
    return f"{BLOCKS[c[0]]}-{c[1].__name__}{tables}"


@pytest.mark.parametrize("case", GRAD_CASES, ids=[_case_id(c) for c in GRAD_CASES])
def test_shading_block_gradient_per_ray(case):
    mt, build, param, *extra = case
    _hold_block_gradient(mt, build, param, extra)


# the refractive block's per-ray gradient with respect to more of its ray
# inputs: t (Beer-Lambert absorption), P and eps (the nudged origin), the
# medium's n_im; (id, scene, the table differentiated, ray inputs, split
# levels: 0 none, else the split patterns' levels).  The glass scene's
# refr_n_im table gradient is ill-conditioned (a sum of large terms near
# total internal reflection): the JAX block's float32 sum is 2% off in one
# channel where the port's float32 agrees with its float64 to 1e-4, so
# that case differentiates refr_n_re (the dispersion case holds refr_n_im)
REFR_GRAD_CASES = [
    ("glass-absorption", glass, "refr_n_re", ("t", "P", "eps", "n_im"), 0),
    ("lights_and_slots-split2", lights_and_slots, "refr_n_re",
     ("t", "P", "eps", "n_im"), 2),
]


@pytest.mark.parametrize("case", REFR_GRAD_CASES, ids=[c[0] for c in REFR_GRAD_CASES])
def test_refractive_block_gradient_per_ray(case):
    """shade_refractive's gradient per ray with respect to D, N, n_re, t,
    P, eps and n_im and a refraction table, against jax.grad of the JAX
    block, at the tolerance of test_shading_block_gradient_per_ray; one
    case without split patterns, one with two levels of them."""
    _, build, param, extra, split = case
    _hold_block_gradient(MAT_REFRACTIVE, build, param, extra, split=split)


def _table(data, path):
    """The table `path` of a SceneData (either package's): a material
    table, "lights.<field>", "geom.<field>", "textures.<k>" or a field of
    the data itself."""
    if "." in path:
        group, field = path.split(".")
        if group == "textures":
            return data.textures[int(field)]
        return getattr(getattr(data, group), field)
    return getattr(data.mats, path) if hasattr(data.mats, path) else getattr(data, path)


def _with_tables(data, values):
    """data with the tables {path: value} replaced."""
    for path, v in values.items():
        if path.startswith("textures."):
            texs = list(data.textures)
            texs[int(path.split(".")[1])] = v
            data = dataclasses.replace(data, textures=tuple(texs))
        elif "." in path:
            group, field = path.split(".")
            data = dataclasses.replace(data, **{group: dataclasses.replace(
                getattr(data, group), **{field: v})})
        elif hasattr(data.mats, path):
            data = dataclasses.replace(data, mats=dataclasses.replace(data.mats, **{path: v}))
        else:
            data = dataclasses.replace(data, **{path: v})
    return data


def _hold_block_gradient(mt, build, param, extra, split=None):
    """Block mt's gradient of a weighted sum of its outputs (weights drawn
    from a numpy seed, on its own rays) with respect to RAY_INPUTS, the ray
    inputs `extra` and the table `param` (or each table of a tuple of
    them, `_table`), the port's plain block against jax.grad of the JAX
    block given the same uniforms (contexts of `build`, `split` levels of
    split patterns unless None): each ray input's gradient within rtol
    1e-3, atol 1e-4 (or both NaN) on >= 99% of the block's rays, each
    extra input's nonzero somewhere there, each table's finite where JAX's
    is and within rtol 2e-3 of it."""
    params = (param,) if isinstance(param, str) else tuple(param)
    inputs = RAY_INPUTS + tuple(extra)
    jctx, tctx, mat_type, hit = contexts(build, split=split)
    name = BLOCKS[mt]
    sel = hit & (mat_type == mt)
    assert sel.sum() >= 20, sel.sum()
    n = sel.shape[0]
    rng = np.random.default_rng(3)
    w = {f: rng.normal(size=(n, 3)).astype(np.float32) for f in OUTS}
    sel3 = sel[:, None].astype(np.float32)

    nt = len(params)

    def jloss(*args):
        rays, ps = args[:len(inputs)], args[len(inputs):]
        data = _with_tables(jctx.data, dict(zip(params, ps)))
        ctx = dataclasses.replace(jctx, **dict(zip(inputs, rays)), data=data)
        out = getattr(jshade, f"shade_{name}")(ctx)
        return sum(jnp.sum(jnp.asarray(getattr(out, f)) * w[f] * sel3)
                   for f in OUTS)

    jg = jax.grad(jloss, argnums=tuple(range(len(inputs) + nt)))(
        *(getattr(jctx, k) for k in inputs), *(_table(jctx.data, t) for t in params))

    leaves = [getattr(tctx, k).clone().requires_grad_(True)
              for k in inputs]
    ps = [_table(tctx.data, t).clone().requires_grad_(True) for t in params]
    ctx = dataclasses.replace(tctx, **dict(zip(inputs, leaves)),
                              data=_with_tables(tctx.data, dict(zip(params, ps))))
    out = getattr(tshade, f"shade_{name}")(ctx, *jax_draws(mt, jctx))
    loss = sum(torch.sum(getattr(out, f) * torch.from_numpy(w[f] * sel3))
               for f in OUTS)
    tg = torch.autograd.grad(loss, leaves + ps, allow_unused=True)
    tg = [torch.zeros_like(x) if g is None else g
          for x, g in zip(leaves + ps, tg)]

    # non-finite exactly where the JAX block's gradient is (Cornell's
    # diffuse table: slot 0 NaN in both, what safe_value_and_grad scrubs)
    ok = np.ones(int(sel.sum()), bool)
    for a, b in zip(tg[:-nt], jg[:-nt]):
        a, b = a.numpy()[sel], np.asarray(b)[sel]
        ok &= np.isclose(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1),
                         rtol=1e-3, atol=1e-4, equal_nan=True).all(axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    for k, g in zip(extra, tg[len(RAY_INPUTS):-nt]):
        assert bool((g[torch.from_numpy(sel)] != 0).any()), k
    for t, a, b in zip(params, tg[-nt:], jg[-nt:]):
        a, b = a.numpy(), np.asarray(b)
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), (t, a, b)
        fin = np.isfinite(b)
        assert np.allclose(a[fin], b[fin], rtol=2e-3,
                           atol=1e-4 * max(1.0, np.abs(b[fin]).max(initial=0))), (t, a, b)


# ---------------------------------------------------------------------------
# a NaN IoR gradient: the JAX package's too
# ---------------------------------------------------------------------------


def primitives_16(m):
    import torch_primitives
    return torch_primitives.primitives(16, 16, m=m)


@pytest.mark.parametrize("scene", [cornell, primitives_16],
                         ids=["cornell", "primitives"])
def test_a_nan_ior_gradient_is_the_jax_packages(scene):
    """Cornell's and the primitives' IoR gradients (16x16 x 2 spp) are not
    finite through the port: the JAX package's (raytracer_tpu/diff.py,
    jax.grad) are not finite in the same entries, and the finite entries
    agree (rtol 1e-3, atol 1e-4).  (The first NaN autograd's anomaly mode
    finds in the port: Cornell's in the update's c.beta * acc.beta_mult,
    ops/bounce_tail.py `plain_update`; the primitives' in a point light's
    dd ** 2, materials/shade.py `shade_glossy`'s spot-light term.)"""
    from raytracer_tpu import diff as jdiff

    fn, data = jdiff.differentiable_render(scene(J), 2, seed=0)
    jg = np.asarray(jax.grad(lambda n: jnp.mean(
        fn(jdiff.update_materials(data, refr_n_re=n)) ** 2))(data.mats.refr_n_re))
    tfn, tdata = differentiable_render(scene(T), 2, seed=0, device=CPU)
    x = tdata.mats.refr_n_re.clone().requires_grad_(True)
    tg, = torch.autograd.grad(
        torch.mean(tfn(update_materials(tdata, refr_n_re=x)) ** 2), x)
    tg = tg.numpy()
    assert not np.isfinite(jg).all()
    assert np.array_equal(np.isfinite(tg), np.isfinite(jg)), (tg, jg)
    fin = np.isfinite(jg)
    assert np.allclose(tg[fin], jg[fin], rtol=1e-3, atol=1e-4), (tg, jg)


COLOUR_TABLES = ("diffuse_color", "glossy_color", "glossy_n_re")


def test_the_primitives_colour_gradient_is_finite_and_matches_fd():
    """The primitives' gradient (16x16 x 2 spp) with respect to
    diffuse_color, glossy_color and glossy_n_re in one backward pass
    (W4's diffuse and glossy blocks' backward on the card): finite in both
    packages (jax.grad of the JAX package's raytracer_tpu/diff.py), and
    the port's within rtol 0.05 of its own central difference at each
    table's largest entry (`_fd_check`)."""
    from raytracer_tpu import diff as jdiff

    fn, data = jdiff.differentiable_render(primitives_16(J), 2, seed=0)
    jg = jax.grad(lambda *xs: jnp.mean(fn(jdiff.update_materials(
        data, **dict(zip(COLOUR_TABLES, xs)))) ** 2), argnums=(0, 1, 2))(
            *(getattr(data.mats, k) for k in COLOUR_TABLES))
    assert all(np.isfinite(np.asarray(g)).all() for g in jg)
    tfn, tdata = differentiable_render(primitives_16(T), 2, seed=0, device=CPU)
    xs = [getattr(tdata.mats, k).clone().requires_grad_(True) for k in COLOUR_TABLES]
    tg = torch.autograd.grad(torch.mean(tfn(update_materials(
        tdata, **dict(zip(COLOUR_TABLES, xs)))) ** 2), xs)
    for k, g in zip(COLOUR_TABLES, tg):
        _fd_check(tfn, tdata, k, g)


# ---------------------------------------------------------------------------
# the gradients of textures and geometry tables, finite in both packages
# ---------------------------------------------------------------------------


def lit_16(m):
    sc = lit_textures(m)
    sc.camera.screen_width = sc.camera.screen_height = 16
    return sc


def sphere_16(m, d):
    import torch_inverse_rendering
    return torch_inverse_rendering.build_scene(1.3, 16, 16, m=m)


def icosphere_16(m, d):
    import torch_inverse_rendering
    return torch_inverse_rendering.build_mesh_scene(1.3, 16, 16, d, subdiv=2, m=m)


def normal_mapped_16(m, d, enclosed=True):
    import torch_features
    return torch_features.normal_mapped(16, 16, m=m, obj_dir=d, enclosed=enclosed)


CORNERS = tuple(f"geom.tri_{k}" for k in ("p1", "p2", "p3", "vn1", "vn2", "vn3"))
# (id, scene, the leaves differentiated, the central difference's eps, the
# leaves held to it); a texture's eps is large where the image is linear
# in a texel (a colour), small where the texel is a normal map's; the
# sphere's radius, the floor's u axis (its extent) and the box's basis move
# silhouettes, which the gradient leaves out by design
# (raytracer_tpu/diff.py:18-22), so they are held for finiteness alone
FINITE_GRADS = [
    ("primitives-floor", lambda m, d: primitives_16(m), ("textures.0",), 0.1,
     ("textures.0",)),
    ("lit_textures", lambda m, d: lit_16(m), tuple(f"textures.{k}" for k in range(4)),
     0.1, tuple(f"textures.{k}" for k in range(4))),
    ("sphere-tables", sphere_16, ("geom.sphere_center", "geom.sphere_radius"), 1e-3,
     ("geom.sphere_center",)),
    ("icosphere-tables", icosphere_16, CORNERS, 1e-3, CORNERS),
    ("normal_mapped-enclosed", normal_mapped_16,
     ("textures.0", "diffuse_color", "geom.plane_u_axis", "geom.box_basis", "geom.tri_tan"),
     1e-3, ("textures.0", "diffuse_color", "geom.tri_tan")),
]


@pytest.mark.parametrize("case", FINITE_GRADS, ids=[c[0] for c in FINITE_GRADS])
def test_a_texture_or_table_gradient_is_finite_in_both_and_matches_fd(case, tmp_path):
    """The gradients that take W4's, W6's and W5's texture taps and table
    rows on the card (16x16 x 2 spp): the primitives' checkered floor (a
    glossy colour texture), every texture of lit_textures, the sphere's
    centres and radii, the icosphere's corners and corner normals, and the
    normal-mapped scene's map, diffuse colours and the tables its maps read
    (the floor's u axis, the box's basis, the mesh's tangents) inside an
    emissive enclosure (no ray misses: object 0, a miss's object, carries
    no map).
    Finite in both packages (jax.grad of raytracer_tpu/diff.py), the
    port's nonzero and within rtol 0.05 of its own central difference at
    each held leaf's largest entry (`_fd_check`)."""
    from raytracer_tpu import diff as jdiff

    _, build, leaves, eps, held = case
    fn, data = jdiff.differentiable_render(build(J, tmp_path), 2, seed=0)
    jg = jax.grad(lambda *xs: jnp.mean(fn(_with_tables(data, dict(zip(leaves, xs)))) ** 2),
                  argnums=tuple(range(len(leaves))))(*(_table(data, k) for k in leaves))
    assert all(np.isfinite(np.asarray(g)).all() for g in jg)
    tfn, tdata = differentiable_render(build(T, tmp_path), 2, seed=0, device=CPU)
    xs = [_table(tdata, k).clone().requires_grad_(True) for k in leaves]
    tg = torch.autograd.grad(torch.mean(tfn(_with_tables(tdata, dict(zip(leaves, xs))))
                                        ** 2), xs)
    for k, g in zip(leaves, tg):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, k
        if k in held:
            _fd_check(tfn, tdata, k, g, eps)


def test_an_open_normal_mapped_gradient_is_nan_as_the_jax_packages(tmp_path):
    """The normal-mapped scene without its enclosure (16x16 x 2 spp): its
    diffuse-colour gradient is not finite through the port, nor through
    the JAX package, in the same entries, and the finite entries agree
    (rtol 1e-3, atol 1e-4): a miss takes object 0's attributes at t =
    10^30, and the diffuse block, run over every ray, hands the colour 0 x
    a non-finite weight there."""
    from raytracer_tpu import diff as jdiff

    fn, data = jdiff.differentiable_render(normal_mapped_16(J, tmp_path, False), 2, seed=0)
    jg = np.asarray(jax.grad(lambda c: jnp.mean(
        fn(jdiff.update_materials(data, diffuse_color=c)) ** 2))(data.mats.diffuse_color))
    tfn, tdata = differentiable_render(normal_mapped_16(T, tmp_path, False), 2, seed=0,
                                       device=CPU)
    x = tdata.mats.diffuse_color.clone().requires_grad_(True)
    tg, = torch.autograd.grad(
        torch.mean(tfn(update_materials(tdata, diffuse_color=x)) ** 2), x)
    tg = tg.numpy()
    assert not np.isfinite(jg).all()
    assert np.array_equal(np.isfinite(tg), np.isfinite(jg)), (tg, jg)
    fin = np.isfinite(jg)
    assert np.allclose(tg[fin], jg[fin], rtol=1e-3, atol=1e-4), (tg, jg)
