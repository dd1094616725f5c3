"""The wavefront's intersection, hit attributes and depth AOV against the
JAX package's, per ray.

Both sides read the same tables (the JAX compile's, carried over by
`interop.scene_data_from_jax`) and the same rays (random rays through a
scene of every analytic kind, made from a numpy seed).  XLA:CPU contracts
a*b+c into FMA, so a few rays that graze an edge may land on the other
side of it: hit masks and object ids are held at >= 99.9% of rays, and
distances, normals and uvs of the rays both sides agree on to 1e-5
relative (uv 1e-4).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import ray as jray
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.core.integrator import trace_distances as jax_distances
from raytracer_tpu.geometry import attrs as jattrs
from raytracer_tpu.geometry import intersect as jsect
from raytracer_tpu_torch.core.integrator import trace_distances
from raytracer_tpu_torch.geometry import attrs as tattrs
from raytracer_tpu_torch.geometry import intersect as tsect
from raytracer_tpu_torch.interop import static_from_jax, scene_data_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import (grid49, one_torch_thread,  # noqa: E402,F401
                                          tri_scene)

N_RAYS = 4096
RATE = 0.999


def all_kinds(m):
    """Every analytic kind, some rotated: spheres, an axis-aligned and a
    rotated plane, a rotated box, an annulus, a capped and an open
    cylinder, two triangles; textured so that uv is computed."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0.5, 4), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    tex = m.image(np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3))
    mat = m.Diffuse(diff_color=tex)
    sc.add(m.Sphere(material=mat, center=m.vec3(-1.0, 0.2, 0), radius=0.5))
    sc.add(m.Sphere(material=mat, center=m.vec3(1.2, 0.6, -0.5), radius=0.3))
    sc.add(m.Plane(material=mat, center=m.vec3(0, -1, 0), width=6.0, height=5.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   uv_shift=(0.25, 0.1)))
    tilted = m.Plane(material=mat, center=m.vec3(0.3, 0.5, -1.5), width=2.0,
                     height=1.5, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0))
    tilted.rotate(θ=25, u=m.vec3(1, 1, 0))
    sc.add(tilted)
    box = m.Cuboid(material=mat, center=m.vec3(0.2, -0.4, 0.6), width=0.6,
                   height=0.5, length=0.4)
    box.rotate(θ=30, u=m.vec3(0, 1, 0))
    sc.add(box)
    sc.add(m.Disc(material=mat, center=m.vec3(-0.6, -0.2, 1.0), radius=0.4,
                  inner_radius=0.1, normal=m.vec3(0.2, 1, 0.3)))
    sc.add(m.Cylinder(material=mat, center=m.vec3(0.9, -0.3, 0.2), radius=0.25,
                      height=0.7, axis=m.vec3(0.1, 1, 0.2)))
    sc.add(m.Cylinder(material=mat, center=m.vec3(-1.3, -0.4, -0.6), radius=0.2,
                      height=0.6, capped=False))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0.3, -0.5),
                      p1=m.vec3(-0.5, -0.2, -0.4), p2=m.vec3(0.4, 0.0, -0.6),
                      p3=m.vec3(0.0, 0.8, -0.5)))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0.3, -0.5),
                      p1=m.vec3(0.5, 0.9, -1.0), p2=m.vec3(-0.5, 1.0, -0.9),
                      p3=m.vec3(0.0, 0.3, -1.1)))
    return sc


@pytest.fixture(scope="module")
def scene():
    j_static, j_data = jax_compile(all_kinds(J))
    return j_static, j_data, static_from_jax(j_static), scene_data_from_jax(j_data)


def rays(seed=0, n=N_RAYS):
    """Random rays: origins in a box around the scene, aimed at random
    points of the objects' bounding box, a quarter of them anywhere."""
    rng = np.random.default_rng(seed)
    O = rng.uniform([-2, -1.5, -2], [2, 2, 4], (n, 3))
    aim = rng.uniform([-1.5, -1.0, -1.5], [1.5, 1.2, 1.2], (n, 3)) - O
    D = np.where(rng.uniform(size=(n, 1)) < 0.25, rng.normal(size=(n, 3)), aim)
    D = D / np.linalg.norm(D, axis=1, keepdims=True)
    return O.astype(np.float32), D.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _hold_hits(t_got, t_want, o_got=None, o_want=None):
    t_got, t_want = np.asarray(t_got), np.asarray(t_want)
    hit_g, hit_w = t_got < 1e29, t_want < 1e29
    assert (hit_g == hit_w).mean() >= RATE, (hit_g == hit_w).mean()
    both = hit_g & hit_w
    assert both.sum() >= 50
    np.testing.assert_allclose(t_got[both], t_want[both], rtol=1e-5, atol=1e-6)
    if o_got is not None:
        assert (np.asarray(o_got)[both] == np.asarray(o_want)[both]).mean() >= RATE


KIND_FNS = ("spheres", "planes", "boxes", "discs", "cylinders", "triangles")


@pytest.mark.parametrize("kind", KIND_FNS)
def test_intersector_per_ray(scene, kind):
    _, _, _, data = scene
    O, D = rays(1)
    tfn = getattr(tsect, f"intersect_{kind}")
    jfn = getattr(jsect, f"intersect_{kind}")
    tabs = {fn: tb for fn, tb, _ in tsect._type_blocks(data.geom)}[tfn]
    t, o = tfn(_t(O), _t(D), *tabs)
    jt, jo = jfn(jnp.asarray(O), jnp.asarray(D),
                 *[jnp.asarray(x.numpy()) for x in tabs])
    assert t.shape == jt.shape and t.dtype == torch.float32
    _hold_hits(t.numpy(), jt, o.numpy(), jo)


def test_intersect_all_and_nearest_hit(scene):
    _, j_data, _, data = scene
    O, D = rays(2)
    t_all, o_all = tsect.intersect_all(_t(O), _t(D), data.geom)
    jt_all, jo_all = jsect.intersect_all(jnp.asarray(O), jnp.asarray(D), j_data.geom)
    assert t_all.shape == jt_all.shape
    _hold_hits(t_all.numpy(), jt_all, o_all.numpy(), jo_all)

    t, o, obj = tsect.nearest_hit(_t(O), _t(D), data.geom)
    jt, jo, jobj = jsect.nearest_hit(jnp.asarray(O), jnp.asarray(D), j_data.geom)
    _hold_hits(t.numpy(), jt, o.numpy(), jo)
    hit = np.asarray(jt) < 1e29
    assert (obj.numpy()[hit] == np.asarray(jobj)[hit]).mean() >= RATE
    assert hit.mean() > 0.3
    # the nearest hit is the minimum over intersect_all, with its id
    np.testing.assert_array_equal(t.numpy(), t_all.numpy().min(axis=0))


def test_blocked_sweeps_equal_the_unblocked(scene, monkeypatch):
    """Blocks of one object give the same winner, ties included, as one
    block of the whole kind; on the grid of 47 spheres too."""
    for data in (scene[3], scene_data_from_jax(jax_compile(grid49(J))[1])):
        O, D = rays(3, 2048)
        O[:1024] = O[:1024] * 0.2 + np.array([0, 3, 9], np.float32)
        whole = tsect.nearest_hit(_t(O), _t(D), data.geom)
        occ_whole = tsect.occluded(_t(O), _t(D), data.geom, data.obj.shadow,
                                   torch.full((2048,), 5.0))
        monkeypatch.setattr(tsect, "BLOCK_ELEMS", 1)
        assert tsect.object_block(2048) == 1
        blocked = tsect.nearest_hit(_t(O), _t(D), data.geom)
        occ_blocked = tsect.occluded(_t(O), _t(D), data.geom, data.obj.shadow,
                                     torch.full((2048,), 5.0))
        monkeypatch.undo()
        for a, b in zip(whole, blocked):
            assert torch.equal(a, b)
        assert torch.equal(occ_whole, occ_blocked)


def test_occluded_per_ray(scene):
    _, j_data, _, data = scene
    O, D = rays(4)
    max_dist = np.random.default_rng(5).uniform(0.1, 6.0, N_RAYS).astype(np.float32)
    mask = np.random.default_rng(6).uniform(size=data.obj.shadow.shape[0]) < 0.7
    got = tsect.occluded(_t(O), _t(D), data.geom, torch.from_numpy(mask),
                         _t(max_dist))
    want = jsect.occluded(jnp.asarray(O), jnp.asarray(D), j_data.geom,
                          jnp.asarray(mask), jnp.asarray(max_dist))
    assert got.dtype == torch.bool
    assert (got.numpy() == np.asarray(want)).mean() >= RATE
    assert 0.05 < got.numpy().mean() < 0.95


@pytest.mark.parametrize("force_uv", [False, True])
def test_hit_attributes_per_kind(scene, force_uv):
    j_static, j_data, static, data = scene
    O, D = rays(7)
    jt, jo, jobj = jsect.nearest_hit(jnp.asarray(O), jnp.asarray(D), j_data.geom)
    # the same hit points and ids on both sides (the JAX package's)
    P = np.asarray(jnp.asarray(O) + jnp.asarray(D) * jt[..., None])
    hit = np.asarray(jt) < 1e29
    N_g, uv = tattrs.hit_attributes(_t(P), _t(jobj).long(), data.geom, static,
                                    force_uv=force_uv)
    jN, juv = jattrs.hit_attributes(jnp.asarray(P), jobj, j_data.geom, j_static,
                                    force_uv=force_uv)
    np.testing.assert_allclose(N_g.numpy()[hit], np.asarray(jN)[hit],
                               rtol=1e-5, atol=2e-6)
    ids = np.asarray(jobj)
    counts = static.kind_counts
    off = 0
    for kind in ("sphere", "plane", "box", "disc", "cyl", "tri"):
        sel = hit & (ids >= off) & (ids < off + counts[kind])
        off += counts[kind]
        assert sel.sum() > 10, kind
        # uv: atan2 / asin are XLA:CPU approximations, and the box's face
        # choice flips where two scaled coordinates tie
        close = np.isclose(uv.numpy()[sel], np.asarray(juv)[sel], rtol=1e-4,
                           atol=1e-5).all(axis=1)
        assert close.mean() >= 0.995, (kind, close.mean())


def test_first_hit_and_distances_equal_jax():
    sc_t, sc_j = all_kinds(T), all_kinds(J)
    O, D = rays(8, 1024)
    hit = T.first_hit(T.Ray(O, D), sc_t, device="cpu")
    want = jray.first_hit(J.Ray(jnp.asarray(O), jnp.asarray(D)), sc_j)
    _hold_hits(hit.distance.numpy(), want.distance, hit.orientation.numpy(),
               want.orientation)
    both = (hit.distance.numpy() < 1e29) & (np.asarray(want.distance) < 1e29)
    assert (hit.obj_id.numpy()[both] == np.asarray(want.obj_id)[both]).mean() >= RATE
    for f in ("point", "normal"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[both],
                                   np.asarray(getattr(want, f))[both],
                                   rtol=1e-5, atol=2e-5)
    miss = ~(hit.distance.numpy() < 1e29)
    assert (hit.point.numpy()[miss] == 0).all()
    assert hit.get_uv() is hit.uv and hit.get_normal() is hit.normal

    # the depth AOV, module function and integrator
    got = T.get_distances(T.Ray(O, D), sc_t, device="cpu").numpy()
    want = np.asarray(jray.get_distances(J.Ray(jnp.asarray(O), jnp.asarray(D)),
                                         sc_j))
    assert got.shape == want.shape == (1024, 3)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(axis=1)
    assert close.mean() >= RATE
    _, j_data = jax_compile(sc_j)
    got2 = trace_distances(_t(O), _t(D), scene_data_from_jax(j_data), 4.0)
    want2 = jax_distances(jnp.asarray(O), jnp.asarray(D), j_data, 4.0)
    assert (np.isclose(got2.numpy(), np.asarray(want2), rtol=1e-5,
                       atol=1e-6).all(axis=1)).mean() >= RATE


@pytest.mark.parametrize("build", [all_kinds, tri_scene, grid49])
def test_scene_get_distances_matches_jax(build):
    """Scene.get_distances: one jittered sample a pixel, the jitter drawn
    differently on each side, so the images agree away from edges."""
    sc_t, sc_j = build(T), build(J)
    for sc in (sc_t, sc_j):
        sc.camera.screen_width, sc.camera.screen_height = 24, 20
    got = sc_t.get_distances(device="cpu", output="linear")
    img = lambda sc, s, **kw: np.asarray(sc.get_distances(seed=s, **kw),
                                         np.float32) / 255.0
    assert np.abs(img(sc_t, 0, device="cpu") - got).max() <= 1 / 255 + 1e-6
    pil = np.mean([img(sc_t, s, device="cpu") for s in range(3)], axis=0)
    want = np.mean([img(sc_j, s) for s in range(3)], axis=0)
    assert got.shape == want.shape == (20, 24, 3) and got.dtype == np.float32
    # the jitter moves a pixel's sample by up to a pixel, which changes the
    # depth of a receding floor by many steps of 1/255
    assert abs(pil.mean() - want.mean()) < 0.01
    assert np.abs(pil - want).mean() < 0.03
