"""Mesh scenes through Scene.render, `first_hit` and `get_distances`:
the port against the JAX package, and within the port.

Whole renders agree with the JAX package statistically: the two sides
draw their camera jitter from different generators, so the image means
of three seeds are held by a z-test (4 standard errors, floor 0.01 in
mean sRGB, as tests/test_torch_wavefront_render.py holds its scenes), on
a small smooth-shaded mesh (flat sweep), a textured UV sphere and a
group of instances (both clustered).  Within the port, with the same
draws on both sides, instanced copies render as the same copies baked
into TriangleMesh vertices (tests/test_instances.py's criterion: mean
difference under 0.5 of 255, 99.5% of pixel channels within 2), and a
mesh swept in clusters as the same mesh swept flat (at most 1 of 255, as
tests/test_bvh.py holds them).  `first_hit` and `get_distances` on mesh
rays hold ray by ray: object ids equal on 99.9% of rays and, where they
are, distances within 1e-5 relative; points and normals within 1e-5
and uvs within 1e-4 on 99.9% of those rays (the hit points round
differently where XLA:CPU contracts FMA; a smooth normal moves with its
point, and a barycentric uv by the point's error over the face's size,
~0.06 on the 5,120-face icosphere), and all within 1e-3.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import ray as jray
from raytracer_tpu_torch.core import compile as tcompile

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh_compile import four_instances  # noqa: E402
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)
from test_torch_wavefront_render import _z_hold  # noqa: E402
import torch_mesh  # noqa: E402

RATE = 0.999
ATOL = 1e-5


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("obj")


def smooth_ball(m, d):
    """A 320-face smooth icosphere: below the cluster threshold."""
    return torch_mesh.icosphere(16, 12, subdiv=2, m=m, obj_dir=d)


def textured_ball(m, d):
    """A 168-face UV sphere with vt / vn and a bilinear texture: below
    the cluster threshold, so the flat sweep with corner uvs."""
    return torch_mesh.beach_ball(16, 12, n_theta=8, n_phi=12, m=m, obj_dir=d)


def instanced(m, d):
    return four_instances(m, d, count=4, subdiv=2)


STAT = [(smooth_ball, 8), (textured_ball, 8), (instanced, 8)]


def _render(m, build, d, spp, seed, **kw):
    if m is T:
        kw["device"] = "cpu"
    return np.asarray(build(m, d).render(samples_per_pixel=spp, seed=seed, **kw),
                      np.float32) / 255.0


@pytest.mark.parametrize("build,spp", STAT, ids=[b.__name__ for b, _ in STAT])
def test_statistical_against_jax(obj_dir, build, spp):
    va = [_render(J, build, obj_dir, spp, s).mean() for s in (0, 1, 2)]
    vb = [_render(T, build, obj_dir, spp, s).mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_repeats_are_bit_equal_and_finite(obj_dir):
    sc = instanced(T, obj_dir)
    a = sc.render(2, seed=4, output="linear", device="cpu")
    b = sc.render(2, seed=4, output="linear", device="cpu")
    assert np.array_equal(a, b) and np.isfinite(a).all() and a.mean() > 0


def test_instanced_against_baked(obj_dir):
    """The field of examples/example_instances.py, 6 instances of a
    320-face icosphere, against the same copies baked on the host."""
    kw = dict(width=32, height=24, count=6, subdiv=2, obj_dir=obj_dir)
    a = np.asarray(torch_mesh.instances(**kw).render(4, seed=3, device="cpu"),
                   np.float64)
    b = np.asarray(torch_mesh.instances(baked=True, **kw).render(
        4, seed=3, device="cpu"), np.float64)
    d = np.abs(a - b)
    assert d.mean() < 0.5, d.mean()
    assert (d <= 2).mean() > 0.995, (d <= 2).mean()


def test_clustered_against_flat_render(obj_dir, monkeypatch):
    """One emissive mesh swept flat and in clusters (the threshold moved,
    as tests/test_bvh.py moves the JAX package's)."""
    path = obj_dir / "ico3.obj"
    torch_mesh.write_icosphere_obj(path, 3)

    def build():
        sc = T.Scene()
        sc.add_Camera(look_from=T.vec3(0, 0, 3), look_at=T.vec3(0, 0, 0),
                      screen_width=16, screen_height=16, field_of_view=45)
        sc.add(T.TriangleMesh(str(path), center=T.vec3(0, 0, 0),
                              material=T.Emissive(color=T.rgb(0.2, 0.9, 0.3))))
        return sc

    monkeypatch.setattr(tcompile, "TRI_CLUSTER_THRESHOLD", 10 ** 9)
    _, data = tcompile.compile_wavefront(build())
    assert data.geom.tri_cl_lo.shape[0] == 0
    flat = np.asarray(build().render(2, seed=5, device="cpu"), np.float32)
    monkeypatch.setattr(tcompile, "TRI_CLUSTER_THRESHOLD", 32)
    _, data = tcompile.compile_wavefront(build())
    assert data.geom.tri_cl_lo.shape[0] == 5
    cl = np.asarray(build().render(2, seed=5, device="cpu"), np.float32)
    assert np.abs(cl - flat).max() <= 1.0


def _mesh_rays(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    O = np.tile(np.array([0.0, 0.6, 4.6], np.float32), (n, 1))
    target = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    D = target - O
    return O, (D / np.linalg.norm(D, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["icosphere", "instanced"])
def test_first_hit_and_distances_against_jax(obj_dir, name):
    build = (lambda m: torch_mesh.icosphere(16, 12, m=m, obj_dir=obj_dir)
             if name == "icosphere" else instanced(m, obj_dir))
    O, D = _mesh_rays()
    want = J.first_hit(J.Ray(origin=O, dir=D), build(J))
    got = T.first_hit(T.Ray(origin=O, dir=D), build(T), device="cpu")
    same = np.asarray(want.obj_id) == got.obj_id.numpy()
    assert same.mean() >= RATE and np.asarray(want.distance < 1e29).mean() > 0.3
    np.testing.assert_allclose(got.distance.numpy()[same],
                               np.asarray(want.distance)[same], rtol=ATOL)
    for f, atol in (("normal", ATOL), ("uv", 10 * ATOL), ("point", ATOL)):
        err = np.abs(getattr(got, f).numpy()
                     - np.asarray(getattr(want, f)))[same].max(axis=1)
        assert (err <= atol).mean() >= RATE and err.max() <= 1e-3, f
    d_j = np.asarray(jray.get_distances(jray.Ray(origin=O, dir=D), build(J)))
    d_t = T.get_distances(T.Ray(origin=O, dir=D), build(T), device="cpu").numpy()
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=ATOL)


def test_virtual_ids_and_per_instance_materials(obj_dir):
    """first_hit gives each instance its own object ids, and each
    instance's material shades it (tests/test_instances.py:114)."""
    path = obj_dir / "ico0.obj"
    torch_mesh.write_icosphere_obj(path, 0)
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 3), look_at=T.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    grp = T.MeshInstances(T.TriangleMesh(str(path), center=T.vec3(0, 0, 0),
                                         material=T.Emissive(color=T.rgb(1, 0, 0))))
    grp.add(translate=(-2, 0, 0))
    grp.add(translate=(2, 0, 0), material=T.Emissive(color=T.rgb(0, 1, 0)))
    sc.add(grp)
    O = np.array([[-2.0, 0, 3], [2.0, 0, 3]], np.float32)
    D = np.array([[0.0, 0, -1]] * 2, np.float32)
    hit = T.first_hit(T.Ray(origin=O, dir=D), sc, device="cpu")
    obj = hit.obj_id.numpy()
    assert (hit.distance.numpy() < 1e30).all()
    assert 0 <= obj[0] < 20 <= obj[1] < 40
    img = np.asarray(sc.render(1, seed=0, device="cpu"), float)
    left, right = img[:, :4], img[:, 4:]
    assert left[..., 0].max() > 100 > left[..., 1].max()
    assert right[..., 1].max() > 100 > right[..., 0].max()
