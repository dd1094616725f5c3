"""The clustered triangle sweep and the mesh hit attributes against the
JAX package's, ray by ray.

The JAX package's own compile of each scene is fed to both sides
(`interop.scene_data_from_jax`), so the sweep alone is held: the nearest
hit of 4,096 seeded rays (a quarter starting inside cluster boxes, a
quarter just off the mesh's surface) within 1e-5 relative in t (relative
to t or to the scene's unit, whichever is larger: a hit a hundredth of a
unit away carries the rounding of coordinates near 1) with the winner
and orientation equal on at least 99.9% of rays (XLA:CPU contracts a*b+c
into FMA, torch does not, so a ray can fall on the other side of an edge
or a box), and `occluded` on shadow rays equal on 99.9%, on a clustered
icosphere, on a group of instances beside a plain triangle and on the
beach ball; then the triangle attributes (smooth normals, interpolated
uvs, instance transforms) within 1e-5 at the same hits.  Within the port:
the clustered sweep against the flat one on the same leaf-ordered
tables (t equal, winners on 99.9%), and the pair cut of
`_cluster_incidences` against sweeping every cluster for every ray.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.geometry import attrs as jattrs
from raytracer_tpu.geometry import intersect as jisect
from raytracer_tpu_torch.geometry import attrs as tattrs
from raytracer_tpu_torch.geometry import intersect as tisect
from raytracer_tpu_torch.interop import scene_data_from_jax, static_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh_compile import (beach_ball, four_instances,  # noqa: E402
                                     icosphere)
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)

N_RAYS = 4096
T_RTOL = 1e-5
RATE = 0.999
ATTR_ATOL = 1e-5
SCENES = {"icosphere": icosphere, "instances": four_instances,
          "beach_ball": beach_ball}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """{name: (JAX static, JAX data, port static, port data)}, compiled
    once."""
    d = tmp_path_factory.mktemp("obj")
    out = {}
    for name, build in SCENES.items():
        js, jd = jax_compile(build(J, d))
        out[name] = (js, jd, static_from_jax(js), scene_data_from_jax(jd))
    return out


def _rays(jd, seed=0):
    """(O, D) float32: rays from around the scene toward its middle, a
    quarter from inside the mesh's cluster boxes, a quarter from just past
    points of its triangles (1e-3 along the ray, as continuations leave a
    surface; from the surface itself, the self-hit at t ~ 1e-7 is
    decided by rounding on both sides)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(jd.geom.tri_cl_lo).min(0)
    hi = np.asarray(jd.geom.tri_cl_hi).max(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    O = (mid + rng.uniform(-3, 3, (N_RAYS, 3)) * half.max()).astype(np.float32)
    q = N_RAYS // 4
    O[:q] = mid + rng.uniform(-1, 1, (q, 3)) * half
    p1 = np.asarray(jd.geom.tri_p1)
    p2 = np.asarray(jd.geom.tri_p2)
    p3 = np.asarray(jd.geom.tri_p3)
    rows = rng.integers(0, p1.shape[0], q)
    w = rng.dirichlet((1, 1, 1), q)
    on = w[:, :1] * p1[rows] + w[:, 1:2] * p2[rows] + w[:, 2:] * p3[rows]
    if np.asarray(jd.geom.inst_rot).shape[0]:
        # surface points of the instances: pushed through a transform
        R, t = np.asarray(jd.geom.inst_rot), np.asarray(jd.geom.inst_trans)
        s = 1.0 / np.asarray(jd.geom.inst_inv_scale)
        k = rng.integers(1, R.shape[0], q)
        on = np.einsum("nij,nj->ni", R[k], s[k, None] * on) + t[k]
    O[q:2 * q] = on
    target = mid + rng.uniform(-1, 1, (N_RAYS, 3)) * half
    D = target - O
    D[np.linalg.norm(D, axis=1) < 1e-3] = (0.3, -1.0, 0.2)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    O[q:2 * q] += 1e-3 * D[q:2 * q]
    return O.astype(np.float32), D.astype(np.float32)


def _both(O, D):
    return (jnp.asarray(O), jnp.asarray(D)), (torch.from_numpy(O),
                                              torch.from_numpy(D))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_hit_against_jax(compiled, name):
    js, jd, ts, td = compiled[name]
    assert np.asarray(jd.geom.tri_cl_lo).shape[0] > 0
    O, D = _rays(jd)
    (jO, jD), (tO, tD) = _both(O, D)
    jt, jo, jid = (np.asarray(x) for x in jisect.nearest_hit(jO, jD, jd.geom))
    tt, to, tid = (x.numpy() for x in tisect.nearest_hit(tO, tD, td.geom))
    hit = jt < 1e29
    assert hit.mean() > 0.5
    same = (jid == tid) & (jo == to)
    assert same.mean() >= RATE, same.mean()
    # where the winner agrees, t within T_RTOL
    assert np.all(np.abs(jt - tt)[same]
                  <= T_RTOL * np.maximum(np.abs(jt), 1.0)[same])
    # the rays that start inside a box agree at the same rate
    assert same[:N_RAYS // 4].mean() >= RATE


@pytest.mark.parametrize("name", sorted(SCENES))
def test_occluded_against_jax(compiled, name):
    js, jd, ts, td = compiled[name]
    O, D = _rays(jd, seed=1)
    rng = np.random.default_rng(2)
    md = np.where(rng.random(N_RAYS) < 0.5, 1e6,
                  rng.uniform(0.05, 4.0, N_RAYS)).astype(np.float32)
    shadow = np.asarray(jd.obj.shadow).copy()
    if name == "instances":
        # a shadow mask that differs between instances (virtual ids)
        shadow[np.arange(shadow.shape[0]) % 3 == 0] = False
    (jO, jD), (tO, tD) = _both(O, D)
    want = np.asarray(jisect.occluded(jO, jD, jd.geom, jnp.asarray(shadow),
                                      jnp.asarray(md)))
    got = tisect.occluded(tO, tD, td.geom, torch.from_numpy(shadow),
                          torch.from_numpy(md)).numpy()
    assert 0.05 < want.mean() < 0.95
    assert (want == got).mean() >= RATE, (want == got).mean()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_triangle_attributes_against_jax(compiled, name):
    """Normals (smooth, instanced) and uvs at the JAX package's own hits:
    the same object ids and points on both sides."""
    js, jd, ts, td = compiled[name]
    O, D = _rays(jd, seed=3)
    jt, _, jid = (np.asarray(x) for x in
                  jisect.nearest_hit(jnp.asarray(O), jnp.asarray(D), jd.geom))
    P = np.where((jt < 1e29)[:, None], O + D * jt[:, None], 0).astype(np.float32)
    tri = jid >= (js.n_objects - js.n_tris)
    assert tri.mean() > 0.2
    jN, juv = jattrs.hit_attributes(jnp.asarray(P), jnp.asarray(jid), jd.geom,
                                    js, force_uv=True)
    tN, tuv = tattrs.hit_attributes(torch.from_numpy(P),
                                    torch.from_numpy(jid.astype(np.int64)),
                                    td.geom, ts, force_uv=True)
    np.testing.assert_allclose(tN.numpy(), np.asarray(jN), rtol=0, atol=ATTR_ATOL)
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=0,
                               atol=ATTR_ATOL)
    if ts.tri_interp:
        # smooth: unit normals that differ from the face normals
        n = np.linalg.norm(tN.numpy()[tri], axis=1)
        assert np.abs(n - 1).max() < 1e-5


def _flat(geom):
    """The same leaf-ordered tables without clusters: the flat sweep."""
    return dataclasses.replace(geom, **{f: getattr(geom, f)[:0] for f in (
        "tri_cl_lo", "tri_cl_hi", "tri_cl_start", "tri_cl_virt")})


def test_clustered_against_flat_in_the_port(compiled):
    js, jd, ts, td = compiled["icosphere"]
    O, D = (torch.from_numpy(a) for a in _rays(jd, seed=4))
    t_c, o_c, id_c = tisect.nearest_hit(O, D, td.geom)
    t_f, o_f, id_f = tisect.nearest_hit(O, D, _flat(td.geom))
    assert torch.equal(t_c, t_f)
    assert ((id_c == id_f) & (o_c == o_f)).float().mean() >= RATE
    md = torch.full((N_RAYS,), 1e6)
    assert torch.equal(tisect.occluded(O, D, td.geom, td.obj.shadow, md),
                       tisect.occluded(O, D, _flat(td.geom), td.obj.shadow, md))


def test_ray_groups_change_nothing(compiled, monkeypatch):
    """Rays swept in groups of whole tiles (a scene with more records
    than one box pass holds) give the answer of one group: a ray's tile,
    and with it the visit order, stays the JAX package's."""
    js, jd, ts, td = compiled["instances"]
    O, D = (torch.from_numpy(a) for a in _rays(jd, seed=6))
    O, D = O.repeat(12, 1), D.repeat(12, 1)      # two tiles of RAY_TILE rays
    md = torch.full((O.shape[0],), 1e6)
    want = (tisect.nearest_hit(O, D, td.geom),
            tisect.occluded(O, D, td.geom, td.obj.shadow, md))
    C = td.geom.tri_cl_lo.shape[0]
    monkeypatch.setattr(tisect, "PAIR_MASK_ELEMS", C * tisect.RAY_TILE)
    assert len(tisect._ray_groups(O.shape[0], C)) == 2
    got = (tisect.nearest_hit(O, D, td.geom),
           tisect.occluded(O, D, td.geom, td.obj.shadow, md))
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])


def test_pair_cut_changes_nothing(compiled, monkeypatch):
    """Sweeping every record for every ray (no box test, no limit) gives
    the answer of the cut pairs: the cut leaves out only pairs that
    cannot win."""
    js, jd, ts, td = compiled["instances"]
    O, D = (torch.from_numpy(a) for a in _rays(jd, seed=5))
    want = tisect.nearest_hit(O, D, td.geom)
    before = dict(tisect.SWEEP_STATS)
    cut_pairs = None
    cut = tisect._cluster_pairs

    def every_pair(O, D, geom, limit, R):
        nonlocal cut_pairs
        sw = cut(O, D, geom, limit, R)
        cut_pairs = sw["rays"].shape[0]
        npad, C = sw["Op"].shape[1], geom.tri_cl_lo.shape[0]
        rec_of_row = torch.argsort(geom.tri_cl_start, stable=True)
        sw["rays"] = torch.arange(npad).repeat(C)
        sw["recs"] = rec_of_row.repeat_interleave(npad)
        groups = []
        for i, start in enumerate(geom.tri_cl_start[rec_of_row].tolist()):
            if groups and groups[-1][0] == start:
                groups[-1][2] += npad
            else:
                groups.append([start, i * npad, (i + 1) * npad])
        sw["groups"] = groups
        return sw

    monkeypatch.setattr(tisect, "_cluster_pairs", every_pair)
    got = tisect.nearest_hit(O, D, td.geom)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    C = td.geom.tri_cl_lo.shape[0]
    assert cut_pairs < C * N_RAYS / 3
    assert tisect.SWEEP_STATS["syncs"] - before["syncs"] == 2


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pair_search_is_the_references_order(compiled, name, monkeypatch):
    """The plain pair search (the order W2 must equal) against the JAX
    package's own selection, tile by tile on the same rays: each tile's
    visit ranks are the places of its clusters in
    jnp.argsort(jnp.min(_cluster_entry(...), axis=1)) (intersect.py:335,
    a stable sort), and the kept pairs are the JAX entry's `< limit`, with
    limits of 0, FARAWAY and 0.5-20 units (some equal to an entry)."""
    js, jd, ts, td = compiled[name]
    O, D = _rays(jd, seed=7)
    rng = np.random.default_rng(8)
    limit = np.where(rng.random(N_RAYS) < 0.4, 1e30,
                     rng.uniform(0.5, 20.0, N_RAYS)).astype(np.float32)
    limit[rng.random(N_RAYS) < 0.1] = 0.0
    monkeypatch.setattr(tisect, "RAY_TILE", 1024)
    C = td.geom.tri_cl_lo.shape[0]
    (_, _, R), = tisect._ray_groups(N_RAYS, C)
    nt = N_RAYS // R
    lo, hi = jd.geom.tri_cl_lo, jd.geom.tri_cl_hi
    entries, ranks = [], []
    for k in range(nt):
        Ot, Dt = (jnp.asarray(a[k * R:(k + 1) * R]) for a in (O, D))
        inv = [jisect._safe_inv(Dt[:, a]) for a in range(3)]
        entry = np.asarray(jisect._cluster_entry(lo, hi, Ot[:, 0], Ot[:, 1],
                                                 Ot[:, 2], *inv))
        order = np.asarray(jnp.argsort(jnp.min(entry, axis=1)))
        rank = np.empty(C, np.int64)
        rank[order] = np.arange(C)
        entries.append(entry)
        ranks.append(rank)
    entry = np.concatenate(entries, axis=1)                     # (C, n)
    # some limits equal an entry: the cut is strict on both sides
    ray = np.arange(0, N_RAYS, 7)
    rec = np.argmin(entry[:, ray], axis=0)
    finite = np.isfinite(entry[rec, ray])
    limit[ray[finite]] = entry[rec[finite], ray[finite]]
    sw = tisect._cluster_pairs(torch.from_numpy(O), torch.from_numpy(D),
                               td.geom, torch.from_numpy(limit), R)
    assert np.array_equal(sw["rank"].numpy(), np.concatenate(ranks))
    keep = np.zeros((C, N_RAYS), bool)
    keep[sw["recs"].numpy(), sw["rays"].numpy()] = True
    assert np.array_equal(keep, entry < limit[None, :])
    assert 0 < keep.sum() < keep.size and finite.sum() > 0
    # ties in some tile's order, which the stable sort breaks by index
    assert any(len(np.unique(e.min(axis=1))) < C for e in entries)
