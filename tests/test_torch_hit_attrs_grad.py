"""W5's plain stage gradient against the JAX package's, per ray and per
object kind: the vector-Jacobian product of P = O + D t and the geometric
normal and uv at P (raytracer_tpu/geometry/attrs.py:245 `hit_attributes`)
with respect to O, D and t, the port's from ops/hit_attrs.py
`plain_attrs_vjp` (the VJP W5's backward kernel is held to bit for bit;
unit orientations, no nudge gradient) and the JAX package's from jax.vjp.

Both sides read the JAX compile's tables and the same rays and hits
(tests/test_torch_hit_attrs.py: seeded numpy rays, the JAX package's
nearest hit of each) and the same cotangents, made from a numpy seed.
The scenes: every analytic kind and two triangles, textured; the beach
ball's smooth normals and corner uvs; a group of instances beside a plain
triangle; uv forced.  The tolerance, as the shading blocks' gradients
(tests/test_torch_diff.py): rtol 1e-3, atol 1e-4 on each ray's O, D and
t gradients, on at least 99% of each kind's hits (XLA:CPU contracts a*b+c
into FMA and approximates atan2 and asin, and the box's face choice flips
where two scaled coordinates tie).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.geometry import attrs as jattrs
from raytracer_tpu.geometry import intersect as jisect
from raytracer_tpu_torch.ops import hit_attrs as ha

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hit_attrs import _rays, compiled  # noqa: E402,F401
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)

RATE = 0.99
# each kind's formula in the JAX package, KINDS order
JAX_KINDS = {"sphere": jattrs.sphere_attrs, "plane": jattrs.plane_attrs,
             "box": jattrs.box_attrs, "disc": jattrs.disc_attrs,
             "cyl": jattrs.cylinder_attrs, "tri": jattrs.triangle_attrs}


@pytest.mark.parametrize("name", ["all_kinds", "beach_ball", "instances"])
def test_the_ray_gradient_against_jax(compiled, one_torch_thread, name):  # noqa: F811
    js, jd, ts, td = compiled[name]
    O, D = _rays(8)
    jt, _, jobj = jisect.nearest_hit(jnp.asarray(O), jnp.asarray(D), jd.geom)
    ids, hit = np.asarray(jobj), np.asarray(jt) < 1e29
    tt = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    rng = np.random.default_rng(5)
    off, held = 0, []
    for kind, jfn in JAX_KINDS.items():
        c = ts.kind_counts[kind]
        sel = np.flatnonzero(hit & (ids >= off) & (ids < off + c))
        off += c
        if not c or sel.size <= 10:
            continue
        held.append(kind)
        n = sel.size
        cot = [rng.normal(size=s).astype(np.float32) for s in ((n, 3), (n, 3), (n, 2))]
        local = jnp.asarray(ids[sel] - (off - c))

        # the kind's own formula on its hits (hit_attributes' torch.where
        # merge hands the other kinds' formulas zeros; the JAX package's
        # gradient of those is NaN on most rays of other kinds: 0 x inf
        # where a sphere's clipped asin saturates)
        def jf(O, D, t):
            P = O + D * t[..., None]
            N, uv = jfn(P, local, jd.geom, True)
            return P, N, uv

        args = (jnp.asarray(O[sel]), jnp.asarray(D[sel]), jnp.asarray(jt)[sel])
        _, vjp = jax.vjp(jf, *args)
        want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(x) for x in cot))]
        got = ha.plain_attrs_vjp(
            [torch.from_numpy(x) for x in cot] + [None],
            [tt(a) for a in args] + [torch.ones(n)], tt(ids[sel]).long(), td, ts,
            (1e-6, True, False), (), (), (True,) * 3 + (False,))
        got = [g.numpy() for g in got[:3]]
        ok = np.ones(n, bool)
        for a, b in zip(got, want):
            ok &= np.isclose(a, b, rtol=1e-3, atol=1e-4).reshape(n, -1).all(axis=1)
        assert ok.mean() >= RATE, (kind, ok.mean())
        # the gradient reaches O, D and t on the kind's hits, finite
        assert all(bool((g != 0).any()) and np.isfinite(g).all() for g in got), kind
    assert set(held) >= (set(JAX_KINDS) if name == "all_kinds" else {"tri"}), held


# the geometry tables each kind's formula gathers (a gradient each: W5's
# backward writes their per-ray rows, ops/hit_attrs.py TABLES)
KIND_TABLES = {
    "sphere": ("sphere_center", "sphere_radius"),
    "plane": ("plane_normal", "plane_center", "plane_half_w", "plane_half_h",
              "plane_uv_shift", "plane_u_axis", "plane_v_axis"),
    "box": ("box_basis", "box_whl", "box_center"),
    "disc": ("disc_normal", "disc_center", "disc_r_out", "disc_u_axis", "disc_v_axis"),
    "cyl": ("cyl_axis", "cyl_u_axis", "cyl_v_axis", "cyl_radius", "cyl_half_h",
            "cyl_center"),
    "tri": ("tri_normal", "tri_p1", "tri_p2", "tri_p3", "tri_vn1", "tri_vn2", "tri_vn3",
            "tri_uv1", "tri_uv2", "tri_uv3", "inst_rot", "inst_trans", "inst_inv_scale"),
}


@pytest.mark.parametrize("name", ["all_kinds", "beach_ball", "instances"])
def test_the_table_gradient_against_jax(compiled, one_torch_thread, name):  # noqa: F811
    """The stage's gradient with respect to each kind's geometry tables
    (the spheres' centres and radii, the planes' and discs' axes, the box
    basis, the triangles' corners, corner normals and uvs, the instances'
    transforms), the port's `plain_attrs_vjp` against jax.vjp of the JAX
    kind's formula, on that kind's hits with cotangents from a numpy seed:
    each table's gradient finite where the JAX package's is, within rtol
    2e-3 (atol 1e-4 of its largest), and not zero where JAX's is not."""
    js, jd, ts, td = compiled[name]
    O, D = _rays(9)
    jt, _, jobj = jisect.nearest_hit(jnp.asarray(O), jnp.asarray(D), jd.geom)
    ids, hit = np.asarray(jobj), np.asarray(jt) < 1e29
    tt = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    rng = np.random.default_rng(6)
    off, held = 0, []
    for kind, jfn in JAX_KINDS.items():
        c = ts.kind_counts[kind]
        sel = np.flatnonzero(hit & (ids >= off) & (ids < off + c))
        off += c
        if not c or sel.size <= 10:
            continue
        names = tuple(k for k in KIND_TABLES[kind] if getattr(td.geom, k).shape[0])
        n = sel.size
        cot = [rng.normal(size=s).astype(np.float32) for s in ((n, 3), (n, 3), (n, 2))]
        local = jnp.asarray(ids[sel] - (off - c))
        O_, D_, t_ = (jnp.asarray(a) for a in (O[sel], D[sel], np.asarray(jt)[sel]))

        def jf(*tables):
            geom = dataclasses.replace(jd.geom, **dict(zip(names, tables)))
            P = O_ + D_ * t_[..., None]
            N, uv = jfn(P, local, geom, True)
            return P, N, uv

        _, vjp = jax.vjp(jf, *(getattr(jd.geom, k) for k in names))
        want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(x) for x in cot))]
        got = ha.plain_attrs_vjp(
            [torch.from_numpy(x) for x in cot] + [None],
            [tt(O_), tt(D_), tt(t_), torch.ones(n)]
            + [getattr(td.geom, k) for k in names], tt(ids[sel]).long(), td, ts,
            (1e-6, True, False), names, (), (False,) * 4 + (True,) * len(names))
        for k, a, b in zip(names, got[4:], want):
            a = np.zeros_like(b) if a is None else a.numpy()
            fin = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), fin), (kind, k)
            assert np.allclose(a[fin], b[fin], rtol=2e-3,
                               atol=1e-4 * max(1.0, np.abs(b[fin]).max(initial=0))), (
                kind, k, a, b)
            assert bool((a != 0).any()) == bool((b != 0).any()), (kind, k)
        held.append(kind)
    assert set(held) >= (set(JAX_KINDS) if name == "all_kinds" else {"tri"}), held


def test_the_map_texture_gradient_against_jax(compiled, one_torch_thread):  # noqa: F811
    """The normal-mapped stage's gradient with respect to its maps'
    textures (raytracer_tpu/core/integrator.py:120 `_apply_normal_maps` on
    hit_attributes' normal and uv, then the orientation), the port's
    `plain_attrs_vjp` against jax.vjp of the JAX stage, on the scene's
    hits with a normal's cotangent from a numpy seed: each texture's
    gradient finite where the JAX package's is, within rtol 2e-3 (atol
    1e-4 of its largest) and not zero."""
    from raytracer_tpu.core import integrator as jint

    js, jd, ts, td = compiled["normal_mapped"]
    O, D = _rays(10)
    jt, jo, jobj = jisect.nearest_hit(jnp.asarray(O), jnp.asarray(D), jd.geom)
    hit = np.flatnonzero(np.asarray(jt) < 1e29)
    n = hit.size
    texs = tuple(sorted({r.tex for r in ts.normal_maps}))
    cot = np.random.default_rng(7).normal(size=(n, 3)).astype(np.float32)
    O_, D_, t_, o_, obj = (jnp.asarray(np.asarray(a)[hit])
                           for a in (O, D, jt, jo, jobj))

    def jf(*tx):
        textures = list(jd.textures)
        for k, x in zip(texs, tx):
            textures[k] = x
        d = dataclasses.replace(jd, textures=tuple(textures))
        P = O_ + D_ * t_[..., None]
        N, uv = jattrs.hit_attributes(P, obj, d.geom, js, force_uv=True)
        return jint._apply_normal_maps(N, P, uv, obj, d, js) * o_[..., None]

    _, vjp = jax.vjp(jf, *(jd.textures[k] for k in texs))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    tt = lambda a: torch.from_numpy(np.array(np.asarray(a)))
    got = ha.plain_attrs_vjp(
        [None, torch.from_numpy(cot), None, None],
        [tt(O_), tt(D_), tt(t_), tt(o_)] + [td.textures[k] for k in texs],
        tt(obj).long(), td, ts, (1e-6, True, False), (), texs,
        (False,) * 4 + (True,) * len(texs))
    for k, a, b in zip(texs, got[4:], want):
        a = a.numpy()
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), k
        assert np.allclose(a[fin], b[fin], rtol=2e-3,
                           atol=1e-4 * max(1.0, np.abs(b[fin]).max(initial=0))), (k, a, b)
        assert bool((a != 0).any()), k
