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
