"""Normal maps in the port against the JAX package's.

The compile registers each normal map after its material (the texture
order follows), gives spheres, planes and boxes their object id and mesh
faces a uv-aligned tangent, its sign and their map's slot, in leaf order
for clustered and instanced meshes: every table equals the JAX
package's array for array, and so does the static side (the refs, the
gates).  `_apply_normal_maps` is held per ray on the JAX package's own
first hits and tables: measured, the port's normals differ from JAX's by
at most 1.2e-7 (two float32 ulps of a unit vector) on every kind, nearest
and bilinear, so the hold is atol 5e-7 (XLA:CPU contracts the frame's
products into FMA; the port does not).  The port's whole attribute stage
(ops/hit_attrs.py `attributes`: on CPU tensors the plain stage, whose
normal W5 computes on the card) is held against the JAX package's
`hit_attributes`, `_apply_normal_maps` and orientation on the same rays
and nearest hits, nearest and bilinear, every basis kind, repeats other
than 1, instanced meshes, two refs on one object (the last wins) and
misses on a mapped object 0: the shading normal within 1e-5 (measured
7.7e-6 at most, on the bilinear map of quarter steps, 1.2e-6 on the
bumps: XLA:CPU contracts the bilinear weights' products into FMA, and a
step of 0.75 between taps carries that into m, then the frame), the hit
point within 1e-6 and the material word equal.
A miss on a mapped plane (the instance scene's object 0) fetches at a uv
near 1e30, past int32: XLA:CPU's float -> int32 conversion saturates,
torch's on the CPU gives INT_MIN (on the card it saturates), so those
misses take another texel and are held to a unit normal; a miss on the
mapped sphere (the other scenes' object 0) overflows its frame to zero
in both.  Whole renders hold by a z-test over seeds; JSON scenes with a
"normalmap" compile as the JAX package's.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import integrator as jint
from raytracer_tpu.core import ray as jray
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.geometry import attrs as jattrs
from raytracer_tpu.geometry import intersect as jisect
from raytracer_tpu_torch.ops import hit_attrs as tha
from raytracer_tpu_torch.core.compile import compile_wavefront
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.interop import scene_data_from_jax, static_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)
from test_torch_wavefront_render import _z_hold  # noqa: E402
import torch_features  # noqa: E402
import torch_mesh  # noqa: E402


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("nm_obj")


def mapped(m, d, filter="nearest"):
    """examples/torch_features.py normal_mapped at 16x12: a sphere, a
    plane, a box and a 192-face UV-sphere mesh, each normal-mapped."""
    return torch_features.normal_mapped(16, 12, m=m, obj_dir=d, filter=filter)


def instanced(m, d):
    """Three instances of a normal-mapped UV sphere (vt records) beside a
    normal-mapped plane: the tangents rotate into world space
    (examples/torch_features.py `instanced_mapped`)."""
    return torch_features.instanced_mapped(16, 12, m=m, obj_dir=d)


def clustered(m, d):
    """A normal-mapped 2,208-face UV sphere: past the cluster threshold,
    so the tangent rows follow the leaf order."""
    path = d / "uv24x48.obj"
    torch_mesh.write_uv_sphere_obj(path, 24, 48)
    mat = m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.6), diffuse_rays=1)
    mat.set_normalmap(torch_features.bump_normalmap(32), repeat=2.0)
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 3), look_at=m.vec3(0, 0, 0),
                  screen_width=16, screen_height=12)
    sc.add(m.TriangleMesh(str(path), center=m.vec3(0, 0, 0), material=mat,
                          smooth=True))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(3, 3, 3)),
                    center=m.vec3(0, 4, 2), radius=1.0, shadow=False),
           importance_sampled=True)
    return sc


SCENES = [mapped, instanced, clustered]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("build", SCENES, ids=[b.__name__ for b in SCENES])
def test_tables_equal_jax(obj_dir, build):
    j_static, j_data = jax_compile(build(J, obj_dir))
    static, got = compile_wavefront(build(T, obj_dir))
    want = scene_data_from_jax(j_data)
    for f in dataclasses.fields(got.geom):
        _equal(getattr(got.geom, f.name).numpy(),
               getattr(want.geom, f.name).numpy(), f.name)
    assert np.asarray(j_data.geom.tri_tan).shape[0] > 0
    assert len(got.textures) == len(want.textures)
    for a, b in zip(got.textures, want.textures):
        _equal(a.numpy(), b.numpy(), "texture")
    assert static.normal_maps == static_from_jax(j_static).normal_maps
    assert static.needs_uv and j_static.needs_uv
    assert (static.pallas_ok, static.pallas_tex_ok) == (
        j_static.pallas_ok, j_static.pallas_tex_ok) == (False, False)
    assert route(static, T.RenderSettings()) == "wavefront"


def _first_hits(jd, js, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    O = np.tile(np.array([0, 1.2, 4.0], np.float32), (n, 1))
    tgt = rng.uniform([-2.5, -0.8, -2], [2.5, 1.0, 1], (n, 3)).astype(np.float32)
    D = tgt - O
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return jray._first_hit_impl(jnp.asarray(O), jnp.asarray(D), jd, js)


CASES = [(mapped, "nearest"), (mapped, "bilinear"), (instanced, None)]


@pytest.mark.parametrize("build,filt", CASES,
                         ids=["nearest", "bilinear", "instanced"])
def test_apply_normal_maps_per_ray(obj_dir, build, filt):
    sc = (build(J, obj_dir, filter=filt) if filt else build(J, obj_dir))
    js, jd = jax_compile(sc)
    t, orient, P, Ng, uv, obj = _first_hits(jd, js)
    want = np.asarray(jint._apply_normal_maps(Ng, P, uv, obj, jd, js))
    tt = lambda x: torch.from_numpy(np.array(x))
    got = tha._apply_normal_maps(tt(Ng), tt(P), tt(uv),
                                 tt(obj).to(torch.int32),
                                 scene_data_from_jax(jd),
                                 static_from_jax(js)).numpy()
    # the maps move most normals, on every kind that is hit
    moved = np.abs(want - np.asarray(Ng)).max(-1) > 1e-3
    assert moved.mean() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def with_two_refs(js, jd):
    """(static, data) of the JAX package with a second texture (quarter
    steps: texels of 0.5 decode to 0) and three more refs: a box ref
    before the scene's own, a bilinear sphere ref at repeat 3 and a
    bilinear mesh ref on the scene's map slot after theirs; the last
    whose mask holds wins."""
    steps = np.random.default_rng(5).choice(np.float32([0.25, 0.5, 0.75, 1.0]),
                                            (8, 8, 3))
    tex = len(jd.textures)
    jd = dataclasses.replace(jd, textures=(*jd.textures, jnp.asarray(steps)))
    ref = {r.basis_kind: r for r in js.normal_maps}
    again = lambda k, **kw: dataclasses.replace(ref[k], tex=tex, **kw)
    js = dataclasses.replace(js, normal_maps=(
        again("box", repeat=1.0), *js.normal_maps,
        again("sphere", repeat=3.0, bilinear=True),
        again("tri", repeat=0.5, bilinear=True)))
    return js, jd


STAGE_CASES = {"nearest": (mapped, "nearest"), "bilinear": (mapped, "bilinear"),
               "instanced": (instanced, None), "two_refs": (mapped, "nearest")}


def _scene_rays(n=4096, seed=0):
    """(O, D) float32 from around the camera of `mapped` and `instanced`,
    aimed into the scene, some past it (misses)."""
    rng = np.random.default_rng(seed)
    O = (np.array([0, 1.2, 4.0]) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    tgt = rng.uniform([-2.5, -0.8, -2.5], [2.5, 1.4, 1], (n, 3)).astype(np.float32)
    D = tgt - O
    return O, D / np.linalg.norm(D, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_attribute_stage_with_maps_against_jax(obj_dir, one_torch_thread,  # noqa: F811
                                               case):
    build, filt = STAGE_CASES[case]
    js, jd = jax_compile(build(J, obj_dir, filter=filt) if filt else build(J, obj_dir))
    if case == "two_refs":
        js, jd = with_two_refs(js, jd)
    O, D = (jnp.asarray(x) for x in _scene_rays())
    t, orient, obj = jisect.nearest_hit(O, D, jd.geom)
    P = O + D * t[..., None]
    N_geo, uv = jattrs.hit_attributes(P, obj, jd.geom, js)
    want = np.asarray(jint._apply_normal_maps(N_geo, P, uv, obj, jd, js)
                      * orient[..., None])
    tt = lambda x: torch.from_numpy(np.array(np.asarray(x)))
    static, data = static_from_jax(js), scene_data_from_jax(jd)
    got = tha.attributes(tt(O), tt(D), tt(t), tt(orient), tt(obj).long(), data, static,
                         T.RenderSettings())
    ids, miss = np.asarray(obj), np.asarray(t) >= 1e29
    # the rays each ref's mask holds for, and the cases they drive
    tri_off = sum(static.kind_counts[k] for k in static.kind_counts if k != "tri")
    slot = data.geom.tri_nm_slot.numpy()
    masks = np.stack([(ids >= tri_off) & (slot[np.clip(ids - tri_off, 0, len(slot) - 1)]
                                          == r.local_id)
                      if r.basis_kind == "tri" else ids == r.obj
                      for r in static.normal_maps], -1)
    won = {static.normal_maps[i].basis_kind for i in np.flatnonzero(masks[~miss].any(0))}
    assert won == {r.basis_kind for r in static.normal_maps}
    assert 0.2 < miss.mean() < 0.8 and any(r.obj == 0 for r in static.normal_maps)
    if case == "two_refs":
        assert (masks[~miss].sum(-1) >= 2).sum() > 100
    moved = np.abs(want - np.asarray(N_geo * orient[..., None])).max(-1) > 1e-3
    assert moved[~miss].mean() > 0.3
    N = got.N.numpy()
    assert np.array_equal(got.packed.numpy(), np.asarray(
        jnp.take(jd.obj.packed, obj, mode="clip")))
    np.testing.assert_allclose(got.P.numpy(), np.asarray(P), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N[~miss], want[~miss], rtol=0, atol=1e-5)
    if case == "instanced":
        # object 0 is the mapped floor: its misses' uv overflows int32
        assert static.normal_maps[0].obj == 0 and static.normal_maps[0].basis_kind == "plane"
        np.testing.assert_allclose(np.linalg.norm(N[miss], axis=-1), 1.0, atol=1e-6)
    else:
        np.testing.assert_allclose(N[miss], want[miss], rtol=0, atol=1e-5)


@pytest.mark.parametrize("build", [mapped, instanced],
                         ids=["mapped", "instanced"])
def test_statistical_against_jax(obj_dir, build):
    va = [np.asarray(build(J, obj_dir).render(4, seed=s), np.float32).mean()
          / 255 for s in (0, 1, 2)]
    vb = [np.asarray(build(T, obj_dir).render(4, seed=s, device="cpu"),
                     np.float32).mean() / 255 for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_normal_map_changes_the_render(obj_dir):
    """Without its maps the scene renders another image: the maps reach
    the shading."""
    a = mapped(T, obj_dir).render(2, seed=0, device="cpu", output="linear")
    sc = mapped(T, obj_dir)
    for p in sc.scene_primitives:
        p.material.normalmap = None
    b = sc.render(2, seed=0, device="cpu", output="linear")
    assert np.isfinite(a).all() and np.abs(a - b).mean() > 1e-3


def test_json_normalmap_compiles_as_jax(tmp_path):
    from PIL import Image

    nm = (torch_features.bump_normalmap(16) * 255).astype(np.uint8)
    Image.fromarray(nm).save(tmp_path / "bumps.png")
    doc = {"camera": {"look_from": [0, 1, 3], "look_at": [0, 0, 0],
                      "screen_width": 8, "screen_height": 6},
           "objects": [{"type": "plane", "center": [0, -0.5, 0],
                        "width": 4, "height": 4, "u_axis": [1, 0, 0],
                        "v_axis": [0, 0, -1],
                        "material": {"type": "diffuse",
                                     "diff_color": [0.5, 0.5, 0.5],
                                     "normalmap": str(tmp_path / "bumps.png")}},
                       {"type": "sphere", "center": [0, 0.3, 0],
                        "radius": 0.4,
                        "material": {"type": "emissive",
                                     "color": [2, 2, 2]}}]}
    js, jd = jax_compile(J.scene_from_dict(json.loads(json.dumps(doc))))
    static, got = compile_wavefront(T.scene_from_dict(doc))
    assert static.normal_maps == static_from_jax(js).normal_maps
    for a, b in zip(got.textures, scene_data_from_jax(jd).textures):
        _equal(a.numpy(), b.numpy(), "texture")


def test_what_raises_as_jax(obj_dir):
    """Instances that disagree on their map, and a map on a cylinder."""
    for m in (J, T):
        compile_ = jax_compile if m is J else compile_wavefront
        sc = instanced(m, obj_dir)
        grp = sc.scene_primitives[-1]
        other = m.Diffuse(diff_color=m.rgb(1, 1, 1))
        other.set_normalmap(np.full((4, 4, 3), 0.6, np.float32))
        grp.add(translate=(0, 1, 0), material=other)
        with pytest.raises(ValueError, match="share one normal map"):
            compile_(sc)
        sc = mapped(m, obj_dir)
        mat = m.Diffuse(diff_color=m.rgb(1, 1, 1))
        mat.set_normalmap(np.full((4, 4, 3), 0.5, np.float32))
        sc.add(m.Cylinder(material=mat, center=m.vec3(0, 0, -2), radius=0.3,
                          height=0.5))
        with pytest.raises(ValueError, match="not supported on Cylinder"):
            compile_(sc)
