"""Meshes in the port's scene compiler against the JAX package's.

The port parses OBJ files and builds the binned-SAH leaf order with its
own copy of the JAX package's C++ source (raytracer_tpu_torch/native.py,
csrc/mesh.cpp): the parser must give the JAX parser's arrays exactly, and
the leaf order must be the JAX build's, or every cluster table would
differ.  Then the compile: on a clustered icosphere, a UV sphere with
corner normals and uvs, a group of four instances (one with its own
material) beside a plain triangle, and flat 20-face meshes inside the
kernels' gates, every wavefront table equals the JAX package's array for
array (integers exactly, floats bit for bit), the static side agrees and
so do both gates; the flat meshes' kernel tables too.  Also JSON mesh
scenes, the routing of mesh scenes, and what still raises.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu import native as jnative
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch import native
from raytracer_tpu_torch.core.compile import compile_scene, compile_wavefront
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.geometry.primitive import _parse_obj_full
from raytracer_tpu_torch.interop import scene_data_from_jax, tables_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)
import torch_mesh  # noqa: E402


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("obj")


def _glossy(m, color):
    return m.Glossy(diff_color=m.rgb(*color), n=m.vec3(1.3 + 0j, 1.3 + 0j, 1.3 + 0j),
                    roughness=0.3, spec_coeff=0.2, diff_coeff=0.9)


def icosphere(m, d):
    """examples/example_mesh.py at 16x12: 5,120 faces in 20 clusters."""
    return torch_mesh.icosphere(16, 12, m=m, obj_dir=d)


def beach_ball(m, d):
    """examples/example_mesh_textured.py at 16x12: vt / vn records."""
    return torch_mesh.beach_ball(16, 12, m=m, obj_dir=d)


def four_instances(m, d, count=4, subdiv=2):
    """`count` instances of a 320-face icosphere, the third with its own
    material, beside a plain triangle (region 0) on a glossy floor."""
    path = d / f"ico{subdiv}.obj"
    torch_mesh.write_icosphere_obj(path, subdiv=subdiv)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.5, 3), look_at=m.vec3(0, 0, -1),
                  screen_width=16, screen_height=12)
    sc.add_DirectionalLight(Ldir=m.vec3(1, 1, 1), color=m.rgb(1, 1, 1))
    sc.add(m.Plane(material=_glossy(m, (0.4, 0.4, 0.4)),
                   center=m.vec3(0, -1.0, -3), width=20, height=20,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    red, blue = _glossy(m, (0.8, 0.3, 0.2)), _glossy(m, (0.2, 0.4, 0.9))
    grp = m.MeshInstances(m.TriangleMesh(str(path), center=m.vec3(0, 0, -2),
                                         material=red, smooth=True))
    for i in range(count):
        grp.add(translate=(-1.5 + i, 0.2 * i, -0.5 * i), theta=25.0 * i,
                axis=(0, 1, 0.3), scale=0.4 + 0.15 * i,
                material=blue if i == 2 else None)
    sc.add(grp)
    sc.add(m.Triangle(material=red, center=m.vec3(0, 0, -4),
                      p1=m.vec3(-1, 0, -4), p2=m.vec3(1, 0, -4),
                      p3=m.vec3(0, 1, -4.5)))
    return sc


def flat20(m, d):
    """A 20-face flat icosahedron, a floor and a sky: 22 objects, inside
    the solid kernel's gate."""
    return torch_mesh.icosphere(16, 12, subdiv=0, smooth=None, m=m, obj_dir=d)


def flat20_textured(m, d):
    """The same with an image texture on the mesh (barycentric uvs): the
    record kernel's gate."""
    sc = flat20(m, d)
    mesh = sc.scene_primitives[0]
    tex = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    mesh.material = m.Glossy(diff_color=m.image(tex), n=m.vec3(1.3, 1.3, 1.3),
                             roughness=0.2, spec_coeff=0.3, diff_coeff=0.8)
    return sc


SCENES = [icosphere, beach_ball, four_instances, flat20, flat20_textured]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


# ---------------------------------------------------------------------------
# the native library: OBJ parsing and the leaf order
# ---------------------------------------------------------------------------


def _obj_files(d):
    """The three examples' OBJ files and three edge cases."""
    files = {}
    for name, write in (("ico4", lambda p: torch_mesh.write_icosphere_obj(p, 4)),
                        ("ico3", lambda p: torch_mesh.write_icosphere_obj(p, 3)),
                        ("uv_sphere", torch_mesh.write_uv_sphere_obj)):
        files[name] = d / f"{name}.obj"
        write(files[name])
    # quads with negative (relative) indices and mixed corner records
    files["quads_negative"] = d / "quads.obj"
    files["quads_negative"].write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nf -4/-4/-1 -3/-3/-1 -2/-2/-1 -1/-1/-1\n"
        "v 0 0 1\nv 1 0 1\nv 1 1 1\nv 0 1 1\nf -4//-1 -3//-1 -2//-1 -1//-1\n")
    # vt on some corners only
    files["missing_vt"] = d / "missing_vt.obj"
    files["missing_vt"].write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0.5 0.5\nvt 0.25 0.75\n"
        "f 1/1 2 3/2\nf 2 4 3\n")
    # one face line of 200 corners, then the same with vt / vn indices
    n = 200
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    lines = [f"v {np.cos(a):.9f} {np.sin(a):.9f} 0.000000000" for a in ang]
    lines += [f"vt {0.5 + np.cos(a) / 2:.6f} {0.5 + np.sin(a) / 2:.6f}"
              for a in ang] + ["vn 0 0 1"]
    lines.append("f " + " ".join(str(i + 1) for i in range(n)))
    lines.append("f " + " ".join(f"{i + 1}/{i + 1}/1" for i in range(n)))
    files["long_face"] = d / "long_face.obj"
    files["long_face"].write_text("\n".join(lines) + "\n")
    return files


OBJS = ["ico4", "ico3", "uv_sphere", "quads_negative", "missing_vt", "long_face"]


@pytest.mark.parametrize("name", OBJS)
def test_obj_parser_equals_jax(obj_dir, name):
    """The native parser against the JAX package's native parser, and the
    plain Python parser against both: array-equal."""
    path = _obj_files(obj_dir)[name]
    assert jnative.available()
    got = native.parse_obj_full(path)
    want = jnative.parse_obj_full(path)
    plain = _parse_obj_full(path)
    assert len(got) == len(want) == 6
    for i, (a, b, c) in enumerate(zip(got, want, plain)):
        _equal(a, b, f"array {i}")
        _equal(a, c, f"plain array {i}")
    if name == "long_face":
        assert got[3].shape == (2 * 198, 3)
    if name == "quads_negative":
        assert got[3].tolist() == [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]]
        assert (got[4][2:] == -1).all() and (got[5] == 0).all()
    if name == "missing_vt":
        assert got[4].tolist() == [[0, -1, 1], [-1, -1, -1]]


def test_missing_obj_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_obj_full(tmp_path / "none.obj")


@pytest.mark.parametrize("subdiv", [3, 4], ids=["1280_faces", "5120_faces"])
def test_leaf_order_equals_jax(obj_dir, subdiv):
    """bvh_build's leaf order on the icospheres' float32 vertices equals
    the JAX package's native build (not its median-split fallback)."""
    path = obj_dir / f"leaf{subdiv}.obj"
    torch_mesh.write_icosphere_obj(path, subdiv)
    mesh = T.TriangleMesh(str(path), center=T.vec3(0, 0, 0),
                          material=T.Emissive(color=T.rgb(1, 1, 1)))
    tv = np.asarray(mesh.triangles, np.float32)
    assert jnative.available() and jnative._lib is not None
    got, want = native.build_bvh(tv), jnative.build_bvh(tv)
    assert len(got["order"]) == 20 * 4 ** subdiv
    for k in want:
        _equal(got[k], want[k], k)
    assert not np.array_equal(got["order"], jnative._py_build_bvh(tv)["order"])


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source that does not build raises."""
    bad = tmp_path / "mesh.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_bvh(np.zeros((2, 3, 3), np.float32))


# ---------------------------------------------------------------------------
# the compile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", SCENES, ids=[b.__name__ for b in SCENES])
def test_mesh_tables_equal_jax(obj_dir, build):
    j_static, j_data = jax_compile(build(J, obj_dir))
    static, got = compile_wavefront(build(T, obj_dir))
    want = scene_data_from_jax(j_data)
    for grp in ("geom", "obj", "mats", "lights"):
        for f in dataclasses.fields(getattr(got, grp)):
            _equal(getattr(getattr(got, grp), f.name).numpy(),
                   getattr(getattr(want, grp), f.name).numpy(), f"{grp}.{f.name}")
    for a, b in zip(got.textures, want.textures):
        _equal(a.numpy(), b.numpy(), "texture")
    assert static.n_objects == j_static.n_objects
    assert static.n_tris == j_static.n_tris
    assert static.tri_interp == j_static.tri_interp
    assert static.needs_uv == j_static.needs_uv
    assert static.mat_types_present == j_static.mat_types_present
    assert static.kind_counts == dict(
        sphere=j_static.n_spheres, plane=j_static.n_planes,
        box=j_static.n_boxes, disc=j_static.n_discs,
        cyl=j_static.n_cylinders, tri=j_static.n_tris)
    assert (static.pallas_ok, static.pallas_tex_ok) == (j_static.pallas_ok,
                                                        j_static.pallas_tex_ok)
    # the kernels' tables and records, whichever route the scene takes
    k_static, k_tables = compile_scene(build(T, obj_dir))
    j_kstatic, j_tables = tables_from_jax(j_static, j_data)
    assert k_static == j_kstatic
    for name in k_tables.TENSORS:
        a, b = getattr(k_tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_mesh_layouts(obj_dir):
    """What each scene compiles to: clusters, corner attributes, virtual
    ids and routes."""
    cases = {icosphere: (20, True, 5120, "wavefront"),
             beach_ball: (5, True, 1224, "wavefront"),
             four_instances: (1 + 4 * 2, True, 1 + 4 * 320, "wavefront"),
             flat20: (0, False, 20, "solid"),
             flat20_textured: (0, False, 20, "record")}
    for build, (clusters, interp, n_tris, path) in cases.items():
        sc = build(T, obj_dir)
        static, _, settings = sc._settings_for_render()
        _, data = compile_wavefront(sc)
        assert data.geom.tri_cl_lo.shape[0] == clusters, build.__name__
        assert static.tri_interp == interp and static.n_tris == n_tris
        assert route(static, settings) == path, build.__name__
    data = compile_wavefront(four_instances(T, obj_dir))[1]
    # instance 0 is the identity of region 0; rows padded to clusters
    assert data.geom.inst_rot.shape[0] == 5
    assert torch.equal(data.geom.inst_rot[0], torch.eye(3))
    assert data.geom.tri_p1.shape[0] == 256 + 2 * 256
    assert data.obj.packed.shape[0] == 1 + 1 + 4 * 320   # plane, triangle


def test_instanced_routes_and_always_raises(obj_dir):
    sc = four_instances(T, obj_dir)
    static, _, settings = sc._settings_for_render()
    assert not (static.pallas_ok or static.pallas_tex_ok)
    assert route(static, settings) == "wavefront"
    sc.settings = T.RenderSettings(use_pallas="always")
    with pytest.raises(ValueError, match="outside both kernels' gates"):
        sc.render(1, device="cpu")
    sc = flat20(T, obj_dir)
    sc.settings = T.RenderSettings(use_pallas="never")
    assert route(*sc._settings_for_render()[::2]) == "wavefront"


def test_what_still_raises(obj_dir):
    """A normal map on a mesh without vt records, an empty group and a
    non-mesh group raise as in the JAX package."""
    path = obj_dir / "ico0.obj"
    torch_mesh.write_icosphere_obj(path, 0)
    for m in (J, T):
        sc = m.Scene()
        sc.add_Camera(look_from=m.vec3(0, 0, 3), look_at=m.vec3(0, 0, 0),
                      screen_width=4, screen_height=4)
        sc.add(m.TriangleMesh(str(path), center=m.vec3(0, 0, 0),
                              material=m.Glossy(
                                  diff_color=m.rgb(1, 1, 1),
                                  n=m.vec3(1.5, 1.5, 1.5), roughness=0.1,
                                  spec_coeff=0.2, diff_coeff=0.8,
                                  normalmap=np.zeros((4, 4, 3), np.float32))))
        with pytest.raises(ValueError, match="needs vt texture coordinates"):
            (jax_compile if m is J else compile_scene)(sc)
    mesh = T.TriangleMesh(str(path), center=T.vec3(0, 0, 0),
                          material=T.Emissive(color=T.rgb(1, 1, 1)))
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 3), look_at=T.vec3(0, 0, 0),
                  screen_width=4, screen_height=4)
    sc.add(T.MeshInstances(mesh))
    with pytest.raises(ValueError, match="no instances"):
        compile_scene(sc)
    with pytest.raises(TypeError, match="wraps a TriangleMesh"):
        T.MeshInstances(T.Sphere(material=mesh.material,
                                 center=T.vec3(0, 0, 0), radius=1.0))
    with pytest.raises(ValueError, match="scale must be > 0"):
        T.MeshInstances(mesh).add(scale=0.0)


def test_mesh_primitives_equal_jax(obj_dir):
    """TriangleMesh's vertices, corner normals and uvs (smooth None / True
    / False, rotation) and MeshInstances' transforms and bounds."""
    path = obj_dir / "uv.obj"
    torch_mesh.write_uv_sphere_obj(path, 6, 8)
    for smooth in (None, True, False):
        a, b = (m.TriangleMesh(str(path), center=m.vec3(0.5, 0, -1),
                               material=m.Emissive(color=m.rgb(1, 1, 1)),
                               scale=1.5, smooth=smooth) for m in (T, J))
        a.rotate(θ=30, u=T.vec3(1, 1, 0))
        b.rotate(θ=30, u=J.vec3(1, 1, 0))
        for f in ("vertices", "faces", "corner_normals", "corner_uvs"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (smooth, f)
            if x is not None:
                _equal(x, y, f)
        assert a.bounded_sphere_radius == b.bounded_sphere_radius
    ga, gb = T.MeshInstances(a), J.MeshInstances(b)
    for g in (ga, gb):
        g.add(translate=(1, 2, 3), theta=40, axis=(0, 1, 0), scale=0.5)
        g.add(rotation=np.eye(3)[[1, 0, 2]] * [1, 1, -1], scale=2.0)
    for (Ra, ta, sa, _), (Rb, tb, sb, _) in zip(ga.instances, gb.instances):
        _equal(Ra, Rb, "R")
        _equal(ta, tb, "t")
        assert sa == sb
    _equal(ga.center, gb.center, "center")
    assert ga.bounded_sphere_radius == gb.bounded_sphere_radius
    assert T.Surface is T.Primitive


# ---------------------------------------------------------------------------
# JSON scenes with meshes
# ---------------------------------------------------------------------------


def test_json_mesh_scene_round_trips(obj_dir):
    path = obj_dir / "json_ico.obj"
    torch_mesh.write_icosphere_obj(path, 2)
    doc = {
        "camera": {"look_from": [0, 0, 3], "look_at": [0, 0, 0], "width": 16,
                   "height": 12, "field_of_view": 60},
        "lights": [{"type": "directional", "Ldir": [0.3, 1, 0.2],
                    "color": [1, 1, 1]}],
        "objects": [
            {"type": "mesh", "filename": str(path), "center": [0, 0.2, -0.5],
             "scale": 0.8, "smooth": True, "max_ray_depth": 2,
             "rotate": [{"theta": 30, "axis": [0, 1, 0]}],
             "material": {"type": "glossy", "diff_color": [0.7, 0.4, 0.2],
                          "n": [1.5, 0], "roughness": 0.2, "spec_coeff": 0.3,
                          "diff_coeff": 0.8}},
            {"type": "sphere", "center": [0, 0, 0], "radius": 30,
             "shadow": False, "material": {"type": "emissive",
                                           "color": [0.8, 0.9, 1.0]}}]}
    port, ref = T.scene_from_dict(doc), J.scene_from_dict(doc)
    out = T.scene_to_dict(port)
    assert out == J.scene_to_dict(ref)
    assert out["objects"][0]["type"] == "mesh" and out["objects"][0]["smooth"]
    again = T.scene_from_dict(out)
    a, b = compile_wavefront(port)[1], compile_wavefront(again)[1]
    want = scene_data_from_jax(jax_compile(ref)[1])
    for f in dataclasses.fields(a.geom):
        _equal(getattr(a.geom, f.name).numpy(), getattr(b.geom, f.name).numpy(),
               f.name)
        _equal(getattr(a.geom, f.name).numpy(),
               getattr(want.geom, f.name).numpy(), f.name)
