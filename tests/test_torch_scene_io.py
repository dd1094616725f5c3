"""The port's JSON scenes (scene_io.py) against the JAX package's.

Each document is built by both packages' `scene_from_dict`; the compiled
tables must be equal bit for bit (the port's against `tables_from_jax` of
the JAX package's), and `scene_to_dict` must give the same dict.  The
texture files are written into tmp_path, as tests/test_scene_io.py does.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch.core.compile import compile_scene
from raytracer_tpu_torch.interop import tables_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import jax_native  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "example_scene.json"

MINIMAL = {
    "camera": {"look_from": [0, 0, 1], "look_at": [0, 0, -1],
               "width": 24, "height": 16},
    "objects": [
        {"type": "sphere", "center": [0, 0, -3], "radius": 1.2,
         "material": {"type": "emissive", "color": [1.0, 0.6, 0.3]}}
    ],
}

LIGHTS_AND_ROTATION = {
    "camera": {"look_from": [0, 0.4, 1.2], "look_at": [0, 0, -2],
               "width": 32, "height": 24, "field_of_view": 70},
    "ambient_color": [0.02, 0.02, 0.02],
    "n": 1.0,
    "lights": [
        {"type": "directional", "Ldir": [0.4, 0.6, -0.4],
         "color": [0.2, 0.2, 0.2]},
        {"type": "point", "pos": [0, 2, -1], "color": [0.5, 0.5, 0.5]},
        {"type": "spot", "pos": [1, 2, -1], "direction": [-0.4, -1, -0.4],
         "color": [0.1, 0.1, 0.1], "angle": 25},
    ],
    "objects": [
        {"type": "plane", "center": [0, -0.5, -3], "width": 20,
         "height": 20, "u_axis": [1, 0, 0], "v_axis": [0, 0, -1],
         "material": {"type": "glossy", "diff_color": [0.8, 0.8, 0.8],
                      "n": [1.5, 0.1], "roughness": 0.2,
                      "spec_coeff": 0.2, "diff_coeff": 0.8}},
        {"type": "sphere", "center": [0, 0, -2], "radius": 0.5,
         "max_ray_depth": 3, "importance_sampled": True,
         "material": {"type": "refractive",
                      "n": [[1.5, 0], [1.51, 0], [1.52, 0]]}},
        {"type": "cuboid", "center": [1.2, -0.2, -2.5], "width": 0.5,
         "height": 0.5, "length": 0.5,
         "rotate": {"theta": 0.6, "axis": [0, 1, 0]},
         "material": {"type": "diffuse", "diff_color": [0.3, 0.5, 0.9],
                      "diffuse_rays": 4}},
    ],
}


def _png(path, shape=(4, 4, 3), value=255):
    import PIL.Image

    a = np.zeros(shape, np.uint8)
    a[::2, ::2] = value
    PIL.Image.fromarray(a).save(path)
    return str(path)


def _documents(tmp_path):
    tex = _png(tmp_path / "t.png")
    sky = tmp_path / "sky_pan.png"
    import PIL.Image
    a = np.zeros((8, 16, 3), np.uint8)
    a[:4], a[4:] = (40, 80, 200), (60, 50, 40)
    PIL.Image.fromarray(a).save(sky)
    textured = copy.deepcopy(MINIMAL)
    textured["objects"] = [
        {"type": "sphere", "center": [0, 0, -3], "radius": 1.2,
         "material": {"type": "diffuse",
                      "diff_color": {"image": tex, "repeat": 2.0,
                                     "filter": "bilinear"}}}]
    shapes = copy.deepcopy(MINIMAL)
    shapes["n"] = [[1.0, 0.0], [1.0, 0.0], [1.1, 0.0]]
    shapes["objects"] += [
        {"type": "disc", "center": [0, 1, -2], "radius": 0.8,
         "inner_radius": 0.3, "normal": [0, 0, 1], "u_axis": [1, 1, 0],
         "material": {"type": "glossy", "diff_color": [0.9, 0.7, 0.3],
                      "n": [[0.2, 3.0], [0.4, 2.4], [1.5, 1.9]],
                      "roughness": 0.1, "spec_coeff": 0.5,
                      "diff_coeff": 0.5}},
        {"type": "cylinder", "center": [0, 0, -2], "radius": 0.3,
         "height": 1.0, "axis": [0, 1, 0.2], "capped": False,
         "material": {"type": "thinfilm", "thickness": 360, "noise": 0.2}},
        {"type": "triangle", "center": [0, 0, -4], "p1": [-1, 0, -4],
         "p2": [1, 0, -4], "p3": [0, 1, -4], "mc": True, "shadow": False,
         "rotate": [{"theta": 20, "axis": [0, 0, 1]},
                    {"theta": 10, "axis": [1, 0, 0]}],
         "material": {"type": "refractive", "n": 1.4, "dispersion": True}}]
    return {
        "minimal": MINIMAL,
        "lights_and_rotation": LIGHTS_AND_ROTATION,
        "texture": textured,
        "shapes": shapes,
        "background": {**MINIMAL, "background": {
            "image": str(sky), "spherical": True, "blur": 1.0,
            "light_intensity": 0.5}},
        "example_scene": json.loads(EXAMPLE.read_text()),
    }


def _assert_same_compile(port, ref):
    static, tables = compile_scene(port)
    j_static, j_tables = tables_from_jax(*jax_compile(ref))
    assert static == j_static
    for name in tables.TENSORS:
        a, b = getattr(tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


DOCS = ["minimal", "lights_and_rotation", "texture", "shapes", "background",
        "example_scene"]


@pytest.mark.parametrize("name", DOCS)
def test_scene_from_dict_compiles_as_jax(tmp_path, name):
    doc = _documents(tmp_path)[name]
    port, ref = T.scene_from_dict(doc), J.scene_from_dict(doc)
    assert len(port.scene_primitives) == len(ref.scene_primitives)
    assert len(port.Light_list) == len(ref.Light_list)
    assert [ref.scene_primitives.index(p) for p in ref.importance_sampled_list] \
        == [port.scene_primitives.index(p) for p in port.importance_sampled_list]
    _assert_same_compile(port, ref)
    assert port._diffuse_fan() == ref._diffuse_fan()
    assert T.scene_to_dict(port) == J.scene_to_dict(ref)


def test_example_scene_takes_the_solid_kernel_and_renders():
    """examples/example_scene.json: the solid kernel's gate, a diffuse fan
    of 8 and no Fresnel split, as the JAX compile has it; rendered here by
    the kernel's plain version."""
    sc = T.load_scene_file(EXAMPLE, width=24, height=18)
    ref = J.load_scene_file(EXAMPLE, width=24, height=18)
    static, _, settings = sc._settings_for_render()
    j_static, _, j_settings = ref._settings_for_render(False)
    assert static.pallas_ok and j_static.pallas_ok
    assert (sc._diffuse_fan(), settings.split_k) == (8, 0)
    assert (ref._diffuse_fan(), j_settings.split_k) == (8, 0)
    assert len(sc.scene_primitives) == 4 and len(sc.Light_list) == 2
    img, stats = sc.render(1, seed=0, output="linear", return_stats=True,
                           device="cpu")
    assert img.shape == (18, 24, 3) and np.isfinite(img).all()
    assert img.max() > 0.1 and stats["samples"] == 8


def test_resolution_override_and_load(tmp_path):
    sc = T.scene_from_dict(MINIMAL, width=40, height=30)
    assert (sc.camera.screen_width, sc.camera.screen_height) == (40, 30)
    p = tmp_path / "s.json"
    p.write_text(json.dumps(MINIMAL))
    sc = T.load_scene_file(p)
    assert (sc.camera.screen_width, sc.camera.screen_height) == (24, 16)
    p.write_text("{")
    with pytest.raises(ValueError, match="invalid JSON"):
        T.load_scene_file(p)


def _rich_scene(m, tex):
    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.03), n=(1.0, 1.0, 1.0))
    sc.add_Camera(look_from=m.vec3(0, 0.4, 1.2), look_at=m.vec3(0, 0, -2),
                  screen_width=40, screen_height=30, field_of_view=70,
                  aperture=0.02, focal_distance=2.5)
    sc.add_DirectionalLight(Ldir=m.vec3(0.4, 0.6, -0.4),
                            color=m.rgb(0.2, 0.2, 0.19))
    sc.add_PointLight(pos=m.vec3(0, 2, -1), color=m.rgb(0.4, 0.4, 0.4))
    sc.add_SpotLight(pos=m.vec3(1, 2, -1), direction=m.vec3(-0.4, -1, -0.4),
                     color=m.rgb(0.1, 0.1, 0.1), angle=25, inner_angle=15)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.image(tex, repeat=2.0),
                                      diffuse_rays=4),
                   center=m.vec3(0, -0.5, -2), width=12, height=12,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(4, 4, 4)),
                    center=m.vec3(0, 2, -2), radius=0.3, shadow=False),
           importance_sampled=True)
    box = m.Cuboid(material=m.Refractive(n=m.vec3(1.5, 1.51, 1.52)),
                   center=m.vec3(0.8, 0, -2.2), width=0.5, height=0.5,
                   length=0.5, max_ray_depth=4, mc=True)
    box.rotate(30, m.vec3(0, 1, 0)).rotate(10, m.vec3(1, 0, 0))
    sc.add(box)
    sc.add(m.Disc(material=m.Glossy(diff_color=m.rgb(0.9, 0.7, 0.3),
                                    n=m.vec3(0.2 + 3.0j, 0.4 + 2.4j, 1.5 + 1.9j),
                                    roughness=0.1, spec_coeff=0.5,
                                    diff_coeff=0.5),
                  center=m.vec3(-0.8, 0.2, -2.5), radius=0.6, inner_radius=0.3,
                  normal=m.vec3(0.2, 0.3, 1.0)))
    sc.add(m.Cylinder(material=m.ThinFilmInterference(thickness=360, noise=0.2),
                      center=m.vec3(0, 0, -3), radius=0.3, height=0.8,
                      capped=False))
    return sc


def test_export_round_trip_is_exact(tmp_path):
    """tests/test_scene_io.py test_export_round_trip_is_exact: the dicts of
    both packages agree, and the reloaded scene has the same attributes
    and compiles to the same tables."""
    tex = _png(tmp_path / "t.png", value=200)
    sc = _rich_scene(T, tex)
    assert T.scene_to_dict(sc) == J.scene_to_dict(_rich_scene(J, tex))
    p = tmp_path / "scene.json"
    T.save_scene_file(sc, p)
    sc2 = T.load_scene_file(p)
    for a, b in zip(sc.scene_primitives, sc2.scene_primitives):
        assert type(a) is type(b)
        for attr in ("center", "radius", "u_axis", "v_axis", "normal",
                     "axis", "basis", "lb", "rt", "p1", "p2", "p3"):
            va, vb = getattr(a, attr, None), getattr(b, attr, None)
            assert (va is None) == (vb is None)
            if va is not None:
                assert np.array_equal(np.asarray(va), np.asarray(vb)), attr
    for a, b in zip(sc.Light_list, sc2.Light_list):
        for attr in ("pos", "Ldir", "direction", "color", "cos_inner",
                     "cos_outer"):
            va, vb = getattr(a, attr, None), getattr(b, attr, None)
            if va is not None:
                assert np.array_equal(np.asarray(va), np.asarray(vb)), attr
    assert sc2.camera.aperture == sc.camera.aperture
    assert len(sc2.importance_sampled_list) == 1
    (s1, t1), (s2, t2) = compile_scene(sc), compile_scene(sc2)
    assert s1 == s2
    for name in t1.TENSORS:
        assert torch.equal(getattr(t1, name), getattr(t2, name)), name


def test_export_rejects_unexportable(tmp_path):
    sc = T.scene_from_dict(MINIMAL)
    sc.add(T.Sphere(material=T.Diffuse(diff_color=T.image(
        np.ones((2, 2, 3), np.float32))), center=T.vec3(1, 0, -3), radius=0.5))
    with pytest.raises(ValueError, match="ndarray-backed"):
        T.save_scene_file(sc, tmp_path / "x.json")
    bg = T.scene_from_dict(MINIMAL)
    bg.add_Background(np.ones((4, 8, 3), np.float32), spherical=True)
    with pytest.raises(ValueError, match="ndarray-backed background"):
        T.scene_to_dict(bg)
    with pytest.raises(ValueError, match="camera"):
        T.scene_to_dict(T.Scene())


def test_errors_are_located():
    """tests/test_scene_io.py test_errors_are_located, message for message."""
    with pytest.raises(ValueError, match="camera"):
        T.scene_from_dict({"objects": []})
    bad = dict(MINIMAL)
    bad["objects"] = [{"type": "klein_bottle", "material":
                       {"type": "emissive", "color": [1, 1, 1]}}]
    with pytest.raises(ValueError, match=r"objects\[0\].*klein_bottle"):
        T.scene_from_dict(bad)
    bad["objects"] = [{"type": "sphere", "center": [0, 0, -3], "radius": 1,
                       "material": {"type": "velvet"}}]
    with pytest.raises(ValueError, match="velvet"):
        T.scene_from_dict(bad)
    bad["objects"] = [{"type": "sphere", "center": [0, 0, -3], "radius": 1,
                       "wobble": 3,
                       "material": {"type": "emissive", "color": [1, 1, 1]}}]
    with pytest.raises(ValueError, match=r"objects\[0\]"):
        T.scene_from_dict(bad)
    with pytest.raises(ValueError, match="n"):
        T.scene_from_dict({**MINIMAL, "n": [1, 2, 3, 4]})
    bad["objects"] = [{"type": "cuboid", "center": [0, 0, -3], "width": 1,
                       "height": 1, "length": 1,
                       "rotate": {"angle": 30, "axis": [0, 1, 0]},
                       "material": {"type": "emissive", "color": [1, 1, 1]}}]
    with pytest.raises(ValueError, match=r"objects\[0\]\.rotate"):
        T.scene_from_dict(bad)
    with pytest.raises(ValueError, match=r"lights\[0\].*laser"):
        T.scene_from_dict({**MINIMAL, "lights": [{"type": "laser"}]})
    with pytest.raises(ValueError, match="background: needs an 'image'"):
        T.scene_from_dict({**MINIMAL, "background": {"blur": 1.0}})
    with pytest.raises(ValueError, match=r"objects\[0\]\.material"):
        T.scene_from_dict({**MINIMAL, "objects": [{"type": "sphere"}]})


def test_mesh_objects_raise_naming_their_roadmap_item(tmp_path):
    """Mesh objects load since ROADMAP.md item 4 (their round trip is in
    tests/test_torch_mesh_scenes.py); what still raises raises as in the
    JAX package: a missing OBJ file, and the export of a MeshInstances
    group (the schema has no instances), located."""
    doc = {**MINIMAL, "objects": [
        {"type": "mesh", "filename": str(tmp_path / "bunny.obj"),
         "center": [0, 0, -3],
         "material": {"type": "emissive", "color": [1, 1, 1]}}]}
    for m in (T, J):
        with pytest.raises(FileNotFoundError, match="bunny.obj"):
            m.scene_from_dict(doc)
    (tmp_path / "bunny.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    for m in (T, J):
        sc = m.scene_from_dict(doc)
        grp = m.MeshInstances(sc.scene_primitives[0])
        sc.add(grp.add(translate=(1, 0, 0)))
        with pytest.raises(ValueError,
                           match=r"objects\[1\]: MeshInstances cannot be "
                                 "exported"):
            m.scene_to_dict(sc)
