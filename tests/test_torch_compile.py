"""The port's scene compiler against the JAX package's.

Each scene is built twice from one description, once through each
package's API.  The port's tables must equal, bit for bit,
`tables_from_jax` of the JAX package's compiled scene, and the derived
render settings, the gate, the diffuse fan and the camera vector must be
the same.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.compile import compile_scene
from raytracer_tpu_torch.interop import static_from_jax, tables_from_jax
from raytracer_tpu_torch.utils.image_io import load_hdr, save_hdr

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (box_and_plane, cornell, emissive, glass,  # noqa: E402
                               is_diffuse, lights_and_slots, too_many_objects)


SCENES = [cornell, emissive, box_and_plane, glass, is_diffuse,
          lights_and_slots, too_many_objects]


@pytest.mark.parametrize("build", SCENES, ids=lambda f: f.__name__)
def test_tables_match_jax_exactly(build):
    static, tables = compile_scene(build(T))
    j_static, j_tables = tables_from_jax(*jax_compile(build(J)))
    assert static == j_static
    for name in tables.TENSORS:
        a, b = getattr(tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tables.obj_rows == j_tables.obj_rows
    assert tables.n_is_targets == j_tables.n_is_targets


@pytest.mark.parametrize("build", SCENES, ids=lambda f: f.__name__)
def test_render_settings_and_fan_match_jax(build):
    port, ref = build(T), build(J)
    static, _, settings = port._settings_for_render()
    j_static, _, j_settings = ref._settings_for_render(False)
    assert static.pallas_ok == j_static.pallas_ok
    assert settings.max_bounces == j_settings.max_bounces
    assert settings.split_k == j_settings.split_k
    assert (settings.sampler, settings.projection) == (
        j_settings.sampler, j_settings.projection)
    assert port._diffuse_fan() == ref._diffuse_fan()


@pytest.mark.parametrize("build", SCENES, ids=lambda f: f.__name__)
def test_cam_vec_matches_jax(build):
    cam = build(J).camera.params()
    want = jnp.concatenate([cam.origin, cam.fwd, cam.right, cam.up,
                            jnp.stack([cam.cam_w, cam.cam_h, cam.lens_radius,
                                       cam.focal, cam.half_fov])])
    got = cam_vec(build(T).camera.params())
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_aa_planes_detected_as_in_jax():
    static, tables = compile_scene(cornell(T))
    assert static == static_from_jax(jax_compile(cornell(J))[0])
    assert sum(r.aa is not None for r in static.obj_records) == 6
    static, _ = compile_scene(lights_and_slots(T))
    assert [r.aa is None for r in static.obj_records
            if r.kind == "plane"] == [False, True]


def test_out_of_slice_scenes_raise():
    sc = emissive(T)
    # .hdr environments load now (tests/test_torch_hdr.py); a missing file
    # is looked up on the asset path and not found
    with pytest.raises(FileNotFoundError, match="sky.hdr"):
        sc.add_Background("sky.hdr")
    # normal maps construct now (tests/test_torch_normal_maps.py); on a
    # disc the compile raises, as in the JAX package
    for m in (J, T):
        bad = emissive(m)
        bad.add(m.Disc(center=m.vec3(0, 0, -4), radius=0.5,
                       material=m.Diffuse(diff_color=m.rgb(1, 1, 1),
                                          normalmap=np.zeros((2, 2, 3)))))
        with pytest.raises(ValueError, match="not supported on Disc"):
            (jax_compile if m is J else compile_scene)(bad)

    # discs, cylinders and triangles compile now, in the JAX object order
    mat = T.Emissive(color=T.rgb(1, 1, 1))
    sc.add(T.Triangle(center=T.vec3(0, 0, -2), material=mat,
                      p1=T.vec3(-1, 0, -2), p2=T.vec3(1, 0, -2),
                      p3=T.vec3(0, 1, -2)))
    sc.add(T.Cylinder(center=T.vec3(0, 0, -3), material=mat, radius=0.5,
                      height=1.0))
    sc.add(T.Disc(center=T.vec3(0, 0, -4), material=mat, radius=0.5))
    static, _ = compile_scene(sc)
    assert [r.kind for r in static.obj_records] == ["sphere", "disc", "cyl", "tri"]

    # a primitive the compiler does not know raises as in the JAX
    # package (meshes compile since ROADMAP.md item 4)
    class Mesh(T.Primitive):
        pass

    sc.add(Mesh(center=T.vec3(0, 0, 0), material=mat))
    with pytest.raises(TypeError, match="unsupported primitive Mesh"):
        compile_scene(sc)
    # a scene past the kernels' gate renders on the wavefront (ROADMAP.md
    # item 3), emissive only, so equal to the JAX package's image
    got = too_many_objects(T).render(samples_per_pixel=1, device="cpu",
                                     output="linear")
    want = too_many_objects(J).render(samples_per_pixel=1, output="linear")
    assert np.array_equal(got, np.asarray(want))


def _env_scene(m, path, spherical=True, blur=0.0, light=0.0):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 0), look_at=m.vec3(0, 0, -1),
                  screen_width=8, screen_height=8)
    sc.add_Background(str(path), spherical=spherical, blur=blur,
                      light_intensity=light)
    return sc


def _hdr_env(tmp_path, bright=True):
    env = np.full((8, 16, 3), 5.0 if bright else 0.5, np.float32)
    env[:, :, 1] = 2.0 if bright else 0.2
    env[2, 3] = 300.0 if bright else 0.9
    p = tmp_path / ("env.hdr" if bright else "dim.rgbe")
    save_hdr(env, p)
    return p


@pytest.mark.parametrize("case", ["panorama", "dim-rgbe", "skybox-blur",
                                  "panorama-blur-light"])
def test_hdr_environment_compiles_as_jax(tmp_path, case):
    """A Radiance .hdr environment: linear radiance, no sRGB EOTF,
    `is_hdr` set as for a linear ndarray, bright maps in RGB9E5 words,
    and the tables bit for bit the JAX package's."""
    p = _hdr_env(tmp_path, bright=case != "dim-rgbe")
    kw = dict(spherical=not case.startswith("skybox"),
              blur=2.0 if "blur" in case else 0.0,
              light=0.7 if "light" in case else 0.0)
    port, ref = _env_scene(T, p, **kw), _env_scene(J, p, **kw)
    mat, jmat = port.scene_primitives[0].material, ref.scene_primitives[0].material
    assert mat.is_hdr and jmat.is_hdr
    assert np.array_equal(mat.texture, jmat.texture)
    assert np.array_equal(mat.texture, load_hdr(p))
    for attr in ("blur_texture", "lightmap"):
        a, b = getattr(mat, attr), getattr(jmat, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            assert np.array_equal(a, b), attr
    static, tables = compile_scene(port)
    j_static, j_tables = tables_from_jax(*jax_compile(ref))
    assert static == j_static
    assert static.pallas_tex_ok and not static.pallas_ok
    for name in tables.TENSORS:
        a, b = getattr(tables, name), getattr(j_tables, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # bright maps take RGB9E5 words, dim ones the 10-10-10 words, exactly
    # as the same map given as a linear ndarray
    assert static.tex_enc[0] == (1 if case != "dim-rgbe" else 0)
    arr = T.Scene()
    arr.add_Camera(look_from=T.vec3(0, 0, 0), look_at=T.vec3(0, 0, -1),
                   screen_width=8, screen_height=8)
    arr.add_Background(load_hdr(p), spherical=kw["spherical"],
                       blur=kw["blur"], light_intensity=kw["light"],
                       linear=True)
    a_static, a_tables = compile_scene(arr)
    assert arr.scene_primitives[0].material.is_hdr
    assert a_static.tex_enc == static.tex_enc
    assert torch.equal(a_tables.atlas, tables.atlas)
