"""The textured scene side of the port against the JAX package.

Host side, bit for bit (numpy in both packages, no kernel): the texture
atlas (words, scales, shapes, offsets, encodings), the glossy and
thin-film tables, `_tf_composed`, `_env_combined`, `_tf_sel_poly`, the
thin-film LUT and noise, `blur_skybox_array`, `_gaussian_blur_linear`,
image loading and the `pallas_ok` / `pallas_tex_ok` gates, on examples
1-4 (procedural assets) and an HDR environment.

Kernel side: the thin-film + lightmap scene (two replay rounds, an
RGB9E5 table) through one interpret call of the Pallas record kernel,
held as tests/test_torch_record.py holds its scenes (same checks), and one
statistical whole render against the JAX package's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.backgrounds import blur as j_blur
from raytracer_tpu.backgrounds import environment as j_env
from raytracer_tpu.core import compile as j_compile
from raytracer_tpu.utils import image_io as j_io
from raytracer_tpu.utils import thin_film as j_tf
from raytracer_tpu_torch.backgrounds import blur as t_blur
from raytracer_tpu_torch.backgrounds import environment as t_env
from raytracer_tpu_torch.core import compile as t_compile
from raytracer_tpu_torch.interop import tables_from_jax
from raytracer_tpu_torch.utils import image_io as t_io
from raytracer_tpu_torch.utils import thin_film as t_tf

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_record import (check_chunk, check_count,  # noqa: E402
                               check_records, hold_case)
from test_torch_scenes import (lit_textures, textured_scene,  # noqa: E402
                               thinfilm_ibl, torch_textured)


def hdr_env(m):
    """An HDR equirect environment (linear=True, values past
    E5_PACK_LIMIT) around a glossy sphere."""
    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(screen_height=16, screen_width=20,
                  look_from=m.vec3(-4, 0, 0), look_at=m.vec3(0, 0.05, 0))
    sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(1.0, 0.572, 0.184),
                                      n=m.vec3(0.15 + 3.58j, 0.4 + 2.37j,
                                               1.54 + 1.91j),
                                      roughness=0.1, spec_coeff=0.3,
                                      diff_coeff=0.7),
                    center=m.vec3(1.0, 0.0, 1.5), radius=1.7, max_ray_depth=3))
    sc.add_Background(m.procedural_sky(128, 96) * 8, spherical=True,
                      linear=True, light_intensity=0.5)
    return sc


SCENES = {
    "example1": lambda m: torch_textured.example1(40, 30, m=m),
    "example2": lambda m: torch_textured.example2(40, 30, m=m),
    "example3": lambda m: torch_textured.example3(40, 30, m=m),
    "example4": lambda m: torch_textured.example4(40, 30, m=m),
    "example4-blur0": lambda m: torch_textured.example4(40, 30, m=m, blur=0.0),
    "hdr_env": hdr_env,
    "thinfilm_ibl": thinfilm_ibl,
    "lit_textures": lit_textures,
    "textured_scene": textured_scene,
}


@pytest.mark.parametrize("name", SCENES)
def test_textured_tables_match_jax_exactly(name):
    """Static structure (texture refs, env slots, atlas shapes / offsets /
    encodings, the thin-film cubics, the gates) and every table (atlas
    words, scales, glossy and thin-film rows) bit for bit."""
    static, tables = t_compile.compile_scene(SCENES[name](T))
    j_static, j_tables = tables_from_jax(*j_compile.compile_scene(SCENES[name](J)))
    assert static == j_static
    for k in tables.TENSORS:
        a, b = getattr(tables, k), getattr(j_tables, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert static.pallas_tex_ok and not static.pallas_ok
    if name in ("example4", "example4-blur0", "thinfilm_ibl", "hdr_env"):
        assert 1 in static.tex_enc          # an RGB9E5 table
    else:
        assert not any(static.tex_enc)


@pytest.mark.parametrize("name", SCENES)
def test_textured_render_settings_match_jax(name):
    """The bounce budget, the split levels and the diffuse fan that
    Scene.render derives, as the JAX package derives them."""
    port, ref = SCENES[name](T), SCENES[name](J)
    _, _, settings = port._settings_for_render()
    _, _, j_settings = ref._settings_for_render(False)
    assert (settings.max_bounces, settings.split_k) == (
        j_settings.max_bounces, j_settings.split_k)
    assert port._diffuse_fan() == ref._diffuse_fan()


def test_pack_e5_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.lognormal(mean=-1, sigma=2, size=(64, 128, 3)).astype(np.float32)
    a[5, 7] = (5000.0, 4.0, 0.25)
    a[6, 8] = 0.0
    assert np.array_equal(t_compile._pack_e5(a), np.asarray(j_compile._pack_e5(a)))


def test_thin_film_tables_match_jax():
    cos = np.linspace(0.0, 1.0, 33)
    d = np.arange(0, 700, 7.0)
    assert np.array_equal(t_tf.thin_film_reflectance(cos[:, None], d[None, :], 1.33),
                          j_tf.thin_film_reflectance(cos[:, None], d[None, :], 1.33))
    assert np.array_equal(t_tf.thin_film_lut(1.4), j_tf.thin_film_lut(1.4))
    assert np.array_equal(t_tf.default_noise_texture(), j_tf.default_noise_texture())


def test_tf_composed_env_combined_sel_poly_match_jax():
    rng = np.random.default_rng(11)
    lut = rng.random((64, 128, 3)).astype(np.float32) * 0.9
    noise = rng.random((32, 32)).astype(np.float32)
    for kw in (dict(thickness=60, noise=40.0), dict(thickness=70, noise=0.0)):
        mt = T.ThinFilmInterference(lut=lut, noise_texture=noise, **kw)
        mj = J.ThinFilmInterference(lut=lut, noise_texture=noise, **kw)
        assert np.array_equal(t_compile._tf_composed(mt),
                              j_compile._tf_composed(mj))
        assert t_compile._tf_sel_poly(mt) == j_compile._tf_sel_poly(mj)
    # the default tables compose past TF_COMP_LIMIT: None in both
    assert t_compile._tf_composed(T.ThinFilmInterference(330, noise=60.0)) is None
    assert j_compile._tf_composed(J.ThinFilmInterference(330, noise=60.0)) is None
    sky = T.procedural_sky(128, 96)
    for size in ((128, 96), (64, 48)):          # same grid; nearest-resampled
        mt = t_env.EnvironmentMaterial(sky, light_intensity=3.0)
        mj = j_env.EnvironmentMaterial(sky, light_intensity=3.0)
        mt.lightmap = mj.lightmap = T.procedural_sky(*size)
        assert np.array_equal(t_compile._env_combined(mt, mt.texture),
                              j_compile._env_combined(mj, mj.texture))


def test_skybox_blurs_match_jax():
    sky = T.procedural_sky(128, 96)
    assert np.array_equal(t_blur.blur_skybox_array(sky, 4.0),
                          j_blur.blur_skybox_array(sky, 4.0))
    assert np.array_equal(t_blur._fill_empty_cells(sky), j_blur._fill_empty_cells(sky))
    hdr = sky * 8
    for wrap in (False, True):
        assert np.array_equal(t_env._gaussian_blur_linear(hdr, 3.0, wrap_x=wrap),
                              j_env._gaussian_blur_linear(hdr, 3.0, wrap_x=wrap))


def test_image_loading_matches_jax(tmp_path, monkeypatch):
    """A PNG found through the asset path loads /255 and linearises as
    in the JAX package; ndarray textures never touch Pillow."""
    from PIL import Image

    rng = np.random.default_rng(5)
    (tmp_path / "textures").mkdir()
    Image.fromarray(rng.integers(0, 256, (6, 10, 3), np.uint8)).save(
        tmp_path / "textures" / "t.png")
    for io in (t_io, j_io):
        monkeypatch.setattr(io, "_DEFAULT_ROOTS", list(io._DEFAULT_ROOTS))
        io.add_asset_root(tmp_path)
    assert t_io.resolve_asset("t.png") == tmp_path / "textures" / "t.png"
    assert np.array_equal(t_io.load_image("t.png"), j_io.load_image("t.png"))
    assert np.array_equal(T.image("t.png", repeat=2.0).img,
                          J.image("t.png", repeat=2.0).img)
    with pytest.raises(FileNotFoundError):
        t_io.resolve_asset("missing.png")
    with pytest.raises(ValueError, match="filter"):
        T.image(np.zeros((2, 2, 3)), filter="cubic")


def test_ndarray_scenes_need_no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    sc = torch_textured.example4(8, 6, blur=0.0)
    img = sc.render(samples_per_pixel=1, output="linear", device="cpu")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    with pytest.raises(ImportError):
        torch_textured.example4(8, 6, blur=2.0)


def test_env_importance_sampling_stays_off_the_record_path():
    """An importance-sampled Panorama is the wavefront's (the JAX gate
    sends it there): without a Diffuse material nothing samples it and the
    scene renders there; with one, the diffuse mixture samples its alias
    tables (tests/test_torch_env_is.py holds them against JAX)."""
    def scene(m):
        sc = torch_textured.example3(8, 6, m=m)
        sc.scene_primitives.pop()
        sc.add_Background(m.procedural_sky(64, 32), spherical=True,
                          importance_sampled=True)
        return sc

    static, _ = t_compile.compile_scene(scene(T))
    j_static, _ = j_compile.compile_scene(scene(J))
    assert (static.pallas_ok, static.pallas_tex_ok) == (
        j_static.pallas_ok, j_static.pallas_tex_ok) == (False, False)
    img = scene(T).render(samples_per_pixel=1, device="cpu", output="linear")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    sc = scene(T)
    sc.add(T.Sphere(material=T.Diffuse(diff_color=T.rgb(0.5, 0.5, 0.5)),
                    center=T.vec3(0, 0, -3), radius=0.5))
    static, _ = t_compile.compile_wavefront(sc)
    assert static.env_is_shape == (32, 64)
    img = sc.render(samples_per_pixel=1, device="cpu", output="linear")
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()


@pytest.fixture(scope="module")
def thinfilm_case():
    return hold_case(thinfilm_ibl, 16, "r2")


def test_thinfilm_records_match_pallas_kernel(thinfilm_case):
    check_records(thinfilm_case)


def test_thinfilm_rays_traced_equal(thinfilm_case):
    """Two of 16,384 lanes diverge here (19,545 rays against 19,547; see
    tests/test_torch_record.py)."""
    check_count(thinfilm_case)


def test_thinfilm_replay_of_jax_records_matches_jax_replay(thinfilm_case):
    """rtol 1e-6 on every ray (observed: bit-equal on every ray, the
    RGB9E5 decode included)."""
    c = thinfilm_case
    ok = np.isclose(c["L_rep"], c["L_j"], rtol=1e-6, atol=1e-12).all(axis=1)
    assert ok.all(), ok.mean()


def test_thinfilm_chunk_matches_pallas_record_chunk(thinfilm_case):
    check_chunk(thinfilm_case)


def test_textured_statistical_match():
    """A whole 20x16 x 16 spp render of the port against the JAX
    package's, as tests/test_pallas_record.py holds its record path
    against its wavefront: the chunk seeds differ (threefry vs numpy), so
    the images agree statistically."""
    a = np.asarray(J.Scene.render(textured_scene(J), 16, seed=0),
                   np.float32) / 255.0
    b = np.asarray(T.Scene.render(textured_scene(T), 16, seed=0, device="cpu"),
                   np.float32) / 255.0
    assert np.allclose(a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0),
                       atol=0.02)
    assert np.abs(a - b).mean() < 0.03
