"""Multi-device rendering through the port (raytracer_tpu_torch/parallel,
`Scene.render(mesh=...)` and every other `mesh=`) against the port's
unsharded renders and the JAX package's sharded ones
(tests/test_sharding.py on the JAX package's eight virtual CPU devices).

The port's mesh here is a grid of the one CPU device repeated
(`make_mesh(4, 2, [cpu] * 8)`), so every shard runs on the CPU, one after
another.  Held: scenes that draw nothing past the camera jitter
(emissive walls, quads, a custom shader constant over octants)
pixel-equal across 1x1, 8x1, 4x2 and 1x8 meshes and the unsharded render,
and equal to the JAX sharded render within 1/255; drawn scenes by image
mean (textured: 0.05, the JAX test's bound) or by a z-test over seeds
within 4 standard errors (Cornell); a 1x1 mesh bit-equal to the
unsharded render on each route (solid kernel, record kernel, wavefront);
a K1 chunk per sample shard with one pixel shard; the options across a
mesh (checkpoint resume bit for bit on an equal mesh and a restart on
another, adaptive stopping, variance, clamp, AOVs, the denoiser); ODS
over sample shards, frames and motion blur over a frame mesh (each frame
the one-device frame).  16x16 frames, one torch thread.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.parallel.sharded import make_mesh as jmake_mesh
from raytracer_tpu.parallel.sharded import render_sharded as jrender_sharded
from raytracer_tpu_torch.core import compile as tcompile
from raytracer_tpu_torch.parallel import sharded as tsharded
from raytracer_tpu_torch.parallel.sharded import (make_mesh,
                                                  plan_spp_per_device,
                                                  render_sharded,
                                                  shard_seed_row)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "examples"))
import torch_features  # noqa: E402
import torch_mesh  # noqa: E402
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from torch_cornellbox import build_cornell  # noqa: E402

CPU = torch.device("cpu")
EXACT = 1 / 255 + 1e-6


def mesh(s, p):
    return make_mesh(s, p, [CPU] * (s * p))


def srgb(sc, spp, seed=0, **kw):
    """The unsharded render as a float sRGB array."""
    return np.asarray(sc.render(spp, seed=seed, device=CPU, **kw),
                      np.float32) / 255.0


def tiny_scene(m=T, W=16, H=16):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 1), look_at=m.vec3(0, 0, -1),
                  screen_width=W, screen_height=H)
    sc.add(m.Plane(material=m.Emissive(color=m.rgb(0.2, 0.4, 0.6)),
                   center=m.vec3(0, 0, -2), width=100.0, height=100.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    return sc


def diffuse_scene(m=T, W=16, H=16):
    """tests/test_sharding.py diffuse_scene: a diffuse wall under part of
    a bright dome, a noisy estimator."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 1), look_at=m.vec3(0, 0, -1),
                  screen_width=W, screen_height=H)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.5, 0.5, 0.5),
                                      diffuse_rays=1),
                   center=m.vec3(0, 0, -2), width=100.0, height=100.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(4, 4, 4)),
                    center=m.vec3(0, 12, -2), radius=6.0, shadow=False))
    return sc


def test_meshes_of_cpu_devices():
    m = mesh(4, 2)
    assert m.shape == {"sample": 4, "pixel": 2} and m.devices.shape == (4, 2)
    assert all(d == CPU for d in m.devices.reshape(-1))
    assert make_mesh(devices=[CPU] * 8).shape == {"sample": 8, "pixel": 1}
    with pytest.raises(ValueError, match="mesh != 8 devices"):
        make_mesh(3, 2, [CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="pixel shards"):
        tiny_scene(W=16, H=15).render(1, mesh=mesh(1, 2))
    for dev in (CPU, None):
        with pytest.raises(ValueError, match="'sample' axis"):
            tiny_scene().render(1, mesh=object(), device=dev)
    # the shards continue one lattice: shard s starts s * spp_dev later
    row = np.array([11, 22, 40], np.int32)
    assert shard_seed_row(row, 0, 0, 8).tolist() == [11, 22, 40]
    r = shard_seed_row(row, 3, 1, 8)
    assert r[1] == 22 and r[2] == 64 and r[0] != 11
    assert plan_spp_per_device(5, 20, 3, 4) == 200    # 800 / 4, whole blocks
    assert plan_spp_per_device(3, 1, 3, 4) == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 8)])
def test_emissive_wall_is_pixel_equal_across_meshes(shape):
    # nothing is drawn past the camera jitter: every mesh gives the
    # unsharded pixels, and the JAX package's sharded ones within 1/255
    sc = tiny_scene()
    img = render_sharded(sc, 8, mesh=mesh(*shape))
    ref = srgb(sc, 8)
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.allclose(img, ref, atol=EXACT)
    jimg = jrender_sharded(tiny_scene(J), 8, mesh=jmake_mesh(*shape))
    assert np.allclose(img, jimg, atol=EXACT)


def test_pixel_bands_cover_frame():
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 1), look_at=T.vec3(0, 0, -1),
                  screen_width=16, screen_height=16)
    sc.add(T.Sphere(material=T.Emissive(color=T.rgb(1, 1, 1)),
                    center=T.vec3(0, 0.7, -2), radius=0.5))
    a = render_sharded(sc, 1, mesh=mesh(1, 8), seed=3)
    b = render_sharded(sc, 8, mesh=mesh(8, 1), seed=3)
    assert a.shape == b.shape == (16, 16, 3)
    ya, xa = np.where(a.sum(-1) > 0.1)
    yb, xb = np.where(b.sum(-1) > 0.1)
    assert len(ya) > 0
    assert abs(ya.mean() - yb.mean()) < 1.5 and abs(xa.mean() - xb.mean()) < 1.5


def _textured(m):
    from importlib import import_module

    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 1), look_at=m.vec3(0, 0, -1),
                  screen_width=16, screen_height=16)
    checker = import_module(f"{m.__name__}.textures.procedural").checkerboard
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.image(checker(32))),
                   center=m.vec3(0, 0, -2), width=100.0, height=100.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(1, 1, 1)),
                    center=m.vec3(0, 0, 0), radius=30.0, shadow=False))
    return sc


def test_sharded_textured_scene():
    # a record-kernel scene over a 4x2 mesh takes the wavefront per band
    img = render_sharded(_textured(T), 8, mesh=mesh(4, 2))
    ref = srgb(_textured(T), 8)
    jimg = jrender_sharded(_textured(J), 8, mesh=jmake_mesh(4, 2))
    assert np.allclose(img.mean(), ref.mean(), atol=0.05)
    assert np.allclose(img.mean(), jimg.mean(), atol=0.05)


def test_sharded_triangle_quad():
    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0, 0, 1), look_at=T.vec3(0, 0, -1),
                  screen_width=16, screen_height=16)
    quad = [((-50, -50), (50, -50), (50, 50)), ((-50, -50), (50, 50), (-50, 50))]
    for (x1, y1), (x2, y2), (x3, y3) in quad:
        sc.add(T.Triangle(material=T.Emissive(color=T.rgb(0.3, 0.6, 0.9)),
                          center=T.vec3(0, 0, 0), p1=T.vec3(x1, y1, -3),
                          p2=T.vec3(x2, y2, -3), p3=T.vec3(x3, y3, -3)))
    img = render_sharded(sc, 4, mesh=mesh(4, 2))
    assert np.allclose(img, srgb(sc, 4), atol=EXACT)
    jsc = J.Scene()
    jsc.add_Camera(look_from=J.vec3(0, 0, 1), look_at=J.vec3(0, 0, -1),
                   screen_width=16, screen_height=16)
    for (x1, y1), (x2, y2), (x3, y3) in quad:
        jsc.add(J.Triangle(material=J.Emissive(color=J.rgb(0.3, 0.6, 0.9)),
                           center=J.vec3(0, 0, 0), p1=J.vec3(x1, y1, -3),
                           p2=J.vec3(x2, y2, -3), p3=J.vec3(x3, y3, -3)))
    assert np.allclose(img, jrender_sharded(jsc, 4, mesh=jmake_mesh(4, 2)),
                       atol=EXACT)


def test_sharded_clustered_mesh(tmp_path, monkeypatch):
    path = tmp_path / "ico3.obj"
    torch_mesh.write_icosphere_obj(path, 3)

    def build():
        sc = T.Scene()
        sc.add_Camera(look_from=T.vec3(0, 0, 3), look_at=T.vec3(0, 0, 0),
                      screen_width=16, screen_height=16, field_of_view=45)
        sc.add(T.TriangleMesh(str(path), center=T.vec3(0, 0, 0),
                              material=T.Emissive(color=T.rgb(0.2, 0.9, 0.3))))
        return sc

    monkeypatch.setattr(tcompile, "TRI_CLUSTER_THRESHOLD", 32)
    img = render_sharded(build(), 4, mesh=mesh(4, 2), seed=7)
    monkeypatch.setattr(tcompile, "TRI_CLUSTER_THRESHOLD", 10 ** 9)
    ref = srgb(build(), 4, seed=7)
    # only silhouette pixels may differ by the shards' jitter
    assert (np.abs(img - ref) <= EXACT).mean() > 0.9
    assert np.allclose(img.mean(), ref.mean(), atol=0.02)


class OctantColor(T.CustomMaterial):
    """A colour constant over each octant of the shading normal."""

    def shade(self, ctx):
        col = 0.25 + 0.5 * (ctx.N > 0).to(torch.float32)
        return dataclasses.replace(T.default_shade_out(ctx), add=col)


def test_sharded_custom_material():
    def build():
        sc = T.Scene()
        sc.add_Camera(look_from=T.vec3(0, 0, 1), look_at=T.vec3(0, 0, -1),
                      screen_width=16, screen_height=16)
        sc.add(T.Sphere(material=OctantColor(), center=T.vec3(0, 0, -3),
                        radius=2.5))
        return sc

    img = render_sharded(build(), 4, mesh=mesh(4, 2), seed=5)
    ref = srgb(build(), 4, seed=5)
    assert (np.abs(img - ref) <= EXACT).mean() > 0.9
    assert np.allclose(img.mean(), ref.mean(), atol=0.02)


@pytest.mark.parametrize("shape", [(8, 1), (2, 2)])
def test_sharded_cornell_within_4_standard_errors(shape):
    # 8x1: K1's plain version on each sample shard; 2x2: the wavefront
    # on each band.  Image and 3x3 region means within 4 standard errors
    # of the unsharded render (the seed-to-seed scatter), and the noise
    # level alike (the stratified sampler kept across shards)
    seeds = (11, 12, 13, 14)
    sh, sg = [], []
    for s in seeds:
        sc = build_cornell(16, 16)
        sh.append(sc.render(2, seed=s, mesh=mesh(*shape), output="linear"))
        sg.append(sc.render(2, seed=s, device=CPU, output="linear"))
    sh, sg = np.stack(sh), np.stack(sg)
    bands = np.array_split(np.arange(16), 3)
    pairs = [(sh.mean((1, 2, 3)), sg.mean((1, 2, 3)))] + [
        (sh[:, r][:, :, c].mean((1, 2, 3)), sg[:, r][:, :, c].mean((1, 2, 3)))
        for r in bands for c in bands]
    for a, b in pairs:
        se = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / len(seeds))
        assert abs(a.mean() - b.mean()) <= 4 * se + 1e-6, (a, b, se)
    ratio = (sh.std(0).mean() + 1e-4) / (sg.std(0).mean() + 1e-4)
    assert 0.5 < ratio < 2.0, ratio
    if shape == (8, 1):
        # and the JAX package's sharded Cornell (display values), by the
        # seed-to-seed scatter of the image mean
        from example_cornellbox import build_cornell as jbuild

        a = np.array([render_sharded(build_cornell(16, 16), 2, seed=s,
                                     mesh=mesh(*shape)).mean() for s in seeds])
        b = np.array([jrender_sharded(jbuild(16, 16), 2, seed=s,
                                      mesh=jmake_mesh(*shape)).mean()
                      for s in seeds])
        se = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / len(seeds))
        assert abs(a.mean() - b.mean()) <= 4 * se + 1e-6, (a, b, se)


@pytest.mark.parametrize("kind", ["solid", "record", "wavefront"])
def test_one_by_one_mesh_is_the_unsharded_render(kind):
    if kind == "record":
        sc = _textured(T)
    else:
        sc = build_cornell(16, 16)
        if kind == "wavefront":
            sc.settings = T.RenderSettings(use_pallas="never")
    a = sc.render(4, seed=9, mesh=mesh(1, 1), output="linear",
                  with_variance=True)
    b = sc.render(4, seed=9, device=CPU, output="linear", with_variance=True)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_sample_shards_run_the_solid_kernel_each(monkeypatch):
    calls = []
    real = tsharded.solid_trace_chunk

    def spy(seed, *args):
        calls.append(seed.tolist())
        return real(seed, *args)

    monkeypatch.setattr(tsharded, "solid_trace_chunk", spy)
    sc = build_cornell(16, 16)
    _, stats = sc.render(2, seed=4, mesh=mesh(4, 1), output="linear",
                         return_stats=True)
    # 2 spp x fan 20 = 40 eff spp: 10 a shard, one chunk of 4 shards
    assert len(calls) == 4 and stats["samples"] == 40
    assert [c[2] for c in calls] == [0, 10, 20, 30]
    assert len({c[0] for c in calls}) == 4 and len({c[1] for c in calls}) == 1
    calls.clear()
    sc.render(2, seed=4, mesh=mesh(2, 2), output="linear")
    assert calls == []          # pixel shards: the wavefront


def test_emissive_scene_pixel_equal_across_1x1_4x1_2x2():
    sc = tiny_scene()
    ref = sc.render(4, seed=2, device=CPU, output="linear")
    for shape in ((1, 1), (4, 1), (2, 2)):
        assert np.array_equal(sc.render(4, seed=2, mesh=mesh(*shape),
                                        output="linear"), ref), shape


def test_sharded_chunked_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "shard_ckpt.npz")
    sc = diffuse_scene()
    m = mesh(8, 1)
    partial16 = sc.render(16, seed=9, batch_size=1, mesh=m,
                          checkpoint_path=ck, checkpoint_every=1,
                          output="linear")
    full = sc.render(32, seed=9, batch_size=1, mesh=m, checkpoint_path=ck,
                     output="linear")
    fresh = sc.render(32, seed=9, batch_size=1, mesh=m, output="linear")
    assert np.array_equal(full, fresh)
    assert not np.array_equal(partial16, fresh)
    # another mesh shape never resumes from it
    single = sc.render(32, seed=9, batch_size=8, checkpoint_path=ck,
                       output="linear", device=CPU)
    single_fresh = sc.render(32, seed=9, batch_size=8, output="linear",
                             device=CPU)
    assert np.array_equal(single, single_fresh)


def test_sharded_adaptive_stopping():
    sc = diffuse_scene()
    linear, stats = sc.render(256, seed=0, batch_size=1, mesh=mesh(8, 1),
                              target_noise=0.15, noise_check_every=1,
                              output="linear", return_stats=True)
    assert stats["noise_q99"] <= 0.15
    assert stats["samples"] < 256 and stats["samples"] % 8 == 0
    assert np.isfinite(linear).all()


def test_sharded_variance_and_clamp():
    m = mesh(4, 2)
    sc = diffuse_scene()
    lin_m, var_m = sc.render(32, seed=1, mesh=m, output="linear",
                             with_variance=True)
    lin_s, var_s = sc.render(32, seed=1, output="linear", with_variance=True,
                             device=CPU)
    assert var_m.shape == var_s.shape == lin_m.shape
    assert np.allclose(lin_m.mean(), lin_s.mean(), atol=0.02)
    assert 0.5 < (var_m.mean() + 1e-8) / (var_s.mean() + 1e-8) < 2.0
    capped = sc.render(8, seed=1, mesh=m, output="linear", clamp=0.25)
    assert capped.max() <= 0.25 + 1e-6
    loose = sc.render(8, seed=1, mesh=m, output="linear", clamp=1e9)
    base = sc.render(8, seed=1, mesh=m, output="linear")
    assert np.array_equal(loose, base)


def test_sharded_aovs():
    sc = diffuse_scene()
    a = sc.render_aovs(4, mesh=mesh(4, 2))
    b = sc.render_aovs(4, device=CPU)
    assert set(a) == set(b)
    assert np.array_equal(a["obj_id"], b["obj_id"])
    assert np.allclose(a["coverage"], b["coverage"])
    assert np.allclose(a["albedo"], b["albedo"], atol=1e-5)
    assert np.allclose(a["depth"], b["depth"], rtol=0.05)
    # a 1x1 mesh: the unsharded planes bit for bit
    c = sc.render_aovs(4, mesh=mesh(1, 1), ao_samples=2)
    d = sc.render_aovs(4, device=CPU, ao_samples=2)
    assert all(np.array_equal(c[k], d[k]) for k in d)
    ao = sc.render_aovs(2, ao_samples=2, mesh=mesh(4, 2))["ao"]
    assert ao.shape == a["coverage"].shape
    assert (ao >= 0).all() and (ao <= 1 + 1e-6).all()


def test_sharded_denoised():
    img = diffuse_scene().render_denoised(8, mesh=mesh(8, 1), output="linear")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_ods_over_sample_shards():
    vr = torch_features.vr(16, 8)
    one = T.render_ods(vr, 2, ipd=0.0, output="linear", layout="separate",
                       mesh=mesh(1, 1))
    ref = T.render_ods(vr, 2, ipd=0.0, output="linear", layout="separate",
                       device=CPU)
    assert np.array_equal(one[0], ref[0]) and np.array_equal(one[1], ref[1])
    four = T.render_ods(vr, 4, ipd=0.0, output="linear", layout="separate",
                        mesh=mesh(4, 1))
    assert np.array_equal(four[0], four[1])            # ipd 0: equal eyes
    assert abs(four[0].mean() - ref[0].mean()) < 0.1 * ref[0].mean() + 1e-3
    with pytest.raises(ValueError, match="pixel=1"):
        T.render_ods(vr, 1, mesh=mesh(2, 2))


def test_frames_and_motion_blur_over_a_frame_mesh():
    from raytracer_tpu_torch.animation import frame_mesh, render_frames

    fm = frame_mesh([CPU] * 3)
    assert fm.shape == {"frame": 3}
    blur = lambda: torch_features.motion_blur(16, 12)
    a = T.render_motion_blur(blur(), 8, torch_features.fly, slices=4,
                             output="linear", mesh=fm)
    b = T.render_motion_blur(blur(), 8, torch_features.fly, slices=4,
                             output="linear", device=CPU)
    assert np.array_equal(a, b)
    times = [0.0, 0.5, 1.0, 1.5]
    fa = list(render_frames(blur(), 1, times, torch_features.fly, mesh=fm))
    fb = list(render_frames(blur(), 1, times, torch_features.fly, device=CPU))
    assert all(np.array_equal(x, y) for x, y in zip(fa, fb)) and len(fa) == 4
