"""ODS stereo 360 (vr.py) and animation / motion blur (animation.py)
against the JAX package's.

ODS rays from given jitter draw nothing: the JAX package's `_ods_samples`
runs eagerly with its `trace` replaced by a recorder, and the port's
`_ods_rays` gets the same uniforms the JAX function draws from its key
(measured max abs difference 6.0e-8 on directions, 7.5e-9 on
origins: XLA:CPU approximates cos and sin; held at atol 1e-6).  The
stereo packing holds exactly on given eyes; whole ODS frames, motion-blurred frames and
animation frames hold by a z-test over seeds.  Within the port: ipd=0
eyes bit-equal, repeats bit-equal, a one-chunk frame 0 equal to
Scene.render's, each motion-blur slice one upload and its chunks on the
record kernel's route (its plain version here), the structure check
raising where the JAX package's does.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch.core.compile import compile_wavefront

# the packages export functions under their modules' names
janim = importlib.import_module("raytracer_tpu.animation")
tanim = importlib.import_module("raytracer_tpu_torch.animation")
jvr = importlib.import_module("raytracer_tpu.vr")
tvr = importlib.import_module("raytracer_tpu_torch.vr")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import one_torch_thread  # noqa: E402,F401
from test_torch_wavefront_render import _z_hold  # noqa: E402
import torch_features  # noqa: E402


def vr(m):
    return torch_features.vr(24, 12, m=m)


@pytest.mark.parametrize("eye_sign,ipd", [(-1.0, 0.2), (1.0, 0.064),
                                          (1.0, 0.0)],
                         ids=["left", "right", "zero_ipd"])
def test_ods_rays_per_ray(eye_sign, ipd, monkeypatch):
    sc = vr(J)
    js, jd = jax_compile(sc)
    W, H, spp = 24, 12, 3
    seen = {}

    def record(key, origin, d, *a, **k):
        seen["o"], seen["d"] = np.asarray(origin), np.asarray(d)
        return jnp.zeros_like(origin), {}

    monkeypatch.setattr(jvr, "trace", record)
    key = jax.random.PRNGKey(7)
    cam = sc.camera.params()
    fwd = np.asarray(cam.fwd)
    phi0 = np.float32(np.arctan2(fwd[2], fwd[0]))
    origin0 = np.array(cam.origin, np.float32)
    jvr._ods_samples(key, jd, jnp.asarray(origin0), jnp.float32(phi0),
                     jnp.float32(ipd / 2), jnp.float32(eye_sign), W, H, spp,
                     js, J.RenderSettings(max_bounces=2))
    k_jx, k_jy, _ = jax.random.split(key, 3)
    n = spp * W * H
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (n,), jnp.float32)))
         for k in (k_jx, k_jy)]
    o, d = tvr._ods_rays(u[0], u[1], torch.from_numpy(origin0), float(phi0),
                         float(np.float32(ipd / 2)), eye_sign, W, H, spp)
    np.testing.assert_allclose(o.numpy(), seen["o"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), seen["d"], rtol=0, atol=1e-6)


def test_stereo_packing_against_jax(monkeypatch):
    """Both packages' layouts on the same two eyes: each eye's radiance
    sum is replaced by a fixed gradient that depends on the eye."""
    W, H = 24, 12
    base = np.linspace(0.0, 1.5, W * H * 3, dtype=np.float32).reshape(-1, 3)

    def eye(sign):
        return base * (1.3 if sign > 0 else 0.7)

    monkeypatch.setattr(jvr, "_ods_chunk",
                        lambda key, data, o, p, h, sign, W_, H_, s, *a:
                        jnp.asarray(eye(float(sign))) * s)
    monkeypatch.setattr(tvr, "_ods_samples",
                        lambda g, data, o, p, h, sign, W_, H_, s, *a, **k:
                        torch.from_numpy(eye(sign)) * s)
    for layout in ("top-bottom", "side-by-side", "separate"):
        for output in ("linear", "np"):
            a = jvr.render_ods(vr(J), 2, layout=layout, output=output)
            b = tvr.render_ods(vr(T), 2, layout=layout, output=output,
                               device="cpu")
            a = a if layout != "separate" else np.stack(a)
            b = b if layout != "separate" else np.stack(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            if output == "linear":
                assert np.array_equal(a, b), layout
            else:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    a = jvr.render_ods(vr(J), 2, layout="anaglyph", output="np")
    b = tvr.render_ods(vr(T), 2, layout="anaglyph", output="np", device="cpu")
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    img = tvr.render_ods(vr(T), 2, device="cpu")
    assert img.size == (24, 24)


def test_ods_frames_against_jax():
    va = [np.asarray(J.render_ods(vr(J), 2, ipd=0.2, seed=s,
                                  output="linear")).mean() for s in (0, 1, 2)]
    vb = [T.render_ods(vr(T), 2, ipd=0.2, seed=s, output="linear",
                       device="cpu").mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_ods_eyes_and_checks():
    left, right = T.render_ods(vr(T), 2, ipd=0.0, layout="separate",
                               output="linear", seed=3, device="cpu")
    assert np.array_equal(left, right)
    left, right = T.render_ods(vr(T), 2, ipd=0.3, layout="separate",
                               output="linear", seed=3, device="cpu")
    assert not np.array_equal(left, right) and np.isfinite(left).all()
    again = T.render_ods(vr(T), 2, ipd=0.3, layout="separate",
                         output="linear", seed=3, device="cpu")
    assert np.array_equal(again[0], left) and np.array_equal(again[1], right)
    assert vr(T).render_ods(2, width=16, output="np",
                            device="cpu").shape == (16, 16, 3)
    with pytest.raises(ValueError, match="layout"):
        T.render_ods(vr(T), 1, layout="over-under", device="cpu")
    with pytest.raises(ValueError, match="anaglyph"):
        T.render_ods(vr(T), 1, layout="anaglyph", output="linear",
                     device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        T.render_ods(vr(T), 1, mesh=object(), device="cpu")


def blur(m):
    return torch_features.motion_blur(16, 12, m=m)


def test_motion_blur_against_jax():
    kw = dict(slices=2, output="linear")
    va = [np.asarray(J.render_motion_blur(blur(J), 4, torch_features.fly,
                                          seed=s, **kw)).mean()
          for s in (0, 1, 2)]
    vb = [T.render_motion_blur(blur(T), 4, torch_features.fly, seed=s,
                               device="cpu", **kw).mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_motion_blur_slices_take_the_record_route(monkeypatch):
    """Every slice is one compile and upload, its chunks go through the
    record kernel's wrapper (its plain version on the CPU), and two
    renders of one seed are bit-equal."""
    calls, uploads = [], []
    real_chunk = tanim.record_trace_chunk
    real_tables = tanim._FramePlan.frame_tables

    def chunk(*args):
        calls.append(tuple(args[4:7]))
        return real_chunk(*args)

    def tables(self, t):
        uploads.append(t)
        return real_tables(self, t)

    monkeypatch.setattr(tanim, "record_trace_chunk", chunk)
    monkeypatch.setattr(tanim._FramePlan, "frame_tables", tables)
    a = T.render_motion_blur(blur(T), 8, torch_features.fly, slices=4,
                             output="linear", device="cpu")
    sc = blur(T)
    static = compile_wavefront(sc)[0]
    assert static.pallas_tex_ok and not static.pallas_ok
    plan = tanim._FramePlan(sc, 2, torch_features.fly, 0.125, 0, "cpu", 4)
    assert plan.path == "record"
    assert uploads[:4] == [0.125, 0.375, 0.625, 0.875]
    assert len(calls) == 4 * plan.n_chunks
    assert calls[0] == (16, 12, plan.chunk)
    b = T.render_motion_blur(blur(T), 8, torch_features.fly, slices=4,
                             output="linear", device="cpu")
    assert np.array_equal(a, b) and np.isfinite(a).all()
    img = T.render_motion_blur(blur(T), 2, torch_features.fly, slices=2,
                               device="cpu")
    assert img.size == (16, 12)


def emissive_ball(m):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=24, screen_height=16)
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(1, 1, 1)),
                    center=m.vec3(-0.8, 0, -1), radius=0.3))
    return sc


def slide(scene, t):
    scene.scene_primitives[0].center = np.asarray(
        [-0.8 + 1.6 * t, 0.0, -1.0], np.float32)


def test_render_frames_against_jax_and_scene_render():
    """tests/test_animation.py's criteria: frame 0 is Scene.render's frame
    bit for bit (one chunk), the blob sweeps across the frames; and
    against the JAX frames, pixel for pixel but at the silhouettes."""
    times = [0.0, 0.5, 1.0]
    got = list(T.animation.render_frames(emissive_ball(T), 2, times, slide,
                                         device="cpu"))
    want = list(janim.render_frames(emissive_ball(J), 2, times, slide))
    sc = emissive_ball(T)
    slide(sc, 0.0)
    assert np.array_equal(got[0], np.asarray(sc.render(2, device="cpu")))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
        assert (diff > 0).mean() < 0.05
    cx = [np.where(f.sum(-1) > 100)[1].mean() for f in got]
    assert cx[0] < cx[1] < cx[2]


def test_structure_change_raises_as_jax():
    """An object added after the first time point raises in both
    packages, at the same time point."""
    def grow(scene, t):
        slide(scene, t)
        if t > 0.3 and len(scene.scene_primitives) == 1:
            m = J if type(scene).__module__.startswith("raytracer_tpu.") else T
            scene.add(m.Sphere(material=m.Emissive(color=m.rgb(1, 0, 0)),
                               center=m.vec3(0.5, 0.5, -1), radius=0.2))

    for m in (J, T):
        kw = {} if m is J else {"device": "cpu"}
        with pytest.raises(ValueError, match="STRUCTURE"):
            list((janim if m is J else tanim).render_frames(
                emissive_ball(m), 1, [0.0, 0.2, 0.5], grow, **kw))
        with pytest.raises(ValueError, match="STRUCTURE"):
            m.render_motion_blur(emissive_ball(m), 2, grow, slices=2, **kw)


def test_create_animation_and_checks(tmp_path):
    fps = T.create_animation(emissive_ball(T), 1, 4, 0.0, 0.5, slide, "ball",
                             frames_dir=tmp_path / "frames", device="cpu")
    files = sorted(p.name for p in (tmp_path / "frames").iterdir())
    assert files == ["ball_0.png", "ball_1.png"] and fps > 0
    path = str(tmp_path / "ball.avi")
    try:
        import cv2  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            T.create_animation_using_opencv(emissive_ball(T), 1, 4, 0.0, 0.5,
                                            slide, path, device="cpu")
    else:
        T.create_animation_using_opencv(emissive_ball(T), 1, 4, 0.0, 0.5,
                                        slide, path, device="cpu")
        assert Path(path).stat().st_size > 0
    for fn in (lambda: list(T.animation.render_frames(
            emissive_ball(T), 1, [0.0], slide, mesh=object(), device="cpu")),
               lambda: T.render_motion_blur(emissive_ball(T), 1, slide,
                                            mesh=object(), device="cpu")):
        with pytest.raises(ValueError, match="mesh"):
            fn()
