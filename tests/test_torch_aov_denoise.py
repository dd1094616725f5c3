"""The AOV pass (core/aov.py) and the denoiser (denoise.py) against the
JAX package's.

AOV planes from given rays draw nothing, so they hold per ray: the JAX
package's `_aov_chunk` is run eagerly with its camera replaced by the
same rays the port's `_aov_planes` gets.  Measured on Cornell, a
textured scene with an environment and a clustered mesh: obj_id,
coverage, emission coverage and albedo equal; depth and position within
rtol 1e-5 (measured: at most 4.9e-4 on Cornell's depth sums near 2,000,
an ulp or two where XLA:CPU's FMA moves a hit), normals within atol 1e-5
(measured 2.1e-6).  The ambient-occlusion plane and whole
render_aovs / render_denoised frames draw, and hold by a z-test over
seeds.  The denoiser draws nothing and holds on the same numpy-seeded
frame, planes and variance: measured, the port's output differs from
JAX's by at most 4.0e-7 relative (6.0e-7 absolute on values up to ~3;
XLA:CPU approximates exp, and each tap's weight is exp of sums of
squares), so the hold is rtol 1e-5 / atol 1e-6, with and without the
variance, emissive freezing and demodulation.
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
from raytracer_tpu.core import aov as jaov
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch.core import aov as taov
from raytracer_tpu_torch.core.compile import compile_wavefront

# the packages export a function `denoise` under their module's name
jden = importlib.import_module("raytracer_tpu.denoise")
tden = importlib.import_module("raytracer_tpu_torch.denoise")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import cornell, textured_scene  # noqa: E402
from test_torch_wavefront_compile import (jax_native,  # noqa: E402,F401
                                          one_torch_thread)
from test_torch_wavefront_render import _z_hold  # noqa: E402
import torch_mesh  # noqa: E402


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("aov_obj")


def icosphere(m, d):
    """examples/example_mesh.py at 16x12: the clustered sweep."""
    return torch_mesh.icosphere(16, 12, m=m, obj_dir=d)


SPP = 4


def _rays(sc, n, seed=0):
    """n rays from the camera through random points of its frame."""
    cam = sc.camera.params()
    r = np.random.default_rng(seed)
    ox = r.uniform(-0.5, 0.5, (n, 1)) * np.asarray(cam.cam_w)
    oy = r.uniform(-0.5, 0.5, (n, 1)) * np.asarray(cam.cam_h)
    d = (np.asarray(cam.fwd) * np.asarray(cam.focal)
         + ox * np.asarray(cam.right) + oy * np.asarray(cam.up))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(np.asarray(cam.origin, np.float32), (n, 1))
    return o, d


@pytest.mark.parametrize("build", [cornell, textured_scene, icosphere],
                         ids=["cornell", "textured", "icosphere"])
def test_aov_planes_per_ray(obj_dir, build, monkeypatch):
    mk = (lambda m: build(m, obj_dir)) if build is icosphere else build
    jsc = mk(J)
    W, H = jsc.camera.screen_width, jsc.camera.screen_height
    O, D = _rays(jsc, SPP * W * H)
    monkeypatch.setattr(jaov, "generate_rays",
                        lambda *a, **k: (jnp.asarray(O), jnp.asarray(D)))
    js, jd = jax_compile(jsc)
    want = jaov._aov_chunk.__wrapped__(jax.random.PRNGKey(0), jd,
                                       jsc.camera.params(), js, W, H, SPP)
    static, data = compile_wavefront(mk(T))
    got = taov._aov_planes(torch.from_numpy(O), torch.from_numpy(D), data,
                           static, SPP, W * H)
    assert set(got) == set(want)
    for k in ("obj_id", "coverage", "emissive"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("depth", "normal", "albedo", "position"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert (np.asarray(want["coverage"]) > 0).mean() > 0.3


def mixed_types(m):
    """The textured scene with a diffuse, a refractive and an emissive
    sphere in view: five material types."""
    sc = textured_scene(m)
    for x, mat in ((-0.5, m.Diffuse(diff_color=m.rgb(0.2, 0.6, 0.3))),
                   (0.0, m.Refractive(n=m.vec3(1.5, 1.5, 1.5))),
                   (0.5, m.Emissive(color=m.rgb(3, 2, 1)))):
        sc.add(m.Sphere(material=mat, center=m.vec3(x, 0.1, -1.5),
                        radius=0.2))
    return sc


def test_albedo_of_every_material_type():
    """Diffuse, glossy and emissive base colours, the environment's
    display texture, refractive white, against the JAX helper on the JAX
    package's own hits."""
    sc = mixed_types(J)
    js, jd = jax_compile(sc)
    O, D = _rays(sc, 2048, seed=3)
    t, orient, P, N, uv, obj = jaov._first_hit_impl(jnp.asarray(O),
                                                    jnp.asarray(D), jd, js)
    packed = np.asarray(jd.obj.packed)[np.asarray(obj)]
    mt, slot = packed & 7, (packed >> 3) & 0x3FF
    want = jaov._albedo_at_hit(jnp.asarray(mt), jnp.asarray(slot), uv, jd, js)
    static, data = compile_wavefront(mixed_types(T))
    got = taov._albedo_at_hit(torch.from_numpy(mt.astype(np.int32)),
                              torch.from_numpy(slot.astype(np.int32)),
                              torch.from_numpy(np.array(uv)), data, static)
    assert len(set(mt.tolist())) == 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_render_aovs_against_jax():
    """Whole passes with ambient occlusion: the planes' means within 4
    standard errors over seeds, obj_id's set of ids equal."""
    planes = ("depth", "coverage", "ao", "emissive")
    va = {k: [] for k in planes}
    vb = {k: [] for k in planes}
    for s in (0, 1, 2):
        a = J.render_aovs(cornell(J), 2, seed=s, ao_samples=2, ao_radius=0.5)
        b = T.render_aovs(cornell(T), 2, seed=s, ao_samples=2, ao_radius=0.5,
                          device="cpu")
        for k in planes:
            va[k].append(float(np.mean(a[k])))
            vb[k].append(float(np.mean(b[k])))
        assert set(np.unique(a["obj_id"])) == set(np.unique(b["obj_id"]))
        assert b["normal"].shape == a["normal"].shape
    for k in planes:
        _z_hold(va[k], vb[k])
    assert 0.0 < np.mean(vb["ao"]) < 1.0
    with pytest.raises(ValueError, match="mesh"):
        T.render_aovs(cornell(T), 1, mesh=object(), device="cpu")


def _frame(seed=0, H=20, W=24):
    r = np.random.default_rng(seed)
    img = r.gamma(1.5, 0.3, (H, W, 3)).astype(np.float32)
    n = r.normal(size=(H, W, 3))
    n[:, W // 2:] = [0, 0, 1]              # a flat half, a noisy half
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    aovs = dict(albedo=r.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32),
                normal=n,
                depth=r.uniform(1.0, 5.0, (H, W)).astype(np.float32),
                emissive=(r.uniform(size=(H, W)) > 0.97).astype(np.float32))
    var = r.uniform(0.0, 0.05, (H, W, 3)).astype(np.float32)
    return img, aovs, var


OPTS = [dict(), dict(variance=True), dict(no_emissive=True),
        dict(demodulate_albedo=False, iterations=2, sigma_color=1.0)]


@pytest.mark.parametrize("opts", OPTS,
                         ids=["fixed", "variance", "no_emissive", "options"])
def test_denoise_against_jax(opts):
    img, aovs, var = _frame()
    opts = dict(opts)
    if opts.pop("no_emissive", False):
        aovs.pop("emissive")
    variance = var if opts.pop("variance", False) else None
    want = jden.denoise(img, aovs, variance=variance, **opts)
    got = tden.denoise(img, aovs, variance=variance, device="cpu", **opts)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got - img).mean() > 1e-3        # it filtered


def test_gauss3_and_atrous_levels_against_jax():
    r = np.random.default_rng(5)
    x = r.uniform(0, 1, (9, 13)).astype(np.float32)
    np.testing.assert_allclose(tden._gauss3(torch.from_numpy(x)).numpy(),
                               np.asarray(jden._gauss3(jnp.asarray(x))),
                               rtol=0, atol=1e-7)
    img, aovs, var = _frame(seed=2)
    valid = np.ones(img.shape[:2], np.float32)
    want = jden._atrous(jnp.asarray(img), jnp.asarray(aovs["normal"]),
                        jnp.asarray(aovs["depth"]), jnp.asarray(valid), None,
                        3, jnp.float32(4.0), jnp.float32(0.1),
                        jnp.float32(0.1))
    t = lambda a: torch.from_numpy(a)
    got = tden._atrous(t(img), t(aovs["normal"]), t(aovs["depth"]), t(valid),
                       None, 3, 4.0, 0.1, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_denoise_checks_its_inputs():
    img, aovs, var = _frame()
    with pytest.raises(ValueError, match=r"img must be \(H, W, 3\)"):
        tden.denoise(img[..., :2], aovs, device="cpu")
    bad = dict(aovs, depth=aovs["depth"][:-1])
    with pytest.raises(ValueError, match="AOV shapes must match"):
        tden.denoise(img, bad, device="cpu")
    with pytest.raises(ValueError, match="variance shape"):
        tden.denoise(img, aovs, variance=var[:-1], device="cpu")
    # a tensor keeps its device; without a card the default raises
    out = tden.denoise(torch.from_numpy(img), aovs)
    assert out.shape == img.shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tden.denoise(img, aovs)


def test_render_denoised_against_jax():
    """Cornell at 16x16: the port's render_denoised (the solid kernel's
    plain version, the AOV pass, the filter) against the JAX package's,
    image means within 4 standard errors over seeds, both smoother than
    their raw renders."""
    va, vb = [], []
    for s in (0, 1, 2):
        va.append(np.asarray(cornell(J).render_denoised(
            4, seed=s, output="linear")).mean())
        vb.append(cornell(T).render_denoised(4, seed=s, output="linear",
                                             device="cpu").mean())
    _z_hold(va, vb)
    raw = cornell(T).render(4, seed=0, output="linear", device="cpu")
    den = cornell(T).render_denoised(4, seed=0, output="linear", device="cpu")
    tv = lambda a: np.abs(np.diff(a, axis=0)).mean()
    assert tv(den) < tv(raw)
    pil = cornell(T).render_denoised(2, seed=0, device="cpu")
    assert pil.size == (16, 16)
