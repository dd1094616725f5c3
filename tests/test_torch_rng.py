"""The port's sampling modules (core/rng.py, core/safemath.py,
utils/random.py) against the JAX package's, and the samplers'
distributions against their pdfs.

The port draws from a torch.Generator and the JAX package from threefry
keys, so draws are compared only through what draws nothing: the bases,
the pdfs, the cap geometry, the environment alias lookup and every
sampler given explicit `uniforms`, at rtol 1e-6 / atol 1e-6 (a pdf with a
caps term also allows one float32 step of cos_max, see close_caps_pdf).  The draws
themselves are held by their distributions: each pdf integrates to 1 over
the sphere, and each sampler's samples follow its pdf, within 3 standard
errors of a seeded Monte-Carlo estimate.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import rng as jrng
from raytracer_tpu.core import safemath as jsafe
from raytracer_tpu.core.compile import _env_is_tables
from raytracer_tpu_torch.core import rng, safemath
from raytracer_tpu_torch.utils import random as trandom

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)
KEY = jax.random.PRNGKey(0)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _inputs(seed=3, n=N, k=2):
    r = np.random.default_rng(seed)
    normal = _unit(r.normal(size=(n, 3))).astype(np.float32)
    # a share of normals past the basis' |x| > 0.9 switch
    normal[: n // 8] = _unit(normal[: n // 8] + [4.0, 0.0, 0.0])
    direction = _unit(r.normal(size=(n, 3))).astype(np.float32)
    origin = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    centers = np.array([[0.0, 3.0, 0.0], [2.5, -1.0, 1.0]][:k], np.float32)
    radii = np.array([0.8, 0.5][:k], np.float32)
    u = r.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    return normal, direction, origin, centers, radii, u


def _env_tables():
    r = np.random.default_rng(11)
    env = r.uniform(0.05, 1.0, (12, 24, 3)).astype(np.float32)
    env[2:4, 5:9] = 40.0                     # a sun
    prob, alias, pdf, hw = _env_is_tables(env)
    return np.asarray(prob), np.asarray(alias), np.asarray(pdf), hw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def close_caps_pdf(got, want, cos_max, share):
    """A pdf with a caps term share / ((1 - cos_max) 2 pi), within 1e-6
    plus what one float32 rounding step of cos_max moves that term by.
    torch's vectorised CPU sqrt is off by one ulp on ~0.7% of lanes (XLA's
    and CUDA's are correctly rounded), and the cancellation in 1 - cos_max
    multiplies that by cos_max / (1 - cos_max), ~26 for these caps."""
    c = np.asarray(cos_max, np.float64)
    step = share * np.spacing(np.float32(1.0)) / ((1.0 - c) ** 2 * 2 * np.pi)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) <= 1e-6 + 1e-6 * np.abs(want) + step).all()


# ---------------------------------------------------------------------------
# deterministic functions against the JAX package's
# ---------------------------------------------------------------------------


def test_orthonormal_basis_matches_jax():
    normal = _inputs()[0]
    (u, v), (ju, jv) = rng._orthonormal_basis(*_t(normal)), \
        jrng._orthonormal_basis(*_j(normal))
    close(u, ju)
    close(v, jv)
    assert torch.allclose((u * v).sum(-1), torch.zeros(N), atol=1e-6)


def test_pdf_values_match_jax():
    normal, direction, origin, centers, radii, _ = _inputs()
    tn, td, to, tc, tr = _t(normal, direction, origin, centers, radii)
    jn, jd, jo, jc, jr = _j(normal, direction, origin, centers, radii)
    close(rng.cosine_pdf_value(td, tn), jrng.cosine_pdf_value(jd, jn))
    assert rng.hemisphere_pdf_value(td, tn) == pytest.approx(
        float(jrng.hemisphere_pdf_value(jd, jn)), rel=1e-12)
    close(rng.caps_pdf_value(td, to, tc, tr),
          jrng.caps_pdf_value(jd, jo, jc, jr))


def test_caps_geometry_matches_jax():
    _, _, origin, centers, radii, _ = _inputs()
    # origins on and inside a target saturate the cap (cos_max 0)
    origin[:4] = centers[0]
    origin[4:8] = centers[0] + [0.1, 0.0, 0.0]
    ax, cm = rng.caps_geometry(*_t(origin, centers, radii))
    jax_, jcm = jrng.caps_geometry(*_j(origin, centers, radii))
    close(ax, jax_)
    close(cm, jcm)
    assert (cm[:8, 0] == 0).all()


def test_env_alias_sample_and_pdf_match_jax():
    prob, alias, pdf, hw = _env_tables()
    _, direction, _, _, _, u = _inputs()
    d = rng.env_alias_sample(*_t(u[0], u[1], prob, alias), hw)
    jd = jrng.env_alias_sample(*_j(u[0], u[1], prob, alias), hw)
    close(d, jd)
    close(rng.env_pdf_value(*_t(direction, pdf), hw),
          jrng.env_pdf_value(*_j(direction, pdf), hw))


def test_samplers_given_uniforms_match_jax():
    """With `uniforms` the samplers draw nothing but the caps' target
    pick, which is always 0 with one target."""
    normal, _, origin, centers, radii, u = _inputs(k=1)
    tn, to, tc, tr, tu0, tu1, tu2 = _t(normal, origin, centers, radii, *u)
    jn, jo, jc, jr, ju0, ju1, ju2 = _j(normal, origin, centers, radii, *u)
    gen = torch.Generator().manual_seed(1)
    close(rng.cosine_sample(None, tn, uniforms=(tu0, tu1)),
          jrng.cosine_sample(None, jn, uniforms=(ju0, ju1)))
    close(rng.caps_sample(gen, to, tc, tr, uniforms=(tu0, tu1)),
          jrng.caps_sample(KEY, jo, jc, jr, uniforms=(ju0, ju1)))
    cos_max = rng.caps_geometry(to, tc, tr)[1][:, 0]
    for w in (0.5, 0.2):
        d, p = rng.mixed_cosine_caps_sample(gen, tn, to, tc, tr, w,
                                            uniforms=(tu0, tu1, tu2))
        jd, jp = jrng.mixed_cosine_caps_sample(KEY, jn, jo, jc, jr, w,
                                               uniforms=(ju0, ju1, ju2))
        close(d, jd)
        close_caps_pdf(p, jp, cos_max, 1.0 - w)


@pytest.mark.parametrize("caps,env", [(True, False), (False, True),
                                      (True, True)])
def test_mixed_diffuse_sample_given_uniforms_matches_jax(caps, env):
    normal, _, origin, centers, radii, u = _inputs(k=1)
    prob, alias, pdf, hw = _env_tables()
    gen = torch.Generator().manual_seed(2)
    t_env = (*_t(prob, alias, pdf), hw) if env else None
    j_env = (*_j(prob, alias, pdf), hw) if env else None
    tc, tr = _t(centers, radii) if caps else (None, None)
    jc, jr = _j(centers, radii) if caps else (None, None)
    d, p = rng.mixed_diffuse_sample(gen, *_t(normal, origin), tc, tr, t_env,
                                    0.4, uniforms=tuple(_t(*u)))
    jd, jp = jrng.mixed_diffuse_sample(KEY, *_j(normal, origin), jc, jr,
                                       j_env, 0.4, uniforms=tuple(_j(*u)))
    close(d, jd)
    if caps:
        cos_max = rng.caps_geometry(*_t(origin, centers, radii))[1][:, 0]
        close_caps_pdf(p, jp, cos_max, 0.6 / (1 + env))
    else:
        close(p, jp)


def test_safemath_matches_jax_with_finite_gradients():
    x = np.array([-1.0, 0.0, 1e-31, 1e-20, 0.25, 4.0], np.float32)
    v = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0], [1e-20, 0.0, 0.0]],
                 np.float32)
    close(safemath.safe_sqrt(*_t(x)), jsafe.safe_sqrt(*_j(x)))
    close(safemath.safe_norm(*_t(v)), jsafe.safe_norm(*_j(v)))
    close(safemath.safe_norm(*_t(v), keepdim=True),
          jsafe.safe_norm(*_j(v), keepdims=True))
    tx, tv = (a.clone().requires_grad_(True) for a in _t(x, v))
    safemath.safe_sqrt(tx).sum().backward()
    safemath.safe_norm(tv).sum().backward()
    gx = jax.grad(lambda a: jsafe.safe_sqrt(a).sum())(jnp.asarray(x))
    gv = jax.grad(lambda a: jsafe.safe_norm(a).sum())(jnp.asarray(v))
    assert torch.isfinite(tx.grad).all() and torch.isfinite(tv.grad).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv), rtol=1e-6)


# ---------------------------------------------------------------------------
# distributions within the port
# ---------------------------------------------------------------------------

M = 1 << 17


def _within_3se(samples, want):
    samples = samples.double()
    se = samples.std().item() / math.sqrt(samples.numel())
    assert abs(samples.mean().item() - want) < 3 * se, (
        samples.mean().item(), want, se)


def _sphere(seed):
    return rng.random_in_unit_sphere(torch.Generator().manual_seed(seed), (M,))


def test_unit_sphere_and_disk_are_uniform():
    d = _sphere(5)
    assert torch.allclose(d.norm(dim=-1), torch.ones(M), atol=1e-5)
    for c in range(3):                      # E[d_c] = 0, E[d_c^2] = 1/3
        _within_3se(d[:, c], 0.0)
        _within_3se(d[:, c] ** 2, 1.0 / 3.0)
    x, y = rng.random_in_unit_disk(torch.Generator().manual_seed(6), (M,))
    r2 = x * x + y * y
    assert (r2 <= 1.0 + 1e-6).all()
    _within_3se(r2, 0.5)                    # r^2 is uniform on [0, 1]


@pytest.mark.parametrize("pdf", ["cosine", "caps", "env", "mixed"])
def test_pdf_integrates_to_one(pdf):
    """4 pi E[pdf(d)] over uniform directions d is the pdf's integral."""
    d = _sphere(7)
    normal = torch.tensor([0.3, 0.8, -0.52]) / math.sqrt(0.09 + 0.64 + 0.2704)
    normal = normal.expand(M, 3)
    origin = torch.zeros(M, 3)
    centers, radii = _t(*_inputs()[3:5])
    prob, alias, tab, hw = _env_tables()
    if pdf == "cosine":
        p = rng.cosine_pdf_value(d, normal)
    elif pdf == "caps":
        p = rng.caps_pdf_value(d, origin, centers, radii)
    elif pdf == "env":
        p = rng.env_pdf_value(d, torch.from_numpy(tab), hw)
    else:
        p = (0.3 * rng.cosine_pdf_value(d, normal)
             + 0.7 * rng.caps_pdf_value(d, origin, centers, radii))
    _within_3se(4.0 * math.pi * p, 1.0)


def test_cosine_and_hemisphere_samples_follow_their_pdfs():
    g = torch.Generator().manual_seed(8)
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(M, 3)
    cos_t = (rng.cosine_sample(g, normal) * normal).sum(-1)
    assert (cos_t >= -1e-6).all()
    _within_3se(cos_t, 2.0 / 3.0)           # E[cos] under cos / pi
    cos_h = (rng.hemisphere_sample(g, normal) * normal).sum(-1)
    assert (cos_h >= 0).all()
    _within_3se(cos_h, 0.5)                 # E[cos] under 1 / 2pi


def test_caps_and_cap_samples_follow_their_pdfs():
    """Every caps sample lies in a cap, each target is picked 1 / K of the
    time, and within a cap cos(theta) is uniform on [cos_max, 1]."""
    g = torch.Generator().manual_seed(9)
    centers, radii = _t(*_inputs()[3:5])
    origin = torch.zeros(M, 3)
    d = rng.caps_sample(g, origin, centers, radii)
    ax, cm = rng.caps_geometry(origin, centers, radii)
    inside = (d[:, None, :] * ax).sum(-1) >= cm - 1e-6
    assert inside.any(dim=1).all()
    _within_3se(inside[:, 0].float(), 0.5)
    cos_max = torch.full((M,), 0.8)
    z = torch.tensor([0.0, 1.0, 0.0]).expand(M, 3)
    c = (rng.spherical_cap_sample(g, cos_max, z) * z).sum(-1)
    assert (c >= 0.8 - 1e-6).all()
    _within_3se(c, 0.9)


def test_env_samples_follow_the_env_pdf():
    """E[1 / pdf(d)] over d drawn from the tables is the sphere's 4 pi
    (the map is positive everywhere, so the pdf has full support)."""
    prob, alias, tab, hw = _env_tables()
    g = torch.Generator().manual_seed(10)
    u1, u2 = torch.rand(M, generator=g), torch.rand(M, generator=g)
    d = rng.env_alias_sample(u1, u2, *_t(prob, alias), hw)
    assert torch.allclose(d.norm(dim=-1), torch.ones(M), atol=1e-5)
    p = rng.env_pdf_value(d, torch.from_numpy(tab), hw)
    _within_3se(1.0 / p, 4.0 * math.pi)


def test_seeded_generator_repeats_draws():
    normal, _, origin, centers, radii, _ = _inputs()
    args = _t(normal, origin, centers, radii)
    a = rng.mixed_cosine_caps_sample(torch.Generator().manual_seed(4), *args, 0.5)
    b = rng.mixed_cosine_caps_sample(torch.Generator().manual_seed(4), *args, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the PDF classes (utils/random.py)
# ---------------------------------------------------------------------------


def test_pdf_classes_sample_and_evaluate():
    import raytracer_tpu_torch as T

    normal = torch.tensor([0.0, 1.0, 0.0]).expand(N, 3)
    origin = torch.zeros(N, 3)
    lights = [T.Sphere(center=T.vec3(0, 3, 0), radius=0.8,
                       material=T.Emissive(color=T.rgb(1, 1, 1)))]
    pdfs = [T.hemisphere_pdf(N, normal), T.cosine_pdf(N, normal),
            T.spherical_caps_pdf(N, origin, lights)]
    pdfs.append(T.mixed_pdf(N, pdfs[1], pdfs[2], 0.3))
    for pdf in pdfs:
        d1 = pdf.generate(torch.Generator().manual_seed(3))
        d2 = pdf.generate(torch.Generator().manual_seed(3))
        assert d1.shape == (N, 3) and torch.equal(d1, d2)
        assert torch.allclose(d1.norm(dim=-1), torch.ones(N), atol=1e-5)
        v = torch.as_tensor(pdf.value(d1))
        assert torch.isfinite(v).all() and (v > 0).all()
    # a (centers, radii) pair of tensors is the same target
    pair = T.spherical_caps_pdf(N, origin, (torch.tensor([[0.0, 3.0, 0.0]]),
                                            torch.tensor([0.8])))
    d = pdfs[2].generate(torch.Generator().manual_seed(5))
    assert torch.equal(pair.value(d), pdfs[2].value(d))
    d, p = T.random_in_unit_spherical_caps(torch.Generator().manual_seed(6),
                                           N, origin, lights)
    assert (p > 0).all()
    assert T.random_in_unit_spherical_cap is rng.spherical_cap_sample
    with pytest.raises(NotImplementedError):
        trandom.PDF().generate(None)
