"""The wavefront through Scene.render against the JAX package's wavefront,
and within the port against the solid kernel's plain version.

The JAX wavefront draws from threefry keys, the port's from a
torch.Generator seeded per chunk, so whole renders agree exactly only
where nothing is drawn (emissive scenes) and statistically elsewhere: a
z-test on the image mean over three seeds, as tests/test_pallas_trace.py
holds the JAX package's three paths against each other (4 standard
errors, floor 0.01 in mean sRGB).  Off the TPU the JAX package's
Scene.render always takes its wavefront.  Also held here: the routing of
use_pallas, the card default, bit-identical repeats and resumes on the
wavefront (with film bands), the render options on the wavefront,
get_raycolor against the JAX package's per ray, averaged over samples,
and the sphere grid's dependence on the last bit of its camera rays (a
fault of the reference that the port keeps, ROADMAP.md §3).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import ray as jray
from raytracer_tpu_torch.core import scene as tscene

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (box_and_plane, cornell, emissive,  # noqa: E402
                               glass, is_diffuse, torch_textured)
from test_torch_wavefront_compile import (grid49, is_targets9,  # noqa: E402,F401
                                          one_torch_thread)
from torch_wavefront import grid  # noqa: E402

NEVER = T.RenderSettings(use_pallas="never")


def example2(m):
    return torch_textured.example2(16, 12, m=m)


def grid46(m):
    """48 objects: inside the solid kernel's gate."""
    return grid(46, 16, 12, m=m)


def _render_t(build, spp, seed, never=True, **kw):
    sc = build(T)
    if never:
        sc.settings = NEVER
    return np.asarray(sc.render(samples_per_pixel=spp, seed=seed, device="cpu",
                                **kw), np.float32) / 255.0


def _render_j(build, spp, seed, **kw):
    return np.asarray(build(J).render(samples_per_pixel=spp, seed=seed, **kw),
                      np.float32) / 255.0


def _z_hold(va, vb):
    va, vb = np.asarray(va), np.asarray(vb)
    se = np.sqrt((va.std() ** 2 + vb.std() ** 2) / len(va))
    assert abs(va.mean() - vb.mean()) < max(4 * se, 0.01), (va, vb, se)


STAT = [(cornell, 24), (glass, 64), (is_diffuse, 64), (example2, 4),
        (grid49, 16), (is_targets9, 8)]


@pytest.mark.parametrize("build,spp", STAT, ids=[b.__name__ for b, _ in STAT])
def test_statistical_against_jax(build, spp):
    va = [_render_j(build, spp, s).mean() for s in (0, 1, 2)]
    vb = [_render_t(build, spp, s).mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_regions_of_the_grid_against_jax():
    """The 49-object grid by image quarter, not only the mean."""
    a = np.mean([_render_j(grid49, 32, s) for s in (0, 1)], axis=0)
    b = np.mean([_render_t(grid49, 32, s) for s in (0, 1)], axis=0)
    H, W = a.shape[:2]
    for ys in (slice(0, H // 2), slice(H // 2, H)):
        for xs in (slice(0, W // 2), slice(W // 2, W)):
            assert abs(a[ys, xs].mean() - b[ys, xs].mean()) < 0.03


@pytest.mark.parametrize("clamp", [None, 0.4])
def test_emissive_equals_jax_exactly(clamp):
    for output in ("linear", "pil"):
        sc = emissive(T)
        sc.settings = NEVER
        got = sc.render(2, seed=3, output=output, clamp=clamp, device="cpu")
        want = emissive(J).render(2, seed=3, output=output, clamp=clamp)
        assert np.array_equal(np.asarray(got), np.asarray(want)), output


def test_silhouettes_against_jax():
    """Box and plane, emissive: only the edge pixels can differ, by the
    jitter the two sides draw differently."""
    a = _render_j(box_and_plane, 64, 0)
    b = _render_t(box_and_plane, 64, 0)
    assert np.abs(a - b).mean() < 0.01
    assert np.abs(a - b).max() < 0.35


@pytest.mark.parametrize("build,spp", [(cornell, 24), (grid46, 16)],
                         ids=["cornell", "grid46"])
def test_wavefront_against_the_solid_kernels_plain_version(build, spp):
    """Within the port, on the CPU: the wavefront (use_pallas="never")
    against the solid kernel's plain version ("auto")."""
    assert build(T)._settings_for_render()[0].pallas_ok
    va = [_render_t(build, spp, s, never=False).mean() for s in (0, 1, 2)]
    vb = [_render_t(build, spp, s).mean() for s in (0, 1, 2)]
    _z_hold(va, vb)


def test_card_default_and_routing():
    """No device means the card, which raises here; nothing falls back
    to the CPU.  Past the gate "auto" renders on the wavefront and
    "always" raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would use it")
    sc = grid49(T)
    ray = T.Ray(np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32))
    for call in (lambda: sc.render(1), lambda: sc.get_distances(),
                 lambda: T.get_raycolor(ray, sc), lambda: T.get_distances(ray, sc),
                 lambda: T.first_hit(ray, sc)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    img, stats = sc.render(2, device="cpu", output="linear", return_stats=True)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    # every path is traced at least once
    assert stats["rays_traced"] >= 2 * 16 * 12 and stats["samples"] == 2
    sc.settings = T.RenderSettings(use_pallas="always")
    with pytest.raises(ValueError, match="outside both kernels' gates"):
        sc.render(1, device="cpu")


def test_repeat_and_resume_are_bit_identical(tmp_path, monkeypatch):
    """The same seed gives the same image; a render resumed from a
    checkpoint equals the uninterrupted one bit for bit; both also with
    film bands (a ray cap below one chunk's rays)."""
    def render(**kw):
        sc = grid49(T)
        return sc.render(8, seed=5, batch_size=2, device="cpu",
                         output="linear", **kw)

    full = render()
    assert np.array_equal(full, render())
    ck = tmp_path / "ck.npz"
    half = grid49(T).render(4, seed=5, batch_size=2, device="cpu",
                            output="linear", checkpoint_path=ck,
                            checkpoint_every=1)
    assert half.shape == full.shape
    resumed = render(checkpoint_path=ck)
    assert np.array_equal(resumed, full)
    assert int(np.load(ck)["chunks_done"]) == 4

    # bands of 5 rows: 16 x 12 x 2 rays a chunk against a cap of 160
    monkeypatch.setattr(tscene, "MAX_RAYS_PER_CHUNK", 160)
    banded = render()
    assert np.array_equal(banded, render())
    assert not np.array_equal(banded, full)
    assert abs(banded.mean() - full.mean()) < 0.1 * full.mean()
    ck2 = tmp_path / "ck2.npz"
    grid49(T).render(4, seed=5, batch_size=2, device="cpu", output="linear",
                     checkpoint_path=ck2, checkpoint_every=1)
    assert np.array_equal(render(checkpoint_path=ck2), banded)


def test_render_options_on_the_wavefront(tmp_path):
    sc = grid49(T)
    plain = sc.render(8, seed=1, batch_size=2, device="cpu", output="linear")
    lin, var = sc.render(8, seed=1, batch_size=2, device="cpu", output="linear",
                         with_variance=True)
    assert np.array_equal(lin, plain)
    assert var.shape == plain.shape and (var >= 0).all() and var.max() > 0
    clamped = sc.render(8, seed=1, batch_size=2, device="cpu", output="linear",
                        clamp=0.2)
    assert clamped.max() <= 0.2 + 1e-6
    _, stats = sc.render(32, seed=1, batch_size=2, device="cpu", output="linear",
                         target_noise=1.0, noise_check_every=2,
                         return_stats=True)
    assert stats["samples"] == 4 and stats["noise_q99"] <= 1.0
    prev = tmp_path / "p.png"
    img = sc.render(4, seed=1, batch_size=2, device="cpu", preview_path=prev,
                    preview_every=1)
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(prev)), np.asarray(img))


def test_get_raycolor_against_jax_per_ray():
    """Eight rays of the IS diffuse scene, each repeated 4096 times: the
    mean radiance per ray agrees with the JAX package's within 4 standard
    errors of the two means (floor 0.01)."""
    rng = np.random.default_rng(3)
    O = np.tile(np.array([[0, 1, 0.3]], np.float32), (8, 1))
    D = np.stack([rng.uniform(-0.3, 0.3, 8), -np.ones(8), rng.uniform(-0.6, 0.0, 8)],
                 axis=1)
    D = (D / np.linalg.norm(D, axis=1, keepdims=True)).astype(np.float32)
    reps = 4096
    Ob, Db = np.repeat(O, reps, axis=0), np.repeat(D, reps, axis=0)
    got = T.get_raycolor(T.Ray(Ob, Db), is_diffuse(T), seed=2,
                         device="cpu").numpy().reshape(8, reps, 3)
    want = np.asarray(jray.get_raycolor(J.Ray(jnp.asarray(Ob), jnp.asarray(Db)),
                                        is_diffuse(J), seed=2)).reshape(8, reps, 3)
    se = np.sqrt((got.std(1) ** 2 + want.std(1) ** 2) / reps)
    diff = np.abs(got.mean(1) - want.mean(1))
    assert (diff < np.maximum(4 * se, 0.01)).all(), (diff, se)
    # a medium given per bundle, and a seed that repeats
    again = T.get_raycolor(T.Ray(Ob, Db, n=np.complex64(1.0 + 0j) * np.ones(3)),
                           is_diffuse(T), seed=2, device="cpu").numpy()
    assert np.array_equal(again.reshape(8, reps, 3), got)


def test_sphere_grid_depends_on_last_bit_ray_rounding(monkeypatch):
    """A fault of the reference the port keeps (ROADMAP.md §3): the sphere
    test takes tca = -D.oc as exact only for |D| = 1, so from afar a
    last-bit norm error moves a hit past the next ray's nudge.  Multiplying
    every camera direction by 1 / sqrt(|D|^2) once more darkens the sphere
    grid by more than 1% (more of its continuations hit their own sphere
    again) and leaves the Cornell box, mostly planes, as it was."""
    gen = tscene.generate_rays

    def renormalised(*a, **k):
        O, D = gen(*a, **k)
        s = D[:, 0] * D[:, 0] + D[:, 1] * D[:, 1] + D[:, 2] * D[:, 2]
        return O, D * (1.0 / torch.sqrt(s))[:, None]

    def means(build, W, H, spp):
        out = []
        for s in range(4):
            sc = build(W, H)
            sc.settings = NEVER
            out.append(float(sc.render(spp, seed=s, device="cpu",
                                       output="linear").mean()))
        return np.asarray(out)

    grid46 = lambda W, H: grid(46, W, H)
    cases = ((grid46, 40, 30, 32), (lambda W, H: cornell(T), 16, 16, 4))
    plain = [means(b, *a) for b, *a in cases]
    monkeypatch.setattr(tscene, "generate_rays", renormalised)
    moved = [means(b, *a) for b, *a in cases]
    shift = [(m - p).mean() / p.mean() for m, p in zip(moved, plain)]
    assert shift[0] < -0.01, shift
    assert abs(shift[1]) < 1e-3, shift


def test_jax_sphere_grid_depends_on_last_bit_ray_rounding(monkeypatch):
    """The same fault in the JAX package's own wavefront, so it is the
    reference's and not the port's: multiplying its camera directions by
    1 / sqrt(|D|^2) once more moves its sphere grid's mean by more than
    0.5% (the same seeds, so the same draws: here it brightens) and leaves
    the Cornell box as it was.  Which way the image moves depends on how
    the unchanged rays were rounded."""
    import jax
    from raytracer_tpu.core import scene as jscene

    gen = jscene.generate_rays

    def renormalised(*a, **k):
        O, D = gen(*a, **k)
        s = D[:, 0] * D[:, 0] + D[:, 1] * D[:, 1] + D[:, 2] * D[:, 2]
        return O, D * (1.0 / jnp.sqrt(s))[:, None]

    def means(build, spp):
        return np.asarray([float(np.asarray(build().render(
            spp, seed=s, output="linear")).mean()) for s in range(4)])

    cases = ((lambda: grid(46, 40, 30, m=J), 32), (lambda: cornell(J), 4))
    plain = [means(*c) for c in cases]
    monkeypatch.setattr(jscene, "generate_rays", renormalised)
    jax.clear_caches()      # the jitted chunks were traced with the plain rays
    try:
        moved = [means(*c) for c in cases]
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    shift = [(m - p).mean() / p.mean() for m, p in zip(moved, plain)]
    assert abs(shift[0]) > 0.005, shift
    assert abs(shift[1]) < 1e-3, shift
