"""Scene.render's options around the chunk loop in the port: checkpoints
and resume, adaptive sampling, the variance of the mean, previews,
progress lines, the profiler trace, render_array and render_environment.

Held against the JAX package where both compute the same thing from the
same numbers (`_noise_q99`, the variance formula, the checkpoint file, the
environment's row order), and within the port by the JAX tests' own
properties (tests/test_adaptive.py, test_preview.py, test_clamp.py,
test_equirect.py): the two packages seed their chunks differently, so
whole renders agree only statistically.  The tests that need the JAX
package skip without it, and the `cuda` tests without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_scene_features.py
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core import scene as tscene
from raytracer_tpu_torch.core.camera import projection_mask
from raytracer_tpu_torch.core.scene import chunk_seeds

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import cornell  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package, or a skip where it cannot be imported."""
    return pytest.importorskip("raytracer_tpu")


def noisy(W=24, H=24, projection="pinhole"):
    """tests/test_adaptive.py's scene: a diffuse sphere lit by an emissive
    panel, with real Monte-Carlo variance."""
    sc = T.Scene(ambient_color=T.rgb(0, 0, 0))
    sc.add_Camera(look_from=T.vec3(0, 0, 5), look_at=T.vec3(0, 0, 0),
                  screen_width=W, screen_height=H, field_of_view=30,
                  projection=projection)
    sc.add(T.Sphere(material=T.Diffuse(diff_color=T.rgb(0.7, 0.7, 0.7),
                                       diffuse_rays=1),
                    center=T.vec3(0, 0, 0), radius=1.0))
    sc.add(T.Plane(material=T.Emissive(color=T.rgb(4, 4, 4)),
                   center=T.vec3(0, 3, 0), width=4.0, height=4.0,
                   u_axis=T.vec3(1, 0, 0), v_axis=T.vec3(0, 0, 1)))
    return sc


def render(sc, spp, **kw):
    return sc.render(spp, device="cpu", **kw)


# ---------------------------------------------------------------------------
# against the JAX package: the same numbers in, the same numbers out
# ---------------------------------------------------------------------------


def _moments(W=24, H=20, k=6, chunk=4, seed=1):
    """acc and acc2 of k chunks of `chunk` samples, as the render loop
    accumulates them."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(0.7, 0.6, (H * W, 3)).astype(np.float32)
    acc = np.zeros((H * W, 3), np.float32)
    acc2 = np.zeros((H * W, 3), np.float32)
    for _ in range(k):
        L = (base * chunk * rng.gamma(4.0, 0.25, (H * W, 3))).astype(np.float32)
        acc += L
        m = L / np.float32(chunk)
        acc2 += m * m
    return acc, acc2


@pytest.mark.parametrize("projection", ["pinhole", "fisheye"])
@pytest.mark.parametrize("k,chunk", [(2, 4), (6, 4), (12, 26)])
def test_noise_q99_matches_jax(J, projection, k, chunk):
    import jax.numpy as jnp
    from raytracer_tpu.core.scene import _noise_q99 as jax_noise

    W, H = 24, 20
    acc, acc2 = _moments(W, H, k, chunk)
    pmask = projection_mask(projection, W, H)
    got = tscene._noise_q99(torch.from_numpy(acc), torch.from_numpy(acc2),
                            float(k), float(chunk),
                            None if pmask is None else torch.from_numpy(pmask))
    want = jax_noise(jnp.asarray(acc), jnp.asarray(acc2), float(k),
                     float(chunk), pmask)
    assert got.shape == () and np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= 1e-6


def _quantile_input(n, nans, seed=3):
    x = np.random.default_rng(seed).gamma(0.7, 0.02, n).astype(np.float32)
    x[:: max(1, n // max(nans, 1))][:nans] = np.nan
    return x


@pytest.mark.parametrize("skip_nan", [False, True])
@pytest.mark.parametrize("n,nans", [(1, 0), (2, 0), (7, 0), (480, 0),
                                    (480, 3), (7, 7), (160000, 0),
                                    (160000, 2500)])
def test_quantile_matches_jax(J, n, nans, skip_nan):
    """_quantile against jnp.quantile / jnp.nanquantile on the same
    float32 vector: NaNs, all NaN, and a frame's worth of pixels."""
    import jax.numpy as jnp

    x = _quantile_input(n, nans)
    got = tscene._quantile(torch.from_numpy(x), 0.99, skip_nan=skip_nan)
    want = float((jnp.nanquantile if skip_nan else jnp.quantile)(
        jnp.asarray(x), 0.99))
    assert got.shape == () and got.dtype == torch.float32
    assert np.isnan(float(got)) == np.isnan(want)
    if not np.isnan(want):
        assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("n", [1, 2, 7, 520])
def test_variance_formula_matches_jax(n):
    """_variance_of_mean against raytracer_tpu/core/scene.py:643-652,
    written out on the host as the JAX package runs it."""
    rng = np.random.default_rng(n)
    samples = rng.gamma(0.5, 1.0, (n, 64, 3)).astype(np.float32)
    acc, acc_ss = samples.sum(0), (samples * samples).sum(0)
    pil = acc / n
    s2 = np.maximum(acc_ss / n - pil * pil, 0.0)
    if n > 1:
        s2 *= n / (n - 1.0)
    want = s2 / n
    got = tscene._variance_of_mean(torch.from_numpy(acc),
                                   torch.from_numpy(acc_ss), n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_checkpoint_file_has_the_jax_fields_and_loads_there(J, tmp_path):
    from raytracer_tpu.core.scene import _load_checkpoint as jax_load

    ck = tmp_path / "c.npz"
    render(noisy(), 16, batch_size=4, seed=3, target_noise=1e-9,
           checkpoint_path=str(ck), checkpoint_every=2, clamp=3.0)
    z = np.load(ck)
    assert {"acc", "chunks_done", "chunk", "seed", "clamp", "shards", "acc2",
            "stream"} == set(z.files)
    assert int(z["chunks_done"]) == 4 and int(z["chunk"]) == 4
    assert float(z["clamp"]) == 3.0 and tuple(z["shards"]) == (1, 1)
    assert str(z["stream"]) == tscene.CHECKPOINT_STREAM
    loaded = jax_load(str(ck), 24 * 24, 4, 3, with_acc2=True, clamp=3.0)
    assert loaded is not None
    acc, done, acc2 = loaded
    assert done == 4
    assert np.array_equal(np.asarray(acc), z["acc"])
    assert np.array_equal(np.asarray(acc2), z["acc2"])
    assert acc.shape == z["acc"].shape and acc.dtype == z["acc"].dtype


def test_jax_checkpoint_is_not_resumed(J, tmp_path):
    """A JAX checkpoint passes every JAX check but seeds its chunks from
    threefry: the port restarts, and overwrites it with its own."""
    import jax.numpy as jnp
    from raytracer_tpu.core.scene import _save_checkpoint as jax_save

    ck = str(tmp_path / "j")
    fake = jnp.full((24 * 24, 3), 1e6, jnp.float32)
    jax_save(ck, fake, 2, 4, 5)
    assert tscene._load_checkpoint(ck, 24 * 24, 4, 5) is None
    resumed = render(noisy(), 16, batch_size=4, seed=5, output="linear",
                     checkpoint_path=ck, checkpoint_every=1)
    fresh = render(noisy(), 16, batch_size=4, seed=5, output="linear")
    assert np.array_equal(resumed, fresh)
    assert str(np.load(ck + ".npz")["stream"]) == tscene.CHECKPOINT_STREAM


def test_environment_rows_match_jax(J, monkeypatch):
    """render_environment's permutation of display rows into the fetch's
    storage order, run by both packages on the same rendered array."""
    img = np.random.default_rng(4).uniform(0, 1, (16, 32, 3)).astype(np.float32)
    seen = []

    def fake_render(self, spp, **kw):
        seen.append((self.camera.projection, self.camera.screen_width,
                     self.camera.screen_height, kw["output"]))
        return img

    monkeypatch.setattr(J.Scene, "render", fake_render)
    monkeypatch.setattr(T.Scene, "render", fake_render)
    want = J.Scene().render_environment(width=32, height=16, center=(1, 2, 3))
    got = T.Scene().render_environment(width=32, height=16, center=(1, 2, 3))
    assert np.array_equal(got, want)
    assert seen == [("equirect", 32, 16, "linear")] * 2
    # storage row (-iv) mod H holds display row iv, read bottom-up
    for iv in (0, 1, 7, 15):
        assert np.array_equal(got[(-iv) % 16], img[::-1][iv])


# ---------------------------------------------------------------------------
# checkpoints and resume, within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,m", [(0, 1, 2), (3, 99, 197), (7, 5, 6),
                                      (2 ** 31 + 5, 40, 1000)])
def test_chunk_seeds_rows_do_not_depend_on_the_chunk_count(seed, n, m):
    assert np.array_equal(chunk_seeds(seed, n, 26), chunk_seeds(seed, m, 26)[:n])


def _chunks_run(out):
    return [int(ln.split()[1].split("/")[0]) for ln in out.splitlines()
            if ln.startswith("  chunk ")]


def test_resume_is_bit_identical(tmp_path, capsys):
    ck = str(tmp_path / "r")
    half, st_half = render(noisy(), 8, batch_size=2, seed=3, output="linear",
                           checkpoint_path=ck, checkpoint_every=3,
                           return_stats=True, progress_bar=True)
    assert _chunks_run(capsys.readouterr().out) == [1, 2, 3, 4]
    full, st_full = render(noisy(), 16, batch_size=2, seed=3, output="linear",
                           return_stats=True)
    resumed, st_res = render(noisy(), 16, batch_size=2, seed=3,
                             output="linear", checkpoint_path=ck,
                             checkpoint_every=3, return_stats=True,
                             progress_bar=True)
    assert _chunks_run(capsys.readouterr().out) == [5, 6, 7, 8]
    assert np.array_equal(resumed, full)
    assert st_res["samples"] == st_full["samples"] == 16
    assert st_res["rays_traced"] + st_half["rays_traced"] == st_full["rays_traced"]
    # the whole render is done: a rerun resumes at the end
    again = render(noisy(), 16, batch_size=2, seed=3, output="linear",
                   checkpoint_path=ck, progress_bar=True)
    assert _chunks_run(capsys.readouterr().out) == []
    assert np.array_equal(again, full)


def test_checkpoint_restarts_on_another_render(tmp_path):
    """Another chunk, seed, frame or clamp, or a checkpoint of more chunks
    than the render plans, starts the render afresh."""
    ck = str(tmp_path / "c.npz")
    render(noisy(), 16, batch_size=2, seed=3, checkpoint_path=ck,
           checkpoint_every=1)
    n_pix = 24 * 24
    assert tscene._load_checkpoint(ck, n_pix, 2, 3) is not None
    for args in ((n_pix, 4, 3), (n_pix, 2, 4), (n_pix - 1, 2, 3)):
        assert tscene._load_checkpoint(ck, *args) is None
    assert tscene._load_checkpoint(ck, n_pix, 2, 3, clamp=2.0) is None
    assert tscene._load_checkpoint(ck, n_pix, 2, 3, with_acc2=True) is None
    assert tscene._load_checkpoint(ck, n_pix, 2, 3, shards=(2, 1)) is None
    short = render(noisy(), 8, batch_size=2, seed=3, output="linear",
                   checkpoint_path=ck)
    assert np.array_equal(short, render(noisy(), 8, batch_size=2, seed=3,
                                        output="linear"))


def test_clamp_checkpoint_mismatch_restarts(tmp_path):
    """tests/test_clamp.py test_clamp_checkpoint_mismatch_restarts."""
    ck = str(tmp_path / "c2.npz")
    a = render(noisy(), 8, seed=3, batch_size=2, checkpoint_path=ck,
               checkpoint_every=1, clamp=2.0, output="linear")
    b = render(noisy(), 8, seed=3, batch_size=2, checkpoint_path=ck,
               checkpoint_every=1, clamp=2.0, output="linear")
    assert np.array_equal(a, b)
    assert tscene._load_checkpoint(ck, 24 * 24, 2, 3, clamp=None) is None
    c = render(noisy(), 8, seed=3, batch_size=2, checkpoint_path=ck,
               clamp=None, output="linear")
    assert np.array_equal(c, render(noisy(), 8, seed=3, batch_size=2,
                                    output="linear"))


def test_adaptive_resume_is_bit_identical(tmp_path):
    ck = str(tmp_path / "adapt")
    full, st_full = render(noisy(), 16, batch_size=4, seed=3,
                           return_stats=True, target_noise=1e-6,
                           checkpoint_path=ck, checkpoint_every=1,
                           output="linear")
    again, st_again = render(noisy(), 16, batch_size=4, seed=3,
                             return_stats=True, target_noise=1e-6,
                             checkpoint_path=ck, checkpoint_every=1,
                             output="linear")
    assert np.array_equal(full, again)
    assert st_again["samples"] == st_full["samples"] == 16
    # resumed halfway, the second moment carries on
    ck2 = str(tmp_path / "adapt2")
    render(noisy(), 8, batch_size=4, seed=3, target_noise=1e-6,
           checkpoint_path=ck2)
    res, st_res = render(noisy(), 16, batch_size=4, seed=3, return_stats=True,
                         target_noise=1e-6, checkpoint_path=ck2,
                         output="linear")
    assert np.array_equal(res, full)
    assert st_res["noise_q99"] == st_full["noise_q99"]


# ---------------------------------------------------------------------------
# adaptive sampling (tests/test_adaptive.py, in the port)
# ---------------------------------------------------------------------------


def test_adaptive_stops_early_on_loose_target():
    _, stats = render(noisy(), 256, batch_size=4, seed=1, return_stats=True,
                      target_noise=0.2, noise_check_every=2)
    assert stats["samples"] < 256
    assert stats["noise_q99"] <= 0.2
    assert stats["samples"] % 4 == 0


def test_adaptive_exhausts_budget_on_tight_target():
    _, stats = render(noisy(), 16, batch_size=4, seed=1, return_stats=True,
                      target_noise=1e-5, noise_check_every=2)
    assert stats["samples"] == 16
    assert stats["noise_q99"] > 1e-5


def test_adaptive_noise_decreases_with_samples():
    _, s_few = render(noisy(), 8, batch_size=4, seed=1, return_stats=True,
                      target_noise=1e-6, noise_check_every=2)
    _, s_many = render(noisy(), 64, batch_size=4, seed=1, return_stats=True,
                       target_noise=1e-6, noise_check_every=16)
    assert s_many["noise_q99"] < s_few["noise_q99"]


def test_adaptive_image_matches_fixed_spp():
    a = np.asarray(render(noisy(), 8, batch_size=4, seed=7))
    b = np.asarray(render(noisy(), 8, batch_size=4, seed=7, target_noise=1e-9))
    assert np.array_equal(a, b)


def test_adaptive_needs_two_chunks_and_fits_quantile():
    _, stats = render(noisy(), 4, batch_size=4, seed=1, return_stats=True,
                      target_noise=0.1)
    assert "noise_q99" not in stats and stats["samples"] == 4
    # a frame past torch.quantile's 2^24 entries is judged, not refused:
    # the quantile of a 4097 x 4097 frame's errors, against numpy's
    x = _quantile_input(4097 * 4097, 0, seed=5)
    got = float(tscene._quantile(torch.from_numpy(x), 0.99))
    assert abs(got - float(np.quantile(x, 0.99))) <= 1e-6


def test_adaptive_judges_visible_fisheye_pixels(monkeypatch):
    seen = []
    orig = tscene._noise_q99

    def spy(acc, acc2, k, chunk, pmask=None):
        seen.append(pmask)
        return orig(acc, acc2, k, chunk, pmask)

    monkeypatch.setattr(tscene, "_noise_q99", spy)
    _, stats = render(noisy(projection="fisheye"), 8, batch_size=4, seed=1,
                      return_stats=True, target_noise=1e-9)
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], torch.from_numpy(
        projection_mask("fisheye", 24, 24)))
    assert np.isfinite(stats["noise_q99"])


# ---------------------------------------------------------------------------
# variance, previews, progress, profile, render_array
# ---------------------------------------------------------------------------


def test_with_variance_leaves_the_image_alone():
    sc = cornell(T)
    lin, var, stats = render(sc, 2, seed=2, output="linear",
                             with_variance=True, clamp=2.0, return_stats=True)
    plain = render(sc, 2, seed=2, output="linear", clamp=2.0)
    assert np.array_equal(lin, plain)
    assert var.shape == lin.shape and var.dtype == np.float32
    assert np.isfinite(var).all() and (var >= 0).all() and var.max() > 0
    assert float(lin.max()) <= 2.0 + 1e-6
    assert stats["samples"] == 40


def test_with_variance_estimates_the_error_of_the_mean():
    """Across independent renders the scatter of a pixel mean matches the
    variance the render reports for it, on average over the frame."""
    lins, vars_ = [], []
    for s in range(8):
        lin, var = render(noisy(12, 12), 16, batch_size=4, seed=s,
                          output="linear", with_variance=True)
        lins.append(lin)
        vars_.append(var)
    scatter = np.stack(lins).var(axis=0, ddof=1).mean()
    reported = np.stack(vars_).mean()
    assert 0.5 < scatter / reported < 2.0


def test_render_argument_checks(tmp_path):
    sc = noisy()
    with pytest.raises(ValueError, match="with_variance requires"):
        render(sc, 1, with_variance=True)
    with pytest.raises(ValueError, match="checkpointing"):
        render(sc, 1, with_variance=True, output="linear",
               checkpoint_path=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="preview_every"):
        render(sc, 1, preview_path=str(tmp_path / "p.png"), preview_every=0)


def test_final_preview_matches_returned_image(tmp_path):
    from PIL import Image

    p = tmp_path / "preview.png"
    for output, kw in (("pil", {}), ("linear", dict(tonemap="aces",
                                                    exposure=0.5))):
        img = render(noisy(32, 24, "fisheye"), 8, seed=1, batch_size=2,
                     preview_path=str(p), preview_every=2, output=output, **kw)
        if output == "pil":
            assert np.array_equal(np.asarray(Image.open(p)), np.asarray(img))
        else:
            want = render(noisy(32, 24, "fisheye"), 8, seed=1, batch_size=2,
                          output="pil", **kw)
            assert np.array_equal(np.asarray(Image.open(p)), np.asarray(want))


def test_intermediate_previews_refine(tmp_path, monkeypatch):
    from PIL import Image

    p = tmp_path / "preview.png"
    snapshots = []
    orig = Image.Image.save

    def spy(self, fp, *a, **k):
        orig(self, fp, *a, **k)
        snapshots.append(np.asarray(Image.open(fp)).copy())

    monkeypatch.setattr(Image.Image, "save", spy)
    render(noisy(32, 24), 8, seed=1, batch_size=2, preview_path=str(p),
           preview_every=1)
    assert len(snapshots) == 4              # 3 of 4 chunks, then the final
    for s in snapshots:
        assert s.shape == (24, 32, 3) and s.max() > 100
    assert not np.array_equal(snapshots[0], snapshots[-1])
    # every 4 chunks (the default) of 4: the final only; every 2: one more
    snapshots.clear()
    render(noisy(32, 24), 8, seed=1, batch_size=2, preview_path=str(p))
    assert len(snapshots) == 1
    snapshots.clear()
    render(noisy(32, 24), 8, seed=1, batch_size=2, preview_path=str(p),
           preview_every=2)
    assert len(snapshots) == 2


def test_progress_lines(capsys):
    _, stats = render(noisy(), 8, batch_size=4, seed=1, progress_bar=True,
                      target_noise=1e-9, noise_check_every=1,
                      return_stats=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Rendering..."
    assert out[1].startswith("  chunk 1/2 (4 samples)")
    assert out[2].startswith("  chunk 2/2 (8 samples)")
    assert out[3].startswith("  noise q99 ") and "(target 1e-09)" in out[3]
    assert out[4].startswith("Render Took")
    assert float(out[3].split()[2]) == pytest.approx(stats["noise_q99"],
                                                     abs=1e-4)


def test_profile_dir_writes_a_trace(tmp_path):
    d = tmp_path / "prof"
    img = render(noisy(8, 8), 1, seed=0, output="linear", profile_dir=d)
    assert img.shape == (8, 8, 3)
    traces = list(d.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_render_array_is_the_display_image_over_255():
    sc = noisy()
    arr = sc.render_array(4, seed=2, batch_size=2, device="cpu")
    img = np.asarray(render(sc, 4, seed=2, batch_size=2), np.float32) / 255.0
    assert np.array_equal(arr, img)
    arr2, stats = sc.render_array(4, seed=2, batch_size=2, device="cpu",
                                  return_stats=True)
    assert np.array_equal(arr2, img) and stats["samples"] == 4


# ---------------------------------------------------------------------------
# render_environment: the bake's round trip (tests/test_equirect.py:79)
# ---------------------------------------------------------------------------


def _panorama_scene(W=64, H=32):
    sc = T.Scene(ambient_color=(0, 0, 0))
    sc.camera = T.Camera(look_from=T.vec3(0, 0, 0), look_at=T.vec3(1, 0, 0),
                         screen_width=W, screen_height=H,
                         projection="equirect")
    for color, center in (((1, 0, 0), (5, 0, 0)), ((0, 1, 0), (0, 0, 5)),
                          ((0, 0, 1), (-5, 0, 0)), ((1, 1, 0), (0, 5, 0))):
        sc.add(T.Sphere(material=T.Emissive(color=T.rgb(*color)),
                        center=T.vec3(*center), radius=1.0))
    return sc


def test_bake_environment_round_trip():
    """Bake scene A into an environment map and show it as scene B's only
    content through a pinhole camera at the same centre: B must reproduce
    A's pinhole render up to texel quantisation at the edges."""
    sc_a = _panorama_scene()
    env = sc_a.render_environment(width=128, height=64, samples_per_pixel=2,
                                  seed=1, device="cpu")
    assert env.shape == (64, 128, 3) and env.dtype == np.float32
    assert np.isfinite(env).all()
    assert sc_a.camera.projection == "equirect"   # the camera is restored

    def pinhole(scene, look_at):
        scene.camera = T.Camera(look_from=T.vec3(0, 0, 0), look_at=look_at,
                                screen_width=24, screen_height=18,
                                field_of_view=50)
        return render(scene, 2, seed=2, output="linear")

    sc_b = T.Scene(ambient_color=(0, 0, 0))
    sc_b.add_Background(env, spherical=True, linear=True)
    for look_at in (T.vec3(1, 0, 0), T.vec3(0, 0, 1), T.vec3(-1, 0.6, 0.3)):
        a = pinhole(_panorama_scene(), look_at)
        b = pinhole(sc_b, look_at)
        assert a.max() > 0.5
        assert abs(a.mean() - b.mean()) < 0.015, look_at
        assert np.percentile(np.abs(a - b), 90) < 0.05, look_at
    assert sc_b._settings_for_render()[0].pallas_tex_ok   # the record path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resume_on_card_is_bit_identical(tmp_path):
    dev = _need_card()
    sc = cornell(T)
    ck = str(tmp_path / "card")
    sc.render(8, output="linear", seed=4, checkpoint_path=ck,
              checkpoint_every=2, batch_size=20, device=dev)
    full = sc.render(16, output="linear", seed=4, batch_size=20, device=dev)
    resumed = sc.render(16, output="linear", seed=4, batch_size=20,
                        checkpoint_path=ck, device=dev)
    assert np.array_equal(resumed, full)


@pytest.mark.cuda
def test_variance_on_card_leaves_the_image_alone():
    dev = _need_card()
    sc = cornell(T)
    lin, var = sc.render(4, output="linear", seed=4, with_variance=True,
                         device=dev)
    assert np.array_equal(lin, sc.render(4, output="linear", seed=4,
                                         device=dev))
    assert np.isfinite(var).all() and (var >= 0).all()


@pytest.mark.cuda
def test_profile_on_card_names_the_kernel(tmp_path):
    dev = _need_card()
    cornell(T).render(2, output="linear", device=dev, profile_dir=tmp_path)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("solid_trace" in str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel")
