"""W6, the wavefront's bounce tail (ops/bounce_tail.py, csrc/bounce_tail.cu),
on the card, without JAX: every start and update call of small renders
held against the plain stages on the same inputs, every field of every ray
bit for bit, one launch a call; the card's renders run no plain start,
update, emissive or environment block; the inverse-rendering gradient (the
IoR and the emissive colours) through `_Start` and `_Update` equals the one
through the plain stages, bit for bit, and two passes agree; every backward
call of two gradients, recorded and replayed, gives the plain stages' VJP
bit for bit through W6's backward kernels.

    python -m pytest --noconftest -m cuda tests/test_torch_bounce_tail_card.py

runs them where there is a card (tests/conftest.py imports jax); here they
skip.  tests/test_torch_bounce_tail_emu.py holds the same source on the
CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.materials import shade
from raytracer_tpu_torch.ops import bounce_tail as bt
from raytracer_tpu_torch.ops import wavefront_shade as ws

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

SCENES = ["grid", "cornell", "icosphere", "example2", "example4", "emitters"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (W6 has no CPU mode)")
    return torch.device("cuda")


def _scene(name, obj_dir):
    import torch_cornellbox
    import torch_mesh
    import torch_textured
    import torch_wavefront
    from test_torch_bounce_tail_emu import emitters

    if name == "grid":
        return torch_wavefront.grid(96, 64, 48)
    if name == "icosphere":
        return torch_mesh.icosphere(64, 48, obj_dir=obj_dir)
    sc = {"cornell": lambda: torch_cornellbox.build_cornell(64, 64),
          "example2": lambda: torch_textured.example2(64, 48),
          "example4": lambda: torch_textured.example4(64, 48, blur=0.0),
          "emitters": lambda: emitters(width=64, height=48)}[name]()
    sc.settings = T.RenderSettings(use_pallas="never")
    return sc


def bits_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.is_floating_point():
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_card_w6_equals_the_plain_stages(card, name, tmp_path, monkeypatch):
    """Every start and update call of a 2-spp render on the card against
    the plain stages on the same inputs: each field of each ray bit for
    bit, one launch a call."""
    held = {"start": 0, "update": 0}
    real_start, real_update = bt.bounce_start, bt.bounce_update

    def start(ctx, packed, mat_type):
        want = bt.plain_start(ctx, mat_type)
        before = bt.launches()["bounce_start"]
        got = bt._kernel_start(ctx, packed, mat_type)
        assert bt.launches()["bounce_start"] - before == 1
        for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS:
            assert bits_equal(getattr(got, f), getattr(want, f)), f
        held["start"] += 1
        return real_start(ctx, packed, mat_type)

    def update(c, miss, acc):
        want = bt.plain_update(c, miss, acc)
        before = bt.launches()["bounce_update"]
        got = bt._kernel_update(c, miss, acc)
        assert bt.launches()["bounce_update"] - before == 1
        for f in bt.CARRY_FLOATS + bt.CARRY_OTHERS:
            assert bits_equal(getattr(got, f), getattr(want, f)), f
        held["update"] += 1
        return real_update(c, miss, acc)

    monkeypatch.setattr(bt, "bounce_start", start)
    monkeypatch.setattr(bt, "bounce_update", update)
    _scene(name, tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                  output="linear")
    assert held["start"] and held["update"]


@pytest.mark.cuda
def test_card_renders_run_no_plain_stage(card, tmp_path, monkeypatch):
    """Cornell on the wavefront and examples 2 and 4 on the card with the
    plain start, update, emissive and environment blocks raising: W6 runs
    them, one launch of each a bounce."""
    def plain(*args, **kw):
        raise AssertionError("a plain stage of the bounce's tail ran on the card")

    for name in ("plain_start", "plain_update"):
        monkeypatch.setattr(bt, name, plain)
    for name in ("shade_emissive", "shade_env"):
        monkeypatch.setattr(shade, name, plain)
    for name in ("cornell", "example2", "example4"):
        sc = _scene(name, tmp_path)
        static, _, settings = sc._settings_for_render()
        bt.reset_launches()
        img, stats = sc.render(samples_per_pixel=4, device=card, seed=1,
                               output="linear", return_stats=True)
        got = bt.launches()
        assert np.isfinite(img).all() and int(stats["rays_traced"]) > 0
        assert got["bounce_start"] == got["bounce_update"] > 0
        assert got["bounce_start"] % settings.max_bounces == 0


@pytest.mark.cuda
def test_card_gradient_through_w6_is_the_plain_stages(card, monkeypatch):
    """The inverse-rendering gradient of the IoR and the emissive colours
    on the card with the start and the update through W6 (`_Start`,
    `_Update`) equals the one through the plain stages bit for bit; two
    passes through W6 agree bit for bit."""
    from torch_inverse_rendering import build_scene

    from raytracer_tpu_torch.diff import differentiable_render, update_materials

    fn, data = differentiable_render(build_scene(1.3, 32, 24), 8, seed=0,
                                     device=card)

    def grad():
        x = data.mats.refr_n_re.clone().requires_grad_(True)
        e = data.mats.emissive_color.clone().requires_grad_(True)
        loss = torch.mean(fn(update_materials(data, refr_n_re=x,
                                              emissive_color=e)) ** 2)
        return torch.autograd.grad(loss, (x, e))

    bt.reset_launches()
    g1, g2 = grad(), grad()
    assert all(n > 0 for n in bt.launches().values())
    monkeypatch.setattr(bt, "bounce_start",
                        lambda ctx, packed, mat_type: bt.plain_start(ctx, mat_type))
    monkeypatch.setattr(bt, "bounce_update", bt.plain_update)
    bt.reset_launches()
    g_plain = grad()
    assert all(n == 0 for n in bt.launches().values())
    for a, b, p in zip(g1, g2, g_plain):
        assert torch.equal(a, b) and torch.equal(a, p)
    assert bool((g1[0] != 0).all()) and bool((g1[1] != 0).any())


@pytest.mark.cuda
def test_card_updates_on_two_streams_count_their_own_rays(card):
    """Two updates of 2 M rays each counting rays_traced, launched back to
    back on two streams (which may run at once), three times: each count
    is its own update's, as the plain update makes it, and an update on
    the default stream after them counts right (no scratch left
    non-zero)."""
    import dataclasses

    from test_torch_bounce_tail_emu import random_update, update_args

    def on_card(c, miss, acc):
        move = lambda x: dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(card) for f in dataclasses.fields(x)})
        return move(c), miss.to(card), move(acc)

    args = [on_card(*update_args(random_update(seed, n=2_000_000))) for seed in (5, 6)]
    want = [int(bt.plain_update(*a).rays_traced) for a in args]
    assert want[0] != want[1]
    streams = torch.cuda.Stream(card), torch.cuda.Stream(card)
    for _ in range(3):
        torch.cuda.synchronize(card)
        outs = []
        for s, a in zip(streams, args):
            with torch.cuda.stream(s):
                outs.append(bt._kernel_update(*a))
        torch.cuda.synchronize(card)
        assert [int(o.rays_traced) for o in outs] == want
    assert int(bt._kernel_update(*args[0]).rays_traced) == want[0]


def _bits_equal_or_none(a, b):
    if a is None or b is None:
        return (a is None) == (b is None)
    return bits_equal(a, b)


@pytest.mark.cuda
def test_card_w6_backward_equals_the_plain_vjp(card, monkeypatch):
    """Every backward call of `_Start` and `_Update` in the IoR and emissive
    gradient of the inverse-rendering scene and in the emissive and sky
    gradient of the emitter scene, recorded and replayed: W6's backward
    kernels give the plain stages' VJP bit for bit (None where it gives
    None); the gradients themselves ran no plain stage."""
    from test_torch_bounce_tail_emu import emitters
    from torch_inverse_rendering import build_scene

    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from raytracer_tpu_torch.ops.plain_grad import recording

    def raising(real, device_of):
        def call(*args):
            # the forward's dataflow check runs the plain start on the meta
            # device
            if device_of(args[0]).type == "cuda":
                raise AssertionError("a plain W6 stage ran on the card")
            return real(*args)
        return call

    calls = []
    for sc, fields in ((build_scene(1.3, 32, 24), ("refr_n_re", "emissive_color")),
                       (emitters(width=32, height=24),
                        ("emissive_color", "env_light_intensity"))):
        fn, data = differentiable_render(sc, 4, seed=2, device=card)
        xs = {f: getattr(data.mats, f).clone().requires_grad_(True) for f in fields}
        with monkeypatch.context() as m, recording(calls, bt._Start, bt._Update):
            m.setattr(bt, "plain_start", raising(bt.plain_start,
                                                 lambda ctx: ctx.P.device))
            m.setattr(bt, "plain_update", raising(bt.plain_update,
                                                  lambda c: c.L.device))
            loss = torch.mean(fn(update_materials(data, **xs)) ** 2)
            torch.autograd.grad(loss, list(xs.values()))
    assert {c[0] for c in calls} == {bt._Start, bt._Update}
    bt.reset_launches()
    for fn, call, xs, grads, wants in calls:
        kernel, plain = bt.backward_pair(fn, call, xs, grads, wants)
        assert kernel is not None
        assert all(_bits_equal_or_none(a, b) for a, b in zip(kernel(), plain()))
    assert all(n > 0 for n in bt.backward_launches().values())


@pytest.mark.cuda
def test_card_texture_gradient_through_w6_is_the_plain_stages(card, monkeypatch):
    """The emitter scene's gradient with respect to its textures (nearest
    and bilinear emissive refs of one texture, the sky's display texture
    that is its lightmap too) on the card: every recorded backward call of
    `_Start` replayed bit for bit against the plain start's VJP through W6's
    start backward (its texel taps' rows), no plain stage on the card."""
    import dataclasses

    from test_torch_bounce_tail_emu import emitters

    from raytracer_tpu_torch.diff import differentiable_render
    from raytracer_tpu_torch.ops.plain_grad import recording

    fn, data = differentiable_render(emitters(width=32, height=24), 4, seed=2,
                                     device=card)
    xs = [t.clone().requires_grad_(True) for t in data.textures]
    calls = []
    with monkeypatch.context() as m, recording(calls, bt._Start):
        def raising(*args):
            if args[0].P.device.type == "cuda":
                raise AssertionError("a plain W6 stage ran on the card")
            return real(*args)
        real = bt.plain_start
        m.setattr(bt, "plain_start", raising)
        loss = torch.mean(fn(dataclasses.replace(data, textures=tuple(xs))) ** 2)
        got = torch.autograd.grad(loss, xs, allow_unused=True)
    assert any(g is not None and bool((g != 0).any()) for g in got)
    bt.reset_launches()
    for f, call, ins, grads, wants in calls:
        kernel, plain = bt.backward_pair(f, call, ins, grads, wants)
        assert all(_bits_equal_or_none(a, b) for a, b in zip(kernel(), plain()))
    assert bt.backward_launches()["bounce_start_bwd"] == len(calls) > 0
