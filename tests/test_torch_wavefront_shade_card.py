"""W4, the wavefront's diffuse, refractive and glossy blocks
(ops/wavefront_shade.py, csrc/wavefront_shade.cu), on the card, without
JAX: every W4 call of small renders held against the plain dispatch on
the same bounce, bit for bit (among them 131 and 8,200 importance-sampled
lamps, whose caps pdf sums its terms in ATen's order for a row of 128 or
more, split across warps from 8,161 on); the card's renders run no plain
block; the inverse-rendering gradient through W4 equals the one through
the plain blocks, bit for bit, and two passes agree.

    python -m pytest --noconftest -m cuda tests/test_torch_wavefront_shade_card.py

runs them where there is a card (tests/conftest.py imports jax); here
they skip.  tests/test_torch_wavefront_shade_emu.py holds the same source
on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.materials import shade as tshade
from raytracer_tpu_torch.ops import wavefront_shade as ws

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

FIELDS = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
SCENES = ["grid", "cornell", "beach_ball", "env_is", "dispersion", "split",
          "shapes", "primitives", "lamps_131", "lamps_8200"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (W4 has no CPU mode)")
    return torch.device("cuda")


def _scene(name, obj_dir):
    import torch_cornellbox
    import torch_features
    import torch_mesh
    import torch_primitives
    import torch_wavefront

    if name == "grid":
        return torch_wavefront.grid(96, 64, 48)
    if name == "beach_ball":
        return torch_mesh.beach_ball(64, 48, obj_dir=obj_dir)
    if name == "env_is":
        return torch_features.env_is(64, 48)
    if name.startswith("lamps_"):
        k = int(name[6:])
        return torch_wavefront.lamp_cluster(k, *((64, 48) if k < 1000 else (32, 24)))
    sc = {"cornell": lambda: torch_cornellbox.build_cornell(64, 64),
          "dispersion": lambda: torch_primitives.dispersion(64, 48),
          "split": lambda: torch_primitives.example2_solid(64, 48),
          "shapes": lambda: torch_primitives.shapes(64, 48),
          "primitives": lambda: torch_primitives.primitives(64, 48)}[name]()
    sc.settings = T.RenderSettings(use_pallas="never")
    return sc


def _bits_equal(a, b):
    if a.is_floating_point():
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


def _replace_wrappers(monkeypatch, make):
    """trace's three W4 wrappers replaced by make(type, real wrapper)."""
    for mt, w in dict(ws._WRAPPER).items():
        monkeypatch.setattr(ws, w.__name__, make(mt, w))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_card_w4_equals_the_plain_dispatch(card, name, tmp_path, monkeypatch):
    """Every W4 call of a 2-spp render on the card against the plain
    dispatch on the same bounce: each field of each ray bit for bit."""
    held = []

    def spy(mt, real):
        def call(ctx, draws, packed, m, acc):
            want = acc.merge(ws._plain(mt, ctx, draws, None), m)
            got = real(ctx, draws, packed, m, ws.Merged(
                *(getattr(acc, f).clone() for f in FIELDS)))
            for f in FIELDS:
                assert _bits_equal(getattr(got, f), getattr(want, f)), (mt, f)
            held.append(mt)
            return want
        return call

    _replace_wrappers(monkeypatch, spy)
    sc = _scene(name, tmp_path)
    ws.reset_launches()
    sc.render(samples_per_pixel=2, device=card, seed=3, output="linear")
    present = {mt for mt in sc._settings_for_render()[0].mat_types_present
               if mt in ws._WRAPPER}
    assert present and set(held) == present
    assert ws.launches() == len(held)


@pytest.mark.cuda
def test_card_renders_run_no_plain_block(card, tmp_path, monkeypatch):
    """Cornell on the wavefront and the beach ball on the card with the
    plain diffuse, refractive and glossy blocks raising: W4 shades them."""
    def plain(*args, **kw):
        raise AssertionError("a plain shading block ran on the card")

    for name in ("shade_diffuse", "shade_refractive", "shade_glossy"):
        monkeypatch.setattr(tshade, name, plain)
    for name in ("cornell", "beach_ball"):
        ws.reset_launches()
        img = _scene(name, tmp_path).render(
            samples_per_pixel=4, device=card, seed=1, output="linear")
        assert np.isfinite(img).all() and ws.launches() > 0


@pytest.mark.cuda
def test_card_gradient_through_w4_is_the_plain_blocks(card, monkeypatch):
    """The inverse-rendering IoR gradient on the card with the refractive
    block through W4 (`_Shade`) equals the one through the plain dispatch
    bit for bit; two passes through W4 agree bit for bit."""
    from torch_inverse_rendering import build_scene

    from raytracer_tpu_torch.diff import differentiable_render, update_materials

    fn, data = differentiable_render(build_scene(1.3, 32, 24), 8, seed=0,
                                     device=card)

    def grad():
        x = data.mats.refr_n_re.clone().requires_grad_(True)
        loss = torch.mean(fn(update_materials(data, refr_n_re=x)) ** 2)
        return torch.autograd.grad(loss, x)[0]

    ws.reset_launches()
    g1, g2 = grad(), grad()
    assert ws.shade_refractive.launches > 0
    _replace_wrappers(monkeypatch, lambda mt, real: lambda ctx, d, p, m, acc:
                      acc.merge(ws._plain(mt, ctx, d, None), m))
    ws.reset_launches()
    g_plain = grad()
    assert ws.launches() == 0
    assert torch.equal(g1, g2) and torch.equal(g1, g_plain)
    assert bool((g1 != 0).all())
