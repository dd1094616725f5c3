"""W4, the wavefront's diffuse, refractive and glossy blocks
(ops/wavefront_shade.py, csrc/wavefront_shade.cu), on the card, without
JAX: every W4 call of small renders held against the plain dispatch on
the same bounce, bit for bit (among them 131 and 8,200 importance-sampled
lamps, whose caps pdf sums its terms in ATen's order for a row of 128 or
more, split across warps from 8,161 on), and the refractive and diffuse
entries on a bounce's rays picked so that ~1% are of their type,
scattered; the caps sum in registers equals torch.sum and the restated
sinf / cosf libdevice's on every float; where torch.sum splits a row of
the caps pdf across blocks (few rays, 131,072 or more targets), the
general caps sum and the diffuse entry equal it; the card's renders run no plain
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


def _queue_on_scattered_rays(card, tmp_path, monkeypatch, mt):
    """The entry of type mt on a Cornell bounce's rays picked so that ~1%
    of them, scattered, are of its type, at 200,003 rays (no multiple of a
    tile or a warp; `ws.pick_rays`): every field of every ray bit for bit
    with the plain dispatch, in one launch."""
    calls = []

    def spy(t, real):
        def call(ctx, draws, packed, m, acc):
            if t == mt:
                calls.append((t, ctx, draws, packed, m, ws.Merged(
                    *(getattr(acc, f).clone() for f in FIELDS))))
            return real(ctx, draws, packed, m, acc)
        return call

    _replace_wrappers(monkeypatch, spy)
    _scene("cornell", tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                       output="linear")
    call = max(calls, key=lambda c: int(c[4].sum()))
    m = call[4]
    typed, other = m.nonzero()[:, 0], (~m).nonzero()[:, 0]
    rng = np.random.default_rng(5)
    n = 200_003
    at = torch.from_numpy(rng.random(n) < 0.01).to(card)
    idx = torch.empty(n, dtype=torch.int64, device=card)
    k = int(at.sum())
    idx[at] = typed[torch.from_numpy(rng.integers(0, typed.shape[0], k)).to(card)]
    idx[~at] = other[torch.from_numpy(rng.integers(0, other.shape[0], n - k)).to(card)]
    mt, ctx, draws, packed, m, acc = ws.pick_rays(call, idx)
    assert torch.equal(m, at) and 1000 < k < 3000
    want = acc.merge(ws._plain(mt, ctx, draws, None), m)
    counted = ws._WRAPPER[mt]
    before = counted.launches
    got = ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
        *(getattr(acc, f).clone() for f in FIELDS)))
    assert counted.launches - before == 1
    for f in FIELDS:
        assert _bits_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_card_refractive_queue_on_scattered_rays(card, tmp_path, monkeypatch):
    """The refractive entry's queue on ~1% scattered refractive rays
    (`_queue_on_scattered_rays`)."""
    _queue_on_scattered_rays(card, tmp_path, monkeypatch, ws.MAT_REFRACTIVE)


@pytest.mark.cuda
def test_card_diffuse_queue_on_scattered_rays(card, tmp_path, monkeypatch):
    """The diffuse entry's queue on ~1% scattered diffuse rays of Cornell's
    (two caps: the caps sum in registers; `_queue_on_scattered_rays`)."""
    _queue_on_scattered_rays(card, tmp_path, monkeypatch, ws.MAT_DIFFUSE)


@pytest.mark.cuda
def test_card_restated_trig_is_libdevices(card):
    """W4's sinf and cosf, restated with their reduction's words in
    registers, equal libdevice's on all 2^32 floats."""
    assert ws.trig_mismatches(card) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 3, 5, 17, 32, 33, 100, 127])
def test_card_caps_sum_in_registers_is_torch_sum(card, K):
    """The diffuse entry's caps sum in registers equals torch.sum over the
    last dimension bit for bit, on rows of mixed signs and magnitudes."""
    gen = torch.Generator(device=card).manual_seed(K)
    x = torch.randn((40_000, K), generator=gen, device=card) * torch.pow(
        10.0, torch.rand((40_000, K), generator=gen, device=card) * 6.0 - 3.0)
    got, want = ws.caps_sum(x), torch.sum(x, dim=-1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (rays, importance-sampled targets) where ATen's torch.sum splits each
# row of the caps pdf across blocks on the H100 (2, 2, 2, 33 and 264
# blocks a row; the last two more than a warp has lanes, 32 and 256, where
# the order of the last block's trees shows)
SPLIT_SUMS = [(64, 200_000), (300, 150_000), (512, 131_072), (16, 300_000),
              (2, 2_200_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, K", SPLIT_SUMS)
def test_card_caps_sum_split_across_blocks_is_torch_sum(card, n, K):
    """Where torch.sum splits a row across blocks (few rows of many
    terms), the diffuse entry's general caps sum equals it bit for bit."""
    gen = torch.Generator(device=card).manual_seed(K + n)
    x = torch.randn((n, K), generator=gen, device=card) * torch.pow(
        10.0, torch.rand((n, K), generator=gen, device=card) * 6.0 - 3.0)
    got, want = ws.caps_sum(x, wide=True), torch.sum(x, dim=-1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def split_caps_call(call, n, K, seed=5):
    """A captured diffuse call (`ws.pick_rays` on its first n rays, nine in
    ten of them diffuse) with K importance-sampled caps in place of its
    scene's: centres on a sphere of radius 2 around the scene's, radii 0.3
    (each direction inside some hundreds of them), and a target picked for
    each ray.  Its caps pdf sums K terms on n rows."""
    import dataclasses

    mt, ctx, draws, packed, m, acc = call
    dev = ctx.P.device
    rng = np.random.default_rng(seed)
    typed, other = m.nonzero()[:, 0], (~m).nonzero()[:, 0]
    at = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    k = int(at.sum())
    idx[at] = typed[torch.from_numpy(rng.integers(0, typed.shape[0], k)).to(dev)]
    idx[~at] = other[torch.from_numpy(rng.integers(0, other.shape[0], n - k)).to(dev)]
    mt, ctx, draws, packed, m, acc = ws.pick_rays(call, idx)
    d = rng.standard_normal((K, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mid = ctx.data.is_center.mean(0).cpu().numpy()
    center = torch.from_numpy((mid + 2.0 * d).astype(np.float32)).to(dev)
    radius = torch.full((K,), 0.3, dtype=torch.float32, device=dev)
    data = dataclasses.replace(ctx.data, is_center=center, is_radius=radius)
    static = dataclasses.replace(ctx.static, n_is_targets=K)
    pick = torch.from_numpy(rng.integers(0, K, n)).to(dev)
    draws = {**draws, mt: (draws[mt][0], pick)}
    ctx = dataclasses.replace(ctx, data=data, static=static)
    return mt, ctx, draws, packed, m, acc


@pytest.mark.cuda
@pytest.mark.parametrize("n, K", [(300, 150_000), (16, 300_000)])
def test_card_diffuse_entry_on_a_split_caps_sum(card, tmp_path, monkeypatch, n, K):
    """The diffuse entry on n rays of a Cornell bounce with K
    importance-sampled caps, where torch.sum splits each row of the caps
    pdf across blocks (2 a row; 33, more than a warp's 32 lanes): every
    field of every ray bit for bit with the plain dispatch, in two
    launches (the blocks' sums, then the shading)."""
    calls = []

    def spy(t, real):
        def call(ctx, draws, packed, m, acc):
            if t == ws.MAT_DIFFUSE:
                calls.append((t, ctx, draws, packed, m, ws.Merged(
                    *(getattr(acc, f).clone() for f in FIELDS))))
            return real(ctx, draws, packed, m, acc)
        return call

    _replace_wrappers(monkeypatch, spy)
    _scene("cornell", tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                       output="linear")
    mt, ctx, draws, packed, m, acc = split_caps_call(calls[0], n, K)
    want = acc.merge(ws._plain(mt, ctx, draws, None), m)
    counted = ws._WRAPPER[mt]
    before = counted.launches
    got = ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
        *(getattr(acc, f).clone() for f in FIELDS)))
    assert counted.launches - before == 2      # the blocks' sums, the shading
    for f in FIELDS:
        assert _bits_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("n, K", [(2_000, 5_000), (300, 150_000)])
def test_card_diffuse_backward_on_many_caps(card, tmp_path, monkeypatch, n, K):
    """W4's diffuse backward kernel on n rays of a Cornell bounce with K
    importance-sampled caps (`split_caps_call`), where the engine's sum_to
    over K of the caps geometry's (N, K, 3) gradient splits across blocks
    (the nudged origin's shares then rows, summed by ATen's own op), and
    at 150,000 caps the caps pdf's torch.sum too (F5's plan, its blocks'
    sums made one after another): every gradient bit for bit with the
    plain VJP, output gradients drawn from a seed, every input wanted."""
    calls = []

    def spy(t, real):
        def call(ctx, draws, packed, m, acc):
            if t == ws.MAT_DIFFUSE:
                calls.append((t, ctx, draws, packed, m, acc))
            return real(ctx, draws, packed, m, acc)
        return call

    _replace_wrappers(monkeypatch, spy)
    _scene("cornell", tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                       output="linear")
    mt, ctx, draws, packed, m, _ = split_caps_call(calls[0], n, K)
    assert ws._outer_rows(K, n)
    g = torch.Generator(device=card).manual_seed(26)
    grads = [torch.randn((n, 3), generator=g, device=card) for _ in ws.WRITTEN[mt]]
    n_tex = len(ctx.data.textures)
    wants = (True,) * (len(ws.WRITTEN[mt]) + len(ws._DIFF_INPUTS)) + (False,) * n_tex
    before = ws.backward_launches()["shade_diffuse_bwd"]
    got = ws.diffuse_vjp(grads, ws.diff_saved(ctx, draws, packed, m), wants)
    assert ws.backward_launches()["shade_diffuse_bwd"] - before == 1
    want = ws.plain_shade_vjp(mt, ctx, draws[mt], m, None, grads, wants)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mt", [ws.MAT_REFRACTIVE, ws.MAT_GLOSSY])
def test_card_backward_wraps_its_grid_on_a_ragged_tile(card, tmp_path, monkeypatch, mt):
    """W4's refractive and glossy backward kernels on a primitives bounce's
    rays picked at random (`ws.pick_rays`), twice as many as one pass of
    the kernel's grid holds and 77 more (the grid-stride loop wraps, the
    last tile is ragged), output gradients drawn from a seed, every input
    wanted (the glossy's light rows, which leave a light at a time, and
    texel taps too): every gradient bit for bit with the plain VJP, in one
    launch."""
    calls = []

    def spy(t, real):
        def call(ctx, draws, packed, m, acc):
            if t == mt:
                calls.append((t, ctx, draws, packed, m, acc))
            return real(ctx, draws, packed, m, acc)
        return call

    _replace_wrappers(monkeypatch, spy)
    _scene("primitives", tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                          output="linear")
    inf = ws.info(mt, backward=True)
    n = 2 * inf["sms"] * inf["blocks_per_sm"] * inf["rays_per_pass"] + 77
    rng = np.random.default_rng(28)
    idx = torch.from_numpy(rng.integers(0, calls[0][4].shape[0], n)).to(card)
    mt, ctx, draws, packed, m, _ = ws.pick_rays(calls[0], idx)
    assert bool(m.any()) and not bool(m.all())
    gen = torch.Generator(device=card).manual_seed(28)
    grads = [torch.randn((n, 3), generator=gen, device=card) for _ in ws.WRITTEN[mt]]
    if mt == ws.MAT_GLOSSY:
        with torch.no_grad():
            nudged, rays = tshade.light_rays(ctx)
            occ = tshade.light_occlusion(ctx, nudged, rays)
        wants = (True,) * (len(ws.WRITTEN[mt]) + len(ws._GLOSS_INPUTS)
                           + len(ctx.data.textures))
        got = lambda: ws.glossy_vjp(grads, ws.gloss_saved(ctx, draws, packed, m, occ), wants)
        want = ws.plain_shade_vjp(mt, ctx, None, m, occ, grads, wants)
    else:
        wants = (True,) * (len(ws.WRITTEN[mt]) + len(ws._REFR_INPUTS))
        got = lambda: ws.refractive_vjp(grads, ws.refr_saved(ctx, draws, packed, m), wants)
        want = ws.plain_shade_vjp(mt, ctx, draws[mt], m, None, grads, wants)
    entry = ws._BLOCKS[mt][0] + "_bwd"
    before = ws.backward_launches()[entry]
    out = got()
    assert ws.backward_launches()[entry] - before == 1
    assert sum(a is not None for a in out) > len(ws.WRITTEN[mt])
    for a, b in zip(out, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _bits_equal(a, b)


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
    block through W4 (`_Shade`: its forward and its backward kernels)
    equals the one through the plain dispatch bit for bit; two passes
    through W4 agree bit for bit."""
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
    assert ws.backward_launches()["shade_refractive_bwd"] > 0
    assert not any(ws.plain_routes.values())
    _replace_wrappers(monkeypatch, lambda mt, real: lambda ctx, d, p, m, acc:
                      acc.merge(ws._plain(mt, ctx, d, None), m))
    ws.reset_launches()
    g_plain = grad()
    assert ws.launches() == 0
    assert torch.equal(g1, g2) and torch.equal(g1, g_plain)
    assert bool((g1 != 0).all())


@pytest.mark.cuda
def test_card_colour_gradient_through_w4_is_the_plain_blocks(card, monkeypatch):
    """The primitives' gradient with respect to diffuse_color, glossy_color
    and glossy_n_re on the card, the diffuse and glossy blocks' backward
    through their kernels (`shade_diffuse_bwd`, `shade_glossy_bwd`, no
    plain route), equals the one through the plain dispatch bit for bit;
    two passes through W4 agree bit for bit."""
    from torch_primitives import primitives

    from raytracer_tpu_torch.diff import differentiable_render, update_materials

    tables = ("diffuse_color", "glossy_color", "glossy_n_re")
    fn, data = differentiable_render(primitives(32, 24), 4, seed=0, device=card)

    def grad():
        xs = [getattr(data.mats, k).clone().requires_grad_(True) for k in tables]
        loss = torch.mean(fn(update_materials(data, **dict(zip(tables, xs)))) ** 2)
        return torch.autograd.grad(loss, xs)

    ws.reset_launches()
    g1, g2 = grad(), grad()
    n = ws.backward_launches()
    assert n["shade_diffuse_bwd"] > 0 and n["shade_glossy_bwd"] > 0
    assert not any(ws.plain_routes.values())
    _replace_wrappers(monkeypatch, lambda mt, real: lambda ctx, d, p, m, acc:
                      acc.merge(ws._plain(mt, ctx, d, None), m))
    ws.reset_launches()
    g_plain = grad()
    assert ws.launches() == 0
    for a, b, c in zip(g1, g2, g_plain):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert bool(torch.isfinite(a).all()) and bool((a != 0).any())


@pytest.mark.cuda
def test_card_texture_gradient_through_w4_is_the_plain_blocks(card, monkeypatch):
    """The gradient with respect to every texture of lit_textures (a
    nearest diffuse, a bilinear glossy, an emissive image and the sky) and
    of the primitives' checkered floor on the card, the diffuse and glossy
    blocks' backward through their kernels (their texel taps' rows, no
    plain route), equals the one through the plain dispatch bit for bit;
    two passes through W4 agree bit for bit."""
    import dataclasses

    from test_torch_scenes import lit_textures
    from torch_primitives import primitives

    from raytracer_tpu_torch.diff import differentiable_render

    def bits_equal(a, b):
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())

    def scene(name):
        if name == "primitives":
            return primitives(32, 24)
        sc = lit_textures(T)
        sc.camera.screen_width, sc.camera.screen_height = 32, 24
        return sc

    for name in ("lit_textures", "primitives"):
        fn, data = differentiable_render(scene(name), 4, seed=0, device=card)

        def grad():
            xs = [t.clone().requires_grad_(True) for t in data.textures]
            loss = torch.mean(fn(dataclasses.replace(data, textures=tuple(xs))) ** 2)
            return torch.autograd.grad(loss, xs, allow_unused=True)

        with monkeypatch.context() as m:
            ws.reset_launches()
            g1, g2 = grad(), grad()
            n = ws.backward_launches()
            assert n["shade_glossy_bwd"] > 0
            assert not any(ws.plain_routes.values())
            _replace_wrappers(m, lambda mt, real: lambda ctx, d, p, mk, acc:
                              acc.merge(ws._plain(mt, ctx, d, None), mk))
            ws.reset_launches()
            g_plain = grad()
            assert ws.launches() == 0
        for a, b, c in zip(g1, g2, g_plain):
            assert (a is None) == (c is None)
            if a is not None:
                assert torch.equal(a, b) and bits_equal(a, c)
        assert any(a is not None and bool((a != 0).any()) for a in g1), name
