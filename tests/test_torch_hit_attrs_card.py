"""W5, the wavefront's hit attributes (ops/hit_attrs.py,
csrc/hit_attrs.cu), on the card, without JAX: every attribute call of
small renders held against the plain stage on the same rays, bit for bit
(as the renders call it, with uv forced, and as the first-hit pass; in
the normal-mapped scenes the mapped, oriented normal that W5 computes),
and likewise the normal maps' cases of tests/test_torch_hit_attrs_emu.py
`map_inputs` (two refs on one object, a map of quarter steps, misses on
the mapped object 0); W5's atan2 and asin against torch's (asin on all
2^32 floats, atan2 on random bit patterns and the special values), and
its 3 x 3 product against torch's (cuBLAS) from 17 rows on; the card's
renders run the plain attribute formulas and the plain normal maps
nowhere; the inverse-rendering gradient through W5 (`_Attrs`) equals
the one through the plain stage, bit for bit, and two passes agree; every
backward call of four IoR gradients, recorded and replayed, gives the
plain stage's VJP bit for bit through W5's backward kernel, and its rsqrt
is torch.rsqrt on all 2^32 floats.

    python -m pytest --noconftest -m cuda tests/test_torch_hit_attrs_card.py

runs them where there is a card (tests/conftest.py imports jax); here
they skip.  tests/test_torch_hit_attrs_emu.py holds the same source on
the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.ops import hit_attrs as ha

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

FIELDS = ha.FLOAT_FIELDS + ha.OTHER_FIELDS
SCENES = ["grid", "cornell", "primitives", "shapes", "icosphere", "beach_ball",
          "instances", "normal_mapped", "normal_mapped_bilinear", "instanced_mapped"]
MODES = ((False, False), (True, False), (True, True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (W5 has no CPU mode)")
    return torch.device("cuda")


def _scene(name, obj_dir):
    import torch_cornellbox
    import torch_features
    import torch_mesh
    import torch_primitives
    import torch_wavefront

    if name == "grid":
        return torch_wavefront.grid(96, 64, 48)
    if name in ("icosphere", "beach_ball"):
        return getattr(torch_mesh, name)(64, 48, obj_dir=obj_dir)
    if name == "instances":
        return torch_mesh.instances(64, 48, count=12, subdiv=2, obj_dir=obj_dir)
    if name in ("normal_mapped", "normal_mapped_bilinear"):
        return torch_features.normal_mapped(
            64, 48, obj_dir=obj_dir,
            filter="bilinear" if name.endswith("bilinear") else "nearest")
    if name == "instanced_mapped":
        return torch_features.instanced_mapped(64, 48, obj_dir=obj_dir)
    sc = {"cornell": lambda: torch_cornellbox.build_cornell(64, 64),
          "primitives": lambda: torch_primitives.primitives(64, 48),
          "shapes": lambda: torch_primitives.shapes(64, 48)}[name]()
    sc.settings = T.RenderSettings(use_pallas="never")
    return sc


def bits_equal(a, b):
    if a.is_floating_point():
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return bool((a == b).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_card_w5_equals_the_plain_stage(card, name, tmp_path, monkeypatch):
    """Every attribute call of a 2-spp render on the card against the
    plain stage on the same rays, as called, with uv forced and as the
    first-hit pass: each field of each ray bit for bit, one launch a
    call."""
    held = []
    real = ha.attributes

    def spy(*args, **kw):
        for force_uv, first_hit in MODES:
            want = ha.plain_attributes(*args, force_uv=force_uv, first_hit=first_hit)
            before = ha.launches()
            got = ha._kernel_attributes(*args, force_uv=force_uv,
                                        first_hit=first_hit)
            assert ha.launches() - before == 1
            for f in FIELDS:
                assert bits_equal(getattr(got, f), getattr(want, f)), (f, force_uv,
                                                                       first_hit)
        held.append(args[2].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ha, "attributes", spy)
    _scene(name, tmp_path).render(samples_per_pixel=2, device=card, seed=3,
                                  output="linear")
    assert held


@pytest.mark.cuda
def test_card_w5_equals_the_plain_stage_on_the_map_cases(card, tmp_path):
    """The normal maps' cases (`map_inputs`: every basis kind, both filters,
    repeats other than 1, two refs on one object, texels of 0.5, misses on
    the mapped object 0, NaN and overflowing distances) on the card: W5
    against the plain stage, every field bit for bit, in each mode."""
    from test_torch_hit_attrs_emu import map_inputs

    static, data, rays, _ = map_inputs(tmp_path)
    data = data.to(card)
    rays = [x.to(card) for x in rays]
    for force_uv, first_hit in MODES:
        want = ha.plain_attributes(*rays, data, static, T.RenderSettings(),
                                   force_uv=force_uv, first_hit=first_hit)
        got = ha._kernel_attributes(*rays, data, static, T.RenderSettings(),
                                    force_uv=force_uv, first_hit=first_hit)
        for f in FIELDS:
            assert bits_equal(getattr(got, f), getattr(want, f)), (f, force_uv,
                                                                   first_hit)


@pytest.mark.cuda
def test_card_w5_mm3_is_cublas(card):
    """W5's 3 x 3 product (`hit_attrs_math` op 2) against torch's (N, 3) @
    (3, 3) on the card (cuBLAS), both layouts of the (3, 3) operand, on
    rows with signed zeros, and its backward into the left factor (op 4,
    the maps' backward) against autograd's: bit for bit from 17 rows on
    (fewer rows take other cuBLAS kernels, scripts/torch_op_rounding.py
    --only matmul3)."""
    gen = torch.Generator(device=card).manual_seed(2)
    for n in (17, 100, 4096, 1 << 20):
        m = torch.rand(n, 3, device=card, generator=gen) - 0.5
        zero = torch.rand(n, 3, device=card, generator=gen) < 0.3
        neg = torch.rand(n, 3, device=card, generator=gen) < 0.5
        a = torch.where(zero, torch.where(neg, -0.0, 0.0), m) * 2.0
        B = torch.randn(3, 3, device=card, generator=gen)
        B[0, 1], B[1, 2] = 0.0, -0.0
        for M in (B, B.T.contiguous().T):
            assert bits_equal(ha.math("mm3", a, M), a @ M), n
            # the backward into the left factor (the maps' backward)
            g = torch.randn(n, 3, device=card, generator=gen)
            x = a.clone().requires_grad_()
            ga, = torch.autograd.grad(x @ M, x, g)
            assert bits_equal(ha.math("mm3_bwd", g, M), ga), n


@pytest.mark.cuda
def test_card_w5_asin_is_torchs_on_every_float(card):
    """W5's asin equals torch.asin on all 2^32 floats (NaN against NaN)."""
    bad = 0
    for lo in range(0, 1 << 32, 1 << 28):
        x = (torch.arange(lo, lo + (1 << 28), device=card, dtype=torch.int64)
             .to(torch.int32).view(torch.float32))
        a, b = ha.math("asin", x), torch.asin(x)
        bad += int((~((a.view(torch.int32) == b.view(torch.int32))
                      | (torch.isnan(a) & torch.isnan(b)))).sum())
    assert bad == 0


@pytest.mark.cuda
def test_card_w5_atan2_is_torchs(card):
    """W5's atan2 equals torch.atan2 on 2^26 pairs of random bit patterns
    and on every pair of +-0, +-inf, NaN, subnormals and a few normals."""
    gen = torch.Generator(device=card).manual_seed(11)
    r = lambda: torch.randint(-(1 << 31), 1 << 31, (1 << 26,), device=card,
                              generator=gen, dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                            1e-45, -1e-45, 1e-39, -1e-39, 1.1754942e-38, 1.0, -1.0,
                            0.5, -3.0, 1e30, -1e-30], device=card)
    sy, sx = torch.meshgrid(special, special, indexing="ij")
    for y, x in ((r(), r()), (sy.flatten(), sx.flatten())):
        a, b = ha.math("atan2", y, x), torch.atan2(y, x)
        assert bits_equal(a, b)


@pytest.mark.cuda
def test_card_renders_run_no_plain_formula(card, tmp_path, monkeypatch):
    """Cornell on the wavefront, the beach ball and the normal-mapped
    scenes on the card with the plain attribute formulas and the plain
    normal maps raising: W5 computes them, the maps too."""
    def plain(*args, **kw):
        raise AssertionError("the plain attribute stage ran on the card")

    monkeypatch.setattr(ha, "hit_attributes", plain)
    monkeypatch.setattr(ha, "_apply_normal_maps", plain)
    for name in ("cornell", "beach_ball", "normal_mapped", "instanced_mapped"):
        ha.reset_launches()
        img = _scene(name, tmp_path).render(
            samples_per_pixel=4, device=card, seed=1, output="linear")
        assert np.isfinite(img).all() and ha.launches() > 0


@pytest.mark.cuda
def test_card_gradient_through_w5_is_the_plain_stages(card, monkeypatch):
    """The inverse-rendering IoR gradient on the card with the attributes
    through W5 (`_Attrs`) equals the one through the plain stage bit for
    bit; two passes through W5 agree bit for bit."""
    from torch_inverse_rendering import build_scene

    from raytracer_tpu_torch.diff import differentiable_render, update_materials

    fn, data = differentiable_render(build_scene(1.3, 32, 24), 8, seed=0,
                                     device=card)

    def grad():
        x = data.mats.refr_n_re.clone().requires_grad_(True)
        loss = torch.mean(fn(update_materials(data, refr_n_re=x)) ** 2)
        return torch.autograd.grad(loss, x)[0]

    ha.reset_launches()
    g1, g2 = grad(), grad()
    assert ha.launches() > 0
    monkeypatch.setattr(ha, "attributes", ha.plain_attributes)
    ha.reset_launches()
    g_plain = grad()
    assert ha.launches() == 0
    assert torch.equal(g1, g2) and torch.equal(g1, g_plain)
    assert bool((g1 != 0).all())


@pytest.mark.cuda
def test_card_w5_rsqrt_is_torchs_on_every_float(card):
    """The backward's rsqrt (asin's derivative) equals torch.rsqrt on all
    2^32 floats (NaN against NaN)."""
    bad = 0
    for lo in range(0, 1 << 32, 1 << 28):
        x = (torch.arange(lo, lo + (1 << 28), device=card, dtype=torch.int64)
             .to(torch.int32).view(torch.float32))
        a, b = ha.math("rsqrt", x), torch.rsqrt(x)
        bad += int((~((a.view(torch.int32) == b.view(torch.int32))
                      | (torch.isnan(a) & torch.isnan(b)))).sum())
    assert bad == 0


@pytest.mark.cuda
def test_card_w5_backward_equals_the_plain_vjp(card, tmp_path, monkeypatch):
    """Every backward call of `_Attrs` in the IoR gradients of the glass
    sphere, its icosphere twin, Cornell and the primitives on the
    wavefront, recorded and replayed: W5's backward kernel gives the plain
    stage's VJP bit for bit; the gradients ran no plain formula and took no
    plain route."""
    import torch_cornellbox
    import torch_primitives
    from torch_inverse_rendering import build_mesh_scene, build_scene

    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from raytracer_tpu_torch.ops.plain_grad import recording

    real = ha.hit_attributes

    def raising(P, *args, **kw):
        if P.device.type == "cuda":
            raise AssertionError("the plain attribute formulas ran on the card")
        return real(P, *args, **kw)

    calls = []
    ha.reset_launches()
    for sc in (build_scene(1.3, 32, 24), build_mesh_scene(1.3, 32, 24, tmp_path),
               torch_cornellbox.build_cornell(32, 32),
               torch_primitives.primitives(32, 24)):
        fn, data = differentiable_render(sc, 4, seed=2, device=card)
        x = data.mats.refr_n_re.clone().requires_grad_(True)
        with monkeypatch.context() as m, recording(calls, ha._Attrs):
            m.setattr(ha, "hit_attributes", raising)
            loss = torch.mean(fn(update_materials(data, refr_n_re=x)) ** 2)
            torch.autograd.grad(loss, x)
    assert calls and ha.backward_launches() > 0
    for fn, call, xs, grads, wants in calls:
        kernel, plain = ha.backward_pair(fn, call, xs, grads, wants)
        got, want = kernel(), plain()
        assert all((a is None) == (b is None) and (a is None or bits_equal(a, b))
                   for a, b in zip(got, want))


@pytest.mark.cuda
def test_card_table_gradients_through_w5_are_the_plain_stages(card, tmp_path):
    """The sphere's gradient with respect to its spheres' centres and radii
    and the icosphere's with respect to its corners and corner normals on
    the card, W5's backward through its TABLES instance (no plain route),
    every recorded backward call of `_Attrs` replayed bit for bit against
    the plain stage's VJP; two passes agree bit for bit."""
    import dataclasses

    from torch_inverse_rendering import build_mesh_scene, build_scene

    from raytracer_tpu_torch.diff import differentiable_render
    from raytracer_tpu_torch.ops.plain_grad import recording

    cases = ((build_scene(1.3, 32, 24), ("sphere_center", "sphere_radius")),
             (build_mesh_scene(1.3, 32, 24, tmp_path),
              ("tri_p1", "tri_p2", "tri_p3", "tri_vn1", "tri_vn2", "tri_vn3")))
    for sc, names in cases:
        fn, data = differentiable_render(sc, 4, seed=2, device=card)

        def grad(calls):
            xs = {k: getattr(data.geom, k).clone().requires_grad_(True) for k in names}
            d = dataclasses.replace(data, geom=dataclasses.replace(data.geom, **xs))
            with recording(calls, ha._Attrs):
                return torch.autograd.grad(torch.mean(fn(d) ** 2), list(xs.values()))

        ha.reset_launches()
        calls = []
        g1, g2 = grad(calls), grad([])
        assert ha.backward_launches(tables=True) > 0
        for a, b in zip(g1, g2):
            assert bits_equal(a, b) and bool(torch.isfinite(a).all())
            assert bool((a != 0).any())
        for f, call, xs, grads, wants in calls:
            kernel, plain = ha.backward_pair(f, call, xs, grads, wants)
            assert all((a is None) == (b is None) and (a is None or bits_equal(a, b))
                       for a, b in zip(kernel(), plain()))


@pytest.mark.cuda
def test_card_map_gradient_through_w5_is_the_plain_stages(card, tmp_path):
    """The enclosed normal-mapped scene's gradient with respect to its map
    (every ref's texture), diffuse_color and the tables its maps read (the
    floor's u axis, the box's basis, the mesh's tangents) on the card: W5's
    backward through its MAPS instance, every recorded call of `_Attrs` bit
    for bit with the plain stage's VJP (the bases' product backward summed
    over the rays by cuBLAS in both); two passes bit-equal and finite."""
    import dataclasses

    import torch_features

    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from raytracer_tpu_torch.ops.plain_grad import recording

    sc = torch_features.normal_mapped(32, 24, obj_dir=tmp_path, enclosed=True)
    fn, data = differentiable_render(sc, 4, seed=2, device=card)
    tables = ("plane_u_axis", "box_basis", "tri_tan")

    def grad(calls):
        tex = data.textures[0].clone().requires_grad_(True)
        c = data.mats.diffuse_color.clone().requires_grad_(True)
        geom = {k: getattr(data.geom, k).clone().requires_grad_(True) for k in tables}
        d = update_materials(dataclasses.replace(
            data, textures=(tex, *data.textures[1:]),
            geom=dataclasses.replace(data.geom, **geom)), diffuse_color=c)
        with recording(calls, ha._Attrs):
            return torch.autograd.grad(torch.mean(fn(d) ** 2), (tex, c, *geom.values()))

    ha.reset_launches()
    calls = []
    g1, g2 = grad(calls), grad([])
    assert ha.backward_launches(maps=True) > 0
    for a, b in zip(g1, g2):
        assert bits_equal(a, b) and bool(torch.isfinite(a).all()) and bool((a != 0).any())
    for f, call, xs, grads, wants in calls:
        kernel, plain = ha.backward_pair(f, call, xs, grads, wants)
        assert kernel is not None
        assert all((a is None) == (b is None) and (a is None or bits_equal(a, b))
                   for a, b in zip(kernel(), plain()))
