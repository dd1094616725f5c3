"""The Hopper probes without JAX: the hand count's source lines, the
bound, the device default of Scene.render, and (`cuda`-marked) every
probe kernel against its plain version on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_probes_card.py

runs the card tests where there is a card (tests/conftest.py imports jax).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.probes import (common, dead_bounce, gather, isect_cost, issue_peak,
                                        roofline, tri_sweep)

ROOT = Path(__file__).resolve().parents[1]


def _cornell(W, H):
    sys.path.insert(0, str(ROOT / "examples"))
    from torch_cornellbox import build_cornell
    return build_cornell(W, H)


def test_slot_table_names_real_source_lines():
    csrc = ROOT / "raytracer_tpu_torch" / "csrc"
    for key, entry in roofline.SLOTS.items():
        path, line = entry["line"].split(":")
        assert int(line) <= len((csrc / path).read_text().splitlines()), key


def test_bound_takes_the_larger_time():
    ms, by = common.bound(33.5e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = common.bound(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Scene.render runs on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_render_without_device_needs_a_card(monkeypatch):
    sc = _cornell(8, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc.render(samples_per_pixel=1, output="linear")
    img = sc.render(samples_per_pixel=1, output="linear", device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_probes_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: gather.run({}), gather.profile_check, dead_bounce.run,
                tri_sweep.run, issue_peak.run,
                lambda: isect_cost.run({}, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            run()


def test_measured_tests_replace_the_hand_count():
    """roofline.work with measured test costs: equal to the hand count
    when they equal it, and one slot more a test adds the test count."""
    sc = _cornell(8, 8)
    _, tables, s = sc._settings_for_render()
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.ops import solid_trace as st
    ev = {}
    st.solid_trace_chunk_reference(torch.tensor([1, 2, 0], dtype=torch.int32), tables,
                                   cam_vec(sc.camera.params()), 8, 8, 2, s.max_bounces,
                                   counts=ev)
    costs = {k: 3.0 for k in ("div", "sqrt", "exp", "sin", "convert")}
    slots, _ = roofline.work("k1", ev, costs, 0)
    counted = {k: roofline.counted_test(k, costs) for k in roofline.KINDS}
    assert roofline.work("k1", ev, costs, 0, test_slots=counted)[0] == pytest.approx(slots)
    more = {k: v + 1.0 for k, v in counted.items()}
    n_tests = sum(v for k, v in ev.items() if k.startswith("tests_"))
    assert roofline.work("k1", ev, costs, 0, test_slots=more)[0] == pytest.approx(
        slots + n_tests)


def test_generic_planes_give_the_same_bits():
    """The axis-aligned planes of the nearest-hit probe through the
    generic formula: the same t, orientation and ids (plain version)."""
    tab, r = isect_cost.table("plane_aa", 16), isect_cost.rays(8192)
    from raytracer_tpu_torch.core.compile import OBJ_AA_N
    gen = isect_cost.generic_planes(tab)
    assert all(row[OBJ_AA_N] == -1 for row in gen.obj_rows)
    assert bool((gen.obj[:, OBJ_AA_N] == -1).all())
    got, want = isect_cost.isect(gen, r), isect_cost.isect(tab, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and bool((want[2] >= 0).any())


def test_no_probe_imports_jax():
    src = ROOT / "raytracer_tpu_torch"
    for path in list((src / "probes").glob("*.py")) + [src / "ops" / "cuda_build.py"]:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|raytracer_tpu)\b", text, re.M), path


# ---------------------------------------------------------------------------
# on the card: every probe kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the probe kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_p1_kernels_on_card(card):
    errs = issue_peak.check(issue_peak.inputs(4 * issue_peak.TILE, card), 4)
    assert errs["tree_fma"] == 0.0 and errs["chain_8x8"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["random", "edge"])
@pytest.mark.parametrize("warp", [False, True])
def test_p3_kernels_on_card(card, warp, inputs):
    """Both kernels bit for bit on random triangles, and on the edge input
    (ties inside a lane and across slices, rays that miss, ragged tiles)
    at its planned grid, which cuts the mesh unevenly; two launches a
    call, counted."""
    edge = inputs == "edge"
    arrays = tri_sweep.edge_inputs() if edge else tri_sweep.pairwise_inputs(512, 4096)
    mesh, o, d = (torch.from_numpy(a).to(card) for a in arrays)
    want = tri_sweep.pairwise_reference(mesh, o, d)
    if edge:
        assert tri_sweep.edge_cases_hold(want)
    before = tri_sweep.nearest.launches
    got, plan = tri_sweep._nearest_launch(mesh, o, d, warp)
    assert tri_sweep.nearest.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if edge:
        assert tri_sweep.ragged(plan, mesh.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("unrolled", [False, True])
def test_p4_kernels_on_card(card, unrolled):
    mesh, o, d = (torch.from_numpy(a).to(card) for a in tri_sweep.sweep_inputs(64))
    assert torch.equal(tri_sweep.sweep(mesh, o, d, 2, unrolled),
                       tri_sweep.sweep_reference(mesh, o, d, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "thread"])
def test_p5_kernels_on_card(card, form):
    x = torch.ones(4 * dead_bounce.TILE, device=card)
    for kill_after, half in dead_bounce.INPUTS.values():
        a = dead_bounce.bounces(x, kill_after, half, form)
        b = dead_bounce.bounce_reference(x, kill_after, half, form)
        assert torch.allclose(a, b, rtol=dead_bounce.CHECK_RTOL, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", gather.MODES)
def test_p6_kernels_on_card(card, mode):
    """The script's inputs, then the edge input at each modulus the mode
    takes (negative indices, int32 wrap, T <= 5 * 977, the smem cut)."""
    table, idx = (torch.from_numpy(a).to(card) for a in gather.inputs(1 << 16))
    t_mod = min(gather.T, gather.smem_entries()) if mode == "smem" else gather.T
    assert torch.equal(gather.gather(table, idx, mode, t_mod),
                       gather.gather_reference(table, idx, t_mod, mode != "base"))
    table, idx = (torch.from_numpy(a).to(card) for a in gather.edge_inputs())
    for t in gather.edge_moduli(mode, gather.smem_entries()):
        got = gather.gather(table, idx, mode, t)
        want = gather.gather_reference(table, idx, t, mode != "base")
        assert torch.equal(got, want), f"T = {t}: {int((got != want).sum())} rays differ"


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_p2_stream_kernel_on_card(card, fused):
    x = torch.rand(1 << 16, device=card) * 0.5 + 0.5
    for c in (4, 8, 16):
        roofline.stream_check(x, c, fused)          # raises on a mismatch


@pytest.mark.cuda
@pytest.mark.parametrize("kind", isect_cost.KINDS)
def test_isect_kernel_on_card(card, kind):
    tab, r = isect_cost.table(kind).to(card), isect_cost.rays(1 << 16, device=card)
    got, want = isect_cost.isect(tab, r), isect_cost.isect_reference(tab, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
