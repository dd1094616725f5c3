"""The redesigned solid kernel K1: persistent warps that refill their
free lanes from a work counter.

    python -m pytest --noconftest -m cuda tests/test_torch_k1_card.py

runs the card tests where there is a card (tests/conftest.py imports
jax): the kernel against its plain version bit for bit (L and
rays_traced) at ray counts that leave warps and blocks ragged (1, 31, 33,
4097), on a whole Cornell chunk (4.16 M rays), at max_bounces 1, and two
launches of one chunk against each other; and its lane count.  Without a
card: the plain version's lane efficiency, the wrapper's checks of the
lane-count buffer, and the tuning script's default build.
"""

import re
import sys
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.ops import solid_trace as st
from raytracer_tpu_torch.probes import dead_bounce

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
from torch_cornellbox import build_cornell  # noqa: E402


def chunk(width, height, spp, device, max_bounces=None, seed=(99, 4242, 0)):
    """solid_trace_chunk's arguments for a Cornell chunk on `device`."""
    sc = build_cornell(width, height)
    _, tables, s = sc._settings_for_render()
    return (torch.tensor(seed, dtype=torch.int32, device=device), tables.to(device),
            cam_vec(sc.camera.params()).to(device), width, height, spp,
            max_bounces or s.max_bounces, s.split_k, s.sampler, s.projection)


# ---------------------------------------------------------------------------
# without a card
# ---------------------------------------------------------------------------


def test_live_warps_pads_the_last_warp():
    alive = torch.zeros(70, dtype=torch.bool)
    alive[[3, 40, 69]] = True
    assert st.live_warps(alive).tolist() == [True, True, True]
    alive[40] = False
    assert st.live_warps(alive).tolist() == [True, False, True]


@pytest.mark.parametrize("max_bounces", [1, 6])
def test_plain_lane_efficiency(max_bounces):
    """One bounce keeps every lane busy; six leave lanes idle behind each
    warp's longest path, as the masks say."""
    args = chunk(32, 8, 2, "cpu", max_bounces)
    eff = dead_bounce.plain_lane_efficiency(args)
    events = {}
    st.solid_trace_chunk_reference(*args, counts=events)
    assert events["ray_bounces"] <= 32 * events["warp_bounces"]
    if max_bounces == 1:
        assert eff == 1.0 and events["warp_bounces"] == 32 * 8 * 2 // 32
    else:
        assert 0.3 < eff < 1.0


def test_lane_count_is_checked_and_needs_the_card():
    args = chunk(8, 8, 1, "cpu")
    seed, tables, cam, w, h, spp, mb, split_k, sampler, proj = args
    with pytest.raises(ValueError, match="lane_stats"):
        st._launch(seed, tables, cam, w, h, spp, mb, sampler, split_k, proj,
                   lane_stats=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="lane_stats"):
        st._launch(seed, tables, cam, w, h, spp, mb, sampler, split_k, proj,
                   lane_stats=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        dead_bounce.kernel_lane_efficiency(args)


def test_tuning_script_default_is_the_source_default():
    """scripts/torch_k1_tune.py times its first variant as the default
    build: it must be the kernel's own constants."""
    src = (ROOT / "raytracer_tpu_torch" / "csrc" / "solid_trace.cu").read_text()
    consts = [int(re.search(rf"#define {name} (\d+)", src).group(1))
              for name in ("K1_BLOCK", "K1_MIN_BLOCKS", "K1_REFILL_MIN", "K1_REFR_MIN")]
    tune = (ROOT / "scripts" / "torch_k1_tune.py").read_text()
    first = re.search(r"VARIANTS = \(\((\d+), (\d+), (\d+), (\d+)\)", tune).groups()
    assert [int(x) for x in first] == consts


def test_tuning_script_k2_default_is_the_source_default():
    """--kernel k2 times K2_VARIANTS' first entry as the default build: it
    must be the record kernel's own launch constants."""
    src = (ROOT / "raytracer_tpu_torch" / "csrc" / "record_trace.cu").read_text()
    consts = [int(re.search(rf"#define {name} (\d+)", src).group(1))
              for name in ("K2_BLOCK", "K2_MIN_BLOCKS")]
    tune = (ROOT / "scripts" / "torch_k1_tune.py").read_text()
    first = re.search(r"K2_VARIANTS = \(\((\d+), (\d+)\)", tune).groups()
    assert [int(x) for x in first] == consts


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bit_equal(args):
    before = st.solid_trace_chunk.launches
    L_k, n_k = st.solid_trace_chunk(*args)
    L_p, n_p = st.solid_trace_chunk_reference(*args)
    torch.cuda.synchronize()
    assert st.solid_trace_chunk.launches == before + 1
    assert int(n_k) == int(n_p)
    assert torch.equal(L_k, L_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_kernel_bit_equal_at_ragged_ray_counts(card, n):
    _bit_equal(chunk(n, 1, 1, card))


@pytest.mark.cuda
def test_kernel_bit_equal_on_a_cornell_chunk(card):
    _bit_equal(chunk(400, 400, 26, card))


@pytest.mark.cuda
def test_kernel_bit_equal_at_one_bounce(card):
    _bit_equal(chunk(64, 64, 4, card, max_bounces=1))


@pytest.mark.cuda
def test_two_launches_give_the_same_bits(card):
    args = chunk(400, 400, 4, card, seed=(7, 1, 3))
    (L1, n1), (L2, n2) = st.solid_trace_chunk(*args), st.solid_trace_chunk(*args)
    assert torch.equal(L1, L2) and int(n1) == int(n2)


@pytest.mark.cuda
def test_refilling_keeps_more_lanes_busy(card):
    args = chunk(400, 400, 4, card)
    kernel = dead_bounce.kernel_lane_efficiency(args)
    assert 0.0 < kernel <= 1.0
    assert kernel > dead_bounce.plain_lane_efficiency(args)
    info = st.kernel_info(args[1])
    assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
