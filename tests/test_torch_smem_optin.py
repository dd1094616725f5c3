"""Kernel tables past 48 KB of shared memory.

A scene inside the JAX gates may hold more lights than the 48 KB of
dynamic shared memory a block gets by default: one Glossy sphere under
1,200 point lights (`examples/torch_features.py` `many_lights`) takes
53,220 bytes on the solid kernel, 53,420 with a textured sphere on the
record kernel.  The kernels opt in past 48 KB (trace_common.cuh
`smem_opt_in`), up to the H100's 227 KB; past that `route` sends the
scene to the wavefront, on every device alike, before any work.

Without a card: the sizes, the routes, the launch's own check, and the
renders on the CPU (the kernels' plain versions).

    python -m pytest --noconftest -m cuda tests/test_torch_smem_optin.py

holds both kernels bit for bit against their plain versions on the
1,200-light scenes on the card (tests/conftest.py imports jax).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops import solid_trace as st
from raytracer_tpu_torch.ops.cuda_build import SMEM_LIMIT, SMEM_OPTIN_MAX

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
from torch_features import many_lights  # noqa: E402

# lights that fit (1,200) and that pass the opt-in maximum (5,400)
FIT, PAST = 1200, 5400


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("textured,path,smem", [(False, "solid", 53220),
                                                (True, "record", 53420)])
def test_many_lights_take_their_kernel_past_48kb(textured, path, smem):
    static, tables, settings = many_lights(8, 8, FIT,
                                           textured)._settings_for_render()
    assert static.kernel_smem == smem
    assert SMEM_LIMIT < smem <= SMEM_OPTIN_MAX
    assert route(static, settings) == path
    size = (st._smem_bytes(tables) if path == "solid"
            else rt._smem_bytes(static, tables))
    assert size == smem


@pytest.mark.parametrize("textured", [False, True])
def test_tables_past_the_optin_maximum_take_the_wavefront(textured):
    sc = many_lights(8, 8, PAST, textured)
    static, _, settings = sc._settings_for_render()
    assert static.kernel_smem > SMEM_OPTIN_MAX
    assert static.pallas_ok or static.pallas_tex_ok     # inside the JAX gates
    assert route(static, settings) == "wavefront"
    with pytest.raises(ValueError, match="shared memory"):
        route(static, T.RenderSettings(use_pallas="always"))
    assert route(static, T.RenderSettings(use_pallas="never")) == "wavefront"


def test_launch_refuses_tables_past_the_optin_maximum():
    # route() gates these; the launch checks again before any CUDA call
    sc = many_lights(8, 8, PAST)
    _, tables, s = sc._settings_for_render()
    with pytest.raises(ValueError, match="shared memory"):
        st._launch(torch.zeros(3, dtype=torch.int32), tables,
                   cam_vec(sc.camera.params()), 8, 8, 1, s.max_bounces,
                   s.sampler, s.split_k, s.projection)


@pytest.mark.parametrize("textured", [False, True])
def test_many_lights_render_on_the_cpu(textured):
    img = many_lights(8, 8, FIT, textured).render(1, output="linear",
                                                  device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.max() > 0


def test_past_the_optin_maximum_renders_on_the_wavefront():
    # one bounce: the wavefront shades each of the 5,400 lights in turn
    sc = many_lights(4, 4, PAST)
    sc.settings = T.RenderSettings(max_bounces=1)
    img = sc.render(1, output="linear", device="cpu")
    assert img.shape == (4, 4, 3) and np.isfinite(img).all()
    assert img.max() > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_kernels_bit_equal_past_48kb(card, textured):
    sc = many_lights(64, 48, FIT, textured)
    static, tables, s = sc._settings_for_render()
    seed = torch.tensor((5, 77, 0), dtype=torch.int32, device=card)
    cam = cam_vec(sc.camera.params()).to(card)
    tab = tables.to(card)
    trace = (s.max_bounces, s.split_k, s.sampler, s.projection)
    if textured:
        args = (seed, static, tab, cam, 64, 48, 2) + trace
        L_k, n_k = rt.record_trace_chunk(*args)
        g, f, n_p = rt.record_trace_chunk_reference(*args)
        L_p = rt.replay(g, f, static, tab, s.max_bounces, 2 * 64 * 48)
        info = rt.kernel_info(static, tab)
    else:
        args = (seed, tab, cam, 64, 48, 2) + trace
        L_k, n_k = st.solid_trace_chunk(*args)
        L_p, n_p = st.solid_trace_chunk_reference(*args)
        info = st.kernel_info(tab)
    assert torch.equal(L_k, L_p) and int(n_k) == int(n_p)
    assert info["smem"] > SMEM_LIMIT and info["blocks_per_sm"] >= 1
    assert info["smem_optin_max"] >= SMEM_OPTIN_MAX
