"""The gather probe (P6) runs on the CPU, through the stand-in CUDA runtime.

g++ compiles csrc/probe_gather.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h (a std::thread per CUDA thread) into a library of
its own, which the wrapper launches in place of the nvcc build
(`gather._launch(..., lib=)`) on CPU tensors.  The stand-in has no
thread-block clusters, TMA bulk copies or mbarriers: the smem kernel keeps
them in one helper, `fill_table`, whose CUDA_EMU branch copies every
cluster rank's slice of the table with plain loads; everything else (the
remainder, the index steps, the wrap path, four rays a thread with the
ragged tail, the grid-stride walk, the summation order) is the code nvcc
builds.  The three modes are held bit for bit against `gather_reference`
(torch.remainder of the int32-wrapped sum, the float sum in the order
b = 0..5) on `gather.edge_inputs`: a ray count off the rays of a thread
and of a block, negative indices, indices at and past every modulus, every
index within 4,886 of 2^31 - 1, and the moduli 1 to 4,886 (where 5 * 977
passes T), the smem cut and the script's T, over a table of random int32
values whose float sums round.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/probe_gather.cu -o build/probe_gather_emu.so
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.probes import gather

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the probes for the CPU")
    out = tmp_path_factory.mktemp("emu") / "probe_gather_emu.so"
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "emu"), "-x", "c++",
                    str(CSRC / "probe_gather.cu"), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def edge():
    table, idx = (torch.from_numpy(a) for a in gather.edge_inputs())
    return table, idx


def test_edge_input_holds_its_cases(edge):
    table, idx = edge
    n = idx.numel()
    assert n % 4 and n % (4 * 256) and n % (4 * 1024)
    top = torch.arange(gather.INT32_MAX - 4886, gather.INT32_MAX + 1, dtype=torch.int32)
    assert bool(torch.isin(top, idx).all())
    assert int((idx < 0).sum()) > n // 4
    for t in gather.EDGE_MODULI:
        assert bool(((idx >= t) & (idx < 2 * t)).any())
    # the float sums round: the sum of six fetches depends on its order
    flat = table.reshape(-1)
    ix = [torch.remainder(idx + b * gather.STRIDE, gather.T).long() for b in range(6)]
    fwd = gather.gather_reference(table, idx)
    rev = torch.zeros_like(fwd)
    for b in reversed(range(6)):
        rev = rev + flat[ix[b]].to(torch.float32)
    assert bool((fwd != rev).any())


def test_plan_of_the_stand_in(emu_lib):
    """2 SMs of one resident block each, one cluster; the cut is the opt-in
    shared memory less the 16-byte barrier."""
    p = gather.plan(emu_lib)
    assert p["sms"] == 2 and p["ldg_blocks"] == 2 and p["base_blocks"] == 2
    assert p["smem_blocks"] == p["cluster"] >= 2
    assert p["smem_entries"] == (227 * 1024 - 16) // 4 == 58108


@pytest.mark.parametrize("mode", gather.MODES)
def test_p6_kernel_on_the_cpu_matches_plain_version(emu_lib, edge, mode):
    table, idx = edge
    before = gather.gather.launches
    moduli = gather.edge_moduli(mode, gather.plan(emu_lib)["smem_entries"])
    assert len(moduli) == (len(gather.EDGE_MODULI) - 2 if mode == "smem"
                           else len(gather.EDGE_MODULI))
    for t in moduli:
        got = gather._launch(table, idx, mode, t, lib=emu_lib)
        want = gather.gather_reference(table, idx, t, mode != "base")
        assert torch.equal(got, want), f"T = {t}: {int((got != want).sum())} rays differ"
    assert gather.gather.launches - before == len(moduli)


@pytest.mark.parametrize("mode", gather.MODES)
@pytest.mark.parametrize("n", [1, 2, 5, 2051])
def test_p6_ragged_counts(emu_lib, mode, n):
    """Counts that leave 1-3 rays of a thread's four, and one ray more
    than the grid's first sweep (2 blocks x 256 threads x 4 rays)."""
    table, idx = (torch.from_numpy(a) for a in gather.inputs(128 * 17))
    idx = idx.reshape(-1)[:n].clone() - 50_000
    t = 4886 if mode == "smem" else gather.T
    got = gather._launch(table, idx, mode, t, lib=emu_lib)
    assert torch.equal(got, gather.gather_reference(table, idx, t, mode != "base"))


def test_p6_scripts_input(emu_lib):
    """The script's inputs, 2 tiles of 128 x 128 rays."""
    table, idx = (torch.from_numpy(a) for a in gather.inputs(2 * 128 * 128))
    for mode in gather.MODES:
        t = 58108 if mode == "smem" else gather.T
        assert torch.equal(gather._launch(table, idx, mode, t, lib=emu_lib),
                           gather.gather_reference(table, idx, t, mode != "base"))


def test_p6_wrapper_refuses(emu_lib):
    """A modulus outside the table (smem: past its cut, or past a table
    smaller than the cut), a misaligned idx or table, a wrong dtype:
    ValueError before any launch; no rays: no launch."""
    table, idx = (torch.from_numpy(a) for a in gather.inputs(1024))
    small = table.reshape(-1)[:4096]
    before = gather.gather.launches
    for mode, tab, t in (("ldg", table, 0), ("ldg", table, table.numel() + 1),
                         ("smem", table, 58109), ("smem", small, 4097),
                         ("base", small, 4097)):
        with pytest.raises(ValueError, match="modulus"):
            gather._launch(tab, idx, mode, t, lib=emu_lib)
    with pytest.raises(ValueError, match="aligned"):
        gather._launch(table, idx.reshape(-1)[1:], "ldg", gather.T, lib=emu_lib)
    with pytest.raises(ValueError, match="aligned"):
        gather._launch(table.reshape(-1)[1:], idx, "smem", 4886, lib=emu_lib)
    with pytest.raises(ValueError, match="int32"):
        gather._launch(table, idx.long(), "ldg", gather.T, lib=emu_lib)
    out = gather._launch(table, idx[:0], "ldg", gather.T, lib=emu_lib)
    assert out.shape == (0, 128) and gather.gather.launches == before
