"""The ray x triangle probes (P3, P4) run on the CPU, through the stand-in
CUDA runtime.

g++ compiles csrc/probe_tri.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h (a std::thread per CUDA thread, barriers for
__syncthreads and the warp reductions) into a library of its own, which
the wrappers launch in place of the nvcc build (`_nearest_launch(...,
lib=)`, `_sweep_launch(..., lib=)`) on CPU tensors.  Both P3 kernels
(tri_thread: rays in threads over triangle slices; tri_warp: triangles in
lanes over ray groups) and the P4 sweeps are held bit for bit against
their plain versions, `pairwise_reference` and `sweep_reference`: the
arithmetic is IEEE without contraction on both sides (-ffp-contract=off),
and the merge's least (t, id) is exact.  P3's input is
`tri_sweep.edge_inputs`: a ray count off the kernels' ray tiles, a mesh
whose slices do not divide it, a copy of triangle 0 in the last slice
(the tie crosses the split; the lower id wins) and rays that miss every
triangle.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/probe_tri.cu -o build/probe_tri_emu.so
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.probes import tri_sweep

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the probes for the CPU")
    out = tmp_path_factory.mktemp("emu") / "probe_tri_emu.so"
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "emu"), "-x", "c++",
                    str(CSRC / "probe_tri.cu"), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


def _edge(n_blocks, n_rays):
    mesh, o, d = (torch.from_numpy(a) for a in tri_sweep.edge_inputs(n_blocks, n_rays))
    ref = tri_sweep.pairwise_reference(mesh, o, d)
    assert tri_sweep.edge_cases_hold(ref)
    return (mesh, o, d), ref


# the stand-in reports 2 SMs of 1 resident block each, so the plan fills 2
# blocks: tri_thread cuts the mesh into 2 slices when the rays are one
# 512-ray tile, tri_warp cuts the rays into 2 groups when the mesh is one
# slice of 4 blocks.  (mesh blocks, rays): the (ray groups, slices, mesh
# blocks a slice) of tri_thread, then of tri_warp
CASES = {
    "ragged_slices": ((5, 300), (1, 2, 3), (1, 2, 4)),        # 3 + 2, 4 + 1
    "one_block_a_slice": ((2, 300), (1, 2, 1), (2, 1, 4)),
    "ragged_groups": ((3, 201), (1, 2, 2), (2, 1, 4)),       # 100 + 101 rays
    "two_ray_tiles": ((5, 700), (2, 1, 5), (1, 2, 4)),       # 512 + 188 rays
    "one_mesh_block": ((1, 130), (1, 1, 1), (2, 1, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("warp", [False, True], ids=["thread", "warp"])
def test_p3_kernel_on_the_cpu_matches_plain_version(emu_lib, warp, case):
    (n_blocks, n_rays), *plans = CASES[case]
    (mesh, o, d), ref = _edge(n_blocks, n_rays)
    before = tri_sweep.nearest.launches
    got, plan = tri_sweep._nearest_launch(mesh, o, d, warp, lib=emu_lib)
    assert tri_sweep.nearest.launches - before == 2     # the sweep and tri_finish
    assert plan == plans[warp]
    for name, a, b in zip(("t", "id", "n"), got, ref):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"


@pytest.mark.parametrize("warp", [False, True], ids=["thread", "warp"])
def test_p3_plan_splits_as_stated(emu_lib, warp):
    """tri_thread: one ray group a 512-ray tile, as few slices as fill the
    resident blocks; tri_warp: 4 mesh blocks a slice, as many ray groups
    as fill them (at most one a ray).  A launch with no rays fails and
    counts no launch."""
    mesh, o, d = (torch.from_numpy(a) for a in tri_sweep.pairwise_inputs(7 * 128, 1100))
    _, plan = tri_sweep._nearest_launch(mesh, o, d, warp, lib=emu_lib)
    assert plan == ((1, 2, 4) if warp else (3, 1, 7))
    assert tri_sweep.ragged(plan, 7) == warp
    _, plan = tri_sweep._nearest_launch(mesh[:1], o[:, :1].contiguous(),
                                     d[:, :1].contiguous(), warp, lib=emu_lib)
    assert plan == ((1, 1, 4) if warp else (1, 1, 1))
    before = tri_sweep.nearest.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tri_sweep._nearest_launch(mesh, o[:, :0], d[:, :0], warp, lib=emu_lib)
    assert tri_sweep.nearest.launches == before


def test_p4_launches_are_counted(emu_lib):
    mesh, o, d = (torch.from_numpy(a) for a in tri_sweep.sweep_inputs(64, 40))
    before = tri_sweep.sweep.launches
    tri_sweep._sweep_launch(mesh, o, d, 2, False, lib=emu_lib)
    assert tri_sweep.sweep.launches == before + 1


@pytest.mark.parametrize("rows,unrolled", [(64, False), (64, True), (512, False),
                                           (512, True)])
def test_p4_kernel_on_the_cpu_matches_plain_version(emu_lib, rows, unrolled):
    mesh, o, d = (torch.from_numpy(a) for a in tri_sweep.sweep_inputs(rows, 200))
    got = tri_sweep._sweep_launch(mesh, o, d, 3, unrolled, lib=emu_lib)
    assert torch.equal(got, tri_sweep.sweep_reference(mesh, o, d, 3))
