"""The CUDA render kernels run on the CPU, through a stand-in CUDA runtime.

g++ compiles csrc/record_trace.cu and csrc/solid_trace.cu, the sources
nvcc builds, against csrc/emu/cuda_runtime.h (a std::thread per CUDA
thread, barriers for __syncthreads and the warp votes and shuffles,
atomics on std::atomic_ref) into one shared library, which the wrappers
launch in place of the nvcc build (`_launch(..., lib=)`) on CPU tensors.
Each kernel is held against its plain version on the CPU on the same
inputs: the fused record kernel (tracing, texel fetches and the path
integral in one pass) against records + replay on examples 1-4 and the
primitives example, the solid kernel against its plain version on a
Cornell chunk, and both on a scene whose tables pass the 48 KB of shared
memory a block gets without opting in (1,200 lights).  Without FMA contraction (-ffp-contract=off) the two round
alike, except where libm's cosf, sinf and expf and torch's CPU kernels
differ in the last bit: rays match at rtol 1e-4, atol 1e-5 on >= 99.9%,
the bit-equal share is printed, and rays_traced is equal or off only
through rays that are not bit-equal (a ray whose path the last bit of a
cosf turned traces other bounces).

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/record_trace.cu \\
        raytracer_tpu_torch/csrc/solid_trace.cu -o build/kernels_emu.so
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops import solid_trace as st

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_primitives  # noqa: E402
import torch_textured  # noqa: E402
from torch_cornellbox import build_cornell  # noqa: E402
from torch_features import many_lights  # noqa: E402

CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")
RTOL, ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999
SEED = (20261017, 4242, 0)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    out = tmp_path_factory.mktemp("emu") / "kernels_emu.so"
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "emu"), "-x", "c++",
                    str(CSRC / "record_trace.cu"), str(CSRC / "solid_trace.cu"),
                    "-o", str(out)], check=True, capture_output=True, timeout=300)
    return cuda_build.declare(ctypes.CDLL(str(out)))


def _report(name, L_k, L_p, n_k, n_p, max_bounces):
    """Match rate >= MATCH_RATE; rays_traced equal, or off only through
    rays whose L is not bit-equal (a ray traces at most max_bounces)."""
    match = torch.isclose(L_k, L_p, rtol=RTOL, atol=ATOL).all(dim=1)
    same = (L_k == L_p).all(dim=1) | (L_k.isnan() & L_p.isnan()).any(dim=1)
    print(f"{name}: {L_k.shape[0]} rays, match {match.float().mean().item():.6f}, "
          f"bit-equal {same.float().mean().item():.6f}, rays_traced {int(n_k)} "
          f"vs {int(n_p)}")
    assert match.float().mean().item() >= MATCH_RATE, name
    assert abs(int(n_k) - int(n_p)) <= max_bounces * int((~same).sum()), name
    assert torch.equal(torch.isfinite(L_k), torch.isfinite(L_p)), name


RECORD_SCENES = {
    "example1": lambda: torch_textured.example1(8, 8),
    "example2": lambda: torch_textured.example2(8, 8),
    "example3": lambda: torch_textured.example3(8, 8),
    "example4": lambda: torch_textured.example4(8, 8, blur=0.0),
    "primitives": lambda: torch_primitives.primitives(8, 8),
    # 1,200 lights: 53,420 bytes of tables, past the 48 KB without opt-in
    "many_lights": lambda: many_lights(8, 8, 1200, textured=True),
}


@pytest.mark.parametrize("name", list(RECORD_SCENES))
def test_record_kernel_on_the_cpu_matches_plain_version(emu_lib, name):
    sc = RECORD_SCENES[name]()
    static, tables, s = sc._settings_for_render()
    args = (torch.tensor(SEED, dtype=torch.int32), static, tables,
            cam_vec(sc.camera.params()), 8, 8, 4, s.max_bounces, s.split_k,
            s.sampler, s.projection)
    before = rt.record_trace_chunk.launches
    L_k, n_k = rt._launch(*args, lib=emu_lib)
    L_p, n_p = rt.record_trace_chunk(*args)
    assert rt.record_trace_chunk.launches == before
    _report(name, L_k, L_p, n_k, n_p, s.max_bounces)


SOLID_SCENES = {
    "cornell": lambda: build_cornell(16, 16),
    # 1,200 lights: 53,220 bytes of tables, past the 48 KB without opt-in
    "many_lights": lambda: many_lights(8, 8, 1200),
}


@pytest.mark.parametrize("name", list(SOLID_SCENES))
def test_solid_kernel_on_the_cpu_matches_plain_version(emu_lib, name):
    sc = SOLID_SCENES[name]()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    _, tables, s = sc._settings_for_render()
    args = (torch.tensor(SEED, dtype=torch.int32), tables,
            cam_vec(sc.camera.params()), W, H, 4 if name == "cornell" else 1,
            s.max_bounces)
    L_k, n_k = st._launch(*args, s.sampler, s.split_k, s.projection, lib=emu_lib)
    L_p, n_p = st.solid_trace_chunk(*args, s.split_k, s.sampler, s.projection)
    _report(name, L_k, L_p, n_k, n_p, s.max_bounces)


def test_stand_in_opts_in_past_48kb(emu_lib):
    """The info calls opt the kernels in past 48 KB and report the
    stand-in's limit as the card's opt-in maximum."""
    for textured in (False, True):
        static, tables, _ = many_lights(8, 8, 1200,
                                        textured)._settings_for_render()
        info = (rt.kernel_info(static, tables, emu_lib) if textured
                else st.kernel_info(tables, emu_lib))
        assert info["smem"] > cuda_build.SMEM_LIMIT
        assert info["smem_optin_max"] == cuda_build.SMEM_OPTIN_MAX
        assert info["blocks_per_sm"] == 1
