"""W1, the wavefront's triangle sweep, run on the CPU through the stand-in
CUDA runtime.

g++ compiles csrc/mesh_sweep.cu, the source nvcc builds, against
csrc/emu/cuda_runtime.h (a std::thread per CUDA thread; the 64-bit
atomicMin of the key merge and cudaMemsetAsync as std::atomic_ref and
memset) into a library of its own, which the wrappers' `_*_launch`
functions take as `lib=` with CPU tensors.  All four entries are held bit
for bit against their plain versions (geometry/intersect.py): the
arithmetic is IEEE without contraction on both sides (-ffp-contract=off),
and the merges are exact.  The input is the edge scene of
tests/test_torch_mesh_sweep.py (`sweep_geom`): two records that tie at
every t (the one first in its tile's visit order wins, in tiles of 256
rays and in one tile), a row copied inside a cluster (the later row
wins), instances at scales 2 and 0.5, a record that runs into the next
region's rows and one into the padding, rays that miss everything, pairs
cut by `limit`, a shadow mask with false bits; the flat sweep at the
block size of 524,288 rays (128, where a row copied 128 rows on loses to
the earlier block) and of 1,536 (2,048, one short block, where it wins),
over 600 rows that neither divides.

By hand:

    g++ -std=c++20 -O1 -ffp-contract=off -fPIC -shared -pthread \\
        -I raytracer_tpu_torch/csrc/emu -x c++ \\
        raytracer_tpu_torch/csrc/mesh_sweep.cu -o build/mesh_sweep_emu.so
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import mesh_sweep
from raytracer_tpu_torch.utils.constants import FARAWAY

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "raytracer_tpu_torch" / "csrc"
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh_sweep import (FLAT_DUP, N_RAYS, RECORDS,  # noqa: E402
                                   sweep_geom, sweep_limits, sweep_rays)

BIG_N, SMALL_N = 524288, N_RAYS        # rays that make B = 128 and B = 2048


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build W1 for the CPU")
    out = tmp_path_factory.mktemp("emu") / "mesh_sweep_emu.so"
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "emu"), "-x", "c++",
                    str(CSRC / "mesh_sweep.cu"), "-o", str(out)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def scene():
    geom, flat, world = sweep_geom()
    O, D = sweep_rays(world)
    return geom, flat, O, D, sweep_limits()


@pytest.fixture(params=[256, isect.RAY_TILE], ids=["tiles_of_256", "one_tile"])
def tile(request, monkeypatch):
    monkeypatch.setattr(isect, "RAY_TILE", request.param)
    return request.param


def _equal(got, want, what):
    for name, a, b in zip(("t", "code"), got, want):
        assert torch.equal(a, b), f"{what} {name}: {int((a != b).sum())} differ"


@pytest.mark.parametrize("cut", [False, True], ids=["no_limit", "limit"])
def test_clustered_nearest_matches_plain(emu_lib, scene, tile, cut):
    geom, _, O, D, (limit, _, _, _) = scene
    if not cut:
        limit = torch.full_like(limit, FARAWAY)
    want = isect._clustered_nearest(O, D, geom, limit)
    before = mesh_sweep.clustered_nearest.launches
    t, code, rec = mesh_sweep._cluster_nearest_launch(O, D, geom, limit,
                                                      lib=emu_lib)
    assert mesh_sweep.clustered_nearest.launches - before == 2  # sweep, finish
    _equal((t, code), want, "clustered nearest")
    hit = code >= 0
    assert bool((~hit).any()) and bool(hit.any())
    assert torch.equal(rec < 0, ~hit)
    # the winning record holds the winner: its code lies in its virtual rows
    virt = geom.tri_cl_virt.to(torch.int64)[rec[hit]]
    assert bool((((code[hit] >> 1) - virt >= 0)
                 & ((code[hit] >> 1) - virt < isect.TRI_CLUSTER_SIZE)).all())
    assert bool(((rec == 2) | (rec == 3)).any())          # the scaled instances
    if tile == 256:
        assert bool((rec == 4).any()) and bool((rec == 0).any())   # the tie
    # the recompute that carries autograd past W1: t bit for bit
    assert torch.equal(isect.winner_t(O, D, geom, code,
                                      *isect.winner_rows(geom, code, rec)), t)


def test_limit_cuts_pairs(emu_lib, scene):
    geom, _, O, D, (limit, _, _, _) = scene
    counts = []
    for lim in (torch.full_like(limit, FARAWAY), limit):
        before = isect.SWEEP_STATS["pairs"]
        mesh_sweep._cluster_nearest_launch(O, D, geom, lim, lib=emu_lib)
        counts.append(isect.SWEEP_STATS["pairs"] - before)
    assert counts[1] < counts[0]


def test_clustered_occluded_matches_plain(emu_lib, scene, tile):
    geom, _, O, D, (_, mask, md, hit0) = scene
    want = isect._clustered_occluded(O, D, geom, mask, md, hit0)
    before = mesh_sweep.clustered_occluded.launches
    got = mesh_sweep._cluster_occluded_launch(O, D, geom, mask, md, hit0,
                                              lib=emu_lib)
    assert mesh_sweep.clustered_occluded.launches - before == 1
    assert torch.equal(got, want)
    assert bool(got.any()) and not bool(got.all())
    # the false mask bits hide occluders
    every = torch.ones_like(mask)
    assert not torch.equal(
        mesh_sweep._cluster_occluded_launch(O, D, geom, every, md, hit0,
                                            lib=emu_lib), got)


@pytest.mark.parametrize("n_for_b", [BIG_N, SMALL_N], ids=["B128", "B2048"])
def test_flat_nearest_matches_plain(emu_lib, scene, n_for_b, monkeypatch):
    """The plain sweep's block size is that of n_for_b rays; the kernel
    takes it from the same function."""
    _, flat, O, D, _ = scene
    B = isect._tri_block_size(n_for_b)
    assert B == (128 if n_for_b == BIG_N else 2048)
    size = isect._tri_block_size
    monkeypatch.setattr(isect, "_tri_block_size", lambda n: size(n_for_b))
    want = isect._flat_nearest(O, D, flat)
    before = mesh_sweep.flat_nearest.launches
    got = mesh_sweep._flat_nearest_launch(O, D, flat, lib=emu_lib)
    assert mesh_sweep.flat_nearest.launches - before == 1
    _equal(got, want, f"flat nearest, B {B}")
    assert flat.tri_p1.shape[0] % B
    v = got[1] >> 1
    won = FLAT_DUP[0] if B == 128 else FLAT_DUP[1]
    lost = FLAT_DUP[1] if B == 128 else FLAT_DUP[0]
    assert bool((v == won).any()) and not bool((v == lost).any())
    assert bool((got[1] < 0).any())
    assert torch.equal(isect.winner_t(O, D, flat, got[1],
                                      *isect.winner_rows(flat, got[1])), got[0])


def test_flat_occluded_matches_plain(emu_lib, scene):
    _, flat, O, D, (_, mask, md, _) = scene
    mask = mask[:flat.tri_p1.shape[0]].contiguous()
    want = isect._flat_occluded(O, D, flat, mask, md)
    before = mesh_sweep.flat_occluded.launches
    got = mesh_sweep._flat_occluded_launch(O, D, flat, mask, md, lib=emu_lib)
    assert mesh_sweep.flat_occluded.launches - before == 1
    assert torch.equal(got, want)
    assert bool(got.any()) and not bool(got.all())
    every = torch.ones_like(mask)
    assert not torch.equal(
        mesh_sweep._flat_occluded_launch(O, D, flat, every, md, lib=emu_lib), got)


def test_a_refused_launch_raises_and_counts_nothing(emu_lib, scene):
    _, flat, O, D, _ = scene
    rows = mesh_sweep.row_table(flat)
    t = torch.empty(4)
    code = torch.empty(4, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mesh_sweep._call(emu_lib, "mesh_flat_nearest", mesh_sweep._p(rows), 0,
                         128, mesh_sweep._p(O), mesh_sweep._p(D), 4,
                         mesh_sweep._p(t), mesh_sweep._p(code), None)


def test_records_cover_the_cases():
    """The edge scene's records: two instances at scales other than 1, a
    record into the next region, one into the padding, one tying."""
    geom, _, _ = sweep_geom()
    s = 1.0 / geom.inst_inv_scale
    assert sorted(float(x) for x in s) == [0.5, 1.0, 2.0]
    starts = [r[0] for r in RECORDS]
    T = geom.tri_p1.shape[0]
    assert any(a + isect.TRI_CLUSTER_SIZE > T for a in starts)
    assert starts.count(0) == 2
