"""One render across two processes through the port
(raytracer_tpu_torch/parallel/multihost.py), as tests/test_multihost.py
holds the JAX package's.

Two gloo processes (tests/torch_multihost_runner.py, each with a
timeout) render the two-process scene over a global 4x2 mesh, four
shards a process, at four seeds: both assemble the same frames, equal bit
for bit to the same mesh rendered in one process (render_multihost
without a process group, and Scene.render(mesh=...)), and equal to the
JAX package's sharded render of the scene over a 4x2 mesh of its eight
virtual CPU devices within 4 standard errors of the seed-to-seed scatter
(image and 3x3 region means).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.parallel.sharded import make_mesh as jmake_mesh
from raytracer_tpu.parallel.sharded import render_sharded as jrender_sharded
from raytracer_tpu_torch.parallel.multihost import render_multihost
from raytracer_tpu_torch.parallel.sharded import make_mesh, render_sharded

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_multihost_runner as runner  # noqa: E402

RUNNER = str(HERE / "torch_multihost_runner.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


SEEDS = (0, 1, 2, 3)


def test_two_process_render_agrees(tmp_path):
    port = _free_port()
    out = str(tmp_path / "mh")
    procs = [subprocess.Popen([sys.executable, RUNNER, str(rank), "2",
                               str(port), out, "cpu",
                               ",".join(map(str, SEEDS))],
                              env=dict(os.environ), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    img0, img1 = np.load(out + ".rank0.npy"), np.load(out + ".rank1.npy")
    assert img0.shape == (len(SEEDS), 16, 16, 3)
    assert np.array_equal(img0, img1)

    # the same global mesh in one process: the same frames bit for bit
    torch.set_num_threads(1)
    for k, s in enumerate(SEEDS):
        one = render_multihost(runner.scene(T), 8, seed=s,
                               mesh=runner.mesh("cpu"), device="cpu")
        assert np.array_equal(one, img0[k]), s
    assert np.array_equal(render_sharded(runner.scene(T), 8, seed=0,
                                         mesh=runner.mesh("cpu")), img0[0])
    assert np.isfinite(img0).all() and 0.0 < img0.mean() < 1.0

    # and the JAX package's sharded render of the scene over the same
    # 4x2 mesh shape, by the seed-to-seed scatter of the image and region
    # means (the two packages draw different numbers)
    jimg = np.stack([jrender_sharded(runner.scene(J), 8, seed=s,
                                     mesh=jmake_mesh(4, 2)) for s in SEEDS])
    bands = np.array_split(np.arange(16), 3)
    stats = [(img0.mean((1, 2, 3)), jimg.mean((1, 2, 3)))] + [
        (img0[:, r][:, :, c].mean((1, 2, 3)),
         jimg[:, r][:, :, c].mean((1, 2, 3))) for r in bands for c in bands]
    for a, b in stats:
        se = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / len(SEEDS))
        assert abs(a.mean() - b.mean()) <= 4 * se + 1e-6, (a, b, se)


def test_single_process_mesh_defaults():
    # no process group: every shard here; the default mesh is one shard
    sc = runner.scene(T)
    a = render_multihost(sc, 2, seed=1, device="cpu")
    b = render_sharded(sc, 2, seed=1,
                       mesh=make_mesh(1, 1, [torch.device("cpu")]))
    assert np.array_equal(a, b)


def test_default_device_is_the_card():
    # no device and no NCCL group: the CUDA device, which raises without
    # one (the CPU only when asked)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="render_multihost runs on the "
                       "CUDA device"):
        render_multihost(runner.scene(T), 1)
