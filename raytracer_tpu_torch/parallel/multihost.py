"""One render across several processes (torch.distributed).

Counterpart of raytracer_tpu/parallel/multihost.py.  Every process calls
`render_multihost` with the same scene and arguments.  The render is one
global ("sample", "pixel") mesh of shards (parallel/sharded.py); the
shards are dealt out in contiguous blocks, process r running block r on
its own device.  Each process:

* runs Scene.render over the global mesh (`Mesh.owned`, `exchange` and
  `share` tell that loop which shards are this process's);
* compiles the scene and then takes process 0's tables (a broadcast of
  every tensor: the JAX package's broadcast_one_to_all), so that all
  trace the same bytes;
* runs its shards of each chunk, exactly as a single process runs them
  (the same seed rows, lattice offsets and routes);
* gathers every process's per-shard sums (all_gather) and adds them in
  the single process's fixed shard order on every process, so each
  process assembles the same frame, and that frame equals the same
  global mesh rendered in one process.

`init_distributed` joins the process group: NCCL when every process has
a GPU of its own, gloo otherwise (two NCCL ranks cannot share one GPU;
gloo gathers through host memory).  With no process group (or one
process) the collectives are skipped, so the same entry point serves one
process.  Across GPUs this path is not verified: the card's machine has
one H100, where two gloo processes share it.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from .sharded import Mesh, render_sharded

__all__ = ["init_distributed", "render_multihost"]

# how long a collective waits for the other processes before it raises
TIMEOUT_S = 300


def init_distributed(coordinator_address, num_processes, process_id,
                     backend=None):
    """Join this process to a group of `num_processes` (multihost.py:38):
    coordinator_address "host:port" of process 0's rendezvous (a free
    port), process_id this process's rank.  backend: "nccl" when every
    process has a GPU of its own (this process then takes cuda:process_id
    mod the visible GPUs), else "gloo" (the default without that many
    GPUs).  Returns the backend."""
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= num_processes else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


def _group():
    """(world size, rank, the collectives' device) of the process group;
    (1, 0, None) without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, None
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    return dist.get_world_size(), dist.get_rank(), comm


def _broadcast(obj, comm):
    """obj (a dataclass of tensors and tuples of them) with every tensor
    replaced by process 0's, on obj's device."""
    def bc(v):
        if isinstance(v, torch.Tensor):
            buf = v.to(comm).contiguous().clone()
            dist.broadcast(buf, 0)
            return buf.to(v.device)
        if isinstance(v, tuple):
            return tuple(bc(x) for x in v)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: bc(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v
    return bc(obj)


def _gather_shards(world, comm, per_rank):
    """A mesh's exchange (build_sharded_chunk): every process's shard
    sums, stacked in shard order, gathered to all."""
    def exchange(parts):
        keys = sorted(parts)
        out = parts[keys[0]][0].device
        with_sq = parts[keys[0]][1] is not None
        stack = lambda i: torch.stack([parts[k][i] for k in keys]).to(comm)
        fields = [stack(0)] + ([stack(1)] if with_sq else []) + [stack(2)]
        got = []
        for f in fields:
            bufs = [torch.empty_like(f) for _ in range(world)]
            dist.all_gather(bufs, f)
            got.append([b.to(out) for b in bufs])
        full = {}
        for r in range(world):
            for j, k in enumerate(per_rank[r]):
                full[k] = (got[0][r][j], got[1][r][j] if with_sq else None,
                           got[-1][r][j])
        return full
    return exchange


def render_multihost(scene, samples_per_pixel, mesh=None, seed=0,
                     n_pixel_shards=1, device=None):
    """Render `scene` across every process of the group (multihost.py:62);
    each returns the assembled (H, W, 3) sRGB float32 array.

    mesh: the global mesh; only its shape is read (a process runs its
    shards on `device`).  By default (processes / n_pixel_shards,
    n_pixel_shards): a shard a process.  The shards, in row-major (s, p)
    order, go to the processes in contiguous blocks.  device: this
    process's device; default its GPU under NCCL, else "cuda", which
    raises without a CUDA device (the CPU only when asked, "cpu").  The
    render is Scene.render's over the global mesh (render_sharded), so
    one process with the same mesh gives Scene.render(mesh=...)'s
    frame."""
    from ..core.ray import resolve_device

    world, rank, comm = _group()
    if device is None and comm is not None and comm.type == "cuda":
        device = comm
    device = resolve_device(device, "render_multihost")
    shape = ((world // n_pixel_shards, n_pixel_shards) if mesh is None
             else (mesh.shape["sample"], mesh.shape.get("pixel", 1)))
    keys = [(s, p) for s in range(shape[0]) for p in range(shape[1])]
    if not keys or len(keys) % world:
        raise ValueError(f"{len(keys)} shards do not split over {world} "
                         "processes")
    k = len(keys) // world
    per_rank = [keys[r * k:(r + 1) * k] for r in range(world)]
    grid = np.empty(shape, dtype=object)
    grid[:] = device
    gmesh = Mesh(grid, ("sample", "pixel"))
    gmesh.owned = {key: device for key in per_rank[rank]}
    if world > 1:
        gmesh.exchange = _gather_shards(world, comm, per_rank)
        gmesh.share = lambda tables, data: (_broadcast(tables, comm),
                                            _broadcast(data, comm))
    return render_sharded(scene, samples_per_pixel, mesh=gmesh, seed=seed,
                          device=device)
