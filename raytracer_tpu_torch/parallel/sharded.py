"""Multi-device rendering over a ("sample", "pixel") grid of devices.

Counterpart of raytracer_tpu/parallel/sharded.py, which runs a
shard_map over a JAX device mesh.  Here a mesh is a small grid of torch
devices (`Mesh`, `make_mesh`) and a sharded chunk is a host loop over
its shards:

* axis "sample": each shard traces its own slice of the chunk's samples
  over the whole frame (or its band), continuing the one global R2
  lattice at sample0 + s * spp_dev;
* axis "pixel": each shard traces only its band of height / pixel film
  rows.

`build_sharded_chunk` is the one chunk of every render: Scene.render
runs it over the mesh it is given, or over a 1x1 mesh of its device.
Each shard runs, on its own device, with one pixel shard the solid
kernel or the record kernel when `route` says so (their plain versions
on the CPU), otherwise the wavefront on the shard's band.  The shards' per-pixel sums (and sums of
squares) are moved to the output device and added in a fixed shard order,
sample shard 0 first, so the reduce is deterministic: no atomics, no
collective.  A shard's seed row is a function of the chunk's row and its
(s, p) place (`shard_seed_row`); shard (0, 0) keeps the chunk's row, so
a 1x1 mesh renders Scene.render()'s image bit for bit.

A mesh may repeat a device: the CPU tests stand in for the JAX tests'
eight virtual CPU devices with `make_mesh(4, 2, [torch.device("cpu")] *
8)`, and one H100 runs a 4x1 or 2x2 grid of "cuda:0"s.  Shards on other
CUDA devices are launched under that device (`torch.cuda.device`);
across several GPUs this path is not verified (one card was available).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.record_trace import record_trace_chunk
from ..ops.solid_trace import solid_trace_chunk
from ..utils.colour import srgb_linear_to_srgb

# the JAX module's functions; Mesh, check_mesh, shard_seed and
# shard_seed_row are this port's own
__all__ = ["make_mesh", "plan_spp_per_device", "build_sharded_render",
           "build_sharded_chunk", "render_sharded"]


class Mesh:
    """A grid of torch devices with named axes (the jax.sharding.Mesh
    subset the renders read): `devices` a numpy object array of
    torch.device, one dimension an axis; `axis_names`; and `shape`
    {axis name: extent}.

    A mesh that spans processes (parallel/multihost.py) also sets
    `owned`, the {(s, p): device} shards this process runs; `exchange`,
    which gathers every process's shard sums (build_sharded_chunk); and
    `share`, which replaces a render's (tables, data) by process 0's
    (Scene.render).  A mesh of one process leaves them None."""

    owned = exchange = share = None

    def __init__(self, devices, axis_names=("sample", "pixel")):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D grid of devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def make_mesh(n_sample_shards=None, n_pixel_shards=1, devices=None):
    """A ("sample", "pixel") mesh over `devices` (sharded.py:33): by
    default every visible CUDA device, so 1x1 on one card.  A list may
    repeat a device (several shards on one card or on the CPU)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "make_mesh found no CUDA device; pass devices= (for "
                "example [torch.device('cpu')] * 8) to shard on the CPU")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_sample_shards is None:
        n_sample_shards = n // n_pixel_shards
    if n_sample_shards * n_pixel_shards != n or n_sample_shards < 1:
        raise ValueError(f"{n_sample_shards}x{n_pixel_shards} mesh != {n} "
                         "devices")
    grid = np.empty((n_sample_shards, n_pixel_shards), dtype=object)
    for i, d in enumerate(devices):
        grid[i // n_pixel_shards, i % n_pixel_shards] = d
    return Mesh(grid, ("sample", "pixel"))


def check_mesh(mesh, height=None, what="render"):
    """(sample shards, pixel shards) of a mesh, validated as the JAX
    package validates it (core/scene.py:451-460): a "sample" axis, and a
    height that the pixel shards divide."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, dict) or "sample" not in shape \
            or not hasattr(mesh, "devices"):
        raise ValueError(f"{what}: mesh must have a 'sample' axis "
                         "(parallel.sharded.make_mesh)")
    n_sample, n_pixel = shape["sample"], shape.get("pixel", 1)
    if height is not None and height % n_pixel:
        raise ValueError(f"height {height} % pixel shards {n_pixel} != 0")
    for d in np.asarray(mesh.devices, dtype=object).reshape(-1):
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{what}: the mesh names {d} and there is no "
                               "CUDA device")
    return n_sample, n_pixel


def plan_spp_per_device(samples_per_pixel, diffuse_fan, split_k, n_sample):
    """Samples a device traces in a sharded render (sharded.py:45): the
    diffuse fan and the 2^split_k branch patterns fold into the count,
    which is split over the sample shards and rounded up to whole pattern
    blocks (the 2F / 2T split weights average out only per block)."""
    eff_spp = samples_per_pixel * diffuse_fan * (1 << split_k)
    spp_per_device = -(-eff_spp // n_sample)
    split_fan = 1 << split_k
    return -(-spp_per_device // split_fan) * split_fan


def shard_seed(seed, s, p):
    """The chunk seed of shard (s, p) of a chunk seeded `seed`: the seed
    itself for (0, 0), else a draw of numpy's SeedSequence keyed by
    (seed, s, p)."""
    if s == 0 and p == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(s), int(p)])
               .generate_state(1)[0] & 0x7FFFFFFF)


def shard_seed_row(row, s, p, spp_dev):
    """Shard (s, p)'s host row [chunk seed, R2 rotation seed, first
    sample] of a chunk's `chunk_seeds` row: its own chunk seed, the
    render's rotation seed, and the chunk's first sample advanced by s
    shards of spp_dev samples (the one global lattice)."""
    out = np.asarray(row, np.int64).copy()
    out[0] = shard_seed(row[0], s, p)
    out[2] = int(row[2]) + s * spp_dev
    return out.astype(np.int32)


def _on(device):
    """A context that makes `device` current for CUDA launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def build_sharded_chunk(static, settings, mesh, width, height, spp_dev,
                        with_sq=False, path=None):
    """ONE sharded chunk of Scene.render's loop (sharded.py:145); every
    render of the port runs its chunks through it, an unsharded one over
    a 1x1 mesh.

    path: the route of an unsharded render (`core.scene.route`; by
    default from static and settings).  With one pixel shard a "solid"
    or "record" scene runs that kernel on each sample shard; every other
    case runs the wavefront on each shard's band.

    Returns run(seed_row, tables, data, camera, clamp=None, out=None) ->
    (L_sum, [L2_sum,] stats) over n_sample * spp_dev samples: seed_row the
    chunk's `chunk_seeds` row (its sample0 is the chunk's first global
    sample), tables / data the scene's SolidTables and SceneData (on any
    device: each shard moves them to its own), camera the Camera's
    params(), clamp an optional per-sample ceiling, out the output device
    (default the mesh's first).  L_sum (H * W, 3) and stats
    {"rays_traced": 0-dim int64} sum over the whole mesh.

    run.stage(seeds, tables, data, camera) moves a whole render's
    constants to each shard's device once (every chunk's seed row, the
    tables or the data, the camera) and returns chunk(i, clamp=None,
    out=None), run's result for row i of `seeds`.

    A mesh of parallel/multihost.py spans processes: its `owned`
    {(s, p): device} names the shards this process runs, and its
    `exchange` takes this process's {(s, p): (L, L2 or None, rays)} and
    returns every shard's."""
    from ..core.camera import cam_vec
    from ..core.scene import _chunk_sums, route, wavefront_rows

    n_sample, n_pixel = check_mesh(mesh, height, "build_sharded_chunk")
    rows = height // n_pixel
    path = path or route(static, settings)
    kernel = path if n_pixel == 1 and path in ("solid", "record") else None
    trace_args = (settings.max_bounces, settings.split_k, settings.sampler,
                  settings.projection)
    owned, exchange = getattr(mesh, "owned", None), getattr(mesh, "exchange",
                                                            None)
    shards = [(s, p, torch.device(owned[(s, p)] if owned is not None
                                  else mesh.devices[s, p]))
              for s in range(n_sample) for p in range(n_pixel)
              if owned is None or (s, p) in owned]

    def trace_shard(p, row, tab, cam):
        if kernel == "solid":
            return solid_trace_chunk(row, tab, cam, width, height, spp_dev,
                                     *trace_args)
        if kernel == "record":
            return record_trace_chunk(row, static, tab, cam, width, height,
                                      spp_dev, *trace_args)
        return wavefront_rows(row, static, tab, cam, settings, width, height,
                              spp_dev, row0=p * rows, rows=rows)

    def stage(seeds, tables, data, camera):
        seeds = np.asarray(seeds).reshape(-1, 3)
        staged = []
        for s, p, dev in shards:
            own = np.stack([shard_seed_row(r, s, p, spp_dev) for r in seeds])
            if kernel is not None:
                # the kernels read their seed row on the device
                staged.append((s, p, dev, torch.from_numpy(own).to(dev),
                               tables.to(dev), cam_vec(camera).to(dev)))
            else:
                staged.append((s, p, dev, own, data.to(dev), camera))

        def chunk(i, clamp=None, out=None):
            out = torch.device(out) if out is not None else shards[0][2]
            parts = {}
            for s, p, dev, own, tab, cam in staged:
                with _on(dev):
                    L, cnt = trace_shard(p, own[i], tab, cam)
                    L, L2 = _chunk_sums(L, spp_dev, rows * width, clamp,
                                        with_sq)
                parts[(s, p)] = (L.to(out), None if L2 is None else L2.to(out),
                                 cnt.to(out))
            if exchange is not None:
                parts = exchange(parts)
            return _reduce(parts, n_sample, n_pixel, with_sq, out)

        return chunk

    def run(seed_row, tables, data, camera, clamp=None, out=None):
        return stage(seed_row, tables, data, camera)(0, clamp, out)

    run.stage = stage
    return run


def _reduce(parts, n_sample, n_pixel, with_sq, out):
    """(L_sum, [L2_sum,] stats) of every shard's sums {(s, p): (L, L2,
    rays)}: within a band the sample shards are added in order, s = 0
    first; the bands are stacked in order."""
    bands, bands2 = [], []
    rays = None
    for p in range(n_pixel):
        acc = acc2 = None
        for s in range(n_sample):
            L, L2, cnt = parts[(s, p)]
            acc = L if acc is None else acc + L
            if with_sq:
                acc2 = L2 if acc2 is None else acc2 + L2
            rays = cnt if rays is None else rays + cnt
        bands.append(acc)
        bands2.append(acc2)
    stats = {"rays_traced": rays}
    L = bands[0] if n_pixel == 1 else torch.cat(bands)
    if with_sq:
        return L, (bands2[0] if n_pixel == 1 else torch.cat(bands2)), stats
    return L, stats


def build_sharded_render(static, settings, mesh, width, height,
                         spp_per_device, force_jnp=False):
    """A whole sharded render in one chunk (sharded.py:59): returns
    f(seed_row, tables, data, camera) -> the (H * W, 3) radiance SUM over
    n_sample * spp_per_device samples.  force_jnp pins the wavefront (the
    kernels have no backward; diff.differentiable_render_sharded)."""
    from ..core.scene import route

    path = "wavefront" if force_jnp else route(static, settings)
    run = build_sharded_chunk(static, settings, mesh, width, height,
                              spp_per_device, path=path)

    def f(seed_row, tables, data, camera):
        return run(seed_row, tables, data, camera)[0]

    return f


def render_sharded(scene, samples_per_pixel, mesh=None, seed=0, **kwargs):
    """Render `scene` over a mesh; returns the (H, W, 3) sRGB float
    array (sharded.py:230).  A thin wrapper over Scene.render(mesh=...);
    extra kwargs (device, batch_size, clamp, ...) go to it."""
    mesh = mesh or make_mesh()
    out = scene.render(samples_per_pixel, seed=seed, mesh=mesh,
                       output="linear", **kwargs)
    linear = out[0] if isinstance(out, tuple) else out
    img = srgb_linear_to_srgb(torch.from_numpy(
        np.ascontiguousarray(linear.reshape(-1, 3))))
    return img.numpy().reshape(linear.shape)
