"""Differentiable rendering: inverse rendering by gradient descent.

Counterpart of raytracer_tpu/diff.py.  The wavefront integrator
(core/integrator.py) is plain torch, so autograd flows through it with
respect to the scene's tables: refraction indices, absorption, material
and light colours, ambient, textures.  A parameter is recovered by
descent on a pixel loss (examples/torch_inverse_rendering.py,
tests/test_torch_diff.py).

What differentiates and what does not (raytracer_tpu/diff.py:13-25):

* any float tensor of the `SceneData` that shading reads: `data.mats.*`,
  `data.lights.*`, `data.ambient_color`, `data.scene_n_*`, textures;
* which object a ray hits, which branch it takes and which texel it
  reads are piecewise constant in the parameters and give no gradient.
  Geometry (`data.geom.*`) gets shading gradients, none at silhouettes:
  nothing is differentiated through the clustered sweep's pair search
  (`ops/mesh_pairs.py` `cluster_pairs`: W2 on the card,
  `geometry/intersect.py` `_cluster_pairs` on the CPU) or its tie rule,
  nor through the sweep kernels (W1, W3), whose winners' t
  `intersect.nearest_hit` recomputes in plain torch;
* with a fixed seed the image is a deterministic function of the
  parameters: every draw comes from a per-chunk torch.Generator seeded
  from `chunk_seeds`, never from the parameters.  So is the gradient,
  bit for bit on the card too: every gather from a table goes through
  `core/safemath.py` `take`, whose backward sums in a fixed order
  (CUDA's `index_select` backward adds with atomics).

The renders always take the wavefront (the kernels have no backward),
in Scene.render's chunks, each under `torch.utils.checkpoint` (not
reentrant), so the backward pass recomputes one chunk at a time and
gradient memory stays one chunk's.  Each chunk creates its generator
inside the checkpointed function, so the recompute draws the same
numbers (an explicit generator is outside `preserve_rng_state`).  The
masked square roots of shading and intersection use core/safemath.py, so
total internal reflection and missed-sphere discriminants give finite
gradients; `safe_value_and_grad` zeroes the rare non-finite one.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .core.compile import compile_wavefront
from .core.ray import resolve_device
from .core.scene import chunk_seeds, plan_chunks
from .parallel.sharded import (build_sharded_chunk, check_mesh, make_mesh,
                               plan_spp_per_device)

__all__ = ["differentiable_render", "differentiable_render_sharded",
           "safe_value_and_grad", "update_materials", "update_lights"]


def _setup(scene, samples_per_pixel):
    if scene.camera is None:
        raise ValueError("scene has no camera; call add_Camera first")
    if samples_per_pixel < 1:
        raise ValueError("samples_per_pixel must be >= 1")
    static, data = compile_wavefront(scene)
    return static, data, scene._settings(static)


def differentiable_render(scene, samples_per_pixel, seed=0, device=None):
    """A differentiable render function of `scene` (diff.py:55).

    Returns `(render_fn, data)`: `data` the scene's `SceneData` on
    `device` (default "cuda"; "cpu" when asked), whose float tensors are
    the parameters; `render_fn(data)` the (H, W, 3) linear radiance mean,
    a torch tensor on data's device, differentiable with respect to
    data's float tensors, and for a fixed `seed` equal to
    Scene.render(samples_per_pixel, seed=seed, output="linear") under
    RenderSettings(use_pallas="never").  samples_per_pixel as for
    Scene.render (the diffuse fan and the split patterns multiply it).

        fn, data = differentiable_render(scene, samples_per_pixel=8)
        target = fn(data).detach()
        n = data.mats.refr_n_re.clone().requires_grad_()
        loss = ((fn(update_materials(data, refr_n_re=n)) - target) ** 2).mean()
        loss.backward()
    """
    device = resolve_device(device, "differentiable_render")
    return _render_fn(scene, samples_per_pixel, make_mesh(1, 1, [device]),
                      seed, device, "differentiable_render")


def differentiable_render_sharded(scene, samples_per_pixel, mesh=None,
                                  seed=0, device=None):
    """`differentiable_render` over a ("sample", "pixel") grid of devices
    (diff.py:132; default `make_mesh()`): the same contract, but each
    chunk runs over the mesh (parallel/sharded.py `build_sharded_chunk`,
    pinned to the wavefront), every shard on its own device, the shards'
    sums added in shard order on `device` (default the mesh's first
    device).  Autograd goes back through the copies to each shard, so the
    gradient is the data-parallel one.  The JAX package traces the whole
    render in one step; here it goes in Scene.render's per-device chunks,
    each checkpointed."""
    return _render_fn(scene, samples_per_pixel, mesh or make_mesh(), seed,
                      device, "differentiable_render_sharded")


def _render_fn(scene, samples_per_pixel, mesh, seed, device, what):
    """Both renders' (render_fn, data): one device is a 1x1 mesh."""
    static, data, settings = _setup(scene, samples_per_pixel)
    W, H = scene.camera.screen_width, scene.camera.screen_height
    n_sample, n_pixel = check_mesh(mesh, H, what)
    device = resolve_device(device if device is not None
                            else mesh.devices[0, 0], what)
    spp_dev = plan_spp_per_device(samples_per_pixel, scene._diffuse_fan(),
                                  settings.split_k, n_sample)
    chunk_dev, n_chunks = plan_chunks(spp_dev, W, H // n_pixel,
                                      1 << settings.split_k)
    run = build_sharded_chunk(static, settings, mesh, W, H, chunk_dev,
                              path="wavefront")
    seeds = chunk_seeds(seed, n_chunks, chunk_dev * n_sample)
    cam = scene.camera.params()
    total = torch.tensor(float(n_chunks * chunk_dev * n_sample),
                         dtype=torch.float32, device=device)

    def render_fn(d):
        # each shard's copy of d once a render; a chunk's generators are
        # made inside it, so a checkpoint's recompute draws the same
        chunk = run.stage(seeds, None, d, cam)
        acc = torch.zeros((H * W, 3), dtype=torch.float32, device=device)
        for i in range(n_chunks):
            if n_chunks == 1:
                acc = acc + chunk(i, out=device)[0]
            else:
                acc = acc + checkpoint(lambda i: chunk(i, out=device)[0], i,
                                       use_reentrant=False)
        return (acc / total).reshape(H, W, 3)

    return render_fn, data.to(device)


def _leaves(x):
    """The float tensors of a tensor, or of tuples, lists, dicts and
    dataclasses of them, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x] if x.is_floating_point() else []
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if isinstance(x, dict):
        return [t for k in x for t in _leaves(x[k])]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _leaves(getattr(x, f.name))]
    return []


def _rebuild(x, it):
    """x with each float tensor replaced by the next of `it`."""
    if isinstance(x, torch.Tensor):
        return next(it) if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    if isinstance(x, dict):
        return {k: _rebuild(x[k], it) for k in x}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _rebuild(getattr(x, f.name),
                                                          it)
                                         for f in dataclasses.fields(x)})
    return x


def safe_value_and_grad(fun, argnums=0):
    """`fun`'s value and its gradient with respect to the arguments
    `argnums` (an int or a tuple), with every non-finite gradient element
    set to 0 (diff.py:174).

    A float32 path tracer has rare degenerate samples; a where-scrub
    repairs their forward value, not the backward pass (a zero cotangent
    times an infinite partial is NaN), and one NaN would reach every
    parameter.  Returns wrapped(*args, **kwargs) -> (value, grads): value
    detached; grads shaped as the argument (a tensor, or tuples, lists,
    dicts and dataclasses of tensors: a gradient for each float tensor,
    zeros where the value does not depend on it), a tuple of them when
    argnums is a tuple."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def wrapped(*args, **kwargs):
        args = list(args)
        leaves = []
        for k in nums:
            ls = [t.detach().requires_grad_(True) for t in _leaves(args[k])]
            args[k] = _rebuild(args[k], iter(ls))
            leaves.append(ls)
        with torch.enable_grad():
            value = fun(*args, **kwargs)
            flat = [t for ls in leaves for t in ls]
            grads = torch.autograd.grad(value, flat, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None
                 else torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                 for t, g in zip(flat, grads)]
        it = iter(grads)
        out = tuple(_rebuild(args[k], it) for k in nums)
        return value.detach(), (out[0] if isinstance(argnums, int) else out)

    return wrapped


def update_materials(data, **fields):
    """A SceneData whose MaterialTables has `fields` replaced
    (diff.py:202): update_materials(data, refr_n_re=x)."""
    return dataclasses.replace(
        data, mats=dataclasses.replace(data.mats, **fields))


def update_lights(data, **fields):
    """A SceneData whose LightTables has `fields` replaced (diff.py:213)."""
    return dataclasses.replace(
        data, lights=dataclasses.replace(data.lights, **fields))
