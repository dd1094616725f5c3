"""Arbitrary-output-variable (AOV) rendering: first-hit feature planes.

Counterpart of raytracer_tpu/core/aov.py.  sightpy's only diagnostic is
the depth map of `Scene.get_distances`; here one first-hit pass over the
camera rays gives the feature planes an image-space denoiser reads
(depth, oriented normal, albedo, position, coverage, object id, emission
coverage) and, with ao_samples, an ambient-occlusion plane.  Both reuse
the wavefront's intersection (`ray._first_hit_impl`, so mesh scenes go
through the clustered sweep) and occlusion test, in plain torch on the
scene's device; spp > 1 box-filters the planes over the camera's jitter.
Passes larger than the port's 4 M-ray chunk go in chunks of samples, the
R2 lattice continuing across them.  With `mesh=` each shard of a grid
of devices computes its sample slice of its band of rows (the JAX
package's `_sharded_aovs`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.intersect import occluded
from ..materials import shade
from ..materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV, MAT_GLOSSY)
from ..utils.constants import FARAWAY, MISS_THRESHOLD
from . import rng as rng_mod
from .camera import generate_rays
from .ray import _first_hit_impl, resolve_device


def _albedo_at_hit(mat_type, mat_slot, uv, data, static):
    """Base colour per ray over the present material types (aov.py:32):
    diffuse, glossy and emissive their texture-or-solid colour, the
    environment its display texture, refractive, thin-film and custom
    materials white."""
    n = mat_slot.shape[0]
    alb = torch.ones((n, 3), dtype=torch.float32, device=mat_slot.device)
    mats, textures = data.mats, data.textures
    for mt in static.mat_types_present:
        if mt == MAT_DIFFUSE:
            c = shade._slot_color(mats.diffuse_color, mat_slot, uv,
                                  static.diffuse_tex, textures)
        elif mt == MAT_GLOSSY:
            c = shade._slot_color(mats.glossy_color, mat_slot, uv,
                                  static.glossy_tex, textures)
        elif mt == MAT_EMISSIVE:
            c = shade._slot_color(mats.emissive_color, mat_slot, uv,
                                  static.emissive_tex, textures)
        elif mt == MAT_ENV:
            c = torch.zeros_like(alb)
            for env in static.env_slots:
                ce = shade.fetch_texture(textures[env.tex], uv, 1.0)
                c = torch.where((mat_slot == env.slot)[..., None], ce, c)
        else:
            continue        # refractive, thin film, custom: white
        alb = torch.where((mat_type == mt)[..., None], c, alb)
    return alb


def _aov_planes(O, D, data, static, spp, n_pix):
    """The feature sums of one chunk of rays in [sample, pixel] order
    (aov.py:70-108): per pixel the sums over the chunk's spp samples, and
    the object id of its first sample."""
    t, orient, obj, a = _first_hit_impl(O, D, data, static)
    hit = t < MISS_THRESHOLD
    h1 = hit[..., None]
    mat_type = a.mat_type
    N_out = torch.where(h1, a.N * orient[..., None], 0.0)
    alb = torch.where(h1, _albedo_at_hit(mat_type, a.mat_slot, a.uv, data,
                                         static), 0.0)
    # emission sources: exact radiance, which the denoiser leaves alone
    is_src = (mat_type == MAT_EMISSIVE) | (mat_type == MAT_ENV)
    sum_pix = lambda x: x.reshape((spp, n_pix) + x.shape[1:]).sum(dim=0)
    return dict(
        depth=sum_pix(torch.where(hit, t, 0.0)),
        normal=sum_pix(N_out),
        albedo=sum_pix(alb),
        coverage=sum_pix(hit.to(torch.float32)),
        obj_id=torch.where(hit, obj, -1)[:n_pix],
        position=sum_pix(torch.where(h1, a.P, 0.0)),
        emissive=sum_pix((is_src & hit).to(torch.float32)),
    )


def _ao_plane(O, D, data, static, generator, spp, n_pix, ao_samples,
              ao_dist):
    """Per pixel, the sum over samples of the fraction of `ao_samples`
    cosine-weighted directions at the first hit that no shadow-casting
    object blocks within ao_dist (aov.py:111); misses count 1."""
    t, orient, obj, a = _first_hit_impl(O, D, data, static)
    hit = t < MISS_THRESHOLD
    N = a.N * orient[..., None]
    nudged = a.P + N * a.eps[..., None]
    md = torch.full((O.shape[0],), float(ao_dist), dtype=torch.float32,
                    device=O.device)
    occ_sum = torch.zeros((O.shape[0],), dtype=torch.float32, device=O.device)
    for _ in range(ao_samples):
        d = rng_mod.cosine_sample(generator, N)
        occ_sum = occ_sum + occluded(nudged, d, data.geom, data.obj.shadow,
                                     md).to(torch.float32)
    ao = torch.where(hit, 1.0 - occ_sum / float(ao_samples), 1.0)
    return ao.reshape(spp, n_pix).sum(dim=0)


def _aov_sums(data, static, cam, W, H, spp, seed, strat, sample0, row0,
              rows, ao_samples, dist, projection, device):
    """The per-pixel sums of one pass over film rows [row0, row0 + rows)
    and samples [sample0, sample0 + spp) of the R2 lattice rotated by
    `strat` (None: the pass's own draw), on `device`: the jitter from a
    generator seeded `seed` (its first draw is the pass's rotation seed),
    the AO directions from another.  Samples go in chunks under the port's
    4 M-ray cap."""
    from .scene import MAX_RAYS_PER_CHUNK

    n_pix = W * rows
    chunk = max(1, min(spp, MAX_RAYS_PER_CHUNK // n_pix))
    g = torch.Generator(device=device).manual_seed(int(seed))
    g_ao = torch.Generator(device=device).manual_seed(int(seed) * 4096 + 1)
    # one R2 rotation for the whole pass, which continues across chunks
    own = int(torch.randint(0, 2 ** 31 - 1, (), generator=g, device=device))
    strat = own if strat is None else strat
    out = None
    for s0 in range(0, spp, chunk):
        c = min(chunk, spp - s0)
        O, D = generate_rays(g, cam, W, H, c, row0=row0, rows=rows,
                             strat_seed=strat, sample0=sample0 + s0,
                             projection=projection)
        part = _aov_planes(O, D, data, static, c, n_pix)
        if ao_samples:
            part["ao"] = _ao_plane(O, D, data, static, g_ao, c, n_pix,
                                   int(ao_samples), dist)
        if out is None:
            out = part
        else:
            for k, v in part.items():
                if k != "obj_id":
                    out[k] = out[k] + v
    return out, own


def render_aovs(scene, samples_per_pixel=1, seed=0, ao_samples=0,
                ao_radius=None, mesh=None, device=None):
    """First-hit feature planes of `scene` (aov.py:183), numpy arrays:

      depth    (H, W)    mean hit distance over the samples that hit
      normal   (H, W, 3) mean oriented unit normal (zero where nothing hits)
      albedo   (H, W, 3) mean base colour (see _albedo_at_hit)
      position (H, W, 3) mean hit point
      coverage (H, W)    share of samples that hit anything
      obj_id   (H, W)    compiled object id of sample 0's hit (-1: a miss)
      emissive (H, W)    share of samples that hit an emission source
                         (Emissive or an environment)

    ao_samples > 0 adds `ao` (H, W): the share of cosine-weighted
    directions at the first hit that escape within ao_radius (None: no
    limit); misses are 1.  seed seeds the passes' generators (the camera
    jitter's R2 rotation, the AO directions).  device: as for
    Scene.render (default "cuda"; "cpu" when asked).  mesh: a ("sample",
    "pixel") grid of devices (parallel.sharded.make_mesh), as the JAX
    package's `_sharded_aovs` (aov.py:143): each shard computes its sample
    slice of its band of rows on its own device, the sums are added in
    shard order on `device` (default the mesh's first device), obj_id is
    sample shard 0's; samples_per_pixel rounds up to whole sample shards.
    """
    from .compile import compile_wavefront
    from .scene import chunk_seeds

    if scene.camera is None:
        raise RuntimeError("call add_Camera() first")
    W, H = scene.camera.screen_width, scene.camera.screen_height
    if mesh is not None:
        from ..parallel.sharded import check_mesh, shard_seed

        n_sample, n_pixel = check_mesh(mesh, H, "render_aovs")
        if device is None:
            device = mesh.devices[0, 0]
    device = resolve_device(device, "render_aovs")
    static, data = compile_wavefront(scene)
    data = data.to(device)
    spp = int(samples_per_pixel)
    row = chunk_seeds(seed, 1, 1)[0]
    cam = scene.camera.params()
    dist = FARAWAY if ao_radius is None else float(ao_radius)
    args = (ao_samples, dist, scene.camera.projection)
    if mesh is None:
        out, _ = _aov_sums(data, static, cam, W, H, spp, row[0], None, 0, 0,
                           H, *args, device)
    else:
        spp_dev = -(-spp // n_sample)
        spp = spp_dev * n_sample
        rows = H // n_pixel
        strat = None       # shard (0, 0)'s own draw: the unsharded pass's
        bands = []
        for p in range(n_pixel):
            band = None
            for s in range(n_sample):
                dev = mesh.devices[s, p]
                part, own = _aov_sums(data.to(dev), static, cam, W, H,
                                      spp_dev, shard_seed(row[0], s, p),
                                      strat, s * spp_dev, p * rows, rows,
                                      *args, dev)
                strat = own if strat is None else strat
                part = {k: v.to(device) for k, v in part.items()}
                if band is None:
                    band = part      # obj_id: sample shard 0's
                else:
                    for k, v in part.items():
                        if k != "obj_id":
                            band[k] = band[k] + v
            bands.append(band)
        out = {k: torch.cat([b[k] for b in bands]) for k in bands[0]}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return _finish(out, float(spp), W, H, bool(ao_samples))


def _finish(out, spp, W, H, with_ao):
    """The planes from the per-pixel sums (aov.py:236-261)."""
    cov = out["coverage"]
    depth = out["depth"] / np.maximum(cov, 1.0)
    normal = out["normal"] / spp
    nlen = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.maximum(nlen, 1e-12)
    normal = np.where(cov[..., None] > 0, normal, 0.0)
    planes = dict(
        depth=depth.reshape(H, W),
        normal=normal.reshape(H, W, 3),
        albedo=(out["albedo"] / spp).reshape(H, W, 3),
        position=(out["position"] / spp).reshape(H, W, 3),
        coverage=(cov / spp).reshape(H, W),
        obj_id=out["obj_id"].reshape(H, W).astype(np.int32),
        emissive=(out["emissive"] / spp).reshape(H, W),
    )
    if with_ao:
        planes["ao"] = (out["ao"] / spp).reshape(H, W)
    return planes
