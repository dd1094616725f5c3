"""Omni-directional stereo (ODS) 360 rendering for VR playback.

Counterpart of raytracer_tpu/vr.py.  `render_ods` renders one equirect
frame per eye, each ray's origin moved half the interpupillary distance
along the horizontal tangent of its azimuth (the Google-Jump ODS
projection), and packs the pair top-bottom, side by side, as a red/cyan
anaglyph or as two images.  The rays (`_ods_rays`) feed the wavefront
integrator (core/integrator.py `trace`) in chunks of samples under the
port's 4 M-ray cap.  Both eyes draw from generators seeded alike per
chunk, so their noise is correlated and ipd=0 gives two bit-identical
eyes.  The jitter is i.i.d. (the generator's uniforms), so a zero-ipd
frame matches Scene.render's equirect frame statistically, not bit for
bit (that one uses the R2 lattice).  Settings come from scene.settings
as Scene.render derives them.  With `mesh=` (sample shards only, the JAX
package's `_build_ods_sharded`) each sample shard traces its slice of
every chunk on its own device and the slices are added in shard order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.compile import (compile_wavefront, derive_max_bounces,
                           derive_split_k)
from .core.integrator import RenderSettings, trace
from .core.ray import resolve_device
from .core.safemath import div
from .utils.colour import tonemap_display

LAYOUTS = ("top-bottom", "side-by-side", "anaglyph", "separate")


def _ods_rays(u1, u2, origin0, phi0, half_ipd, eye_sign, width, height, spp):
    """(origin, direction) of one eye's spp * height * width rays in
    [sample, pixel] order (vr.py:53-71).  u1, u2: (n,) jitter uniforms.
    Pixel (column, row) maps to azimuth phi0 + 2 pi ((col + u1) / width -
    1/2) and elevation pi (1/2 - (row + u2) / height) as the equirect
    camera maps it; the origin moves eye_sign * half_ipd along (-sin phi,
    0, cos phi).  eye_sign: -1 the left eye, +1 the right."""
    dev = u1.device
    n_pix = width * height
    idx = torch.arange(spp * n_pix, dtype=torch.int64, device=dev)
    pix = torch.remainder(idx, n_pix)
    col = torch.remainder(pix, width).to(torch.float32)
    row = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    el = math.pi * (0.5 - div(row + u2, float(height)))
    phi = phi0 + 2.0 * math.pi * (div(col + u1, float(width)) - 0.5)
    rho = torch.cos(el)
    d = torch.stack([rho * torch.cos(phi), torch.sin(el),
                     rho * torch.sin(phi)], dim=-1)
    right = torch.stack([-torch.sin(phi), torch.zeros_like(phi),
                         torch.cos(phi)], dim=-1)
    origin = origin0[None, :] + (eye_sign * half_ipd) * right
    return origin, d


def _ods_samples(generator, data, origin0, phi0, half_ipd, eye_sign, width,
                 height, spp, static, settings, clamp=None, sample0=0):
    """Sum of `spp` radiance samples per pixel for one eye (vr.py:42):
    (width * height, 3).  `generator` draws the jitter (u1, then u2, one
    uniform a ray each), then the paths.  sample0: the chunk's first
    sample, which numbers the split patterns."""
    n_pix = width * height
    n = spp * n_pix
    dev = generator.device
    u1 = torch.rand(n, generator=generator, device=dev)
    u2 = torch.rand(n, generator=generator, device=dev)
    origin, d = _ods_rays(u1, u2, origin0, phi0, half_ipd, eye_sign, width,
                          height, spp)
    pattern = None
    if settings.split_k > 0:
        # [sample, pixel]-ordered rays; callers keep spp a multiple of
        # 2^split_k so that every pixel sees each pattern as often
        s_loc = torch.div(torch.arange(n, dtype=torch.int32, device=dev),
                          n_pix, rounding_mode="floor")
        pattern = ((int(sample0) + s_loc) % (1 << settings.split_k)).to(
            torch.int32)
    L, _ = trace(generator, origin, d, data.scene_n_re, data.scene_n_im, data,
                 static, settings, pattern=pattern)
    if clamp is not None:
        L = torch.clamp_max(L, float(clamp))
    return L.reshape(spp, n_pix, 3).sum(dim=0)


def _finish_eye(linear, output, operator, exposure):
    """An eye's (H, W, 3) linear tensor as output: the float32 array, or
    the tonemapped uint8 array (vr.py:129)."""
    if output == "linear":
        return linear.cpu().numpy()
    img = tonemap_display(linear, operator, exposure)
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255).to(
        torch.uint8).cpu().numpy()


def _pack_stereo(left, right, layout):
    """Two eyes' images in `layout` (vr.py:268-282): top-bottom (left on
    top), side-by-side (left on the left), anaglyph (left eye red, right
    eye green and blue) or separate (the pair)."""
    if layout == "separate":
        return (left, right)
    if layout == "top-bottom":
        return np.concatenate([left, right], axis=0)
    if layout == "anaglyph":
        return np.stack([left[..., 0], right[..., 1], right[..., 2]], axis=-1)
    return np.concatenate([left, right], axis=1)


def _eye_seed(seed, ci):
    """The generator seed of chunk ci, the same for both eyes."""
    return int(np.random.SeedSequence([int(seed), int(ci)]).generate_state(1)[0])


def render_ods(scene, samples_per_pixel=8, ipd=0.064, seed=0,
               width=None, height=None, layout="top-bottom", output="pil",
               operator="srgb", exposure=1.0, mesh=None, clamp=None,
               device=None):
    """A stereo 360 (ODS) frame of `scene` (vr.py:137).

    samples_per_pixel: paths per pixel and eye (no diffuse fan; with
    split_k > 0 each camera sample fans into 2^split_k patterns).
    ipd: interpupillary distance in world units (0: identical eyes).
    width / height: per-eye resolution; default the camera's screen size
    (height width // 2 when only width is given).
    layout: "top-bottom", "side-by-side", "anaglyph" or "separate".
    output: "pil" (8-bit sRGB image), "np" (uint8 array) or "linear"
    (float32 radiance).  operator / exposure: the display transform.
    clamp: optional per-sample radiance ceiling.  device: as for
    Scene.render (default "cuda"; "cpu" when asked).  mesh: a grid of
    devices with one pixel shard (parallel.sharded.make_mesh(n, 1, ...)):
    each sample shard traces its slice of every chunk, the slices summed
    in shard order on `device` (default the mesh's first device);
    samples_per_pixel rounds up to whole shards and pattern blocks.
    """
    if scene.camera is None:
        raise ValueError("scene has no camera; call add_Camera first")
    if layout not in LAYOUTS:
        raise ValueError("layout must be 'top-bottom', 'side-by-side', "
                         f"'anaglyph' or 'separate', got {layout!r}")
    if layout == "anaglyph" and output == "linear":
        raise ValueError("anaglyph is a display-space composite; use "
                         "output='pil' or 'np'")
    if output not in ("pil", "np", "linear"):
        raise ValueError(f"output must be 'pil', 'np' or 'linear', got "
                         f"{output!r}")
    spp = int(samples_per_pixel)
    if spp < 1:
        raise ValueError(f"samples_per_pixel must be >= 1, got {spp}")
    W = int(width) if width is not None else scene.camera.screen_width
    if height is not None:
        H = int(height)
    elif width is not None:
        H = max(1, W // 2)
    else:
        H = scene.camera.screen_height
    if W < 1 or H < 1:
        raise ValueError(f"invalid ODS frame size {W}x{H}")
    from .core.scene import MAX_RAYS_PER_CHUNK

    n_sample = 1
    if mesh is not None:
        from .parallel.sharded import check_mesh, shard_seed

        n_sample, n_pixel = check_mesh(mesh, None, "render_ods")
        if n_pixel != 1:
            raise ValueError("render_ods shards over the 'sample' axis "
                             "only; use a mesh with pixel=1")
        if device is None:
            device = mesh.devices[0, 0]
    device = resolve_device(device, "render_ods")
    static, data = compile_wavefront(scene)
    data = data.to(device)
    base = scene.settings
    max_b = base.max_bounces
    if max_b == RenderSettings.max_bounces:
        max_b = derive_max_bounces(static)
    settings = RenderSettings(max_bounces=max_b, nudge_eps=base.nudge_eps,
                              sampler="iid",
                              split_k=base.split_k or derive_split_k(static))
    split_fan = 1 << settings.split_k
    spp = spp * split_fan
    # samples of one device (vr.py:214-217)
    spp_dev = -(-spp // (n_sample * split_fan)) * split_fan
    spp = spp_dev * n_sample
    chunk = max(1, min(spp_dev, 128, MAX_RAYS_PER_CHUNK // (W * H)))
    chunk = max(split_fan, chunk - chunk % split_fan)

    cam = scene.camera.params()
    fwd = np.asarray(cam.fwd)
    phi0 = float(np.float32(np.arctan2(fwd[2], fwd[0])))
    origin0 = torch.as_tensor(np.asarray(cam.origin, np.float32),
                              device=device)
    half_ipd = float(np.float32(float(ipd) / 2.0))
    eyes = []
    for eye_sign in (-1.0, 1.0):
        acc = torch.zeros((W * H, 3), dtype=torch.float32, device=device)
        done = ci = 0
        while done < spp_dev:
            s = min(chunk, spp_dev - done)
            if mesh is None:
                g = torch.Generator(device=device).manual_seed(
                    _eye_seed(seed, ci))
                acc = acc + _ods_samples(g, data, origin0, phi0, half_ipd,
                                         eye_sign, W, H, s, static, settings,
                                         clamp=clamp, sample0=done)
            else:
                part = None
                for sh in range(n_sample):
                    dev = mesh.devices[sh, 0]
                    g = torch.Generator(device=dev).manual_seed(
                        shard_seed(_eye_seed(seed, ci), sh, 0))
                    L = _ods_samples(g, data.to(dev), origin0.to(dev), phi0,
                                     half_ipd, eye_sign, W, H, s, static,
                                     settings, clamp=clamp,
                                     sample0=sh * spp_dev + done).to(device)
                    part = L if part is None else part + L
                acc = acc + part
            done += s
            ci += 1
        linear = div(acc, float(spp)).reshape(H, W, 3)
        eyes.append(_finish_eye(linear, output, operator, exposure))
    pair = _pack_stereo(eyes[0], eyes[1], layout)
    if output != "pil":
        return pair
    from PIL import Image

    if layout == "separate":
        return tuple(Image.fromarray(e) for e in pair)
    return Image.fromarray(pair)
