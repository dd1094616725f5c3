"""Edge-avoiding à-trous wavelet denoiser driven by the AOV feature planes.

Counterpart of raytracer_tpu/denoise.py (Dammertz et al. 2010, with the
SVGF variance weight of Schied et al. 2017), in plain torch on the
image's device.  Each à-trous level is 25 edge-clamped shifts of the
(H, W) planes combined with per-pixel weights; the pipeline is the
demodulated-irradiance scheme:

  1. demodulate: illum = radiance / max(albedo, 0.05), so the filter sees
     lighting and not texture;
  2. `iterations` à-trous levels with stride 2^level and a 5x5 B3-spline
     kernel, taps weighted by normal, relative-depth and colour
     edge-stopping functions (the colour sigma halves each level), or
     with a variance the SVGF luminance weight;
  3. remodulate: out = filtered illum * albedo.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .core.ray import resolve_device

# the 1-D B3 spline; the 5x5 kernel is its outer product
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _pad(x, p, mode="replicate"):
    """(H, W) or (H, W, C) padded by p on both sides of H and W, edge
    values repeated (mode "replicate") or zeros ("constant")."""
    if x.dim() == 2:
        return F.pad(x[None, None], (p, p, p, p), mode=mode)[0, 0]
    return F.pad(x.permute(2, 0, 1)[None], (p, p, p, p),
                 mode=mode)[0].permute(1, 2, 0)


def _gauss3(x):
    """3x3 binomial prefilter, edge-clamped (denoise.py:38): SVGF smooths
    the variance before it drives the luminance weight."""
    k = (0.25, 0.5, 0.25)
    H, W = x.shape
    xp = _pad(x, 1)
    out = torch.zeros_like(x)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = out + (k[dy] * k[dx]) * xp[dy:dy + H, dx:dx + W]
    return out


def _atrous(illum, normal, depth, valid, var_lum, iterations, sigma_color,
            sigma_normal, sigma_depth):
    """`iterations` levels of the edge-avoiding à-trous transform
    (denoise.py:53).

    illum (H, W, 3) linear radiance; normal (H, W, 3) oriented unit
    normals (zero where nothing was hit); depth (H, W); valid (H, W) 1.0
    where a pixel is filtered, 0.0 where it is frozen (emission sources).
    var_lum: None for the fixed-sigma radiance weight, or the (H, W)
    luminance variance of illum for the SVGF weight
    exp(-|dlum| / (sigma sqrt(var))), the variance carried through each
    level (var' = sum w^2 v / (sum w)^2).
    """
    H, W = illum.shape[0], illum.shape[1]
    keep = valid[..., None]
    out = illum
    var = var_lum
    for level in range(iterations):
        step = 1 << level
        sc2 = (sigma_color / (1 << level)) ** 2 + 1e-12
        pad = 2 * step
        cp = _pad(out, pad)
        npad = _pad(normal, pad)
        dpad = _pad(depth, pad)
        vpad = _pad(valid, pad, mode="constant")
        if var is not None:
            lum = out.mean(-1)
            lpad = _pad(lum, pad)
            varpad = _pad(var, pad)
            sdev = torch.sqrt(torch.clamp_min(_gauss3(var), 0.0))
            vsum = torch.zeros((H, W), dtype=out.dtype, device=out.device)
        csum = torch.zeros_like(out)
        wsum = torch.zeros((H, W, 1), dtype=out.dtype, device=out.device)
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                y0, x0 = pad + dy * step, pad + dx * step
                cj = cp[y0:y0 + H, x0:x0 + W]
                nj = npad[y0:y0 + H, x0:x0 + W]
                dj = dpad[y0:y0 + H, x0:x0 + W]
                vj = vpad[y0:y0 + H, x0:x0 + W]
                # geometric edges: normal direction and relative depth
                wn = torch.exp(-((normal - nj) ** 2).sum(-1)
                               / max(sigma_normal, 1e-6))
                zden = sigma_depth * torch.clamp_min(torch.maximum(depth, dj),
                                                     1e-6)
                wz = torch.exp(-((depth - dj) / zden) ** 2)
                if var is not None:
                    # the luminance distance in units of the local noise
                    lj = lpad[y0:y0 + H, x0:x0 + W]
                    wc = torch.exp(-torch.abs(lum - lj)
                                   / (sigma_color * sdev + 1e-8))
                else:
                    wc = torch.exp(-((out - cj) ** 2).sum(-1) / sc2)
                w = (_B3[dy + 2] * _B3[dx + 2]) * wn * wz * wc
                if (dy, dx) == (0, 0):
                    w = torch.clamp_min(w, 1e-8)   # never divide by zero
                else:
                    w = w * vj                     # frozen taps add nothing
                csum = csum + w[..., None] * cj
                wsum = wsum + w[..., None]
                if var is not None:
                    varj = varpad[y0:y0 + H, x0:x0 + W]
                    vsum = vsum + w * w * varj
        out = torch.where(keep > 0, csum / wsum, illum)
        if var is not None:
            var = torch.where(valid > 0, vsum / wsum[..., 0] ** 2, var)
    return out


def _tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def denoise(img, aovs, *, variance=None, iterations=4, sigma_color=4.0,
            sigma_normal=0.1, sigma_depth=0.1, demodulate_albedo=True,
            device=None):
    """Denoise a linear-radiance frame with its AOV feature planes
    (denoise.py:129).

    img: (H, W, 3) linear radiance (Scene.render(output="linear")).
    aovs: a dict from Scene.render_aovs: `albedo`, `normal`, `depth` and,
    when present, `emissive`, whose pixels (and their neighbours) pass
    through unfiltered and give their neighbours nothing.
    variance: optional (H, W, 3) variance of the mean of img
    (Scene.render(with_variance=True)); it switches the radiance weight
    to SVGF's, sigma_color then counting standard deviations.
    iterations / sigma_*: à-trous levels and edge-stopping widths.
    device: where the filter runs; default the device of img when it is
    a tensor, else "cuda" (raising without one); "cpu" when asked.
    Returns the denoised (H, W, 3) float32 numpy array.
    """
    if device is None and isinstance(img, torch.Tensor):
        device = img.device
    device = resolve_device(device, "denoise")
    img = _tensor(img, device)
    if img.dim() != 3 or img.shape[-1] != 3:
        raise ValueError(f"img must be (H, W, 3), got {tuple(img.shape)}")
    albedo = _tensor(aovs["albedo"], device)
    normal = _tensor(aovs["normal"], device)
    depth = _tensor(aovs["depth"], device)
    hw = img.shape[:2]
    if albedo.shape != img.shape or normal.shape != img.shape \
            or depth.shape != hw:
        raise ValueError(
            f"AOV shapes must match img {tuple(img.shape)}: albedo "
            f"{tuple(albedo.shape)}, normal {tuple(normal.shape)}, depth "
            f"{tuple(depth.shape)} (expected {tuple(hw)})")
    if "emissive" in aovs:
        # one pixel of dilation: the AOV pass samples other sub-pixel
        # positions than the beauty pass, so a neighbour of a light may
        # have caught it
        src = _tensor(aovs["emissive"], device) > 0.0
        sp = _pad(src.to(torch.float32), 1, mode="constant") > 0
        near = torch.zeros(hw, dtype=torch.bool, device=device)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                near = near | sp[dy:dy + hw[0], dx:dx + hw[1]]
        valid = (~near).to(torch.float32)
    else:
        valid = torch.ones(hw, dtype=torch.float32, device=device)
    if demodulate_albedo:
        mod = torch.clamp_min(albedo, 0.05)
        illum = img / mod
    else:
        mod = torch.ones_like(img)
        illum = img
    var_lum = None
    if variance is not None:
        var = _tensor(variance, device)
        if var.shape != img.shape:
            raise ValueError(f"variance shape {tuple(var.shape)} must match "
                             f"img {tuple(img.shape)}")
        # Var(x / m) = Var(x) / m^2, reduced to a luminance variance by the
        # mean over channels (their noise comes from the same paths)
        var_lum = torch.clamp_min(var / (mod * mod), 0.0).mean(-1)
    out = _atrous(illum, normal, depth, valid, var_lum, int(iterations),
                  float(sigma_color), float(sigma_normal), float(sigma_depth))
    return (out * mod).cpu().numpy()
