"""sRGB transfer and display tonemapping on torch tensors.

Counterpart of raytracer_tpu/utils/colour.py, with the same semantics
(sightpy colour_functions.py:4-28): the sRGB EOTF plus the
highlight-preserving intensity clip, which scales a pixel so that its
largest channel is at most 1 instead of clipping channels one by one.
The channel axis is the last axis.
"""

from __future__ import annotations

import numpy as np
import torch


def _srgb_encode(x):
    """Pure sRGB EOTF (knee at 0.00304); no highlight handling."""
    return torch.where(
        x <= 0.00304,
        12.92 * x,
        1.055 * torch.pow(torch.clamp_min(x, 1e-30), 1.0 / 2.4) - 0.055,
    )


def srgb_linear_to_srgb(rgb_linear):
    """Linear -> sRGB with highlight-preserving intensity scaling."""
    srgb = _srgb_encode(rgb_linear)
    rgb_max = torch.amax(srgb, dim=-1, keepdim=True) + 0.00001
    intensity_cutoff = 1.0
    return torch.where(rgb_max > intensity_cutoff,
                       srgb * intensity_cutoff / rgb_max, srgb)


def aces_film(rgb_linear):
    """Narkowicz 2015 ACES filmic fit; linear radiance -> display-linear [0, 1]."""
    x = rgb_linear
    y = x * (2.51 * x + 0.03) / (x * (2.43 * x + 0.59) + 0.14)
    return torch.clamp(y, 0.0, 1.0)


def reinhard(rgb_linear, white=4.0):
    """Extended Reinhard per channel, white point `white`, clipped to [0, 1]."""
    x = rgb_linear
    y = x * (1.0 + x / (white * white)) / (1.0 + x)
    return torch.clamp(y, 0.0, 1.0)


TONEMAP_OPERATORS = ("srgb", "aces", "reinhard")


def srgb_to_srgb_linear(srgb):
    """sRGB -> linear on the host (numpy), for texture preprocessing
    (sightpy colour_functions.py:21-28)."""
    srgb = np.asarray(srgb)
    return np.where(srgb <= 0.03928, srgb / 12.92,
                    np.power((srgb + 0.055) / 1.055, 2.4))


def tonemap_display(rgb_linear, operator="srgb", exposure_scale=1.0):
    """Linear radiance -> display sRGB in [0, 1].

    operator: "srgb" (sRGB EOTF with the intensity clip), "aces" or
    "reinhard" (each followed by the sRGB EOTF).  exposure_scale
    multiplies the linear radiance first; 1.0 is exact.
    """
    x = rgb_linear * exposure_scale
    if operator == "srgb":
        return srgb_linear_to_srgb(x)
    if operator == "aces":
        return _srgb_encode(aces_film(x))
    if operator == "reinhard":
        return _srgb_encode(reinhard(x))
    raise ValueError(
        f"tonemap must be one of {TONEMAP_OPERATORS}, got {operator!r}")
