"""Texture descriptions (host side).

Counterpart of raytracer_tpu/textures/texture.py.  `image` holds a
linearised float32 array; the scene compiler packs it into the texture
atlas (core/compile.py) and the record kernel fetches it with
wrap-around nearest or bilinear taps (csrc/record_trace.cu; the plain
version's replay, ops/replay.py), with sightpy's negated v axis
(texture.py:32-39).
"""

from __future__ import annotations

import numpy as np

from ..core.vec import as_float3
from ..utils.image_io import load_image_as_linear_srgb


class texture:
    pass


class solid_color(texture):
    def __init__(self, color):
        self.color = as_float3(color, "color")


class image(texture):
    """Image texture.  filter="nearest" is sightpy's fetch; "bilinear"
    wrap-interpolates the four neighbours."""

    def __init__(self, img, repeat=1.0, filter="nearest"):
        if isinstance(img, np.ndarray):
            self.img = np.asarray(img, dtype=np.float32)
            self.source = None
        else:
            self.img = load_image_as_linear_srgb(img, subdir_hint="textures")
            self.source = str(img)
        self.repeat = float(repeat)
        if filter not in ("nearest", "bilinear"):
            raise ValueError(f"filter must be 'nearest' or 'bilinear', got {filter!r}")
        self.bilinear = filter == "bilinear"


def as_texture(value, name="color"):
    """Accept a vec3/sequence (solid colour) or a texture instance."""
    if isinstance(value, texture):
        return value
    return solid_color(as_float3(value, name))
