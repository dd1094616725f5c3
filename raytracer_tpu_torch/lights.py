"""Light descriptions (counterpart of raytracer_tpu/lights.py).

Only Glossy reads lights, and the solid kernel of this slice has no glossy
shading yet; the classes are here so that scenes with lights compile their
light table (core/compile.py) as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from .core.vec import as_float3
from .geometry.primitive import stable_unit


class Light:
    def __init__(self, color):
        self.color = as_float3(color, "color")


class PointLight(Light):
    def __init__(self, pos, color):
        super().__init__(color)
        self.pos = as_float3(pos, "pos")


class DirectionalLight(Light):
    def __init__(self, Ldir, color):
        super().__init__(color)
        self.Ldir = stable_unit(as_float3(Ldir, "Ldir"))


class SpotLight(Light):
    """PointLight falloff times a smooth cone factor: 1 inside
    `inner_angle`, smoothstep to 0 at `angle` (outer half-angle, degrees)."""

    def __init__(self, pos, direction, color, angle=30.0, inner_angle=None):
        super().__init__(color)
        self.pos = as_float3(pos, "pos")
        self.direction = stable_unit(as_float3(direction, "direction"))
        outer = float(angle)
        inner = float(inner_angle) if inner_angle is not None else 0.75 * outer
        if not 0.0 < outer < 180.0:
            raise ValueError(f"angle must be in (0, 180) degrees, got {outer}")
        if not 0.0 <= inner <= outer:
            raise ValueError(
                f"inner_angle must be in [0, angle], got {inner} vs {outer}")
        self.angle = outer
        self.inner_angle = inner
        self.cos_outer = float(np.cos(np.radians(outer)))
        self.cos_inner = float(np.cos(np.radians(inner)))
