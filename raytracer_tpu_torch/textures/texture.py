"""Texture descriptions (host side).

Counterpart of raytracer_tpu/textures/texture.py.  This slice of the port
has solid colours only; image textures render through the record kernel,
which ROADMAP.md "Modules to port" item 7 brings.
"""

from __future__ import annotations

from ..core.vec import as_float3


class texture:
    pass


class solid_color(texture):
    def __init__(self, color):
        self.color = as_float3(color, "color")


def as_texture(value, name="color"):
    """Accept a vec3/sequence (solid colour) or a texture instance."""
    if isinstance(value, texture):
        return value
    return solid_color(as_float3(value, name))
