"""raytracer_tpu_torch — the PyTorch / CUDA port of raytracer_tpu.

The first slice: solid-colour scenes (Sphere, Plane, Cuboid with Diffuse,
Emissive and Refractive materials, importance-sampled light caps) render
through one hand-written CUDA kernel on the card (ops/solid_trace.py,
csrc/solid_trace.cu), or through its plain PyTorch version on the CPU.
The public names follow raytracer_tpu's star-import surface as far as the
slice reaches.  This package imports neither jax nor raytracer_tpu.
"""

import numpy as np

from .core.camera import Camera
from .core.integrator import RenderSettings
from .core.scene import Scene
from .core.vec import rgb, vec3
from .geometry.primitive import Cuboid, Plane, Primitive, Sphere
from .lights import DirectionalLight, Light, PointLight, SpotLight
from .materials.base import Diffuse, Emissive, Material, Refractive
from .textures.texture import solid_color, texture
from .utils.colour import srgb_linear_to_srgb, tonemap_display
from .utils.constants import FARAWAY, SKYBOX_DISTANCE, UPDOWN, UPWARDS

__all__ = [
    "Scene", "Camera", "RenderSettings", "vec3", "rgb", "np",
    "Primitive", "Sphere", "Plane", "Cuboid",
    "Light", "PointLight", "DirectionalLight", "SpotLight",
    "Material", "Diffuse", "Emissive", "Refractive",
    "texture", "solid_color", "srgb_linear_to_srgb", "tonemap_display",
    "FARAWAY", "SKYBOX_DISTANCE", "UPDOWN", "UPWARDS",
]
