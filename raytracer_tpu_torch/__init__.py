"""raytracer_tpu_torch — the PyTorch / CUDA port of raytracer_tpu.

Solid-colour scenes (Sphere, Plane, Cuboid, Disc, Cylinder and Triangle
with Diffuse, Glossy, Emissive and Refractive materials, lights with
shadow rays, importance-sampled light caps, deterministic Fresnel
splitting, spectral dispersion, the pinhole, fisheye, equirect and
orthographic cameras) render through the solid kernel
(ops/solid_trace.py, csrc/solid_trace.cu); textured scenes (image
textures, SkyBox / Panorama environments, thin films) through the record
kernel, which traces, fetches the textures and integrates in one pass
(ops/record_trace.py, csrc/record_trace.cu).  Both kernels are written by
hand in CUDA; on the CPU their plain PyTorch versions run (on the record
path: records, then the replay of ops/replay.py).  The public names
follow raytracer_tpu's star-import surface as far as the slices reach.
This package imports neither jax nor raytracer_tpu.
"""

import numpy as np

from .backgrounds.environment import Panorama, SkyBox, procedural_sky
from .core.camera import Camera
from .core.integrator import RenderSettings
from .core.scene import Scene
from .core.vec import rgb, vec3
from .geometry.primitive import (Cuboid, Cylinder, Disc, Plane, Primitive,
                                 Sphere, Triangle)
from .lights import DirectionalLight, Light, PointLight, SpotLight
from .materials.base import (Diffuse, Emissive, Glossy, Material, Refractive,
                             ThinFilmInterference)
from .textures.texture import image, solid_color, texture
from .utils.image_io import add_asset_root, load_image
from .utils.colour import srgb_linear_to_srgb, tonemap_display
from .utils.constants import FARAWAY, SKYBOX_DISTANCE, UPDOWN, UPWARDS

__all__ = [
    "Scene", "Camera", "RenderSettings", "vec3", "rgb", "np",
    "Primitive", "Sphere", "Plane", "Cuboid", "Disc", "Cylinder", "Triangle",
    "Light", "PointLight", "DirectionalLight", "SpotLight",
    "Material", "Diffuse", "Emissive", "Refractive", "Glossy",
    "ThinFilmInterference", "SkyBox", "Panorama", "procedural_sky",
    "texture", "image", "solid_color", "add_asset_root", "load_image",
    "srgb_linear_to_srgb", "tonemap_display",
    "FARAWAY", "SKYBOX_DISTANCE", "UPDOWN", "UPWARDS",
]
