"""raytracer_tpu_torch — the PyTorch / CUDA port of raytracer_tpu.

Solid-colour scenes (Sphere, Plane, Cuboid, Disc, Cylinder, Triangle and
small flat TriangleMeshes with Diffuse, Glossy, Emissive and Refractive materials, lights with
shadow rays, importance-sampled light caps, deterministic Fresnel
splitting, spectral dispersion, the pinhole, fisheye, equirect and
orthographic cameras) render through the solid kernel
(ops/solid_trace.py, csrc/solid_trace.cu); textured scenes (image
textures, SkyBox / Panorama environments, thin films) through the record
kernel, which traces, fetches the textures and integrates in one pass
(ops/record_trace.py, csrc/record_trace.cu).  Both kernels are written by
hand in CUDA; on the CPU their plain PyTorch versions run (on the record
path: records, then the replay of ops/replay.py).  Scenes past both
kernels' gates (more than 48 objects, more than 8 importance-sampled
targets or more than 36 shading groups), and any scene under
RenderSettings(use_pallas="never"), render through the wavefront
integrator in plain PyTorch (core/integrator.py, geometry/intersect.py,
geometry/attrs.py, materials/shade.py), as do triangle meshes with vertex
normals or uvs, meshes of 1,024 faces or more (swept in SAH clusters)
and MeshInstances, normal maps, an importance-sampled environment under
a Diffuse material and CustomMaterial shaders; the wavefront is what
`Ray`, `get_raycolor`, `get_distances`, `first_hit` and
`Scene.get_distances` also use.  Around them: checkpoints, adaptive
sampling, the variance of the mean, previews, `Scene.render_environment`,
JSON scenes (`scene_io`), Radiance `.hdr` files, sightpy's sampling API
(`core/rng.py`, `utils/random.py`), the AOV planes (`render_aovs`), the
à-trous denoiser (`denoise`, `Scene.render_denoised`), stereo 360 frames
(`render_ods`), animation and motion blur (`animation.py`), the
command line (`python -m raytracer_tpu_torch`, cli.py), differentiable
rendering (the `diff` module: autograd through the wavefront) and
multi-device rendering (the `parallel` package: `Scene.render(mesh=...)`
over a grid of devices, and one render across processes with
torch.distributed).  The public names follow raytracer_tpu's star-import
surface, and `diff` and `parallel` are its submodules of the same names;
nothing of the JAX package waits for a later slice (NOT_YET_PORTED is
empty).  This package imports neither jax nor raytracer_tpu.
"""

import numpy as np

from .animation import (create_animation, create_animation_using_opencv,
                        render_motion_blur)
from .backgrounds.blur import blur_skybox, blur_skybox_array
from .backgrounds.environment import Panorama, SkyBox, procedural_sky
from .core.aov import render_aovs
from .core.camera import Camera
from .core.integrator import RenderSettings
from .core.ray import Hit, Ray, first_hit, get_distances, get_raycolor
from .core.scene import Scene
from .core.vec import array_to_vec3, extract, rgb, vec3
from .geometry.primitive import (Cuboid, Cylinder, Disc, MeshInstances,
                                 Plane, Primitive, Sphere, Surface, Triangle,
                                 TriangleMesh)
from .lights import DirectionalLight, Light, PointLight, SpotLight
from .materials.base import (CustomMaterial, Diffuse, Emissive, Glossy,
                             Material, Refractive, ThinFilmInterference)
from .materials.shade import ShadeOut, default_shade_out
from .scene_io import (load_scene_file, save_scene_file, scene_from_dict,
                       scene_to_dict)
from .textures.texture import image, solid_color, texture
from .utils.colour import (srgb_linear_to_srgb, srgb_to_srgb_linear,
                           tonemap_display)
from .utils.constants import FARAWAY, SKYBOX_DISTANCE, UPDOWN, UPWARDS
from .utils.image_io import (add_asset_root, load_hdr, load_image,
                             load_image_as_linear_srgb, load_image_with_blur,
                             save_hdr)
from .denoise import denoise
from .vr import render_ods
from .utils.random import (PDF, cosine_pdf, hemisphere_pdf, mixed_pdf,
                           random_in_unit_disk, random_in_unit_sphere,
                           random_in_unit_spherical_cap,
                           random_in_unit_spherical_caps, spherical_caps_pdf)

# sightpy star-exports these camelCase names (colour_functions.py,
# image_functions.py); user scripts call them verbatim
sRGB_linear_to_sRGB = srgb_linear_to_srgb
sRGB_to_sRGB_linear = srgb_to_srgb_linear
load_image_as_linear_sRGB = load_image_as_linear_srgb

# what of raytracer_tpu this package does not have yet, each with the
# ROADMAP.md item that brings it: nothing since items 7 and 8
NOT_YET_PORTED = {}


def __getattr__(name):
    if name in NOT_YET_PORTED:
        raise AttributeError(
            f"raytracer_tpu_torch.{name} is not ported yet: "
            f"{NOT_YET_PORTED[name]}")
    raise AttributeError(f"module 'raytracer_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Scene", "Camera", "RenderSettings", "vec3", "rgb", "np",
    "Ray", "Hit", "get_raycolor", "get_distances", "first_hit",
    "render_aovs", "denoise",
    "PDF", "hemisphere_pdf", "cosine_pdf", "spherical_caps_pdf", "mixed_pdf",
    "random_in_unit_disk", "random_in_unit_sphere",
    "random_in_unit_spherical_cap", "random_in_unit_spherical_caps",
    "Primitive", "Sphere", "Plane", "Cuboid", "Disc", "Cylinder", "Triangle",
    "TriangleMesh", "MeshInstances", "Surface",
    "Light", "PointLight", "DirectionalLight", "SpotLight",
    "Material", "CustomMaterial", "ShadeOut", "default_shade_out",
    "Diffuse", "Emissive", "Refractive", "Glossy",
    "ThinFilmInterference", "SkyBox", "Panorama", "procedural_sky",
    "create_animation", "create_animation_using_opencv",
    "render_motion_blur", "render_ods",
    "texture", "image", "solid_color", "add_asset_root",
    "load_scene_file", "scene_from_dict", "save_scene_file", "scene_to_dict",
    "load_image", "load_image_as_linear_srgb", "load_image_with_blur",
    "save_hdr", "load_hdr",
    "srgb_linear_to_srgb", "srgb_to_srgb_linear", "tonemap_display",
    "sRGB_linear_to_sRGB", "sRGB_to_sRGB_linear", "load_image_as_linear_sRGB",
    "blur_skybox", "blur_skybox_array", "extract", "array_to_vec3",
    "FARAWAY", "SKYBOX_DISTANCE", "UPDOWN", "UPWARDS",
]
