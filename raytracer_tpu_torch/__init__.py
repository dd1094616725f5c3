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
and MeshInstances; the wavefront is what `Ray`, `get_raycolor`,
`get_distances`, `first_hit` and `Scene.get_distances` also use.  Around
them:
checkpoints, adaptive sampling, the variance of the mean, previews,
`Scene.render_environment`, JSON scenes (`scene_io`), Radiance `.hdr`
files, and sightpy's sampling API (`core/rng.py`, `utils/random.py`).
The public names follow raytracer_tpu's star-import surface; the names
that wait for a later slice are listed in NOT_YET_PORTED with their
ROADMAP.md item.  This package imports neither jax nor raytracer_tpu.
"""

import numpy as np

from .backgrounds.blur import blur_skybox, blur_skybox_array
from .backgrounds.environment import Panorama, SkyBox, procedural_sky
from .core.camera import Camera
from .core.integrator import RenderSettings
from .core.ray import Hit, Ray, first_hit, get_distances, get_raycolor
from .core.scene import Scene
from .core.vec import array_to_vec3, extract, rgb, vec3
from .geometry.primitive import (Cuboid, Cylinder, Disc, MeshInstances,
                                 Plane, Primitive, Sphere, Surface, Triangle,
                                 TriangleMesh)
from .lights import DirectionalLight, Light, PointLight, SpotLight
from .materials.base import (Diffuse, Emissive, Glossy, Material, Refractive,
                             ThinFilmInterference)
from .scene_io import (load_scene_file, save_scene_file, scene_from_dict,
                       scene_to_dict)
from .textures.texture import image, solid_color, texture
from .utils.colour import (srgb_linear_to_srgb, srgb_to_srgb_linear,
                           tonemap_display)
from .utils.constants import FARAWAY, SKYBOX_DISTANCE, UPDOWN, UPWARDS
from .utils.image_io import (add_asset_root, load_hdr, load_image,
                             load_image_as_linear_srgb, load_image_with_blur,
                             save_hdr)
from .utils.random import (PDF, cosine_pdf, hemisphere_pdf, mixed_pdf,
                           random_in_unit_disk, random_in_unit_sphere,
                           random_in_unit_spherical_cap,
                           random_in_unit_spherical_caps, spherical_caps_pdf)

# sightpy star-exports these camelCase names (colour_functions.py,
# image_functions.py); user scripts call them verbatim
sRGB_linear_to_sRGB = srgb_linear_to_srgb
sRGB_to_sRGB_linear = srgb_to_srgb_linear
load_image_as_linear_sRGB = load_image_as_linear_srgb

_SHADING = ("ROADMAP.md 'Modules to port' item 5 (wavefront C: custom "
            "shading)")
_FEATURES = ("ROADMAP.md 'Modules to port' item 6 (features on the "
             "wavefront)")
# raytracer_tpu's public names that this package does not have yet, each
# with the slice that brings it
NOT_YET_PORTED = {
    "CustomMaterial": _SHADING, "ShadeOut": _SHADING,
    "default_shade_out": _SHADING,
    "render_aovs": _FEATURES, "denoise": _FEATURES,
    "create_animation": _FEATURES, "create_animation_using_opencv": _FEATURES,
    "render_motion_blur": _FEATURES, "render_ods": _FEATURES,
}


def __getattr__(name):
    if name in NOT_YET_PORTED:
        raise AttributeError(
            f"raytracer_tpu_torch.{name} is not ported yet: "
            f"{NOT_YET_PORTED[name]}")
    raise AttributeError(f"module 'raytracer_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Scene", "Camera", "RenderSettings", "vec3", "rgb", "np",
    "Ray", "Hit", "get_raycolor", "get_distances", "first_hit",
    "PDF", "hemisphere_pdf", "cosine_pdf", "spherical_caps_pdf", "mixed_pdf",
    "random_in_unit_disk", "random_in_unit_sphere",
    "random_in_unit_spherical_cap", "random_in_unit_spherical_caps",
    "Primitive", "Sphere", "Plane", "Cuboid", "Disc", "Cylinder", "Triangle",
    "TriangleMesh", "MeshInstances", "Surface",
    "Light", "PointLight", "DirectionalLight", "SpotLight",
    "Material", "Diffuse", "Emissive", "Refractive", "Glossy",
    "ThinFilmInterference", "SkyBox", "Panorama", "procedural_sky",
    "texture", "image", "solid_color", "add_asset_root",
    "load_scene_file", "scene_from_dict", "save_scene_file", "scene_to_dict",
    "load_image", "load_image_as_linear_srgb", "load_image_with_blur",
    "save_hdr", "load_hdr",
    "srgb_linear_to_srgb", "srgb_to_srgb_linear", "tonemap_display",
    "sRGB_linear_to_sRGB", "sRGB_to_sRGB_linear", "load_image_as_linear_sRGB",
    "blur_skybox", "blur_skybox_array", "extract", "array_to_vec3",
    "FARAWAY", "SKYBOX_DISTANCE", "UPDOWN", "UPWARDS",
]
