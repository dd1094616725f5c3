"""Material description classes (host side).

Counterpart of raytracer_tpu/materials/base.py: the constructors take the
same keyword arguments and hold parameters only; the shading math lives in
the solid kernel (ops/solid_trace.py).  The type ids are the JAX package's,
so compiled tables carry over unchanged.
"""

from __future__ import annotations

from ..core.vec import as_complex3
from ..textures.texture import as_texture

MAT_NONE = 0
MAT_EMISSIVE = 1
MAT_GLOSSY = 2
MAT_DIFFUSE = 3
MAT_REFRACTIVE = 4
MAT_THINFILM = 5
MAT_CUSTOM = 7


class Material:
    mat_type = MAT_NONE

    def __init__(self, normalmap=None):
        if normalmap is not None:
            raise NotImplementedError(
                "normal maps are not ported yet (ROADMAP.md 'Modules to "
                "port' item 8, the wavefront slice)")
        self.normalmap = None
        self.assigned_primitive = None


class Emissive(Material):
    """Area-light surface; terminates paths (sightpy emissive.py:11-23)."""

    mat_type = MAT_EMISSIVE

    def __init__(self, color, **kwargs):
        super().__init__(**kwargs)
        self.texture_color = as_texture(color)


class Diffuse(Material):
    """Monte-Carlo Lambertian with the cosine / light-cap importance
    mixture (sightpy diffuse.py:12-124).

    `diffuse_rays` is sightpy's first-bounce branching factor; the render
    traces one continuation per path and multiplies the samples per pixel
    by the scene's largest `diffuse_rays` instead (Scene._diffuse_fan).
    """

    mat_type = MAT_DIFFUSE

    def __init__(self, diff_color, diffuse_rays=20, ambient_weight=0.5, **kwargs):
        super().__init__(**kwargs)
        self.diff_texture = as_texture(diff_color)
        self.diffuse_rays = int(diffuse_rays)
        self.max_diffuse_reflections = 2
        self.ambient_weight = float(ambient_weight)


class Refractive(Material):
    """Complex-IoR Fresnel dielectric with Beer-Lambert absorption
    (sightpy refractive.py:10-123).  dispersion=True is accepted by the
    scene description, but the solid kernel of this slice refuses it
    (ROADMAP.md "TPU kernels to port", K1)."""

    mat_type = MAT_REFRACTIVE

    def __init__(self, n, dispersion=False, **kwargs):
        super().__init__(**kwargs)
        self.n = as_complex3(n, "n")
        self.dispersion = bool(dispersion)
