"""Material description classes (host side).

Counterpart of raytracer_tpu/materials/base.py: the constructors take the
same keyword arguments and hold parameters only; the shading math lives in
the kernels (ops/solid_trace.py, ops/record_trace.py) and the wavefront's
blocks (materials/shade.py), or for a CustomMaterial in its own `shade`.
The type ids are the JAX package's, so compiled tables carry over
unchanged.
"""

from __future__ import annotations

import numpy as np

from ..core.vec import as_complex3
from ..textures.texture import as_texture

MAT_NONE = 0
MAT_EMISSIVE = 1
MAT_GLOSSY = 2
MAT_DIFFUSE = 3
MAT_REFRACTIVE = 4
MAT_THINFILM = 5
MAT_ENV = 6          # skybox / panorama environment material
MAT_CUSTOM = 7


class Material:
    """Base: an optional tangent-space normal map (sightpy
    material.py:11-40).  normalmap: an (H, W, 3) array or an image path,
    set through `set_normalmap`."""

    mat_type = MAT_NONE

    def __init__(self, normalmap=None):
        self.normalmap = None
        self.normalmap_repeat = 1.0
        self.normalmap_bilinear = False
        if normalmap is not None:
            self.set_normalmap(normalmap)
        self.assigned_primitive = None

    def set_normalmap(self, normalmap, repeat=1.0, filter="nearest"):
        """Perturb the shading normal by this map, fetched at the hit's uv
        `repeat` times over; filter "nearest" or "bilinear"."""
        if isinstance(normalmap, np.ndarray):
            self.normalmap = np.asarray(normalmap, dtype=np.float32)
        else:
            from ..utils.image_io import load_image

            self.normalmap = load_image(normalmap, subdir_hint="normalmaps")
        self.normalmap_repeat = float(repeat)
        if filter not in ("nearest", "bilinear"):
            raise ValueError(
                f"filter must be 'nearest' or 'bilinear', got {filter!r}")
        self.normalmap_bilinear = filter == "bilinear"


class CustomMaterial(Material):
    """A user's material: subclass and implement `shade(ctx) -> ShadeOut`.

    The wavefront's hook (raytracer_tpu CustomMaterial): `shade` receives
    a ShadeCtx (core/integrator.py) describing the hit state of the whole
    wavefront (hit points ctx.P, shading normals ctx.N, ctx.uv, incoming
    directions ctx.D, ...) and returns a ShadeOut (materials/shade.py;
    start from `default_shade_out(ctx)` and set the fields it needs): the
    radiance at the hit (`add`), the throughput factor (`beta_mult`) and
    the continuation ray.  Write it in torch over (N, ...) tensors on the
    rays' device; the integrator keeps the result only on the rays that
    hit this material.

    Random numbers: the JAX hook's ctx.key has no torch counterpart.  Here
    ctx.generator is the chunk's torch.Generator; a shader draws from it
    (torch.rand(n, generator=ctx.generator, device=ctx.P.device)), and the
    integrator calls the custom shaders once a bounce each, in slot order,
    after the built-in blocks' draws, so the same seed gives the same
    image.  Draw the same count whatever the rays hit, or repeated renders
    stop being bit-equal.

    Plain-python parameters (numbers, strings, flat tuples) are part of
    the compile's fingerprint (`compile._custom_param_fp`); arrays and
    other objects count by identity, so assign a new array rather than
    change one in place.  Scenes with a CustomMaterial render on the
    wavefront only, never through a kernel.
    """

    mat_type = MAT_CUSTOM

    def shade(self, ctx):
        raise NotImplementedError(
            "subclass CustomMaterial and implement shade(ctx) -> ShadeOut")


class Emissive(Material):
    """Area-light surface; terminates paths (sightpy emissive.py:11-23)."""

    mat_type = MAT_EMISSIVE

    def __init__(self, color, **kwargs):
        super().__init__(**kwargs)
        self.texture_color = as_texture(color)


class Glossy(Material):
    """Lambert + Schlick-Fresnel / Blinn-Phong over the scene's lights, and
    the mirror continuation (sightpy glossy.py:11-110)."""

    mat_type = MAT_GLOSSY

    def __init__(self, diff_color, roughness, spec_coeff, diff_coeff, n, **kwargs):
        super().__init__(**kwargs)
        self.diff_texture = as_texture(diff_color)
        self.roughness = float(roughness)
        self.spec_coeff = float(spec_coeff)
        self.diff_coeff = float(diff_coeff)
        self.n = as_complex3(n, "n")


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
    (sightpy refractive.py:10-123).  dispersion=True refracts transmitted
    paths at one uniformly chosen channel's IoR (hero wavelength), that
    channel carrying 3x the throughput."""

    mat_type = MAT_REFRACTIVE

    def __init__(self, n, dispersion=False, **kwargs):
        super().__init__(**kwargs)
        self.n = as_complex3(n, "n")
        self.dispersion = bool(dispersion)


class ThinFilmInterference(Material):
    """Thin-film coating: reflectance from a (cos theta, thickness) LUT
    (sightpy thin_film_interference.py:11-115).

    Without a `lut`, sightpy's PNG table is read when the asset path has
    it, else the analytic Airy table (utils/thin_film.py) stands in; the
    same for the thickness-jitter `noise_texture`.  Pillow is needed only
    when such an asset file is found.
    """

    mat_type = MAT_THINFILM

    def __init__(self, thickness, noise=0.0, film_n=1.4, lut=None,
                 noise_texture=None, **kwargs):
        from ..utils.image_io import load_image, resolve_asset

        super().__init__(**kwargs)
        self.thickness = float(thickness)
        self.noise_factor = float(noise)
        self.film_n = float(film_n)
        self.custom_tables = lut is not None or noise_texture is not None
        if lut is not None:
            self.lut = np.asarray(lut, dtype=np.float32)
        else:
            try:
                p = resolve_asset(f"thin_film_interference_n={film_n:g}.png",
                                  subdir_hint="textures")
            except FileNotFoundError:
                from ..utils.thin_film import thin_film_lut
                self.lut = thin_film_lut(film_n)
            else:
                from PIL import Image

                # raw PNG values / 256, not linearised (sightpy's reading)
                self.lut = (np.asarray(Image.open(p), dtype=np.float32)
                            / 256.0)[..., :3]
        if noise_texture is not None:
            self.noise_texture = np.asarray(noise_texture, dtype=np.float32)
        else:
            try:
                self.noise_texture = np.ascontiguousarray(
                    load_image("noise.png", subdir_hint="textures")[..., 0])
            except FileNotFoundError:
                from ..utils.thin_film import default_noise_texture
                self.noise_texture = default_noise_texture()
