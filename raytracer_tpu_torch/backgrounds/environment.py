"""Environment geometry: SkyBox (cube-cross map) and Panorama (equirect).

Counterpart of raytracer_tpu/backgrounds/environment.py: a giant cube or
sphere around the scene whose material shows the environment texture.
The optional lightmap is added only for secondary rays, scaled by
light_intensity (sightpy skybox.py:74-88); the compiler prebakes
display + intensity * lightmap into one table (core/compile.py
`_env_combined`).
"""

from __future__ import annotations

import numpy as np

from ..geometry.primitive import Cuboid, Sphere
from ..materials.base import MAT_ENV, Material
from ..utils.colour import srgb_to_srgb_linear
from ..utils.constants import SKYBOX_DISTANCE
from ..utils.image_io import load_hdr, load_image, resolve_asset
from .blur import blur_skybox_array


class EnvironmentMaterial(Material):
    mat_type = MAT_ENV

    def __init__(self, img, light_intensity=0.0, blur=0.0, layout="cross",
                 importance_sampled=False, linear=False):
        super().__init__()
        self.importance_sampled = bool(importance_sampled)
        # a Radiance .hdr / .rgbe file, or an ndarray with linear=True, is
        # already unbounded linear radiance: no sRGB EOTF, no [0, 1] clip;
        # the atlas stores such maps as RGB9E5 words when they are bright
        # (core/compile.py E5_PACK_LIMIT)
        is_hdr = (not isinstance(img, np.ndarray)
                  and str(img).lower().endswith((".hdr", ".rgbe"))) \
            or (isinstance(img, np.ndarray) and linear)
        self.is_hdr = is_hdr
        self.source = None if isinstance(img, np.ndarray) else str(img)
        self.blur = float(blur)
        self.linear = bool(linear)
        if isinstance(img, np.ndarray):
            raw = np.asarray(img, dtype=np.float32)
            self.texture = (raw if linear
                            else srgb_to_srgb_linear(raw).astype(np.float32))
        elif is_hdr:
            raw = load_hdr(resolve_asset(img, subdir_hint="backgrounds"))
            self.texture = raw
        else:
            raw = load_image(img, subdir_hint="backgrounds")
            self.texture = srgb_to_srgb_linear(raw).astype(np.float32)
        self.light_intensity = float(light_intensity)
        self.lightmap = None
        if light_intensity != 0.0:
            if isinstance(img, str) and not is_hdr:
                try:
                    self.lightmap = load_image(
                        img, subdir_hint="backgrounds/lightmaps")
                except FileNotFoundError:
                    # the texture itself is the light source
                    self.lightmap = raw
            else:
                self.lightmap = raw
        if blur == 0.0:
            self.blur_texture = None
        elif is_hdr:
            src = raw
            if layout == "cross":
                # replicate face edges into the empty cross cells so the
                # blur cannot bleed black across face borders
                from .blur import _fill_empty_cells
                src = _fill_empty_cells(np.asarray(raw, np.float32))
            self.blur_texture = _gaussian_blur_linear(
                src, blur, wrap_x=(layout == "equirect"))
        else:
            self.blur_texture = blur_skybox_array(raw, blur)


def _gaussian_blur_linear(arr, radius, wrap_x=False):
    """Separable Gaussian blur of an unbounded linear-radiance image
    (numpy).  wrap_x pads the x axis periodically (equirect seam);
    otherwise both axes are edge-clamped."""
    a = np.asarray(arr, np.float64)
    sigma = max(float(radius), 1e-3)
    # the pads below supply at most one image of context
    r = min(int(np.ceil(3 * sigma)), a.shape[0] - 1, a.shape[1] - 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    if wrap_x:
        ah = np.concatenate([a[:, a.shape[1] - r:], a, a[:, :r]], axis=1)
    else:
        ah = np.concatenate([a[:, :1].repeat(r, 1), a,
                             a[:, -1:].repeat(r, 1)], axis=1)
    ah = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 1, ah)
    ah = ah[:, r:ah.shape[1] - r]
    av = np.concatenate([ah[:1].repeat(r, 0), ah, ah[-1:].repeat(r, 0)], axis=0)
    av = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 0, av)
    av = av[r:av.shape[0] - r]
    return av.astype(np.float32)


class SkyBox(Cuboid):
    """Cube-cross map on a giant cube (sightpy skybox.py:9-32)."""

    def __init__(self, cubemap, center=(0.0, 0.0, 0.0), light_intensity=0.0,
                 blur=0.0, importance_sampled=False, linear=False):
        if importance_sampled:
            raise ValueError(
                "environment importance sampling needs an equirect map — "
                "use Panorama (the cube-cross direction mapping has no "
                "sampling tables)")
        material = EnvironmentMaterial(cubemap, light_intensity, blur,
                                       layout="cross", linear=linear)
        l = SKYBOX_DISTANCE
        super().__init__(center=center, material=material,
                         width=2 * l, height=2 * l, length=2 * l,
                         max_ray_depth=9999, shadow=False)
        self.light_intensity = light_intensity


class Panorama(Sphere):
    """Equirect panorama on a giant sphere (sightpy panorama.py:10-26)."""

    def __init__(self, panorama, center=(0.0, 0.0, 0.0), light_intensity=0.0,
                 blur=0.0, importance_sampled=False, linear=False):
        material = EnvironmentMaterial(panorama, light_intensity, blur,
                                       layout="equirect",
                                       importance_sampled=importance_sampled,
                                       linear=linear)
        super().__init__(center=center, material=material,
                         radius=SKYBOX_DISTANCE, max_ray_depth=9999, shadow=False)
        self.light_intensity = light_intensity


def procedural_sky(width=1024, height=768):
    """Simple gradient cube-cross map for asset-free demos and tests."""
    img = np.zeros((height, width, 3), dtype=np.float32)
    ch, cw = height // 3, width // 4
    yy = np.linspace(0, 1, height)[:, None]
    horizon = np.array([0.85, 0.88, 0.95], np.float32)
    zenith = np.array([0.25, 0.45, 0.85], np.float32)
    img[:] = horizon + (zenith - horizon) * yy[..., None]
    # top face brighter (sky), bottom face ground-ish
    img[0:ch, cw:2 * cw] = np.array([0.35, 0.3, 0.25], np.float32)
    img[2 * ch:, cw:2 * cw] = zenith
    return img
