"""Host-side image loading and output.

Counterpart of raytracer_tpu/utils/image_io.py: the asset search path
(`add_asset_root`, `resolve_asset`), `load_image` with its /255
normalisation (the JAX package's fix of sightpy's /256), and
`array_to_pil`.  Pillow is imported only when an image file is actually
read or made, so ndarray textures and `render(output="linear")` work on
machines without it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .colour import srgb_to_srgb_linear

# Scenes name textures by bare filename (sightpy's API); files are looked
# up in each root and its textures/ backgrounds/ normalmaps/ subdirectories.
_DEFAULT_ROOTS = [Path(__file__).resolve().parent.parent / "assets"]
if os.environ.get("SIGHTPY_ASSETS"):
    _DEFAULT_ROOTS.insert(0, Path(os.environ["SIGHTPY_ASSETS"]))

_SUBDIRS = ("", "textures", "backgrounds", "normalmaps", "backgrounds/lightmaps")


def add_asset_root(path):
    """Prepend a directory to the asset search path."""
    _DEFAULT_ROOTS.insert(0, Path(path))


def resolve_asset(name, subdir_hint=None):
    """Find an asset file by name (or return the path unchanged if it exists)."""
    p = Path(name)
    if p.is_absolute() or p.exists():
        return p
    subdirs = ([subdir_hint] if subdir_hint else []) + list(_SUBDIRS)
    for root in _DEFAULT_ROOTS:
        for sub in subdirs:
            cand = root / sub / name
            if cand.exists():
                return cand
    raise FileNotFoundError(
        f"asset {name!r} not found under roots {[str(r) for r in _DEFAULT_ROOTS]}; "
        "set SIGHTPY_ASSETS or call add_asset_root()")


def load_image(path, subdir_hint=None, blur=0.0):
    """Load an image as a float32 array in [0, 1], shape (H, W, 3)."""
    found = resolve_asset(path, subdir_hint)
    from PIL import Image, ImageFilter

    img = Image.open(found)
    if blur != 0.0:
        img = img.filter(ImageFilter.GaussianBlur(radius=blur))
    a = np.asarray(img, dtype=np.float32) / 255.0
    if a.ndim == 2:
        a = np.stack([a, a, a], axis=-1)
    return a[..., :3]


def load_image_as_linear_srgb(path, blur=0.0, subdir_hint=None):
    """Load an image and linearise it (sightpy image_functions.py:19-33)."""
    return srgb_to_srgb_linear(
        load_image(path, subdir_hint=subdir_hint, blur=blur)).astype(np.float32)


def array_to_pil(array):
    """Convert a (H, W, 3) float [0, 1] array to a PIL RGB image."""
    from PIL import Image

    a = np.clip(np.asarray(array), 0.0, 1.0)
    return Image.fromarray((a * 255).astype(np.uint8), "RGB")
