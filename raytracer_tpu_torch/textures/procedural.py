"""Procedural texture generators (counterpart of
raytracer_tpu/textures/procedural.py, the same numpy code).

Asset-free stand-ins for the reference's bundled images
(sightpy/textures/*.png), used by the examples when the original assets are
not on the asset search path, and by the port's smoke test on the card.
"""

from __future__ import annotations

import numpy as np


def checkerboard(size=512, squares=2, c0=(0.92, 0.92, 0.92), c1=(0.05, 0.05, 0.05)):
    """Checkerboard like sightpy/textures/checkered_floor.png (linear values)."""
    cell = size // (2 * squares)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return img.astype(np.float32)


def wood(size=512, seed=3):
    """Concentric-ring wood grain, loosely like sightpy/textures/wood.jpg."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    r = np.sqrt((xx - 0.4) ** 2 + (yy - 0.6) ** 2)
    rings = 0.5 + 0.5 * np.sin(r * 80 + rng.random() * 6)
    base = np.asarray([0.45, 0.27, 0.12], np.float32)
    light = np.asarray([0.7, 0.45, 0.22], np.float32)
    img = base + (light - base) * rings[..., None]
    return img.astype(np.float32)
