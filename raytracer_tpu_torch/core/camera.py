"""Camera description: pinhole / thin lens, fisheye, equirect, orthographic.

Counterpart of raytracer_tpu/core/camera.py.  `Camera` takes the same
constructor arguments; `params()` derives the frame exactly as the JAX
package does (in float64, then float32), and `cam_vec` packs it into the
17 floats the kernels read (raytracer_tpu/core/scene.py:109-112):
origin, fwd, right, up, cam_w, cam_h, lens_radius, focal, half_fov.
Ray generation itself happens inside the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vec import as_float3

PROJECTIONS = ("pinhole", "equirect", "fisheye", "orthographic")


@dataclass(frozen=True)
class CameraParams:
    origin: np.ndarray      # (3,) float32 look_from
    fwd: np.ndarray         # (3,)
    right: np.ndarray       # (3,)
    up: np.ndarray          # (3,)
    cam_w: np.float32       # film width at unit distance
    cam_h: np.float32
    lens_radius: np.float32
    focal: np.float32       # focal distance
    half_fov: np.float32    # field_of_view / 2 in radians


class Camera:
    """Host-side camera description (sightpy camera.py:8-49)."""

    def __init__(self, look_from, look_at, screen_width=400, screen_height=300,
                 field_of_view=90.0, aperture=0.0, focal_distance=1.0,
                 projection="pinhole"):
        if projection not in PROJECTIONS:
            raise ValueError(
                "projection must be 'pinhole', 'equirect', 'fisheye' or "
                f"'orthographic', got {projection!r}")
        self.screen_width = int(screen_width)
        self.screen_height = int(screen_height)
        self.aspect_ratio = float(screen_width) / screen_height
        self.look_from = as_float3(look_from, "look_from")
        self.look_at = as_float3(look_at, "look_at")
        self.field_of_view = float(field_of_view)
        self.aperture = float(aperture)
        self.focal_distance = float(focal_distance)
        self.projection = projection

    def params(self) -> CameraParams:
        cam_w = np.tan(self.field_of_view * np.pi / 180 / 2.0) * 2.0
        cam_h = cam_w / self.aspect_ratio
        fwd = self.look_at - self.look_from
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        f = lambda v: np.asarray(v, dtype=np.float32)
        return CameraParams(
            origin=f(self.look_from), fwd=f(fwd), right=f(right), up=f(up),
            cam_w=f(cam_w), cam_h=f(cam_h),
            lens_radius=f(self.aperture / 2.0), focal=f(self.focal_distance),
            half_fov=f(self.field_of_view * np.pi / 360.0),
        )


def projection_mask(projection, width, height):
    """(H*W,) float32 mask of the pixels inside a circular fisheye's image
    circle, or None for the other projections (raytracer_tpu
    camera.py:92-107).  Scene.render applies it to the accumulated
    radiance at output time."""
    if projection != "fisheye":
        return None
    m = min(width, height)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    xn = (2.0 * (xs + 0.5) - width) / m
    yn = (height - 2.0 * (ys + 0.5)) / m
    return (xn * xn + yn * yn <= 1.0).astype(np.float32).reshape(-1)


def cam_vec(p: CameraParams) -> torch.Tensor:
    """The (17,) float32 camera vector of the solid kernel, on the CPU."""
    v = np.concatenate([p.origin, p.fwd, p.right, p.up,
                        np.stack([p.cam_w, p.cam_h, p.lens_radius, p.focal,
                                  p.half_fov])]).astype(np.float32)
    return torch.from_numpy(v)
