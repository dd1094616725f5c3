"""Camera description: pinhole / thin lens, fisheye, equirect, orthographic.

Counterpart of raytracer_tpu/core/camera.py.  `Camera` takes the same
constructor arguments; `params()` derives the frame exactly as the JAX
package does (in float64, then float32), and `cam_vec` packs it into the
17 floats the kernels read (raytracer_tpu/core/scene.py:109-112):
origin, fwd, right, up, cam_w, cam_h, lens_radius, focal, half_fov.
The kernels generate their rays themselves; `generate_rays` makes the
wavefront's (raytracer_tpu/core/camera.py:110-251).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import lds, rng
from .safemath import div
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


def generate_rays(generator, params: CameraParams, width, height, spp,
                  row0=0, rows=None, sampler="r2", strat_seed=None,
                  sample0=None, projection="pinhole", device=None):
    """(origin, direction), each (spp * rows * width, 3) float32: the camera
    rays of a band of `rows` film rows from row `row0`, in [sample, pixel]
    order, so that a (spp, rows * width, 3) view gives one frame a sample
    (raytracer_tpu/core/camera.py:110-251).

    sampler "r2": the jitter (and the thin lens) from the per-pixel
    rotated R2 lattice, keyed by the global pixel, with `strat_seed` the
    render's rotation seed and `sample0` the global index of the first
    sample (Python ints; drawn from `generator` when None), integer math
    that draws nothing; "iid": uniforms from `generator` in the JAX
    package's order (x jitter, y jitter, then the lens disk's r and phi).
    device: where the rays are made (default: the generator's).
    """
    if device is None:
        device = generator.device
    if rows is None:
        rows = height
    n_pix = width * rows
    n = spp * n_pix
    f32 = lambda v: torch.as_tensor(np.array(v, np.float32), device=device)
    origin0, fwd, right, up = (f32(params.origin), f32(params.fwd),
                               f32(params.right), f32(params.up))
    cam_w, cam_h = f32(params.cam_w), f32(params.cam_h)

    def lattice(dims):
        nonlocal strat_seed, sample0
        if strat_seed is None:
            strat_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                           device=generator.device))
        if sample0 is None:
            sample0 = 0
        idx = torch.arange(n, dtype=torch.int64, device=device)
        band_pix = torch.remainder(idx, n_pix)
        gpix = (band_pix + int(row0) * width) & lds.M32
        s = (torch.div(idx, n_pix, rounding_mode="floor") + int(sample0)) & lds.M32
        return [lds.to_float(lds.r2_bits(gpix, s, int(strat_seed), d))
                for d in dims]

    def uniforms(k):
        return [torch.rand(n, generator=generator, dtype=torch.float32,
                           device=generator.device).to(device) for _ in range(k)]

    if sampler not in ("r2", "iid"):
        raise ValueError(f"sampler must be 'r2' or 'iid', got {sampler!r}")
    if projection in ("equirect", "fisheye"):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        band_pix = torch.remainder(idx, n_pix)
        col = torch.remainder(band_pix, width).to(torch.float32)
        grow = float(row0) + torch.div(band_pix, width,
                                       rounding_mode="floor").to(torch.float32)
        u1, u2 = lattice((0, 1)) if sampler == "r2" else uniforms(2)
        if projection == "fisheye":
            m = float(min(width, height))
            xn = div(2.0 * (col + u1) - width, m)
            yn = div(height - 2.0 * (grow + u2), m)
            r = torch.sqrt(xn * xn + yn * yn)
            theta = r * f32(params.half_fov)
            phi = torch.atan2(yn, xn)
            sin_t = torch.sin(theta)
            d = (torch.cos(theta)[:, None] * fwd[None, :]
                 + (sin_t * torch.cos(phi))[:, None] * right[None, :]
                 + (sin_t * torch.sin(phi))[:, None] * up[None, :])
            return origin0[None, :].expand(n, 3), d
        u_img = div(col + u1, width)
        el = math.pi * (0.5 - div(grow + u2, height))
        phi0 = torch.atan2(fwd[2], fwd[0])
        phi = phi0 + 2.0 * math.pi * (u_img - 0.5)
        rho = torch.cos(el)
        d = torch.stack([rho * torch.cos(phi), torch.sin(el),
                         rho * torch.sin(phi)], dim=-1)
        return origin0[None, :].expand(n, 3), d

    # pixel centres in camera units (sightpy camera.py:36-49)
    xs = (div(torch.arange(width, dtype=torch.float32, device=device),
              width - 1) - 0.5) * cam_w
    ys = (0.5 - div(float(row0) + torch.arange(rows, dtype=torch.float32,
                                               device=device),
                    height - 1)) * cam_h
    gx = xs[None, :].expand(rows, width).reshape(-1).repeat(spp)
    gy = ys[:, None].expand(rows, width).reshape(-1).repeat(spp)
    lens = projection != "orthographic"     # parallel rays have no lens
    rx = ry = None
    if sampler == "r2":
        u1, u2, u3, u4 = lattice((0, 1, 2, 3))
        x = gx + (u1 - 0.5) * div(cam_w, width)
        y = gy + (u2 - 0.5) * div(cam_h, height)
        if lens:
            # thin-lens disk: (sqrt(r), 2 pi phi), as in the kernels
            r_d = torch.sqrt(u3)
            phi = u4 * (2.0 * math.pi)
            rx, ry = r_d * torch.cos(phi), r_d * torch.sin(phi)
    else:
        ux, uy = uniforms(2)
        x = gx + (ux - 0.5) * div(cam_w, width)
        y = gy + (uy - 0.5) * div(cam_h, height)
        if lens:
            rx, ry = rng.random_in_unit_disk(generator, (n,))
            rx, ry = rx.to(device), ry.to(device)
    focal = f32(params.focal)
    if not lens:
        # parallel rays along fwd over the pinhole's footprint at the
        # focal distance
        origin = (origin0[None, :] + right[None, :] * (x * focal)[:, None]
                  + up[None, :] * (y * focal)[:, None])
        return origin, fwd[None, :].expand(n, 3)
    lr = f32(params.lens_radius)
    origin = (origin0[None, :] + right[None, :] * (rx * lr)[:, None]
              + up[None, :] * (ry * lr)[:, None])
    target = (origin0[None, :] + up[None, :] * (y * focal)[:, None]
              + right[None, :] * (x * focal)[:, None] + fwd[None, :] * focal)
    return origin, unit(target - origin)


def unit(d):
    """(N, 3) directions scaled to unit length as the kernels scale theirs
    (x * (1 / sqrt(x.x)), solid_trace.py `_normalize3`), not by the JAX
    wavefront's division: the reference's sphere test is exact only for
    |D| = 1, and from afar the last bit of |D| decides some self-hits
    (ROADMAP.md §3), so both routes of the port round a camera ray alike."""
    s = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return d * (1.0 / torch.sqrt(torch.clamp_min(s, 1e-30)))[:, None]
