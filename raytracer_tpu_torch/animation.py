"""Animation and motion blur: frames over time on one device.

Counterpart of raytracer_tpu/animation.py, with the reference's
`create_animation` / `create_animation_using_opencv` signatures
(sightpy/animation.py:6-54) and the JAX package's `render_frames` and
`render_motion_blur`.  `update_scene(scene, t)` mutates the scene for
time t; each time point is compiled once and its tables uploaded once,
then its chunks trace through the path Scene.render would take
(`scene.route`): the solid kernel (`solid_trace_chunk`) or the record
kernel (`record_trace_chunk`) on CUDA, their plain versions when the
caller asks for the CPU, and the wavefront past the gates.  The scene's
structure must stay the same across time points (`_FramePlan`
raises, as the JAX package does).  With `mesh=` (a 1-D "frame" mesh,
`frame_mesh`, or any mesh of parallel/sharded.py, whose devices are
taken in order) frame or slice j renders on device j mod the mesh's
size, as the JAX package's frame-axis sharding does; its sums come back
to `device` and add up in frame order, so a frame (or a motion-blurred
image) is the one a single device renders.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .core.camera import cam_vec, projection_mask
from .core.compile import compile_all, derive_max_bounces, derive_split_k
from .core.integrator import RenderSettings
from .core.ray import resolve_device
from .core.safemath import div
from .ops.record_trace import record_trace_chunk
from .ops.solid_trace import solid_trace_chunk
from .utils.colour import srgb_linear_to_srgb


def frame_mesh(devices=None):
    """A 1-D "frame" mesh over `devices` (animation.py:39; default every
    visible CUDA device); a list may repeat a device."""
    from .parallel.sharded import Mesh

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("frame_mesh found no CUDA device; pass "
                               "devices=")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid, ("frame",))


def _mesh_devices(mesh, device, what):
    """(the devices frames take in turn, the output device)."""
    if mesh is None:
        device = resolve_device(device, what)
        return [device], device
    if not hasattr(mesh, "devices"):
        raise ValueError(f"{what}: mesh must be a grid of devices "
                         "(animation.frame_mesh, parallel.sharded.make_mesh)")
    devs = [torch.device(d) for d in
            np.asarray(mesh.devices, dtype=object).reshape(-1)]
    for d in devs:
        resolve_device(d, what)
    return devs, resolve_device(device if device is not None else devs[0],
                                what)


class _FramePlan:
    """What render_frames and render_motion_blur share (animation.py:144):
    the settings, route and chunk plan fixed at the first time point, one
    compile and upload per time point with the structure check, and the
    chunks' seed rows.

    Seeds: one stream of `core.scene.chunk_seeds(seed, ...)` rows, frame
    j's chunk c taking row j * n_chunks + c, all rows sharing the render's
    R2 rotation seed, so that a one-chunk frame 0 is Scene.render's frame
    bit for bit.  The rows' sample offsets follow `strat`."""

    def __init__(self, scene, samples_per_pixel, update_scene, t_first,
                 seed, device, n_frames, devices=None):
        from .core.scene import MAX_RAYS_PER_CHUNK, chunk_seeds, route

        self.scene, self.update_scene = scene, update_scene
        self.device = device
        self.devices = devices or [device]
        self.frame_device = device      # where render() traces now
        self.W = scene.camera.screen_width
        self.H = scene.camera.screen_height
        update_scene(scene, t_first)
        self.static0 = compile_all(scene)[0]
        split_k = derive_split_k(self.static0)
        self.settings = RenderSettings(
            max_bounces=derive_max_bounces(self.static0), split_k=split_k,
            sampler=scene.settings.sampler,
            projection=scene.camera.projection, collect_stats=True,
            use_pallas=scene.settings.use_pallas)
        self.path = route(self.static0, self.settings)
        split_fan = 1 << split_k
        eff_spp = samples_per_pixel * scene._diffuse_fan() * split_fan
        chunk = max(1, min(eff_spp, MAX_RAYS_PER_CHUNK // (self.W * self.H)))
        self.chunk = max(split_fan, chunk - chunk % split_fan)
        self.n_chunks = -(-eff_spp // self.chunk)
        self.spp_frame = self.n_chunks * self.chunk
        self.seeds = chunk_seeds(seed, n_frames * self.n_chunks, self.chunk)

    def frame_tables(self, t):
        """The scene at time t, compiled and uploaded once to the frame's
        device: (tables for the path, camera)."""
        device = self.frame_device
        self.update_scene(self.scene, t)
        static, tables, data = compile_all(self.scene)
        if static != self.static0:
            raise ValueError(
                "update_scene changed the scene STRUCTURE between time "
                "points (object/material/light counts must stay "
                "constant; only traced parameters may animate)")
        if self.path == "wavefront":
            return data.to(device), self.scene.camera.params()
        return (tables.to(device),
                cam_vec(self.scene.camera.params()).to(device))

    def seed_row(self, frame, c, advance_per_frame):
        """[chunk seed, R2 rotation seed, first sample] of chunk c of
        frame `frame` (animation.py:211): advance_per_frame 0 keeps one
        lattice for every frame; spp_frame walks one lattice across the
        frames (motion blur: the slices together are one full-spp sample
        set)."""
        row = self.seeds[frame * self.n_chunks + c].copy()
        row[2] = frame * advance_per_frame + c * self.chunk
        return row

    def chunk_sum(self, tables, cam, row):
        """One chunk's radiance summed over its samples, (H * W, 3),
        non-finite samples scrubbed, on the frame's device."""
        from .core.scene import wavefront_chunk

        device = self.frame_device

        s = self.settings
        args = (s.max_bounces, s.split_k, s.sampler, s.projection)
        W, H = self.W, self.H
        if self.path == "wavefront":
            L, _ = wavefront_chunk(row, self.static0, tables, cam, s, W, H,
                                   self.chunk)
        else:
            seed = torch.from_numpy(np.asarray(row, np.int32)).to(device)
            if self.path == "solid":
                L, _ = solid_trace_chunk(seed, tables, cam, W, H, self.chunk,
                                         *args)
            else:
                L, _ = record_trace_chunk(seed, self.static0, tables, cam, W,
                                          H, self.chunk, *args)
        L = torch.where(torch.isfinite(L), L, 0.0)
        return L.view(self.chunk, H * W, 3).sum(dim=0)

    def render(self, frame, t, advance_per_frame):
        """The radiance sum of every chunk of the scene at time t, traced
        on the frame's device (frame mod the devices) and returned on the
        plan's."""
        from .parallel.sharded import _on

        self.frame_device = self.devices[frame % len(self.devices)]
        with _on(self.frame_device):
            tables, cam = self.frame_tables(t)
            acc = None
            for c in range(self.n_chunks):
                part = self.chunk_sum(tables, cam,
                                      self.seed_row(frame, c,
                                                    advance_per_frame))
                acc = part if acc is None else acc + part
        return acc.to(self.device)

    def mask(self, acc):
        pmask = projection_mask(self.settings.projection, self.W, self.H)
        if pmask is None:
            return acc
        return acc * torch.from_numpy(pmask).to(acc.device)[:, None]

    def tonemap(self, acc, n_samples):
        """(H, W, 3) uint8: sRGB of the mean, truncated as array_to_pil
        quantises."""
        srgb = srgb_linear_to_srgb(div(self.mask(acc), float(n_samples)))
        img = (torch.clamp(srgb, 0.0, 1.0) * 255.0).to(torch.uint8)
        return img.reshape(self.H, self.W, 3).cpu().numpy()


def render_frames(scene, samples_per_pixel, times, update_scene, seed=0,
                  mesh=None, device=None):
    """One frame per entry of `times`, each the scene as update_scene left
    it at that time: yields (H, W, 3) uint8 arrays (animation.py:226).
    Every frame draws its samples from the same R2 lattice (stable
    anti-aliasing, no shimmer).  device: as for Scene.render (default
    "cuda"; "cpu" when asked; with a mesh its first device).  mesh: a
    frame mesh (`frame_mesh`): frame j renders on its device j mod the
    mesh's size, the same image it renders alone."""
    devices, device = _mesh_devices(mesh, device, "render_frames")
    times = list(times)
    plan = _FramePlan(scene, samples_per_pixel, update_scene, times[0], seed,
                      device, len(times), devices)
    for i, t in enumerate(times):
        yield plan.tonemap(plan.render(i, t, 0), plan.spp_frame)


def render_motion_blur(scene, samples_per_pixel, update_scene,
                       shutter=(0.0, 1.0), slices=None, seed=0, mesh=None,
                       output="srgb", device=None):
    """Distribution motion blur over an open shutter (animation.py:264).

    The shutter is cut into `slices` times (slice midpoints); each slice
    renders samples_per_pixel / slices camera samples of the scene as
    update_scene(scene, t) leaves it, and the radiance accumulates on the
    device across slices before one tonemap.  The R2 lattice continues
    across slices (the union of the slices is the full-spp sample set).
    slices=None takes min(32, spp); samples_per_pixel rounds up to a
    multiple of slices.  Returns a PIL image (output="srgb") or the
    (H, W, 3) float32 linear mean (output="linear").  device: as for
    Scene.render.  mesh: a frame mesh (`frame_mesh`): slice j traces on
    its device j mod the mesh's size; the slices' sums add up on `device`
    in slice order, so the image is the one-device image bit for bit."""
    from PIL import Image

    devices, device = _mesh_devices(mesh, device, "render_motion_blur")
    slices = (max(1, min(32, samples_per_pixel)) if slices is None
              else min(slices, samples_per_pixel))
    slice_spp = -(-samples_per_pixel // slices)
    t0, t1 = shutter
    dt = (t1 - t0) / slices
    times = [t0 + (j + 0.5) * dt for j in range(slices)]
    plan = _FramePlan(scene, slice_spp, update_scene, times[0], seed, device,
                      slices, devices)
    acc = None
    for j, t in enumerate(times):
        part = plan.render(j, t, plan.spp_frame)
        acc = part if acc is None else acc + part
    n_total = slices * plan.spp_frame
    if output == "linear":
        lin = div(plan.mask(acc), float(n_total))
        return lin.reshape(plan.H, plan.W, 3).cpu().numpy()
    return Image.fromarray(plan.tonemap(acc, n_total))


def _frame_times(fps, start_time, final_time):
    number_of_frames = int(fps * (final_time - start_time))
    dt = (final_time - start_time) / number_of_frames
    return [start_time + i * dt for i in range(number_of_frames)]


def create_animation(scene, samples_per_pixel, fps, start_time, final_time,
                     update_scene, name, frames_dir="./frames",
                     progress=False, device=None, mesh=None):
    """Render frames to PNG files <frames_dir>/<name>_<i>.png (sightpy
    animation.py:6-31); returns the frames a second.  mesh: as for
    render_frames."""
    from PIL import Image

    out = Path(frames_dir)
    out.mkdir(exist_ok=True)
    times = _frame_times(fps, start_time, final_time)
    t0 = time.time()
    for i, frame in enumerate(render_frames(scene, samples_per_pixel, times,
                                            update_scene, mesh=mesh,
                                            device=device)):
        Image.fromarray(frame).save(str(out / f"{name}_{i}.png"))
        if progress:
            print(f"frame {i + 1}/{len(times)} {time.time() - t0:.2f}s",
                  flush=True)
    wall = time.time() - t0
    return len(times) / wall if wall > 0 else 0.0


def create_animation_using_opencv(scene, samples_per_pixel, fps, start_time,
                                  final_time, update_scene, name,
                                  device=None):
    """Stream frames into an MJPG video (sightpy animation.py:34-54);
    returns the frames a second.  Needs OpenCV (cv2): ImportError
    without it."""
    import cv2

    times = _frame_times(fps, start_time, final_time)
    size = (scene.camera.screen_width, scene.camera.screen_height)
    writer = cv2.VideoWriter(name, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    t0 = time.time()
    n = 0
    for frame in render_frames(scene, samples_per_pixel, times, update_scene,
                               device=device):
        writer.write(frame[..., ::-1])          # RGB -> BGR
        n += 1
    writer.release()
    wall = time.time() - t0
    return n / wall if wall > 0 else 0.0
