"""Render settings (counterpart of RenderSettings in
raytracer_tpu/core/integrator.py).  The wavefront integrator itself is
ROADMAP.md "Modules to port" item 8."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderSettings:
    """Knobs of one render.

    max_bounces: path length budget; at the default, Scene.render derives
    it from the scene (compile.derive_max_bounces).
    split_k: deterministic Fresnel-split levels (0 = stochastic); at 0,
    Scene.render derives it from the scene (compile.derive_split_k).
    sampler: "r2" (per-pixel rotated R2 lattice, core/lds.py) or "iid".
    projection: the camera projection, set from Camera.projection.
    """

    max_bounces: int = 8
    split_k: int = 0
    sampler: str = "r2"
    projection: str = "pinhole"
