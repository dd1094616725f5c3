"""Multi-device rendering over a ("sample", "pixel") grid of torch
devices."""

from .sharded import build_sharded_render, make_mesh, render_sharded
