"""Gradient-safe math primitives on torch tensors.

Counterpart of raytracer_tpu/core/safemath.py.  `torch.sqrt(torch.clamp_min(x,
0))` is the usual masked square root on the forward pass, but its
backward pass is NaN at the saturation boundary: sqrt'(0) = inf and the
clamp's gradient is 0, so the chain rule evaluates 0 * inf, and one NaN
poisons every gradient it is accumulated into.  Ray tracers saturate
exactly there (missed sphere discriminants, total internal reflection,
grazing spherical caps), so autograd through the renderer needs the
double-where form below.

`safe_sqrt` equals `sqrt(max(0, x))` except on the sliver 0 < x <= eps
(where it returns sqrt(eps) instead of a smaller positive number), and its
gradient is finite everywhere: 0 for x <= 0, bounded near the boundary.
"""

import torch

__all__ = ["safe_sqrt", "safe_norm", "div", "rdiv"]


def safe_sqrt(x, eps=1e-30):
    """sqrt(max(0, x)) with a finite gradient everywhere."""
    r = torch.sqrt(torch.clamp_min(x, eps))
    return torch.where(x > 0, r, torch.zeros_like(r))


def safe_norm(v, dim=-1, keepdim=False, eps=1e-30):
    """``torch.linalg.vector_norm(v, dim=dim)`` with a finite gradient at
    v = 0.

    The norm's own backward is v / ||v|| = 0 / 0 at the origin, and a
    later ``clamp_min(norm, tiny)`` guards only the division that follows,
    not the norm's backward.  Equal to the l2 norm away from 0.
    """
    return safe_sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim), eps)


def div(a, s):
    """a / s for a Python number s, correctly rounded on every device: on
    CUDA, torch turns a division by a Python number into a product with
    its rounded reciprocal, so the card and the CPU would differ by an
    ulp."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def rdiv(s, a):
    """s / a for a Python number s, a true division (torch computes
    `s / a` as a rounded reciprocal times s)."""
    return torch.tensor(s, dtype=a.dtype, device=a.device) / a
