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

`take` is a gather whose gradient is reproducible: `index_select`'s
backward on CUDA adds the gradient of each gathered row into the table
with atomics, in an order that changes from run to run, so two backward
passes of one render differed in the last bits.  Its backward sorts the
indices and sums each index's run by a scan of fixed shape
(`_segment_sums`), with no atomics and no serial loop over a run: PyTorch's
own deterministic path (index_put_ with accumulate, which
torch.use_deterministic_algorithms selects) sums a run serially, and
the inverse-rendering scene's gathers from a one-row table made its
backward pass 4.6x slower on an H100 (PERF.md).  Every gather from a
table that can require grad goes through it.
"""

import math

import torch

__all__ = ["safe_sqrt", "safe_norm", "div", "rdiv", "take", "take_backward"]


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


def _segment_sums(idx, v):
    """(the rows idx names, each with the sum of the rows of v that name
    it) as (target, sums): target (N,) is each row's index where it is
    the last of its index in a stable sort of idx and -1 elsewhere, sums
    (N, K) the inclusive sums of v's rows within their index's run,
    flattened past the first dimension.  The runs are summed by a
    segmented Hillis-Steele scan: log2(N) passes of fixed shape, each
    adding the row d before where it names the same index; every add is
    one elementwise op, so the order is fixed, on every device alike."""
    order = torch.argsort(idx, stable=True)
    s = idx.index_select(0, order)
    v = v.reshape(v.shape[0], math.prod(v.shape[1:])).index_select(0, order)
    n, d = s.shape[0], 1
    while d < n:
        same = (s[d:] == s[:-d])[:, None]
        v = torch.cat([v[:d], v[d:] + torch.where(same, v[:-d], 0.0)])
        d *= 2
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    return torch.where(last, s, -1), v


class _Take(torch.autograd.Function):
    """table.index_select(0, idx) with a backward that adds the rows'
    gradients in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return take_backward(idx, grad, ctx.shape), None


def take_backward(idx, grad, shape):
    """The gradient of a table of `shape` that `take(table, idx)` hands
    grad (a row an index): each row's sum of the rows of grad that name it,
    in `_segment_sums`' fixed order."""
    target, sums = _segment_sums(idx, grad)
    # one write a row that idx names (a spare row takes the others)
    out = grad.new_zeros((shape[0] + 1, sums.shape[1]))
    out.index_put_((torch.where(target < 0, shape[0], target),), sums)
    return out[:-1].reshape(shape)


def take(table, idx):
    """table.index_select(0, idx), idx int64 (N,): the same forward, bit
    for bit, and a gradient with respect to table that is the same on
    every run and every device (`index_select`'s, up to the order of its
    sums)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(0, idx)
    return _Take.apply(table, idx)
