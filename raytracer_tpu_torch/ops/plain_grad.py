"""The backward of a wavefront stage whose forward is a hand-written kernel.

W4's blocks (`wavefront_shade._Shade`), W5's attributes (`hit_attrs._Attrs`)
and W6's bounce tail (`bounce_tail._Start`, `_Update`) each run their
kernel in a `torch.autograd.Function` whose backward recomputes the plain
stage from the saved inputs and returns its vector-Jacobian product: the
gradient is the plain stage's, bit for bit.  Each forward calls
`set_materialize_grads(False)`, so that an output that takes no gradient
comes to the backward as None, not as zeros; `plain_vjp` then runs
nothing where no gradient comes.
"""

from __future__ import annotations

import torch


def plain_vjp(grads, xs, wants, plain):
    """The gradients of the inputs xs, one a tensor of xs (None where
    `wants` is false, where no gradient comes or where it is unused):
    plain(leaves) recomputes the stage's outputs, one a gradient of grads,
    from xs with the wanted ones made leaves that require grad, and its
    vector-Jacobian product with grads is taken."""
    if all(g is None for g in grads) or not any(wants):
        return [None] * len(xs)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() if w else x for x, w in zip(xs, wants)]
        pairs = [(y, g) for y, g in zip(plain(leaves), grads)
                 if g is not None and y.requires_grad]
        wrt = [x for x, w in zip(leaves, wants) if w]
        got = iter(torch.autograd.grad([y for y, _ in pairs], wrt,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs else ())
    return [next(got, None) if w else None for w in wants]
