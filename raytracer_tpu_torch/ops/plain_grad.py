"""The plain backward of a wavefront stage whose forward is a hand-written
kernel.

W4's blocks (`wavefront_shade._Shade`), W5's attributes (`hit_attrs._Attrs`)
and W6's bounce tail (`bounce_tail._Start`, `_Update`) each run their
kernel in a `torch.autograd.Function`.  Their backward passes are
kernels of their own, held bit for bit to the plain stage's
vector-Jacobian product, recomputed from the saved inputs (`plain_vjp`;
`wavefront_shade.plain_shade_vjp`, `bounce_tail.plain_update_vjp`,
`plain_start_vjp`, `hit_attrs.plain_attrs_vjp`), which they take only on
the explicit routes their modules count.  Each forward calls
`set_materialize_grads(False)`, so that an output that takes no gradient
comes to the backward as None, not as zeros; `plain_vjp` then runs
nothing where no gradient comes.  `recording` records the backward calls
for the holds.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def recording(calls, *functions):
    """While inside, each backward of the autograd Functions `functions`
    (W4's, W5's and W6's, whose forward takes (call, *xs)) is appended to
    calls as (the Function, its forward's call and inputs, the output
    gradients, the inputs' needs_input_grad): the holds of a backward
    kernel against the plain VJP replay them (`backward_pair` of
    ops/bounce_tail.py, ops/hit_attrs.py and ops/wavefront_shade.py).  The Functions' own forward
    and backward are restored after."""
    saved = [(f, f.__dict__["forward"], f.__dict__["backward"]) for f in functions]

    def forward(f, real):
        def call(fctx, c, *xs):
            fctx.recorded = (c, xs)
            return real.__func__(fctx, c, *xs)
        return staticmethod(call)

    def backward(f, real):
        def call(fctx, *grads):
            calls.append((f, *fctx.recorded, grads, fctx.needs_input_grad[1:]))
            return real.__func__(fctx, *grads)
        return staticmethod(call)

    for f, fwd, bwd in saved:
        f.forward, f.backward = forward(f, fwd), backward(f, bwd)
    try:
        yield calls
    finally:
        for f, fwd, bwd in saved:
            f.forward, f.backward = fwd, bwd
