"""W6: the wavefront's bounce tail (csrc/bounce_tail.cu).

`core/integrator.py` `trace` starts each bounce's merged shading output
with `bounce_start` and ends the bounce with `bounce_update`:

- `bounce_start`: the merged output (ops/wavefront_shade.py `Merged`)
  every ray starts from (no emission, unit throughput, the ray as it came,
  no continuation) with the emissive and environment blocks
  (materials/shade.py `shade_emissive`, `shade_env`) merged into it; the
  diffuse, refractive and glossy blocks (W4) then write their rays into
  it in place, and the other blocks merge into it.
- `bounce_update`: the radiance, throughput and carry update, from one
  `Carry` (the wavefront's state between bounces) to the next.

On CUDA tensors each is one launch of W6 (a failed build or launch
raises; nothing falls back); on CPU tensors it is W6's plain version,
`plain_start` / `plain_update`, the stage as `trace` ran it op by op,
which W6 equals bit for bit.  `bounce_start.launches` and
`bounce_update.launches` count the kernels launched.

W6 reads the emissive and environment textures as W4 reads its blocks'
(`wavefront_shade.texture_tables`: one flat texel buffer and a
descriptor a slot, made once per data and kept on its material tables),
and a medium every ray shares as its one row.  Where autograd records a
stage (grad enabled and an input requiring grad), the kernel runs inside
`_Start` / `_Update`, whose backward is a kernel too (`start_vjp`,
`update_vjp`: csrc/bounce_tail.cu `bounce_start_bwd`, `bounce_update_bwd`,
one launch each), the plain stage's vector-Jacobian product
(`plain_start_vjp`, `plain_update_vjp`) bit for bit; the tables'
gradients are `core/safemath.py` `take`'s scans of the start kernel's
per-ray rows, the textures' those of its texel taps' rows.
`backward_launches()` counts the backward kernels.

The `_launch_*` functions and the VJPs take `lib=`: the tests pass the CPU
stand-in's build of the source (csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import torch

from ..core.compile import TexRef
from ..materials import shade
from ..materials.base import MAT_EMISSIVE, MAT_ENV
from . import cuda_build
from . import wavefront_shade as ws
from ..core.safemath import take_backward
from .mesh_sweep import _call, kept
from .plain_grad import plain_vjp

_V, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# W6's kernels by name, as a profile lists them
KERNELS = ("bounce_start_kernel", "bounce_update_kernel")


class Start(ctypes.Structure):
    _fields_ = [("packed", _V), ("P", _V), ("D", _V), ("uv", _V), ("n_re", _V),
                ("n_im", _V), ("re_step", _L), ("im_step", _L), ("depth", _V),
                ("n", _L), ("emissive", _I), ("em_color", _V), ("em_rows", _I),
                ("em_tex", ws.Textures), ("env", _I), ("env_tex", ws.Textures),
                ("env_lm", ws.Textures), ("env_li", _V), ("env_rows", _I),
                *((f, _V) for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS)]


CARRY_FLOATS = ("L", "beta", "O", "D", "n_re", "n_im")
CARRY_OTHERS = ("alive", "depth", "diffuse_refl", "split_cnt", "rays_traced")

_CARRY_IN = ("L", "beta", "alive", "miss", "add", "beta_mult", "new_origin",
             "new_dir", "new_n_re", "new_n_im", "cont", "is_diffuse", "did_split",
             "O", "D", "n_re", "n_im")


class Update(ctypes.Structure):
    _fields_ = [*((f, _V) for f in _CARRY_IN), ("re_step", _L), ("im_step", _L),
                ("depth", _V), ("diffuse_refl", _V), ("split_cnt", _V),
                ("traced", _V), ("n", _L),
                *((f, _V) for f in ("L_out", "beta_out", "alive_out", "O_out",
                                    "D_out", "n_re_out", "n_im_out", "depth_out",
                                    "diffuse_out", "split_out", "traced_out",
                                    "scratch"))]


# the update's backward: the next carry's float gradients (CARRY_FLOATS),
# the forward's rows and masks it reads, and its inputs' gradients by the
# name of the input (`_UPDATE_FLOATS`)
_UPDATE_GRADS = tuple(f"g{f}" for f in CARRY_FLOATS)
_UPDATE_SAVED = ("beta", "add", "beta_mult", "alive", "miss", "cont")


class UpdateBwd(ctypes.Structure):
    _fields_ = [*((f, _V) for f in _UPDATE_GRADS + _UPDATE_SAVED), ("n", _L),
                *((f"d{f}", _V) for f in ("L", "beta", "add", "beta_mult",
                                          "new_origin", "O", "new_dir", "D",
                                          "new_n_re", "n_re", "new_n_im", "n_im"))]


class StartBwd(ctypes.Structure):
    _fields_ = [*((f, _V) for f in ("g_add", "g_origin", "g_dir", "g_n_re", "g_n_im",
                                    "mat_type", "mat_slot", "depth", "uv")),
                ("n", _L), ("em", _I), ("env", _I), ("em_refs", _I),
                ("em_ref_slot", _V), ("em_ref_tex", ws.Textures), ("env_slots", _I),
                ("env_slot", _V), ("env_lm_row", _V), ("env_lm", ws.Textures),
                *((f, _V) for f in ("dP", "dD", "dn_re", "dn_im", "duv", "em_rows",
                                    "li_rows")),
                ("env_disp", ws.Textures), ("env_li", _V), ("env_rows", _I),
                ("taps", ws.TapRows)]


ENTRIES = {"bounce_start": [ctypes.POINTER(Start), _V, ctypes.POINTER(_I)],
           "bounce_update": [ctypes.POINTER(Update), _V, ctypes.POINTER(_I)],
           "bounce_start_bwd": [ctypes.POINTER(StartBwd), _V, ctypes.POINTER(_I)],
           "bounce_update_bwd": [ctypes.POINTER(UpdateBwd), _V, ctypes.POINTER(_I)]}


@dataclass
class Carry:
    """The wavefront's state between bounces (the JAX package's scan
    carry, integrator.py:213): radiance and throughput (N, 3), the rays
    alive (N,) bool, the path counters (N,) int32, the rays (N, 3), the
    medium (N, 3) (the expand of one row at the first bounce) and the rays
    traced so far (a 0-dim int64 tensor, or None: not counted)."""
    L: Any
    beta: Any
    alive: Any
    depth: Any
    diffuse_refl: Any
    split_cnt: Any
    O: Any
    D: Any
    n_re: Any
    n_im: Any
    rays_traced: Any = None




# ---------------------------------------------------------------------------
# the plain versions (the stages as core/integrator.py ran them, op by op)
# ---------------------------------------------------------------------------


def plain_start(ctx, mat_type):
    """W6's plain start: `Merged.start` (copies of P, D and the medium, no
    emission, unit throughput, no continuation), then the emissive and
    environment blocks merged where present.  ctx: what the blocks read of
    the bounce (P, D, n_re, n_im, uv, mat_slot, depth, data, static)."""
    acc = ws.Merged.start(ctx.P, ctx.D, ctx.n_re, ctx.n_im)
    present = ctx.static.mat_types_present
    if MAT_EMISSIVE in present:
        acc = acc.merge(shade.shade_emissive(ctx), mat_type == MAT_EMISSIVE)
    if MAT_ENV in present:
        acc = acc.merge(shade.shade_env(ctx), mat_type == MAT_ENV)
    return acc


def plain_update(c, miss, acc):
    """W6's plain update: the next Carry from c, the rays' misses and the
    bounce's merged output."""
    shaded = c.alive & ~miss
    L = c.L + torch.where(shaded[..., None], c.beta * acc.add, 0.0)
    traced = None if c.rays_traced is None else c.rays_traced + c.alive.sum()
    alive = shaded & acc.cont
    a3 = alive[..., None]
    beta = torch.where(a3, c.beta * acc.beta_mult, c.beta)
    # dead rays keep their last O / D and are swept again each bounce
    O = torch.where(a3, acc.new_origin, c.O)
    D = torch.where(a3, acc.new_dir, c.D)
    n_re = torch.where(a3, acc.new_n_re, c.n_re)
    n_im = torch.where(a3, acc.new_n_im, c.n_im)
    depth = c.depth + alive.to(torch.int32)
    diffuse_refl = c.diffuse_refl + (alive & acc.is_diffuse).to(torch.int32)
    split_cnt = c.split_cnt + (shaded & acc.did_split).to(torch.int32)
    return Carry(L, beta, alive, depth, diffuse_refl, split_cnt, O, D, n_re, n_im,
                 traced)


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------


def _same_device(dev, **xs):
    for name, x in xs.items():
        if x is not None and x.device != dev:
            raise ValueError(f"W6: {name} is on {x.device}, the rays on {dev}")


def _rows(name, x, n, dtype, width=None):
    """x detached and contiguous; raise unless of `dtype` and (n,) or
    (n, width)."""
    if x.dtype != dtype:
        raise TypeError(f"W6 takes {dtype} {name}, got {x.dtype}")
    if x.shape != ((n,) if width is None else (n, width)):
        raise ValueError(f"W6: {name} has shape {tuple(x.shape)} for {n} rays")
    return x.detach().contiguous()


def env_tables(data, static):
    """(display, lightmap) texture tables of the environment slots, over
    the light-intensity table's rows (`texture_tables`, repeat 1, nearest),
    each slot's last EnvSlot winning as in `shade.shade_env`; the lightmap
    table None where no winner has one."""
    last = {e.slot: e for e in static.env_slots}.values()
    mats = data.mats
    tex = ws.texture_tables(mats, mats.env_light_intensity,
                            [TexRef(e.slot, e.tex, 1.0) for e in last],
                            data.textures, "w6_env")
    lm = ws.texture_tables(mats, mats.env_light_intensity,
                           [TexRef(e.slot, e.lightmap, 1.0) for e in last
                            if e.lightmap is not None], data.textures, "w6_lightmap")
    return tex, lm


def _launch_start(ctx, packed, lib=None):
    """W6's start from `lib` on the bounce: a Merged of fresh contiguous
    tensors.  Adds its launches to `bounce_start.launches`."""
    n, dev = ctx.P.shape[0], ctx.P.device
    f = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)
    b = lambda: torch.empty((n,), dtype=torch.bool, device=dev)
    out = ws.Merged(f(), f(), f(), f(), f(), f(), b(), b(), b())
    if n == 0:
        return out
    data, static, mats = ctx.data, ctx.static, ctx.data.mats
    n_re, re_step = ws._medium(ctx.n_re)
    n_im, im_step = ws._medium(ctx.n_im)
    ins = dict(packed=_rows("packed words", packed, n, torch.int32),
               P=_rows("P", ctx.P, n, torch.float32, 3),
               D=_rows("D", ctx.D, n, torch.float32, 3),
               uv=_rows("uv", ctx.uv, n, torch.float32, 2),
               depth=_rows("depth", ctx.depth, n, torch.int32), n_re=n_re, n_im=n_im)
    _same_device(dev, **ins)
    present = static.mat_types_present
    em = MAT_EMISSIVE in present
    color = ws._f32(mats.emissive_color) if em else None
    em_tt = (ws.texture_tables(mats, mats.emissive_color, static.emissive_tex,
                               data.textures, "w6_emissive") if em else None)
    env = MAT_ENV in present and bool(static.env_slots)
    env_tt, lm_tt = env_tables(data, static) if env else (None, None)
    li = ws._f32(mats.env_light_intensity) if env else None
    _same_device(dev, emissive_color=color, env_light_intensity=li)
    struct = Start(**{k: v.data_ptr() for k, v in ins.items()}, re_step=re_step,
                   im_step=im_step, n=n, emissive=int(em), em_color=ws._p(color),
                   em_rows=color.shape[0] if em else 0, em_tex=ws._textures(em_tt),
                   env=int(env), env_tex=ws._textures(env_tt), env_lm=ws._textures(lm_tt),
                   env_li=ws._p(li), env_rows=li.shape[0] if env else 0,
                   **{k: getattr(out, k).data_ptr()
                      for k in ws.FLOAT_FIELDS + ws.BOOL_FIELDS})
    _COUNTED["bounce_start"].launches += _call(
        lib, "bounce_start", ctypes.byref(struct), cuda_build.stream_of(dev),
        entries=ENTRIES)
    return out


_SCRATCH = {}


def _scratch(device, stream):
    """The update's scratch for launches on `stream` of `device`: (the
    blocks' 64-bit sum, their ticket), zero between launches (the last
    block zeroes it); made once a stream.  Launches on one stream run one
    after another; two streams' launches, which may run at once, never
    share a scratch."""
    key = (device, None if stream is None else stream.value)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _SCRATCH[key]


def _launch_update(c, miss, acc, lib=None):
    """W6's update from `lib`: the next Carry, fresh contiguous tensors.
    Adds its launches to `bounce_update.launches`."""
    n, dev = c.L.shape[0], c.L.device
    f3 = lambda name, x: _rows(name, x, n, torch.float32, 3)
    b = lambda name, x: _rows(name, x, n, torch.bool)
    i = lambda name, x: _rows(name, x, n, torch.int32)
    n_re, re_step = ws._medium(c.n_re)
    n_im, im_step = ws._medium(c.n_im)
    ins = dict(L=f3("L", c.L), beta=f3("beta", c.beta), alive=b("alive", c.alive),
               miss=b("miss", miss),
               **{k: f3(k, getattr(acc, k)) for k in ws.FLOAT_FIELDS},
               **{k: b(k, getattr(acc, k)) for k in ws.BOOL_FIELDS},
               O=f3("O", c.O), D=f3("D", c.D), n_re=n_re, n_im=n_im,
               depth=i("depth", c.depth), diffuse_refl=i("diffuse_refl", c.diffuse_refl),
               split_cnt=i("split_cnt", c.split_cnt))
    traced = c.rays_traced
    if traced is not None:
        if traced.dtype != torch.int64 or traced.dim() != 0:
            raise TypeError("W6 counts rays_traced in a 0-dim int64 tensor")
        ins["traced"] = traced.detach()
    _same_device(dev, **ins)
    fl = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)
    it = lambda: torch.empty((n,), dtype=torch.int32, device=dev)
    out = Carry(L=fl(), beta=fl(), alive=torch.empty((n,), dtype=torch.bool, device=dev),
                depth=it(), diffuse_refl=it(), split_cnt=it(), O=fl(), D=fl(),
                n_re=fl(), n_im=fl(),
                rays_traced=None if traced is None else torch.empty(
                    (), dtype=torch.int64, device=dev))
    if n == 0:
        out.rays_traced = traced
        return out
    stream = cuda_build.stream_of(dev)
    scratch = _scratch(dev, stream) if traced is not None else None
    struct = Update(**{k: v.data_ptr() for k, v in ins.items()}, re_step=re_step,
                    im_step=im_step, n=n,
                    **{f"{k}_out": getattr(out, k).data_ptr()
                       for k in ("L", "beta", "alive", "O", "D", "n_re", "n_im",
                                 "depth")},
                    diffuse_out=out.diffuse_refl.data_ptr(),
                    split_out=out.split_cnt.data_ptr(),
                    traced_out=ws._p(out.rays_traced), scratch=ws._p(scratch))
    _COUNTED["bounce_update"].launches += _call(
        lib, "bounce_update", ctypes.byref(struct), stream, entries=ENTRIES)
    return out


# ---------------------------------------------------------------------------
# autograd: the kernel forward, the kernel backward
# ---------------------------------------------------------------------------

_START_RAYS = ("P", "D", "n_re", "n_im", "uv")


def _start_inputs(ctx):
    """The tensors the start's output is a function of, flat: the rays'
    P, D, medium and uv, the emissive colours, the environments' light
    intensity and the textures."""
    mats = ctx.data.mats
    return ([getattr(ctx, f) for f in _START_RAYS]
            + [mats.emissive_color, mats.env_light_intensity, *ctx.data.textures])


def _start_ctx(xs, mat_slot, depth, data, static):
    """What `plain_start` reads, with the tensors of `_start_inputs`
    replaced by xs."""
    k = len(_START_RAYS)
    data = dataclasses.replace(
        data, mats=dataclasses.replace(data.mats, emissive_color=xs[k],
                                       env_light_intensity=xs[k + 1]),
        textures=tuple(xs[k + 2:]))
    return SimpleNamespace(**dict(zip(_START_RAYS, xs[:k])), mat_slot=mat_slot,
                           depth=depth, data=data, static=static)


def _start_flow(ctx, mat_type, flags):
    """The float fields of the plain start's output that depend on an
    input requiring grad (flags: one a tensor of `_start_inputs`), read
    off its first ray on the meta device (`ws.kept_flow`); kept on the
    scene's static facts per flags."""
    def plain():
        xs = _start_inputs(ctx)
        k = len(_START_RAYS)
        xs = [ws._meta(x[:1]) for x in xs[:k]] + [ws._meta(x) for x in xs[k:]]
        leaves = [x.requires_grad_(fl) if fl else x for x, fl in zip(xs, flags)]
        return plain_start(_start_ctx(leaves, ws._meta(ctx.mat_slot[:1]),
                                      ws._meta(ctx.depth[:1]), ctx.data, ctx.static),
                           ws._meta(mat_type[:1]))

    return ws.kept_flow(ctx.static, "_w6_flow", flags, plain)


def plain_start_vjp(grads, xs, mat_type, mat_slot, depth, data, static, wants):
    """The plain start's vector-Jacobian product (ops/plain_grad.py
    `plain_vjp`): the gradients of the start's inputs xs (`_start_inputs`;
    None where not wanted or reached) from those of its float fields
    (ws.FLOAT_FIELDS)."""
    def plain(leaves):
        o = plain_start(_start_ctx(leaves, mat_slot, depth, data, static), mat_type)
        return [getattr(o, f) for f in ws.FLOAT_FIELDS]

    return plain_vjp(grads, xs, wants, plain)


def backward_tables(data, static):
    """{name: tensor} of the start's backward (csrc/bounce_tail.cu
    `StartBwd`): "em_ref_slot" (refs,) int32, each emissive image texture's
    slot, in SceneStatic.emissive_tex order, and "em_ref_tex" its
    (texels, desc_i, desc_f) a row a ref; "env_slot" (slots,) int32, each
    environment's slot in SceneStatic.env_slots order, "env_lm_row" its
    row of the light-intensity rows (-1 without a lightmap), "env_lm"
    the lightmaps' textures a row an environment and "env_disp" their
    display textures.  Made once per data and kept on its material
    tables."""
    mats, refs, envs = data.mats, static.emissive_tex, static.env_slots
    used = sorted({r[0] for r in start_texture_refs(data, static)})
    dev = mats.emissive_color.device

    def make():
        out = {}
        if refs:
            slot = torch.tensor([r.slot for r in refs], dtype=torch.int32, device=dev)
            out.update(em_ref_slot=slot, em_ref_tex=ws.texture_tables(
                mats, slot, [TexRef(i, r.tex, r.repeat, r.bilinear)
                             for i, r in enumerate(refs)], data.textures, "w6_bwd_em"))
        if envs:
            slot = torch.tensor([e.slot for e in envs], dtype=torch.int32, device=dev)
            rows, k = [], 0
            for e in envs:
                rows.append(-1 if e.lightmap is None else k)
                k += e.lightmap is not None
            out.update(env_slot=slot, env_lm_row=torch.tensor(
                rows, dtype=torch.int32, device=dev), env_lm=ws.texture_tables(
                mats, slot, [TexRef(i, e.lightmap, 1.0) for i, e in enumerate(envs)
                             if e.lightmap is not None], data.textures, "w6_bwd_lm"),
                env_disp=ws.texture_tables(
                    mats, slot, [TexRef(i, e.tex, 1.0) for i, e in enumerate(envs)],
                    data.textures, "w6_bwd_disp"))
        return out

    name = "_w6_bwd_" + "_".join(
        [f"{r.slot}.{r.tex}.{r.repeat}.{r.bilinear}" for r in refs]
        + [f"e{e.slot}.{e.lightmap}" for e in envs])
    return kept(mats, name, (mats.emissive_color, *(data.textures[k] for k in used)),
                make)


def _grad_rows(name, g, n):
    """An output gradient as the backward kernels read it (None stays)."""
    if g is None:
        return None
    return _rows(name, g, n, torch.float32, g.shape[-1] if g.dim() == 2 else None)


def start_vjp(grads, mat_type, mat_slot, depth, uv, data, static, wants, lib=None):
    """The start's vector-Jacobian product from W6's backward kernel (`lib`;
    csrc/bounce_tail.cu `bounce_start_bwd`), one launch (`_start_rows`):
    the gradients of `_start_inputs` (None where not wanted or not reached,
    as `plain_start_vjp` gives them, bit for bit) from those of the float
    fields (grads, one a ws.FLOAT_FIELDS; beta_mult's takes no part).  The
    tables' gradients are the scans of core/safemath.py `take` over the
    kernel's per-ray rows, the textures' those of its taps' rows
    (`start_texture_refs`, `ws.texture_grads`)."""
    out = [None] * len(wants)
    got = _start_rows(grads, mat_type, mat_slot, depth, uv, data, static, wants, lib)
    if got is None:
        return out
    d, em_rows, li_rows, taps, wanted, trefs = got
    k = len(_START_RAYS) + 2
    out[:5] = d
    mats = data.mats
    if em_rows is not None:
        out[5] = take_backward(shade.slot_rows(mat_slot, mats.emissive_color), em_rows,
                               mats.emissive_color.shape)
    if li_rows is not None:
        # one gather a lightmap; the engine adds their gradients last first
        idx = shade.slot_rows(mat_slot, mats.env_light_intensity)
        for row in reversed(range(li_rows.shape[0])):
            t = take_backward(idx, li_rows[row], mats.env_light_intensity.shape)
            out[6] = t if out[6] is None else out[6] + t
    if taps[0] is not None:
        nr = len(static.emissive_tex)
        # the engine runs the environments' fetches first, the last one
        # first, its lightmap's before its display texture's; then the
        # emissive refs', the last first
        order = [j for e in reversed(range(len(static.env_slots)))
                 for j in _env_ref_rows(static, nr, e)[::-1]] + list(reversed(range(nr)))
        for t, grad in ws.texture_grads(trefs, *taps, wanted, order).items():
            out[k + t] = grad
    return out


def _start_rows(grads, mat_type, mat_slot, depth, uv, data, static, wants, lib=None):
    """W6's start backward kernel on the arguments of `start_vjp`, one
    launch: (the gradients of P, D, n_re, n_im and uv, the emissive
    colours' rows, the light intensity's (lightmaps, N) rows, the taps'
    (rows, idx), the wanted textures, `start_texture_refs`), None where
    nothing wanted is reached.  Adds its launches to `start_vjp.launches`
    (its TAPS instance's to `start_vjp.tap_launches` too)."""
    g = dict(zip(ws.FLOAT_FIELDS, grads))
    present = static.mat_types_present
    em, env = MAT_EMISSIVE in present, MAT_ENV in present
    refs, envs = static.emissive_tex, static.env_slots
    lms = sum(e.lightmap is not None for e in envs)
    add = g["add"] is not None
    reach = [g["new_origin"] is not None, g["new_dir"] is not None,
             g["new_n_re"] is not None, g["new_n_im"] is not None,
             add and em and any(r.bilinear for r in refs), add and em,
             add and env and lms > 0]
    k = len(reach)
    want = [w and r for w, r in zip(wants[:k], reach)]
    trefs = start_texture_refs(data, static)
    wanted = {r[0] for r in trefs if wants[k + r[0]]} if add else set()
    if not (any(want) or wanted):
        return None
    n, dev = mat_type.shape[0], mat_type.device
    f = lambda *s: torch.empty((n, *s), dtype=torch.float32, device=dev)
    d = [f(3) if w else None for w in want[:4]] + [f(2) if want[4] else None]
    em_rows = f(3) if want[5] else None
    li_rows = (torch.empty((lms, n), dtype=torch.float32, device=dev) if want[6]
               else None)
    taps = ws.tap_buffers(trefs, wanted, n, dev)
    if n:
        tabs = backward_tables(data, static)
        ins = dict(mat_type=_rows("mat_type", mat_type, n, torch.int32),
                   mat_slot=_rows("mat_slot", mat_slot, n, torch.int32),
                   depth=_rows("depth", depth, n, torch.int32),
                   uv=_rows("uv", uv, n, torch.float32, 2),
                   **{f"g_{a}": _grad_rows(a, g[b], n) for a, b in (
                       ("add", "add"), ("origin", "new_origin"), ("dir", "new_dir"),
                       ("n_re", "new_n_re"), ("n_im", "new_n_im"))})
        _same_device(dev, **ins, **{k: v for k, v in tabs.items()
                                    if isinstance(v, torch.Tensor)})
        struct = StartBwd(**{a: ws._p(v) for a, v in ins.items()}, n=n, em=int(em),
                          env=int(env), em_refs=len(refs),
                          em_ref_slot=ws._p(tabs.get("em_ref_slot")),
                          em_ref_tex=ws._textures(tabs.get("em_ref_tex")),
                          env_slots=len(envs), env_slot=ws._p(tabs.get("env_slot")),
                          env_lm_row=ws._p(tabs.get("env_lm_row")),
                          env_lm=ws._textures(tabs.get("env_lm")),
                          **dict(zip(("dP", "dD", "dn_re", "dn_im", "duv"),
                                     (ws._p(x) for x in d))),
                          em_rows=ws._p(em_rows), li_rows=ws._p(li_rows),
                          env_disp=ws._textures(tabs.get("env_disp")),
                          env_li=ws._p(ws._f32(data.mats.env_light_intensity)
                                       if env and taps[0] is not None else None),
                          env_rows=data.mats.env_light_intensity.shape[0],
                          taps=ws.TapRows(*(ws._p(x) for x in taps)))
        launched = _call(lib, "bounce_start_bwd", ctypes.byref(struct),
                         cuda_build.stream_of(dev), entries=ENTRIES)
        _COUNTED_BWD["bounce_start_bwd"].launches += launched
        if taps[0] is not None:
            _COUNTED_BWD["bounce_start_bwd"].tap_launches += launched
    return d, em_rows, li_rows, taps, wanted, trefs


def _env_ref_rows(static, nr, e):
    """The rows of `start_texture_refs` of environment e: its display
    texture's, then its lightmap's where it has one."""
    at = nr
    for j, env in enumerate(static.env_slots):
        rows = [at] + ([at + 1] if env.lightmap is not None else [])
        if j == e:
            return rows
        at += len(rows)
    raise IndexError(e)


def start_texture_refs(data, static):
    """The textures the start reads, as `ws.tex_refs` gives a block's refs
    and in the order of the backward kernel's tap planes: the emissive
    image textures' refs, then each environment's display texture and its
    lightmap where it has one (nearest)."""
    tx = data.textures
    envs = [(t, False, tuple(tx[t].shape)) for e in static.env_slots
            for t in (e.tex, e.lightmap) if t is not None]
    return ws.tex_refs(tx, static.emissive_tex) + tuple(envs)


class _Start(torch.autograd.Function):
    """W6's start forward (xs: `_start_inputs`), its fields that take no
    gradient from the plain start (`_start_flow`) and its bools marked
    non-differentiable.  Backward: W6's backward kernel (`start_vjp`)."""

    @staticmethod
    def forward(fctx, call, *xs):
        ctx, packed, mat_type, lib, flow = call
        out = _launch_start(ctx, packed, lib)
        fctx.mark_non_differentiable(
            *(getattr(out, f) for f in ws.FLOAT_FIELDS if f not in flow),
            *(getattr(out, f) for f in ws.BOOL_FIELDS))
        fctx.data, fctx.static, fctx.lib = ctx.data, ctx.static, lib
        fctx.set_materialize_grads(False)        # see ops/plain_grad.py
        # the kernel reads the words' fields, the depth and uv
        fctx.save_for_backward(mat_type, ctx.mat_slot, ctx.depth, ctx.uv)
        return tuple(getattr(out, f) for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS)

    @staticmethod
    def backward(fctx, *grads):
        mat_type, mat_slot, depth, uv = fctx.saved_tensors
        grads, wants = grads[:len(ws.FLOAT_FIELDS)], fctx.needs_input_grad[1:]
        with torch.profiler.record_function("wavefront.backward.start"):
            got = start_vjp(grads, mat_type, mat_slot, depth, uv, fctx.data,
                            fctx.static, wants, fctx.lib)
        # the bools take no gradient
        return (None, *got)


def _kernel_start(ctx, packed, mat_type, lib=None):
    """W6's start on the bounce, from `lib`, through `_Start` where
    autograd records the stage."""
    xs = _start_inputs(ctx)
    flags = tuple(x.requires_grad for x in xs)
    if not torch.is_grad_enabled() or not any(flags):
        return _launch_start(ctx, packed, lib)
    flow = _start_flow(ctx, mat_type, flags)
    return ws.Merged(*_Start.apply((ctx, packed, mat_type, lib, flow), *xs))


_UPDATE_FLOATS = ("L", "beta", *ws.FLOAT_FIELDS, "O", "D", "n_re", "n_im")
# the inputs each float output of the plain update is a function of
_UPDATE_FLOW = {"L": ("L", "beta", "add"), "beta": ("beta", "beta_mult"),
                "O": ("new_origin", "O"), "D": ("new_dir", "D"),
                "n_re": ("new_n_re", "n_re"), "n_im": ("new_n_im", "n_im")}
_UPDATE_OTHERS = ("alive", "miss", *ws.BOOL_FIELDS, "depth", "diffuse_refl",
                  "split_cnt", "rays_traced")


def _update_parts(c, miss, acc):
    """(the update's float inputs, `_UPDATE_FLOATS`; its others,
    `_UPDATE_OTHERS`)."""
    v = ({f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
         | {f: getattr(acc, f) for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS}
         | {"miss": miss})
    return [v[f] for f in _UPDATE_FLOATS], [v[f] for f in _UPDATE_OTHERS]


def _update_args(xs, others):
    """(Carry, miss, Merged) from the update's parts."""
    v = dict(zip(_UPDATE_FLOATS, xs)) | dict(zip(_UPDATE_OTHERS, others))
    c = Carry(**{f.name: v[f.name] for f in dataclasses.fields(Carry)})
    acc = ws.Merged(*(v[f] for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS))
    return c, v["miss"], acc


def plain_update_vjp(grads, xs, others, wants):
    """The plain update's vector-Jacobian product (ops/plain_grad.py
    `plain_vjp`): the gradients of its float inputs xs (`_UPDATE_FLOATS`;
    None where not wanted or reached) from those of the next carry's
    floats (CARRY_FLOATS); others: `_UPDATE_OTHERS`."""
    def plain(leaves):
        o = plain_update(*_update_args(leaves, others))
        return [getattr(o, f) for f in CARRY_FLOATS]

    return plain_vjp(grads, xs, wants, plain)


def update_vjp(grads, saved, wants, lib=None):
    """The update's vector-Jacobian product from W6's backward kernel
    (`lib`; csrc/bounce_tail.cu `bounce_update_bwd`), one launch: the
    gradients of `_UPDATE_FLOATS` (None where not wanted or not reached,
    as `plain_update_vjp` gives them, bit for bit) from those of the next
    carry's floats (grads, one a CARRY_FLOATS); saved: the forward's
    beta, add, beta_mult, alive, miss and cont (`_UPDATE_SAVED`).  Adds its
    launches to `update_vjp.launches`."""
    got = dict(zip(CARRY_FLOATS, grads))
    reach = {x for o, gr in got.items() if gr is not None for x in _UPDATE_FLOW[o]}
    want = {x for x, w in zip(_UPDATE_FLOATS, wants) if w and x in reach}
    if not want:
        return [None] * len(_UPDATE_FLOATS)
    v = dict(zip(_UPDATE_SAVED, saved))
    n, dev = v["beta"].shape[0], v["beta"].device
    out = {x: torch.empty((n, 3), dtype=torch.float32, device=dev) for x in want}
    if n:
        ins = {f"g{o}": _grad_rows(f"the {o} gradient", gr, n) for o, gr in got.items()}
        ins.update({f: _rows(f, v[f], n, torch.float32, 3)
                    for f in ("beta", "add", "beta_mult")},
                   **{f: _rows(f, v[f], n, torch.bool) for f in ("alive", "miss", "cont")})
        _same_device(dev, **ins)
        struct = UpdateBwd(**{k: ws._p(x) for k, x in ins.items()}, n=n,
                           **{f"d{x}": t.data_ptr() for x, t in out.items()})
        _COUNTED_BWD["bounce_update_bwd"].launches += _call(
            lib, "bounce_update_bwd", ctypes.byref(struct), cuda_build.stream_of(dev),
            entries=ENTRIES)
    return [out.get(x) for x in _UPDATE_FLOATS]


class _Update(torch.autograd.Function):
    """W6's update forward (xs: `_UPDATE_FLOATS`), its float outputs that
    take no gradient from the plain update (`_UPDATE_FLOW`), its bools
    and integers marked non-differentiable.  Backward: W6's backward
    kernel (`update_vjp`) from the rows and masks it reads, saved."""

    @staticmethod
    def forward(fctx, call, *xs):
        others, lib = call
        c, miss, acc = _update_args(xs, others)
        out = _launch_update(c, miss, acc, lib)
        req = {f for f, x in zip(_UPDATE_FLOATS, xs) if x.requires_grad}
        fctx.mark_non_differentiable(
            *(getattr(out, f) for f in CARRY_FLOATS if not req & set(_UPDATE_FLOW[f])),
            *(x for x in (getattr(out, f) for f in CARRY_OTHERS) if x is not None))
        fctx.set_materialize_grads(False)        # see ops/plain_grad.py
        fctx.lib = lib
        fctx.save_for_backward(c.beta, acc.add, acc.beta_mult, c.alive, miss, acc.cont)
        return (*(getattr(out, f) for f in CARRY_FLOATS),
                *(getattr(out, f) for f in CARRY_OTHERS[:-1]), out.rays_traced)

    @staticmethod
    def backward(fctx, *grads):
        with torch.profiler.record_function("wavefront.backward.update"):
            got = update_vjp(grads[:len(CARRY_FLOATS)], fctx.saved_tensors,
                             fctx.needs_input_grad[1:], fctx.lib)
        # the bools and integers take no gradient
        return (None, *got)


def _kernel_update(c, miss, acc, lib=None):
    """W6's update from `lib`, through `_Update` where autograd records
    the stage."""
    xs, others = _update_parts(c, miss, acc)
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in xs):
        return _launch_update(c, miss, acc, lib)
    res = _Update.apply((others, lib), *xs)
    nf = len(CARRY_FLOATS)
    return Carry(**dict(zip(CARRY_FLOATS, res[:nf])),
                 **dict(zip(CARRY_OTHERS, res[nf:])))


def backward_pair(fn, call, xs, grads, wants, lib=None):
    """(kernel, plain) for a backward of `_Start` or `_Update` (fn) that
    ops/plain_grad.py `recording` recorded (its forward's call and inputs
    xs, its output gradients, the inputs' needs_input_grad): functions of
    no argument giving the inputs' gradients from W6's backward kernel
    (`lib`) and from the plain stage's VJP, for the holds of one against
    the other."""
    if fn is _Update:
        others = call[0]
        v = dict(zip(_UPDATE_FLOATS, xs)) | dict(zip(_UPDATE_OTHERS, others))
        g = grads[:len(CARRY_FLOATS)]
        return (lambda: update_vjp(g, [v[f] for f in _UPDATE_SAVED], wants, lib),
                lambda: plain_update_vjp(g, xs, others, wants))
    ctx, _, mat_type, _, _ = call
    g = grads[:len(ws.FLOAT_FIELDS)]
    plain = lambda: plain_start_vjp(g, xs, mat_type, ctx.mat_slot, ctx.depth,
                                    ctx.data, ctx.static, wants)
    return (lambda: start_vjp(g, mat_type, ctx.mat_slot, ctx.depth, ctx.uv, ctx.data,
                              ctx.static, wants, lib), plain)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def bounce_start(ctx, packed, mat_type):
    """The bounce's merged shading output (ops/wavefront_shade.py
    `Merged`) with its emissive and environment rays shaded: ctx the
    bounce's ShadeCtx, packed its rays' material words, mat_type their
    types.  W6 on CUDA tensors, `plain_start` on CPU tensors."""
    if ctx.P.device.type == "cpu":
        return plain_start(ctx, mat_type)
    return _kernel_start(ctx, packed, mat_type)


def bounce_update(c, miss, acc):
    """The next Carry from c, the rays' misses (N,) bool and the bounce's
    merged output acc (a Merged).  W6 on CUDA tensors, `plain_update` on
    CPU tensors."""
    if c.L.device.type == "cpu":
        return plain_update(c, miss, acc)
    return _kernel_update(c, miss, acc)


bounce_start.launches = bounce_update.launches = 0
# the functions whose counts a launch adds to (a spy may replace the
# module's wrappers)
_COUNTED = {"bounce_start": bounce_start, "bounce_update": bounce_update}


start_vjp.launches = update_vjp.launches = start_vjp.tap_launches = 0
# the functions whose counts the backward kernels' launches add to
_COUNTED_BWD = {"bounce_start_bwd": start_vjp, "bounce_update_bwd": update_vjp}


def launches():
    """W6's forward launches by entry."""
    return {k: w.launches for k, w in _COUNTED.items()}


def backward_launches(taps=False):
    """W6's backward launches by entry (taps: those of the start
    backward's TAPS instance)."""
    if taps:
        return _COUNTED_BWD["bounce_start_bwd"].tap_launches
    return {k: w.launches for k, w in _COUNTED_BWD.items()}


def reset_launches():
    """Zero the forward and backward counts."""
    for w in (*_COUNTED.values(), *_COUNTED_BWD.values()):
        w.launches = 0
    _COUNTED_BWD["bounce_start_bwd"].tap_launches = 0


INFO = ("registers", "local_bytes", "blocks_per_sm", "sms", "block")


def info(entry, lib=None):
    """What W6's kernel of `entry` ("bounce_start", "bounce_update",
    "bounce_start_bwd", "bounce_update_bwd" or "bounce_start_bwd_taps", the
    start backward's TAPS instance) was built to, read on the card
    (`bounce_tail_info`): registers and local memory (bytes: spills and
    stack) a thread, resident blocks an SM, the SMs and threads a block."""
    fn = (lib or cuda_build.load_library()).bounce_tail_info
    fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], _I
    out = (_I * len(INFO))()
    err = fn((*_COUNTED, *_COUNTED_BWD, "bounce_start_bwd_taps").index(entry), out)
    if err:
        raise RuntimeError(f"bounce_tail_info: CUDA error {err}")
    return dict(zip(INFO, out))
