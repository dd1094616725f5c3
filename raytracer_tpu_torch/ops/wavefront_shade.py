"""W4: the wavefront's shading blocks (csrc/wavefront_shade.cu).

`core/integrator.py` `trace` shades the diffuse, refractive and glossy
rays of a bounce through the wrappers here (`shade_diffuse`,
`shade_refractive`, `shade_glossy`, each with `.launches`).  A wrapper
takes the bounce's `ShadeCtx`, the draws of `integrator._draw`, the rays'
packed material words, the block's mask and the bounce's merged shading
output (`Merged`), and returns that output with its type's rays shaded.
On CPU tensors it runs the plain block (materials/shade.py) and merges
its output with torch.where, as the dispatch always has; on CUDA tensors
it launches W4, which writes the fields its type's rays change into the
merged output in place (a failed build or launch raises; nothing falls
back), equal to the plain dispatch bit for bit.

W4 reads the scene as data: the material slot tables, the lights, the
importance-sampled targets and the environment's alias tables by
pointer, and the block's image textures as one flat texel buffer with a
descriptor a slot (`texture_tables`, made once per data and kept on its
material tables by `mesh_sweep.kept`).  The glossy block's shadow rays
are cast here, as the plain block casts them (`shade.light_rays`,
`shade.light_occlusion`: W3 and W1), and W4 reads their answers.

Where autograd records the block (grad enabled and a field of the
merged output, an input or a table requiring grad), the kernel runs
inside `_Shade`, an autograd.Function whose backward returns the merge's
gradient and, where the block's own inputs need one, recomputes the
plain block under enable_grad for its vector-Jacobian product: the
gradient is the plain dispatch's.

The `_kernel_shade` function takes `lib=`: the tests pass the CPU
stand-in's build of the source (csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any

import torch

from ..materials import shade
from ..materials.base import MAT_DIFFUSE, MAT_GLOSSY, MAT_REFRACTIVE
from . import cuda_build
from .mesh_sweep import _call, kept

_V, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# W4's kernels by name, as a profile lists them
KERNELS = ("shade_diffuse_kernel", "shade_diffuse_wide_kernel",
           "shade_refractive_kernel", "shade_glossy_kernel")
SCHLICK = 5.0             # the Schlick exponent, passed to the kernel


class Rays(ctypes.Structure):
    _fields_ = [("packed", _V), ("P", _V), ("N", _V), ("D", _V), ("uv", _V),
                ("eps", _V), ("t", _V), ("orient", _V), ("n_re", _V),
                ("n_im", _V), ("re_step", _L), ("im_step", _L), ("depth", _V),
                ("diffuse_refl", _V), ("pattern", _V), ("split_cnt", _V),
                ("n", _L), ("add", _V), ("beta_mult", _V),
                ("new_origin", _V), ("new_dir", _V), ("new_n_re", _V),
                ("new_n_im", _V), ("cont", _V), ("is_diffuse", _V),
                ("did_split", _V)]


class Textures(ctypes.Structure):
    _fields_ = [("texels", _V), ("desc_i", _V), ("desc_f", _V)]


class Diffuse(ctypes.Structure):
    _fields_ = [("color", _V), ("ambient_w", _V), ("rows", _I),
                ("tex", Textures), ("u_mix", _V), ("u_phi", _V),
                ("u_r2", _V), ("s_mix", _V), ("s_phi", _V), ("s_r2", _V),
                ("pick", _V), ("is_center", _V), ("is_radius", _V),
                ("K", _I), ("env_prob", _V), ("env_alias", _V),
                ("env_pdf", _V), ("Hs", _I), ("Ws", _I)]


class Refractive(ctypes.Structure):
    _fields_ = [("m_re", _V), ("m_im", _V), ("dispersive", _V), ("rows", _I),
                ("scene_re", _V), ("scene_im", _V), ("k", _F * 3),
                ("u", _V), ("hero", _V), ("split_k", _I)]


class Glossy(ctypes.Structure):
    _fields_ = [("color", _V), ("diff", _V), ("rough", _V), ("spec", _V),
                ("m_re", _V), ("m_im", _V), ("rows", _I), ("tex", Textures),
                ("ambient", _V), ("scene_re", _V), ("scene_im", _V),
                ("dir_l", _V), ("dir_color", _V), ("n_dir", _I),
                ("point_pos", _V), ("point_color", _V), ("n_point", _I),
                ("spot_pos", _V), ("spot_dir", _V), ("spot_color", _V),
                ("spot_cos_in", _V), ("spot_cos_out", _V), ("n_spot", _I),
                ("occ", _V), ("five", _F)]


_BLOCKS = {MAT_DIFFUSE: ("shade_diffuse", Diffuse),
           MAT_REFRACTIVE: ("shade_refractive", Refractive),
           MAT_GLOSSY: ("shade_glossy", Glossy)}
ENTRIES = {entry: [ctypes.POINTER(Rays), ctypes.POINTER(cls), _V,
                   ctypes.POINTER(_I)] for entry, cls in _BLOCKS.values()}
ENTRIES["w4_caps_sum"] = [_V, _L, _I, _I, _V, _V, ctypes.POINTER(_I)]
ENTRIES["w4_trig_mismatches"] = [_V, _V, ctypes.POINTER(_I)]

FLOAT_FIELDS = ("add", "beta_mult", "new_origin", "new_dir", "new_n_re",
                "new_n_im")
BOOL_FIELDS = ("cont", "is_diffuse", "did_split")
# the float fields each entry writes (csrc/wavefront_shade.cu): the others
# keep the values `Merged.start` gives a ray
WRITTEN = {MAT_DIFFUSE: ("beta_mult", "new_origin", "new_dir"),
           MAT_REFRACTIVE: ("beta_mult", "new_origin", "new_dir", "new_n_re",
                            "new_n_im"),
           MAT_GLOSSY: ("add", "beta_mult", "new_origin", "new_dir")}


@dataclass
class Merged:
    """A bounce's merged shading output: each ray's fields from the block
    of its material type (`trace` starts it, every block merges into it),
    every field a contiguous tensor of its own, which W4 writes in
    place."""
    add: Any
    beta_mult: Any
    new_origin: Any
    new_dir: Any
    new_n_re: Any
    new_n_im: Any
    cont: Any
    is_diffuse: Any
    did_split: Any

    @classmethod
    def start(cls, P, D, n_re, n_im):
        """No emission, unit throughput, the ray as it came (copies of P,
        D, n_re and n_im), no continuation: the fields of a ray no block
        shades."""
        n = P.shape[0]
        f3 = lambda v: torch.full((n, 3), v, dtype=P.dtype, device=P.device)
        z = lambda: torch.zeros((n,), dtype=torch.bool, device=P.device)
        c = lambda x: x.clone(memory_format=torch.contiguous_format)
        return cls(f3(0.0), f3(1.0), c(P), c(D), c(n_re), c(n_im), z(), z(),
                   z())

    def merge(self, out, m):
        """The fields of `out` (a ShadeOut) where m, these elsewhere."""
        m3 = m[..., None]
        w = torch.where
        return Merged(
            w(m3, out.add, self.add), w(m3, out.beta_mult, self.beta_mult),
            w(m3, out.new_origin, self.new_origin),
            w(m3, out.new_dir, self.new_dir), w(m3, out.new_n_re, self.new_n_re),
            w(m3, out.new_n_im, self.new_n_im), w(m, out.cont, self.cont),
            w(m, out.is_diffuse, self.is_diffuse),
            self.did_split if out.did_split is None
            else w(m, out.did_split, self.did_split))


# ---------------------------------------------------------------------------
# the scene as W4 reads it
# ---------------------------------------------------------------------------


def _f32(x):
    """x detached and contiguous; raise unless float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"W4 takes float32 tables and rays, got {x.dtype}")
    return x.detach().contiguous()


def _p(t):
    return t.data_ptr() if t is not None and t.numel() else None


def texture_tables(mats, table, refs, textures):
    """(texels, desc_i, desc_f) of a block's image textures `refs`
    (SceneStatic.diffuse_tex / glossy_tex) over its slot table `table`:
    the textures they name, flattened into one (texels, 3) float32
    buffer; desc_i (slots, 4) int32 (offset in texels, H, W, flags: bit 0
    the slot fetches, bit 1 bilinear, the slot's last ref winning as in
    `shade._slot_color`); desc_f (slots, 2) float32 (W * repeat,
    H * repeat, rounded once from Python's product, as fetch_texture's
    scales).  None without refs.  Kept on `mats` while the textures and
    the table are the same tensors at the same version."""
    if not refs:
        return None
    used = sorted({r.tex for r in refs})
    srcs = (table, *(textures[k] for k in used))

    def make():
        with torch.no_grad():
            offs, at = {}, 0
            for k in used:
                tex = textures[k]
                if tex.dim() != 3 or tex.shape[-1] != 3:
                    raise ValueError("W4 reads (H, W, 3) textures")
                offs[k] = at
                at += tex.shape[0] * tex.shape[1]
            texels = torch.cat([_f32(textures[k]).reshape(-1) for k in used])
            rows = table.shape[0]
            di = torch.zeros((rows, 4), dtype=torch.int32)
            df = torch.zeros((rows, 2), dtype=torch.float32)
            for r in refs:
                if not 0 <= r.slot < rows:
                    continue
                H, W = textures[r.tex].shape[:2]
                di[r.slot] = torch.tensor([offs[r.tex], H, W,
                                           1 | (2 if r.bilinear else 0)])
                df[r.slot] = torch.tensor([W * r.repeat, H * r.repeat])
            return texels, di.to(table.device), df.to(table.device)

    name = "_w4_tex_" + "_".join(f"{r.slot}.{r.tex}.{r.repeat}.{r.bilinear}"
                                 for r in refs)
    return kept(mats, name, srcs, make)


def _textures(tt):
    if tt is None:
        return Textures()
    return Textures(*(x.data_ptr() for x in tt))


@functools.lru_cache(maxsize=None)
def beer_k(wavelengths):
    """2 pi / lambda in float32, as the refractive block computes it
    (`rdiv(2.0 * math.pi, lam)`; IEEE on every device)."""
    lam = torch.tensor(wavelengths, dtype=torch.float32)
    return (torch.tensor(2.0 * math.pi, dtype=torch.float32) / lam).tolist()


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


def _medium(x):
    """(x as the kernel reads it, its row step): its one row, uncopied,
    with step 0 where every ray shares it (the expand of one row, as
    `trace` starts), else its (N, 3) rows with step 3."""
    x = x.detach()
    if x.dtype != torch.float32:
        raise TypeError(f"W4 takes a float32 medium, got {x.dtype}")
    if x.shape[0] > 1 and x.stride(0) == 0 and x.stride(1) == 1:
        return x[0], 0
    return x.contiguous(), 3


def _i32(x):
    if x.dtype != torch.int32:
        raise TypeError(f"W4 takes int32 path counters, got {x.dtype}")
    return x.detach().contiguous()


def _rays(ctx, packed, out, keep):
    """The Rays struct of a bounce (the tensors it points into are
    appended to `keep`, which the caller holds until the launch)."""
    n = ctx.P.shape[0]
    n_re, re_step = _medium(ctx.n_re)
    n_im, im_step = _medium(ctx.n_im)
    split = ctx.split_k > 0 and ctx.pattern is not None
    ins = dict(packed=_i32(packed), P=_f32(ctx.P), N=_f32(ctx.N),
               D=_f32(ctx.D), uv=_f32(ctx.uv), eps=_f32(ctx.eps),
               t=_f32(ctx.t), orient=_f32(ctx.orient), n_re=n_re, n_im=n_im,
               depth=_i32(ctx.depth), diffuse_refl=_i32(ctx.diffuse_reflections))
    if split:
        ins.update(pattern=_i32(ctx.pattern), split_cnt=_i32(ctx.split_cnt))
    for name, x in ins.items():
        if x.device != ctx.P.device:
            raise ValueError(f"W4: {name} is on {x.device}, the rays on "
                             f"{ctx.P.device}")
    outs = {f: getattr(out, f) for f in FLOAT_FIELDS + BOOL_FIELDS}
    for f, x in outs.items():
        if not x.is_contiguous() or x.shape[0] != n:
            raise ValueError(f"W4 writes contiguous (N, ...) outputs: {f}")
    keep.extend(ins.values())
    return Rays(**{k: v.data_ptr() for k, v in ins.items()}, re_step=re_step,
                im_step=im_step, n=n, **{f: x.data_ptr() for f, x in outs.items()})


def _diffuse_args(ctx, draws, keep):
    data, static, mats = ctx.data, ctx.static, ctx.data.mats
    (u_mix, u_phi, u_r2), pick = draws
    color, aw = _f32(mats.diffuse_color), _f32(mats.diffuse_ambient_weight)
    tt = texture_tables(mats, mats.diffuse_color, static.diffuse_tex,
                        data.textures)
    u = [_f32(x) for x in (u_mix, u_phi, u_r2)]
    s = [_f32(x) for x in ctx.strat_u] if ctx.strat_u is not None else [None] * 3
    K = static.n_is_targets
    if K and (pick is None or pick.dtype != torch.int64):
        raise TypeError("W4's caps branch takes an int64 pick")
    Hs, Ws = tuple(static.env_is_shape)
    center, radius = _f32(data.is_center), _f32(data.is_radius)
    env = ([_f32(data.env_is_prob), data.env_is_alias.to(torch.int32).contiguous(),
            _f32(data.env_is_pdf)] if Hs else [None] * 3)
    pick = pick.contiguous() if K else None
    keep.extend([color, aw, *u, *s, pick, center, radius, *env, tt])
    return Diffuse(color=_p(color), ambient_w=_p(aw), rows=color.shape[0],
                   tex=_textures(tt), u_mix=_p(u[0]), u_phi=_p(u[1]),
                   u_r2=_p(u[2]), s_mix=_p(s[0]), s_phi=_p(s[1]), s_r2=_p(s[2]),
                   pick=_p(pick), is_center=_p(center) if K else None,
                   is_radius=_p(radius) if K else None, K=K,
                   env_prob=_p(env[0]), env_alias=_p(env[1]), env_pdf=_p(env[2]),
                   Hs=Hs, Ws=Ws)


def _refractive_args(ctx, draws, keep):
    data, static, mats = ctx.data, ctx.static, ctx.data.mats
    u, hero = draws
    m_re, m_im = _f32(mats.refr_n_re), _f32(mats.refr_n_im)
    disp = _f32(mats.refr_dispersive) if static.has_dispersion else None
    if static.has_dispersion and (hero is None or hero.dtype != torch.int64):
        raise TypeError("W4's dispersive branch takes an int64 hero channel")
    hero = hero.contiguous() if static.has_dispersion else None
    s_re, s_im, u = _f32(data.scene_n_re), _f32(data.scene_n_im), _f32(u)
    keep.extend([m_re, m_im, disp, hero, s_re, s_im, u])
    return Refractive(m_re=_p(m_re), m_im=_p(m_im), dispersive=_p(disp),
                      rows=m_re.shape[0], scene_re=_p(s_re), scene_im=_p(s_im),
                      k=(_F * 3)(*beer_k(tuple(ctx.wavelengths))), u=_p(u),
                      hero=_p(hero),
                      split_k=int(ctx.split_k) if ctx.pattern is not None else 0)


def _glossy_args(ctx, occ, keep):
    data, static, mats, lights = ctx.data, ctx.static, ctx.data.mats, ctx.data.lights
    tabs = [_f32(x) for x in (mats.glossy_color, mats.glossy_diff,
                              mats.glossy_roughness, mats.glossy_spec,
                              mats.glossy_n_re, mats.glossy_n_im)]
    tt = texture_tables(mats, mats.glossy_color, static.glossy_tex, data.textures)
    const = [_f32(x) for x in (data.ambient_color, data.scene_n_re,
                               data.scene_n_im)]
    lt = [_f32(getattr(lights, f)) for f in (
        "dir_l", "dir_color", "point_pos", "point_color", "spot_pos",
        "spot_dir", "spot_color", "spot_cos_in", "spot_cos_out")]
    hits = None
    if occ:
        hits = torch.stack([o.detach() for o in occ]).contiguous()
        if hits.dtype != torch.bool:
            raise TypeError("W4 takes bool shadow-ray answers")
    keep.extend([*tabs, tt, *const, *lt, hits])
    return Glossy(*(_p(x) for x in tabs), rows=tabs[0].shape[0],
                  tex=_textures(tt), ambient=_p(const[0]), scene_re=_p(const[1]),
                  scene_im=_p(const[2]), dir_l=_p(lt[0]), dir_color=_p(lt[1]),
                  n_dir=static.n_dir_lights, point_pos=_p(lt[2]),
                  point_color=_p(lt[3]), n_point=static.n_point_lights,
                  spot_pos=_p(lt[4]), spot_dir=_p(lt[5]), spot_color=_p(lt[6]),
                  spot_cos_in=_p(lt[7]), spot_cos_out=_p(lt[8]),
                  n_spot=static.n_spot_lights, occ=_p(hits), five=SCHLICK)


def prepare(mt, ctx, draws, packed, out, occ=None):
    """(entry, Rays, block struct, the tensors they point into) of W4's
    entry for material type mt on the bounce, writing into `out` (a
    Merged); the caller holds the tensors until the launch."""
    keep = []
    rays = _rays(ctx, packed, out, keep)
    if mt == MAT_DIFFUSE:
        block = _diffuse_args(ctx, draws[mt], keep)
    elif mt == MAT_REFRACTIVE:
        block = _refractive_args(ctx, draws[mt], keep)
    else:
        block = _glossy_args(ctx, occ, keep)
    return _BLOCKS[mt][0], rays, block, keep


def _launch(mt, ctx, draws, packed, out, occ=None, lib=None):
    """W4's entry for material type mt from `lib` on the bounce: writes
    the shaded fields of mt's rays into `out` (a Merged) in place.  Adds
    its launches to the type's wrapper."""
    if ctx.P.shape[0] == 0:
        return
    entry, rays, block, keep = prepare(mt, ctx, draws, packed, out, occ)
    _WRAPPER[mt].launches += _call(
        lib, entry, ctypes.byref(rays), ctypes.byref(block),
        cuda_build.stream_of(ctx.P.device), entries=ENTRIES)
    del keep


# ---------------------------------------------------------------------------
# autograd: the kernel forward, the plain block's backward
# ---------------------------------------------------------------------------

_CTX_FIELDS = ("D", "n_re", "n_im", "t", "P", "N", "uv", "eps")
_DATA_FIELDS = {
    MAT_DIFFUSE: (("mats", "diffuse_color"), ("mats", "diffuse_ambient_weight"),
                  ("is_center",), ("is_radius",), ("env_is_prob",),
                  ("env_is_pdf",)),
    MAT_REFRACTIVE: (("mats", "refr_n_re"), ("mats", "refr_n_im"),
                     ("mats", "refr_dispersive"), ("scene_n_re",),
                     ("scene_n_im",)),
    MAT_GLOSSY: tuple(("mats", f) for f in (
        "glossy_color", "glossy_diff", "glossy_roughness", "glossy_spec",
        "glossy_n_re", "glossy_n_im")) + (("ambient_color",), ("scene_n_re",),
                                          ("scene_n_im",))
    + tuple(("lights", f) for f in (
        "dir_l", "dir_color", "point_pos", "point_color", "spot_pos",
        "spot_dir", "spot_color", "spot_cos_in", "spot_cos_out")),
}
_PER_RAY = ("D", "n_re", "n_im", "depth", "diffuse_reflections", "t", "P",
            "N", "uv", "orient", "mat_slot", "obj_max_depth", "obj_mc", "eps",
            "pattern", "split_cnt", "strat_u")


def _inputs(mt, ctx):
    """The tensors the block's output is a function of, flat: ctx's, the
    block's data tables and the textures."""
    data = ctx.data
    tabs = [getattr(data, p[0]) if len(p) == 1 else getattr(getattr(data, p[0]), p[1])
            for p in _DATA_FIELDS[mt]]
    texs = list(data.textures) if mt != MAT_REFRACTIVE else []
    return [getattr(ctx, f) for f in _CTX_FIELDS] + tabs + texs


def _rebuild(mt, ctx, xs):
    """ctx with the tensors of `_inputs` replaced by xs."""
    nc, fields = len(_CTX_FIELDS), _DATA_FIELDS[mt]
    tabs, texs = xs[nc:nc + len(fields)], xs[nc + len(fields):]
    data = ctx.data
    top, sub = {}, {}
    for p, x in zip(fields, tabs):
        if len(p) == 1:
            top[p[0]] = x
        else:
            sub.setdefault(p[0], {})[p[1]] = x
    for k, v in sub.items():
        top[k] = dataclasses.replace(getattr(data, k), **v)
    if texs:
        top["textures"] = tuple(texs)
    return dataclasses.replace(ctx, data=dataclasses.replace(data, **top),
                               **dict(zip(_CTX_FIELDS, xs[:nc])))


class _Slot(int):
    """Where `_pack` put a tensor in its list."""


def _pack(x, saved):
    """x with every tensor in it (through dataclasses, tuples, lists and
    dicts) replaced by a _Slot, the tensor appended to `saved`."""
    if isinstance(x, torch.Tensor):
        saved.append(x)
        return _Slot(len(saved) - 1)
    return _walk(x, lambda v: _pack(v, saved))


def _unpack(x, saved):
    """x as `_pack` took it, its tensors from `saved`."""
    if isinstance(x, _Slot):
        return saved[x]
    return _walk(x, lambda v: _unpack(v, saved))


def _walk(x, f):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        new = {k.name: f(getattr(x, k.name)) for k in dataclasses.fields(x)}
        changed = {k: v for k, v in new.items() if v is not getattr(x, k)}
        return dataclasses.replace(x, **changed) if changed else x
    if isinstance(x, (tuple, list)):
        new = [f(v) for v in x]
        return type(x)(new) if any(a is not b for a, b in zip(new, x)) else x
    if isinstance(x, dict):
        return {k: f(v) for k, v in x.items()}
    return x


def pick_rays(call, idx):
    """A captured W4 call (type, ShadeCtx, draws, packed words, mask,
    merged output) on the rays idx (int64) of it, in that order: every
    per-ray tensor's rows idx, a medium every ray shares kept as the
    expand of its one row.  For tests and measurements that hold or time
    an entry on other orders and type patterns of a bounce's rays."""
    mt, ctx, draws, packed, m, acc = call
    n = packed.shape[0]

    def rows(x):
        if isinstance(x, torch.Tensor):
            if x.dim() == 0 or x.shape[0] != n:
                return x
            if x.stride(0) == 0:
                return x[:1].expand(idx.shape[0], *x.shape[1:])
            return x[idx]
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        return x

    ctx = dataclasses.replace(ctx, **{f: rows(getattr(ctx, f)) for f in _PER_RAY})
    acc = Merged(*(rows(getattr(acc, f)) for f in FLOAT_FIELDS + BOOL_FIELDS))
    return mt, ctx, rows(draws), rows(packed), rows(m), acc


def _first(x):
    """x's first ray: the first row of each tensor in it."""
    if isinstance(x, torch.Tensor):
        return x[:1]
    if isinstance(x, (tuple, list)):
        return type(x)(_first(v) for v in x)
    if isinstance(x, dict):
        return {k: _first(v) for k, v in x.items()}
    return x


def _meta(x):
    """x with every tensor in it on the meta device (shapes and dtypes, no
    data)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    return _walk(x, _meta)


def _flow(mt, ctx, draws, occ, flags):
    """The float fields of mt's plain block's output that depend on an
    input requiring grad (flags: one a tensor of `_inputs`): the block's
    own dataflow, read off its first ray on the meta device under
    autograd (nothing computed, nothing run on the rays' device); kept
    on the scene's static facts per block, flags and options."""
    key = (mt, flags, ctx.split_k, ctx.pattern is None, ctx.strat_u is None,
           occ is None)
    kept_flows = ctx.static.__dict__.setdefault("_w4_flow", {})
    if key not in kept_flows:
        c = _meta(dataclasses.replace(
            ctx, static=None, **{f: _first(getattr(ctx, f)) for f in _PER_RAY}))
        c = dataclasses.replace(c, static=ctx.static)
        # its own saved tensors: none for a checkpoint around it to count
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda x: x, lambda x: x):
            leaves = [x.requires_grad_(fl) if fl else x
                      for x, fl in zip(_inputs(mt, c), flags)]
            o = _plain(mt, _rebuild(mt, c, leaves), _meta(_first(draws)),
                       _meta(_first(occ)))
        kept_flows[key] = frozenset(f for f in FLOAT_FIELDS
                                    if getattr(o, f).requires_grad)
    return kept_flows[key]


def _plain(mt, ctx, draws, occ):
    if mt == MAT_DIFFUSE:
        return shade.shade_diffuse(ctx, *draws[mt])
    if mt == MAT_REFRACTIVE:
        return shade.shade_refractive(ctx, *draws[mt])
    return shade.shade_glossy(ctx, occ=occ)


class _Shade(torch.autograd.Function):
    """W4 forward into the merged output's float fields that the entry
    writes (`WRITTEN`), in place (xs: those fields, then the block's
    `_inputs`); a field that neither requires grad nor takes one from the
    block (`_flow`) is marked non-differentiable, as the plain merge
    leaves it.  Backward: a field's gradient passes where the block's
    rays are not (the merge's); where one of the block's inputs needs a
    gradient, the plain block is recomputed from the tensors saved for it
    and its vector-Jacobian product on the block's rays returned (see the
    module doc)."""

    @staticmethod
    def forward(fctx, call, *xs):
        mt, ctx, draws, packed, m, out, occ, lib, flow = call
        nw = len(WRITTEN[mt])
        keep = [x.requires_grad or f in flow for x, f in zip(xs, WRITTEN[mt])]
        _launch(mt, ctx, draws, packed, out, occ, lib)
        fctx.mark_dirty(*xs[:nw])
        fctx.mark_non_differentiable(*(x for x, k in zip(xs, keep) if not k))
        fctx.mt, saved = mt, [m]
        if any(fctx.needs_input_grad[1 + nw:]):
            # the scene's static facts hold no tensors: kept as they are
            fctx.static = ctx.static
            fctx.held = _pack((dataclasses.replace(ctx, static=None),
                               draws.get(mt), occ), saved)
        fctx.save_for_backward(*saved)
        return xs[:nw]

    @staticmethod
    def backward(fctx, *grads):
        saved, mt = fctx.saved_tensors, fctx.mt
        nw = len(WRITTEN[mt])
        m3, need = saved[0][..., None], fctx.needs_input_grad[1:]
        outs = [torch.where(m3, 0.0, g) if n and g is not None else None
                for g, n in zip(grads, need[:nw])]
        wants = need[nw:]
        if not any(wants):
            return (None, *outs, *([None] * len(wants)))
        ctx, d, occ = _unpack(fctx.held, saved)
        ctx = dataclasses.replace(ctx, static=fctx.static)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() if n else x
                      for x, n in zip(_inputs(mt, ctx), wants)]
            o = _plain(mt, _rebuild(mt, ctx, leaves), {mt: d}, occ)
            pairs = [(torch.where(m3, getattr(o, f), g), g)
                     for f, g in zip(WRITTEN[mt], grads)
                     if g is not None and getattr(o, f).requires_grad]
            wrt = [x for x, n in zip(leaves, wants) if n]
            got = (torch.autograd.grad([y for y, _ in pairs], wrt,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs else [None] * len(wrt))
        it = iter(got)
        return (None, *outs, *(next(it) if n else None for n in wants))


def _kernel_shade(mt, ctx, draws, packed, m, out, lib=None):
    """W4 on the bounce, from `lib`: the merged output `out` with mt's rays
    shaded in place; through `_Shade` where autograd records the block
    (grad enabled and a float field the entry writes or one of the
    block's `_inputs` requiring grad)."""
    occ = None
    if mt == MAT_GLOSSY:
        with torch.no_grad():
            nudged, rays = shade.light_rays(ctx)
            occ = shade.light_occlusion(ctx, nudged, rays)
    written = [getattr(out, f) for f in WRITTEN[mt]]
    xs = _inputs(mt, ctx)
    flags = tuple(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)
    if not torch.is_grad_enabled() or not (
            any(flags) or any(x.requires_grad for x in written)):
        _launch(mt, ctx, draws, packed, out, occ, lib)
        return out
    flow = _flow(mt, ctx, draws, occ, flags) if any(flags) else frozenset()
    res = _Shade.apply((mt, ctx, draws, packed, m, out, occ, lib, flow),
                       *written, *xs)
    return dataclasses.replace(out, **dict(zip(WRITTEN[mt], res)))


def _wrapper(mt, name, doc):
    def wrapper(ctx, draws, packed, m, out):
        if ctx.P.device.type == "cpu":
            return out.merge(_plain(mt, ctx, draws, None), m)
        return _kernel_shade(mt, ctx, draws, packed, m, out)
    wrapper.__name__, wrapper.__doc__, wrapper.launches = name, doc, 0
    return wrapper


shade_diffuse = _wrapper(MAT_DIFFUSE, "shade_diffuse", """The diffuse block
on the bounce (shade.py `shade_diffuse`): `out` with the diffuse rays (m)
shaded; W4 on CUDA tensors, the plain block and its merge on CPU
tensors.""")
shade_refractive = _wrapper(MAT_REFRACTIVE, "shade_refractive", """The
refractive block (shade.py `shade_refractive`), as `shade_diffuse`.""")
shade_glossy = _wrapper(MAT_GLOSSY, "shade_glossy", """The glossy block
(shade.py `shade_glossy`), as `shade_diffuse`; its shadow rays are cast
as the plain block casts them (W3 and W1 on the card).""")
# the wrapper whose count a launch of each type's entry adds to
_WRAPPER = {MAT_DIFFUSE: shade_diffuse, MAT_REFRACTIVE: shade_refractive,
            MAT_GLOSSY: shade_glossy}


INFO = ("registers", "local_bytes", "blocks_per_sm", "sms", "block",
        "min_blocks", "rays_per_pass")


def info(mt, lib=None, wide=False):
    """What W4's entry for material type mt was built to, read on the card
    (`shade_info`; wide: the diffuse entry's kernel for caps sums past
    registers): registers and local memory (bytes: spills and stack) a
    thread, resident blocks an SM, the SMs, threads a block, the
    __launch_bounds__ minimum of blocks an SM, and rays a block a pass (a
    queued entry's tile)."""
    fn = (lib or cuda_build.load_library()).shade_info
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], _I
    out = (_I * len(INFO))()
    err = fn(mt, int(wide), out)
    if err:
        raise RuntimeError(f"shade_info: CUDA error {err}")
    return dict(zip(INFO, out))


def caps_sum(x, wide=False, lib=None):
    """torch.sum(x, -1) of the (n, K) float32 rows x as the diffuse entry
    adds its caps pdf's terms on the card (`w4_caps_sum`): by the register
    sum of the plan torch's reduction makes for x (raises where that plan
    is past it: four values a load from K = 128), or, wide, by the general
    restatement of that plan.  For the holds against torch.sum."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError("caps_sum takes (n, K) float32 rows")
    x = x.contiguous()
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    _call(lib, "w4_caps_sum", x.data_ptr(), x.shape[0], x.shape[1], int(wide),
          out.data_ptr(), cuda_build.stream_of(x.device), entries=ENTRIES)
    return out


def trig_mismatches(device=None, lib=None):
    """The floats, of all 2^32, at which W4's restated sinf or cosf
    (csrc/wavefront_shade.cu `t_sincos`) differs from libdevice's on the
    card (`w4_trig_mismatches`; each function counted apart, NaN against
    NaN agreeing)."""
    device = torch.device(device or "cuda")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _call(lib, "w4_trig_mismatches", bad.data_ptr(), cuda_build.stream_of(device),
          entries=ENTRIES)
    return int(bad.item())


def launches():
    """W4's launches over its three wrappers."""
    return sum(w.launches for w in _WRAPPER.values())


def reset_launches():
    for w in _WRAPPER.values():
        w.launches = 0
