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
gradient and, where the block's own inputs need one, the block's
vector-Jacobian product: the gradient is the plain dispatch's.  Each
block's backward is a kernel of its own on CUDA tensors, one launch a
backward call, the plain VJP bit for bit: `refractive_vjp`
(csrc/wavefront_shade_bwd.cu `shade_refractive_bwd`), `diffuse_vjp`
(csrc/wavefront_diffuse_bwd.cu `shade_diffuse_bwd`), `glossy_vjp`
(csrc/wavefront_glossy_bwd.cu `shade_glossy_bwd`), a colour texture's
gradient included (the kernels write its taps' rows, `texture_grads`).
On CPU tensors without a backward library, the backward recomputes the
plain block under enable_grad for its VJP (`plain_shade_vjp`), a route
counted in `plain_routes`.

`_kernel_shade` and the `*_vjp` take `lib=` (and `_kernel_shade`
`bwd_lib=`): the tests pass the CPU stand-in's builds of the sources
(csrc/emu) with CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any

import torch

from ..core.compile import TexRef
from ..core.safemath import take_backward
from ..materials import shade
from ..materials.base import MAT_DIFFUSE, MAT_GLOSSY, MAT_REFRACTIVE
from . import cuda_build
from .mesh_sweep import _call, kept
from .plain_grad import plain_vjp

_V, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# W4's kernels by name, as a profile lists them, each with its entry's
# material type and its `info` variant: the diffuse entry's kernel of its
# caps sum in registers, by ATen's plan on one block, and, where ATen
# splits each row across blocks, the shading with the staged sums and the
# blocks' sums before it
KERNEL_INFO = {"shade_diffuse_kernel": (3, 0), "shade_diffuse_wide_kernel": (3, 1),
               "shade_diffuse_staged_kernel": (3, 2), "caps_partials_kernel": (3, 3),
               "shade_refractive_kernel": (4, 0), "shade_glossy_kernel": (2, 0)}
KERNELS = tuple(KERNEL_INFO)
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


class TapRows(ctypes.Structure):
    _fields_ = [("rows", _V), ("idx", _V)]


class Diffuse(ctypes.Structure):
    _fields_ = [("color", _V), ("ambient_w", _V), ("rows", _I),
                ("tex", Textures), ("u_mix", _V), ("u_phi", _V),
                ("u_r2", _V), ("s_mix", _V), ("s_phi", _V), ("s_r2", _V),
                ("pick", _V), ("is_center", _V), ("is_radius", _V),
                ("K", _I), ("env_prob", _V), ("env_alias", _V),
                ("env_pdf", _V), ("Hs", _I), ("Ws", _I), ("staging", _V)]


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
ENTRIES["w4_caps_sum"] = [_V, _L, _I, _I, _V, _V, _V, ctypes.POINTER(_I)]
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
    of its material type (ops/bounce_tail.py `bounce_start` starts it
    with the emissive and environment blocks, every other block merges
    into it), every field a contiguous tensor of its own, which W4 writes
    in place."""
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


def texture_tables(mats, table, refs, textures, tag="w4"):
    """(texels, desc_i, desc_f) of a block's image textures `refs`
    (SceneStatic.diffuse_tex / glossy_tex; W6's emissive and environment
    textures) over its slot table `table`:
    the textures they name, flattened into one (texels, 3) float32
    buffer; desc_i (slots, 4) int32 (offset in texels, H, W, flags: bit 0
    the slot fetches, bit 1 bilinear, the slot's last ref winning as in
    `shade._slot_color`); desc_f (slots, 2) float32 (W * repeat,
    H * repeat, rounded once from Python's product, as fetch_texture's
    scales).  None without refs.  Kept on `mats` while the textures and
    the table are the same tensors at the same version, under a name of
    `tag` and the refs."""
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

    name = f"_{tag}_tex_" + "_".join(f"{r.slot}.{r.tex}.{r.repeat}.{r.bilinear}"
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


def _staging(K, n, device, lib=None):
    """The staging buffer of the caps pdf's sums of n rays over K targets
    where torch.sum would split each row across blocks (`w4_sum_ctas` of
    `lib`: n ctas float32), else None."""
    if not K or not n:
        return None
    fn = (lib or cuda_build.load_library()).w4_sum_ctas
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_L, _L, ctypes.POINTER(_I)], _I
    ctas = _I(1)
    err = fn(K, n, ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"w4_sum_ctas: CUDA error {err}")
    return (torch.empty(n * ctas.value, dtype=torch.float32, device=device)
            if ctas.value > 1 else None)


def _diffuse_args(ctx, draws, keep, lib=None):
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
    staging = _staging(K, ctx.P.shape[0], ctx.P.device, lib)
    keep.extend([color, aw, *u, *s, pick, center, radius, *env, tt, staging])
    return Diffuse(color=_p(color), ambient_w=_p(aw), rows=color.shape[0],
                   tex=_textures(tt), u_mix=_p(u[0]), u_phi=_p(u[1]),
                   u_r2=_p(u[2]), s_mix=_p(s[0]), s_phi=_p(s[1]), s_r2=_p(s[2]),
                   pick=_p(pick), is_center=_p(center) if K else None,
                   is_radius=_p(radius) if K else None, K=K,
                   env_prob=_p(env[0]), env_alias=_p(env[1]), env_pdf=_p(env[2]),
                   Hs=Hs, Ws=Ws, staging=_p(staging))


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


def prepare(mt, ctx, draws, packed, out, occ=None, lib=None):
    """(entry, Rays, block struct, the tensors they point into) of W4's
    entry for material type mt from `lib` on the bounce, writing into
    `out` (a Merged); the caller holds the tensors until the launch."""
    keep = []
    rays = _rays(ctx, packed, out, keep)
    if mt == MAT_DIFFUSE:
        block = _diffuse_args(ctx, draws[mt], keep, lib)
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
    entry, rays, block, keep = prepare(mt, ctx, draws, packed, out, occ, lib)
    _WRAPPER[mt].launches += _call(
        lib, entry, ctypes.byref(rays), ctypes.byref(block),
        cuda_build.stream_of(ctx.P.device), entries=ENTRIES)
    del keep


# ---------------------------------------------------------------------------
# autograd: the kernel forward, the backward kernels or the plain block's
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

    def plain():
        c = _meta(dataclasses.replace(
            ctx, static=None, **{f: _first(getattr(ctx, f)) for f in _PER_RAY}))
        c = dataclasses.replace(c, static=ctx.static)
        leaves = [x.requires_grad_(fl) if fl else x
                  for x, fl in zip(_inputs(mt, c), flags)]
        return _plain(mt, _rebuild(mt, c, leaves), _meta(_first(draws)),
                      _meta(_first(occ)))

    return kept_flow(ctx.static, "_w4_flow", key, plain)


def kept_flow(static, name, key, plain):
    """The float fields of the Merged that plain() returns that require
    grad: plain() run once under autograd, on the meta device, with its own
    saved tensors kept as they are (none for a checkpoint around it to
    count); kept on the scene's static facts `static` in the dict `name`,
    under key."""
    kept_flows = static.__dict__.setdefault(name, {})
    if key not in kept_flows:
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda x: x, lambda x: x):
            o = plain()
        kept_flows[key] = frozenset(f for f in FLOAT_FIELDS
                                    if getattr(o, f).requires_grad)
    return kept_flows[key]


def _plain(mt, ctx, draws, occ):
    if mt == MAT_DIFFUSE:
        return shade.shade_diffuse(ctx, *draws[mt])
    if mt == MAT_REFRACTIVE:
        return shade.shade_refractive(ctx, *draws[mt])
    return shade.shade_glossy(ctx, occ=occ)


# ---------------------------------------------------------------------------
# the refractive block's backward kernel
# ---------------------------------------------------------------------------


class RefrBwd(ctypes.Structure):
    _fields_ = [("packed", _V), ("m", _V), ("P", _V), ("N", _V), ("D", _V),
                ("eps", _V), ("t", _V), ("orient", _V), ("n_re", _V), ("n_im", _V),
                ("re_step", _L), ("im_step", _L), ("depth", _V), ("pattern", _V),
                ("split_cnt", _V), ("u", _V), ("hero", _V), ("m_re", _V),
                ("m_im", _V), ("dispersive", _V), ("rows", _I), ("split_k", _I),
                ("scene_re", _V), ("scene_im", _V), ("k", _F * 3), ("n", _L),
                ("g", _V * 5), ("pass_", _V * 5), ("dD", _V), ("dn_re", _V),
                ("dn_im", _V), ("dt", _V), ("dP", _V), ("dN", _V), ("deps", _V),
                ("m_re_rows", _V), ("m_im_rows", _V), ("s_re_rows", _V),
                ("s_im_rows", _V)]


ENTRIES["shade_refractive_bwd"] = [ctypes.POINTER(RefrBwd), _V, ctypes.POINTER(_I)]

# the refractive block's `_inputs` by name, and the inputs each field it
# writes is a function of (the plain block's dataflow; uv and
# refr_dispersive take no gradient)
_REFR_INPUTS = _CTX_FIELDS + ("refr_n_re", "refr_n_im", "refr_dispersive",
                              "scene_n_re", "scene_n_im")
_REFR_FLOW = {
    "beta_mult": {"D", "N", "n_re", "n_im", "t", "refr_n_re", "refr_n_im",
                  "scene_n_re", "scene_n_im"},
    "new_origin": {"P", "N", "eps"},
    "new_dir": {"D", "N", "n_re", "refr_n_re", "scene_n_re"},
    "new_n_re": {"n_re", "refr_n_re", "scene_n_re"},
    "new_n_im": {"n_im", "refr_n_im", "scene_n_im"}}
# the per-ray rows the kernel writes of each table's gradient: the gathered
# tables' (core/safemath.py `take`) and the scene medium's (a broadcast)
_REFR_ROWS = {"refr_n_re": "m_re_rows", "refr_n_im": "m_im_rows",
              "scene_n_re": "s_re_rows", "scene_n_im": "s_im_rows"}


@dataclass
class RefrSaved:
    """What the refractive backward kernel reads of a call: the block's
    mask, the rays' words and state, its draws, the slots (the gathers'
    index) and its tables (`_REFR_SAVED`, None where the scene has no
    split or no dispersion), the split levels and 2 pi / lambda."""
    m: Any
    packed: Any
    P: Any
    N: Any
    D: Any
    eps: Any
    t: Any
    orient: Any
    n_re: Any
    n_im: Any
    depth: Any
    pattern: Any
    split_cnt: Any
    u: Any
    hero: Any
    mat_slot: Any
    m_re: Any
    m_im: Any
    dispersive: Any
    scene_re: Any
    scene_im: Any
    split_k: int
    k: tuple


# RefrSaved's tensors, which `_Shade` saves for the backward
_REFR_SAVED = tuple(f.name for f in dataclasses.fields(RefrSaved))[:-2]


def refr_saved(ctx, draws, packed, m):
    """The RefrSaved of a refractive call on the bounce."""
    u, hero = draws[MAT_REFRACTIVE]
    mats, data = ctx.data.mats, ctx.data
    split = ctx.split_k > 0 and ctx.pattern is not None
    disp = ctx.static.has_dispersion
    return RefrSaved(
        m=m, packed=packed, P=ctx.P, N=ctx.N, D=ctx.D, eps=ctx.eps, t=ctx.t,
        orient=ctx.orient, n_re=ctx.n_re, n_im=ctx.n_im, depth=ctx.depth,
        pattern=ctx.pattern if split else None,
        split_cnt=ctx.split_cnt if split else None, u=u,
        hero=hero if disp else None, mat_slot=ctx.mat_slot, m_re=mats.refr_n_re,
        m_im=mats.refr_n_im, dispersive=mats.refr_dispersive if disp else None,
        scene_re=data.scene_n_re, scene_im=data.scene_n_im,
        split_k=int(ctx.split_k) if split else 0, k=tuple(beer_k(tuple(ctx.wavelengths))))


def _refractive_rows(grads, saved, wants, lib=None):
    """W4's backward kernel (`lib`; csrc/wavefront_shade_bwd.cu
    `shade_refractive_bwd`), one launch, on the arguments of
    `refractive_vjp` (grads not all None): (the fields' pass-through
    gradients, {input: its gradient} of the rays' inputs the kernel
    writes, {table input: its per-ray rows}).  Adds its launches to
    `_refractive_rows.launches`."""
    fields = WRITTEN[MAT_REFRACTIVE]
    nw = len(fields)
    reach = set().union(*(_REFR_FLOW[f] for f, g in zip(fields, grads)
                          if g is not None))
    want = [w and x in reach for x, w in zip(_REFR_INPUTS, wants[nw:])]
    s = saved
    n, dev = s.P.shape[0], s.P.device
    f32 = lambda *shape: torch.empty((n, *shape), dtype=torch.float32, device=dev)
    passes = [f32(3) if w and g is not None else None
              for w, g in zip(wants[:nw], grads)]
    out = {x: f32(*(() if x in ("t", "eps") else (3,)))
           for x, w in zip(_REFR_INPUTS, want) if w and x in _CTX_FIELDS}
    rows = {x: f32(3) for x, w in zip(_REFR_INPUTS, want) if w and x in _REFR_ROWS}
    if n and (out or rows or any(x is not None for x in passes)):
        if s.m.dtype != torch.bool:
            raise TypeError("W4's backward takes a bool mask")
        ins = dict(packed=_i32(s.packed), m=s.m.contiguous(), P=_f32(s.P),
                   N=_f32(s.N), D=_f32(s.D), eps=_f32(s.eps), t=_f32(s.t),
                   orient=_f32(s.orient), depth=_i32(s.depth), u=_f32(s.u),
                   m_re=_f32(s.m_re), m_im=_f32(s.m_im), scene_re=_f32(s.scene_re),
                   scene_im=_f32(s.scene_im))
        if s.split_k:
            ins.update(pattern=_i32(s.pattern), split_cnt=_i32(s.split_cnt))
        if s.hero is not None:
            if s.hero.dtype != torch.int64:
                raise TypeError("W4's dispersive backward takes an int64 hero channel")
            ins.update(hero=s.hero.contiguous(), dispersive=_f32(s.dispersive))
        n_re, re_step = _medium(s.n_re)
        n_im, im_step = _medium(s.n_im)
        ins.update(n_re=n_re, n_im=n_im)
        gs = [None if g is None else _f32(g) for g in grads]
        for name, x in [*ins.items(), *(("grad", g) for g in gs if g is not None)]:
            if x.device != dev:
                raise ValueError(f"W4's backward: {name} is on {x.device}, the rays on {dev}")
        struct = RefrBwd(**{k: v.data_ptr() for k, v in ins.items()}, re_step=re_step,
                         im_step=im_step, rows=s.m_re.shape[0], split_k=s.split_k,
                         k=(_F * 3)(*s.k), n=n, g=(_V * 5)(*(_p(g) for g in gs)),
                         pass_=(_V * 5)(*(_p(x) for x in passes)),
                         **{f"d{x}": t.data_ptr() for x, t in out.items()},
                         **{_REFR_ROWS[x]: t.data_ptr() for x, t in rows.items()})
        _refractive_rows.launches += _call(
            lib, "shade_refractive_bwd", ctypes.byref(struct), cuda_build.stream_of(dev),
            entries=ENTRIES)
    return passes, out, rows


_refractive_rows.launches = 0


def refractive_vjp(grads, saved, wants, lib=None):
    """The refractive block's backward from W4's backward kernel
    (`_refractive_rows`): from the gradients of the five fields the entry
    writes (grads, one a WRITTEN[MAT_REFRACTIVE]; None where none comes)
    and the RefrSaved `saved`, the gradients `_Shade`'s backward returns
    (wants: its needs_input_grad past the call): the fields' pass-through
    gradients, then those of the block's `_inputs`, None where not wanted
    or not reached, as `plain_shade_vjp` gives them, bit for bit.  The
    gathered tables' gradients are core/safemath.py `take_backward`'s
    scans of the kernel's per-ray rows, the scene medium's torch.sum of
    its rows over the rays (autograd's sum_to of a broadcast)."""
    if all(g is None for g in grads):
        return [None] * len(wants)
    passes, out, rows = _refractive_rows(grads, saved, wants, lib)
    s = saved
    res = []
    for x in _REFR_INPUTS:
        if x in out:
            res.append(out[x])
        elif x in rows and x.startswith("refr"):
            table = s.m_re if x == "refr_n_re" else s.m_im
            res.append(take_backward(shade.slot_rows(s.mat_slot, table), rows[x], table.shape))
        elif x in rows:
            medium = s.scene_re if x == "scene_n_re" else s.scene_im
            res.append(torch.sum(rows[x], 0, keepdim=True).reshape(medium.shape))
        else:
            res.append(None)
    return [*passes, *res]


# ---------------------------------------------------------------------------
# the diffuse block's backward kernel
# ---------------------------------------------------------------------------


class DiffBwd(ctypes.Structure):
    _fields_ = [("packed", _V), ("m", _V), ("P", _V), ("N", _V), ("eps", _V), ("uv", _V),
                ("diffuse_refl", _V), ("u_mix", _V), ("u_phi", _V), ("u_r2", _V),
                ("s_mix", _V), ("s_phi", _V), ("s_r2", _V), ("pick", _V), ("color", _V),
                ("ambient_w", _V), ("rows", _I), ("refs", _I), ("ref_slot", _V),
                ("ref_tex", Textures), ("is_center", _V), ("is_radius", _V), ("K", _I),
                ("env_prob", _V), ("env_alias", _V), ("env_pdf", _V), ("Hs", _I),
                ("Ws", _I), ("n", _L), ("g", _V * 3), ("pass_", _V * 3), ("dP", _V),
                ("dN", _V), ("deps", _V), ("duv", _V), ("color_rows", _V),
                ("w_rows", _V), ("prob_rows", _V), ("pdf_rows", _V), ("cen_pdf", _V),
                ("rad_pdf", _V), ("cen_smp", _V), ("rad_smp", _V), ("prob_idx", _V),
                ("pdf_idx", _V), ("opdf_rows", _V), ("osmp_rows", _V), ("outer_rows", _I),
                ("taps", TapRows)]


ENTRIES["shade_diffuse_bwd"] = [ctypes.POINTER(DiffBwd), _V, ctypes.POINTER(_I)]


def _outer_rows(K, n, lib=None):
    """Whether the engine's sum_to over K of an (n, K, 3) gradient splits
    each output across blocks on the device (`lib`'s
    `shade_diffuse_bwd_outer`; thousands of caps): the diffuse backward then
    leaves the nudged origin's sums over the caps to `_diffuse_rows`."""
    fn = (lib or cuda_build.load_library()).shade_diffuse_bwd_outer
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_L, _L, ctypes.POINTER(_I)], _I
    rows = _I(0)
    err = fn(K, n, ctypes.byref(rows))
    if err:
        raise RuntimeError(f"shade_diffuse_bwd_outer: CUDA error {err}")
    return bool(rows.value)

_DIFF_INPUTS = _CTX_FIELDS + ("diffuse_color", "diffuse_ambient_weight", "is_center",
                              "is_radius", "env_is_prob", "env_is_pdf")


def ref_tables(data, static, mt):
    """{"slot": (refs,) int32 each image-texture ref's slot, "tex": its
    (texels, desc_i, desc_f) a row a ref} of the diffuse or glossy block's
    colour textures (SceneStatic.diffuse_tex / glossy_tex, in order), as
    the backward kernels read `_slot_color`'s wheres; None without refs.
    Kept on the material tables."""
    refs = static.diffuse_tex if mt == MAT_DIFFUSE else static.glossy_tex
    if not refs:
        return None
    mats = data.mats
    table = mats.diffuse_color if mt == MAT_DIFFUSE else mats.glossy_color
    tag = f"w4_bwd_{_BLOCKS[mt][0]}"

    def make():
        slot = torch.tensor([r.slot for r in refs], dtype=torch.int32, device=table.device)
        return {"slot": slot, "tex": texture_tables(
            mats, slot, [TexRef(i, r.tex, r.repeat, r.bilinear) for i, r in enumerate(refs)],
            data.textures, tag)}

    used = sorted({r.tex for r in refs})
    return kept(mats, f"_{tag}_refs_" + "_".join(f"{r.slot}.{r.tex}.{r.repeat}.{r.bilinear}"
                                                for r in refs),
                (table, *(data.textures[k] for k in used)), make)


def tex_refs(textures, refs):
    """Each image-texture ref of `refs` (a block's, in order) as the tap
    rows' reduction reads it: (texture index, bilinear, the texture's
    shape)."""
    return tuple((r.tex, bool(r.bilinear), tuple(textures[r.tex].shape)) for r in refs)


def tap_buffers(refs, wanted, n, device):
    """(rows, idx) the backward kernels write a block's texel taps into
    (csrc/texture_fetch.cuh `tap_rows`): (planes, n, 3) float32 and
    (planes, n) int64, a plane a tap of each ref (four a bilinear ref, one
    a nearest), refs in order; (None, None) where no texture of `wanted`
    (indices) is one a ref of `refs` (`tex_refs`) reads."""
    if not any(r[0] in wanted for r in refs):
        return None, None
    planes = sum(4 if r[1] else 1 for r in refs)
    return (torch.empty((planes, n, 3), dtype=torch.float32, device=device),
            torch.empty((planes, n), dtype=torch.int64, device=device))


def texture_grads(refs, rows, idx, wanted, order=None):
    """{texture index: its gradient} of the textures of `wanted` from the
    tap rows of `tap_buffers`: each tap's core/safemath.py `take_backward`
    scan, summed as the engine sums them.  The engine runs a fetch's taps
    last first (the sum's last term is the node created last), each into
    the buffer of that fetch's flat view of the texture, the first stored
    as it is; then the fetches' views into the texture's buffer in the
    order they run: `order`, the refs' indices (`refs` in order; default
    `_slot_color`'s wheres, the last ref first)."""
    at, first = 0, []
    for r in refs:
        first.append(at)
        at += 4 if r[1] else 1
    out = {}
    for k in (reversed(range(len(refs))) if order is None else order):
        tex, bilinear, shape = refs[k]
        if tex not in wanted:
            continue
        flat = (math.prod(shape[:-1]), shape[-1])
        view = None
        for p in reversed(range(first[k], first[k] + (4 if bilinear else 1))):
            g = take_backward(idx[p], rows[p], flat)
            view = g if view is None else view + g
        view = view.reshape(shape)
        out[tex] = view if tex not in out else out[tex] + view
    return out


def _wanted_textures(wants, refs):
    """The indices of the textures a block's refs read whose gradient is
    wanted (wants: `_Shade`'s past the fields and the block's other
    inputs, one a texture)."""
    return {r[0] for r in refs if wants[r[0]]}


@dataclass
class DiffSaved:
    """What the diffuse backward kernel reads of a call: the block's mask,
    the rays' words and state, its draws, the slots (the gathers' index),
    its tables (`_DIFF_SAVED`; None where the scene has no caps, no
    environment sampling or no stratified draws) and its colour textures'
    refs (`ref_tables`), the environment's grid and whether a ref is
    bilinear."""
    m: Any
    packed: Any
    P: Any
    N: Any
    eps: Any
    uv: Any
    diffuse_refl: Any
    u_mix: Any
    u_phi: Any
    u_r2: Any
    s_mix: Any
    s_phi: Any
    s_r2: Any
    pick: Any
    mat_slot: Any
    color: Any
    ambient_w: Any
    is_center: Any
    is_radius: Any
    env_prob: Any
    env_alias: Any
    env_pdf: Any
    ref_slot: Any
    ref_texels: Any
    ref_desc_i: Any
    ref_desc_f: Any
    hw: tuple
    bilinear: bool
    refs: tuple = ()


_DIFF_SAVED = tuple(f.name for f in dataclasses.fields(DiffSaved))[:-3]


def diff_saved(ctx, draws, packed, m):
    """The DiffSaved of a diffuse call on the bounce."""
    data, static, mats = ctx.data, ctx.static, ctx.data.mats
    (u_mix, u_phi, u_r2), pick = draws[MAT_DIFFUSE]
    s = ctx.strat_u if ctx.strat_u is not None else (None, None, None)
    K, hw = static.n_is_targets, tuple(static.env_is_shape)
    env = hw != (0, 0)
    refs = ref_tables(data, static, MAT_DIFFUSE)
    tex = refs["tex"] if refs else (None, None, None)
    return DiffSaved(
        m=m, packed=packed, P=ctx.P, N=ctx.N, eps=ctx.eps, uv=ctx.uv,
        diffuse_refl=ctx.diffuse_reflections, u_mix=u_mix, u_phi=u_phi, u_r2=u_r2,
        s_mix=s[0], s_phi=s[1], s_r2=s[2], pick=pick if K else None,
        mat_slot=ctx.mat_slot, color=mats.diffuse_color,
        ambient_w=mats.diffuse_ambient_weight,
        is_center=data.is_center if K else None, is_radius=data.is_radius if K else None,
        env_prob=data.env_is_prob if env else None,
        env_alias=data.env_is_alias if env else None,
        env_pdf=data.env_is_pdf if env else None,
        ref_slot=refs["slot"] if refs else None, ref_texels=tex[0], ref_desc_i=tex[1],
        ref_desc_f=tex[2], hw=hw, bilinear=any(r.bilinear for r in static.diffuse_tex),
        refs=tex_refs(data.textures, static.diffuse_tex))


def _diffuse_rows(grads, saved, wants, lib=None):
    """W4's diffuse backward kernel (`lib`; csrc/wavefront_diffuse_bwd.cu
    `shade_diffuse_bwd`), one launch, on the arguments of `diffuse_vjp`
    (grads not all None): (the fields' pass-through gradients, {input: its
    gradient} of the rays' inputs the kernel writes, {table input: its
    rows}: a gathered table's (per-ray rows, their index), the caps'
    [(ray, cap) rows of the pdf's geometry or None, those of the sample's
    or None]).  Adds its launches to `_diffuse_rows.launches`."""
    s = saved
    nw = len(WRITTEN[MAT_DIFFUSE])
    gb, go, gd = (g is not None for g in grads)
    caps, env = s.is_center is not None, s.env_prob is not None
    reach = {"P": go or ((gb or gd) and caps), "eps": go or ((gb or gd) and caps),
             "N": True, "uv": gb and s.bilinear, "diffuse_color": gb,
             "diffuse_ambient_weight": gb and (caps or env),
             "is_center": (gb or gd) and caps, "is_radius": (gb or gd) and caps,
             "env_is_prob": (gb or gd) and env, "env_is_pdf": gb and env}
    want = {x: w and reach.get(x, False) for x, w in zip(_DIFF_INPUTS, wants[nw:])}
    n, dev = s.P.shape[0], s.P.device
    K = s.is_center.shape[0] if caps else 0
    f32 = lambda *shape: torch.empty((n, *shape), dtype=torch.float32, device=dev)
    i64 = lambda: torch.empty((n,), dtype=torch.int64, device=dev)
    passes = [f32(3) if w and g is not None else None
              for w, g in zip(wants[:nw], grads)]
    out = {x: f32(*{"eps": (), "uv": (2,)}.get(x, (3,)))
           for x in ("P", "N", "eps", "uv") if want[x]}
    rows = {}
    if want["diffuse_color"]:
        rows["diffuse_color"] = f32(3)
    if want["diffuse_ambient_weight"]:
        rows["diffuse_ambient_weight"] = f32()
    if want["env_is_prob"]:
        rows["env_is_prob"] = (f32(), i64())
    if want["env_is_pdf"]:
        rows["env_is_pdf"] = (f32(), i64())
    if want["is_center"]:
        rows["is_center"] = [f32(K, 3) if gb else None, f32(K, 3)]
    if want["is_radius"]:
        rows["is_radius"] = [f32(K) if gb else None, f32(K)]
    wanted = _wanted_textures(wants[nw + len(_DIFF_INPUTS):], s.refs) if gb else set()
    taps = tap_buffers(s.refs, wanted, n, dev)
    if taps[0] is not None:
        rows["textures"] = (*taps, wanted)
    # where the sums over the caps split across blocks, the origin's shares
    # as rows, summed below by ATen's own op
    outer = (caps and (gb or gd) and bool(out or rows) and n > 0
             and _outer_rows(K, n, lib))
    orows = [f32(K, 3) if gb else None, f32(K, 3)] if outer else [None, None]
    if outer:
        dN = out.pop("N", None)
        part = f32(3)
        out_kernel = {x: t for x, t in out.items() if x not in ("P", "eps")}
        out_kernel["N"] = part
    else:
        out_kernel = out
    if n and (out or rows or any(x is not None for x in passes)):
        if s.m.dtype != torch.bool:
            raise TypeError("W4's backward takes a bool mask")
        if caps and (s.pick is None or s.pick.dtype != torch.int64):
            raise TypeError("W4's caps backward takes an int64 pick")
        ins = dict(packed=_i32(s.packed), m=s.m.contiguous(), P=_f32(s.P), N=_f32(s.N),
                   eps=_f32(s.eps), uv=_f32(s.uv), diffuse_refl=_i32(s.diffuse_refl),
                   u_mix=_f32(s.u_mix), u_phi=_f32(s.u_phi), u_r2=_f32(s.u_r2),
                   color=_f32(s.color))
        if s.s_mix is not None:
            ins.update(s_mix=_f32(s.s_mix), s_phi=_f32(s.s_phi), s_r2=_f32(s.s_r2))
        if caps or env:
            ins.update(ambient_w=_f32(s.ambient_w))
        if caps:
            ins.update(pick=s.pick.contiguous(), is_center=_f32(s.is_center),
                       is_radius=_f32(s.is_radius))
        if env:
            ins.update(env_prob=_f32(s.env_prob),
                       env_alias=s.env_alias.to(torch.int32).contiguous(),
                       env_pdf=_f32(s.env_pdf))
        tex = {}
        if s.ref_slot is not None:
            tex = dict(ref_slot=s.ref_slot.contiguous(), texels=s.ref_texels,
                       desc_i=s.ref_desc_i, desc_f=s.ref_desc_f)
        gs = [None if g is None else _f32(g) for g in grads]
        for name, x in [*ins.items(), *tex.items(), *(("grad", g) for g in gs if g is not None)]:
            if x.device != dev:
                raise ValueError(f"W4's backward: {name} is on {x.device}, the rays on {dev}")
        pair = lambda x: (None, None) if x is None else (_p(x[0]), _p(x[1]))
        two = lambda x, k: None if x is None else _p(x[k])
        prob, pdf = pair(rows.get("env_is_prob")), pair(rows.get("env_is_pdf"))
        struct = DiffBwd(
            **{k: v.data_ptr() for k, v in ins.items()}, rows=s.color.shape[0],
            refs=0 if s.ref_slot is None else s.ref_slot.shape[0],
            ref_slot=_p(tex.get("ref_slot")),
            ref_tex=Textures(_p(tex.get("texels")), _p(tex.get("desc_i")),
                             _p(tex.get("desc_f"))),
            K=K, Hs=s.hw[0], Ws=s.hw[1], n=n, g=(_V * 3)(*(_p(g) for g in gs)),
            pass_=(_V * 3)(*(_p(x) for x in passes)),
            **{f"d{x}": t.data_ptr() for x, t in out_kernel.items()},
            color_rows=_p(rows.get("diffuse_color")),
            w_rows=_p(rows.get("diffuse_ambient_weight")), prob_rows=prob[0],
            prob_idx=prob[1], pdf_rows=pdf[0], pdf_idx=pdf[1],
            cen_pdf=two(rows.get("is_center"), 0), cen_smp=two(rows.get("is_center"), 1),
            rad_pdf=two(rows.get("is_radius"), 0), rad_smp=two(rows.get("is_radius"), 1),
            opdf_rows=_p(orows[0]), osmp_rows=_p(orows[1]), outer_rows=int(outer),
            taps=TapRows(*(_p(x) for x in taps)))
        _diffuse_rows.launches += _call(
            lib, "shade_diffuse_bwd", ctypes.byref(struct), cuda_build.stream_of(dev),
            entries=ENTRIES)
    if outer:
        # nudged = P + N eps: its buffer (new_origin's, the caps pdf's share,
        # the sample's), each share the engine's sum_to over K of the rows
        parts = ([torch.where(s.m[:, None], _f32(grads[1]), 0.0)] if go else []) + [
            r.sum_to_size(n, 1, 3).reshape(n, 3) for r in orows if r is not None]
        bo = parts[0]
        for x in parts[1:]:
            bo = bo + x
        if "P" in out:
            out["P"] = bo
        if "eps" in out:
            out["eps"] = (bo * _f32(s.N)).sum_to_size(n, 1).reshape(n)
        if dN is not None:
            out["N"] = part + bo * _f32(s.eps)[:, None]
    return passes, out, rows


_diffuse_rows.launches = 0


def diffuse_vjp(grads, saved, wants, lib=None):
    """The diffuse block's backward from W4's backward kernel
    (`_diffuse_rows`): from the gradients of the three fields the entry
    writes (grads, one a WRITTEN[MAT_DIFFUSE]; None where none comes) and
    the DiffSaved `saved`, the gradients `_Shade`'s backward returns
    (wants: its needs_input_grad past the call): the fields' pass-through
    gradients, then those of the block's `_inputs`, as `plain_shade_vjp`
    gives them, bit for bit.  The gathered tables' gradients are
    core/safemath.py `take_backward`'s scans of the kernel's per-ray rows,
    the colour textures' those of its taps' rows (`texture_grads`);
    is_center's and is_radius's the engine's sum_to over the rays of the
    caps pdf's (ray, cap) rows, plus that of the caps sample's."""
    if all(g is None for g in grads):
        return [None] * len(wants)
    passes, out, rows = _diffuse_rows(grads, saved, wants, lib)
    s = saved
    res = []
    for x in _DIFF_INPUTS:
        if x in out:
            res.append(out[x])
        elif x in ("diffuse_color", "diffuse_ambient_weight") and x in rows:
            table = s.color if x == "diffuse_color" else s.ambient_w
            res.append(take_backward(shade.slot_rows(s.mat_slot, table), rows[x], table.shape))
        elif x in ("env_is_prob", "env_is_pdf") and x in rows:
            table = s.env_prob if x == "env_is_prob" else s.env_pdf
            res.append(take_backward(rows[x][1], rows[x][0], table.shape))
        elif x in rows:
            table = s.is_center if x == "is_center" else s.is_radius
            parts = [r.sum_to_size(table.shape) for r in rows[x] if r is not None]
            res.append(parts[0] if len(parts) == 1 else parts[0] + parts[1])
        else:
            res.append(None)
    return [*passes, *res, *_texture_results(s.refs, rows.get("textures"),
                                             len(wants) - len(passes) - len(res))]


def _texture_results(refs, taps, k):
    """The gradients of the k textures `_inputs` ends with: None but where
    the kernel wrote taps (rows, idx, the wanted textures) for a wanted
    one (`texture_grads`)."""
    got = texture_grads(refs, *taps) if taps is not None else {}
    return [got.get(t) for t in range(k)]


# ---------------------------------------------------------------------------
# the glossy block's backward kernel
# ---------------------------------------------------------------------------


class GlossBwd(ctypes.Structure):
    _fields_ = [("packed", _V), ("m", _V), ("P", _V), ("N", _V), ("D", _V), ("eps", _V),
                ("uv", _V), ("n_re", _V), ("n_im", _V), ("re_step", _L), ("im_step", _L),
                ("color", _V), ("diff", _V), ("rough", _V), ("spec", _V), ("m_re", _V),
                ("m_im", _V), ("rows", _I), ("refs", _I), ("ref_slot", _V),
                ("ref_tex", Textures), ("ambient", _V), ("scene_re", _V),
                ("scene_im", _V), ("dir_l", _V), ("dir_color", _V), ("n_dir", _I),
                ("point_pos", _V), ("point_color", _V), ("n_point", _I),
                ("spot_pos", _V), ("spot_dir", _V), ("spot_color", _V),
                ("spot_cos_in", _V), ("spot_cos_out", _V), ("n_spot", _I), ("occ", _V),
                ("five", _F), ("n", _L), ("g", _V * 4), ("pass_", _V * 4), ("dD", _V),
                ("dn_re", _V), ("dn_im", _V), ("dP", _V), ("dN", _V), ("duv", _V),
                ("deps", _V), ("color_rows", _V), ("m_re_rows", _V), ("m_im_rows", _V),
                ("diff_rows", _V), ("rough_rows", _V), ("spec_rows", _V),
                ("amb_rows", _V), ("sre_add", _V), ("sre_sub", _V), ("sim_add", _V),
                ("sim_sub", _V), ("lc_rows", _V), ("lp_rows", _V), ("sd_rows", _V),
                ("cci_rows", _V), ("nco_rows", _V), ("taps", TapRows)]


ENTRIES["shade_glossy_bwd"] = [ctypes.POINTER(GlossBwd), _V, ctypes.POINTER(_I)]

_GLOSS_TABLES = ("glossy_color", "glossy_diff", "glossy_roughness", "glossy_spec",
                 "glossy_n_re", "glossy_n_im")
_LIGHT_TABLES = ("dir_l", "dir_color", "point_pos", "point_color", "spot_pos",
                 "spot_dir", "spot_color", "spot_cos_in", "spot_cos_out")
_GLOSS_INPUTS = (_CTX_FIELDS + _GLOSS_TABLES + ("ambient_color", "scene_n_re", "scene_n_im")
                 + _LIGHT_TABLES)
# the glossy `_inputs` each written field is a function of, past the lights'
# tables and the colour's uv (`glossy_vjp`)
_GLOSS_FLOW = {
    "add": {"D", "n_re", "n_im", "N", *_GLOSS_TABLES, "ambient_color"},
    "beta_mult": {"D", "N", "glossy_n_re", "glossy_n_im", "scene_n_re", "scene_n_im"},
    "new_origin": {"P", "N", "eps"},
    "new_dir": {"D", "N"}}


@dataclass
class GlossSaved:
    """What the glossy backward kernel reads of a call: the block's mask,
    the rays' words and state, the slots, its tables, the lights', the
    shadow rays' answers ((lights, N) bool, None where no object casts a
    shadow) and its colour textures' refs (`ref_tables`), the lights of
    each kind and whether a ref is bilinear."""
    m: Any
    packed: Any
    P: Any
    N: Any
    D: Any
    eps: Any
    uv: Any
    n_re: Any
    n_im: Any
    mat_slot: Any
    color: Any
    diff: Any
    rough: Any
    spec: Any
    m_re: Any
    m_im: Any
    ambient: Any
    scene_re: Any
    scene_im: Any
    dir_l: Any
    dir_color: Any
    point_pos: Any
    point_color: Any
    spot_pos: Any
    spot_dir: Any
    spot_color: Any
    spot_cos_in: Any
    spot_cos_out: Any
    occ: Any
    ref_slot: Any
    ref_texels: Any
    ref_desc_i: Any
    ref_desc_f: Any
    kinds: tuple
    bilinear: bool
    refs: tuple = ()


_GLOSS_SAVED = tuple(f.name for f in dataclasses.fields(GlossSaved))[:-3]


def gloss_saved(ctx, draws, packed, m, occ):
    """The GlossSaved of a glossy call on the bounce (occ: the lights'
    shadow-ray answers, `shade.light_occlusion`'s)."""
    del draws
    data, static, mats, lights = ctx.data, ctx.static, ctx.data.mats, ctx.data.lights
    refs = ref_tables(data, static, MAT_GLOSSY)
    tex = refs["tex"] if refs else (None, None, None)
    hits = None
    if occ:
        hits = torch.stack([o.detach() for o in occ]).contiguous()
    return GlossSaved(
        m=m, packed=packed, P=ctx.P, N=ctx.N, D=ctx.D, eps=ctx.eps, uv=ctx.uv,
        n_re=ctx.n_re, n_im=ctx.n_im, mat_slot=ctx.mat_slot, color=mats.glossy_color,
        diff=mats.glossy_diff, rough=mats.glossy_roughness, spec=mats.glossy_spec,
        m_re=mats.glossy_n_re, m_im=mats.glossy_n_im, ambient=data.ambient_color,
        scene_re=data.scene_n_re, scene_im=data.scene_n_im,
        **{f: getattr(lights, f) for f in _LIGHT_TABLES}, occ=hits,
        ref_slot=refs["slot"] if refs else None, ref_texels=tex[0], ref_desc_i=tex[1],
        ref_desc_f=tex[2],
        kinds=(static.n_dir_lights, static.n_point_lights, static.n_spot_lights),
        bilinear=any(r.bilinear for r in static.glossy_tex),
        refs=tex_refs(data.textures, static.glossy_tex))


def _glossy_rows(grads, saved, wants, lib=None):
    """W4's glossy backward kernel (`lib`; csrc/wavefront_glossy_bwd.cu
    `shade_glossy_bwd`), one launch, on the arguments of `glossy_vjp`
    (grads not all None): (the fields' pass-through gradients, {input: its
    gradient} of the rays' inputs the kernel writes, {table input: its
    rows}).  Adds its launches to `_glossy_rows.launches`."""
    s = saved
    nw = len(WRITTEN[MAT_GLOSSY])
    fields = WRITTEN[MAT_GLOSSY]
    ga = grads[0] is not None
    nd, np_, ns = s.kinds
    reach = set().union(*(_GLOSS_FLOW[f] for f, g in zip(fields, grads) if g is not None))
    if ga:
        if s.bilinear:
            reach.add("uv")
        if np_ + ns:
            reach.add("P")
        reach.update(x for x, k in (("dir_l", nd), ("dir_color", nd), ("point_pos", np_),
                                    ("point_color", np_), ("spot_pos", ns),
                                    ("spot_dir", ns), ("spot_color", ns),
                                    ("spot_cos_in", ns), ("spot_cos_out", ns)) if k)
    want = {x: w and x in reach for x, w in zip(_GLOSS_INPUTS, wants[nw:])}
    n, dev = s.P.shape[0], s.P.device
    nl = nd + np_ + ns
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    passes = [f32(n, 3) if w and g is not None else None for w, g in zip(wants[:nw], grads)]
    out = {x: f32(n, *{"eps": (), "uv": (2,)}.get(x, (3,)))
           for x in ("D", "n_re", "n_im", "P", "N", "uv", "eps") if want[x]}
    rows = {}
    for x, shape in (("glossy_color", (3,)), ("glossy_diff", ()), ("glossy_roughness", ()),
                     ("glossy_spec", ()), ("glossy_n_re", (3,)), ("glossy_n_im", (3,)),
                     ("ambient_color", (3,))):
        if want[x]:
            rows[x] = f32(n, *shape)
    for x in ("scene_n_re", "scene_n_im"):
        if want[x]:
            rows[x] = (f32(n, 3), f32(n, 3))
    light_rows = {}
    if any(want[x] for x in ("dir_color", "point_color", "spot_color")):
        light_rows["lc"] = f32(nl, n, 3)
    if any(want[x] for x in ("dir_l", "point_pos", "spot_pos")):
        light_rows["lp"] = f32(nl, n, 3)
    if want["spot_dir"]:
        light_rows["sd"] = f32(ns, 3, n)
    if want["spot_cos_in"] or want["spot_cos_out"]:
        light_rows["cci"] = f32(ns, n)
    if want["spot_cos_out"]:
        light_rows["nco"] = f32(ns, n)
    wanted = _wanted_textures(wants[nw + len(_GLOSS_INPUTS):], s.refs) if ga else set()
    taps = tap_buffers(s.refs, wanted, n, dev)
    if taps[0] is not None:
        rows["textures"] = (*taps, wanted)
    if n and (out or rows or light_rows or any(x is not None for x in passes)):
        if s.m.dtype != torch.bool:
            raise TypeError("W4's backward takes a bool mask")
        ins = dict(packed=_i32(s.packed), m=s.m.contiguous(), P=_f32(s.P), N=_f32(s.N),
                   D=_f32(s.D), eps=_f32(s.eps), uv=_f32(s.uv), color=_f32(s.color),
                   diff=_f32(s.diff), rough=_f32(s.rough), spec=_f32(s.spec),
                   m_re=_f32(s.m_re), m_im=_f32(s.m_im), ambient=_f32(s.ambient),
                   scene_re=_f32(s.scene_re), scene_im=_f32(s.scene_im),
                   **{f: _f32(getattr(s, f)) for f in _LIGHT_TABLES})
        if s.occ is not None:
            if s.occ.dtype != torch.bool:
                raise TypeError("W4 takes bool shadow-ray answers")
            ins["occ"] = s.occ.contiguous()
        n_re, re_step = _medium(s.n_re)
        n_im, im_step = _medium(s.n_im)
        ins.update(n_re=n_re, n_im=n_im)
        tex = {}
        if s.ref_slot is not None:
            tex = dict(ref_slot=s.ref_slot.contiguous(), texels=s.ref_texels,
                       desc_i=s.ref_desc_i, desc_f=s.ref_desc_f)
        gs = [None if g is None else _f32(g) for g in grads]
        for name, x in [*ins.items(), *tex.items(), *(("grad", g) for g in gs if g is not None)]:
            if x.device != dev:
                raise ValueError(f"W4's backward: {name} is on {x.device}, the rays on {dev}")
        pair = lambda x, k: None if x is None else _p(x[k])
        struct = GlossBwd(
            **{k: _p(v) for k, v in ins.items()}, re_step=re_step, im_step=im_step,
            rows=s.color.shape[0], refs=0 if s.ref_slot is None else s.ref_slot.shape[0],
            ref_slot=_p(tex.get("ref_slot")),
            ref_tex=Textures(_p(tex.get("texels")), _p(tex.get("desc_i")),
                             _p(tex.get("desc_f"))),
            n_dir=nd, n_point=np_, n_spot=ns, five=SCHLICK, n=n,
            g=(_V * 4)(*(_p(g) for g in gs)), pass_=(_V * 4)(*(_p(x) for x in passes)),
            **{f"d{x}": t.data_ptr() for x, t in out.items()},
            color_rows=_p(rows.get("glossy_color")), diff_rows=_p(rows.get("glossy_diff")),
            rough_rows=_p(rows.get("glossy_roughness")),
            spec_rows=_p(rows.get("glossy_spec")), m_re_rows=_p(rows.get("glossy_n_re")),
            m_im_rows=_p(rows.get("glossy_n_im")), amb_rows=_p(rows.get("ambient_color")),
            sre_add=pair(rows.get("scene_n_re"), 0), sre_sub=pair(rows.get("scene_n_re"), 1),
            sim_add=pair(rows.get("scene_n_im"), 0), sim_sub=pair(rows.get("scene_n_im"), 1),
            **{f"{k}_rows": _p(v) for k, v in light_rows.items()},
            taps=TapRows(*(_p(x) for x in taps)))
        _glossy_rows.launches += _call(
            lib, "shade_glossy_bwd", ctypes.byref(struct), cuda_build.stream_of(dev),
            entries=ENTRIES)
    return passes, out, rows, light_rows, want


_glossy_rows.launches = 0


def _selected(parts, shape):
    """The gradient of a light table of `shape` whose rows the lights'
    selects took, from each light's row's gradient (parts: (light, value)
    in the order the lights were made): a select's full table of +0 pads
    around its row, the last light's first, the others added, as the
    engine adds them."""
    out = None
    for k, v in reversed(parts):
        t = v.new_zeros(shape)
        t[k] = v
        out = t if out is None else out + t
    return out


def _own(x):
    """x where its data starts on a 16-byte boundary, else a copy of it:
    ATen's sum of a row plans its four-wide loads from the row's first
    16-byte boundary, and the gradient the engine sums is a tensor of its
    own.  A light's (or a spot direction's channel's) rows lie a multiple
    of n floats into the kernel's buffer, off that boundary where n is no
    multiple of 4."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _light_grads(s, light_rows, want):
    """{light table: its gradient} from the kernel's per-(light, ray) rows:
    each light's broadcast row summed over the rays (the engine's sum_to,
    of rows on their own boundary: `_own`), then the lights' selects
    (`_selected`)."""
    nd, np_, ns = s.kinds
    res = {}
    lc, lp = light_rows.get("lc"), light_rows.get("lp")
    spans = {"dir": (0, nd), "point": (nd, np_), "spot": (nd + np_, ns)}
    for kind, (at, k) in spans.items():
        colour, where = f"{kind}_color", ("dir_l" if kind == "dir" else f"{kind}_pos")
        if want[colour]:
            res[colour] = _selected([(i, _own(lc[at + i]).sum_to_size(1, 3).reshape(3))
                                     for i in range(k)], getattr(s, colour).shape)
        if want[where]:
            # a directional light's expanded row, a point or spot light's
            # position pos[None, :]
            size = (3,) if kind == "dir" else (1, 3)
            res[where] = _selected([(i, _own(lp[at + i]).sum_to_size(*size).reshape(3))
                                    for i in range(k)], getattr(s, where).shape)
    if want["spot_dir"]:
        parts = []
        for i in range(ns):
            # _sum3's selects of spot_dir[i][None, :], the last channel first
            row = None
            for c in (2, 1, 0):
                t = s.spot_dir.new_zeros((1, 3))
                t[0, c] = _own(light_rows["sd"][i, c]).sum_to_size(1)[0]
                row = t if row is None else row + t
            parts.append((i, row.reshape(3)))
        res["spot_dir"] = _selected(parts, s.spot_dir.shape)
    if want["spot_cos_in"] or want["spot_cos_out"]:
        ins, outs = [], []
        for i in range(ns):
            # t = (cos_t - co) / clamp_min(ci - co, 1e-6): the divisor's
            # gradient summed over the rays, clamp_min's mask, ci - co
            g = _own(light_rows["cci"][i]).sum_to_size(())
            ci, co = s.spot_cos_in[i], s.spot_cos_out[i]
            g = torch.where(ci - co >= 1e-6, g, torch.zeros_like(g))
            ins.append((i, g))
            if want["spot_cos_out"]:
                outs.append((i, -g + _own(light_rows["nco"][i]).sum_to_size(())))
        if want["spot_cos_in"]:
            res["spot_cos_in"] = _selected(ins, s.spot_cos_in.shape)
        if want["spot_cos_out"]:
            res["spot_cos_out"] = _selected(outs, s.spot_cos_out.shape)
    return res


def glossy_vjp(grads, saved, wants, lib=None):
    """The glossy block's backward from W4's backward kernel
    (`_glossy_rows`): from the gradients of the four fields the entry
    writes (grads, one a WRITTEN[MAT_GLOSSY]; None where none comes) and
    the GlossSaved `saved`, the gradients `_Shade`'s backward returns
    (wants: its needs_input_grad past the call): the fields' pass-through
    gradients, then those of the block's `_inputs`, as `plain_shade_vjp`
    gives them, bit for bit.  The gathered tables' gradients are
    core/safemath.py `take_backward`'s scans of the kernel's per-ray rows,
    the colour textures' those of its taps' rows (`texture_grads`); a
    broadcast row's the engine's sum_to over the rays of its rows, and a
    light's the lights' selects of those (`_light_grads`)."""
    if all(g is None for g in grads):
        return [None] * len(wants)
    passes, out, rows, light_rows, want = _glossy_rows(grads, saved, wants, lib)
    s = saved
    lights = _light_grads(s, light_rows, want)
    tables = dict(zip(_GLOSS_TABLES, (s.color, s.diff, s.rough, s.spec, s.m_re, s.m_im)))
    res = []
    for x in _GLOSS_INPUTS:
        if x in out:
            res.append(out[x])
        elif x in tables and x in rows:
            res.append(take_backward(shade.slot_rows(s.mat_slot, tables[x]), rows[x],
                                     tables[x].shape))
        elif x == "ambient_color" and x in rows:
            res.append(rows[x].sum_to_size(1, 3).reshape(3))
        elif x in ("scene_n_re", "scene_n_im") and x in rows:
            a, b = (r.sum_to_size(1, 3).reshape(3) for r in rows[x])
            res.append(a + b)
        else:
            res.append(lights.get(x))
    return [*passes, *res, *_texture_results(s.refs, rows.get("textures"),
                                             len(wants) - len(passes) - len(res))]


# the backward calls of each block that recomputed its plain block for its
# VJP (`plain_shade_vjp`): a block's where no backward library serves it
# (CPU tensors)
plain_routes = {"diffuse": 0, "refractive": 0, "glossy": 0}


def plain_shade_vjp(mt, ctx, draws, m, occ, grads, wants):
    """The gradients `_Shade`'s backward returns, from the plain block
    (materials/shade.py) recomputed on the call's ctx (draws: the block's
    own) and merged under the mask m: the fields' pass-through gradients
    where(m, 0, g), then the VJP of `_inputs` (ops/plain_grad.py
    `plain_vjp`)."""
    nw = len(WRITTEN[mt])
    m3 = m[..., None]
    outs = [torch.where(m3, 0.0, g) if w and g is not None else None
            for g, w in zip(grads, wants[:nw])]

    def plain(leaves):
        o = _plain(mt, _rebuild(mt, ctx, leaves), {mt: draws}, occ)
        return [getattr(o, f) if g is None else torch.where(m3, getattr(o, f), g)
                for f, g in zip(WRITTEN[mt], grads)]

    return [*outs, *plain_vjp(grads, _inputs(mt, ctx), wants[nw:], plain)]


# each block's backward kernel: (its wrapper, the Saved class, a function
# making it from a call (ctx, draws, packed words, mask), the class's
# tensors, which `_Shade` saves, the other fields after them)
_BWD = {MAT_REFRACTIVE: (lambda *a: refractive_vjp(*a), RefrSaved, refr_saved, _REFR_SAVED),
        MAT_DIFFUSE: (lambda *a: diffuse_vjp(*a), DiffSaved, diff_saved, _DIFF_SAVED),
        MAT_GLOSSY: (lambda *a: glossy_vjp(*a), GlossSaved, gloss_saved, _GLOSS_SAVED)}


def _bwd_route(mt, ctx, lib, bwd_lib):
    """(the block's backward library, or None for the plain VJP; the plain
    route's key): the backward kernel on CUDA tensors (from `lib`, the
    render kernels' library unless given) or where `bwd_lib` (a library,
    or {type: library}) serves the type; the plain VJP on CPU tensors
    without a backward library."""
    name = _BLOCKS[mt][0][len("shade_"):]
    if isinstance(bwd_lib, dict):
        bwd_lib = bwd_lib.get(mt)
    if bwd_lib is None and not ctx.P.is_cuda:
        return None, name
    return (bwd_lib if bwd_lib is not None else lib or cuda_build.load_library()), name


class _Shade(torch.autograd.Function):
    """W4 forward into the merged output's float fields that the entry
    writes (`WRITTEN`), in place (xs: those fields, then the block's
    `_inputs`); a field that neither requires grad nor takes one from the
    block (`_flow`) is marked non-differentiable, as the plain merge
    leaves it.  Backward: a field's gradient passes where the block's
    rays are not (the merge's); where one of the block's inputs needs a
    gradient, the block's backward kernel (`refractive_vjp`,
    `diffuse_vjp`, `glossy_vjp`; `_bwd_route`) from the tensors saved for
    it, or the plain block recomputed from the tensors saved for it and
    its vector-Jacobian product on the block's rays (`plain_shade_vjp`,
    counted in `plain_routes`; see the module doc)."""

    @staticmethod
    def forward(fctx, call, *xs):
        mt, ctx, draws, packed, m, out, occ, lib, flow, bwd_lib = call
        nw = len(WRITTEN[mt])
        keep = [x.requires_grad or f in flow for x, f in zip(xs, WRITTEN[mt])]
        _launch(mt, ctx, draws, packed, out, occ, lib)
        fctx.mark_dirty(*xs[:nw])
        fctx.mark_non_differentiable(*(x for x, k in zip(xs, keep) if not k))
        fctx.set_materialize_grads(False)        # see ops/plain_grad.py
        fctx.mt = mt
        fctx.lib, fctx.route = _bwd_route(mt, ctx, lib, bwd_lib)
        if fctx.lib is not None:
            # what the backward kernel reads
            _, cls, make, ts = _BWD[mt]
            sv = make(ctx, draws, packed, m) if mt != MAT_GLOSSY else make(
                ctx, draws, packed, m, occ)
            fctx.rest = tuple(getattr(sv, f.name) for f in dataclasses.fields(cls)[len(ts):])
            fctx.save_for_backward(*(getattr(sv, f) for f in ts))
            return xs[:nw]
        saved = [m]
        if any(fctx.needs_input_grad[1 + nw:]):
            # the scene's static facts hold no tensors: kept as they are
            fctx.static = ctx.static
            fctx.held = _pack((dataclasses.replace(ctx, static=None),
                               draws.get(mt), occ), saved)
        fctx.save_for_backward(*saved)
        return xs[:nw]

    @staticmethod
    def backward(fctx, *grads):
        with torch.profiler.record_function(f"wavefront.backward.{_BLOCKS[fctx.mt][0]}"):
            return _shade_backward(fctx, *grads)


def _shade_backward(fctx, *grads):
    """`_Shade`'s backward (see there)."""
    saved, mt, wants = fctx.saved_tensors, fctx.mt, fctx.needs_input_grad[1:]
    if fctx.lib is not None:
        vjp, cls, _, _ = _BWD[mt]
        return (None, *vjp(grads, cls(*saved, *fctx.rest), wants, fctx.lib))
    nw = len(WRITTEN[mt])
    if all(g is None for g in grads) or not any(wants[nw:]):
        m3 = saved[0][..., None]
        return (None, *(torch.where(m3, 0.0, g) if w and g is not None else None
                        for g, w in zip(grads, wants[:nw])), *([None] * len(wants[nw:])))
    ctx, d, occ = _unpack(fctx.held, saved)
    plain_routes[fctx.route] += 1
    return (None, *plain_shade_vjp(mt, dataclasses.replace(ctx, static=fctx.static),
                                   d, saved[0], occ, grads, wants))


def _kernel_shade(mt, ctx, draws, packed, m, out, lib=None, bwd_lib=None):
    """W4 on the bounce, from `lib`: the merged output `out` with mt's rays
    shaded in place; through `_Shade` where autograd records the block
    (grad enabled and a float field the entry writes or one of the
    block's `_inputs` requiring grad), whose backward kernel comes from
    `bwd_lib` where it serves the type (a library, or {type: library};
    see `_bwd_route`)."""
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
    res = _Shade.apply((mt, ctx, draws, packed, m, out, occ, lib, flow, bwd_lib),
                       *written, *xs)
    return dataclasses.replace(out, **dict(zip(WRITTEN[mt], res)))


def backward_pair(fn, call, xs, grads, wants, lib=None):
    """(kernel, plain) for a backward of `_Shade` (fn) that
    ops/plain_grad.py `recording` recorded (its forward's call and inputs
    xs, its output gradients, the inputs' needs_input_grad): functions of
    no argument giving the gradients `_Shade`'s backward returns from the
    block's backward kernel (`lib`) and from the plain block's VJP
    (`plain_shade_vjp`), for the holds of one against the other."""
    mt, ctx, draws, packed, m, _, occ, _, _, _ = call
    plain = lambda: plain_shade_vjp(mt, ctx, draws.get(mt), m, occ, grads, wants)
    vjp, _, make, _ = _BWD[mt]
    sv = (lambda: make(ctx, draws, packed, m)) if mt != MAT_GLOSSY else (
        lambda: make(ctx, draws, packed, m, occ))
    return (lambda: vjp(grads, sv(), wants, lib)), plain


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


def info(mt, lib=None, variant=0, backward=False):
    """What W4's entry for material type mt was built to, read on the card
    (`shade_info`; variant: the diffuse entry's kernel, as KERNEL_INFO
    numbers them; backward: the type's backward kernel, `<entry>_bwd_info`,
    variant the diffuse one's caps sum in registers (0) or by the general
    plan (1)): registers and local memory (bytes: spills and stack) a
    thread, resident blocks an SM, the SMs, threads a block, the
    __launch_bounds__ minimum of blocks an SM, and rays a block a pass (a
    queued entry's tile)."""
    lib = lib or cuda_build.load_library()
    out = (_I * len(INFO))()
    if backward:
        name = f"{_BLOCKS[mt][0]}_bwd_info"
        fn = getattr(lib, name)
        if mt == MAT_DIFFUSE:
            args = (int(variant),)
            fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], _I
        else:
            args = ()
            fn.argtypes, fn.restype = [ctypes.POINTER(_I)], _I
    else:
        fn, args, name = lib.shade_info, (mt, int(variant)), "shade_info"
        fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], _I
    err = fn(*args, out)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return dict(zip(INFO, out))


def caps_sum(x, wide=False, lib=None):
    """torch.sum(x, -1) of the (n, K) float32 rows x as the diffuse entry
    adds its caps pdf's terms on the card (`w4_caps_sum`): by the register
    sum of the plan torch's reduction makes for x (raises where that plan
    is past it: four values a load from K = 128), or, wide, by the general
    restatement of that plan (where it splits each row across blocks, the
    blocks' sums staged and then added as ATen's last block adds them: two
    launches).  For the holds against torch.sum."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError("caps_sum takes (n, K) float32 rows")
    x = x.contiguous()
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    staging = _staging(x.shape[1], x.shape[0], x.device, lib) if wide else None
    _call(lib, "w4_caps_sum", x.data_ptr(), x.shape[0], x.shape[1], int(wide),
          _p(staging), out.data_ptr(), cuda_build.stream_of(x.device),
          entries=ENTRIES)
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


# each backward kernel's entry and the launch function that counts it
_BWD_COUNTED = {"shade_refractive_bwd": _refractive_rows,
                "shade_diffuse_bwd": _diffuse_rows, "shade_glossy_bwd": _glossy_rows}


def backward_launches():
    """{entry: launches} of W4's backward kernels."""
    return {k: f.launches for k, f in _BWD_COUNTED.items()}


def reset_launches():
    """Zero the forward and backward counts and the plain routes'."""
    for w in _WRAPPER.values():
        w.launches = 0
    for f in _BWD_COUNTED.values():
        f.launches = 0
    for k in plain_routes:
        plain_routes[k] = 0
