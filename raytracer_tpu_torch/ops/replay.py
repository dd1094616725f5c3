"""The replay of the record path: records -> radiance (plain PyTorch).

Counterpart of `_decode_words` and `_replay` in
raytracer_tpu/ops/pallas_record.py (:742, :787), which are XLA code in the
JAX package, not a Pallas kernel.  From the (B, n) group words and the
(B, 12, n) shading floats of ops/record_trace.py it

- routes every (bounce, ray) element to its texture by shading group
  (image textures, the environment's display map or, for secondary rays,
  its prebaked display + intensity * lightmap table, the thin-film
  tables), builds one atlas index per element and gathers one packed word
  (four, weighted, for bilinear textures);
- decodes the words: 10-10-10 bits over a per-texture scale, or RGB9E5;
- fetches a second, dependent round for thin films whose composed table
  was too large (noise texel -> LUT column);
- integrates L = sum_b beta_b * add_b with the product chain over bounces.

The port fetches bilinear taps as four gathers; the JAX package's quad
atlas (one gather row per fetch) exists for the TPU's gather engine and
is bit-identical to this.  The banded replay is not ported.
"""

from __future__ import annotations

import torch

from ..core.compile import SceneStatic, SolidTables, shading_groups
from ..materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV, MAT_GLOSSY,
                              MAT_THINFILM)


def decode_words(w, s1023, e5m, any_e5):
    """Packed atlas words -> [r, g, b] (pallas_record.py:742): 10-10-10
    bits times s1023 (the texture's scale / 1023), or, where e5m, RGB9E5
    (a shared exponent e, value m * 2^(e - 24))."""
    ten = [((w >> 20) & 1023).to(torch.float32) * s1023,
           ((w >> 10) & 1023).to(torch.float32) * s1023,
           (w & 1023).to(torch.float32) * s1023]
    if not any_e5:
        return ten
    es = torch.exp2(((w >> 27) & 31).to(torch.float32) - 24.0)
    e5 = [((w >> 18) & 511).to(torch.float32) * es,
          ((w >> 9) & 511).to(torch.float32) * es,
          (w & 511).to(torch.float32) * es]
    return [torch.where(e5m, e5[c], ten[c]) for c in range(3)]


class _Round:
    """One gather round: per-element fetch parameters, built by
    group-masked selects (pallas_record.py Round)."""

    def __init__(self, static, tables, u, v):
        M, dev = u.shape[0], u.device
        self.static, self.tables, self.u, self.v = static, tables, u, v
        i0 = torch.zeros(M, dtype=torch.int64, device=dev)
        self.f0 = torch.zeros(M, dtype=torch.float32, device=dev)
        self.off, self.W, self.H = i0, i0 + 1, i0 + 1
        self.frep = self.grep = self.scale = self.f0
        self.used = False
        self.direct, self.dmask = i0, None
        self.e5m = self.bilm = torch.zeros(M, dtype=torch.bool, device=dev)
        self.any_e5 = self.any_bil = False

    def _set_enc(self, m, tex_id):
        enc = bool(self.static.tex_enc[tex_id])
        self.any_e5 = self.any_e5 or enc
        self.e5m = torch.where(m, enc, self.e5m)

    def set(self, m, tex_id, repeat=1.0, bilinear=False):
        self.used = True
        Hh, Ww = self.static.tex_shapes[tex_id]
        self.off = torch.where(m, self.static.tex_offsets[tex_id], self.off)
        self.W = torch.where(m, Ww, self.W)
        self.H = torch.where(m, Hh, self.H)
        # W * repeat and H * repeat as float32, as the JAX package's
        # weakly typed python floats become
        self.frep = torch.where(m, float(Ww * repeat), self.frep)
        self.grep = torch.where(m, float(Hh * repeat), self.grep)
        self.scale = torch.where(m, self.tables.tex_scale[tex_id], self.scale)
        self._set_enc(m, tex_id)
        self.any_bil = self.any_bil or bool(bilinear)
        self.bilm = torch.where(m, bool(bilinear), self.bilm)

    def set_direct(self, m, tex_id, local_idx):
        """Fetch texture-local element local_idx instead of the uv wrap
        (the composed thin-film tables index by (cos row, noise texel))."""
        self.used = True
        self.off = torch.where(m, self.static.tex_offsets[tex_id], self.off)
        self.scale = torch.where(m, self.tables.tex_scale[tex_id], self.scale)
        self.direct = torch.where(m, local_idx, self.direct)
        self.dmask = m if self.dmask is None else (self.dmask | m)
        self._set_enc(m, tex_id)

    def uv_index(self):
        iu = torch.remainder((self.u * self.frep).to(torch.int64), self.W)
        iv = torch.remainder((self.v * self.grep).to(torch.int64), self.H)
        idx = torch.remainder(-iv, self.H) * self.W + iu
        if self.dmask is not None:
            idx = torch.where(self.dmask, self.direct, idx)
        return idx + self.off

    def take(self, idx):
        """Gather and decode the words at idx, clipped into the atlas as
        jnp.take(mode="clip") does."""
        atlas = self.tables.atlas
        w = atlas[idx.clamp(0, atlas.shape[0] - 1)]
        return decode_words(w, self.scale * (1.0 / 1023.0), self.e5m,
                            self.any_e5)

    def fetch(self):
        """This round's texels: one gather, or four weighted gathers when
        a group fetches bilinear (other groups' elements ride tap 0 at
        weight 1)."""
        if not self.any_bil:
            return self.take(self.uv_index())
        x = self.u * self.frep - 0.5
        y = self.v * self.grep - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        ix, iy = x0.to(torch.int64), y0.to(torch.int64)
        idx_n = self.uv_index()
        one = self.f0 + 1.0
        wgts = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
        out = [self.f0, self.f0, self.f0]
        for (dx, dy), wgt in zip(((0, 0), (1, 0), (0, 1), (1, 1)), wgts):
            col = torch.remainder(ix + dx, self.W)
            row = torch.remainder(-(iy + dy), self.H)
            idx = torch.where(self.bilm, row * self.W + col + self.off, idx_n)
            rgb = self.take(idx)
            w_el = torch.where(self.bilm, wgt,
                               one if (dx, dy) == (0, 0) else self.f0)
            out = [out[c] + w_el * rgb[c] for c in range(3)]
        return out


def replay(rec_g, rec_f, static: SceneStatic, tables: SolidTables,
           max_bounces, n):
    """rec_g (B, n) int32, rec_f (B, 12, n) float32 -> radiance (n, 3)
    float32 (pallas_record.py:787 `_replay`, flat order, no banding)."""
    groups, order = shading_groups(static.obj_records)
    dif_tex = {r.slot: r for r in static.diffuse_tex}
    glo_tex = {r.slot: r for r in static.glossy_tex}
    emi_tex = {r.slot: r for r in static.emissive_tex}
    env_by_slot = {e.slot: e for e in static.env_slots}
    tf_lut = {r.slot: r for r in static.thinfilm_lut}
    tf_noise = {r.slot: r for r in static.thinfilm_noise}
    tf_comp = {r.slot: r for r in static.thinfilm_comp}

    B, dev = max_bounces, rec_g.device
    M = B * n
    word = rec_g.reshape(M).to(torch.int64)
    gid = word & 0xFFFF
    flag = (word >> 16) & 1
    plane = lambda j: rec_f[:, j, :].reshape(M)
    u_, v_, cos_i = plane(0), plane(1), plane(2)
    add_b = [plane(3 + k) for k in range(3)]
    add_t = [plane(6 + k) for k in range(3)]
    beta_b = [plane(9 + k) for k in range(3)]
    # env lightmaps apply to secondary rays only
    sec = (torch.arange(M, device=dev) // n) > 0

    r1, r2 = _Round(static, tables, u_, v_), _Round(static, tables, u_, v_)
    lut_rows = torch.zeros(M, dtype=torch.int64, device=dev)
    lut_mode = torch.zeros(M, dtype=torch.bool, device=dev)
    masks = {key: gid == groups[key]["gid"] for key in order}
    for key in order:
        mt, slot, _maxd, _mc = key
        m = masks[key]
        if mt == MAT_ENV:
            env = env_by_slot[slot]
            if env.combined is not None:
                # the display for camera rays, display + intensity *
                # lightmap for secondary rays
                r1.set(m & ~sec, env.tex)
                r1.set(m & sec, env.combined)
            else:
                r1.set(m, env.tex)
        elif mt == MAT_THINFILM and slot in tf_comp:
            # the composed (cos row, noise texel) table: one round
            comp = tf_comp[slot]
            LH = int(comp.repeat)
            cH, cW = static.tex_shapes[comp.tex]
            nH, nW = cH // LH, cW
            iu = torch.remainder((u_ * (nW * 0.5)).to(torch.int64), nW)
            iv = torch.remainder((v_ * (nH * 0.5)).to(torch.int64), nH)
            rn = torch.remainder(-iv, nH)
            row = torch.clamp((cos_i * LH).to(torch.int64), 0, LH - 1)
            r1.set_direct(m, comp.tex, (row * nH + rn) * nW + iu)
        elif mt == MAT_THINFILM:
            # past TF_COMP_LIMIT: the dependent two-round fetch
            r1.set(m, tf_noise[slot].tex, 0.5)
            r2.set(m, tf_lut[slot].tex)
            Hh = static.tex_shapes[tf_lut[slot].tex][0]
            lut_rows = torch.where(m, (cos_i * Hh).to(torch.int64), lut_rows)
            lut_mode = lut_mode | m
        elif mt == MAT_DIFFUSE and slot in dif_tex:
            r1.set(m, dif_tex[slot].tex, dif_tex[slot].repeat,
                   dif_tex[slot].bilinear)
        elif mt == MAT_GLOSSY and slot in glo_tex:
            r1.set(m, glo_tex[slot].tex, glo_tex[slot].repeat,
                   glo_tex[slot].bilinear)
        elif mt == MAT_EMISSIVE and slot in emi_tex:
            r1.set(m, emi_tex[slot].tex, emi_tex[slot].repeat,
                   emi_tex[slot].bilinear)

    ones = torch.ones(M, dtype=torch.float32, device=dev)
    # a round no group fetches from is skipped
    rgb1 = r1.fetch() if r1.used else [ones, ones, ones]
    rgb2 = None
    if r2.used:
        # round 2: the thin-film LUT at (cos row, thickness column), the
        # column jittered by round 1's noise value
        th_all = r1.f0
        for key in order:
            mt, slot, _maxd, _mc = key
            if mt == MAT_THINFILM and slot not in tf_comp:
                th = tables.tf[slot, 4] + tables.tf[slot, 5] * (rgb1[0] - 0.5)
                th_all = torch.where(masks[key], th, th_all)
        lut_idx = (torch.minimum(torch.clamp_min(lut_rows, 0), r2.H - 1) * r2.W
                   + torch.minimum(torch.clamp_min(th_all.to(torch.int64), 0),
                                   r2.W - 1)
                   + r2.off)
        rgb2 = r2.take(torch.where(lut_mode, lut_idx, r2.uv_index()))

    tex = [ones, ones, ones]
    beta_tex = [ones, ones, ones]
    for key in order:
        mt, slot, _maxd, _mc = key
        m = masks[key]
        if mt == MAT_ENV:
            # a lightmap is always baked into `combined` (core/compile.py)
            tex = [torch.where(m, rgb1[c], tex[c]) for c in range(3)]
        elif mt == MAT_THINFILM:
            refl = flag == 1
            F = rgb1 if slot in tf_comp else rgb2
            for c in range(3):
                tex[c] = torch.where(m, F[c], tex[c])     # add = ambient * F
                beta_tex[c] = torch.where(
                    m, torch.where(refl, F[c], 1.0 - F[c]), beta_tex[c])
        elif mt == MAT_DIFFUSE and slot in dif_tex:
            beta_tex = [torch.where(m, rgb1[c], beta_tex[c]) for c in range(3)]
        elif ((mt == MAT_GLOSSY and slot in glo_tex)
              or (mt == MAT_EMISSIVE and slot in emi_tex)):
            tex = [torch.where(m, rgb1[c], tex[c]) for c in range(3)]

    hit = gid > 0
    out = []
    for c in range(3):
        m_add = torch.where(hit, add_b[c] + add_t[c] * tex[c], 0.0).reshape(B, n)
        m_beta = torch.where(hit, beta_b[c] * beta_tex[c], 1.0).reshape(B, n)
        Lc, beta = m_add[0], m_beta[0]
        for k in range(1, B):
            Lc = Lc + beta * m_add[k]
            beta = beta * m_beta[k]
        out.append(Lc)
    return torch.stack(out, dim=-1)
