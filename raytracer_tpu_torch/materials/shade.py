"""The wavefront's shading blocks, one per material type, on torch tensors.

Counterpart of raytracer_tpu/materials/shade.py.  Every bounce, each
material type present in the scene shades ALL rays (masked execution,
fixed shapes) into a `ShadeOut`, and the integrator (core/integrator.py)
keeps each ray's own type:

  L    += beta * add             radiance emitted toward the ray
  beta *= beta_mult              path throughput
  ray  <- (new_origin, new_dir)  the continuation, where cont

Where a JAX block draws from its threefry key (diffuse :340-342, the hero
channel :436, refractive :459, thin film :537), the block here takes the
draws as tensor arguments, which the integrator draws from the chunk's
generator; each block is thus a pure function of its inputs.  A CustomMaterial
shades in its own `shade(ctx)`, starting from `default_shade_out`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..core import rng
from ..core.safemath import div, rdiv, safe_norm, safe_sqrt, take
from ..geometry.intersect import occluded
from ..utils.constants import SKYBOX_DISTANCE, UPWARDS


@dataclass
class ShadeOut:
    add: Any              # (N, 3) radiance at this hit, before throughput
    beta_mult: Any        # (N, 3) throughput factor of the continuation
    new_origin: Any       # (N, 3)
    new_dir: Any          # (N, 3)
    new_n_re: Any         # (N, 3) medium IoR carried by the continuation
    new_n_im: Any         # (N, 3)
    cont: Any             # (N,) bool: does the path go on?
    is_reflection: Any    # (N,) bool
    is_transmission: Any
    is_diffuse: Any
    did_split: Any = None  # (N,) bool: consumed a deterministic split bit


def default_shade_out(ctx):
    """A neutral ShadeOut: no emission, unit throughput, the path ends
    (shade.py:52).  Custom shaders start from it and replace the fields
    they set (dataclasses.replace, or by assignment)."""
    n = ctx.P.shape[0]
    f = torch.zeros((n, 3), dtype=ctx.P.dtype, device=ctx.P.device)
    b = torch.zeros((n,), dtype=torch.bool, device=ctx.P.device)
    return ShadeOut(add=f, beta_mult=torch.ones_like(f), new_origin=ctx.P,
                    new_dir=ctx.D, new_n_re=ctx.n_re, new_n_im=ctx.n_im,
                    cont=b, is_reflection=b, is_transmission=b, is_diffuse=b,
                    did_split=b)


_zeros_out = default_shade_out


def _split_branch(ctx, cont):
    """Deterministic Fresnel branch selection (shade.py:68): (det,
    take_second, did_split); det marks rays whose branch is bit
    split_cnt of their pattern, weighted 2F or 2T."""
    if ctx.split_k <= 0 or ctx.pattern is None:
        z = torch.zeros(ctx.P.shape[:1], dtype=torch.bool, device=ctx.P.device)
        return z, z, z
    det = (~ctx.obj_mc) & (ctx.split_cnt < ctx.split_k) & cont
    bit = ((ctx.pattern >> torch.clamp_max(ctx.split_cnt, 30)) & 1) == 1
    return det, bit, det


# ---------------------------------------------------------------------------
# texture fetch
# ---------------------------------------------------------------------------


def fetch_texture(tex, uv, repeat=1.0, bilinear=False):
    """Texel of `tex` (H, W, C) at uv in sightpy's wrap-around convention
    (shade.py:94): row = (-v * H * repeat) mod H, column = (u * W * repeat)
    mod W, truncated; bilinear wrap-interpolates the four neighbours."""
    H, W = tex.shape[0], tex.shape[1]
    flat = tex.reshape(-1, tex.shape[-1])

    def tap(iu, iv):
        idx = torch.remainder(-iv, H) * W + torch.remainder(iu, W)
        return take(flat, idx.reshape(-1).long()).reshape(
            iu.shape + (tex.shape[-1],))

    if not bilinear:
        iu = (uv[..., 0] * (W * repeat)).to(torch.int32)
        iv = (uv[..., 1] * (H * repeat)).to(torch.int32)
        return tap(iu, iv)
    x = uv[..., 0] * (W * repeat) - 0.5
    y = uv[..., 1] * (H * repeat) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    ix, iy = x0.to(torch.int32), y0.to(torch.int32)
    return ((1 - fx) * (1 - fy) * tap(ix, iy) + fx * (1 - fy) * tap(ix + 1, iy)
            + (1 - fx) * fy * tap(ix, iy + 1) + fx * fy * tap(ix + 1, iy + 1))


def slot_rows(slot, table):
    """The row of table each slot gathers: the slot clamped into the table
    (jnp.take mode=clip), int64, as `_g1` and the backward kernels'
    `take_backward` scans index it."""
    return torch.clamp(slot, 0, table.shape[0] - 1).long()


def _g1(table, slot):
    """table[slot], the slot clamped into the table (`slot_rows`), with a
    reproducible gradient (safemath.take)."""
    return take(table, slot_rows(slot, table))


def _slot_color(solid_table, slot, uv, tex_refs, textures):
    """Per-ray colour: the solid table, overridden by the slots' image
    textures (shade.py:130)."""
    color = _g1(solid_table, slot)
    for ref in tex_refs:
        c = fetch_texture(textures[ref.tex], uv, ref.repeat, ref.bilinear)
        color = torch.where((slot == ref.slot)[..., None], c, color)
    return color


def _sum3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _reflect(D, N):
    r = D - N * (2.0 * _sum3(D, N))[..., None]
    return r / torch.sqrt(_sum3(r, r))[..., None]


def _cmag2(re, im):
    return re * re + im * im


def _c_mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _c_div(a, b):
    d = torch.clamp_min(b[0] * b[0] + b[1] * b[1], 1e-30)
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _c_sqrt(a):
    # safe_sqrt: a real IoR at total internal reflection takes sqrt(0)
    mag = safe_sqrt(a[0] * a[0] + a[1] * a[1])
    re = safe_sqrt((mag + a[0]) * 0.5)
    im = safe_sqrt((mag - a[0]) * 0.5)
    return re, torch.where(a[1] < 0, -im, im)


# ---------------------------------------------------------------------------
# emissive and environment
# ---------------------------------------------------------------------------


def shade_emissive(ctx):
    """Emit the material's colour and end the path (shade.py:176)."""
    out = _zeros_out(ctx)
    out.add = _slot_color(ctx.data.mats.emissive_color, ctx.mat_slot, ctx.uv,
                          ctx.static.emissive_tex, ctx.data.textures)
    return out


def shade_env(ctx):
    """The environment's texel, plus light_intensity x the lightmap on
    rays past the camera's (shade.py:192)."""
    out = _zeros_out(ctx)
    color = torch.zeros_like(ctx.P)
    for env in ctx.static.env_slots:
        c = fetch_texture(ctx.data.textures[env.tex], ctx.uv, 1.0)
        if env.lightmap is not None:
            li = _g1(ctx.data.mats.env_light_intensity, ctx.mat_slot)
            lm = fetch_texture(ctx.data.textures[env.lightmap], ctx.uv, 1.0)
            c = c + torch.where((ctx.depth != 0)[..., None], li[..., None] * lm,
                                0.0)
        color = torch.where((ctx.mat_slot == env.slot)[..., None], c, color)
    out.add = color
    return out


# ---------------------------------------------------------------------------
# glossy
# ---------------------------------------------------------------------------


def light_rays(ctx):
    """(nudged, rays): the glossy block's shadow-ray origins, P + N * eps,
    and each light's (L, dist) in its order (directional, point, spot):
    L (N, 3) the unit direction toward the light (a directional light's
    one row expanded), dist (N,) its distance (a directional light's
    SKYBOX_DISTANCE, one element).  The plain block and W4's wrapper
    (ops/wavefront_shade.py) both take them from here."""
    lights, static, P = ctx.data.lights, ctx.static, ctx.P
    nudged = P + ctx.N * ctx.eps[..., None]
    rays = []
    for i in range(static.n_dir_lights):
        rays.append((lights.dir_l[i].expand(P.shape),
                     torch.full((1,), SKYBOX_DISTANCE, dtype=P.dtype,
                                device=P.device)))
    for pos in ([lights.point_pos[i] for i in range(static.n_point_lights)]
                + [lights.spot_pos[i] for i in range(static.n_spot_lights)]):
        d = pos[None, :] - P
        dist = safe_norm(d, dim=-1)
        rays.append((d / torch.clamp_min(dist, 1e-20)[..., None], dist))
    return nudged, rays


def light_occlusion(ctx, nudged, rays):
    """Each light's shadow-ray answer, (N,) bool a light in `rays`' order,
    or None where no object casts a shadow (the glossy block's light
    terms)."""
    if not ctx.static.has_shadow_objects:
        return None
    data = ctx.data
    return [occluded(nudged, L, data.geom, data.obj.shadow,
                     dist.expand(ctx.P.shape[:1])) for L, dist in rays]


def shade_glossy(ctx, occ=None):
    """Ambient, Lambert and Schlick-Fresnel Blinn-Phong per light with
    shadow rays, and the Fresnel-weighted mirror continuation
    (shade.py:216).  occ: the lights' shadow-ray answers
    (`light_occlusion`), cast here unless given."""
    mats, data, static = ctx.data.mats, ctx.data, ctx.static
    slot, N = ctx.mat_slot, ctx.N
    V = -ctx.D
    out = _zeros_out(ctx)

    diff_coeff = _g1(mats.glossy_diff, slot)
    diff_color = _slot_color(mats.glossy_color, slot, ctx.uv, static.glossy_tex,
                             data.textures) * diff_coeff[..., None]
    add = data.ambient_color[None, :] * diff_color
    nudged, rays = light_rays(ctx)
    if occ is None:
        occ = light_occlusion(ctx, nudged, rays)
    roughness = _g1(mats.glossy_roughness, slot)
    spec_coeff = _g1(mats.glossy_spec, slot)
    m_n_re = _g1(mats.glossy_n_re, slot)
    m_n_im = _g1(mats.glossy_n_im, slot)

    def light_term(L, hit, irradiance):
        NdotL = torch.clamp_min(_sum3(N, L), 0.0)
        lv = irradiance(NdotL)
        if hit is not None:
            seelight = 1.0 - hit.to(N.dtype)
        else:
            seelight = torch.ones_like(NdotL)
        term = diff_color * lv * seelight[..., None]
        H = L + V
        H = H / torch.clamp_min(safe_norm(H, keepdim=True), 1e-20)
        # F0 against the medium the ray travels in (glossy.py:65)
        F0 = (_cmag2(ctx.n_re - m_n_re, ctx.n_im - m_n_im)
              / torch.clamp_min(_cmag2(ctx.n_re + m_n_re, ctx.n_im + m_n_im),
                                1e-20))
        cos_vh = torch.clamp(_sum3(V, H), 0.0, 1.0)
        F = F0 + (1.0 - F0) * torch.pow(1.0 - cos_vh[..., None], 5)
        a = rdiv(2.0, torch.clamp_min(roughness, 1e-6) ** 2) - 2.0
        Dphong = div(torch.pow(torch.clamp(_sum3(N, H), 0.0, 1.0), a) * (a + 2.0),
                     2.0 * math.pi)
        denom = 4.0 * torch.clamp(_sum3(N, V) * NdotL, 0.001, 1.0)
        spec = F * (Dphong / denom * seelight * spec_coeff)[..., None] * lv
        return term + torch.where((roughness != 0.0)[..., None], spec, 0.0)

    lights = data.lights
    hits = occ if occ is not None else [None] * len(rays)
    k = 0
    for i in range(static.n_dir_lights):
        c = lights.dir_color[i]
        add = add + light_term(
            rays[k][0], hits[k], lambda NdotL, c=c: c[None, :] * NdotL[..., None])
        k += 1
    for i in range(static.n_point_lights):
        c = lights.point_color[i]
        L, dist = rays[k]
        add = add + light_term(
            L, hits[k], lambda NdotL, c=c, dd=dist:
                c[None, :] * (NdotL / dd ** 2 * 100.0)[..., None])
        k += 1
    for i in range(static.n_spot_lights):
        # point falloff times a smoothstep cone (lights.SpotLight)
        c = lights.spot_color[i]
        ci, co = lights.spot_cos_in[i], lights.spot_cos_out[i]
        L, dist = rays[k]
        cos_t = _sum3(-L, lights.spot_dir[i][None, :])
        t = torch.clamp((cos_t - co) / torch.clamp_min(ci - co, 1e-6), 0.0, 1.0)
        cone = t * t * (3.0 - 2.0 * t)
        add = add + light_term(
            L, hits[k], lambda NdotL, c=c, dd=dist, k=cone:
                c[None, :] * (NdotL * k / dd ** 2 * 100.0)[..., None])
        k += 1

    # the mirror continuation, Schlick-Fresnel against the scene's medium
    # (glossy.py:87-104)
    F0 = (_cmag2(data.scene_n_re[None, :] - m_n_re, data.scene_n_im[None, :] - m_n_im)
          / torch.clamp_min(_cmag2(data.scene_n_re[None, :] + m_n_re,
                                   data.scene_n_im[None, :] + m_n_im), 1e-20))
    cos_vn = torch.clamp(_sum3(V, N), 0.0, 1.0)
    out.add = add
    out.beta_mult = F0 + (1.0 - F0) * torch.pow(1.0 - cos_vn[..., None], 5)
    out.new_origin = nudged
    out.new_dir = _reflect(ctx.D, N)
    out.cont = ctx.depth < ctx.obj_max_depth
    out.is_reflection = out.cont
    return out


# ---------------------------------------------------------------------------
# diffuse
# ---------------------------------------------------------------------------


def shade_diffuse(ctx, u, pick=None):
    """Monte-Carlo Lambertian over the cosine / light-cap / environment
    mixture (shade.py:316); at most 2 diffuse bounces a path.  The
    environment component samples the alias tables of an
    importance-sampled Panorama (SceneStatic.env_is_shape).

    u: (u_mix, u_phi, u_r2), each (N,), the block's uniforms (the
    stratified ctx.strat_u replace them at a path's first diffuse bounce);
    pick: (N,) int64 importance-sampled target of the caps branch, needed
    when the scene has targets.
    """
    mats, data, static = ctx.data.mats, ctx.data, ctx.static
    N = ctx.N
    out = _zeros_out(ctx)
    diff_color = _slot_color(mats.diffuse_color, ctx.mat_slot, ctx.uv,
                             static.diffuse_tex, data.textures)
    nudged = ctx.P + N * ctx.eps[..., None]
    if ctx.strat_u is not None:
        first = ctx.diffuse_reflections == 0
        u = tuple(torch.where(first, s, i) for s, i in zip(ctx.strat_u, u))
    if tuple(static.env_is_shape) != (0, 0):
        # cosine, caps and the environment: the env component sends rays
        # toward the map's bright cells
        w = _g1(mats.diffuse_ambient_weight, ctx.mat_slot)
        env_tabs = (data.env_is_prob, data.env_is_alias, data.env_is_pdf,
                    tuple(static.env_is_shape))
        d, pdf = rng.mixed_diffuse_sample(
            None, N, nudged,
            data.is_center if static.n_is_targets > 0 else None,
            data.is_radius, env_tabs, w, uniforms=u, pick=pick)
    elif static.n_is_targets > 0:
        w = _g1(mats.diffuse_ambient_weight, ctx.mat_slot)
        d, pdf = rng.mixed_cosine_caps_sample(
            None, N, nudged, data.is_center, data.is_radius, w, uniforms=u,
            pick=pick)
    else:
        d = rng.cosine_sample(None, N, uniforms=(u[1], u[2]))
        pdf = rng.cosine_pdf_value(d, N)
    NdotL = torch.clamp(_sum3(d, N), 0.0, 1.0)
    weight = div(NdotL / torch.clamp_min(pdf, 1e-9), math.pi)
    out.add = torch.zeros_like(diff_color)
    out.beta_mult = diff_color * weight[..., None]
    out.new_origin = nudged
    out.new_dir = d
    out.cont = ctx.diffuse_reflections < 2
    out.is_reflection = out.cont
    out.is_diffuse = out.cont
    return out


# ---------------------------------------------------------------------------
# refractive
# ---------------------------------------------------------------------------


def shade_refractive(ctx, u, hero=None):
    """Complex-IoR Fresnel dielectric with Beer-Lambert absorption
    (shade.py:379); the branch chosen by u (N,) against the refraction
    probability, or by the split pattern.  hero: (N,) int64 channel of a
    dispersive material's transmitted path, needed when the scene has
    dispersion (spectral hero wavelength)."""
    mats, data = ctx.data.mats, ctx.data
    N = ctx.N
    V = -ctx.D
    out = _zeros_out(ctx)

    m_re = _g1(mats.refr_n_re, ctx.mat_slot)
    m_im = _g1(mats.refr_n_im, ctx.mat_slot)
    entering = (ctx.orient == UPWARDS)[..., None]
    n2_re = torch.where(entering, m_re, data.scene_n_re[None, :])
    n2_im = torch.where(entering, m_im, data.scene_n_im[None, :])

    cos_i = _sum3(V, N)[..., None]                       # (N, 1)
    n1 = (ctx.n_re, ctx.n_im)
    n2 = (n2_re, n2_im)
    ratio = _c_div(n1, n2)
    r2 = _c_mul(ratio, ratio)
    s2 = 1.0 - cos_i * cos_i
    cos_t = _c_sqrt((1.0 - r2[0] * s2, -r2[1] * s2))
    a = (n1[0] * cos_i, n1[1] * cos_i)
    bt = _c_mul(n2, cos_t)
    r_per = _c_div((a[0] - bt[0], a[1] - bt[1]), (a[0] + bt[0], a[1] + bt[1]))
    at = _c_mul(n1, cos_t)
    bb = (n2[0] * cos_i, n2[1] * cos_i)
    r_par = _c_div((bb[0] - at[0], bb[1] - at[1]), (at[0] + bb[0], at[1] + bb[1]))
    F = div(_cmag2(*r_per) + _cmag2(*r_par), 2.0)
    T = 1.0 - F

    # the refraction direction from the channel-averaged real ratio
    ratio_ch = ctx.n_re / torch.clamp_min(n2_re, 1e-9)
    ratio_avg = div(ratio_ch[..., 0] + ratio_ch[..., 1] + ratio_ch[..., 2], 3.0)
    cos_i1 = cos_i[..., 0]
    hero_w = None
    if ctx.static.has_dispersion:
        # dispersive paths refract at one channel's IoR and carry 3x its
        # throughput (shade.py:428-441)
        disp = _g1(mats.refr_dispersive, ctx.mat_slot) > 0.5
        ratio_h = torch.gather(ratio_ch, -1, hero[..., None].long())[..., 0]
        ratio_avg = torch.where(disp, ratio_h, ratio_avg)
        onehot = torch.nn.functional.one_hot(hero.long(), 3).to(ctx.P.dtype)
        hero_w = torch.where(disp[..., None], 3.0 * onehot, 1.0)
    sin2_t = ratio_avg ** 2 * (1.0 - cos_i1 ** 2)
    non_tir = sin2_t <= 1.0
    refr_dir = (ctx.D * ratio_avg[..., None]
                + N * (ratio_avg * cos_i1 - safe_sqrt(1.0 - sin2_t))[..., None])
    refr_norm = safe_sqrt(_sum3(refr_dir, refr_dir))[..., None]
    refr_dir = refr_dir / torch.clamp_min(refr_norm, 1e-20)
    refl_dir = _reflect(ctx.D, N)

    # Beer-Lambert over the segment just travelled (refractive.py:114-122)
    lam = torch.tensor(ctx.wavelengths, dtype=ctx.P.dtype, device=ctx.P.device)
    k = rdiv(2.0 * math.pi, lam)[None, :]
    absorb = torch.exp(-2.0 * ctx.n_im * k * 1e9 * ctx.t[..., None])

    T_avg = div(T[..., 0] + T[..., 1] + T[..., 2], 3.0)
    p_refr = torch.where(non_tir, torch.clamp(T_avg, 0.0, 1.0), 0.0)
    take_refr = (u < p_refr) & non_tir
    w_refr = T / torch.clamp_min(p_refr, 1e-9)[..., None]
    w_refl = F / torch.clamp_min(1.0 - p_refr, 1e-9)[..., None]

    cont = ctx.depth < ctx.obj_max_depth
    det, bit, did_split = _split_branch(ctx, cont)
    take_refr = torch.where(det, bit & non_tir, take_refr)
    d3 = det[..., None]
    w = torch.where(take_refr[..., None], torch.where(d3, 2.0 * T, w_refr),
                    torch.where(d3, 2.0 * F, w_refl))
    # a pattern that asks for refraction under TIR carries no energy
    cont = cont & ~(det & bit & ~non_tir)

    t3 = take_refr[..., None]
    out.add = torch.zeros_like(F)
    out.beta_mult = absorb * w
    if hero_w is not None:
        out.beta_mult = out.beta_mult * torch.where(t3, hero_w, 1.0)
    out.new_dir = torch.where(t3, refr_dir, refl_dir)
    out.new_origin = torch.where(t3, ctx.P - N * ctx.eps[..., None],
                                 ctx.P + N * ctx.eps[..., None])
    out.new_n_re = torch.where(t3, n2_re, ctx.n_re)
    out.new_n_im = torch.where(t3, n2_im, ctx.n_im)
    out.cont = cont
    out.is_reflection = cont & ~take_refr
    out.is_transmission = cont & take_refr
    out.did_split = did_split
    return out


# ---------------------------------------------------------------------------
# thin-film interference
# ---------------------------------------------------------------------------


def shade_thinfilm(ctx, u):
    """Thin film: reflectance from the (cos theta, thickness) table, the
    transmitted path straight through (shade.py:510); u (N,) chooses the
    branch against the mean reflectance."""
    mats, data, static = ctx.data.mats, ctx.data, ctx.static
    N = ctx.N
    V = -ctx.D
    out = _zeros_out(ctx)

    cos_i = torch.clamp(_sum3(V, N), 0.0, 1.0)
    thickness = _g1(mats.tf_thickness, ctx.mat_slot)
    noise_factor = _g1(mats.tf_noise, ctx.mat_slot)
    for ref in static.thinfilm_noise:
        noise = fetch_texture(data.textures[ref.tex], ctx.uv, 0.5)[..., 0]
        jittered = thickness + noise_factor * (noise - 0.5)
        thickness = torch.where(ctx.mat_slot == ref.slot, jittered, thickness)

    F = torch.zeros_like(ctx.P)
    for ref in static.thinfilm_lut:
        lut = data.textures[ref.tex]
        H, W = lut.shape[0], lut.shape[1]
        row = torch.clamp((cos_i * H).to(torch.int32), 0, H - 1)
        col = torch.clamp(thickness.to(torch.int32), 0, W - 1)
        val = take(lut.reshape(-1, 3), (row * W + col).long())
        F = torch.where((ctx.mat_slot == ref.slot)[..., None], val, F)
    T = 1.0 - F

    out.cont = ctx.depth < ctx.obj_max_depth
    # the reflected branch also takes the ambient term times F, below the
    # depth cap (thin_film_interference.py:83-99)
    out.add = torch.where(out.cont[..., None], data.ambient_color[None, :] * F,
                          0.0)
    F_avg = div(F[..., 0] + F[..., 1] + F[..., 2], 3.0)
    take_refl = u < torch.clamp(F_avg, 0.0, 1.0)
    w_refl = F / torch.clamp_min(F_avg, 1e-9)[..., None]
    w_tran = T / torch.clamp_min(1.0 - F_avg, 1e-9)[..., None]
    det, bit, did_split = _split_branch(ctx, out.cont)
    take_refl = torch.where(det, bit, take_refl)
    out.did_split = did_split
    d3, r3 = det[..., None], take_refl[..., None]
    out.beta_mult = torch.where(r3, torch.where(d3, 2.0 * F, w_refl),
                                torch.where(d3, 2.0 * T, w_tran))
    out.new_dir = torch.where(r3, _reflect(ctx.D, N), ctx.D)
    out.new_origin = torch.where(r3, ctx.P + N * ctx.eps[..., None],
                                 ctx.P - N * ctx.eps[..., None])
    out.is_reflection = out.cont & take_refl
    out.is_transmission = out.cont & ~take_refl
    return out
