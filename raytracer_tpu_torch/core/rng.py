"""Sampling primitives and importance-sampling PDFs on torch tensors.

Counterpart of raytracer_tpu/core/rng.py (which replaces sightpy's
utils/random.py).  Where a JAX sampler takes a threefry key, this one
takes `generator`, a `torch.Generator` on the device of the tensors it
samples for; its draws come from that generator in a fixed order, so a
seeded generator gives the same samples on every run.  The port does not
reproduce threefry: the draws differ from the JAX package's, the
distributions do not.  Everything that draws nothing (the basis, the pdfs,
the cap geometry, the environment alias lookup, and every sampler given
`uniforms=`) computes what the JAX function computes, to float32
rounding.

Directions and normals are tensors of shape (..., 3); samples match the
batch shape.
"""

from __future__ import annotations

import math

import torch

from .safemath import safe_sqrt, take

_TWO_PI = 2.0 * math.pi


def _uniform(generator, shape, like=None):
    """U[0, 1) float32 (or `like`'s dtype) of `shape` from `generator`."""
    dtype = torch.float32 if like is None else like.dtype
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=generator.device)


# ---------------------------------------------------------------------------
# basic geometric samplers
# ---------------------------------------------------------------------------


def random_in_unit_disk(generator, shape):
    """Uniform points in the unit disk -> (rx, ry), each of `shape`
    (sightpy random.py:6-9)."""
    r = torch.sqrt(_uniform(generator, shape))
    phi = _uniform(generator, shape) * _TWO_PI
    return r * torch.cos(phi), r * torch.sin(phi)


def random_in_unit_sphere(generator, shape):
    """Uniform directions on the unit sphere, shape (*shape, 3)
    (sightpy random.py:12-17)."""
    phi = _uniform(generator, shape) * _TWO_PI
    u = 2.0 * _uniform(generator, shape) - 1.0
    r = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), u], dim=-1)


def _orthonormal_basis(w):
    """(u, v) orthonormal to the unit vectors w (..., 3): a helper axis
    chosen by |w.x|, then two cross products (sightpy random.py:63-66)."""
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    a = torch.where(torch.abs(w[..., 0:1]) > 0.9, ey.expand(w.shape),
                    ex.expand(w.shape))
    v = torch.linalg.cross(w, a, dim=-1)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    u = torch.linalg.cross(w, v, dim=-1)
    return u, v


# ---------------------------------------------------------------------------
# cosine-weighted hemisphere
# ---------------------------------------------------------------------------


def cosine_sample(generator, normal, uniforms=None):
    """Cosine-weighted directions about `normal` (..., 3) (sightpy
    cosine_pdf.generate, random.py:62-74).

    uniforms: optional (u_phi, u_r2) in [0, 1), each batch-shaped, the
    injection point of stratified draws; `generator` is unused when given.
    """
    ax_u, ax_v = _orthonormal_basis(normal)
    batch = normal.shape[:-1]
    if uniforms is None:
        u_phi = _uniform(generator, batch, normal)
        r2 = _uniform(generator, batch, normal)
    else:
        u_phi, r2 = uniforms
    phi = u_phi * _TWO_PI
    z = torch.sqrt(1.0 - r2)
    x = torch.cos(phi) * torch.sqrt(r2)
    y = torch.sin(phi) * torch.sqrt(r2)
    return ax_u * x[..., None] + ax_v * y[..., None] + normal * z[..., None]


def cosine_pdf_value(direction, normal):
    """PDF of cosine_sample at `direction` (sightpy random.py:57-59)."""
    c = torch.clamp(torch.sum(direction * normal, dim=-1), 0.0, 1.0)
    return c / math.pi


def hemisphere_sample(generator, normal):
    """Uniform directions on the hemisphere about `normal` (sightpy
    random.py:44-46)."""
    r = random_in_unit_sphere(generator, normal.shape[:-1]).to(normal.dtype)
    flip = torch.sum(normal * r, dim=-1, keepdim=True) < 0.0
    return torch.where(flip, -r, r)


def hemisphere_pdf_value(direction, normal):
    del direction, normal
    return 1.0 / (2.0 * math.pi)


# ---------------------------------------------------------------------------
# spherical caps toward importance-sampled targets
# ---------------------------------------------------------------------------


def caps_geometry(origin, targets_center, targets_radius):
    """Per-(ray, target) cap axis and cos(theta_max).

    origin (..., 3); targets_center (K, 3); targets_radius (K,).  Returns
    the unit axes toward each target, (..., K, 3), and cos_max (..., K)
    (sightpy spherical_caps_pdf, random.py:98-133).
    """
    d = targets_center - origin[..., None, :]
    # safe_sqrt: an origin on or inside a target saturates these (dist 0,
    # sin_max 1), where a plain sqrt's backward is NaN
    dist = safe_sqrt(torch.sum(d * d, dim=-1))
    ax_w = d / torch.clamp_min(dist, 1e-20)[..., None]
    sin_max = torch.clamp(targets_radius / torch.clamp_min(dist, 1e-20),
                          0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin_max * sin_max)
    return ax_w, cos_max


def _cap_direction(ax_w, cos_max, u_phi, r2):
    """The direction of (u_phi, r2) in the cap about ax_w."""
    ax_u, ax_v = _orthonormal_basis(ax_w)
    phi = u_phi * _TWO_PI
    z = 1.0 + r2 * (cos_max - 1.0)
    s = safe_sqrt(1.0 - z * z)
    return (ax_u * (torch.cos(phi) * s)[..., None]
            + ax_v * (torch.sin(phi) * s)[..., None] + ax_w * z[..., None])


def caps_sample(generator, origin, targets_center, targets_radius,
                uniforms=None, pick=None):
    """A direction in the union-of-caps mixture, the target picked
    uniformly (sightpy spherical_caps_pdf.generate, random.py:98-151).

    uniforms: optional (u_phi, u_r2) for the draw inside the cap; pick:
    optional batch-shaped int64 target index; what is not given comes from
    `generator`.
    """
    batch = origin.shape[:-1]
    K = targets_center.shape[0]
    ax_w, cos_max = caps_geometry(origin, targets_center, targets_radius)
    if pick is None:
        pick = torch.randint(0, K, tuple(batch), generator=generator,
                             device=generator.device)
    ax_w_sel = torch.gather(
        ax_w, -2, pick[..., None, None].expand(*batch, 1, 3))[..., 0, :]
    cos_sel = torch.gather(cos_max, -1, pick[..., None])[..., 0]
    if uniforms is None:
        u_phi = _uniform(generator, batch, origin)
        r2 = _uniform(generator, batch, origin)
    else:
        u_phi, r2 = uniforms
    return _cap_direction(ax_w_sel, cos_sel, u_phi, r2)


def caps_pdf_value(direction, origin, targets_center, targets_radius):
    """Mixture PDF of caps_sample at `direction` (sightpy
    random.py:87-96)."""
    ax_w, cos_max = caps_geometry(origin, targets_center, targets_radius)
    K = targets_center.shape[0]
    inside = torch.sum(direction[..., None, :] * ax_w, dim=-1) > cos_max
    per_cap = torch.where(inside, 1.0 / ((1.0 - cos_max) * 2.0 * math.pi),
                          torch.zeros_like(cos_max))
    return torch.sum(per_cap, dim=-1) / K


def spherical_cap_sample(generator, cos_max, normal):
    """A direction in the cap of half-angle acos(cos_max) about `normal`
    (sightpy random_in_unit_spherical_cap, random.py:239-253)."""
    batch = normal.shape[:-1]
    u_phi = _uniform(generator, batch, normal)
    r2 = _uniform(generator, batch, normal)
    return _cap_direction(normal, cos_max, u_phi, r2)


# ---------------------------------------------------------------------------
# environment-map importance sampling (alias method)
# ---------------------------------------------------------------------------
# The distribution lives on a uniform (Hs, Ws) grid over the equirect
# (u, v) square.  Within a picked cell, v is jittered uniformly in
# sin(elevation), so the density is constant in solid angle over the cell
# and pdf(d) is one table lookup.  Direction <-> (u, v) follows the
# sphere's uv convention: u = (atan2(z, x) + pi) / 2pi,
# v = (asin(y) + pi/2) / pi.


def _gather(table, idx):
    """table[idx] (idx int32 of any shape) through core/safemath.py `take`:
    a table that requires grad takes its gradient by `take`'s fixed-order
    scan, as every gather from such a table does."""
    return take(table, idx.reshape(-1).long()).reshape(idx.shape)


def env_alias_sample(u1, u2, prob, alias, hw):
    """Directions distributed per the environment's alias tables; u1 and
    u2 in [0, 1)."""
    Hs, Ws = hw
    n = Hs * Ws
    x = u1 * n
    k = torch.clamp(x.to(torch.int32), 0, n - 1)
    ju = x - k                          # the fraction is the u jitter
    p = _gather(prob, k)
    take = u2 < p
    k = torch.where(take, k, alias[k.long()].to(torch.int32))
    jv = torch.where(take, u2 / torch.clamp_min(p, 1e-12),
                     (u2 - p) / torch.clamp_min(1.0 - p, 1e-12))
    i = torch.div(k, Ws, rounding_mode="floor").to(u1.dtype)
    j = torch.remainder(k, Ws).to(u1.dtype)
    uu = (j + ju) / Ws
    # the cell's v band [i/Hs, (i+1)/Hs] in sin(elevation): uniform jv
    # there is uniform in solid angle over the band
    s0 = -torch.cos(math.pi * i / Hs)
    s1 = -torch.cos(math.pi * (i + 1.0) / Hs)
    sy = s0 + jv * (s1 - s0)
    rho = safe_sqrt(1.0 - sy * sy)
    phi = _TWO_PI * uu - math.pi
    return torch.stack([rho * torch.cos(phi), sy, rho * torch.sin(phi)],
                       dim=-1)


def env_pdf_value(direction, pdf_table, hw):
    """Solid-angle pdf of env_alias_sample at `direction` (one gather)."""
    Hs, Ws = hw
    u = (torch.atan2(direction[..., 2], direction[..., 0]) + math.pi) \
        / _TWO_PI
    v = (torch.asin(torch.clamp(direction[..., 1], -1.0, 1.0))
         + math.pi / 2.0) / math.pi
    i = torch.clamp((v * Hs).to(torch.int32), 0, Hs - 1)
    j = torch.remainder((u * Ws).to(torch.int32), Ws)
    idx = torch.clamp(i * Ws + j, 0, pdf_table.shape[0] - 1)
    return _gather(pdf_table, idx)


# ---------------------------------------------------------------------------
# mixtures used by the Diffuse BRDF
# ---------------------------------------------------------------------------


def mixed_cosine_caps_sample(generator, normal, origin, targets_center,
                             targets_radius, cosine_weight, uniforms=None,
                             pick=None):
    """Sample the Diffuse importance mixture; returns (direction, pdf).

    With probability `cosine_weight` a cosine-lobe direction about the
    normal, else one from the union of caps toward the importance-sampled
    targets; the pdf is the full mixture's (sightpy mixed_pdf,
    random.py:153-174, as diffuse.py:49-61 uses it).

    uniforms: optional (u_mix, u_phi, u_r2); the (phi, r2) pair feeds
    whichever branch is chosen.  pick: optional target index of the caps
    branch (see caps_sample).
    """
    batch = normal.shape[:-1]
    if uniforms is None:
        u_mix, dir_u = _uniform(generator, batch, normal), None
    else:
        u_mix, dir_u = uniforms[0], (uniforms[1], uniforms[2])
    use_cos = u_mix < cosine_weight
    d_cos = cosine_sample(generator, normal, uniforms=dir_u)
    d_caps = caps_sample(generator, origin, targets_center, targets_radius,
                         uniforms=dir_u, pick=pick)
    d = torch.where(use_cos[..., None], d_cos, d_caps)
    pdf = (cosine_weight * cosine_pdf_value(d, normal)
           + (1.0 - cosine_weight) * caps_pdf_value(d, origin, targets_center,
                                                    targets_radius))
    return d, pdf


def mixed_diffuse_sample(generator, normal, origin, targets_center,
                         targets_radius, env_tabs, cosine_weight,
                         uniforms=None, pick=None):
    """The general Diffuse mixture: cosine lobe, light caps and the
    environment; returns (direction, pdf).

    env_tabs = (prob, alias, pdf_table, (Hs, Ws)) or None; a
    targets_center of None (or with no rows) drops the caps.  The cosine
    lobe takes `cosine_weight` (sightpy's ambient_weight, diffuse.py:49-58)
    and the other components share the rest equally.  Every direction with
    N.L > 0 keeps pdf > 0 through the cosine term.

    uniforms: optional (u_mix, u_phi, u_r2); the (phi, r2) pair feeds
    whichever branch is chosen.  pick: optional target index of the caps
    branch (see caps_sample).
    """
    has_caps = targets_center is not None and targets_center.shape[0] > 0
    has_env = env_tabs is not None
    batch = normal.shape[:-1]
    if uniforms is None:
        u_mix = _uniform(generator, batch, normal)
        dir_u = (_uniform(generator, batch, normal),
                 _uniform(generator, batch, normal))
    else:
        u_mix, dir_u = uniforms[0], (uniforms[1], uniforms[2])

    w = cosine_weight
    seg = (1.0 - w) / (int(has_caps) + int(has_env))
    d = cosine_sample(generator, normal, uniforms=dir_u)
    if has_caps:
        d_caps = caps_sample(generator, origin, targets_center,
                             targets_radius, uniforms=dir_u, pick=pick)
        in_caps = (u_mix >= w) & (u_mix < w + seg)
        d = torch.where(in_caps[..., None], d_caps, d)
    if has_env:
        prob, alias, pdf_tab, hw = env_tabs
        d_env = env_alias_sample(dir_u[0], dir_u[1], prob, alias, hw)
        in_env = u_mix >= 1.0 - seg
        d = torch.where(in_env[..., None], d_env, d)
    pdf = w * cosine_pdf_value(d, normal)
    if has_caps:
        pdf = pdf + seg * caps_pdf_value(d, origin, targets_center,
                                         targets_radius)
    if has_env:
        pdf = pdf + seg * env_pdf_value(d, pdf_tab, hw)
    return d, pdf
