"""Analytic thin-film interference reflectance LUT (host, numpy).

Counterpart of raytracer_tpu/utils/thin_film.py, the same numpy code, so
the tables are bit-equal to the JAX package's.

The reference ships precomputed PNG lookup tables
(sightpy/textures/thin_film_interference_n={1.3,1.4,1.5}.png) indexed by
(cos(theta_i) * height, thickness_nm) and multiplies the result into the
reflected radiance (thin_film_interference.py:59-72).  Here the table is
computed from first principles (Airy summation for a film of index n_f in
air) at the same three RGB wavelengths the engine uses for its spectral
approximation, so any film index works without shipping assets.

Layout matches the reference indexing convention:
  lut[row, col, channel], row = int(cos_theta_i * H) clamped, col = thickness in nm.
"""

from __future__ import annotations

import numpy as np

from .constants import WAVELENGTHS_NM

LUT_H = 1024           # cos(theta) resolution
LUT_THICKNESS_NM = 2048  # max film thickness (columns = integer nanometres)

_lut_cache = {}


def thin_film_reflectance(cos_i, thickness_nm, film_n, wavelengths=WAVELENGTHS_NM):
    """Unpolarized reflectance of an air / film / air stack.

    cos_i: (...,) cosine of incidence angle; thickness_nm: (...,) film
    thickness; returns (..., len(wavelengths)).
    """
    # clamp away from exact grazing: at cos_i == 0 the Airy ratio is 0/0
    # (R -> 1 in the limit); 1e-4 keeps the table finite and smooth
    cos_i = np.clip(np.asarray(cos_i, dtype=np.float64), 1e-4, 1.0)
    d = np.asarray(thickness_nm, dtype=np.float64)
    n0 = 1.0
    nf = float(film_n)

    sin_i2 = 1.0 - cos_i ** 2
    sin_t2 = sin_i2 / nf ** 2
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin_t2))

    # interface amplitude coefficients (s and p polarization);
    # exit medium is air so the 2->3 interface mirrors 1->2
    r_s1 = (n0 * cos_i - nf * cos_t) / (n0 * cos_i + nf * cos_t)
    r_p1 = (nf * cos_i - n0 * cos_t) / (nf * cos_i + n0 * cos_t)
    r_s2 = (nf * cos_t - n0 * cos_i) / (nf * cos_t + n0 * cos_i)
    r_p2 = (n0 * cos_t - nf * cos_i) / (n0 * cos_t + nf * cos_i)

    out = []
    for lam in wavelengths:
        delta = 4.0 * np.pi * nf * d * cos_t / lam
        ph = np.exp(1j * delta)
        R_s = np.abs((r_s1 + r_s2 * ph) / (1.0 + r_s1 * r_s2 * ph)) ** 2
        R_p = np.abs((r_p1 + r_p2 * ph) / (1.0 + r_p1 * r_p2 * ph)) ** 2
        out.append(0.5 * (R_s + R_p))
    return np.stack(out, axis=-1)


def thin_film_lut(film_n, height=LUT_H, max_thickness=LUT_THICKNESS_NM):
    """(height, max_thickness, 3) float32 reflectance table."""
    key = (round(float(film_n), 6), height, max_thickness)
    if key not in _lut_cache:
        cos_i = (np.arange(height) + 0.5) / height
        d = np.arange(max_thickness, dtype=np.float64)
        R = thin_film_reflectance(cos_i[:, None], d[None, :], film_n)
        _lut_cache[key] = R.astype(np.float32)
    return _lut_cache[key]


def default_noise_texture(size=512, seed=7):
    """Smooth tileable value-noise texture in [0, 1] for thickness jitter.

    Stands in for the reference's sightpy/textures/noise.png asset: a blurred
    random field, deterministic by seed.
    """
    rng = np.random.default_rng(seed)
    base = rng.random((size, size))
    # low-pass in Fourier space -> smooth and periodic (tileable)
    f = np.fft.rfft2(base)
    ky = np.fft.fftfreq(size)[:, None]
    kx = np.fft.rfftfreq(size)[None, :]
    sigma = 0.02
    f *= np.exp(-(kx ** 2 + ky ** 2) / (2 * sigma ** 2))
    smooth = np.fft.irfft2(f, s=(size, size))
    smooth -= smooth.min()
    smooth /= max(smooth.max(), 1e-12)
    return smooth.astype(np.float32)
