"""Low-discrepancy camera sampling: Cranley-Patterson-rotated R2 lattices.

Counterpart of raytracer_tpu/core/lds.py, which has the derivation.  The
JAX package does this math in uint32; torch's CPU uint32 has no shifts or
adds, so here every value is an int64 tensor holding a uint32 in
[0, 2**32), and each operation masks back to 32 bits.  Products are split
into 16-bit halves so that no intermediate leaves int64.  The bits are
those of the JAX package, and of csrc/solid_trace.cu, which hard-codes the
same constants.

Draw-dimension registry (shared with the JAX package):
  0, 1: camera AA jitter (x, y)
  2, 3: thin-lens aperture (r, phi)
  4, 5: first diffuse bounce direction (phi, r2/cap-z)
  6:    first diffuse bounce mixture choice (cosine vs light cap)
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

_G2 = 1.32471795724474602596   # plastic constant (R2)
_G3 = 1.22074408460575947536
_G4 = 1.16730397826141868426
_fx = lambda a: int(a * 2 ** 32) & M32
# per-dimension generators in 32-bit fixed point (frac by wraparound)
ALPHA = (_fx(1 / _G2), _fx(1 / _G2 ** 2),          # 0,1: camera AA
         _fx(1 / _G3), _fx(1 / _G3 ** 2),          # 2,3: thin lens
         _fx(1 / _G4), _fx(1 / _G4 ** 2),          # 4,5: first diffuse dir
         _fx(1 / _G4 ** 3), _fx(1 / _G3 ** 3))     # 6: mixture choice; 7: spare
# per-dimension rotation salts
DIM_SALT = (0x3C6EF372, 0x9E3779B9, 0x85EBCA77, 0xC2B2AE3D,
            0x27220A95, 0x6180339B, 0xB5297A4D, 0x68E31DA5)

INV_2_24 = 1.0 / (1 << 24)


def mul32(x, c):
    """(x * c) mod 2**32 for x in [0, 2**32) and a python int c."""
    c &= M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def add32(a, b):
    return (a + b) & M32


def mix32(x):
    """murmur3 finalizer (the kernels' hash)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def to_float(bits):
    """uint32 bits -> float32 in [0, 1): the top 24 bits, exactly."""
    return (bits >> 8).to(torch.float32) * INV_2_24


def r2_bits(pix, s, seed, dim):
    """uint32 bits of the R2 sample u_dim(pix, s).

    pix, s: int64 tensors of uint32 values (pixel and global sample
    index); seed: render seed as an int64 tensor or python int (any sign;
    its low 32 bits are used); dim: python-static draw dimension.
    """
    rot = mix32(mul32(pix, 0x9E3779B1) ^ add32(seed & M32, DIM_SALT[dim]))
    return add32(rot, mul32(s, ALPHA[dim]))


def raygen_draws(pixu, su, seed):
    """The kernels' raygen draw set: camera AA (u1, u2), thin lens
    (u3, u4), and the first-diffuse-bounce (mix, phi, r2), dims 0-6."""
    u = [to_float(r2_bits(pixu, su, seed, d)) for d in range(7)]
    return u[0], u[1], u[2], u[3], u[6], u[4], u[5]


def first_bounce_uniforms(width, n_pix, spp, row0, strat_seed, sample0,
                          device="cpu"):
    """(u_mix, u_phi, u_r2) of the first diffuse bounce, dims 6, 4, 5, one
    draw set per ray of a [sample, pixel]-ordered wavefront of spp x
    n_pix rays whose band starts at film row `row0`
    (raytracer_tpu/core/lds.py:95).  row0, strat_seed and sample0 are
    Python ints."""
    idx = torch.arange(spp * n_pix, dtype=torch.int64, device=device)
    gpix = torch.remainder(idx, n_pix) + int(row0) * width
    s = torch.div(idx, n_pix, rounding_mode="floor") + int(sample0)
    return tuple(to_float(r2_bits(gpix & M32, s & M32, int(strat_seed), d))
                 for d in (6, 4, 5))
