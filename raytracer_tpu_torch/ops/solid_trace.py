"""The solid path-tracing kernel: a CUDA kernel and its plain PyTorch version.

Counterpart of raytracer_tpu/ops/pallas_trace.py (`pallas_trace_chunk`,
kernel body `_make_kernel`, with its production options diet, aa_planes
and merge_groups).  One call traces one chunk of spp * H * W camera rays
of a solid-colour scene: ray generation (pinhole + thin lens, fisheye,
equirect, orthographic), then per bounce the nearest hit over spheres,
planes, boxes, discs, cylinders and triangles, the normal, and the shading
of emissive, diffuse (cosine lobe + spherical-cap importance sampling),
refractive (complex-IoR Fresnel, Beer-Lambert, deterministic Fresnel
splitting, hero-wavelength dispersion) and glossy hits (ambient, lights
with shadow rays, Blinn-Phong, the Fresnel mirror continuation).  It
returns L as (n, 3) float32 in [sample, pixel] order, and the count of
rays traced (the sum over bounces of the rays alive at the start of the
bounce).

- `solid_trace_chunk_reference` is the plain version: vectorised over
  rays, the hash math in int64 (core/lds.py), the reference's own
  polynomials.  It runs on any device.
- `solid_trace_chunk` is the public entry.  For CPU tensors it calls the
  plain version; for CUDA tensors it launches the kernel of
  csrc/solid_trace.cu, or raises.  The kernel's grid is persistent: its
  warps take ray indices from a work counter that the wrapper zeroes.

Both follow the JAX kernel draw for draw: given the same seed_vec they
trace the same paths, ray by ray.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core import lds
from ..core.compile import (KIND_CODES, OBJ_AA_N, OBJ_AA_NSIGN, OBJ_AA_U,
                            OBJ_AA_V, OBJ_COLS, OBJ_HU1, OBJ_KIND,
                            OBJ_MAT_SLOT, OBJ_MAT_TYPE, OBJ_MAX_DEPTH, OBJ_MC,
                            OBJ_SHADOW, SolidTables)
from ..materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_GLOSSY,
                              MAT_REFRACTIVE)
from ..utils.constants import (FARAWAY, MISS_THRESHOLD, SKYBOX_DISTANCE,
                               WAVELENGTHS_NM)
from .cuda_build import (SMEM_OPTIN_MAX, check_tensor, load_library,
                         stream_of)

SAMPLERS = ("r2", "iid")
# camera projections and their codes in the kernels (trace_common.cuh)
PROJECTIONS = {"pinhole": 0, "fisheye": 1, "equirect": 2, "orthographic": 3}
MAX_SPLIT_K = 16
MAX_HU_GROUPS = 48          # csrc/solid_trace.cu MAX_HU

_SPHERE, _PLANE, _BOX, _TRI, _DISC, _CYL = (
    KIND_CODES[k] for k in ("sphere", "plane", "box", "tri", "disc", "cyl"))
_SOLID_TYPES = {MAT_EMISSIVE, MAT_GLOSSY, MAT_DIFFUSE, MAT_REFRACTIVE}
KIND_NAMES = {code: name for name, code in KIND_CODES.items()}


def check_args(sampler, projection, split_k):
    """Raise ValueError for a sampler, projection or split_k the kernels
    do not know."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be 'r2' or 'iid', got {sampler!r}")
    if projection not in PROJECTIONS:
        raise ValueError(f"projection must be one of {tuple(PROJECTIONS)}, "
                         f"got {projection!r}")
    if not (isinstance(split_k, int) and 0 <= split_k <= MAX_SPLIT_K):
        raise ValueError(f"split_k must be an int in [0, {MAX_SPLIT_K}], "
                         f"got {split_k!r}")


def check_slice(tables: SolidTables, split_k, sampler, projection):
    """Raise for arguments or material types the solid kernel does not
    take."""
    check_args(sampler, projection, split_k)
    bad = {r[OBJ_MAT_TYPE] for r in tables.obj_rows} - _SOLID_TYPES
    if bad:
        raise ValueError(f"material types {sorted(bad)} have no solid shading")


def hu_groups(obj_rows):
    """Depth caps of the solid kernel's merged dispersive groups, in the
    order of their OBJ_HU1 numbers (core/compile.dispersive_groups)."""
    maxd = {r[OBJ_HU1]: r[OBJ_MAX_DEPTH] for r in obj_rows if r[OBJ_HU1] >= 0}
    return [maxd[j] for j in range(len(maxd))]


# ---------------------------------------------------------------------------
# helpers of the plain versions (pallas_trace.py:68-500)
# ---------------------------------------------------------------------------


def hash_uniform(idx, seed, counter):
    """`_TileRng.uniform`: murmur3 over (ray index, draw counter, seed).

    idx: int64 tensor of ray indices; seed: int64 tensor or int (low 32
    bits used); counter: the draw number, counted from 1.
    """
    x = lds.mul32(idx, 0x9E3779B1)
    x = x ^ lds.add32(seed & lds.M32, (counter * 0x85EBCA6B) & lds.M32)
    return lds.to_float(lds.mix32(x))


def tally(counts, key, v):
    """counts[key] += v, for an int or a mask (its count of True).  The
    event counts of the plain versions' optional `counts` dict, which
    probes/roofline.py turns into the kernels' work."""
    counts[key] = counts.get(key, 0) + int(v.sum() if torch.is_tensor(v) else v)


def kind_key(row):
    """The name of an object row's intersection test in the event counts:
    its kind, and "plane_aa" for a plane with an axis-aligned frame."""
    name = KIND_NAMES[row[OBJ_KIND]]
    return name + "_aa" if row[OBJ_KIND] == _PLANE and row[OBJ_AA_N] >= 0 else name


def live_warps(alive):
    """How many warps of 32 consecutive rays hold a ray alive: the warps
    that run a bounce in a kernel with one ray per thread."""
    pad = torch.zeros((-alive.numel()) % 32, dtype=torch.bool, device=alive.device)
    return torch.cat([alive, pad]).view(-1, 32).any(dim=1)


def tally_normals(counts, found, kind_hit, rows, uv_hit=None):
    """normal_<kind> (and uv_<kind> where uv_hit) events of the lanes
    `found`, whose hit object has kind code kind_hit."""
    for k in {KIND_NAMES[r[OBJ_KIND]] for r in rows}:
        m = found & (kind_hit == KIND_CODES[k])
        tally(counts, f"normal_{k}", m)
        if uv_hit is not None:
            tally(counts, f"uv_{k}", m & uv_hit)


def tally_tests(counts, key, lanes, kinds):
    """counts[key_<kind>] += lanes for every object of `kinds`, a list of
    kind names: one intersection test each."""
    for k in set(kinds):
        tally(counts, f"{key}_{k}", lanes * kinds.count(k))


def _div(a, s):
    """a / s for a Python number s, correctly rounded on every device: on
    CUDA, torch turns a division by a Python number into a product with
    its rounded reciprocal, which the kernel's division does not do."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv(a, b):
    d = torch.clamp_min(b[0] * b[0] + b[1] * b[1], 1e-30)
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _csqrt(a):
    mag = torch.sqrt(a[0] * a[0] + a[1] * a[1])
    re = torch.sqrt(torch.clamp_min((mag + a[0]) * 0.5, 0.0))
    im = torch.sqrt(torch.clamp_min((mag - a[0]) * 0.5, 0.0))
    return re, torch.where(a[1] < 0, -im, im)


def _cabs2(a):
    return a[0] * a[0] + a[1] * a[1]


def _pow5(x):
    """x ** 5 as lax.integer_pow computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def atan2_poly(y, x):
    """The reference's polynomial atan2 (pallas_trace.py:121)."""
    ax, ay = x.abs(), y.abs()
    a = torch.minimum(ax, ay) / torch.clamp_min(torch.maximum(ax, ay), 1e-30)
    s = a * a
    r = a * (0.9998660 + s * (-0.3302995 + s * (0.1801410
             + s * (-0.0851330 + s * 0.0208351))))
    r = torch.where(ay > ax, (math.pi / 2) - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def asin_poly(x):
    """The reference's asin through the polynomial atan2 (pallas_trace.py:133)."""
    x = torch.clamp(x, -1.0, 1.0)
    return atan2_poly(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def sincos_2pi(u):
    """(sin, cos) of 2*pi*u: the reference's quarter-wave polynomials
    (pallas_trace.py:138)."""
    t = u - torch.floor(u)
    x4 = t * 4.0
    q = torch.floor(x4)
    r = x4 - q
    r2 = r * r
    s = r * (1.57079632 + r2 * (-0.64596375 + r2 * (0.07968996
             + r2 * (-0.00467430 + r2 * 0.00015179))))
    c = 0.99999996 + r2 * (-1.23369862 + r2 * (0.25365306
        + r2 * (-0.02081478 + r2 * 0.00086048)))
    q1, q2, q3 = q == 1.0, q == 2.0, q == 3.0
    sin_v = torch.where(q1, c, torch.where(q2, -s, torch.where(q3, -c, s)))
    cos_v = torch.where(q1, -s, torch.where(q2, -c, torch.where(q3, s, c)))
    return sin_v, cos_v


def _orthobasis(nx, ny, nz):
    """(u, v) orthonormal to n (pallas_trace.py:239)."""
    big = nx.abs() > 0.9
    ax = torch.where(big, 0.0, 1.0)
    ay = torch.where(big, 1.0, 0.0)
    vx = ny * 0.0 - nz * ay
    vy = nz * ax - nx * 0.0
    vz = nx * ay - ny * ax
    vx, vy, vz = _normalize3(vx, vy, vz)
    ux = ny * vz - nz * vy
    uy = nz * vx - nx * vz
    uz = nx * vy - ny * vx
    return (ux, uy, uz), (vx, vy, vz)


def _isect_sphere(g, ox, oy, oz, dx, dy, dz):
    cx, cy, cz, r = g[0], g[1], g[2], g[3]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    tca = -(dx * ocx + dy * ocy + dz * ocz)
    px, py, pz = ocx + tca * dx, ocy + tca * dy, ocz + tca * dz
    d2 = px * px + py * py + pz * pz
    disc = r * r - d2
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    h0, h1 = tca - sq, tca + sq
    h = torch.where((h0 > 0) & (h0 < h1), h0, h1)
    ndd = (((ox + dx * h) - cx) * dx + ((oy + dy * h) - cy) * dy
           + ((oz + dz * h) - cz) * dz)
    valid = (disc > 0) & (h > 0) & (ndd != 0)
    return torch.where(valid, h, FARAWAY), torch.where(ndd < 0, 1.0, -1.0)


def _isect_plane(g, ox, oy, oz, dx, dy, dz, aa=None):
    cx, cy, cz = g[0], g[1], g[2]
    w2, h2 = g[12], g[13]
    if aa is not None:
        # axis-aligned frame: component selection, bit-identical to the
        # generic formula below (the dropped terms are exact *0 / +0)
        nax, nsg, uax, vax = aa
        o, d, c = (ox, oy, oz), (dx, dy, dz), (cx, cy, cz)
        ndd = d[nax] if nsg > 0 else -d[nax]
        ndd = torch.where(ndd == 0.0, ndd + 1e-4, ndd)
        ndco = (c[nax] - o[nax]) if nsg > 0 else (o[nax] - c[nax])
        tt = ndco / ndd
        uu = o[uax] + d[uax] * tt - c[uax]
        vv = o[vax] + d[vax] * tt - c[vax]
    else:
        ux, uy, uz = g[3], g[4], g[5]
        vx, vy, vz = g[6], g[7], g[8]
        nx, ny, nz = g[9], g[10], g[11]
        ndd = nx * dx + ny * dy + nz * dz
        ndd = torch.where(ndd == 0.0, ndd + 1e-4, ndd)
        ndco = nx * (cx - ox) + ny * (cy - oy) + nz * (cz - oz)
        tt = ndco / ndd
        mx, my, mz = ox + dx * tt - cx, oy + dy * tt - cy, oz + dz * tt - cz
        uu = ux * mx + uy * my + uz * mz
        vv = vx * mx + vy * my + vz * mz
    inside = (uu.abs() <= w2) & (vv.abs() <= h2) & (ndco * ndd > 0)
    return torch.where(inside, tt, FARAWAY), torch.where(ndd < 0, 1.0, -1.0)


def _isect_box(g, ox, oy, oz, dx, dy, dz):
    b = g[:9]
    ol = [b[3 * i] * ox + b[3 * i + 1] * oy + b[3 * i + 2] * oz for i in range(3)]
    dl = [b[3 * i] * dx + b[3 * i + 1] * dy + b[3 * i + 2] * dz for i in range(3)]
    tmin = tmax = None
    for i in range(3):
        inv = 1.0 / dl[i]
        t1 = (g[9 + i] - ol[i]) * inv
        t2 = (g[12 + i] - ol[i]) * inv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    miss = (tmax < 0) | (tmin > tmax)
    inside = tmin < 0
    t = torch.where(miss, FARAWAY, torch.where(inside, tmax, tmin))
    return t, torch.where(inside, -1.0, 1.0)


def _isect_tri(g, ox, oy, oz, dx, dy, dz):
    """Triangle: row [p1, p2, p3, unit normal, n31, n12, n23]
    (pallas_trace.py:342)."""
    cx = _div(g[0] + g[3] + g[6], 3.0)
    cy = _div(g[1] + g[4] + g[7], 3.0)
    cz = _div(g[2] + g[5] + g[8], 3.0)
    ndd = g[9] * dx + g[10] * dy + g[11] * dz
    ndd = torch.where(ndd == 0.0, ndd + 1e-4, ndd)
    ndco = g[9] * (cx - ox) + g[10] * (cy - oy) + g[11] * (cz - oz)
    tt = ndco / ndd
    mx, my, mz = ox + dx * tt, oy + dy * tt, oz + dz * tt
    inside = ndco * ndd > 0
    for e, p in ((12, 0), (15, 3), (18, 6)):       # n31 at p1, n12 at p2, n23 at p3
        inside = inside & (g[e] * (mx - g[p]) + g[e + 1] * (my - g[p + 1])
                           + g[e + 2] * (mz - g[p + 2]) >= 0)
    return torch.where(inside, tt, FARAWAY), torch.where(ndd < 0, 1.0, -1.0)


def _isect_disc(g, ox, oy, oz, dx, dy, dz):
    """Disc / annulus: row [center, normal, u, v, r_out, r_in]
    (pallas_trace.py:369)."""
    cx, cy, cz = g[0], g[1], g[2]
    nx, ny, nz = g[3], g[4], g[5]
    r_out, r_in = g[12], g[13]
    ndd = nx * dx + ny * dy + nz * dz
    ndd = torch.where(ndd == 0.0, ndd + 1e-4, ndd)
    ndco = nx * (cx - ox) + ny * (cy - oy) + nz * (cz - oz)
    tt = ndco / ndd
    mx, my, mz = ox + dx * tt - cx, oy + dy * tt - cy, oz + dz * tt - cz
    rho2 = mx * mx + my * my + mz * mz
    hit = (rho2 <= r_out * r_out) & (rho2 >= r_in * r_in) & (ndco * ndd > 0)
    return torch.where(hit, tt, FARAWAY), torch.where(ndd < 0, 1.0, -1.0)


def _cyl_local(g, px, py, pz):
    """A point in the cylinder's frame: (radial u, axial, radial v)
    (pallas_trace.py:388)."""
    mx, my, mz = px - g[0], py - g[1], pz - g[2]
    return (g[6] * mx + g[7] * my + g[8] * mz,
            g[3] * mx + g[4] * my + g[5] * mz,
            g[9] * mx + g[10] * my + g[11] * mz)


def _isect_cyl(g, ox, oy, oz, dx, dy, dz):
    """Finite, optionally capped cylinder: row [center, axis, u, v,
    radius, half height, capped] (pallas_trace.py:398)."""
    r, hh, cap_on = g[12], g[13], g[14] > 0.5
    lox, loy, loz = _cyl_local(g, ox, oy, oz)
    ldx = g[6] * dx + g[7] * dy + g[8] * dz
    ldy = g[3] * dx + g[4] * dy + g[5] * dz
    ldz = g[9] * dx + g[10] * dy + g[11] * dz
    r2 = r * r
    a_s = torch.clamp_min(ldx * ldx + ldz * ldz, 1e-12)
    hb = lox * ldx + loz * ldz
    c = lox * lox + loz * loz - r2
    disc = hb * hb - a_s * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    side_ok = disc > 0
    ldy_s = torch.where(ldy.abs() < 1e-12, 1e-12, ldy)
    cands = []
    for ts in ((-hb - sq) / a_s, (-hb + sq) / a_s):
        cands.append((ts, side_ok & (ts > 0) & ((loy + ldy * ts).abs() <= hh)))
    for y_plane in (hh, -hh):
        tc = (y_plane - loy) / ldy_s
        xc, zc = lox + ldx * tc, loz + ldz * tc
        cands.append((tc, cap_on & (tc > 0) & (xc * xc + zc * zc <= r2)))
    t = torch.where(cands[0][1], cands[0][0], FARAWAY)
    for tc, ok in cands[1:]:
        t = torch.minimum(t, torch.where(ok, tc, FARAWAY))
    x, y, z = lox + ldx * t, loy + ldy * t, loz + ldz * t
    rho_hat = torch.sqrt(torch.clamp_min((x * x + z * z) / r2, 0.0))
    is_cap = cap_on & (y.abs() / hh >= rho_hat)
    nd = torch.where(is_cap, torch.sign(y) * ldy, x * ldx + z * ldz)
    return t, torch.where(nd < 0, 1.0, -1.0)


_ISECT = {_SPHERE: _isect_sphere, _BOX: _isect_box, _TRI: _isect_tri,
          _DISC: _isect_disc, _CYL: _isect_cyl}


def isect_of(row):
    """The intersector of one object-table row (planes with an
    axis-aligned frame take the component-selection form)."""
    kind = row[OBJ_KIND]
    if kind != _PLANE:
        return _ISECT[kind]
    aa = (None if row[OBJ_AA_N] < 0 else
          (row[OBJ_AA_N], row[OBJ_AA_NSIGN], row[OBJ_AA_U], row[OBJ_AA_V]))
    return lambda g, *a: _isect_plane(g, *a, aa=aa)


def _normal(kind, g, px, py, pz):
    """The raw geometric normal at a hit point (pallas_trace.py:463)."""
    if kind == _SPHERE:
        inv_r = 1.0 / g[3]
        return (px - g[0]) * inv_r, (py - g[1]) * inv_r, (pz - g[2]) * inv_r
    if kind in (_PLANE, _TRI, _DISC):
        j = 3 if kind == _DISC else 9
        return tuple(g[j + k].expand_as(px) for k in range(3))
    if kind == _CYL:
        # side radial, cap axial, classified by the intersector's rule
        r, hh, cap_on = g[12], g[13], g[14] > 0.5
        x, y, z = _cyl_local(g, px, py, pz)
        rho = torch.sqrt(torch.clamp_min(x * x + z * z, 1e-20))
        is_cap = cap_on & (y.abs() / hh >= rho / r)
        sy = torch.sign(y)
        return tuple(torch.where(is_cap, sy * g[3 + k],
                                 (x * g[6 + k] + z * g[9 + k]) / rho)
                     for k in range(3))
    # box: the max-|axis| face normal in the local frame
    b = g[:9]
    mx, my, mz = px - g[15], py - g[16], pz - g[17]
    pl_ = [b[3 * i] * mx + b[3 * i + 1] * my + b[3 * i + 2] * mz for i in range(3)]
    ap = [pl_[i].abs() / g[18 + i] for i in range(3)]
    pmax = torch.maximum(torch.maximum(ap[0], ap[1]), ap[2])
    nl = [torch.where(pmax == ap[i], torch.sign(pl_[i]), 0.0) for i in range(3)]
    return (b[0] * nl[0] + b[3] * nl[1] + b[6] * nl[2],
            b[1] * nl[0] + b[4] * nl[1] + b[7] * nl[2],
            b[2] * nl[0] + b[5] * nl[1] + b[8] * nl[2])


def nearest_hit(isects, geom, ox, oy, oz, dx, dy, dz):
    """(t, orient, object id or -1) of the nearest hit (pallas_trace.py:594)."""
    n = ox.shape[0]
    best_t = torch.full((n,), FARAWAY, dtype=ox.dtype, device=ox.device)
    best_o = torch.ones_like(ox)
    obj = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    for i, isect in enumerate(isects):
        t_i, o_i = isect(geom[i], ox, oy, oz, dx, dy, dz)
        better = t_i < best_t
        best_t = torch.where(better, t_i, best_t)
        best_o = torch.where(better, o_i, best_o)
        obj = torch.where(better, i, obj)
    return best_t, best_o, obj


def hit_normals(rows, geom, obj, px, py, pz):
    """The raw normal of each ray's hit object (zeros where none is hit)."""
    nx = ny = nz = torch.zeros_like(px)
    for i, r in enumerate(rows):
        nxi, nyi, nzi = _normal(r[OBJ_KIND], geom[i], px, py, pz)
        m = obj == i
        nx = torch.where(m, nxi, nx)
        ny = torch.where(m, nyi, ny)
        nz = torch.where(m, nzi, nz)
    return nx, ny, nz


def reflect(dx, dy, dz, nx, ny, nz):
    """The mirror direction, normalised (pallas_trace.py:1025-1028)."""
    ddn = dx * nx + dy * ny + dz * nz
    return _normalize3(dx - nx * 2.0 * ddn, dy - ny * 2.0 * ddn,
                       dz - nz * 2.0 * ddn)


def glossy_lights(tables, shadow, p, nu, n, v, rough, spec_c, on_test=None):
    """Per light, the terms of a glossy hit's direct lighting
    (pallas_trace.py:957-1015): yields (lv, see, p5, sw): the light's
    colour times its falloff, 1 unless a shadow caster blocks it, the
    Schlick power (1 - cos_vh)^5, and the Blinn-Phong weight.

    shadow: [(intersector, geometry row)] of the shadow-casting objects;
    p, nu, n, v: hit point, offset origin, oriented normal, view vector.
    on_test: optional on_test(j, live) called before the test of caster j with
    the lanes no earlier caster has occluded, which are the lanes whose
    kernel loop reaches that test.
    """
    (px, py, pz), (nux, nuy, nuz), (nx, ny, nz), (vx, vy, vz) = p, nu, n, v
    n_dir, n_point, n_spot = tables.n_lights
    rm = torch.clamp_min(rough, 1e-6)
    a_ph = 2.0 / (rm * rm) - 2.0
    for li in range(n_dir + n_point + n_spot):
        L = tables.lights[li]
        if li >= n_dir:                               # point and spot
            wx, wy, wz = L[0] - px, L[1] - py, L[2] - pz
            dist = torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz,
                                              1e-20))
            lx, ly, lz = wx / dist, wy / dist, wz / dist
        else:
            lx, ly, lz = (torch.zeros_like(px) + L[k] for k in range(3))
            dist = torch.full_like(px, SKYBOX_DISTANCE)
        ndl = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
        if li >= n_dir:
            fall = ndl / (dist * dist) * 100.0
            if li >= n_dir + n_point:
                # point falloff times the smooth cone factor
                cos_t = -(lx * L[6] + ly * L[7] + lz * L[8])
                tt = torch.clamp((cos_t - L[10])
                                 / torch.clamp_min(L[9] - L[10], 1e-6), 0.0, 1.0)
                fall = fall * (tt * tt * (3.0 - 2.0 * tt))
            lv = [L[3 + k] * fall for k in range(3)]
        else:
            lv = [L[3 + k] * ndl for k in range(3)]
        occ = torch.zeros_like(px, dtype=torch.bool)
        for j, (isect, g) in enumerate(shadow):
            if on_test is not None:
                on_test(j, ~occ)
            t_s, _ = isect(g, nux, nuy, nuz, lx, ly, lz)
            occ = occ | (t_s < dist)
        see = 1.0 - occ.to(px.dtype)
        hx, hy, hz = _normalize3(lx + vx, ly + vy, lz + vz)
        cos_vh = torch.clamp(vx * hx + vy * hy + vz * hz, 0.0, 1.0)
        p5 = _pow5(1.0 - cos_vh)
        dph = _div(torch.pow(torch.clamp(nx * hx + ny * hy + nz * hz, 0.0, 1.0),
                             a_ph) * (a_ph + 2.0), 2.0 * math.pi)
        denom = 4.0 * torch.clamp((nx * vx + ny * vy + nz * vz) * ndl, 0.001, 1.0)
        sw = torch.where(rough != 0.0, dph / denom * see * spec_c, 0.0)
        yield lv, see, p5, sw


def fresnel_f0(n1r, n1i, n2r, n2i):
    """|n1 - n2|^2 / |n1 + n2|^2, the normal-incidence Fresnel term."""
    return (_cabs2((n1r - n2r, n1i - n2i))
            / torch.clamp_min(_cabs2((n1r + n2r, n1i + n2i)), 1e-20))


def camera_rays(seed, cam_vec, width, height, spp, sampler,
                projection="pinhole"):
    """The camera draws and rays of one chunk (pallas_trace.py:548-566,
    162-236).

    seed: int64 (3,) seed vector.  Returns (idx, (ox, oy, oz, dx, dy, dz),
    sb, counter0): idx the int64 ray indices (sample * n_pix + pixel), sb
    the first diffuse bounce's R2 draws (mix, phi, r2) under "r2" or None,
    counter0 the hash counter of the last raygen draw (4 under "iid", 0
    under "r2").  The thin lens is a no-op under the fisheye, equirect and
    orthographic projections; its draws are taken all the same.
    """
    dev = cam_vec.device
    f32 = torch.float32
    n_pix = width * height
    idx = torch.arange(spp * n_pix, device=dev, dtype=torch.int64)
    pix = idx % n_pix
    py_i = pix // width
    px_i = pix - py_i * width
    cam = [cam_vec[j] for j in range(17)]
    if sampler == "r2":
        su = (idx // n_pix + seed[2]) & lds.M32
        u1, u2, u3, u4, sb_mix, sb_phi, sb_r2 = lds.raygen_draws(
            pix, su, seed[1])
        sb, counter0 = (sb_mix, sb_phi, sb_r2), 0
    else:
        u1, u2, u3, u4 = (hash_uniform(idx, seed[0], c) for c in range(1, 5))
        sb, counter0 = None, 4
    o0x, o0y, o0z, fwx, fwy, fwz, rix, riy, riz, upx, upy, upz = cam[:12]
    cw, ch, lens_r, focal, half_fov = cam[12:17]
    zf = torch.zeros(spp * n_pix, dtype=f32, device=dev)
    if projection in ("fisheye", "equirect"):
        col, grw = px_i.to(f32), py_i.to(f32)
        if projection == "fisheye":
            # circular equidistant
            m = float(min(width, height))
            xn = _div(2.0 * (col + u1) - width, m)
            yn = _div(height - 2.0 * (grw + u2), m)
            theta = torch.sqrt(xn * xn + yn * yn) * half_fov
            phi = atan2_poly(yn, xn)
            sin_t, cos_t = torch.sin(theta), torch.cos(theta)
            cp, sp = torch.cos(phi), torch.sin(phi)
            d = [cos_t * cam[3 + k] + sin_t * cp * cam[6 + k]
                 + sin_t * sp * cam[9 + k] for k in range(3)]
        else:
            # 360x180: column -> azimuth around the view heading, row ->
            # elevation, directions in world axes
            u_img = _div(col + u1, width)
            el = math.pi * (0.5 - _div(grw + u2, height))
            phi = atan2_poly(fwz, fwx) + (2.0 * math.pi) * (u_img - 0.5)
            rho = torch.cos(el)
            d = [rho * torch.cos(phi), torch.sin(el), rho * torch.sin(phi)]
        return idx, (zf + o0x, zf + o0y, zf + o0z, *d), sb, counter0
    x = ((_div(px_i.to(f32), width - 1) - 0.5) * cw
         + (u1 - 0.5) * _div(cw, width))
    y = ((0.5 - _div(py_i.to(f32), height - 1)) * ch
         + (u2 - 0.5) * _div(ch, height))
    if projection == "orthographic":
        # parallel rays along fwd over the pinhole's focal-plane footprint
        o = [cam[k] + cam[6 + k] * (x * focal) + cam[9 + k] * (y * focal)
             for k in range(3)]
        return idx, (*o, zf + fwx, zf + fwy, zf + fwz), sb, counter0
    r_d = torch.sqrt(u3)
    sp_d, cp_d = sincos_2pi(u4)
    rx = r_d * cp_d * lens_r
    ry = r_d * sp_d * lens_r
    ox = o0x + rix * rx + upx * ry
    oy = o0y + riy * rx + upy * ry
    oz = o0z + riz * rx + upz * ry
    tx = o0x + upx * (y * focal) + rix * (x * focal) + fwx * focal - ox
    ty = o0y + upy * (y * focal) + riy * (x * focal) + fwy * focal - oy
    tz = o0z + upz * (y * focal) + riz * (x * focal) + fwz * focal - oz
    dx, dy, dz = _normalize3(tx, ty, tz)
    return idx, (ox, oy, oz, dx, dy, dz), sb, counter0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def solid_trace_chunk_reference(seed_vec, tables: SolidTables, cam_vec, width,
                                height, spp, max_bounces, split_k=0,
                                sampler="r2", projection="pinhole",
                                counts=None):
    """Trace one chunk with plain tensor operations (any device).

    seed_vec: int32 (3,) [chunk seed, R2 rotation seed, global index of
    the chunk's first sample]; cam_vec: float32 (17,) (core/camera.py);
    tables: SolidTables on the same device.
    counts: optional dict that receives the events the kernel would run
    on these inputs (ray-bounces, intersection tests and normals by kind,
    shading by material, lights, shadow tests, draws; see `tally`); it
    changes nothing else, and the render path never passes it.
    Returns (L (spp*H*W, 3) float32, rays traced int64 scalar tensor).
    """
    check_slice(tables, split_k, sampler, projection)
    dev = cam_vec.device
    f32 = torch.float32
    n_pix = width * height
    n = spp * n_pix
    seed = seed_vec.to(torch.int64)
    idx, (ox, oy, oz, dx, dy, dz), sb, draws = camera_rays(
        seed, cam_vec, width, height, spp, sampler, projection)
    sb_mix, sb_phi, sb_r2 = sb if sb is not None else (None, None, None)

    consts = tables.consts
    ambient = [consts[k] for k in range(3)]
    scene_nre = [consts[3 + k] for k in range(3)]
    scene_nim = [consts[6 + k] for k in range(3)]
    zeros = torch.zeros(n, dtype=f32, device=dev)
    Lx, Ly, Lz = zeros, zeros, zeros
    bx = by = bz = torch.ones(n, dtype=f32, device=dev)
    nre = [zeros + scene_nre[k] for k in range(3)]
    nim = [zeros + scene_nim[k] for k in range(3)]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    dcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    scnt = torch.zeros(n, dtype=torch.int64, device=dev)
    # deterministic Fresnel-split pattern: the sample index mod 2^split_k
    pattern = (idx // n_pix) % (1 << split_k)
    count = torch.zeros((), dtype=torch.int64, device=dev)

    rows = tables.obj_rows
    geom = [tables.geom[i] for i in range(len(rows))]
    isects = [isect_of(r) for r in rows]
    shadow = [(isects[i], geom[i]) for i, r in enumerate(rows) if r[OBJ_SHADOW]]
    obj_t = tables.obj.to(torch.int64)
    mat_type_of = obj_t[:, OBJ_MAT_TYPE]
    slot_of = obj_t[:, OBJ_MAT_SLOT]
    maxd_of = obj_t[:, OBJ_MAX_DEPTH]
    split_of = obj_t[:, OBJ_MC] == 0
    hu_of = obj_t[:, OBJ_HU1]
    hu_maxd = hu_groups(rows)
    types = {r[OBJ_MAT_TYPE] for r in rows}
    K = tables.n_is_targets
    lam = WAVELENGTHS_NM
    if counts is not None:
        kinds = [kind_key(r) for r in rows]
        shadow_kinds = [kinds[i] for i, r in enumerate(rows) if r[OBJ_SHADOW]]
        tally(counts, "camera_rays", n)
        tally(counts, "r2_draws" if sampler == "r2" else "draws",
              (7 if sampler == "r2" else 4) * n)

    for bounce in range(max_bounces):
        last = bounce == max_bounces - 1
        t, orient, obj = nearest_hit(isects, geom, ox, oy, oz, dx, dy, dz)
        hit = alive & ~(t >= MISS_THRESHOLD)
        count = count + alive.sum()
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        obj_c = obj.clamp(min=0)
        mt = mat_type_of[obj_c]
        slot = slot_of[obj_c]
        if counts is not None:
            # what the kernel's thread does for this bounce: every object's
            # test, then on a hit the emissive add and stop, or the normal
            # (not on the last bounce, unless glossy) and the shading
            lanes = int(alive.sum())
            tally(counts, "ray_bounces", lanes)
            tally(counts, "warp_bounces", live_warps(alive))
            tally_tests(counts, "tests", lanes, kinds)
            tally(counts, "hits", hit)
            tally(counts, "emissive", hit & (mt == MAT_EMISSIVE))
            tally(counts, "zero_add", hit & ((mt == MAT_DIFFUSE)
                                             | (mt == MAT_REFRACTIVE)))
            shaded = hit & (mt != MAT_EMISSIVE)
            if last:
                shaded = shaded & (mt == MAT_GLOSSY)
            tally_normals(counts, shaded, obj_t[obj_c, OBJ_KIND], rows)

        add = [zeros, zeros, zeros]
        if MAT_EMISSIVE in types:
            g = hit & (mt == MAT_EMISSIVE)
            col = tables.emi[torch.where(g, slot, 0)]
            add = [torch.where(g, col[:, k], 0.0) for k in range(3)]
        glossy = MAT_GLOSSY in types
        if last and not glossy:
            # the last bounce's continuation is dead, and it takes no draws
            Lx = Lx + torch.where(hit, bx * add[0], 0.0)
            Ly = Ly + torch.where(hit, by * add[1], 0.0)
            Lz = Lz + torch.where(hit, bz * add[2], 0.0)
            break

        nx, ny, nz = hit_normals(rows, geom, obj, px, py, pz)
        nx, ny, nz = nx * orient, ny * orient, nz * orient
        eps = 1e-6 * torch.clamp_min(
            torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs())), 1.0)

        new_alive = torch.zeros(n, dtype=torch.bool, device=dev)
        bmul = [torch.ones(n, dtype=f32, device=dev) for _ in range(3)]
        ndx, ndy, ndz = dx, dy, dz
        nox, noy, noz = px, py, pz
        new_nre, new_nim = list(nre), list(nim)
        inc_d = torch.zeros(n, dtype=torch.bool, device=dev)
        if not last:
            # six draws a bounce, then one per merged dispersive group that
            # shades this bounce, in group order (pallas_trace.py:658, 859)
            ru = [hash_uniform(idx, seed[0], draws + j + 1) for j in range(6)]
            active = [j for j, md in enumerate(hu_maxd) if bounce < md]
            hu = zeros
            for a, j in enumerate(active):
                hu = torch.where(hu_of[obj_c] == j,
                                 hash_uniform(idx, seed[0], draws + 7 + a), hu)
            draws += 6 + len(active)

        if glossy:
            # direct light on every bounce, the last included; the mirror
            # continuation below the depth cap (pallas_trace.py:944-1042)
            g = hit & (mt == MAT_GLOSSY)
            prm = tables.glo[torch.where(g, slot, 0)]
            rough, spec_c, diff_c = prm[:, 9], prm[:, 10], prm[:, 11]
            g_re = [prm[:, 3 + k] for k in range(3)]
            g_im = [prm[:, 6 + k] for k in range(3)]
            dc = [prm[:, k] * diff_c for k in range(3)]
            nux, nuy, nuz = px + nx * eps, py + ny * eps, pz + nz * eps
            v = (-dx, -dy, -dz)
            acc = [ambient[k] * dc[k] for k in range(3)]
            F0 = [fresnel_f0(nre[k], nim[k], g_re[k], g_im[k]) for k in range(3)]
            tests = None
            if counts is not None:
                tally(counts, "glossy", g)
                for name, m in zip(("dir", "point", "spot"), tables.n_lights):
                    tally(counts, f"light_{name}", m * int(g.sum()))
                tests = lambda j, live: tally(
                    counts, f"shadow_{shadow_kinds[j]}", g & live)
            for lv, see, p5, sw in glossy_lights(
                    tables, shadow, (px, py, pz), (nux, nuy, nuz),
                    (nx, ny, nz), v, rough, spec_c, on_test=tests):
                for k in range(3):
                    acc[k] = acc[k] + dc[k] * lv[k] * see
                    acc[k] = acc[k] + (F0[k] + (1.0 - F0[k]) * p5) * sw * lv[k]
            add = [torch.where(g, acc[k], add[k]) for k in range(3)]
            if not last:
                gc = g & (bounce < maxd_of[obj_c])
                if counts is not None:
                    tally(counts, "glossy_cont", gc)
                cos_vn = torch.clamp(v[0] * nx + v[1] * ny + v[2] * nz, 0.0, 1.0)
                p5r = _pow5(1.0 - cos_vn)
                rlx, rly, rlz = reflect(dx, dy, dz, nx, ny, nz)
                for k in range(3):
                    F0s = fresnel_f0(scene_nre[k], scene_nim[k], g_re[k], g_im[k])
                    bmul[k] = torch.where(gc, F0s + (1.0 - F0s) * p5r, bmul[k])
                ndx = torch.where(gc, rlx, ndx)
                ndy = torch.where(gc, rly, ndy)
                ndz = torch.where(gc, rlz, ndz)
                nox = torch.where(gc, nux, nox)
                noy = torch.where(gc, nuy, noy)
                noz = torch.where(gc, nuz, noz)
                new_alive = new_alive | gc

        Lx = Lx + torch.where(hit, bx * add[0], 0.0)
        Ly = Ly + torch.where(hit, by * add[1], 0.0)
        Lz = Lz + torch.where(hit, bz * add[2], 0.0)
        if last:
            break

        if MAT_DIFFUSE in types:
            g = hit & (mt == MAT_DIFFUSE)
            prm = tables.dif[torch.where(g, slot, 0)]
            col = [prm[:, k] for k in range(3)]
            aw = prm[:, 3]
            nux, nuy, nuz = px + nx * eps, py + ny * eps, pz + nz * eps
            ax_u, ax_v = _orthobasis(nx, ny, nz)
            u_phi1, u_r21, u_phi2, u_r22, u_mixv = ru[0], ru[1], ru[3], ru[4], ru[5]
            if sb_mix is not None:
                # the R2 draws replace the hash draws at the first diffuse bounce
                fd = dcnt == 0
                u_phi1 = torch.where(fd, sb_phi, u_phi1)
                u_r21 = torch.where(fd, sb_r2, u_r21)
                u_phi2 = torch.where(fd, sb_phi, u_phi2)
                u_r22 = torch.where(fd, sb_r2, u_r22)
                u_mixv = torch.where(fd, sb_mix, u_mixv)
            r2 = u_r21
            zc = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
            sr2 = torch.sqrt(r2)
            sphi, cphi = sincos_2pi(u_phi1)
            xc, yc = cphi * sr2, sphi * sr2
            cdx = ax_u[0] * xc + ax_v[0] * yc + nx * zc
            cdy = ax_u[1] * xc + ax_v[1] * yc + ny * zc
            cdz = ax_u[2] * xc + ax_v[2] * yc + nz * zc
            if K > 0:
                # spherical-cap sample toward a uniformly picked target
                pick = torch.clamp_max((ru[2] * K).to(torch.int32), K - 1)
                wxs, cms = [], []
                for kk in range(K):
                    tcx, tcy, tcz, tr = (tables.is_tab[kk, j] for j in range(4))
                    wx, wy, wz = tcx - nux, tcy - nuy, tcz - nuz
                    dist = torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz,
                                                      1e-20))
                    wx, wy, wz = wx / dist, wy / dist, wz / dist
                    sin_m = torch.clamp(tr / dist, 0.0, 1.0)
                    cms.append(torch.sqrt(torch.clamp_min(1.0 - sin_m * sin_m, 0.0)))
                    wxs.append((wx, wy, wz))
                swx, swy, swz = wxs[0]
                scm = cms[0]
                for kk in range(1, K):
                    m = pick == kk
                    swx = torch.where(m, wxs[kk][0], swx)
                    swy = torch.where(m, wxs[kk][1], swy)
                    swz = torch.where(m, wxs[kk][2], swz)
                    scm = torch.where(m, cms[kk], scm)
                cu, cv = _orthobasis(swx, swy, swz)
                zq = 1.0 + u_r22 * (scm - 1.0)
                sq = torch.sqrt(torch.clamp_min(1.0 - zq * zq, 0.0))
                sphi2, cphi2 = sincos_2pi(u_phi2)
                cps, sps = cphi2 * sq, sphi2 * sq
                qdx = cu[0] * cps + cv[0] * sps + swx * zq
                qdy = cu[1] * cps + cv[1] * sps + swy * zq
                qdz = cu[2] * cps + cv[2] * sps + swz * zq
                use_cos = u_mixv < aw
                sdx = torch.where(use_cos, cdx, qdx)
                sdy = torch.where(use_cos, cdy, qdy)
                sdz = torch.where(use_cos, cdz, qdz)
                ndl = torch.clamp(sdx * nx + sdy * ny + sdz * nz, 0.0, 1.0)
                pdf_cos = _div(ndl, math.pi)
                pdf_cap = zeros
                for kk in range(K):
                    cosk = sdx * wxs[kk][0] + sdy * wxs[kk][1] + sdz * wxs[kk][2]
                    pdf_cap = pdf_cap + torch.where(
                        cosk > cms[kk], 1.0 / ((1.0 - cms[kk]) * 2.0 * math.pi),
                        0.0)
                pdf_cap = _div(pdf_cap, K)
                pdf = aw * pdf_cos + (1.0 - aw) * pdf_cap
            else:
                sdx, sdy, sdz = cdx, cdy, cdz
                ndl = torch.clamp(sdx * nx + sdy * ny + sdz * nz, 0.0, 1.0)
                pdf = _div(ndl, math.pi)
            w = _div(ndl / torch.clamp_min(pdf, 1e-9), math.pi)
            gc = g & (dcnt < 2)
            if counts is not None:
                # a diffuse hit past the diffuse depth ends the kernel's path
                tally(counts, "diffuse", gc)
                if K > 0:
                    tally(counts, "diffuse_pick", gc)
                    tally(counts, "diffuse_caps", K * int(gc.sum()))
                    tally(counts, "diffuse_cap", gc & ~use_cos)
                first = (gc & (dcnt == 0)) if sb_mix is not None else gc & False
                tally(counts, "draws", int(first.sum()) * int(K > 0)
                      + int((gc & ~first).sum()) * (6 if K > 0 else 2))
            for k in range(3):
                bmul[k] = torch.where(gc, col[k] * w, bmul[k])
            ndx = torch.where(gc, sdx, ndx)
            ndy = torch.where(gc, sdy, ndy)
            ndz = torch.where(gc, sdz, ndz)
            nox = torch.where(gc, nux, nox)
            noy = torch.where(gc, nuy, noy)
            noz = torch.where(gc, nuz, noz)
            inc_d = inc_d | gc
            new_alive = new_alive | gc

        if MAT_REFRACTIVE in types:
            # alive rays at bounce b have taken b transitions, so the depth
            # cap is a per-object test on the bounce number
            g = hit & (mt == MAT_REFRACTIVE) & (bounce < maxd_of[obj_c])
            prm = tables.refr[torch.where(g, slot, 0)]
            cos_i = -(dx * nx + dy * ny + dz * nz)
            entering = orient > 0
            F, n2r_l, n2i_l = [], [], []
            for k in range(3):
                n1 = (nre[k], nim[k])
                n2r = torch.where(entering, prm[:, k], scene_nre[k])
                n2i = torch.where(entering, prm[:, 3 + k], scene_nim[k])
                n2 = (n2r, n2i)
                ratio = _cdiv(n1, n2)
                r2 = _cmul(ratio, ratio)
                s2 = 1.0 - cos_i * cos_i
                cos_t = _csqrt((1.0 - r2[0] * s2, -r2[1] * s2))
                a = (n1[0] * cos_i, n1[1] * cos_i)
                bt = _cmul(n2, cos_t)
                at = _cmul(n1, cos_t)
                bb = (n2[0] * cos_i, n2[1] * cos_i)
                F_per = (_cabs2((a[0] - bt[0], a[1] - bt[1]))
                         / torch.clamp_min(_cabs2((a[0] + bt[0], a[1] + bt[1])),
                                           1e-30))
                F_par = (_cabs2((bb[0] - at[0], bb[1] - at[1]))
                         / torch.clamp_min(_cabs2((at[0] + bb[0], at[1] + bb[1])),
                                           1e-30))
                F.append((F_per + F_par) * 0.5)
                n2r_l.append(n2r)
                n2i_l.append(n2i)
            T = [1.0 - F[k] for k in range(3)]
            rat = [nre[k] / torch.clamp_min(n2r_l[k], 1e-9) for k in range(3)]
            ratio_avg = _div(rat[0] + rat[1] + rat[2], 3.0)
            # dispersion: transmitted paths refract at one uniformly chosen
            # channel's IoR and carry 3x that channel (pallas_trace.py:853)
            dsp = hu_of[obj_c] >= 0
            h0 = hu < (1.0 / 3.0)
            h1 = (hu >= (1.0 / 3.0)) & (hu < (2.0 / 3.0))
            hero = (h0, h1, ~(h0 | h1))
            ratio_avg = torch.where(
                dsp, torch.where(h0, rat[0], torch.where(h1, rat[1], rat[2])),
                ratio_avg)
            sin2t = ratio_avg * ratio_avg * (1.0 - cos_i * cos_i)
            non_tir = sin2t <= 1.0
            croot = torch.sqrt(1.0 - torch.clamp(sin2t, 0.0, 1.0))
            rfx = dx * ratio_avg + nx * (ratio_avg * cos_i - croot)
            rfy = dy * ratio_avg + ny * (ratio_avg * cos_i - croot)
            rfz = dz * ratio_avg + nz * (ratio_avg * cos_i - croot)
            rfx, rfy, rfz = _normalize3(rfx, rfy, rfz)
            rlx, rly, rlz = reflect(dx, dy, dz, nx, ny, nz)
            T_avg = _div(T[0] + T[1] + T[2], 3.0)
            p_refr = torch.where(non_tir, torch.clamp(T_avg, 0.0, 1.0), 0.0)
            take_refr = (ru[0] < p_refr) & non_tir
            # deterministic split: the pattern bit picks the branch, weight
            # 2F / 2T, for groups without mc (pallas_trace.py:902-926)
            det = split_of[obj_c] & (scnt < split_k)
            bit = ((pattern >> scnt) & 1) == 1
            take_refr = (det & bit & non_tir) | (~det & take_refr)
            gc = g & ~(det & bit & ~non_tir)
            scnt = scnt + (gc & det).to(torch.int64)
            if counts is not None:
                tally(counts, "refractive", g)
                tally(counts, "dispersive", g & dsp)
                tally(counts, "draws", g)
                tally(counts, "draws", g & dsp)
            for k in range(3):
                absorb = torch.exp(nim[k] * ((-4.0 * math.pi / lam[k]) * 1e9 * t))
                w_r = torch.where(det, 2.0 * T[k],
                                  T[k] / torch.clamp_min(p_refr, 1e-9))
                w_l = torch.where(det, 2.0 * F[k],
                                  F[k] / torch.clamp_min(1.0 - p_refr, 1e-9))
                w_r = w_r * torch.where(dsp, torch.where(hero[k], 3.0, 0.0), 1.0)
                bmul[k] = torch.where(gc, absorb * torch.where(take_refr, w_r, w_l),
                                      bmul[k])
                new_nre[k] = torch.where(gc & take_refr, n2r_l[k], new_nre[k])
                new_nim[k] = torch.where(gc & take_refr, n2i_l[k], new_nim[k])
            ndx = torch.where(gc, torch.where(take_refr, rfx, rlx), ndx)
            ndy = torch.where(gc, torch.where(take_refr, rfy, rly), ndy)
            ndz = torch.where(gc, torch.where(take_refr, rfz, rlz), ndz)
            sgn = torch.where(take_refr, -1.0, 1.0)
            nox = torch.where(gc, px + nx * eps * sgn, nox)
            noy = torch.where(gc, py + ny * eps * sgn, noy)
            noz = torch.where(gc, pz + nz * eps * sgn, noz)
            new_alive = new_alive | gc

        bx = torch.where(new_alive, bx * bmul[0], bx)
        by = torch.where(new_alive, by * bmul[1], by)
        bz = torch.where(new_alive, bz * bmul[2], bz)
        ox = torch.where(new_alive, nox, ox)
        oy = torch.where(new_alive, noy, oy)
        oz = torch.where(new_alive, noz, oz)
        dx = torch.where(new_alive, ndx, dx)
        dy = torch.where(new_alive, ndy, dy)
        dz = torch.where(new_alive, ndz, dz)
        for k in range(3):
            nre[k] = torch.where(new_alive, new_nre[k], nre[k])
            nim[k] = torch.where(new_alive, new_nim[k], nim[k])
        dcnt = dcnt + (new_alive & inc_d).to(torch.int32)
        alive = new_alive

    return torch.stack([Lx, Ly, Lz], dim=1), count


# ---------------------------------------------------------------------------
# the CUDA kernel: launch (ops/cuda_build.py builds and binds it)
# ---------------------------------------------------------------------------

def _smem_bytes(tables):
    """Shared memory a block of the kernel takes for the scene tables."""
    return 4 * (len(tables.obj_rows) * (24 + OBJ_COLS) + sum(
        getattr(tables, k).numel() for k in ("dif", "glo", "refr", "emi"))
        + 11 * sum(tables.n_lights) + 4 * max(tables.n_is_targets, 1) + 16 + 17 + 3)


def kernel_info(tables, lib=None):
    """The kernel as built and as the current card holds it with these
    tables: {registers, local_bytes (stack and spills a thread),
    blocks_per_sm, sms, block, min_blocks, refill_min, refr_min,
    smem_optin_max (the card's opt-in maximum of shared memory a block),
    smem (the bytes these tables take, opted in past 48 KB)}."""
    info = (ctypes.c_int * 9)()
    smem = _smem_bytes(tables)
    err = (lib or load_library()).solid_trace_info(smem, info)
    if err != 0:
        raise RuntimeError(f"solid_trace_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "sms", "block",
                     "min_blocks", "refill_min", "refr_min", "smem_optin_max"),
                    info)) | {"smem": smem}


def _launch(seed_vec, tables, cam_vec, width, height, spp, max_bounces,
            sampler, split_k=0, projection="pinhole", lane_stats=None, lib=None):
    """Launch the kernel on the current stream; returns (L, rays traced).
    lane_stats: None, or a zeroed int64 (2,) tensor on the device that
    receives the kernel's lane-iterations with a ray and all its
    lane-iterations (probes/dead_bounce.py); lib: the library to launch
    from (cuda_build.load_library() unless given)."""
    dev = cam_vec.device
    f32, i32 = torch.float32, torch.int32
    n_obj = len(tables.obj_rows)
    check_tensor("seed_vec", seed_vec, i32, (3,), dev)
    check_tensor("cam_vec", cam_vec, f32, (17,), dev)
    check_tensor("geom", tables.geom, f32, (n_obj, 24), dev)
    check_tensor("obj", tables.obj, i32, (n_obj, OBJ_COLS), dev)
    cols = dict(dif=4, glo=12, refr=6, emi=3, lights=11, is_tab=4)
    for name, c in cols.items():
        check_tensor(name, getattr(tables, name), f32, (None, c), dev)
    check_tensor("consts", tables.consts, f32, (16,), dev)
    K = tables.n_is_targets
    n_l = sum(tables.n_lights)
    if K > tables.is_tab.shape[0] or n_l > tables.lights.shape[0]:
        raise ValueError("is_tab or lights has fewer rows than the scene says")
    rows_of = {MAT_DIFFUSE: tables.dif.shape[0], MAT_GLOSSY: tables.glo.shape[0],
               MAT_REFRACTIVE: tables.refr.shape[0],
               MAT_EMISSIVE: tables.emi.shape[0]}
    for r in tables.obj_rows:
        if not 0 <= r[OBJ_MAT_SLOT] < rows_of[r[OBJ_MAT_TYPE]]:
            raise ValueError(f"object row {r} names a missing material slot")
    hu_maxd = hu_groups(tables.obj_rows)
    if len(hu_maxd) > MAX_HU_GROUPS:
        raise ValueError(f"{len(hu_maxd)} dispersive groups; the kernel takes "
                         f"at most {MAX_HU_GROUPS}")
    smem = _smem_bytes(tables)
    if smem > SMEM_OPTIN_MAX:
        # route() sends such scenes to the wavefront before any work
        raise ValueError(
            f"scene tables need {smem} bytes of shared memory; the kernel "
            f"takes at most {SMEM_OPTIN_MAX} (route() gates this)")
    n = spp * width * height
    if not (width >= 1 and height >= 1 and spp >= 1 and max_bounces >= 1
            and n < 2 ** 31):
        raise ValueError(f"bad chunk shape {spp}x{height}x{width}, "
                         f"max_bounces {max_bounces}")
    if lane_stats is not None:
        check_tensor("lane_stats", lane_stats, torch.int64, (2,), dev)
    L = torch.empty((n, 3), dtype=f32, device=dev)
    # rays traced, then the persistent grid's work counter (the next ray
    # index), zeroed on the launch's stream
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = lib or load_library()
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    rows = lambda t: t.shape[0]
    hu = (ctypes.c_int * MAX_HU_GROUPS)(*hu_maxd)
    err = lib.solid_trace_launch(
        p(seed_vec), p(cam_vec), p(tables.geom), p(tables.obj), n_obj,
        p(tables.dif), rows(tables.dif), p(tables.glo), rows(tables.glo),
        p(tables.refr), rows(tables.refr), p(tables.emi), rows(tables.emi),
        p(tables.lights), n_l, *tables.n_lights, p(tables.is_tab), K,
        p(tables.consts), width, height, spp, max_bounces,
        int(sampler == "iid"), split_k, PROJECTIONS[projection],
        hu, len(hu_maxd), p(L), p(counters), p(counters[1:]),
        None if lane_stats is None else p(lane_stats),
        stream_of(dev))
    if err != 0:
        raise RuntimeError(f"solid_trace kernel launch failed: CUDA error {err}")
    return L, counters[0]


def solid_trace_chunk(seed_vec, tables: SolidTables, cam_vec, width, height,
                      spp, max_bounces, split_k=0, sampler="r2",
                      projection="pinhole"):
    """Trace one chunk: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Arguments and result as
    `solid_trace_chunk_reference`; `solid_trace_chunk.launches` counts
    kernel launches."""
    if cam_vec.device.type == "cpu":
        return solid_trace_chunk_reference(seed_vec, tables, cam_vec, width,
                                           height, spp, max_bounces, split_k,
                                           sampler, projection)
    if cam_vec.device.type != "cuda":
        raise ValueError(f"no solid kernel for device {cam_vec.device}")
    check_slice(tables, split_k, sampler, projection)
    out = _launch(seed_vec, tables, cam_vec, width, height, spp, max_bounces,
                  sampler, split_k, projection)
    solid_trace_chunk.launches += 1
    return out


solid_trace_chunk.launches = 0
