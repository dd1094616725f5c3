"""The record path: a CUDA kernel that traces, fetches the textures and
integrates one chunk of a textured scene, and its plain version.

Counterpart of raytracer_tpu/ops/pallas_record.py: `pallas_record_chunk`,
the Pallas kernel `_make_record_kernel` followed by the XLA replay
(`_replay`, `_decode_words`).  The TPU splits a chunk in two passes,
because a Pallas kernel cannot gather per lane from HBM and sampling
directions never depend on texture values:

1. **record**: trace every path and write, per (bounce, ray), an int32
   word `gid | branch_flag << 16` and 12 floats `[u, v, cos_i,
   add_base(3), add_texcoef(3), beta_base(3)]`;
2. **replay**: fetch the textures at the recorded uvs and integrate
   L = sum_b beta_b * add_b.

The CUDA kernel (csrc/record_trace.cu) does both in one pass: each thread
fetches its hit's texels from the atlas through the per-group fetch table
(core/compile.py `fetch_table`) and folds the bounce into its radiance in
registers, so no record reaches device memory.  The plain version keeps
the two passes:

- `record_trace_chunk_reference` is the plain version of the record pass:
  vectorised over rays and masked per shading group, as the Pallas kernel
  is.  It runs on any device; `replay` (ops/replay.py) is the second pass.
- `record_trace_chunk` computes one chunk; Scene.render calls it.  For CPU
  tensors it runs the plain version (records, then replay); for CUDA
  tensors it launches the kernel, or raises.

Both follow the JAX kernel draw for draw, in its flat (sample-major) lane
order, for every object kind (spheres, planes, boxes, discs, cylinders,
triangles), every projection and spectral dispersion.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.compile import (FT_BIL, FT_FCOLS, FT_ICOLS, FT_MODE,
                            FT_MODE_COMP, FT_MODE_TWO, FT_MODE_UV, FT_SEC,
                            FT_USE, FT_USE_NONE, KIND_CODES, OBJ_COLS,
                            OBJ_KIND, OBJ_UV, SceneStatic, SolidTables,
                            dispersive_groups, shading_groups)
from ..materials.base import (MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV, MAT_GLOSSY,
                              MAT_REFRACTIVE, MAT_THINFILM)
from ..utils.constants import MISS_THRESHOLD, WAVELENGTHS_NM
from .cuda_build import (SMEM_OPTIN_MAX, check_tensor, load_library,
                         stream_of)
from .replay import replay
from .solid_trace import (PROJECTIONS, _cabs2, _cdiv, _cmul,
                          _csqrt, _cyl_local, _div, _normal, _normalize3,
                          _orthobasis, _pow5, asin_poly, atan2_poly,
                          camera_rays, check_args, fresnel_f0, glossy_lights,
                          hash_uniform, isect_of, kind_key, nearest_hit,
                          reflect, tally, tally_normals, tally_tests)

_SPHERE, _PLANE, _BOX, _TRI, _DISC, _CYL = (
    KIND_CODES[k] for k in ("sphere", "plane", "box", "tri", "disc", "cyl"))
_REC_TYPES = {MAT_EMISSIVE, MAT_GLOSSY, MAT_DIFFUSE, MAT_REFRACTIVE,
              MAT_THINFILM, MAT_ENV}


def replay_rounds(static: SceneStatic):
    """Gather rounds of the replay (pallas_record.py:66): 1, or 2 when a
    thin-film slot past TF_COMP_LIMIT needs the dependent noise -> LUT
    fetch."""
    _, order = shading_groups(static.obj_records)
    comp = {r.slot for r in static.thinfilm_comp}
    return 1 + int(any(mt == MAT_THINFILM and slot not in comp
                       for (mt, slot, _d, _mc) in order))


def check_slice(static: SceneStatic, split_k, sampler, projection):
    """Raise ValueError for arguments or material types the record kernel
    does not take."""
    check_args(sampler, projection, split_k)
    bad = set(static.mat_types_present) - _REC_TYPES
    if bad:
        raise ValueError(f"material types {sorted(bad)} have no record shading")


def _uv_for(kind, g, px, py, pz, nx_r, ny_r, nz_r):
    """Texture uv per object kind (pallas_record.py:76-148); n*_r is the
    raw geometric normal (before the orientation flip)."""
    if kind == _SPHERE:
        phi = atan2_poly(nz_r, nx_r)
        th = asin_poly(ny_r)
        return (_div(phi + math.pi, 2.0 * math.pi),
                _div(th + math.pi / 2.0, math.pi))
    if kind == _PLANE:
        mx, my, mz = px - g[0], py - g[1], pz - g[2]
        uu = (g[3] * mx + g[4] * my + g[5] * mz) / g[12]
        vv = (g[6] * mx + g[7] * my + g[8] * mz) / g[13]
        return (uu + 1.0) / 2.0 + g[14], (vv + 1.0) / 2.0 + g[15]
    if kind == _DISC:
        # planar over the bounding square
        mx, my, mz = px - g[0], py - g[1], pz - g[2]
        return (((g[6] * mx + g[7] * my + g[8] * mz) / g[12] + 1.0) / 2.0,
                ((g[9] * mx + g[10] * my + g[11] * mz) / g[12] + 1.0) / 2.0)
    if kind == _CYL:
        # side: (azimuth, height); caps: planar
        r, hh, cap_on = g[12], g[13], g[14] > 0.5
        x, y, z = _cyl_local(g, px, py, pz)
        rho = torch.sqrt(torch.clamp_min(x * x + z * z, 1e-20))
        is_cap = cap_on & (y.abs() / hh >= rho / r)
        u_side = _div(atan2_poly(z, x) + math.pi, 2.0 * math.pi)
        v_side = (y / hh + 1.0) / 2.0
        return (torch.where(is_cap, (x / r + 1.0) / 2.0, u_side),
                torch.where(is_cap, (z / r + 1.0) / 2.0, v_side))
    if kind == _TRI:
        # barycentric
        e1 = [g[3 + i] - g[i] for i in range(3)]
        e2 = [g[6 + i] - g[i] for i in range(3)]
        qx, qy, qz = px - g[0], py - g[1], pz - g[2]
        d11 = e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2]
        d12 = e1[0] * e2[0] + e1[1] * e2[1] + e1[2] * e2[2]
        d22 = e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]
        dp1 = qx * e1[0] + qy * e1[1] + qz * e1[2]
        dp2 = qx * e2[0] + qy * e2[1] + qz * e2[2]
        det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
        return (d22 * dp1 - d12 * dp2) / det, (d11 * dp2 - d12 * dp1) / det
    # box: the max-|axis| face, then the cube-cross layout, / 4, / 3
    b = g[:9]
    mx, my, mz = px - g[15], py - g[16], pz - g[17]
    pl_ = [b[3 * i] * mx + b[3 * i + 1] * my + b[3 * i + 2] * mz
           for i in range(3)]
    ap = [pl_[i].abs() / g[18 + i] for i in range(3)]
    pmax = torch.maximum(torch.maximum(ap[0], ap[1]), ap[2])
    nl = [torch.where(pmax == ap[i], torch.sign(pl_[i]), 0.0) for i in range(3)]
    s = (2.0 * 0.985) / g[18]
    bottom, top = nl[1] == -1.0, nl[1] == 1.0
    right, left = nl[0] == 1.0, nl[0] == -1.0
    front = nl[2] == 1.0
    u = torch.where(right, (pl_[2] * s + 1.0) / 2.0 + 2.0,
        torch.where(left, (-pl_[2] * s + 1.0) / 2.0 + 0.0,
        torch.where(front, (-pl_[0] * s + 1.0) / 2.0 + 3.0,
                    (pl_[0] * s + 1.0) / 2.0 + 1.0)))
    v = torch.where(bottom, (-pl_[2] * s + 1.0) / 2.0 + 0.0,
        torch.where(top, (pl_[2] * s + 1.0) / 2.0 + 2.0,
                    (pl_[1] * s + 1.0) / 2.0 + 1.0))
    return u / 4.0, _div(v, 3.0)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def record_trace_chunk_reference(seed_vec, static: SceneStatic,
                                 tables: SolidTables, cam_vec, width, height,
                                 spp, max_bounces, split_k=0, sampler="r2",
                                 projection="pinhole", counts=None):
    """Record one chunk with plain tensor operations (any device).

    seed_vec: int32 (3,) [chunk seed, R2 rotation seed, global index of
    the chunk's first sample]; cam_vec: float32 (17,); static / tables:
    the compiled scene, tables on cam_vec's device.
    counts: optional dict that receives the events the kernel would run
    on these inputs (solid_trace.tally); it changes nothing else, and the
    render path never passes it.
    Returns (rec_g (B, n) int32, rec_f (B, 12, n) float32, rays traced
    int64 scalar tensor), B = max_bounces, n = spp * H * W.
    """
    check_slice(static, split_k, sampler, projection)
    dev = cam_vec.device
    f32 = torch.float32
    n_pix = width * height
    n = spp * n_pix
    seed = seed_vec.to(torch.int64)
    idx, (ox, oy, oz, dx, dy, dz), sb, counter0 = camera_rays(
        seed, cam_vec, width, height, spp, sampler, projection)
    sb_mix, sb_phi, sb_r2 = sb if sb is not None else (None, None, None)

    records = static.obj_records
    groups, order = shading_groups(records)
    # one hero-wavelength draw per dispersive group on every bounce, after
    # the six per-bounce draws, in group order (pallas_record.py:333, 475)
    _, hu_of = dispersive_groups(records, static.refr_disp)
    draws_per_bounce = 6 + len(hu_of)
    img_slots = static.image_slots()
    rows = tables.obj_rows
    geom = [tables.geom[i] for i in range(len(rows))]
    isects = [isect_of(r) for r in rows]
    shadow = [(isects[i], geom[i]) for i, r in enumerate(records) if r.shadow]
    consts = tables.consts
    ambient = [consts[k] for k in range(3)]
    scene_nre = [consts[3 + k] for k in range(3)]
    scene_nim = [consts[6 + k] for k in range(3)]
    lam = WAVELENGTHS_NM
    K = static.n_is_targets

    zf = torch.zeros(n, dtype=f32, device=dev)
    nre = [zf + scene_nre[k] for k in range(3)]
    nim = [zf + scene_nim[k] for k in range(3)]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    dcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    scnt = torch.zeros(n, dtype=torch.int64, device=dev)
    pattern = (idx // n_pix) % (1 << split_k) if split_k else None
    count = torch.zeros((), dtype=torch.int64, device=dev)
    rec_g = torch.zeros((max_bounces, n), dtype=torch.int32, device=dev)
    rec_f = torch.zeros((max_bounces, 12, n), dtype=f32, device=dev)
    if counts is not None:
        kinds = [kind_key(r) for r in rows]
        shadow_kinds = [kinds[i] for i, r in enumerate(records) if r.shadow]
        obj_t = tables.obj.to(torch.int64)
        tally(counts, "camera_rays", n)
        tally(counts, "r2_draws" if sampler == "r2" else "draws",
              (7 if sampler == "r2" else 4) * n)
        tally(counts, "records", max_bounces * n)

    for bounce in range(max_bounces):
        t, orient, obj = nearest_hit(isects, geom, ox, oy, oz, dx, dy, dz)
        hit = alive & ~(t >= MISS_THRESHOLD)
        count = count + alive.sum()
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        if counts is not None:
            # every object's test for each live lane; the normal (and uv
            # where the object has one) wherever a test hit, then shading
            lanes = int(alive.sum())
            tally(counts, "ray_bounces", lanes)
            tally_tests(counts, "tests", lanes, kinds)
            tally(counts, "hits", hit)
            obj_c = obj.clamp(min=0)
            tally_normals(counts, alive & (obj >= 0), obj_t[obj_c, OBJ_KIND],
                          rows, obj_t[obj_c, OBJ_UV] != 0)

        nx = ny = nz = uu = vv = zf
        for i, (r, rec) in enumerate(zip(rows, records)):
            nxi, nyi, nzi = _normal(r[OBJ_KIND], geom[i], px, py, pz)
            m = obj == i
            nx = torch.where(m, nxi, nx)
            ny = torch.where(m, nyi, ny)
            nz = torch.where(m, nzi, nz)
            if (rec.mat_type in (MAT_ENV, MAT_THINFILM)
                    or (rec.mat_type, rec.mat_slot) in img_slots):
                ui, vi = _uv_for(r[OBJ_KIND], geom[i], px, py, pz, nxi, nyi, nzi)
                uu = torch.where(m, ui, uu)
                vv = torch.where(m, vi, vv)
        nx, ny, nz = nx * orient, ny * orient, nz * orient
        eps = 1e-6 * torch.clamp_min(
            torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs())), 1.0)

        gid_out = torch.zeros(n, dtype=torch.int32, device=dev)
        cos_out = zf
        addb, addt, betab = [zf] * 3, [zf] * 3, [zf] * 3
        new_alive = torch.zeros(n, dtype=torch.bool, device=dev)
        ndx, ndy, ndz = dx, dy, dz
        nox, noy, noz = px, py, pz
        new_nre, new_nim = list(nre), list(nim)
        inc_d = torch.zeros(n, dtype=torch.bool, device=dev)
        cb = counter0 + draws_per_bounce * bounce
        ru = [hash_uniform(idx, seed[0], cb + j + 1) for j in range(6)]
        rlx, rly, rlz = reflect(dx, dy, dz, nx, ny, nz)

        for key in order:
            mt, slot, maxd, mc = key
            g = torch.zeros(n, dtype=torch.bool, device=dev)
            for i in groups[key]["ids"]:
                g = g | (obj == i)
            g = g & hit
            gid = groups[key]["gid"]
            has_img = (mt, slot) in img_slots
            split = bool(split_k) and not mc

            if counts is not None:
                tally(counts, {MAT_EMISSIVE: "emissive", MAT_ENV: "env",
                               MAT_DIFFUSE: "diffuse", MAT_REFRACTIVE: "refractive",
                               MAT_THINFILM: "thinfilm", MAT_GLOSSY: "glossy"}[mt], g)

            if mt == MAT_EMISSIVE:
                col = tables.emi[slot]
                for k in range(3):
                    if has_img:
                        addt[k] = torch.where(g, 1.0, addt[k])
                    else:
                        addb[k] = torch.where(g, col[k], addb[k])
                gid_out = torch.where(g, gid, gid_out)

            elif mt == MAT_ENV:
                addt = [torch.where(g, 1.0, a) for a in addt]
                gid_out = torch.where(g, gid, gid_out)

            elif mt == MAT_DIFFUSE:
                prm = tables.dif[slot]
                aw = prm[3]
                nux, nuy, nuz = px + nx * eps, py + ny * eps, pz + nz * eps
                ax_u, ax_v = _orthobasis(nx, ny, nz)
                u_phi1, u_r21, u_phi2, u_r22, u_mixv = ru[0], ru[1], ru[3], ru[4], ru[5]
                if sb_mix is not None:
                    # the R2 draws replace the hash draws at the first
                    # diffuse bounce
                    fd = dcnt == 0
                    u_phi1 = torch.where(fd, sb_phi, u_phi1)
                    u_r21 = torch.where(fd, sb_r2, u_r21)
                    u_phi2 = torch.where(fd, sb_phi, u_phi2)
                    u_r22 = torch.where(fd, sb_r2, u_r22)
                    u_mixv = torch.where(fd, sb_mix, u_mixv)
                phi = u_phi1 * (2.0 * math.pi)
                r2 = u_r21
                zc = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
                xc = torch.cos(phi) * torch.sqrt(r2)
                yc = torch.sin(phi) * torch.sqrt(r2)
                cdx = ax_u[0] * xc + ax_v[0] * yc + nx * zc
                cdy = ax_u[1] * xc + ax_v[1] * yc + ny * zc
                cdz = ax_u[2] * xc + ax_v[2] * yc + nz * zc
                if K > 0:
                    pick = torch.clamp_max((ru[2] * K).to(torch.int32), K - 1)
                    wxs, cms = [], []
                    for kk in range(K):
                        tcx, tcy, tcz, tr = (tables.is_tab[kk, j] for j in range(4))
                        wx, wy, wz = tcx - nux, tcy - nuy, tcz - nuz
                        dist = torch.sqrt(torch.clamp_min(
                            wx * wx + wy * wy + wz * wz, 1e-20))
                        wx, wy, wz = wx / dist, wy / dist, wz / dist
                        sin_m = torch.clamp(tr / dist, 0.0, 1.0)
                        cms.append(torch.sqrt(torch.clamp_min(1.0 - sin_m * sin_m, 0.0)))
                        wxs.append((wx, wy, wz))
                    (swx, swy, swz), scm = wxs[0], cms[0]
                    for kk in range(1, K):
                        m = pick == kk
                        swx = torch.where(m, wxs[kk][0], swx)
                        swy = torch.where(m, wxs[kk][1], swy)
                        swz = torch.where(m, wxs[kk][2], swz)
                        scm = torch.where(m, cms[kk], scm)
                    cu, cv = _orthobasis(swx, swy, swz)
                    phi2 = u_phi2 * (2.0 * math.pi)
                    zq = 1.0 + u_r22 * (scm - 1.0)
                    sq = torch.sqrt(torch.clamp_min(1.0 - zq * zq, 0.0))
                    cq, sq2 = torch.cos(phi2) * sq, torch.sin(phi2) * sq
                    qdx = cu[0] * cq + cv[0] * sq2 + swx * zq
                    qdy = cu[1] * cq + cv[1] * sq2 + swy * zq
                    qdz = cu[2] * cq + cv[2] * sq2 + swz * zq
                    use_cos = u_mixv < aw
                    sdx = torch.where(use_cos, cdx, qdx)
                    sdy = torch.where(use_cos, cdy, qdy)
                    sdz = torch.where(use_cos, cdz, qdz)
                    ndl = torch.clamp(sdx * nx + sdy * ny + sdz * nz, 0.0, 1.0)
                    pdf_cap = zf
                    for kk in range(K):
                        cosk = sdx * wxs[kk][0] + sdy * wxs[kk][1] + sdz * wxs[kk][2]
                        pdf_cap = pdf_cap + torch.where(
                            cosk > cms[kk], 1.0 / ((1.0 - cms[kk]) * 2.0 * math.pi),
                            0.0)
                    pdf = aw * _div(ndl, math.pi) + _div((1.0 - aw) * pdf_cap, K)
                else:
                    sdx, sdy, sdz = cdx, cdy, cdz
                    ndl = torch.clamp(sdx * nx + sdy * ny + sdz * nz, 0.0, 1.0)
                    pdf = _div(ndl, math.pi)
                w = _div(ndl / torch.clamp_min(pdf, 1e-9), math.pi)
                gc = g & (dcnt < 2)
                if counts is not None:
                    # the kernel shades every diffuse hit, and continues gc
                    if K > 0:
                        tally(counts, "diffuse_pick", g)
                        tally(counts, "diffuse_caps", K * int(g.sum()))
                        tally(counts, "diffuse_cap", g & ~use_cos)
                    first = (g & (dcnt == 0)) if sb_mix is not None else g & False
                    tally(counts, "draws", int(first.sum()) * int(K > 0)
                          + int((g & ~first).sum()) * (6 if K > 0 else 2))
                for k in range(3):
                    betab[k] = torch.where(gc, w if has_img else prm[k] * w,
                                           betab[k])
                gid_out = torch.where(g, gid, gid_out)
                ndx = torch.where(gc, sdx, ndx)
                ndy = torch.where(gc, sdy, ndy)
                ndz = torch.where(gc, sdz, ndz)
                nox = torch.where(gc, nux, nox)
                noy = torch.where(gc, nuy, noy)
                noz = torch.where(gc, nuz, noz)
                inc_d = inc_d | gc
                new_alive = new_alive | gc

            elif mt == MAT_REFRACTIVE:
                prm = tables.refr[slot]
                cos_i = -(dx * nx + dy * ny + dz * nz)
                entering = orient > 0
                F, n2r_l, n2i_l = [], [], []
                for k in range(3):
                    n1 = (nre[k], nim[k])
                    n2 = (torch.where(entering, prm[k], scene_nre[k]),
                          torch.where(entering, prm[3 + k], scene_nim[k]))
                    ratio = _cdiv(n1, n2)
                    r2c = _cmul(ratio, ratio)
                    s2 = 1.0 - cos_i * cos_i
                    cos_t = _csqrt((1.0 - r2c[0] * s2, -r2c[1] * s2))
                    a = (n1[0] * cos_i, n1[1] * cos_i)
                    bt = _cmul(n2, cos_t)
                    r_per = _cdiv((a[0] - bt[0], a[1] - bt[1]),
                                  (a[0] + bt[0], a[1] + bt[1]))
                    at = _cmul(n1, cos_t)
                    bb = (n2[0] * cos_i, n2[1] * cos_i)
                    r_par = _cdiv((bb[0] - at[0], bb[1] - at[1]),
                                  (at[0] + bb[0], at[1] + bb[1]))
                    F.append((_cabs2(r_per) + _cabs2(r_par)) * 0.5)
                    n2r_l.append(n2[0])
                    n2i_l.append(n2[1])
                T = [1.0 - F[k] for k in range(3)]
                rat = [nre[k] / torch.clamp_min(n2r_l[k], 1e-9) for k in range(3)]
                disp = (slot, maxd, mc) in hu_of
                if disp:
                    # dispersion: refract at one uniformly chosen channel's
                    # IoR, that channel carrying 3x on transmitted paths
                    hu = hash_uniform(idx, seed[0], cb + 7 + hu_of[(slot, maxd, mc)])
                    h0 = hu < (1.0 / 3.0)
                    h1 = (hu >= (1.0 / 3.0)) & (hu < (2.0 / 3.0))
                    hero = (h0, h1, ~(h0 | h1))
                    ratio_avg = torch.where(h0, rat[0], torch.where(h1, rat[1], rat[2]))
                else:
                    ratio_avg = _div(rat[0] + rat[1] + rat[2], 3.0)
                sin2t = ratio_avg * ratio_avg * (1.0 - cos_i * cos_i)
                non_tir = sin2t <= 1.0
                croot = torch.sqrt(1.0 - torch.clamp(sin2t, 0.0, 1.0))
                rfx, rfy, rfz = _normalize3(
                    dx * ratio_avg + nx * (ratio_avg * cos_i - croot),
                    dy * ratio_avg + ny * (ratio_avg * cos_i - croot),
                    dz * ratio_avg + nz * (ratio_avg * cos_i - croot))
                T_avg = _div(T[0] + T[1] + T[2], 3.0)
                p_refr = torch.where(non_tir, torch.clamp(T_avg, 0.0, 1.0), 0.0)
                take_refr = (ru[0] < p_refr) & non_tir
                cont = torch.full((n,), bounce < maxd, device=dev)
                if split:
                    # deterministic branch from the pattern bit, weight 2F / 2T
                    det = scnt < split_k
                    bit = ((pattern >> scnt) & 1) == 1
                    take_refr = (det & bit & non_tir) | (~det & take_refr)
                    cont = cont & ~(det & bit & ~non_tir)
                gc = g & cont
                if split:
                    scnt = scnt + (gc & det).to(torch.int64)
                if counts is not None:
                    tally(counts, "refr_cont", gc)
                    tally(counts, "draws", g)
                    if disp:
                        tally(counts, "dispersive", g)
                        tally(counts, "draws", g)
                for k in range(3):
                    absorb = torch.exp(-2.0 * nim[k] * (2.0 * math.pi / lam[k])
                                       * 1e9 * t)
                    w_r = T[k] / torch.clamp_min(p_refr, 1e-9)
                    w_l = F[k] / torch.clamp_min(1.0 - p_refr, 1e-9)
                    if split:
                        w_r = torch.where(det, 2.0 * T[k], w_r)
                        w_l = torch.where(det, 2.0 * F[k], w_l)
                    if disp:
                        w_r = w_r * torch.where(hero[k], 3.0, 0.0)
                    betab[k] = torch.where(
                        gc, absorb * torch.where(take_refr, w_r, w_l), betab[k])
                    new_nre[k] = torch.where(gc & take_refr, n2r_l[k], new_nre[k])
                    new_nim[k] = torch.where(gc & take_refr, n2i_l[k], new_nim[k])
                gid_out = torch.where(g, gid, gid_out)
                ndx = torch.where(gc, torch.where(take_refr, rfx, rlx), ndx)
                ndy = torch.where(gc, torch.where(take_refr, rfy, rly), ndy)
                ndz = torch.where(gc, torch.where(take_refr, rfz, rlz), ndz)
                sgn = torch.where(take_refr, -1.0, 1.0)
                nox = torch.where(gc, px + nx * eps * sgn, nox)
                noy = torch.where(gc, py + ny * eps * sgn, noy)
                noz = torch.where(gc, pz + nz * eps * sgn, noz)
                new_alive = new_alive | gc

            elif mt == MAT_THINFILM:
                # branch choice only; the F / T factor is the replay's
                cos_i = torch.clamp(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
                gc = g & (bounce < maxd)
                c3, c2, c1, c0 = (tables.tf[slot, j] for j in range(4))
                q = torch.clamp(((c3 * cos_i + c2) * cos_i + c1) * cos_i + c0,
                                0.05, 0.95)
                take_refl = ru[0] < q
                w_sel = torch.where(take_refl, 1.0 / q, 1.0 / (1.0 - q))
                if split:
                    det = scnt < split_k
                    bit = ((pattern >> scnt) & 1) == 1
                    take_refl = (det & bit) | (~det & take_refl)
                    w_sel = torch.where(det, 2.0, w_sel)
                    scnt = scnt + (gc & det).to(torch.int64)
                if counts is not None:
                    tally(counts, "draws", g)
                    tally(counts, "tf_cont", gc)
                    tally(counts, "tf_reflect", gc & take_refl)
                for k in range(3):
                    addt[k] = torch.where(gc, ambient[k], addt[k])
                    betab[k] = torch.where(gc, w_sel, betab[k])
                cos_out = torch.where(g, cos_i, cos_out)
                gid_out = torch.where(
                    g, gid | torch.where(take_refl, 1 << 16, 0), gid_out)
                ndx = torch.where(gc & take_refl, rlx, ndx)
                ndy = torch.where(gc & take_refl, rly, ndy)
                ndz = torch.where(gc & take_refl, rlz, ndz)
                sgn = torch.where(take_refl, 1.0, -1.0)
                nox = torch.where(gc, px + nx * eps * sgn, nox)
                noy = torch.where(gc, py + ny * eps * sgn, noy)
                noz = torch.where(gc, pz + nz * eps * sgn, noz)
                new_alive = new_alive | gc

            elif mt == MAT_GLOSSY:
                prm = tables.glo[slot]
                col, g_re, g_im = prm[0:3], prm[3:6], prm[6:9]
                rough, spec_c, diff_c = prm[9], prm[10], prm[11]
                vx, vy, vz = -dx, -dy, -dz
                nux, nuy, nuz = px + nx * eps, py + ny * eps, pz + nz * eps
                lam_acc = [zf + ambient[k] * diff_c for k in range(3)]
                spec_acc = [zf, zf, zf]
                F0 = [fresnel_f0(nre[k], nim[k], g_re[k], g_im[k])
                      for k in range(3)]
                tests = None
                if counts is not None:
                    for name, m in zip(("dir", "point", "spot"), tables.n_lights):
                        tally(counts, f"light_{name}", m * int(g.sum()))
                    tests = lambda j, live: tally(
                        counts, f"shadow_{shadow_kinds[j]}", g & live)
                for lv, see, p5, sw in glossy_lights(
                        tables, shadow, (px, py, pz), (nux, nuy, nuz),
                        (nx, ny, nz), (vx, vy, vz), rough, spec_c, on_test=tests):
                    for k in range(3):
                        lam_acc[k] = lam_acc[k] + diff_c * lv[k] * see
                        spec_acc[k] = (spec_acc[k]
                                       + (F0[k] + (1.0 - F0[k]) * p5) * sw * lv[k])
                for k in range(3):
                    if has_img:
                        addt[k] = torch.where(g, lam_acc[k], addt[k])
                        addb[k] = torch.where(g, spec_acc[k], addb[k])
                    else:
                        addb[k] = torch.where(g, col[k] * lam_acc[k] + spec_acc[k],
                                              addb[k])
                gid_out = torch.where(g, gid, gid_out)
                cos_vn = torch.clamp(vx * nx + vy * ny + vz * nz, 0.0, 1.0)
                p5r = _pow5(1.0 - cos_vn)
                gc = g & (bounce < maxd)
                if counts is not None:
                    tally(counts, "glossy_cont", gc)
                for k in range(3):
                    F0s = fresnel_f0(scene_nre[k], scene_nim[k], g_re[k], g_im[k])
                    betab[k] = torch.where(gc, F0s + (1.0 - F0s) * p5r, betab[k])
                ndx = torch.where(gc, rlx, ndx)
                ndy = torch.where(gc, rly, ndy)
                ndz = torch.where(gc, rlz, ndz)
                nox = torch.where(gc, nux, nox)
                noy = torch.where(gc, nuy, noy)
                noz = torch.where(gc, nuz, noz)
                new_alive = new_alive | gc

        rec_g[bounce] = gid_out
        if counts is not None:
            # the fused kernel's texel fetches at this bounce's hits, by
            # how the group fetches (core/compile.py fetch_table)
            fi = tables.fetch_i[(gid_out & 0xFFFF).long()].long()
            use = fi[:, FT_USE] != FT_USE_NONE
            mode, bil = fi[:, FT_MODE], fi[:, FT_BIL] == 1
            uv = use & (mode == FT_MODE_UV)
            sec = (fi[:, FT_SEC] == 1) & (bounce > 0)
            tally(counts, "texel_hits", use)
            tally(counts, "fetch_bilinear", uv & bil & ~sec)
            tally(counts, "fetch_uv", uv & ~(bil & ~sec))
            tally(counts, "fetch_comp", use & (mode == FT_MODE_COMP))
            tally(counts, "fetch_two", use & (mode == FT_MODE_TWO))
        for j, plane in enumerate([uu, vv, cos_out] + addb + addt + betab):
            rec_f[bounce, j] = plane

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

    return rec_g, rec_f, count


# ---------------------------------------------------------------------------
# the CUDA kernel: launch (ops/cuda_build.py builds and binds it)
# ---------------------------------------------------------------------------

def _smem_bytes(static, tables):
    """Shared memory a block of the kernel takes for the scene tables,
    the fetch table among them."""
    n_l = static.n_dir_lights + static.n_point_lights + static.n_spot_lights
    return 4 * (len(tables.obj_rows) * (24 + OBJ_COLS) + sum(
        getattr(tables, k).numel() for k in ("dif", "glo", "refr", "emi", "tf"))
        + 11 * n_l + 4 * tables.n_is_targets + 16 + 17 + 3
        + tables.fetch_i.shape[0] * (FT_ICOLS + FT_FCOLS))


def kernel_info(static, tables, lib=None):
    """The kernel as built and as the current card holds it with these
    tables: {registers, local_bytes (stack and spills a thread),
    blocks_per_sm, sms, block, min_blocks, smem_optin_max (the card's
    opt-in maximum of shared memory a block), smem (the bytes these tables
    take, opted in past 48 KB)}."""
    info = (ctypes.c_int * 7)()
    smem = _smem_bytes(static, tables)
    err = (lib or load_library()).record_trace_info(smem, info)
    if err != 0:
        raise RuntimeError(f"record_trace_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "sms", "block",
                     "min_blocks", "smem_optin_max"),
                    info)) | {"smem": smem}


def _launch(seed_vec, static, tables, cam_vec, width, height, spp,
            max_bounces, split_k, sampler, projection="pinhole", lib=None):
    """Launch the kernel on the current stream; returns (L (n, 3), rays
    traced).  lib: the library to launch from (cuda_build.load_library()
    unless given; the tests pass the CPU stand-in's)."""
    dev = cam_vec.device
    f32, i32 = torch.float32, torch.int32
    n_obj = len(tables.obj_rows)
    _, order = shading_groups(static.obj_records)
    check_tensor("seed_vec", seed_vec, i32, (3,), dev)
    check_tensor("cam_vec", cam_vec, f32, (17,), dev)
    check_tensor("geom", tables.geom, f32, (n_obj, 24), dev)
    check_tensor("obj", tables.obj, i32, (n_obj, OBJ_COLS), dev)
    cols = dict(dif=4, glo=12, refr=6, emi=3, tf=6, lights=11, is_tab=4)
    for name, c in cols.items():
        check_tensor(name, getattr(tables, name), f32, (None, c), dev)
    check_tensor("consts", tables.consts, f32, (16,), dev)
    check_tensor("fetch_i", tables.fetch_i, i32, (len(order) + 1, FT_ICOLS), dev)
    check_tensor("fetch_f", tables.fetch_f, f32, (len(order) + 1, FT_FCOLS), dev)
    check_tensor("atlas", tables.atlas, i32, (None,), dev)
    if tables.atlas.numel() < 1:
        raise ValueError("atlas is empty")
    K = tables.n_is_targets
    n_l = static.n_dir_lights + static.n_point_lights + static.n_spot_lights
    if K > tables.is_tab.shape[0] or n_l > tables.lights.shape[0]:
        raise ValueError("is_tab or lights has fewer rows than the scene says")
    rows_of = {MAT_DIFFUSE: tables.dif.shape[0], MAT_GLOSSY: tables.glo.shape[0],
               MAT_REFRACTIVE: tables.refr.shape[0],
               MAT_EMISSIVE: tables.emi.shape[0],
               MAT_THINFILM: tables.tf.shape[0]}
    for r in tables.obj_rows:            # env slots read no table
        if r[1] in rows_of and not 0 <= r[2] < rows_of[r[1]]:
            raise ValueError(f"object row {r} names a missing material slot")
    smem = _smem_bytes(static, tables)
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
    L = torch.empty((n, 3), dtype=f32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    lib = lib or load_library()
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    rows = lambda t: t.shape[0]
    err = lib.record_trace_launch(
        p(seed_vec), p(cam_vec), p(tables.geom), p(tables.obj), n_obj,
        p(tables.dif), rows(tables.dif), p(tables.glo), rows(tables.glo),
        p(tables.refr), rows(tables.refr), p(tables.emi), rows(tables.emi),
        p(tables.tf), rows(tables.tf), p(tables.lights), n_l,
        static.n_dir_lights, static.n_point_lights, static.n_spot_lights,
        p(tables.is_tab), K, p(tables.consts), p(tables.fetch_i),
        p(tables.fetch_f), rows(tables.fetch_i), p(tables.atlas),
        tables.atlas.numel(), width, height, spp, max_bounces,
        int(sampler == "iid"), split_k, PROJECTIONS[projection],
        len(dispersive_groups(static.obj_records, static.refr_disp)[1]),
        p(L), p(count), stream_of(dev))
    if err != 0:
        raise RuntimeError(f"record_trace kernel launch failed: CUDA error {err}")
    return L, count


def record_trace_chunk(seed_vec, static: SceneStatic, tables: SolidTables,
                       cam_vec, width, height, spp, max_bounces, split_k=0,
                       sampler="r2", projection="pinhole"):
    """Trace one chunk of a textured scene: the CUDA kernel for CUDA
    tensors, the plain version (`record_trace_chunk_reference`, then
    `replay`) for CPU tensors.  Arguments as `record_trace_chunk_reference`.
    Returns (L (spp*H*W, 3) float32 in [sample, pixel] order, rays traced
    int64 scalar tensor); `record_trace_chunk.launches` counts kernel
    launches."""
    if cam_vec.device.type == "cpu":
        rec_g, rec_f, count = record_trace_chunk_reference(
            seed_vec, static, tables, cam_vec, width, height, spp,
            max_bounces, split_k, sampler, projection)
        L = replay(rec_g, rec_f, static, tables, max_bounces,
                   spp * width * height)
        return L, count
    if cam_vec.device.type != "cuda":
        raise ValueError(f"no record kernel for device {cam_vec.device}")
    check_slice(static, split_k, sampler, projection)
    out = _launch(seed_vec, static, tables, cam_vec, width, height, spp,
                  max_bounces, split_k, sampler, projection)
    record_trace_chunk.launches += 1
    return out


record_trace_chunk.launches = 0
