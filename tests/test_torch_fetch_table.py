"""The per-group fetch table (core/compile.py `fetch_table`) against the
replay it stands for.

The record kernel (csrc/record_trace.cu) fetches each hit's texels through
the fetch table, where the plain version's replay (ops/replay.py) builds
per-element fetch parameters by group-masked selects (`_Round`, the
counterpart of pallas_record.py:849-1060).  On each scene, over the
records of one small chunk (record_trace_chunk_reference):

- the table, read at each element's gid, gives field for field the
  parameters the replay's rounds hold for that element: texture offset,
  W, H, W * repeat and H * repeat, scale, RGB9E5 and bilinear flags (the
  environment's lightmap table on bounces after the first), the composed
  thin-film index, the two-round thin film's noise and LUT fields;
- `table_replay`, a plain replay that reads only the table (the
  kernel's arithmetic on tensors), is bit-equal to `replay`;
- the table built from the JAX package's compiled scene (interop) equals
  the port's.
"""

import sys
from pathlib import Path

import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu_torch.core import compile as C
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.interop import tables_from_jax
from raytracer_tpu_torch.materials.base import (MAT_DIFFUSE, MAT_ENV,
                                                MAT_THINFILM)
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops import replay as replay_mod

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (lit_textures, thinfilm_ibl,  # noqa: E402
                               torch_primitives, torch_textured)

W_, H_, SPP = 8, 8, 4

SCENES = {  # name: package -> scene
    "example1": lambda m: torch_textured.example1(W_, H_, m=m),
    "example2": lambda m: torch_textured.example2(W_, H_, m=m),
    "example3": lambda m: torch_textured.example3(W_, H_, m=m),
    # a two-round thin film and an environment lightmap
    "example4": lambda m: torch_textured.example4(W_, H_, m=m, blur=0.0),
    "primitives": lambda m: torch_primitives.primitives(W_, H_, m=m),
    "fisheye": lambda m: torch_primitives.fisheye(W_, H_, m=m),
    "panorama": lambda m: torch_primitives.panorama(16, H_, m=m),
    "still_life": lambda m: torch_primitives.orthographic(W_, H_, m=m),
    # a blurred environment with a lightmap, packed RGB9E5
    "thinfilm_ibl": thinfilm_ibl,
    # a bilinear texture
    "lit_textures": lit_textures,
}


def table_replay(rec_g, rec_f, tables, max_bounces, n):
    """Radiance (n, 3) from the records, the texel fetches taken from the
    fetch table alone, element by element as the kernel takes them."""
    B, M = max_bounces, max_bounces * n
    word = rec_g.reshape(M).long()
    gid, flag = word & 0xFFFF, (word >> 16) & 1
    plane = lambda j: rec_f[:, j, :].reshape(M)
    u, v, cos_i = plane(0), plane(1), plane(2)
    fi, ff = tables.fetch_i[gid].long(), tables.fetch_f[gid]
    sec = (fi[:, C.FT_SEC] == 1) & (torch.arange(M) // n > 0)
    pick = lambda a, b: torch.where(sec, a, b)
    atlas = tables.atlas

    def texel(idx, scale, e5):
        w = atlas[idx.clamp(0, atlas.shape[0] - 1)]
        s1023 = scale * (1.0 / 1023.0)
        es = torch.exp2(((w >> 27) & 31).float() - 24.0)
        return [torch.where(e5, ((w >> s5) & 511).float() * es,
                            ((w >> s10) & 1023).float() * s1023)
                for s5, s10 in ((18, 20), (9, 10), (0, 0))]

    def uv_idx(frep, grep, Wd, Hd):
        iu = torch.remainder((u * frep).long(), Wd)
        iv = torch.remainder((v * grep).long(), Hd)
        return torch.remainder(-iv, Hd) * Wd + iu

    # round 1 at the uv wrap (the environment's second table after bounce 0)
    Wd = pick(fi[:, C.FT_W2], fi[:, C.FT_W]).clamp_min(1)
    Hd = pick(fi[:, C.FT_H2], fi[:, C.FT_H]).clamp_min(1)
    off = pick(fi[:, C.FT_OFF2], fi[:, C.FT_OFF])
    e5 = pick(fi[:, C.FT_E5_2], fi[:, C.FT_E5]) == 1
    frep = pick(ff[:, C.FT_FREP2], ff[:, C.FT_FREP])
    grep = pick(ff[:, C.FT_GREP2], ff[:, C.FT_GREP])
    scale = pick(ff[:, C.FT_SCALE2], ff[:, C.FT_SCALE])
    rgb = texel(uv_idx(frep, grep, Wd, Hd) + off, scale, e5)
    # bilinear: four weighted taps, summed from 0
    x, y = u * frep - 0.5, v * grep - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ix, iy = x0.long(), y0.long()
    wts = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    bil = [torch.zeros(M)] * 3
    for t, wt in enumerate(wts):
        idx = (torch.remainder(-(iy + t // 2), Hd) * Wd
               + torch.remainder(ix + t % 2, Wd) + off)
        tap = texel(idx, scale, e5)
        bil = [bil[c] + wt * tap[c] for c in range(3)]
    use_bil = (fi[:, C.FT_BIL] == 1) & ~sec
    rgb = [torch.where(use_bil, bil[c], rgb[c]) for c in range(3)]
    # the composed thin-film table
    nH, nW, LH = (fi[:, c].clamp_min(1) for c in (C.FT_NH, C.FT_NW, C.FT_LH))
    iu = torch.remainder((u * ff[:, C.FT_FREP]).long(), nW)
    iv = torch.remainder((v * ff[:, C.FT_GREP]).long(), nH)
    row = torch.minimum(torch.clamp_min((cos_i * LH.float()).long(), 0), LH - 1)
    comp = texel((row * nH + torch.remainder(-iv, nH)) * nW + iu
                 + fi[:, C.FT_OFF], ff[:, C.FT_SCALE], fi[:, C.FT_E5] == 1)
    # the two-round thin film: noise texel, then the LUT
    W1, H1 = fi[:, C.FT_W].clamp_min(1), fi[:, C.FT_H].clamp_min(1)
    noise = texel(uv_idx(ff[:, C.FT_FREP], ff[:, C.FT_GREP], W1, H1)
                  + fi[:, C.FT_OFF], ff[:, C.FT_SCALE], fi[:, C.FT_E5] == 1)[0]
    th = ff[:, C.FT_TF_THICK] + ff[:, C.FT_TF_NOISE] * (noise - 0.5)
    W2, H2 = fi[:, C.FT_W2].clamp_min(1), fi[:, C.FT_H2].clamp_min(1)
    lrow = torch.minimum(torch.clamp_min((cos_i * H2.float()).long(), 0), H2 - 1)
    lcol = torch.minimum(torch.clamp_min(th.long(), 0), W2 - 1)
    two = texel(lrow * W2 + lcol + fi[:, C.FT_OFF2], ff[:, C.FT_SCALE2],
                fi[:, C.FT_E5_2] == 1)
    mode, use = fi[:, C.FT_MODE], fi[:, C.FT_USE]
    rgb = [torch.where(mode == C.FT_MODE_COMP, comp[c],
                       torch.where(mode == C.FT_MODE_TWO, two[c], rgb[c]))
           for c in range(3)]
    ones = torch.ones(M)
    tex = [torch.where((use == C.FT_USE_ADD) | (use == C.FT_USE_FILM), rgb[c], ones)
           for c in range(3)]
    film_beta = [torch.where(flag == 1, rgb[c], 1.0 - rgb[c]) for c in range(3)]
    btex = [torch.where(use == C.FT_USE_BETA, rgb[c],
                        torch.where(use == C.FT_USE_FILM, film_beta[c], ones))
            for c in range(3)]
    hit = gid > 0
    out = []
    for c in range(3):
        m_add = torch.where(hit, plane(3 + c) + plane(6 + c) * tex[c], 0.0).reshape(B, n)
        m_beta = torch.where(hit, plane(9 + c) * btex[c], 1.0).reshape(B, n)
        L, beta = m_add[0], m_beta[0]
        for k in range(1, B):
            L = L + beta * m_add[k]
            beta = beta * m_beta[k]
        out.append(L)
    return torch.stack(out, dim=-1)


class _RecordingRound(replay_mod._Round):
    """The replay's round, kept for inspection once the replay is done."""
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _RecordingRound.made.append(self)


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    sc = SCENES[request.param](T)
    static, tables, s = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    args = (torch.tensor([41, 42, 0], dtype=torch.int32), static, tables,
            cam_vec(sc.camera.params()), W, H, SPP, s.max_bounces, s.split_k,
            s.sampler, s.projection)
    g, f, _ = rt.record_trace_chunk_reference(*args)
    return dict(name=request.param, static=static, tables=tables, g=g, f=f,
                B=s.max_bounces, n=W * H * SPP)


def test_table_matches_the_replay_rounds(case, monkeypatch):
    static, tables, B, n = case["static"], case["tables"], case["B"], case["n"]
    _RecordingRound.made = []
    monkeypatch.setattr(replay_mod, "_Round", _RecordingRound)
    replay_mod.replay(case["g"], case["f"], static, tables, B, n)
    r1, r2 = _RecordingRound.made
    gid = case["g"].reshape(-1).long() & 0xFFFF
    fi, ff = tables.fetch_i[gid].long(), tables.fetch_f[gid]
    M = B * n
    sec = (fi[:, C.FT_SEC] == 1) & (torch.arange(M) // n > 0)
    use, mode = fi[:, C.FT_USE], fi[:, C.FT_MODE]
    assert bool(((use == C.FT_USE_NONE) == (mode == C.FT_MODE_NONE)).all())
    assert bool((use[gid == 0] == C.FT_USE_NONE).all())
    assert int((use != C.FT_USE_NONE).sum()) > 0, "no textured hit"

    def same(m, a, b):
        assert torch.equal(a[m], b[m].to(a.dtype)), (case["name"], int(m.sum()))

    # round 1 at the uv wrap, and the environment's second table
    for m, ic, fc in (((mode == C.FT_MODE_UV) & ~sec,
                       (C.FT_OFF, C.FT_W, C.FT_H, C.FT_E5),
                       (C.FT_FREP, C.FT_GREP, C.FT_SCALE)),
                      ((mode == C.FT_MODE_UV) & sec,
                       (C.FT_OFF2, C.FT_W2, C.FT_H2, C.FT_E5_2),
                       (C.FT_FREP2, C.FT_GREP2, C.FT_SCALE2)),
                      (mode == C.FT_MODE_TWO,
                       (C.FT_OFF, C.FT_W, C.FT_H, C.FT_E5),
                       (C.FT_FREP, C.FT_GREP, C.FT_SCALE))):
        for a, col in zip((r1.off, r1.W, r1.H, r1.e5m), ic):
            same(m, a, fi[:, col])
        for a, col in zip((r1.frep, r1.grep, r1.scale), fc):
            same(m, a, ff[:, col])
        bil = fi[:, C.FT_BIL] * (~sec).long()
        same(m, r1.bilm, bil)
    # the composed thin-film table: the replay's direct index
    m = mode == C.FT_MODE_COMP
    if bool(m.any()):
        nH, nW, LH = fi[:, C.FT_NH], fi[:, C.FT_NW], fi[:, C.FT_LH]
        u, v, cos_i = (case["f"][:, j, :].reshape(M) for j in range(3))
        iu = torch.remainder((u * ff[:, C.FT_FREP]).long(), nW.clamp_min(1))
        iv = torch.remainder((v * ff[:, C.FT_GREP]).long(), nH.clamp_min(1))
        row = torch.minimum(torch.clamp_min((cos_i * LH.float()).long(), 0), LH - 1)
        local = (row * nH + torch.remainder(-iv, nH.clamp_min(1))) * nW + iu
        same(m, r1.direct, local)
        same(m, r1.dmask, torch.ones(M, dtype=torch.long))
        for a, col in zip((r1.off, r1.e5m), (C.FT_OFF, C.FT_E5)):
            same(m, a, fi[:, col])
        same(m, r1.scale, ff[:, C.FT_SCALE])
    # the two-round thin film's LUT round
    m = mode == C.FT_MODE_TWO
    if bool(m.any()):
        for a, col in zip((r2.off, r2.W, r2.H, r2.e5m),
                          (C.FT_OFF2, C.FT_W2, C.FT_H2, C.FT_E5_2)):
            same(m, a, fi[:, col])
        same(m, r2.scale, ff[:, C.FT_SCALE2])
    # how the texel enters the path, by material
    mt_of = {g["gid"]: key[0] for key, g in C.shading_groups(
        static.obj_records)[0].items()}
    for g, mt in mt_of.items():
        u_g = int(tables.fetch_i[g, C.FT_USE])
        want = {MAT_ENV: C.FT_USE_ADD, MAT_THINFILM: C.FT_USE_FILM}.get(mt)
        if mt == MAT_DIFFUSE and u_g != C.FT_USE_NONE:
            want = C.FT_USE_BETA
        if want is not None:
            assert u_g == want, (case["name"], g, mt, u_g)


def test_table_replay_is_bit_equal_to_the_replay(case):
    L = replay_mod.replay(case["g"], case["f"], case["static"], case["tables"],
                          case["B"], case["n"])
    L_t = table_replay(case["g"], case["f"], case["tables"], case["B"], case["n"])
    assert torch.equal(torch.nan_to_num(L_t, 7.0), torch.nan_to_num(L, 7.0))
    assert float(L.nan_to_num().abs().sum()) > 0


@pytest.mark.parametrize("name", ["example4", "lit_textures", "primitives"])
def test_table_from_the_jax_compile_equals_the_ports(name):
    build = SCENES[name]
    _, j_tables = tables_from_jax(*jax_compile(build(J)))
    _, t_tables = C.compile_scene(build(T))
    assert torch.equal(j_tables.fetch_i, t_tables.fetch_i)
    assert torch.equal(j_tables.fetch_f, t_tables.fetch_f)
