"""The plane equivalence the solid kernel K1 rests on.

K1 (csrc/solid_trace.cu, through trace_common.cuh `isect_plane`) takes
every plane, axis-aligned ones included, through the generic plane
formula, while its plain version (ops/solid_trace.py) takes an
axis-aligned plane by component selection (`_isect_plane(..., aa=...)`).
The two forms must give the same bits: the generic sums only add exact
+-0 products, negation is exact, and where the distance overflows both
forms fail the extent test.  Held here on the CPU, bit for bit:

- `_isect_plane` with the axis-aligned codes against the generic formula
  on every axis-aligned plane of the Cornell box and of the fisheye,
  panorama and orthographic examples: 10^5 seeded random rays, plus
  direction components exactly 0 and denormal, rays from points on the
  plane, and rays aimed at the plane's edges and corners;
- `nearest_hit` over Cornell's tables as compiled and with the
  axis-aligned frames dropped (probes/isect_cost.py `generic_planes`), on
  Cornell's camera rays and on bounce rays from their hit points;
- the plain version over a whole Cornell chunk (400x400 x 2 spp) with and
  without the frames: L bit for bit and rays_traced identical.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.compile import (KIND_CODES, OBJ_AA_N, OBJ_AA_NSIGN,
                                              OBJ_AA_U, OBJ_AA_V, OBJ_KIND)
from raytracer_tpu_torch.ops import solid_trace as st
from raytracer_tpu_torch.probes import isect_cost

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import torch_primitives  # noqa: E402
from torch_cornellbox import build_cornell  # noqa: E402

SCENES = {"cornell": lambda: build_cornell(16, 16),
          "fisheye": lambda: torch_primitives.fisheye(16, 16),
          "panorama": lambda: torch_primitives.panorama(16, 8),
          "orthographic": lambda: torch_primitives.orthographic(16, 12)}
N_RAYS = 100_000


def aa_planes(name):
    """[(geometry row, (n axis, n sign, u axis, v axis))] of the scene's
    planes with an axis-aligned frame."""
    _, tables, _ = SCENES[name]()._settings_for_render()
    return [(tables.geom[i], (r[OBJ_AA_N], r[OBJ_AA_NSIGN], r[OBJ_AA_U], r[OBJ_AA_V]))
            for i, r in enumerate(tables.obj_rows)
            if r[OBJ_KIND] == KIND_CODES["plane"] and r[OBJ_AA_N] >= 0]


CASES = [(name, j) for name, n in (("cornell", 6), ("fisheye", 1), ("panorama", 1),
                                   ("orthographic", 1)) for j in range(n)]


def test_every_scene_has_its_axis_aligned_planes():
    assert [len(aa_planes(name)) for name in SCENES] == [6, 1, 1, 1]


def plane_rays(g, codes, seed):
    """(ox, oy, oz, dx, dy, dz) float32: random rays around the plane, and
    the edge cases of the equivalence."""
    rng = np.random.default_rng(seed)
    g = g.numpy().astype(np.float64)
    c, u, v, w2, h2 = g[0:3], g[3:6], g[6:9], g[12], g[13]
    size = max(w2, h2, 1.0)
    o = c + rng.uniform(-3.0, 3.0, (N_RAYS, 3)) * size
    d = rng.standard_normal((N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nax, _, uax, vax = codes
    q = N_RAYS // 10                             # ten blocks of rays, the last random
    d[:q, nax] = 0.0                             # parallel to the plane
    d[q:2 * q, uax] = 0.0
    d[2 * q:3 * q, vax] = 0.0
    d[3 * q:4 * q, nax] = 1e-40                  # denormal toward the plane
    d[4 * q:5 * q, nax] = -1e-40
    # origins on the plane
    o[5 * q:6 * q] = (c + np.outer(rng.uniform(-1.5, 1.5, q), u) * w2
                      + np.outer(rng.uniform(-1.5, 1.5, q), v) * h2)
    # aimed at the edges (|uu| = w2, |vv| = h2) and at the corners
    s = rng.uniform(-1.0, 1.0, (q, 1))
    su, sv = rng.choice((-1.0, 1.0), (q, 1)), rng.choice((-1.0, 1.0), (q, 1))
    targets = (c + su * w2 * u + s * h2 * v, c + s * w2 * u + sv * h2 * v,
               c + su * w2 * u + sv * h2 * v)
    for k, target in enumerate(targets):
        rows = slice((6 + k) * q, (7 + k) * q)
        to = target - o[rows]
        d[rows] = to / np.linalg.norm(to, axis=1, keepdims=True)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return tuple(f(o[:, k]) for k in range(3)) + tuple(f(d[:, k]) for k in range(3))


@pytest.mark.parametrize("name,j", CASES, ids=[f"{n}-{j}" for n, j in CASES])
def test_axis_aligned_form_equals_generic_formula(name, j):
    g, codes = aa_planes(name)[j]
    rays = plane_rays(g, codes, seed=17 + j)
    t_aa, or_aa = st._isect_plane(g, *rays, aa=codes)
    t_gen, or_gen = st._isect_plane(g, *rays)
    assert torch.equal(t_aa, t_gen) and torch.equal(or_aa, or_gen)
    hit = t_aa < 1e29
    assert 0.01 < hit.float().mean().item() < 0.99      # both outcomes occur
    assert bool(torch.isfinite(t_aa).all())


def _cornell_inputs(width=40, height=40):
    sc = build_cornell(width, height)
    _, tables, s = sc._settings_for_render()
    return sc, tables, cam_vec(sc.camera.params()), s


def _nearest(tables, rays):
    isects = [st.isect_of(r) for r in tables.obj_rows]
    return st.nearest_hit(isects, tables.geom, *rays)


@pytest.mark.parametrize("which", ["camera", "bounce"])
def test_nearest_hit_without_axis_aligned_frames(which):
    sc, tables, cam, s = _cornell_inputs()
    seed = torch.tensor([5, 6, 0], dtype=torch.int64)
    _, rays, _, _ = st.camera_rays(seed, cam, 40, 40, 8, "iid")
    if which == "bounce":
        # from each camera ray's hit point, nudged off its surface, in
        # random directions
        t, orient, obj = _nearest(tables, rays)
        keep = obj >= 0
        o = [rays[k][keep] + rays[3 + k][keep] * t[keep] for k in range(3)]
        n = st.hit_normals(tables.obj_rows, tables.geom, obj[keep], *o)
        rng = np.random.default_rng(3)
        d = torch.from_numpy(rng.standard_normal((3, int(keep.sum()))).astype(np.float32))
        d = list(st._normalize3(*d))
        for k in range(3):
            o[k] = o[k] + n[k] * orient[keep] * 1e-4
        rays = (*o, *d)
    want = _nearest(tables, rays)
    got = _nearest(isect_cost.generic_planes(tables), rays)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plane_hits = sum(int((want[2] == i).sum()) for i, r in enumerate(tables.obj_rows)
                     if r[OBJ_AA_N] >= 0)
    assert plane_hits > 0.2 * want[2].numel()


@pytest.mark.parametrize("seed", [(99, 4242, 0), (7, 1, 3)])
def test_whole_chunk_without_axis_aligned_frames(seed):
    sc, tables, cam, s = _cornell_inputs(400, 400)
    args = (torch.tensor(seed, dtype=torch.int32), tables, cam, 400, 400, 2, s.max_bounces)
    L, n = st.solid_trace_chunk_reference(*args)
    L_gen, n_gen = st.solid_trace_chunk_reference(args[0], isect_cost.generic_planes(tables),
                                                  *args[2:])
    assert torch.equal(L, L_gen) and int(n) == int(n_gen)
    assert int(n) > 2 * 400 * 400
