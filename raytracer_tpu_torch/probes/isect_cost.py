"""The cost of one intersection test on the card, against the hand count.

probes/roofline.py counts the render kernels' work by hand (SLOTS): one
entry per device function, each read off its source line.  The nearest-hit
tests are the largest part of that count (about half of the solid
kernel's slots on Cornell), and this probe measures them: the nearest-hit
loop of the render kernels (trace_common.cuh `nearest_hit`, kernel in
csrc/probe_isect.cu) over N_OBJ objects of one kind for N_RAYS random
rays, timed against the same loop over no objects.  The difference per
test, at P1's measured unfused rate, is the slots one test costs as the
kernels run it (shared-memory loads, the kind dispatch and loop control
included, which the hand count leaves out); `counted` is the hand count
of the same test.  Every kind's kernel is held bit for bit against its
plain version (ops/solid_trace.py `nearest_hit`) on the timed inputs.

The render kernels take axis-aligned planes ("plane_aa") through the
generic plane formula, which gives the bits of the plain version's
component-selection form; the probe also times that selection form on the
same planes (`plane_aa_select`, the form the kernels took before), held to
the same bits, so that the two costs stand side by side.

    python -m raytracer_tpu_torch.probes.isect_cost
"""

from __future__ import annotations

import ctypes
import dataclasses
import json

import numpy as np
import torch

from . import common, roofline

KINDS = roofline.KINDS
N_OBJ, N_RAYS = 32, 1 << 22
SOURCE = "probe_isect.cu"


def _unit(v):
    return v / np.linalg.norm(v)


def table(kind, n_obj=N_OBJ, seed=0):
    """SolidTables of n_obj objects of `kind` (a name of KINDS) placed at
    random around the origin, drawn from default_rng(seed)."""
    from .. import (Cuboid, Cylinder, Diffuse, Disc, Plane, Scene, Sphere,
                    Triangle, rgb, vec3)
    from ..core.compile import compile_scene

    rng = np.random.default_rng(seed)
    mat = Diffuse(diff_color=rgb(0.5, 0.5, 0.5))
    sc = Scene()
    axes = np.eye(3)
    for i in range(n_obj):
        c = rng.uniform(-3.0, 3.0, 3)
        while np.linalg.norm(c) < 1.5:
            c = rng.uniform(-3.0, 3.0, 3)
        s = rng.uniform(0.3, 0.8)
        n = _unit(rng.standard_normal(3))
        if kind == "sphere":
            obj = Sphere(center=vec3(*c), material=mat, radius=s)
        elif kind in ("plane_aa", "plane"):
            if kind == "plane_aa":
                a, b = rng.choice(3, 2, replace=False)
                u, v = axes[a] * rng.choice((-1, 1)), axes[b] * rng.choice((-1, 1))
            else:
                u = _unit(np.cross(n, rng.standard_normal(3)))
                v = np.cross(n, u)
            obj = Plane(center=vec3(*c), material=mat, width=2 * s, height=1.5 * s,
                        u_axis=vec3(*u), v_axis=vec3(*v))
        elif kind == "box":
            obj = Cuboid(center=vec3(*c), material=mat, width=s, height=0.8 * s,
                         length=0.6 * s)
            obj.rotate(theta=float(rng.uniform(0, 90)), u=vec3(*n))
        elif kind == "tri":
            p = [c + 0.7 * s * rng.standard_normal(3) for _ in range(3)]
            obj = Triangle(center=vec3(*c), material=mat, p1=vec3(*p[0]),
                           p2=vec3(*p[1]), p3=vec3(*p[2]))
        elif kind == "disc":
            obj = Disc(center=vec3(*c), material=mat, radius=s, normal=vec3(*n),
                       inner_radius=0.5 * s * (i % 2))
        else:
            obj = Cylinder(center=vec3(*c), material=mat, radius=0.4 * s,
                           height=1.5 * s, axis=vec3(*n), capped=bool(i % 2))
        sc.add(obj)
    _, tables = compile_scene(sc)
    return tables


def generic_planes(tables):
    """tables with every plane's axis-aligned frame dropped (OBJ_AA_N =
    -1), so that the intersectors take the generic plane formula."""
    from ..core.compile import OBJ_AA_N

    obj = tables.obj.clone()
    obj[:, OBJ_AA_N] = -1
    rows = tuple(r[:OBJ_AA_N] + (-1,) + r[OBJ_AA_N + 1:] for r in tables.obj_rows)
    return dataclasses.replace(tables, obj=obj, obj_rows=rows)


def rays(n=N_RAYS, seed=1, device="cpu"):
    """float32 (6, n): origins within 0.5 of the origin, unit directions,
    drawn from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (3, n))
    d = rng.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0)
    return torch.from_numpy(np.concatenate([o, d]).astype(np.float32)).to(device)


def isect_reference(tables, r):
    """The plain version: (t, orient, id int32) of the nearest hit of each
    ray of r (6, n) over the objects of tables (ops/solid_trace.py)."""
    from ..ops.solid_trace import isect_of, nearest_hit

    isects = [isect_of(row) for row in tables.obj_rows]
    t, orient, obj = nearest_hit(isects, tables.geom.to(r.device), *r)
    return t, orient, obj.to(torch.int32)


def isect(tables, r, select=False):
    """The nearest hit over the objects of tables: the kernel for a CUDA
    tensor r, the plain version for a CPU one.  select: the kernel takes
    axis-aligned planes by component selection instead of the generic
    formula (the same bits).  `isect.launches` counts kernel launches."""
    if r.device.type == "cpu":
        return isect_reference(tables, r)
    common.require_card()
    if r.dtype != torch.float32 or r.dim() != 2 or r.shape[0] != 6 or not r.is_contiguous():
        raise ValueError("rays must be a contiguous float32 (6, n) tensor")
    geom = tables.geom.to(r.device).contiguous()
    obj = tables.obj.to(r.device).contiguous()
    n = r.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=r.device)
    orient = torch.empty_like(t)
    ids = torch.empty(n, dtype=torch.int32, device=r.device)
    vp = ctypes.c_void_p
    common.launch("probe_isect_launch",
                  [vp, vp, ctypes.c_int, vp, vp, vp, vp, ctypes.c_longlong,
                   ctypes.c_int, vp],
                  common.ptr(geom), common.ptr(obj), geom.shape[0], common.ptr(r),
                  common.ptr(t), common.ptr(orient), common.ptr(ids), n,
                  int(select), common.stream(r))
    isect.launches += 1
    return t, orient, ids


isect.launches = 0


def run(costs, unfused_rate, n=N_RAYS, n_obj=N_OBJ, reps=10):
    """Each kind's kernel held against its plain version, then timed over
    its table and over none; and the axis-aligned planes by component
    selection, held to the same bits.  costs, unfused_rate: P1's slot
    costs and measured unfused rate.  Returns (result dict, kernels-line
    rows)."""
    from .issue_peak import sass_counts

    dev = common.require_card()
    r = rays(n, device=dev)
    tabs = {k: table(k, n_obj).to(dev) for k in KINDS}
    empty = table("sphere", 0).to(dev)
    hits = {}
    for k, tab, sel in [*((k, tab, False) for k, tab in tabs.items()),
                        ("plane_aa_select", tabs["plane_aa"], True),
                        ("none", empty, False)]:
        got, want = isect(tab, r, sel), isect_reference(tab, r)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"isect_cost {k}: kernel and plain version differ")
        hits[k] = float((got[2] >= 0).float().mean())
        del got, want
    isect.launches = 0
    ms_empty = common.cuda_ms(lambda: isect(empty, r), reps)
    ms = {k: common.cuda_ms(lambda: isect(tab, r), reps) for k, tab in tabs.items()}
    ms_select = common.cuda_ms(lambda: isect(tabs["plane_aa"], r, True), reps)
    launches = isect.launches
    out = {"probe": "isect_cost", **common.device_info(), "rays": n,
           "objects": n_obj, "ms_no_objects": ms_empty, "ms": ms,
           "hit_share": hits, "measured_slots_per_test": {},
           "counted_slots_per_test": {}, "measured_over_counted": {}}
    for k in KINDS:
        meas = (ms[k] - ms_empty) * 1e-3 * unfused_rate / (n * n_obj)
        cnt = roofline.counted_test(k, costs)
        out["measured_slots_per_test"][k] = meas
        out["counted_slots_per_test"][k] = cnt
        out["measured_over_counted"][k] = meas / cnt
    out["plane_aa_select"] = {
        "ms": ms_select, "same_bits_as_generic": True,
        "measured_slots_per_test": (ms_select - ms_empty) * 1e-3 * unfused_rate
        / (n * n_obj)}
    out["clocks_after"] = common.clocks()
    out["sass"] = sass_counts(("probe_isect",))
    plain_ms = sum(common.cuda_ms(lambda: isect_reference(tab, r), 1, 0)
                   for tab in tabs.values())
    # the row: one launch over each kind's table
    slots = n * n_obj * sum(roofline.counted_test(k, costs) for k in KINDS)
    row = common.row("isect_cost", SOURCE, "scripts/roofline.py:190",
                     launches, 0.0, sum(ms.values()), plain_ms, slots,
                     len(KINDS) * (n * 36 + n_obj * 160))
    return out, [row]


def main():
    from . import issue_peak

    p1, _ = issue_peak.run()
    out, rows = run(p1["slot_costs"], p1["unfused_peak_lane_ops_per_s"])
    out["kernels"] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main()
