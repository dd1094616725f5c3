"""Scene compiler, solid-path subset: scene description -> kernel tables.

Counterpart of raytracer_tpu/core/compile.py (`compile_scene`, `ObjRecord`,
`SceneStatic`, `derive_max_bounces`, `derive_split_k` and the `pallas_ok`
gate) plus the kernel-side tables that raytracer_tpu/ops/pallas_trace.py
builds at call time (:1134-1150).  The float math is the JAX package's
numpy code, so every table matches it bit for bit
(tests/test_torch_compile.py).

Object ids run spheres, then planes, then boxes, in insertion order within
each kind, as in the JAX package.  Scenes outside the solid slice raise
NotImplementedError naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ..geometry.primitive import Cuboid, Plane, Sphere
from ..lights import SpotLight
from ..materials.base import (MAT_CUSTOM, MAT_DIFFUSE, MAT_EMISSIVE,
                              MAT_GLOSSY, MAT_REFRACTIVE, MAT_THINFILM)

F32 = np.float32
I32 = np.int32

# the JAX package's Pallas walls (compile.py:1131-1132), kept so that the
# gate routes every scene as the reference does
PALLAS_MAX_OBJECTS = 48
PALLAS_MAX_GROUPS = 36

KIND_CODES = {"sphere": 0, "plane": 1, "box": 2, "tri": 3, "disc": 4, "cyl": 5}
SOLID_KINDS = ("sphere", "plane", "box")

# columns of the (O, OBJ_COLS) int32 object table the kernel reads
(OBJ_KIND, OBJ_MAT_TYPE, OBJ_MAT_SLOT, OBJ_MAX_DEPTH, OBJ_MC, OBJ_SHADOW,
 OBJ_DISP, OBJ_AA_N, OBJ_AA_NSIGN, OBJ_AA_U, OBJ_AA_V) = range(11)
OBJ_COLS = 12


@dataclass(frozen=True)
class ObjRecord:
    """Static structure of one object (raytracer_tpu ObjRecord).

    aa: ((n_axis, n_sign), (u_axis, u_sign), (v_axis, v_sign)) when a
    plane's frame vectors are exact +-unit axes, else None; the kernel
    then tests the plane by component selection, bit-identical to the
    generic formula.
    """
    kind: str
    mat_type: int
    mat_slot: int
    max_depth: int
    mc: bool
    shadow: bool
    aa: Any = None


@dataclass(frozen=True)
class SceneStatic:
    """Structural facts of a compiled scene (the subset of the JAX
    SceneStatic that the solid path reads)."""
    n_objects: int
    n_is_targets: int
    mat_types_present: Tuple[int, ...]
    obj_records: Tuple[ObjRecord, ...]
    refr_disp: Tuple[bool, ...]
    pallas_ok: bool


@dataclass(frozen=True)
class SolidTables:
    """Everything the solid kernel reads about a scene.

    geom (O, 24) f32: per-object geometry rows (the JAX `pallas_geom`);
    obj (O, OBJ_COLS) i32: kind, material and plane-axis codes per object;
    dif (S, 4): colour + ambient weight; refr (S, 6): n_re, n_im;
    emi (S, 3); lights (L, 11); is_tab (K, 4): importance-sampled
    target centre + radius; consts (16,): ambient, scene n_re, n_im.
    Empty tables hold one zero row, as in the JAX package.
    n_is_targets is K (is_tab keeps one zero row when K is 0), and
    obj_rows is a host copy of `obj`, so that callers can check a scene
    without reading the device.
    """
    geom: torch.Tensor
    obj: torch.Tensor
    dif: torch.Tensor
    refr: torch.Tensor
    emi: torch.Tensor
    lights: torch.Tensor
    is_tab: torch.Tensor
    consts: torch.Tensor
    n_is_targets: int
    obj_rows: Tuple[Tuple[int, ...], ...]

    TENSORS = ("geom", "obj", "dif", "refr", "emi", "lights", "is_tab",
               "consts")

    def to(self, device):
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in self.TENSORS})


def derive_max_bounces(static: SceneStatic, cap: int = 12) -> int:
    """Bounce budget from scene structure (raytracer_tpu compile.py:604).

    Glossy / refractive / thin-film honour the per-object depth cap;
    diffuse ends after 2 diffuse bounces; emissive is terminal.
    """
    capped = [r.max_depth for r in static.obj_records
              if r.mat_type in (MAT_GLOSSY, MAT_REFRACTIVE, MAT_THINFILM,
                                MAT_CUSTOM)]
    extra = 3 if MAT_DIFFUSE in static.mat_types_present else 1
    return min(max(capped or [0]) + extra, cap)


def derive_split_k(static: SceneStatic, cap: int = 3) -> int:
    """Deterministic Fresnel-split levels (raytracer_tpu compile.py:623):
    on only for scenes without Diffuse, at the deepest split-capable
    recursion, capped."""
    if MAT_DIFFUSE in static.mat_types_present:
        return 0
    depths = [r.max_depth for r in static.obj_records
              if r.mat_type in (MAT_REFRACTIVE, MAT_THINFILM) and not r.mc]
    return min(max(depths or [0]), cap)


def _f(x):
    return np.asarray(x, dtype=F32)


def _stack3(rows):
    if not rows:
        return np.zeros((0, 3), F32)
    return _f(np.stack(rows))


def _arr1(rows):
    return _f(np.asarray(rows, dtype=F32)) if rows else np.zeros((0,), F32)


def _pad_rows(a):
    a = np.asarray(a, F32)
    return np.zeros((1,) + a.shape[1:], F32) if a.shape[0] == 0 else a


def _unit_axis(vec):
    """(axis, sign) when vec is an EXACT +-unit axis in f32, else None."""
    a = np.asarray(vec, F32)
    nz = np.nonzero(a)[0]
    if len(nz) == 1 and abs(a[nz[0]]) == 1.0:
        return int(nz[0]), float(np.sign(a[nz[0]]))
    return None


def obj_table(records, refr_disp):
    """(O, OBJ_COLS) int32 object table from the static records."""
    t = np.zeros((len(records), OBJ_COLS), I32)
    for i, r in enumerate(records):
        t[i, OBJ_KIND] = KIND_CODES[r.kind]
        t[i, OBJ_MAT_TYPE] = r.mat_type
        t[i, OBJ_MAT_SLOT] = r.mat_slot
        t[i, OBJ_MAX_DEPTH] = r.max_depth
        t[i, OBJ_MC] = int(r.mc)
        t[i, OBJ_SHADOW] = int(r.shadow)
        t[i, OBJ_DISP] = int(r.mat_type == MAT_REFRACTIVE
                             and refr_disp[r.mat_slot])
        if r.aa is not None:
            (nax, nsg), (uax, _), (vax, _) = r.aa
            t[i, OBJ_AA_N:OBJ_AA_V + 1] = (nax, int(nsg), uax, vax)
        else:
            t[i, OBJ_AA_N:OBJ_AA_V + 1] = (-1, 0, -1, -1)
    return t


def light_table(dir_l, dir_color, point_pos, point_color, spot_pos,
                spot_dir, spot_color, spot_cos_in, spot_cos_out):
    """(L, 11) light rows [pos_or_dir(3), colour(3), spot_dir(3), cos_in,
    cos_out]: directional rows, then point, then spot
    (raytracer_tpu/ops/pallas_trace.py:1089 `_light_table`)."""
    nd, npt, ns = len(dir_l), len(point_pos), len(spot_pos)
    if nd + npt + ns == 0:
        return np.zeros((1, 11), F32)
    z = lambda n: np.zeros((n, 5), F32)
    return np.concatenate([
        np.concatenate([dir_l, dir_color, z(nd)], axis=1),
        np.concatenate([point_pos, point_color, z(npt)], axis=1),
        np.concatenate([spot_pos, spot_color, spot_dir,
                        np.asarray(spot_cos_in, F32)[:, None],
                        np.asarray(spot_cos_out, F32)[:, None]], axis=1),
    ], axis=0).astype(F32)


def build_solid_tables(records, refr_disp, geom, mats, lights, is_center,
                       is_radius, ambient, scene_n_re, scene_n_im):
    """Kernel tables from host arrays; the JAX package's table layout
    (pallas_trace.py:1134-1150).  `mats` maps the JAX MaterialTables field
    names to arrays, `lights` is the (L, 11) light table."""
    m = {k: np.asarray(v, F32) for k, v in mats.items()}
    col = lambda a: a[:, None]
    dif = np.concatenate([_pad_rows(m["diffuse_color"]),
                          _pad_rows(col(m["diffuse_ambient_weight"]))], axis=1)
    refr = np.concatenate([_pad_rows(m["refr_n_re"]),
                           _pad_rows(m["refr_n_im"])], axis=1)
    emi = _pad_rows(m["emissive_color"])
    is_center = np.asarray(is_center, F32)
    K = int(is_center.shape[0])
    is_tab = (np.concatenate([is_center, np.asarray(is_radius, F32)[:, None]],
                             axis=1) if K else np.zeros((1, 4), F32))
    consts = np.concatenate([np.asarray(ambient, F32),
                             np.asarray(scene_n_re, F32),
                             np.asarray(scene_n_im, F32),
                             np.zeros(7, F32)])
    obj = obj_table(records, refr_disp)
    t = lambda a: torch.from_numpy(np.array(a))     # a writable copy
    return SolidTables(
        geom=t(np.asarray(geom, F32).reshape(-1, 24)), obj=t(obj),
        dif=t(dif), refr=t(refr), emi=t(emi),
        lights=t(np.asarray(lights, F32)), is_tab=t(is_tab), consts=t(consts),
        n_is_targets=K, obj_rows=tuple(tuple(int(v) for v in r) for r in obj))


def compile_scene(scene) -> Tuple[SceneStatic, SolidTables]:
    """Lower a Scene to (SceneStatic, SolidTables) on the CPU."""
    mat_rows = {}      # mat_type -> [material], in slot order
    mat_slots = {}     # id(material) -> slot
    by_kind = {k: [] for k in SOLID_KINDS}   # (primitive, props) per kind

    for prim in scene.scene_primitives:
        if isinstance(prim, Sphere):
            kind = "sphere"
        elif isinstance(prim, Plane):
            kind = "plane"
        elif isinstance(prim, Cuboid):
            kind = "box"
        else:
            raise NotImplementedError(
                f"{type(prim).__name__} is not ported yet: triangles, "
                "meshes, discs and cylinders come with the wavefront slice "
                "(ROADMAP.md 'Modules to port' item 8)")
        mat = prim.material
        if id(mat) not in mat_slots:
            rows = mat_rows.setdefault(mat.mat_type, [])
            mat_slots[id(mat)] = len(rows)
            rows.append(mat)
        props = dict(mat_type=mat.mat_type, mat_slot=mat_slots[id(mat)],
                     max_depth=min(prim.max_ray_depth, 10 ** 6),
                     mc=prim.mc, shadow=prim.shadow)
        by_kind[kind].append((prim, props))

    # ---- static records + (O, 24) geometry rows (compile.py:1596-1662) ----
    records, rows = [], []

    def _row(vals):
        r = np.zeros(24, dtype=F32)
        r[:len(vals)] = vals
        rows.append(r)

    def _rec(kind, p, aa=None):
        records.append(ObjRecord(kind, p["mat_type"], p["mat_slot"],
                                 min(p["max_depth"], 1023), p["mc"],
                                 p["shadow"], aa=aa))

    for prim, p in by_kind["sphere"]:
        _rec("sphere", p)
        _row(list(np.asarray(prim.center)) + [prim.radius])
    for prim, p in by_kind["plane"]:
        c, u, v = prim.center, prim.u_axis, prim.v_axis
        w2, h2, s = prim.width / 2, prim.height / 2, prim.uv_shift
        nrm = np.cross(u, v)
        nrm = nrm / np.linalg.norm(nrm)
        axes = (_unit_axis(nrm), _unit_axis(u), _unit_axis(v))
        _rec("plane", p, aa=(tuple(axes) if all(a is not None for a in axes)
                             else None))
        _row(list(np.asarray(c)) + list(np.asarray(u)) + list(np.asarray(v))
             + list(nrm) + [w2, h2, s[0], s[1]])
    for prim, p in by_kind["box"]:
        whl = (prim.width, prim.height, prim.length)
        _rec("box", p)
        _row(list(np.asarray(prim.basis).reshape(-1))
             + list(np.asarray(prim.lb_local)) + list(np.asarray(prim.rt_local))
             + list(np.asarray(prim.center)) + list(np.asarray(whl)))
    geom = np.stack(rows) if rows else np.zeros((0, 24), F32)

    # ---- material tables (compile.py:1529-1556) ---------------------------
    def solid_of(m, attr):
        return getattr(m, attr).color

    dif = mat_rows.get(MAT_DIFFUSE, [])
    ref = mat_rows.get(MAT_REFRACTIVE, [])
    emi = mat_rows.get(MAT_EMISSIVE, [])
    mats = dict(
        diffuse_color=_stack3([solid_of(m, "diff_texture") for m in dif]),
        diffuse_ambient_weight=_arr1([m.ambient_weight for m in dif]),
        refr_n_re=_stack3([np.real(m.n) for m in ref]),
        refr_n_im=_stack3([np.imag(m.n) for m in ref]),
        emissive_color=_stack3([solid_of(m, "texture_color") for m in emi]),
    )

    # ---- lights (compile.py:1558-1574) ------------------------------------
    slts = [l for l in scene.Light_list if isinstance(l, SpotLight)]
    dlts = [l for l in scene.Light_list if hasattr(l, "Ldir")]
    plts = [l for l in scene.Light_list
            if hasattr(l, "pos") and not isinstance(l, SpotLight)]
    lights = light_table(
        _stack3([l.Ldir for l in dlts]), _stack3([l.color for l in dlts]),
        _stack3([l.pos for l in plts]), _stack3([l.color for l in plts]),
        _stack3([l.pos for l in slts]), _stack3([l.direction for l in slts]),
        _stack3([l.color for l in slts]),
        _arr1([l.cos_inner for l in slts]), _arr1([l.cos_outer for l in slts]))

    is_center = _stack3([p.center for p in scene.importance_sampled_list])
    is_radius = _arr1([p.bounded_sphere_radius
                       for p in scene.importance_sampled_list])

    # ---- the pallas_ok gate (compile.py:1690-1721) -------------------------
    refr_disp = tuple(bool(m.dispersion) for m in ref)
    present = tuple(sorted({r.mat_type for r in records}))
    n_groups_merged = len(
        {(r.mat_type, r.max_depth, r.mc,
          refr_disp[r.mat_slot] if r.mat_type == MAT_REFRACTIVE else None)
         for r in records})
    pallas_ok = (0 < len(records) <= PALLAS_MAX_OBJECTS
                 and len(scene.importance_sampled_list) <= 8
                 and n_groups_merged <= PALLAS_MAX_GROUPS
                 and set(present) <= {MAT_EMISSIVE, MAT_GLOSSY, MAT_DIFFUSE,
                                      MAT_REFRACTIVE})

    static = SceneStatic(
        n_objects=len(records), n_is_targets=int(is_center.shape[0]),
        mat_types_present=present, obj_records=tuple(records),
        refr_disp=refr_disp, pallas_ok=pallas_ok)
    tables = build_solid_tables(
        records, refr_disp, geom, mats, lights, is_center, is_radius,
        _f(scene.ambient_color), _f(np.real(scene.n)), _f(np.imag(scene.n)))
    return static, tables
