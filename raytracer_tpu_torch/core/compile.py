"""Scene compiler, solid and textured subsets: scene -> kernel tables.

Counterpart of raytracer_tpu/core/compile.py (`compile_scene`, `ObjRecord`,
`TexRef`, `EnvSlot`, `SceneStatic`, `derive_max_bounces`, `derive_split_k`,
the texture atlas and the `pallas_ok` / `pallas_tex_ok` gates) plus the
kernel-side tables that raytracer_tpu/ops/pallas_trace.py and
ops/pallas_record.py build at call time (pallas_trace.py:1134-1150,
pallas_record.py:1106-1122).  The float math is the JAX package's numpy
code, so every table matches it bit for bit (tests/test_torch_compile.py,
tests/test_torch_textures.py).

Object ids run spheres, planes, boxes, discs, cylinders, then triangles,
in insertion order within each kind, as in the JAX package.
`compile_scene` gives the kernels' tables (`SolidTables`);
`compile_wavefront` gives the wavefront's per-kind tables (`SceneData`,
compile.py:319-480), the pair the JAX `compile_scene` returns, for every
scene whichever route it renders by.

Triangle meshes add their faces to the triangle tables, with corner
normals and uvs where a mesh carries them.  From TRI_CLUSTER_THRESHOLD
triangles on, and for every scene with MeshInstances, the triangles are
permuted into the binned-SAH leaf order of the port's native library
(native.py) and cut into clusters of TRI_CLUSTER_SIZE rows with one
inflated box each, which the wavefront's clustered sweep visits
(geometry/intersect.py); instances share one object-space copy of their
mesh, and triangle object ids are virtual (compile.py:1162-1400).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..backgrounds.environment import Panorama, SkyBox
from ..geometry.intersect import TRI_CLUSTER_SIZE
from ..geometry.primitive import (Cuboid, Cylinder, Disc, MeshInstances,
                                  Plane, Sphere, Triangle, TriangleMesh)
from ..lights import SpotLight
from ..materials.base import (MAT_CUSTOM, MAT_DIFFUSE, MAT_EMISSIVE, MAT_ENV,
                              MAT_GLOSSY, MAT_REFRACTIVE, MAT_THINFILM)
from ..textures.texture import image as image_texture
from ..textures.texture import solid_color

F32 = np.float32
I32 = np.int32

# the JAX package's Pallas walls (compile.py:1131-1132), kept so that the
# gate routes every scene as the reference does
PALLAS_MAX_OBJECTS = 48
PALLAS_MAX_GROUPS = 36

KIND_CODES = {"sphere": 0, "plane": 1, "box": 2, "tri": 3, "disc": 4, "cyl": 5}
# object order in the tables (compile.py:1500)
KINDS = ("sphere", "plane", "box", "disc", "cyl", "tri")
_PRIM_KIND = ((Sphere, "sphere"), (Plane, "plane"), (Cuboid, "box"),
              (Disc, "disc"), (Cylinder, "cyl"), (Triangle, "tri"),
              (TriangleMesh, "tri"))

# columns of the (O, OBJ_COLS) int32 object table the kernels read;
# OBJ_GID is the record path's shading-group id (`shading_groups`), OBJ_UV
# says whether the object's uv is recorded, OBJ_IMG whether its material
# slot fetches an image texture; OBJ_HU1 / OBJ_HU2 number the dispersive
# groups whose hero-wavelength draws the solid / record kernel takes
# (`dispersive_groups`), -1 for other objects
(OBJ_KIND, OBJ_MAT_TYPE, OBJ_MAT_SLOT, OBJ_MAX_DEPTH, OBJ_MC, OBJ_SHADOW,
 OBJ_DISP, OBJ_AA_N, OBJ_AA_NSIGN, OBJ_AA_U, OBJ_AA_V, OBJ_GID, OBJ_UV,
 OBJ_IMG, OBJ_HU1, OBJ_HU2) = range(16)
OBJ_COLS = 16

# textures whose largest value exceeds this pack as RGB9E5 (compile.py:121)
E5_PACK_LIMIT = 4.0
_E5_BIAS = 15
# largest composed thin-film table in texels (compile.py:662)
TF_COMP_LIMIT = 2_000_000
# triangle count from which the wavefront sweeps triangles in clusters
# (compile.py:1162); below it, the flat blocked sweep
TRI_CLUSTER_THRESHOLD = 1024
# the word of ObjectTables.packed: type | slot << 3 | min(depth, 1023) << 13
# | mc << 23 | shadow << 24 (compile.py:405-417)
PACKED_SLOT_SHIFT = 3
PACKED_DEPTH_SHIFT = 13
PACKED_MC_SHIFT = 23
PACKED_SHADOW_SHIFT = 24


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
class TexRef:
    """An image texture used by a material slot (raytracer_tpu TexRef)."""
    slot: int
    tex: int
    repeat: float
    bilinear: bool = False


@dataclass(frozen=True)
class NormalMapRef:
    """Object `obj` perturbs its normal with texture `tex` (raytracer_tpu
    NormalMapRef).  basis_kind: 'sphere', 'plane', 'box' or 'tri';
    local_id: the row of the kind's geometry table, or for 'tri' the
    ref's number in GeometryTables.tri_nm_slot (obj is then -1)."""
    obj: int
    tex: int
    repeat: float
    basis_kind: str
    local_id: int
    bilinear: bool = False


@dataclass(frozen=True)
class EnvSlot:
    """An environment material slot (raytracer_tpu EnvSlot): its display
    texture, its lightmap, and display + light_intensity * lightmap
    prebaked on the display grid (`combined`), which the replay fetches
    for secondary rays."""
    slot: int
    kind: str
    tex: int
    lightmap: Optional[int]
    combined: Optional[int] = None


@dataclass(frozen=True)
class SceneStatic:
    """Structural facts of a compiled scene (the subset of the JAX
    SceneStatic that the solid and record paths read).

    tex_shapes / tex_offsets / tex_enc describe the texture atlas
    (`texture_atlas`); tf_selp holds each thin-film slot's cubic fit of
    its mean reflectance over cos_i (`_tf_sel_poly`)."""
    n_objects: int
    n_is_targets: int
    mat_types_present: Tuple[int, ...]
    obj_records: Tuple[ObjRecord, ...]
    refr_disp: Tuple[bool, ...]
    pallas_ok: bool
    pallas_tex_ok: bool
    n_dir_lights: int
    n_point_lights: int
    n_spot_lights: int
    diffuse_tex: Tuple[TexRef, ...]
    glossy_tex: Tuple[TexRef, ...]
    emissive_tex: Tuple[TexRef, ...]
    thinfilm_lut: Tuple[TexRef, ...]
    thinfilm_noise: Tuple[TexRef, ...]
    thinfilm_comp: Tuple[TexRef, ...]
    env_slots: Tuple[EnvSlot, ...]
    tex_shapes: Tuple[Tuple[int, int], ...]
    tex_offsets: Tuple[int, ...]
    tex_enc: Tuple[int, ...]
    tf_selp: Tuple[Tuple[float, float, float, float], ...]
    # the wavefront's facts: whether anything samples uv; n_tris counts
    # the triangle object ids, which are virtual under MeshInstances (one
    # record per instance, one id per instance and face); tri_interp says
    # whether the triangles carry corner normals and uvs; normal_maps the
    # normal-mapped objects; env_is_shape the (Hs, Ws) grid of the
    # environment's alias tables, (0, 0) without environment importance
    # sampling; custom_mats the CustomMaterial instances in slot order and
    # custom_fp their parameter fingerprints (`_custom_param_fp`)
    needs_uv: bool = False
    n_tris: int = 0
    tri_interp: bool = False
    normal_maps: Tuple[NormalMapRef, ...] = ()
    env_is_shape: Tuple[int, int] = (0, 0)
    custom_mats: Tuple[Any, ...] = ()
    custom_fp: Tuple[str, ...] = ()
    # bytes of shared memory a block of the scene's kernel (the solid one
    # if pallas_ok, else the record one if pallas_tex_ok) takes for its
    # tables; 0 for a scene inside neither gate.  core/scene.py `route`
    # sends a scene past ops/cuda_build.py SMEM_OPTIN_MAX to the wavefront.
    # Derived from the tables (kernel_smem_bytes), so not compared: the
    # JAX package's SceneStatic has no such field
    kernel_smem: int = field(default=0, compare=False)

    @cached_property
    def kind_counts(self):
        """{kind: object ids} over KINDS (the JAX n_spheres ...)."""
        counts = {k: sum(r.kind == k for r in self.obj_records) for k in KINDS}
        counts["tri"] = self.n_tris
        return counts

    @property
    def has_shadow_objects(self):
        return any(r.shadow for r in self.obj_records)

    @property
    def has_dispersion(self):
        return any(self.refr_disp)

    def image_slots(self):
        """{(mat_type, slot)} of the slots that fetch an image texture."""
        return ({(MAT_DIFFUSE, r.slot) for r in self.diffuse_tex}
                | {(MAT_GLOSSY, r.slot) for r in self.glossy_tex}
                | {(MAT_EMISSIVE, r.slot) for r in self.emissive_tex})


@dataclass(frozen=True)
class SolidTables:
    """Everything the kernels and the replay read about a scene.

    geom (O, 24) f32: per-object geometry rows (the JAX `pallas_geom`);
    obj (O, OBJ_COLS) i32: kind, material, plane-axis and record-path
    codes per object; dif (S, 4): colour + ambient weight; glo (S, 12):
    colour, n_re, n_im, roughness, spec_coeff, diff_coeff; refr (S, 6):
    n_re, n_im; emi (S, 3); tf (S, 6): the thin-film selection cubic
    (c3, c2, c1, c0), thickness, noise factor; lights (L, 11); is_tab
    (K, 4): importance-sampled target centre + radius; consts (16,):
    ambient, scene n_re, n_im; atlas (total,) i32: every texture packed
    one word per texel; tex_scale (T,) f32: each texture's decode scale;
    fetch_i (G + 1, FT_ICOLS) i32 and fetch_f (G + 1, FT_FCOLS) f32: the
    texel fetch of each shading group, by gid (`fetch_table`).
    Empty tables hold one zero row, as in the JAX package.
    n_is_targets is K (is_tab keeps one zero row when K is 0), n_lights
    the (directional, point, spot) counts of the light rows, and obj_rows
    a host copy of `obj`, so that callers can check a scene without
    reading the device.
    """
    geom: torch.Tensor
    obj: torch.Tensor
    dif: torch.Tensor
    glo: torch.Tensor
    refr: torch.Tensor
    emi: torch.Tensor
    tf: torch.Tensor
    lights: torch.Tensor
    is_tab: torch.Tensor
    consts: torch.Tensor
    atlas: torch.Tensor
    tex_scale: torch.Tensor
    fetch_i: torch.Tensor
    fetch_f: torch.Tensor
    n_is_targets: int
    obj_rows: Tuple[Tuple[int, ...], ...]
    n_lights: Tuple[int, int, int] = (0, 0, 0)

    TENSORS = ("geom", "obj", "dif", "glo", "refr", "emi", "tf", "lights",
               "is_tab", "consts", "atlas", "tex_scale", "fetch_i", "fetch_f")

    def to(self, device):
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in self.TENSORS})


# ---------------------------------------------------------------------------
# the wavefront's tables (compile.py:319-480): one struct of arrays per
# primitive kind, in object-id order, and the per-object, material and
# light tables; float32 and int32 tensors, on the CPU until `to`
# ---------------------------------------------------------------------------


class _Tables:
    """A dataclass of tensors (or tuples of them) that moves as one."""

    def to(self, device):
        def mv(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, _Tables):
                return v.to(device)
            if isinstance(v, tuple):
                return tuple(mv(x) for x in v)
            return v
        return dataclasses.replace(
            self, **{f.name: mv(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class GeometryTables(_Tables):
    """Per-kind geometry (the JAX GeometryTables).

    Triangle rows are physical: under MeshInstances, region 0 (Triangle
    and mesh faces, identity transform), then one object-space copy of
    each instanced mesh, every region in leaf order and padded with
    degenerate rows to whole clusters.  Clusters (empty below
    TRI_CLUSTER_THRESHOLD triangles without instances): the inflated
    world box tri_cl_lo / hi, the first physical row tri_cl_start, the
    owning instance tri_cl_inst (empty without instances) and the first
    virtual object id tri_cl_virt.  Virtual ids map to (row, instance)
    through tri_virt_row / tri_virt_inst, and an instance is world =
    inst_rot @ (s x) + inst_trans with inst_inv_scale = 1 / s (instance 0
    is the identity).  tri_vn1-3 / tri_uv1-3: corner normals and uvs,
    empty unless a mesh carries them (flat faces then hold their face
    normal and the barycentric identity uvs).  Normal-mapped meshes:
    tri_tan, each face's uv-aligned tangent, tri_tan_sign, the sign of
    its uv layout's determinant (mirrored uv islands), and tri_nm_slot,
    its 'tri' normal map's number or -1; all empty unless a mesh has a
    normal map (compile.py:364-370)."""
    sphere_center: torch.Tensor    # (S, 3)
    sphere_radius: torch.Tensor    # (S,)
    plane_center: torch.Tensor
    plane_normal: torch.Tensor
    plane_u_axis: torch.Tensor
    plane_v_axis: torch.Tensor
    plane_half_w: torch.Tensor
    plane_half_h: torch.Tensor
    plane_uv_shift: torch.Tensor   # (P, 2)
    box_basis: torch.Tensor        # (B, 3, 3), rows = the box's axes
    box_center: torch.Tensor
    box_whl: torch.Tensor
    box_lb_local: torch.Tensor
    box_rt_local: torch.Tensor
    disc_center: torch.Tensor
    disc_normal: torch.Tensor
    disc_u_axis: torch.Tensor
    disc_v_axis: torch.Tensor
    disc_r_out: torch.Tensor
    disc_r_in: torch.Tensor
    cyl_center: torch.Tensor
    cyl_axis: torch.Tensor
    cyl_u_axis: torch.Tensor
    cyl_v_axis: torch.Tensor
    cyl_radius: torch.Tensor
    cyl_half_h: torch.Tensor
    cyl_capped: torch.Tensor       # (C,) 0/1
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_p3: torch.Tensor
    tri_normal: torch.Tensor
    tri_centroid: torch.Tensor
    tri_n31: torch.Tensor
    tri_n12: torch.Tensor
    tri_n23: torch.Tensor
    tri_cl_lo: torch.Tensor        # (C, 3)
    tri_cl_hi: torch.Tensor
    tri_cl_start: torch.Tensor     # (C,) int32
    tri_vn1: torch.Tensor          # (T, 3) or (0, 3)
    tri_vn2: torch.Tensor
    tri_vn3: torch.Tensor
    tri_uv1: torch.Tensor          # (T, 2) or (0, 2)
    tri_uv2: torch.Tensor
    tri_uv3: torch.Tensor
    tri_cl_inst: torch.Tensor      # (C,) int32 or (0,)
    tri_cl_virt: torch.Tensor      # (C,) int32
    tri_virt_row: torch.Tensor     # (V,) int32 or (0,)
    tri_virt_inst: torch.Tensor    # (V,) int32 or (0,)
    inst_rot: torch.Tensor         # (I, 3, 3) object -> world
    inst_trans: torch.Tensor       # (I, 3)
    inst_inv_scale: torch.Tensor   # (I,)
    tri_tan: torch.Tensor          # (T, 3) or (0, 3)
    tri_tan_sign: torch.Tensor     # (T,) +-1 or (0,)
    tri_nm_slot: torch.Tensor      # (T,) int32 or (0,)


@dataclass(frozen=True)
class ObjectTables(_Tables):
    mat_type: torch.Tensor   # (O,) int32
    mat_slot: torch.Tensor   # (O,) int32, the row of the type's table
    max_depth: torch.Tensor  # (O,) int32, at most 1023
    mc: torch.Tensor         # (O,) bool
    shadow: torch.Tensor     # (O,) bool
    packed: torch.Tensor     # (O,) int32, see PACKED_*_SHIFT


@dataclass(frozen=True)
class MaterialTables(_Tables):
    diffuse_color: torch.Tensor
    diffuse_ambient_weight: torch.Tensor
    glossy_color: torch.Tensor
    glossy_n_re: torch.Tensor
    glossy_n_im: torch.Tensor
    glossy_roughness: torch.Tensor
    glossy_spec: torch.Tensor
    glossy_diff: torch.Tensor
    refr_n_re: torch.Tensor
    refr_n_im: torch.Tensor
    refr_dispersive: torch.Tensor
    tf_thickness: torch.Tensor
    tf_noise: torch.Tensor
    emissive_color: torch.Tensor
    env_light_intensity: torch.Tensor


@dataclass(frozen=True)
class LightTables(_Tables):
    dir_l: torch.Tensor
    dir_color: torch.Tensor
    point_pos: torch.Tensor
    point_color: torch.Tensor
    spot_pos: torch.Tensor
    spot_dir: torch.Tensor
    spot_color: torch.Tensor
    spot_cos_in: torch.Tensor    # (S,) cos(inner half-angle)
    spot_cos_out: torch.Tensor   # (S,) cos(outer half-angle)


@dataclass(frozen=True)
class SceneData(_Tables):
    """The wavefront's scene tables (the JAX SceneData less the kernels'
    packed rows).  textures: one (H, W, 3) float32 tensor per registered
    texture, in atlas order.  env_is_prob / env_is_alias / env_is_pdf:
    the environment's alias tables over SceneStatic.env_is_shape cells
    (`_env_is_tables`), empty without environment importance sampling."""
    geom: GeometryTables
    obj: ObjectTables
    mats: MaterialTables
    lights: LightTables
    is_center: torch.Tensor      # (K, 3) importance-sampled targets
    is_radius: torch.Tensor      # (K,)
    textures: Tuple[torch.Tensor, ...]
    ambient_color: torch.Tensor  # (3,)
    scene_n_re: torch.Tensor     # (3,)
    scene_n_im: torch.Tensor     # (3,)
    env_is_prob: torch.Tensor    # (Hs * Ws,) float32 or (0,)
    env_is_alias: torch.Tensor   # (Hs * Ws,) int32 or (0,)
    env_is_pdf: torch.Tensor     # (Hs * Ws,) float32 or (0,)


def _t(a, dtype=F32):
    """A tensor of `a` as `dtype` (a writable copy)."""
    return torch.from_numpy(np.array(a, dtype=dtype))


# float32 texture tables, keyed by the identity of the host arrays (held)
_TEX_F32_CACHE = {}


def texture_f32(arr):
    """(H, W, 3) float32 tensor of a texture: 2-D maps repeat into three
    channels, extra channels drop (compile.py:81 `_texture_to_device`)."""
    hit = _TEX_F32_CACHE.get(id(arr))
    if hit is None:
        a = np.asarray(arr, dtype=F32)
        if a.ndim == 2:
            a = a[..., None].repeat(3, axis=-1)
        hit = (arr, torch.from_numpy(np.ascontiguousarray(a[..., :3])))
        _TEX_F32_CACHE[id(arr)] = hit
    return hit[1]


def pack_objects(records, repeats=None):
    """ObjectTables of the static records (compile.py:1500-1522), record i
    repeated repeats[i] times (an instance's record covers its mesh's
    faces)."""
    col = lambda k, dt: (np.asarray([getattr(r, k) for r in records], dt)
                         if repeats is None else np.repeat(
                             np.asarray([getattr(r, k) for r in records], dt),
                             repeats))
    mt, sl = col("mat_type", I32), col("mat_slot", I32)
    dep = np.minimum(col("max_depth", I32), 1023)
    mc, sh = col("mc", bool), col("shadow", bool)
    packed = (mt | (sl << PACKED_SLOT_SHIFT) | (dep << PACKED_DEPTH_SHIFT)
              | (mc.astype(I32) << PACKED_MC_SHIFT)
              | (sh.astype(I32) << PACKED_SHADOW_SHIFT))
    return ObjectTables(mat_type=_t(mt, I32), mat_slot=_t(sl, I32),
                        max_depth=_t(dep, I32), mc=_t(mc, bool),
                        shadow=_t(sh, bool), packed=_t(packed, I32))


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


def _i(x):
    return np.asarray(x, dtype=I32)


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


def shading_groups(records):
    """The record path's shading groups (pallas_record.py:53): one per
    distinct (mat_type, slot, max_depth, mc), numbered from 1 in order of
    first appearance; gid 0 means "no hit".  Returns ({key: {"gid", "ids"}},
    [keys in order])."""
    groups, order = {}, []
    for i, rec in enumerate(records):
        key = (rec.mat_type, rec.mat_slot, rec.max_depth, rec.mc)
        if key not in groups:
            groups[key] = {"gid": len(order) + 1, "ids": []}
            order.append(key)
        groups[key]["ids"].append(i)
    return groups, order


# columns of the per-group fetch table (`fetch_table`), one row per gid;
# the record kernel (csrc/record_trace.cu) reads the same layout
FT_USE_NONE, FT_USE_ADD, FT_USE_BETA, FT_USE_FILM = range(4)
FT_MODE_NONE, FT_MODE_UV, FT_MODE_COMP, FT_MODE_TWO = range(4)
(FT_USE, FT_MODE, FT_OFF, FT_W, FT_H, FT_E5, FT_BIL, FT_SEC, FT_OFF2, FT_W2,
 FT_H2, FT_E5_2, FT_LH, FT_NH, FT_NW) = range(15)
FT_ICOLS = 16
(FT_FREP, FT_GREP, FT_SCALE, FT_FREP2, FT_GREP2, FT_SCALE2, FT_TF_THICK,
 FT_TF_NOISE) = range(8)
FT_FCOLS = 8


def fetch_table(static, tex_scale, tf):
    """The texel fetch of every shading group, as tables indexed by gid:
    the decisions of the replay's group loop (ops/replay.py `replay`,
    pallas_record.py:849-1060 `Round`) made once per scene.  Returns
    (fetch_i (G + 1, FT_ICOLS) int32, fetch_f (G + 1, FT_FCOLS) float32);
    row 0 (no hit) and rows of groups without a texture are zero.

    Per group: FT_USE says how the texel enters the path (FT_USE_ADD: the
    `tex` factor of add_t; FT_USE_BETA: beta's; FT_USE_FILM: F on add_t,
    and F or 1 - F on beta by the branch flag).  FT_MODE says how it is
    fetched:
    - FT_MODE_UV: round 1 at the uv wrap of the texture (FT_OFF, FT_W,
      FT_H, FT_FREP = W * repeat and FT_GREP = H * repeat as float32,
      FT_SCALE, FT_E5 RGB9E5, FT_BIL bilinear); with FT_SEC (an
      environment with a lightmap) bounces after the first read the
      combined table instead (the *2 fields);
    - FT_MODE_COMP: the composed thin-film table (FT_OFF, FT_SCALE,
      FT_E5), indexed by (cos row, noise texel): FT_LH rows of FT_NH x
      FT_NW texels, FT_FREP = nW * 0.5, FT_GREP = nH * 0.5;
    - FT_MODE_TWO: a thin film past TF_COMP_LIMIT: round 1 the noise
      texture at repeat 0.5, round 2 the LUT (the *2 fields) at (cos row,
      thickness column), the column FT_TF_THICK + FT_TF_NOISE * (noise -
      0.5)."""
    groups, order = shading_groups(static.obj_records)
    fi = np.zeros((len(order) + 1, FT_ICOLS), I32)
    ff = np.zeros((len(order) + 1, FT_FCOLS), F32)
    tex_scale = np.asarray(tex_scale, F32)
    tf = np.asarray(tf, F32)
    dif_tex = {r.slot: r for r in static.diffuse_tex}
    glo_tex = {r.slot: r for r in static.glossy_tex}
    emi_tex = {r.slot: r for r in static.emissive_tex}
    env_by_slot = {e.slot: e for e in static.env_slots}
    tf_lut = {r.slot: r for r in static.thinfilm_lut}
    tf_noise = {r.slot: r for r in static.thinfilm_noise}
    tf_comp = {r.slot: r for r in static.thinfilm_comp}

    def put(g, tex, repeat=1.0, bilinear=False, second=False):
        Hh, Ww = static.tex_shapes[tex]
        ic = (FT_OFF2, FT_W2, FT_H2, FT_E5_2) if second else (
            FT_OFF, FT_W, FT_H, FT_E5)
        fc = (FT_FREP2, FT_GREP2, FT_SCALE2) if second else (
            FT_FREP, FT_GREP, FT_SCALE)
        fi[g, list(ic)] = (static.tex_offsets[tex], Ww, Hh, static.tex_enc[tex])
        # W * repeat and H * repeat rounded to float32, as the replay's
        # python floats are
        ff[g, list(fc)] = (float(Ww * repeat), float(Hh * repeat),
                           tex_scale[tex])
        if not second:
            fi[g, FT_BIL] = int(bool(bilinear))

    for key in order:
        mt, slot, _maxd, _mc = key
        g = groups[key]["gid"]
        ref = {MAT_DIFFUSE: dif_tex, MAT_GLOSSY: glo_tex,
               MAT_EMISSIVE: emi_tex}.get(mt, {}).get(slot)
        if mt == MAT_ENV:
            env = env_by_slot[slot]
            fi[g, [FT_USE, FT_MODE]] = FT_USE_ADD, FT_MODE_UV
            put(g, env.tex)
            if env.combined is not None:
                fi[g, FT_SEC] = 1
                put(g, env.combined, second=True)
        elif mt == MAT_THINFILM and slot in tf_comp:
            comp = tf_comp[slot]
            LH = int(comp.repeat)
            cH, cW = static.tex_shapes[comp.tex]
            nH, nW = cH // LH, cW
            fi[g, [FT_USE, FT_MODE]] = FT_USE_FILM, FT_MODE_COMP
            put(g, comp.tex)
            fi[g, [FT_LH, FT_NH, FT_NW]] = LH, nH, nW
            ff[g, [FT_FREP, FT_GREP]] = nW * 0.5, nH * 0.5
        elif mt == MAT_THINFILM:
            fi[g, [FT_USE, FT_MODE]] = FT_USE_FILM, FT_MODE_TWO
            put(g, tf_noise[slot].tex, 0.5)
            put(g, tf_lut[slot].tex, second=True)
            ff[g, [FT_TF_THICK, FT_TF_NOISE]] = tf[slot, 4], tf[slot, 5]
        elif ref is not None:
            fi[g, [FT_USE, FT_MODE]] = (
                FT_USE_BETA if mt == MAT_DIFFUSE else FT_USE_ADD, FT_MODE_UV)
            put(g, ref.tex, ref.repeat, ref.bilinear)
    return fi, ff


def dispersive_groups(records, refr_disp):
    """The dispersive refractive groups of each kernel, numbered in order
    of first appearance: ({(max_depth, mc): n}, {(slot, max_depth, mc): n}).

    The solid kernel merges groups by (type, max_depth, mc, dispersion)
    and draws one hero-wavelength uniform per merged dispersive group at
    every bounce it shades (pallas_trace.py:522-529, 857-859); the record
    kernel draws one per (type, slot, max_depth, mc) group at every
    bounce (pallas_record.py:473-475)."""
    merged, per_slot = {}, {}
    for r in records:
        if r.mat_type == MAT_REFRACTIVE and refr_disp[r.mat_slot]:
            merged.setdefault((r.max_depth, r.mc), len(merged))
            per_slot.setdefault((r.mat_slot, r.max_depth, r.mc), len(per_slot))
    return merged, per_slot


def obj_table(records, refr_disp, img_slots=frozenset()):
    """(O, OBJ_COLS) int32 object table from the static records."""
    t = np.zeros((len(records), OBJ_COLS), I32)
    groups, _ = shading_groups(records)
    merged, per_slot = dispersive_groups(records, refr_disp)
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
        img = (r.mat_type, r.mat_slot) in img_slots
        t[i, OBJ_GID] = groups[(r.mat_type, r.mat_slot, r.max_depth, r.mc)]["gid"]
        t[i, OBJ_UV] = int(img or r.mat_type in (MAT_ENV, MAT_THINFILM))
        t[i, OBJ_IMG] = int(img)
        disp = bool(t[i, OBJ_DISP])
        t[i, OBJ_HU1] = merged[(r.max_depth, r.mc)] if disp else -1
        t[i, OBJ_HU2] = per_slot[(r.mat_slot, r.max_depth, r.mc)] if disp else -1
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
                       is_radius, ambient, scene_n_re, scene_n_im,
                       tf_rows=(), atlas=None, tex_scale=None,
                       img_slots=frozenset(), n_lights=(0, 0, 0), *, static):
    """Kernel tables from host arrays; the JAX package's table layout
    (pallas_trace.py:1134-1150, pallas_record.py:1106-1122).  `mats` maps
    the JAX MaterialTables field names to arrays, `lights` is the (L, 11)
    light table holding n_lights = (directional, point, spot) rows,
    `tf_rows` one (c3, c2, c1, c0, thickness, noise) row per thin-film
    slot, `atlas` / `tex_scale` the texture atlas, `static` the scene's
    SceneStatic, from which the fetch table is built (`fetch_table`)."""
    m = {k: np.asarray(v, F32) for k, v in mats.items()}
    col = lambda a: a[:, None]
    dif = np.concatenate([_pad_rows(m["diffuse_color"]),
                          _pad_rows(col(m["diffuse_ambient_weight"]))], axis=1)
    glo = np.concatenate([
        _pad_rows(m["glossy_color"]), _pad_rows(m["glossy_n_re"]),
        _pad_rows(m["glossy_n_im"]), _pad_rows(col(m["glossy_roughness"])),
        _pad_rows(col(m["glossy_spec"])), _pad_rows(col(m["glossy_diff"]))],
        axis=1)
    refr = np.concatenate([_pad_rows(m["refr_n_re"]),
                           _pad_rows(m["refr_n_im"])], axis=1)
    emi = _pad_rows(m["emissive_color"])
    tf = _pad_rows(np.asarray(tf_rows, F32).reshape(-1, 6))
    is_center = np.asarray(is_center, F32)
    K = int(is_center.shape[0])
    is_tab = (np.concatenate([is_center, np.asarray(is_radius, F32)[:, None]],
                             axis=1) if K else np.zeros((1, 4), F32))
    consts = np.concatenate([np.asarray(ambient, F32),
                             np.asarray(scene_n_re, F32),
                             np.asarray(scene_n_im, F32),
                             np.zeros(7, F32)])
    obj = obj_table(records, refr_disp, img_slots)
    atlas = np.zeros((1,), I32) if atlas is None else np.asarray(atlas, I32)
    tex_scale = (np.ones((1,), F32) if tex_scale is None
                 else np.asarray(tex_scale, F32))
    fetch_i, fetch_f = fetch_table(static, tex_scale, tf)
    t = lambda a: torch.from_numpy(np.array(a))     # a writable copy
    return SolidTables(
        geom=t(np.asarray(geom, F32).reshape(-1, 24)), obj=t(obj),
        dif=t(dif), glo=t(glo), refr=t(refr), emi=t(emi), tf=t(tf),
        lights=t(np.asarray(lights, F32)), is_tab=t(is_tab), consts=t(consts),
        atlas=t(atlas), tex_scale=t(tex_scale), fetch_i=t(fetch_i),
        fetch_f=t(fetch_f), n_is_targets=K,
        obj_rows=tuple(tuple(int(v) for v in r) for r in obj),
        n_lights=tuple(int(c) for c in n_lights))


# ---------------------------------------------------------------------------
# the texture atlas (compile.py:104-180) and the thin-film / env tables
# ---------------------------------------------------------------------------

# packed textures and atlases, keyed by the identity of the host arrays
# (held, so that an id is never reused while its entry lives)
_PACKED_CACHE = {}
_ATLAS_CACHE = {}


def _pack_e5(a):
    """(H, W, 3) f32 >= 0 -> (H, W) int32 RGB9E5 words (compile.py:125)."""
    a = np.clip(a, 0.0, (511.0 / 512.0) * 2.0 ** 16)
    maxc = np.maximum(a.max(axis=-1), 1e-30)
    e = np.clip(np.floor(np.log2(maxc)) + _E5_BIAS + 1, 0, 31).astype(np.uint32)
    denom = np.exp2(e.astype(np.float64) - _E5_BIAS - 9)
    m = np.clip(a / denom[..., None] + 0.5, 0, 511).astype(np.uint32)
    return ((e << 27) | (m[..., 0] << 18) | (m[..., 1] << 9)
            | m[..., 2]).view(np.int32)


def _texture_packed(arr):
    """(words (H*W,) int32, scale, (H, W), enc) of one texture: 10-10-10
    bits over a per-texture scale (enc 0), or RGB9E5 for maps brighter
    than E5_PACK_LIMIT (enc 1) (compile.py:136)."""
    hit = _PACKED_CACHE.get(id(arr))
    if hit is None:
        a = np.asarray(arr, dtype=F32)
        if a.ndim == 2:
            a = a[..., None].repeat(3, axis=-1)
        a = np.ascontiguousarray(a[..., :3])
        amax = float(np.max(a)) if a.size else 1.0
        if amax > E5_PACK_LIMIT:
            packed, scale, enc = _pack_e5(a), 1.0, 1
        else:
            scale, enc = float(max(1.0, amax)), 0
            q = np.clip(a / scale * 1023.0 + 0.5, 0.0, 1023.0).astype(np.uint32)
            packed = ((q[..., 0] << 20) | (q[..., 1] << 10)
                      | q[..., 2]).astype(np.int32)
        hit = (arr, packed.reshape(-1), scale,
               (int(a.shape[0]), int(a.shape[1])), enc)
        _PACKED_CACHE[id(arr)] = hit
    return hit[1:]


def texture_atlas(arrs):
    """(atlas (total,) int32, scales (T,) f32, shapes, offsets, encodings)
    of the textures `arrs`, in order (compile.py:158)."""
    key = tuple(id(a) for a in arrs)
    hit = _ATLAS_CACHE.get(key)
    if hit is None:
        parts, scales, shapes, offsets, encs = [], [], [], [], []
        off = 0
        for a in arrs:
            p, s, shp, enc = _texture_packed(a)
            parts.append(p)
            scales.append(s)
            shapes.append(shp)
            offsets.append(off)
            encs.append(enc)
            off += shp[0] * shp[1]
        atlas = np.concatenate(parts) if parts else np.zeros((1,), I32)
        hit = (arrs, atlas, np.asarray(scales or [1.0], F32), tuple(shapes),
               tuple(offsets), tuple(encs))
        _ATLAS_CACHE[key] = hit
    return hit[1:]


def _tf_composed(mat):
    """Composed thin-film reflectance table, or None when larger than
    TF_COMP_LIMIT texels (compile.py:665):
    C[(row * nH + rn) * nW + cn] = lut[row, col(noise[rn, cn])], the
    chained noise -> LUT fetch precomposed.  Cached on the material."""
    lut = np.asarray(mat.lut, np.float32)
    LH, LW = lut.shape[:2]
    key = (id(mat.lut), id(mat.noise_texture), float(mat.thickness),
           float(mat.noise_factor))
    cached = getattr(mat, "_tf_comp_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if mat.noise_factor == 0.0:
        col = int(np.clip(float(mat.thickness), 0, LW - 1))
        comp = np.ascontiguousarray(lut[:, col:col + 1, :3])   # (LH, 1, 3)
    else:
        noise = np.asarray(mat.noise_texture, np.float32)
        nH, nW = noise.shape[:2]
        if LH * nH * nW > TF_COMP_LIMIT:
            mat._tf_comp_cache = (key, None)
            return None
        th = mat.thickness + mat.noise_factor * (noise - 0.5)
        col = np.clip(th.astype(np.int32), 0, LW - 1)           # (nH, nW)
        comp = lut[:, col, :3].reshape(LH * nH, nW, 3)
    mat._tf_comp_cache = (key, comp)
    return comp


def _env_combined(mat, display):
    """display + light_intensity * lightmap on the display grid,
    nearest-resampled when the grids differ (compile.py:700).  Cached on
    the material."""
    key = (id(display), id(mat.lightmap), float(mat.light_intensity))
    cached = getattr(mat, "_env_comb_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    disp = np.asarray(display, np.float32)[..., :3]
    lm = np.asarray(mat.lightmap, np.float32)[..., :3]
    if lm.shape[:2] != disp.shape[:2]:
        ys = np.arange(disp.shape[0]) * lm.shape[0] // disp.shape[0]
        xs = np.arange(disp.shape[1]) * lm.shape[1] // disp.shape[1]
        lm = lm[ys][:, xs]
    out = (disp + np.float32(mat.light_intensity) * lm).astype(np.float32)
    mat._env_comb_cache = (key, out)
    return out


def _tf_sel_poly(m):
    """Branch-selection cubic of a thin-film material (compile.py:720):
    least-squares fit in cos_i of the channel-mean reflectance of its LUT
    at the mean film thickness, highest power first."""
    lut = np.asarray(m.lut, np.float64)
    H, W = lut.shape[:2]
    cos = np.linspace(1e-3, 1.0, 256)
    rows = np.clip((cos * H).astype(int), 0, H - 1)
    col = int(np.clip(m.thickness, 0, W - 1))
    F = lut[rows, col, :3].mean(axis=-1)
    return tuple(float(c) for c in np.polyfit(cos, F, 3))


# environment importance sampling: alias tables over an equirect map's
# luminance, keyed by the identity of the host array (held)
_ENV_IS_CACHE = {}


def _build_alias(mass):
    """Walker alias tables (prob float32, alias int32) of the discrete
    distribution `mass`, on the host (compile.py:228)."""
    n = mass.shape[0]
    p = mass / max(mass.sum(), 1e-30) * n
    alias = np.arange(n, dtype=I32)
    prob = np.ones(n, F32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    return prob, alias


def _env_is_tables(arr, max_h=128, max_w=256):
    """(prob, alias, pdf_table, (Hs, Ws)) of an equirect map
    (compile.py:243).

    The cells are a uniform (Hs, Ws) grid over the (u, v) square in the
    environment fetch's convention (sphere uv, the fetch's negated row);
    a cell's mass pools its texels' luminance times solid angle, and
    pdf_table is the normalised mass over the cell's exact solid angle,
    so pdf(d) is exact for the sampler whatever the pooling."""
    hit = _ENV_IS_CACHE.get(id(arr))
    if hit is not None:
        return hit[1]
    a = np.asarray(arr, np.float64)
    H, W = a.shape[0], a.shape[1]
    lum = a[..., :3].mean(-1) if a.ndim == 3 else a
    # v in [iv/H, (iv+1)/H) fetches row (-iv) mod H
    lum_v = lum[(-np.arange(H)) % H]
    # a texel's solid angle: its band in sin(elevation) times 2 pi / W
    sl = -np.cos(np.pi * np.arange(H + 1) / H)
    w_tex = (sl[1:] - sl[:-1]) * (2.0 * np.pi / W)
    Hs, Ws = min(H, max_h), min(W, max_w)
    rowmap = np.arange(H) * Hs // H
    colmap = np.arange(W) * Ws // W
    mass = np.zeros((Hs, Ws))
    np.add.at(mass, (rowmap[:, None], colmap[None, :]), lum_v * w_tex[:, None])
    slc = -np.cos(np.pi * np.arange(Hs + 1) / Hs)
    w_cell = (slc[1:] - slc[:-1])[:, None] * (2.0 * np.pi / Ws)
    total = max(mass.sum(), 1e-30)
    pdf = (mass / total) / w_cell
    prob, alias = _build_alias(mass.reshape(-1))
    out = (prob, alias, pdf.reshape(-1).astype(F32), (Hs, Ws))
    _ENV_IS_CACHE[id(arr)] = (arr, out)
    return out


def _custom_param_fp(m) -> str:
    """Parameter fingerprint of a CustomMaterial (compile.py:734): plain
    scalars, strings and flat tuples by value, arrays and other objects by
    identity."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    for k in sorted(vars(m)):
        v = vars(m)[k]
        if isinstance(v, (int, float, bool, str, bytes, type(None))) or (
                isinstance(v, tuple)
                and all(isinstance(x, (int, float, bool, str)) for x in v)):
            h.update(f"{k}={v!r};".encode())
        else:
            h.update(f"{k}:{id(v)};".encode())
    return h.hexdigest()


class _Textures:
    """Texture and material-slot registration in the JAX package's order
    (compile.py:937-988): the atlas offsets depend on it."""

    def __init__(self):
        self.arrays, self._ids = [], {}
        self.mat_rows, self.mat_slots = {}, {}
        self.refs = {k: [] for k in ("diffuse", "glossy", "emissive", "tf_lut",
                                     "tf_noise", "tf_comp")}
        self.env_slots = []
        self.normal_maps = []

    def add(self, arr):
        if id(arr) not in self._ids:
            self._ids[id(arr)] = len(self.arrays)
            self.arrays.append(arr)
        return self._ids[id(arr)]

    def material_slot(self, mat):
        if id(mat) in self.mat_slots:
            return self.mat_slots[id(mat)]
        t = mat.mat_type
        rows = self.mat_rows.setdefault(t, [])
        slot = len(rows)
        rows.append(mat)
        self.mat_slots[id(mat)] = slot

        def tex_of(tex, refs):
            if isinstance(tex, image_texture):
                refs.append(TexRef(slot, self.add(tex.img), tex.repeat,
                                   tex.bilinear))

        if t == MAT_DIFFUSE:
            tex_of(mat.diff_texture, self.refs["diffuse"])
        elif t == MAT_GLOSSY:
            tex_of(mat.diff_texture, self.refs["glossy"])
        elif t == MAT_EMISSIVE:
            tex_of(mat.texture_color, self.refs["emissive"])
        elif t == MAT_THINFILM:
            self.refs["tf_lut"].append(TexRef(slot, self.add(mat.lut), 1.0))
            self.refs["tf_noise"].append(
                TexRef(slot, self.add(mat.noise_texture), 1.0))
            comp = _tf_composed(mat)
            if comp is not None:
                # repeat carries the LUT row count, which splits the index
                rows_ = comp.shape[0] // (1 if mat.noise_factor == 0.0
                                          else mat.noise_texture.shape[0])
                self.refs["tf_comp"].append(
                    TexRef(slot, self.add(comp), float(rows_)))
        elif t == MAT_ENV:
            tex = mat.blur_texture if mat.blur_texture is not None else mat.texture
            # the lightmap, then the combined table, then the display
            lm = self.add(mat.lightmap) if mat.lightmap is not None else None
            cm = (self.add(_env_combined(mat, tex))
                  if mat.lightmap is not None else None)
            self.env_slots.append(EnvSlot(slot, "box", self.add(tex), lm, cm))
        return slot

    def normal_map(self, mat, kind, local_id, obj=-1):
        """Register `mat`'s normal map, if any, after its material slot
        (compile.py:1011-1069): the texture order depends on it."""
        if mat.normalmap is None:
            return None
        ref = NormalMapRef(obj, self.add(mat.normalmap), mat.normalmap_repeat,
                           kind, local_id, mat.normalmap_bilinear)
        self.normal_maps.append(ref)
        return ref

    def n_tri_maps(self):
        return sum(r.basis_kind == "tri" for r in self.normal_maps)

    def patch_env_kind(self, slot, kind):
        for i, e in enumerate(self.env_slots):
            if e.slot == slot:
                self.env_slots[i] = dataclasses.replace(e, kind=kind)


# ---------------------------------------------------------------------------
# triangles: corner attributes, the leaf order, clusters and instances
# (compile.py:1162-1400); host numpy in the JAX package's dtypes (float32
# vertices, float64 corner attributes until the tables), so that every
# table is bit for bit the JAX package's
# ---------------------------------------------------------------------------


def _cluster_runs(TV, B):
    """(starts, bbox_lo, bbox_hi) of the fixed runs of B leaf-ordered
    triangles, the boxes in float64 (compile.py:1165)."""
    T = TV.shape[0]
    C = -(-T // B)
    v64 = np.pad(TV.astype(np.float64).reshape(-1, 3),
                 ((0, (C * B - T) * 3), (0, 0)),
                 constant_values=np.nan).reshape(C, B * 3, 3)
    starts = np.arange(C, dtype=np.int64) * B
    return starts, np.nanmin(v64, axis=1), np.nanmax(v64, axis=1)


def _inflate(lo, hi):
    """Conservative float32 inflation of the cluster boxes
    (compile.py:1184): a box only gates the triangle test, so rounding
    must never cull a cluster that a ray hits."""
    pad = 1e-4 * (hi - lo + np.abs(lo) + np.abs(hi) + 1.0)
    return _f(lo - pad), _f(hi + pad)


def _inst_world_aabb(lo, hi, R, t, s):
    """World boxes of (C, 3) object-space boxes under world = R @ (s x) + t:
    the min and max of the 8 transformed corners (compile.py:1192)."""
    corners = np.stack([np.where(np.asarray(m, bool)[None, :], hi, lo)
                        for m in np.ndindex(2, 2, 2)], axis=1)    # (C, 8, 3)
    w = (s * corners) @ R.T + t[None, None, :]
    return w.min(axis=1), w.max(axis=1)


def _default_cvn(tv):
    """Corner normals of flat faces: the face normal at every corner."""
    fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    return np.repeat(fn[:, None, :], 3, axis=1).astype(np.float64)


def _default_cuv(T):
    """Corner uvs of faces without vt: the barycentric identity."""
    return np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), (T, 1, 1))


def _layout_instanced(TV, CVN, CUV, TNM, groups):
    """Physical and virtual triangle layout of a scene with MeshInstances
    (compile.py:1201).

    Region 0 holds the plain triangles (identity transform), then each
    group one object-space copy of its mesh; every region is in leaf
    order and padded with zero rows to whole clusters, so that a
    cluster's rows never belong to another region.  Each (cluster,
    instance) pair is one cluster record, its box the object-space box
    pushed through the instance's transform.  Virtual ids: region 0's
    rows, then one id per (instance, row).  TNM: region 0's normal-map
    slot per face, or None.  groups: (mesh, [instance dicts with R, t,
    s], normal-map ref number or None) in scene order."""
    from ..native import build_bvh

    B = TRI_CLUSTER_SIZE
    any_attrs = CVN is not None or any(
        mesh.corner_normals is not None or mesh.corner_uvs is not None
        for mesh, _, _ in groups)
    any_nm = TNM is not None or any(nm is not None for _, _, nm in groups)
    phys_tv, phys_cvn, phys_cuv, phys_tnm = [], [], [], []
    cl_lo, cl_hi, cl_start, cl_virt, cl_inst = [], [], [], [], []
    inst_R, inst_t, inst_s = [np.eye(3)], [np.zeros(3)], [1.0]
    virt_rows, virt_insts = [], []
    state = {"phys": 0, "virt": 0}

    def add_region(tvr, cvnr, cuvr, tnmr, transforms):
        """transforms: (R, t, s, instance id or None to allocate one)."""
        T = tvr.shape[0]
        perm = (build_bvh(tvr)["order"] if T >= 2
                else np.arange(T, dtype=np.int64))
        tvr = tvr[perm]
        starts, lo, hi = _cluster_runs(tvr, B)
        C = starts.shape[0]
        padr = C * B - T
        phys_tv.append(np.pad(tvr, ((0, padr), (0, 0), (0, 0))))
        if any_attrs:
            # given tables are in face order; the defaults come from the
            # leaf-ordered vertices
            cvnr = _default_cvn(tvr) if cvnr is None else cvnr[perm]
            cuvr = _default_cuv(T) if cuvr is None else cuvr[perm]
            phys_cvn.append(np.pad(cvnr, ((0, padr), (0, 0), (0, 0))))
            phys_cuv.append(np.pad(cuvr, ((0, padr), (0, 0), (0, 0))))
        if any_nm:
            tnmr = (np.full((T,), -1, I32) if tnmr is None
                    else np.asarray(tnmr)[perm])
            phys_tnm.append(np.pad(tnmr, (0, padr), constant_values=-1))
        for (R, tr, s, inst_id) in transforms:
            if inst_id is None:
                inst_id = len(inst_R)
                inst_R.append(R)
                inst_t.append(tr)
                inst_s.append(s)
            lo_w, hi_w = _inflate(*_inst_world_aabb(lo, hi, R, tr, s))
            cl_lo.append(lo_w)
            cl_hi.append(hi_w)
            cl_start.append(state["phys"] + starts)
            cl_virt.append(state["virt"] + starts)
            cl_inst.append(np.full((C,), inst_id, I32))
            virt_rows.append(state["phys"] + np.arange(T, dtype=np.int64))
            virt_insts.append(np.full((T,), inst_id, I32))
            state["virt"] += T
        state["phys"] += C * B
        return perm

    perm0 = None
    if TV.shape[0]:
        perm0 = add_region(TV, CVN, CUV, TNM,
                           [(np.eye(3), np.zeros(3), 1.0, 0)])
    for mesh, insts, nm in groups:
        tvr = np.asarray(mesh.triangles, F32)
        cvnr = cuvr = None
        if any_attrs:
            cvnr = (np.asarray(mesh.corner_normals, np.float64)
                    if mesh.corner_normals is not None else None)
            cuvr = (np.asarray(mesh.corner_uvs, np.float64)
                    if mesh.corner_uvs is not None else None)
        tnmr = (np.full((tvr.shape[0],), -1 if nm is None else nm, I32)
                if any_nm else None)
        add_region(tvr, cvnr, cuvr, tnmr,
                   [(i["R"], i["t"], i["s"], None) for i in insts])
    cat = np.concatenate
    return dict(
        TV=cat(phys_tv).astype(F32),
        CVN=cat(phys_cvn) if any_attrs else None,
        CUV=cat(phys_cuv) if any_attrs else None,
        TNM=cat(phys_tnm) if any_nm else None,
        cl_lo=cat(cl_lo), cl_hi=cat(cl_hi),
        cl_start=_i(cat(cl_start)), cl_virt=_i(cat(cl_virt)),
        cl_inst=cat(cl_inst),
        virt_row=_i(cat(virt_rows)), virt_inst=cat(virt_insts),
        inst_rot=_f(np.stack(inst_R)), inst_trans=_f(np.stack(inst_t)),
        inst_inv_scale=_f(1.0 / np.asarray(inst_s)),
        n_virtual=state["virt"], perm0=perm0)


def _triangle_tables(tri, groups):
    """The triangle side of a compile (compile.py:1320-1400).

    tri: (primitive, props) of the Triangle and TriangleMesh objects in
    scene order (props["nm"]: a mesh's normal-map ref number, or None);
    groups: (mesh, [instance dicts], normal-map ref or None) of the
    MeshInstances.  Returns a dict: TV (T, 3, 3) float32 in table order,
    CVN / CUV the float64 corner normals and uvs (None when no mesh
    carries them), TTAN / TSGN / TNM the tangent tables of normal-mapped
    meshes (None without), the row props of region 0 in table order, the
    cluster and instance tables (None without clusters), and n_virtual,
    the triangle object ids."""
    parts, props, attr_blocks, nm_blocks = [], [], [], []
    for q, p in tri:
        start = len(props)
        if isinstance(q, TriangleMesh):
            parts.append(np.asarray(q.triangles, F32))
            props.extend([p] * len(q.faces))
            if q.corner_normals is not None or q.corner_uvs is not None:
                attr_blocks.append((start, len(q.faces), q.corner_normals,
                                    q.corner_uvs))
            if p.get("nm") is not None:
                nm_blocks.append((start, len(q.faces), p["nm"]))
        else:
            parts.append(np.asarray([(q.p1, q.p2, q.p3)], F32))
            props.append(p)
    TV = np.concatenate(parts) if parts else np.zeros((0, 3, 3), F32)

    # corner attributes parallel to TV before any permutation; the
    # defaults make the interpolation exact for flat faces
    CVN = CUV = None
    if attr_blocks:
        CVN = _default_cvn(TV)
        CUV = _default_cuv(TV.shape[0])
        for a_start, a_count, a_vn, a_uv in attr_blocks:
            if a_vn is not None:
                CVN[a_start:a_start + a_count] = a_vn
            if a_uv is not None:
                CUV[a_start:a_start + a_count] = a_uv
    TNM = None
    if nm_blocks:
        TNM = np.full((TV.shape[0],), -1, I32)
        for a_start, a_count, a_ref in nm_blocks:
            TNM[a_start:a_start + a_count] = a_ref

    out = dict(props=props, clusters=None, n_virtual=len(props))
    if groups:
        # instanced scenes always take the clustered sweep (the flat one
        # has no per-row transform)
        lay = _layout_instanced(TV, CVN, CUV, TNM, groups)
        if lay["perm0"] is not None:
            out["props"] = [props[i] for i in lay["perm0"]]
        TV, CVN, CUV, TNM = lay["TV"], lay["CVN"], lay["CUV"], lay["TNM"]
        out["clusters"] = lay
        out["n_virtual"] = lay["n_virtual"]
    elif len(props) >= TRI_CLUSTER_THRESHOLD:
        from ..native import build_bvh
        perm = build_bvh(TV)["order"]
        TV = TV[perm]
        out["props"] = [props[i] for i in perm]
        if CVN is not None:
            CVN, CUV = CVN[perm], CUV[perm]
        if TNM is not None:
            TNM = TNM[perm]
        starts, lo, hi = _cluster_runs(TV, TRI_CLUSTER_SIZE)
        lo, hi = _inflate(lo, hi)
        out["clusters"] = dict(cl_lo=lo, cl_hi=hi, cl_start=_i(starts),
                               cl_virt=_i(starts))
    TTAN = TSGN = None
    if TNM is not None:
        TTAN, TSGN = _uv_tangents(TV, CUV)
    out.update(TV=TV, CVN=CVN, CUV=CUV, TTAN=TTAN, TSGN=TSGN, TNM=TNM)
    return out


def _uv_tangents(TV, CUV):
    """Per face, the unit tangent T = dP/du of its corner uvs (float64)
    and the sign of the uv determinant (compile.py:1376-1394); a face
    with a degenerate uv layout takes its first edge."""
    P1, P2, P3 = TV[:, 0], TV[:, 1], TV[:, 2]
    e1 = (P2 - P1).astype(np.float64)
    e2 = (P3 - P1).astype(np.float64)
    duv1 = CUV[:, 1] - CUV[:, 0]
    duv2 = CUV[:, 2] - CUV[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    inv = 1.0 / np.where(np.abs(det) < 1e-12,
                         np.where(det < 0, -1e-12, 1e-12), det)
    tan = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    nrm = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = np.where(nrm > 1e-12, tan / np.maximum(nrm, 1e-12),
                   (P2 - P1) / np.maximum(
                       np.linalg.norm(P2 - P1, axis=1, keepdims=True), 1e-12))
    return tan, np.where(det < 0, -1.0, 1.0)


def _cluster_fields(cl, CVN, CUV, TTAN=None, TSGN=None, TNM=None):
    """The GeometryTables fields of the clusters, instances and corner
    attributes (compile.py:1476-1494); empty tables where a scene has
    none."""
    z = lambda *shape: _t(np.zeros(shape, F32))
    zi = lambda: _t(np.zeros((0,), I32), I32)
    lay = cl if cl is not None and "inst_rot" in cl else None
    out = dict(
        tri_cl_lo=_t(cl["cl_lo"]) if cl else z(0, 3),
        tri_cl_hi=_t(cl["cl_hi"]) if cl else z(0, 3),
        tri_cl_start=_t(cl["cl_start"], I32) if cl else zi(),
        tri_cl_inst=_t(lay["cl_inst"], I32) if lay else zi(),
        tri_cl_virt=_t(cl["cl_virt"], I32) if cl else zi(),
        tri_virt_row=_t(lay["virt_row"], I32) if lay else zi(),
        tri_virt_inst=_t(lay["virt_inst"], I32) if lay else zi(),
        inst_rot=_t(lay["inst_rot"]) if lay else z(0, 3, 3),
        inst_trans=_t(lay["inst_trans"]) if lay else z(0, 3),
        inst_inv_scale=_t(lay["inst_inv_scale"]) if lay else z(0))
    for j in range(3):
        out[f"tri_vn{j + 1}"] = _t(CVN[:, j]) if CVN is not None else z(0, 3)
        out[f"tri_uv{j + 1}"] = _t(CUV[:, j]) if CUV is not None else z(0, 2)
    out.update(tri_tan=_t(TTAN) if TTAN is not None else z(0, 3),
               tri_tan_sign=_t(TSGN) if TSGN is not None else z(0),
               tri_nm_slot=_t(TNM, I32) if TNM is not None else zi())
    return out


def _mesh_group(reg, prim):
    """(mesh, [instance dicts], normal-map ref number or None) of a
    MeshInstances, its materials registered in instance order, then its
    normal map, which every instance must share (compile.py:990)."""
    if not prim.instances:
        raise ValueError("MeshInstances has no instances; call .add()")
    insts, eff = [], []
    for (R, tr, s, mat) in prim.instances:
        m = mat if mat is not None else prim.material
        eff.append(m)
        slot = reg.material_slot(m)
        insts.append(dict(
            R=np.asarray(R, np.float64), t=np.asarray(tr, np.float64),
            s=float(s),
            rec=ObjRecord("tri", m.mat_type, slot,
                          min(prim.max_ray_depth, 10 ** 6, 1023), prim.mc,
                          prim.shadow)))
    nm = None
    maps = {id(m.normalmap) for m in eff if m.normalmap is not None}
    if maps:
        if len(maps) > 1 or any(m.normalmap is None for m in eff):
            raise ValueError(
                "all instances of a MeshInstances group must share one "
                "normal map (the tangent/slot tables are per mesh face)")
        if prim.mesh.corner_uvs is None:
            raise ValueError(
                "a normal-mapped MeshInstances mesh needs vt texture "
                "coordinates in the OBJ (the tangent basis comes from "
                "the uv layout)")
        nm = reg.n_tri_maps()
        reg.normal_map(eff[0], "tri", nm)
    return prim.mesh, insts, nm


def _register_normal_map(reg, prim, kind, local):
    """Register a primitive's normal map (compile.py:1011-1069); returns
    a mesh's 'tri' ref number (None for other kinds).  A sphere's, plane's
    or box's object id is set once the kinds are counted; discs,
    cylinders and plain triangles raise, as in the JAX package."""
    mat = prim.material
    if kind in ("sphere", "plane", "box"):
        reg.normal_map(mat, kind, local)
        return None
    if kind == "disc":
        raise ValueError("normal maps are not supported on Disc")
    if kind == "cyl":
        raise ValueError("normal maps are not supported on Cylinder")
    if not isinstance(prim, TriangleMesh):
        raise ValueError("normal maps require a (u,v,n) basis; supported on "
                         "Plane, Cuboid and TriangleMesh (with vt) only")
    if prim.corner_uvs is None:
        raise ValueError(
            "a normal-mapped TriangleMesh needs vt texture coordinates in "
            "the OBJ (the tangent basis comes from the uv layout)")
    ref = reg.n_tri_maps()
    reg.normal_map(mat, "tri", ref)
    return ref


def compile_scene(scene) -> Tuple[SceneStatic, SolidTables]:
    """Lower a Scene to (SceneStatic, SolidTables) on the CPU: the
    kernels' tables."""
    static, tables, _ = compile_all(scene)
    return static, tables


def compile_wavefront(scene) -> Tuple[SceneStatic, SceneData]:
    """Lower a Scene to (SceneStatic, SceneData) on the CPU: the
    wavefront's tables, as the JAX `compile_scene` returns them."""
    static, _, data = compile_all(scene)
    return static, data


def compile_all(scene) -> Tuple[SceneStatic, SolidTables, SceneData]:
    """Lower a Scene to the static part and both routes' tables, for a
    caller that picks its route after the static part."""
    reg = _Textures()
    by_kind = {k: [] for k in KINDS}   # (primitive, props) per kind
    groups = []                        # MeshInstances: (mesh, instances)

    for prim in scene.scene_primitives:
        if isinstance(prim, MeshInstances):
            groups.append(_mesh_group(reg, prim))
            continue
        kind = next((k for cls, k in _PRIM_KIND if isinstance(prim, cls)), None)
        if kind is None:
            raise TypeError(f"unsupported primitive {type(prim).__name__}")
        mat = prim.material
        slot = reg.material_slot(mat)
        props = dict(mat_type=mat.mat_type, mat_slot=slot,
                     max_depth=min(prim.max_ray_depth, 10 ** 6),
                     mc=prim.mc, shadow=prim.shadow)
        local = len(by_kind[kind])
        if isinstance(prim, Panorama):
            reg.patch_env_kind(slot, "sphere")
        elif isinstance(prim, SkyBox):
            reg.patch_env_kind(slot, "box")
        elif mat.normalmap is not None:
            props["nm"] = _register_normal_map(reg, prim, kind, local)
        by_kind[kind].append((prim, props))

    # normal maps' object ids (compile.py:1581-1588)
    offsets = {"sphere": 0, "plane": len(by_kind["sphere"]),
               "box": len(by_kind["sphere"]) + len(by_kind["plane"])}
    nmaps = tuple(r if r.basis_kind == "tri" else dataclasses.replace(
        r, obj=offsets[r.basis_kind] + r.local_id) for r in reg.normal_maps)

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
    for prim, p in by_kind["disc"]:
        _rec("disc", p)
        _row(list(np.asarray(prim.center)) + list(np.asarray(prim.normal))
             + list(np.asarray(prim.u_axis)) + list(np.asarray(prim.v_axis))
             + [prim.radius, prim.inner_radius])
    for prim, p in by_kind["cyl"]:
        _rec("cyl", p)
        _row(list(np.asarray(prim.center)) + list(np.asarray(prim.axis))
             + list(np.asarray(prim.u_axis)) + list(np.asarray(prim.v_axis))
             + [prim.radius, prim.height / 2, 1.0 if prim.capped else 0.0])
    # triangles: p1, p2, p3, the unit normal and the edge normals n31, n12,
    # n23, vectorised over the float32 vertices (compile.py:1341, 1426-1431),
    # one record a region-0 row and one an instance (compile.py:1646-1656)
    tt = _triangle_tables(by_kind["tri"], groups)
    for p in tt["props"]:
        _rec("tri", p)
    repeats = [1] * len(records)
    for mesh, insts, _ in groups:
        records.extend(i["rec"] for i in insts)
        repeats.extend([len(mesh.faces)] * len(insts))
    n_obj_total = sum(repeats)
    TV, CVN, CUV = tt["TV"], tt["CVN"], tt["CUV"]
    P1, P2, P3 = TV[:, 0], TV[:, 1], TV[:, 2]
    nr = np.cross(P2 - P1, P3 - P1)
    nr_u = nr / np.maximum(np.linalg.norm(nr, axis=-1, keepdims=True), 1e-20)
    tri_n = (np.cross(P3 - P1, nr_u), np.cross(P1 - P2, nr_u),
             np.cross(P2 - P3, nr_u))
    tri_rows = np.zeros((TV.shape[0], 24), F32)
    for j, part in enumerate((P1, P2, P3, nr_u) + tri_n):
        tri_rows[:, 3 * j:3 * j + 3] = part
    geom = np.concatenate([np.stack(rows) if rows else np.zeros((0, 24), F32),
                           tri_rows]).astype(F32)

    # ---- the wavefront's per-kind geometry (compile.py:1434-1479) ---------
    g = {k: [q for q, _ in by_kind[k]] for k in KINDS}
    s3 = lambda k, f: _stack3([np.asarray(f(q)) for q in g[k]])
    a1 = lambda k, f: _arr1([f(q) for q in g[k]])
    wgeom = GeometryTables(
        sphere_center=_t(s3("sphere", lambda q: q.center)),
        sphere_radius=_t(a1("sphere", lambda q: q.radius)),
        plane_center=_t(s3("plane", lambda q: q.center)),
        plane_normal=_t(s3("plane", lambda q: (lambda n: n / np.linalg.norm(n))(
            np.cross(q.u_axis, q.v_axis)))),
        plane_u_axis=_t(s3("plane", lambda q: q.u_axis)),
        plane_v_axis=_t(s3("plane", lambda q: q.v_axis)),
        plane_half_w=_t(a1("plane", lambda q: q.width / 2)),
        plane_half_h=_t(a1("plane", lambda q: q.height / 2)),
        plane_uv_shift=_t(np.stack([q.uv_shift for q in g["plane"]])
                          if g["plane"] else np.zeros((0, 2), F32)),
        box_basis=_t(np.stack([q.basis for q in g["box"]])
                     if g["box"] else np.zeros((0, 3, 3), F32)),
        box_center=_t(s3("box", lambda q: q.center)),
        box_whl=_t(s3("box", lambda q: (q.width, q.height, q.length))),
        box_lb_local=_t(s3("box", lambda q: q.lb_local)),
        box_rt_local=_t(s3("box", lambda q: q.rt_local)),
        disc_center=_t(s3("disc", lambda q: q.center)),
        disc_normal=_t(s3("disc", lambda q: q.normal)),
        disc_u_axis=_t(s3("disc", lambda q: q.u_axis)),
        disc_v_axis=_t(s3("disc", lambda q: q.v_axis)),
        disc_r_out=_t(a1("disc", lambda q: q.radius)),
        disc_r_in=_t(a1("disc", lambda q: q.inner_radius)),
        cyl_center=_t(s3("cyl", lambda q: q.center)),
        cyl_axis=_t(s3("cyl", lambda q: q.axis)),
        cyl_u_axis=_t(s3("cyl", lambda q: q.u_axis)),
        cyl_v_axis=_t(s3("cyl", lambda q: q.v_axis)),
        cyl_radius=_t(a1("cyl", lambda q: q.radius)),
        cyl_half_h=_t(a1("cyl", lambda q: q.height / 2)),
        cyl_capped=_t(a1("cyl", lambda q: 1.0 if q.capped else 0.0)),
        tri_p1=_t(P1), tri_p2=_t(P2), tri_p3=_t(P3), tri_normal=_t(nr_u),
        tri_centroid=_t((P1 + P2 + P3) / 3.0), tri_n31=_t(tri_n[0]),
        tri_n12=_t(tri_n[1]), tri_n23=_t(tri_n[2]),
        **_cluster_fields(tt["clusters"], CVN, CUV, tt["TTAN"], tt["TSGN"],
                          tt["TNM"]))

    # ---- material tables (compile.py:1529-1556) ---------------------------
    def solid_of(m, attr):
        t = getattr(m, attr)
        return t.color if isinstance(t, solid_color) else np.zeros(3)

    dif = reg.mat_rows.get(MAT_DIFFUSE, [])
    glo = reg.mat_rows.get(MAT_GLOSSY, [])
    ref = reg.mat_rows.get(MAT_REFRACTIVE, [])
    tfi = reg.mat_rows.get(MAT_THINFILM, [])
    emi = reg.mat_rows.get(MAT_EMISSIVE, [])
    mats = dict(
        diffuse_color=_stack3([solid_of(m, "diff_texture") for m in dif]),
        diffuse_ambient_weight=_arr1([m.ambient_weight for m in dif]),
        glossy_color=_stack3([solid_of(m, "diff_texture") for m in glo]),
        glossy_n_re=_stack3([np.real(m.n) for m in glo]),
        glossy_n_im=_stack3([np.imag(m.n) for m in glo]),
        glossy_roughness=_arr1([m.roughness for m in glo]),
        glossy_spec=_arr1([m.spec_coeff for m in glo]),
        glossy_diff=_arr1([m.diff_coeff for m in glo]),
        refr_n_re=_stack3([np.real(m.n) for m in ref]),
        refr_n_im=_stack3([np.imag(m.n) for m in ref]),
        refr_dispersive=_arr1([float(m.dispersion) for m in ref]),
        tf_thickness=_arr1([m.thickness for m in tfi]),
        tf_noise=_arr1([m.noise_factor for m in tfi]),
        emissive_color=_stack3([solid_of(m, "texture_color") for m in emi]),
        env_light_intensity=_arr1([m.light_intensity for m in
                                   reg.mat_rows.get(MAT_ENV, [])]),
    )
    tf_selp = tuple(_tf_sel_poly(m) for m in tfi)
    tf_rows = [sel + (m.thickness, m.noise_factor)
               for sel, m in zip(tf_selp, tfi)]

    # ---- lights (compile.py:1558-1574) ------------------------------------
    slts = [l for l in scene.Light_list if isinstance(l, SpotLight)]
    dlts = [l for l in scene.Light_list if hasattr(l, "Ldir")]
    plts = [l for l in scene.Light_list
            if hasattr(l, "pos") and not isinstance(l, SpotLight)]
    lt = dict(
        dir_l=_stack3([l.Ldir for l in dlts]),
        dir_color=_stack3([l.color for l in dlts]),
        point_pos=_stack3([l.pos for l in plts]),
        point_color=_stack3([l.color for l in plts]),
        spot_pos=_stack3([l.pos for l in slts]),
        spot_dir=_stack3([l.direction for l in slts]),
        spot_color=_stack3([l.color for l in slts]),
        spot_cos_in=_arr1([l.cos_inner for l in slts]),
        spot_cos_out=_arr1([l.cos_outer for l in slts]))
    lights = light_table(**lt)

    is_center = _stack3([p.center for p in scene.importance_sampled_list])
    is_radius = _arr1([p.bounded_sphere_radius
                       for p in scene.importance_sampled_list])

    # ---- the gates (compile.py:1690-1731) ----------------------------------
    refr_disp = tuple(bool(m.dispersion) for m in ref)
    present = tuple(sorted({r.mat_type for r in records}))
    refs = reg.refs
    customs = tuple(reg.mat_rows.get(MAT_CUSTOM, []))
    # custom shaders may read uv
    needs_uv = bool(refs["diffuse"] or refs["glossy"] or refs["emissive"]
                    or reg.env_slots or refs["tf_lut"] or nmaps or customs)
    env_rows = reg.mat_rows.get(MAT_ENV, [])
    is_envs, env_is = _env_importance(reg.env_slots, env_rows)
    n_groups_merged = len(
        {(r.mat_type, r.max_depth, r.mc,
          refr_disp[r.mat_slot] if r.mat_type == MAT_REFRACTIVE else None)
         for r in records})
    n_groups_slot = len(shading_groups(records)[1])
    # instanced scenes and corner attributes shade on the wavefront
    common_ok = (0 < n_obj_total <= PALLAS_MAX_OBJECTS
                 and len(scene.importance_sampled_list) <= 8
                 and not groups and CVN is None)
    pallas_ok = (common_ok and n_groups_merged <= PALLAS_MAX_GROUPS
                 and not needs_uv
                 and set(present) <= {MAT_EMISSIVE, MAT_GLOSSY, MAT_DIFFUSE,
                                      MAT_REFRACTIVE})
    # env importance sampling is the wavefront's (its diffuse mixture
    # gains an env component)
    # normal maps perturb the sampled directions, which a record cannot
    # defer
    pallas_tex_ok = (common_ok and n_groups_slot <= PALLAS_MAX_GROUPS
                     and not pallas_ok and not nmaps and not is_envs
                     and set(present) <= {MAT_EMISSIVE, MAT_GLOSSY,
                                          MAT_DIFFUSE, MAT_REFRACTIVE,
                                          MAT_THINFILM, MAT_ENV})

    atlas, tex_scale, tex_shapes, tex_offsets, tex_enc = texture_atlas(
        tuple(reg.arrays))
    static = SceneStatic(
        n_objects=n_obj_total, n_is_targets=int(is_center.shape[0]),
        mat_types_present=present, obj_records=tuple(records),
        refr_disp=refr_disp, pallas_ok=pallas_ok, pallas_tex_ok=pallas_tex_ok,
        n_dir_lights=len(dlts), n_point_lights=len(plts),
        n_spot_lights=len(slts),
        diffuse_tex=tuple(refs["diffuse"]), glossy_tex=tuple(refs["glossy"]),
        emissive_tex=tuple(refs["emissive"]),
        thinfilm_lut=tuple(refs["tf_lut"]),
        thinfilm_noise=tuple(refs["tf_noise"]),
        thinfilm_comp=tuple(refs["tf_comp"]), env_slots=tuple(reg.env_slots),
        tex_shapes=tex_shapes, tex_offsets=tex_offsets, tex_enc=tex_enc,
        tf_selp=tf_selp, needs_uv=needs_uv, n_tris=tt["n_virtual"],
        tri_interp=CVN is not None, normal_maps=nmaps,
        env_is_shape=env_is[3] if env_is else (0, 0), custom_mats=customs,
        custom_fp=tuple(_custom_param_fp(m) for m in customs))
    tables = build_solid_tables(
        records, refr_disp, geom, mats, lights, is_center, is_radius,
        _f(scene.ambient_color), _f(np.real(scene.n)), _f(np.imag(scene.n)),
        tf_rows, atlas, tex_scale, static.image_slots(),
        (len(dlts), len(plts), len(slts)), static=static)
    static = dataclasses.replace(static,
                                 kernel_smem=kernel_smem_bytes(static, tables))
    data = SceneData(
        geom=wgeom, obj=pack_objects(records, repeats),
        mats=MaterialTables(**{k: _t(v) for k, v in mats.items()}),
        lights=LightTables(**{k: _t(v) for k, v in lt.items()}),
        is_center=_t(is_center), is_radius=_t(is_radius),
        textures=tuple(texture_f32(a) for a in reg.arrays),
        ambient_color=_t(scene.ambient_color), scene_n_re=_t(np.real(scene.n)),
        scene_n_im=_t(np.imag(scene.n)),
        env_is_prob=_t(env_is[0] if env_is else np.zeros((0,), F32)),
        env_is_alias=_t(env_is[1] if env_is else np.zeros((0,), I32), I32),
        env_is_pdf=_t(env_is[2] if env_is else np.zeros((0,), F32)))
    return static, tables, data


def kernel_smem_bytes(static, tables):
    """Bytes of shared memory a block of the kernel that renders the scene
    takes for `tables` (ops/solid_trace.py and ops/record_trace.py
    `_smem_bytes`); 0 for a scene inside neither kernel's gate."""
    if static.pallas_ok:
        from ..ops.solid_trace import _smem_bytes
        return _smem_bytes(tables)
    if static.pallas_tex_ok:
        from ..ops.record_trace import _smem_bytes
        return _smem_bytes(static, tables)
    return 0


def _env_importance(env_slots, env_rows):
    """(the importance-sampled environment materials, their alias tables
    or None) (compile.py:1680-1706).  At most one environment, and an
    equirect one; a black map has no distribution to sample and keeps
    the cosine / caps mixture."""
    is_envs = [(e, env_rows[e.slot]) for e in env_slots
               if env_rows[e.slot].importance_sampled]
    if not is_envs:
        return [], None
    if len(is_envs) > 1:
        raise ValueError("only one environment may be importance_sampled")
    e, m = is_envs[0]
    if e.kind != "sphere":
        raise ValueError(
            "environment importance sampling needs an equirect map — use "
            "Panorama / add_Background(spherical=True)")
    # sample the array the slot displays (its blurred variant, if any)
    src = m.blur_texture if m.blur_texture is not None else m.texture
    if float(np.asarray(src, np.float64)[..., :3].sum()) <= 0.0:
        return is_envs, None
    return is_envs, _env_is_tables(src)
