"""Carry the JAX package's compiled scene state over to the port.

`tables_from_jax(static, data)` takes a `SceneStatic` and `SceneData` from
`raytracer_tpu.core.compile.compile_scene`, reads every array through
`np.asarray`, and returns the port's (SceneStatic, SolidTables): the
solid and record paths' tables, the thin-film rows and the texture atlas
(words, scales, shapes, offsets, encodings); `scene_data_from_jax(data)`
returns the wavefront's (`SceneData`), with the triangle clusters,
corner attributes, instances and normal-map tangents of mesh scenes and
the environment's alias tables.  It never imports jax:
whatever the arrays are, numpy reads them.  The tests feed the
reference's own tables to the port through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.compile import (EnvSlot, GeometryTables, LightTables,
                           MaterialTables, NormalMapRef, ObjectTables,
                           ObjRecord, SceneData, SceneStatic, TexRef,
                           build_solid_tables, kernel_smem_bytes,
                           light_table)

_MAT_FIELDS = ("diffuse_color", "diffuse_ambient_weight", "glossy_color",
               "glossy_n_re", "glossy_n_im", "glossy_roughness",
               "glossy_spec", "glossy_diff", "refr_n_re", "refr_n_im",
               "emissive_color")


def _refs(refs):
    return tuple(TexRef(int(r.slot), int(r.tex), float(r.repeat),
                        bool(r.bilinear)) for r in refs)


def static_from_jax(static) -> SceneStatic:
    """The port's SceneStatic from the JAX package's.  Custom materials
    carry over as the JAX instances (their shaders are jnp code, so only
    the structure is of use)."""
    records = tuple(ObjRecord(r.kind, int(r.mat_type), int(r.mat_slot),
                              int(r.max_depth), bool(r.mc), bool(r.shadow),
                              aa=getattr(r, "aa", None))
                    for r in static.obj_records)
    return SceneStatic(
        n_objects=static.n_objects, n_is_targets=static.n_is_targets,
        mat_types_present=tuple(static.mat_types_present),
        obj_records=records, refr_disp=tuple(static.refr_disp),
        pallas_ok=bool(static.pallas_ok),
        pallas_tex_ok=bool(static.pallas_tex_ok),
        n_dir_lights=int(static.n_dir_lights),
        n_point_lights=int(static.n_point_lights),
        n_spot_lights=int(static.n_spot_lights),
        diffuse_tex=_refs(static.diffuse_tex),
        glossy_tex=_refs(static.glossy_tex),
        emissive_tex=_refs(static.emissive_tex),
        thinfilm_lut=_refs(static.thinfilm_lut),
        thinfilm_noise=_refs(static.thinfilm_noise),
        thinfilm_comp=_refs(static.thinfilm_comp),
        env_slots=tuple(EnvSlot(int(e.slot), e.kind, int(e.tex), e.lightmap,
                                e.combined) for e in static.env_slots),
        tex_shapes=tuple(tuple(int(v) for v in s) for s in static.tex_shapes),
        tex_offsets=tuple(int(v) for v in static.tex_offsets),
        tex_enc=tuple(int(v) for v in static.tex_enc),
        tf_selp=tuple(tuple(float(c) for c in p) for p in static.tf_selp),
        needs_uv=bool(static.needs_uv),
        n_tris=int(static.n_tris), tri_interp=bool(static.tri_interp),
        normal_maps=tuple(NormalMapRef(int(r.obj), int(r.tex),
                                       float(r.repeat), r.basis_kind,
                                       int(r.local_id), bool(r.bilinear))
                          for r in static.normal_maps),
        env_is_shape=tuple(int(v) for v in static.env_is_shape),
        custom_mats=tuple(static.custom_mats),
        custom_fp=tuple(static.custom_fp))


def _tensors(cls, src):
    """An instance of the port's table class `cls` from the JAX dataclass
    `src`, field by field (bools stay bool, ints become int32)."""
    def conv(x):
        a = np.asarray(x)
        dt = (bool if a.dtype == np.bool_ else np.int32
              if np.issubdtype(a.dtype, np.integer) else np.float32)
        return torch.from_numpy(np.array(a, dtype=dt))
    return cls(**{f.name: conv(getattr(src, f.name))
                  for f in dataclasses.fields(cls)})


def scene_data_from_jax(data) -> SceneData:
    """The port's SceneData from the JAX package's: every geometry table
    (clusters, corner attributes, instances and normal-map tangents
    included) and the environment's alias tables."""
    f32 = lambda x: torch.from_numpy(np.array(np.asarray(x), np.float32))
    i32 = lambda x: torch.from_numpy(np.array(np.asarray(x), np.int32))
    return SceneData(
        geom=_tensors(GeometryTables, data.geom),
        obj=_tensors(ObjectTables, data.obj),
        mats=_tensors(MaterialTables, data.mats),
        lights=_tensors(LightTables, data.lights),
        is_center=f32(data.is_center), is_radius=f32(data.is_radius),
        textures=tuple(f32(t) for t in data.textures),
        ambient_color=f32(data.ambient_color),
        scene_n_re=f32(data.scene_n_re), scene_n_im=f32(data.scene_n_im),
        env_is_prob=f32(data.env_is_prob), env_is_alias=i32(data.env_is_alias),
        env_is_pdf=f32(data.env_is_pdf))


def tables_from_jax(static, data):
    """(SceneStatic, SolidTables) of the port from the JAX package's
    compiled (SceneStatic, SceneData)."""
    a = lambda x: np.asarray(x, np.float32)
    lt = data.lights
    lights = light_table(a(lt.dir_l), a(lt.dir_color), a(lt.point_pos),
                         a(lt.point_color), a(lt.spot_pos), a(lt.spot_dir),
                         a(lt.spot_color), a(lt.spot_cos_in),
                         a(lt.spot_cos_out))
    port_static = static_from_jax(static)
    mats = data.mats
    tf_rows = [tuple(sel) + (th, nf) for sel, th, nf in zip(
        port_static.tf_selp, a(mats.tf_thickness), a(mats.tf_noise))]
    tables = build_solid_tables(
        port_static.obj_records, port_static.refr_disp, a(data.pallas_geom),
        {k: a(getattr(mats, k)) for k in _MAT_FIELDS}, lights,
        a(data.is_center), a(data.is_radius), a(data.ambient_color),
        a(data.scene_n_re), a(data.scene_n_im), tf_rows,
        np.asarray(data.tex_atlas, np.int32), a(data.tex_scale),
        port_static.image_slots(),
        (port_static.n_dir_lights, port_static.n_point_lights,
         port_static.n_spot_lights), static=port_static)
    port_static = dataclasses.replace(
        port_static, kernel_smem=kernel_smem_bytes(port_static, tables))
    return port_static, tables
