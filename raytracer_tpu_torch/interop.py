"""Carry the JAX package's compiled scene state over to the port.

`tables_from_jax(static, data)` takes a `SceneStatic` and `SceneData` from
`raytracer_tpu.core.compile.compile_scene`, reads every array through
`np.asarray`, and returns the port's (SceneStatic, SolidTables).  It never
imports jax: whatever the arrays are, numpy reads them.  The tests feed the
reference's own tables to the port through it.
"""

from __future__ import annotations

import numpy as np

from .core.compile import (ObjRecord, SceneStatic, build_solid_tables,
                           light_table)

_MAT_FIELDS = ("diffuse_color", "diffuse_ambient_weight", "refr_n_re",
               "refr_n_im", "emissive_color")


def static_from_jax(static) -> SceneStatic:
    """The port's SceneStatic from the JAX package's."""
    records = tuple(ObjRecord(r.kind, int(r.mat_type), int(r.mat_slot),
                              int(r.max_depth), bool(r.mc), bool(r.shadow),
                              aa=getattr(r, "aa", None))
                    for r in static.obj_records)
    return SceneStatic(
        n_objects=static.n_objects, n_is_targets=static.n_is_targets,
        mat_types_present=tuple(static.mat_types_present),
        obj_records=records, refr_disp=tuple(static.refr_disp),
        pallas_ok=bool(static.pallas_ok))


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
    tables = build_solid_tables(
        port_static.obj_records, port_static.refr_disp, a(data.pallas_geom),
        {k: a(getattr(data.mats, k)) for k in _MAT_FIELDS}, lights,
        a(data.is_center), a(data.is_radius), a(data.ambient_color),
        a(data.scene_n_re), a(data.scene_n_im))
    return port_static, tables
