"""Declarative JSON scene format.

Counterpart of raytracer_tpu/scene_io.py, with the same schema and the
same located error messages.  sightpy describes scenes only as Python
code (example1.py etc.); here a render can also be described as data, a
JSON document that :func:`load_scene_file` / :func:`scene_from_dict`
build through the port's scene API and :func:`scene_to_dict` /
:func:`save_scene_file` write back.  ``{"type": "mesh"}`` objects load
an OBJ file as a TriangleMesh; a MeshInstances group cannot be exported
and raises a located ValueError, as in the JAX package.

Schema (all vectors are 3-lists; complex numbers are ``[re, im]`` pairs,
and a per-channel complex triple is a 3-list of numbers or pairs)::

    {
      "camera":  {"look_from": [0,0,1], "look_at": [0,0,-1],
                  "width": 400, "height": 300, "field_of_view": 90,
                  "aperture": 0, "focal_distance": 1,
                  "projection": "pinhole"},
      "ambient_color": [0.05, 0.05, 0.05],
      "n": 1.0,                                  # scene medium IoR
      "lights": [
        {"type": "directional", "Ldir": [0.5,0.5,-0.5], "color": [0.2,0.2,0.2]},
        {"type": "point", "pos": [0,2,-1], "color": [1,1,1]},
        {"type": "spot",  "pos": [0,2,-1], "direction": [0,-1,0],
         "color": [1,1,1], "angle": 30, "inner_angle": 20}
      ],
      "background": {"image": "stormydays.png", "spherical": false,
                     "light_intensity": 0.0, "blur": 0.0},
      "objects": [
        {"type": "sphere", "center": [-0.75,0.1,-3], "radius": 0.6,
         "max_ray_depth": 3, "importance_sampled": false,
         "material": {"type": "glossy", "diff_color": [1,0.57,0.18],
                      "n": [[0.15,3.58],[0.4,2.37],[1.54,1.91]],
                      "roughness": 0, "spec_coeff": 0.2, "diff_coeff": 0.8}},
        {"type": "plane", "center": [0,-0.5,-3], "width": 12, "height": 12,
         "u_axis": [1,0,0], "v_axis": [0,0,-1],
         "material": {"type": "diffuse",
                      "diff_color": {"image": "checker.png", "repeat": 2}}},
        {"type": "cuboid", "center": [1,0,-3], "width": 1, "height": 1,
         "length": 1, "rotate": {"theta": 30, "axis": [0,1,0]},  # degrees
         "material": {"type": "refractive", "n": [1.5, 0]}},
        {"type": "disc", "center": [0,1,-2], "radius": 0.8,
         "inner_radius": 0.3, "normal": [0,0,1], "material": ...},
        {"type": "cylinder", "center": [0,0,-2], "radius": 0.3,
         "height": 1.0, "axis": [0,1,0], "capped": true, "material": ...},
        {"type": "triangle", "center": [0,0,0], "p1": [...], "p2": [...],
         "p3": [...], "material": ...},
        {"type": "mesh", "filename": "bunny.obj", "center": [0,0,-3],
         "scale": 2.0, "material": ...}
      ]
    }

Material ``type``: ``emissive`` (color), ``diffuse`` (diff_color,
diffuse_rays, ambient_weight), ``glossy`` (diff_color, roughness,
spec_coeff, diff_coeff, n), ``refractive`` (n, dispersion), ``thinfilm``
(thickness, noise, film_n).  Color-valued fields accept a 3-list (solid
color) or ``{"image": "file.png", "repeat": 1.0, "filter": "nearest"}``.
Every other key maps 1:1 onto the Python constructor kwarg of the same
name.
"""

from __future__ import annotations

import json
from pathlib import Path

from .core.scene import Scene
from .geometry.primitive import (Cuboid, Cylinder, Disc, Plane, Sphere,
                                 Triangle, TriangleMesh)
from .materials.base import (Diffuse, Emissive, Glossy, Refractive,
                             ThinFilmInterference)
from .textures.texture import image as image_texture

_MATERIALS = {
    "emissive": Emissive,
    "diffuse": Diffuse,
    "glossy": Glossy,
    "refractive": Refractive,
    "thinfilm": ThinFilmInterference,
}

# material keys that take a color OR a texture spec
_COLOR_KEYS = ("color", "diff_color")


def _c1(v, where):
    """A JSON complex scalar: number or [re, im]."""
    if isinstance(v, (int, float)):
        return complex(float(v), 0.0)
    if isinstance(v, (list, tuple)) and len(v) == 2 \
            and all(isinstance(x, (int, float)) for x in v):
        return complex(float(v[0]), float(v[1]))
    raise ValueError(f"{where}: expected a number or [re, im], got {v!r}")


def _c3(v, where):
    """A per-channel complex triple: scalar, [re, im], or 3-list of those."""
    if isinstance(v, (int, float)):
        return _c1(v, where)
    if isinstance(v, (list, tuple)):
        if len(v) == 2 and all(isinstance(x, (int, float)) for x in v):
            return _c1(v, where)
        if len(v) == 3:
            return tuple(_c1(x, where) for x in v)
    raise ValueError(
        f"{where}: expected a number, [re, im], or 3 of those, got {v!r}")


def _color_or_texture(v, where):
    if isinstance(v, dict):
        d = dict(v)
        try:
            img = d.pop("image")
        except KeyError:
            raise ValueError(f"{where}: a texture spec needs an 'image' key")
        return image_texture(img, **d)
    return v        # 3-list solid color; validated by as_texture downstream


def _material(spec, where):
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(f"{where}: material must be an object with a 'type'")
    d = dict(spec)
    t = d.pop("type")
    cls = _MATERIALS.get(t)
    if cls is None:
        raise ValueError(f"{where}: unknown material type {t!r} "
                         f"(valid: {sorted(_MATERIALS)})")
    for k in _COLOR_KEYS:
        if k in d:
            d[k] = _color_or_texture(d[k], f"{where}.{k}")
    if "n" in d:
        d["n"] = _c3(d["n"], f"{where}.n")
    return cls(**d)


def _build_object(spec, index):
    where = f"objects[{index}]"
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(f"{where}: must be an object with a 'type'")
    d = dict(spec)
    t = d.pop("type")
    importance = bool(d.pop("importance_sampled", False))
    rotate = d.pop("rotate", None)
    d["material"] = _material(d.pop("material", None), f"{where}.material")
    try:
        if t == "sphere":
            prim = Sphere(**d)
        elif t == "plane":
            prim = Plane(**d)
        elif t == "cuboid":
            prim = Cuboid(**d)
        elif t == "disc":
            prim = Disc(**d)
        elif t == "cylinder":
            prim = Cylinder(**d)
        elif t == "triangle":
            prim = Triangle(**d)
        elif t == "mesh":
            prim = TriangleMesh(**d)
        else:
            raise ValueError(
                f"{where}: unknown object type {t!r} (valid: sphere, plane, "
                "cuboid, disc, cylinder, triangle, mesh)")
    except TypeError as e:
        raise ValueError(f"{where}: {e}") from None
    if rotate is not None:
        steps = rotate if isinstance(rotate, list) else [rotate]
        for r in steps:
            if not isinstance(r, dict) or "theta" not in r or "axis" not in r:
                raise ValueError(
                    f"{where}.rotate: expected {{'theta': degrees, "
                    f"'axis': [x,y,z]}}, got {r!r}")
            prim.rotate(float(r["theta"]), r["axis"])
    return prim, importance


def _build_light(scene, spec, index):
    where = f"lights[{index}]"
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(f"{where}: must be an object with a 'type'")
    d = dict(spec)
    t = d.pop("type")
    try:
        if t == "point":
            scene.add_PointLight(**d)
        elif t == "directional":
            scene.add_DirectionalLight(**d)
        elif t == "spot":
            scene.add_SpotLight(**d)
        else:
            raise ValueError(f"{where}: unknown light type {t!r} "
                             "(valid: point, directional, spot)")
    except TypeError as e:
        raise ValueError(f"{where}: {e}") from None


def scene_from_dict(cfg, width=None, height=None):
    """Build a :class:`Scene` from a schema dict (see module docstring).

    `width`/`height` override the camera resolution.
    """
    if not isinstance(cfg, dict) or "camera" not in cfg:
        raise ValueError("scene document must be an object with a 'camera'")
    kwargs = {}
    if "ambient_color" in cfg:
        kwargs["ambient_color"] = cfg["ambient_color"]
    if "n" in cfg:
        kwargs["n"] = _c3(cfg["n"], "n")
    sc = Scene(**kwargs)

    cam = dict(cfg["camera"])
    for src, dst in (("width", "screen_width"), ("height", "screen_height")):
        if src in cam:
            cam[dst] = cam.pop(src)
    if width is not None:
        cam["screen_width"] = width
    if height is not None:
        cam["screen_height"] = height
    try:
        sc.add_Camera(**cam)
    except TypeError as e:
        raise ValueError(f"camera: {e}") from None

    for i, l in enumerate(cfg.get("lights", [])):
        _build_light(sc, l, i)

    bg = cfg.get("background")
    if bg is not None:
        d = dict(bg) if isinstance(bg, dict) else {"image": bg}
        try:
            img = d.pop("image")
        except KeyError:
            raise ValueError("background: needs an 'image' key")
        sc.add_Background(img, **d)

    for i, o in enumerate(cfg.get("objects", [])):
        prim, importance = _build_object(o, i)
        sc.add(prim, importance_sampled=importance)
    return sc


def load_scene_file(path, width=None, height=None):
    """Load a ``.json`` scene document into a :class:`Scene`."""
    text = Path(path).read_text()
    try:
        cfg = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: invalid JSON — {e}") from None
    return scene_from_dict(cfg, width=width, height=height)


# ---------------------------------------------------------------------------
# export: Scene -> schema dict (the inverse of scene_from_dict)
# ---------------------------------------------------------------------------

def _v(x):
    return [float(c) for c in x]


def _c_out(n):
    """Complex scalar/triple -> schema spelling ([re, im] pairs)."""
    import numpy as np

    a = np.atleast_1d(np.asarray(n, np.complex128))
    pairs = [[float(c.real), float(c.imag)] for c in a]
    return pairs[0] if len(pairs) == 1 else pairs


def _texture_out(tex, where):
    from .textures.texture import image as image_texture, solid_color

    if isinstance(tex, solid_color):
        return _v(tex.color)
    if isinstance(tex, image_texture):
        if tex.source is None:
            raise ValueError(
                f"{where}: an ndarray-backed image texture has no filename "
                "to export — construct it from a file path")
        d = {"image": tex.source}
        if tex.repeat != 1.0:
            d["repeat"] = tex.repeat
        if tex.bilinear:
            d["filter"] = "bilinear"
        return d
    raise ValueError(f"{where}: cannot export texture {type(tex).__name__}")


def _material_out(m, where):
    from .materials.base import (Diffuse, Emissive, Glossy, Refractive,
                                 ThinFilmInterference)

    if getattr(m, "normalmap", None) is not None:
        raise ValueError(f"{where}: normal-mapped materials cannot be "
                         "exported to JSON yet")
    if isinstance(m, Emissive):
        return {"type": "emissive",
                "color": _texture_out(m.texture_color, where)}
    if isinstance(m, Glossy):
        return {"type": "glossy",
                "diff_color": _texture_out(m.diff_texture, where),
                "roughness": m.roughness, "spec_coeff": m.spec_coeff,
                "diff_coeff": m.diff_coeff, "n": _c_out(m.n)}
    if isinstance(m, Diffuse):
        return {"type": "diffuse",
                "diff_color": _texture_out(m.diff_texture, where),
                "diffuse_rays": m.diffuse_rays,
                "ambient_weight": m.ambient_weight}
    if isinstance(m, Refractive):
        d = {"type": "refractive", "n": _c_out(m.n)}
        if m.dispersion:
            d["dispersion"] = True
        return d
    if isinstance(m, ThinFilmInterference):
        if m.custom_tables:
            raise ValueError(f"{where}: a ThinFilm with custom LUT/noise "
                             "arrays cannot be exported to JSON")
        return {"type": "thinfilm", "thickness": m.thickness,
                "noise": m.noise_factor, "film_n": m.film_n}
    raise ValueError(
        f"{where}: {type(m).__name__} cannot be exported to JSON "
        "(custom materials are Python code)")


def _common_out(p):
    d = {}
    if p.max_ray_depth != 5:
        d["max_ray_depth"] = p.max_ray_depth
    if not p.shadow:
        d["shadow"] = False
    if p.mc:
        d["mc"] = True
    return d


def _object_out(p, index, importance):
    import numpy as np

    from .geometry.primitive import _orthonormal_frame

    where = f"objects[{index}]"
    d = {"material": _material_out(p.material, f"{where}.material"),
         "center": _v(p.center)}
    d.update(_common_out(p))
    if importance:
        d["importance_sampled"] = True
    if isinstance(p, TriangleMesh):
        d.update(type="mesh", filename=p.filename, scale=p.scale)
        if p.smooth_arg is not None:
            d["smooth"] = p.smooth_arg
        rots = getattr(p, "_rotations", [])
        if rots:
            d["rotate"] = [{"theta": t, "axis": _v(a)} for t, a in rots]
        return d
    if isinstance(p, Sphere):
        d.update(type="sphere", radius=p.radius)
        return d
    if isinstance(p, Plane):
        d.update(type="plane", width=p.width, height=p.height,
                 u_axis=_v(p.u_axis), v_axis=_v(p.v_axis))
        if p.uv_shift != (0.0, 0.0):
            d["uv_shift"] = list(p.uv_shift)
        return d
    if isinstance(p, Cuboid):
        d.update(type="cuboid", width=p.width, height=p.height,
                 length=p.length)
        rots = getattr(p, "_rotations", [])
        if rots:
            # replaying the recorded rotations reconstructs the basis (and
            # the rotated corners) with the exact same float operations
            d["rotate"] = [{"theta": t, "axis": _v(a)} for t, a in rots]
        return d
    if isinstance(p, Disc):
        d.update(type="disc", radius=p.radius, normal=_v(p.normal))
        if p.inner_radius:
            d["inner_radius"] = p.inner_radius
        u_def, _ = _orthonormal_frame(p.normal)
        if not np.array_equal(np.asarray(p.u_axis), u_def):
            d["u_axis"] = _v(p.u_axis)
        return d
    if isinstance(p, Cylinder):
        d.update(type="cylinder", radius=p.radius, height=p.height,
                 axis=_v(p.axis))
        if not p.capped:
            d["capped"] = False
        u_def, _ = _orthonormal_frame(p.axis)
        if not np.array_equal(np.asarray(p.u_axis), u_def):
            d["u_axis"] = _v(p.u_axis)
        return d
    if isinstance(p, Triangle):
        d.update(type="triangle", p1=_v(p.p1), p2=_v(p.p2), p3=_v(p.p3))
        return d
    raise ValueError(
        f"{where}: {type(p).__name__} cannot be exported to JSON")


def scene_to_dict(scene):
    """Export a :class:`Scene` into the schema dict `scene_from_dict`
    consumes.  The inverse is exact for everything the schema can spell
    (a reloaded scene compiles to the identical content fingerprint);
    unexportable content (ndarray-backed textures or backgrounds,
    `MeshInstances`) raises a located ValueError instead of being dropped
    silently."""
    from .backgrounds.environment import Panorama, SkyBox
    from .lights import DirectionalLight, PointLight, SpotLight

    if scene.camera is None:
        raise ValueError("scene has no camera (call add_Camera first)")
    cam = scene.camera
    out = {
        "camera": {
            "look_from": _v(cam.look_from), "look_at": _v(cam.look_at),
            "width": cam.screen_width, "height": cam.screen_height,
            "field_of_view": cam.field_of_view,
        },
        "ambient_color": _v(scene.ambient_color),
        "n": _c_out(scene.n),
    }
    if cam.aperture:
        out["camera"]["aperture"] = cam.aperture
    if cam.focal_distance != 1.0:
        out["camera"]["focal_distance"] = cam.focal_distance
    if cam.projection != "pinhole":
        out["camera"]["projection"] = cam.projection

    lights = []
    for i, l in enumerate(scene.Light_list):
        if isinstance(l, SpotLight):
            lights.append({"type": "spot", "pos": _v(l.pos),
                           "direction": _v(l.direction),
                           "color": _v(l.color), "angle": l.angle,
                           "inner_angle": l.inner_angle})
        elif isinstance(l, DirectionalLight):
            lights.append({"type": "directional", "Ldir": _v(l.Ldir),
                           "color": _v(l.color)})
        elif isinstance(l, PointLight):
            lights.append({"type": "point", "pos": _v(l.pos),
                           "color": _v(l.color)})
        else:
            raise ValueError(
                f"lights[{i}]: {type(l).__name__} cannot be exported")
    if lights:
        out["lights"] = lights

    objects = []
    for i, p in enumerate(scene.scene_primitives):
        if isinstance(p, (SkyBox, Panorama)):
            if "background" in out:
                raise ValueError(
                    "scene has multiple backgrounds; the schema holds one")
            m = p.material
            if m.source is None:
                raise ValueError(
                    "an ndarray-backed background has no filename to export")
            bg = {"image": m.source}
            if m.light_intensity:
                bg["light_intensity"] = m.light_intensity
            if m.blur:
                bg["blur"] = m.blur
            if isinstance(p, Panorama):
                bg["spherical"] = True
            if m.importance_sampled:
                bg["importance_sampled"] = True
            if m.linear:
                bg["linear"] = True
            out["background"] = bg
            continue
        objects.append(_object_out(
            p, i, p in scene.importance_sampled_list))
    out["objects"] = objects
    return out


def save_scene_file(scene, path):
    """Write `scene` as a JSON scene document (see :func:`scene_to_dict`)."""
    Path(path).write_text(json.dumps(scene_to_dict(scene), indent=2) + "\n")
