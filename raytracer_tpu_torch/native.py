"""The scene compiler's host library for meshes: OBJ parsing and the
binned-SAH leaf order.

Counterpart of raytracer_tpu/native/__init__.py, over the port's own copy
of its C++ source (csrc/mesh.cpp).  The library is built at first use
with g++ into the checkout's build/raytracer_tpu_torch/, under a hash of
the source, the flags and g++'s version, and loaded with ctypes.  A
failed build or load raises: there is no Python fallback, because the
JAX package's fallback BVH (a median split) orders the leaves otherwise,
and the triangle clusters follow the leaf order.  The Python OBJ reader
`geometry.primitive._parse_obj_full` is the parser's plain version, for
the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from .ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "mesh.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path():
    """Where the library is (or will be) built: keyed by a hash of the
    source, the flags and g++'s version."""
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256((version + " ".join(GXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"mesh_{h.hexdigest()[:16]}.so"


def build():
    """Build the library unless it is built; returns its path.  The
    output is written under a temporary name and renamed, so processes
    that build at once never load a half-written file."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.obj_count_full.restype = ctypes.c_int32
    lib.obj_count_full.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64p]
    lib.obj_parse_full.restype = ctypes.c_int32
    lib.obj_parse_full.argtypes = [ctypes.c_char_p, f32, f32, f32, i64, i64,
                                   i64]
    lib.bvh_build.restype = ctypes.c_int32
    lib.bvh_build.argtypes = [f32, ctypes.c_int64, f32, f32, i32, i32, i32,
                              i32, i32]
    _lib = lib
    return lib


def parse_obj_full(path):
    """v / vt / vn / f records of an OBJ file (native/__init__.py:97):
    (verts (V, 3) f32, uvs (VT, 2) f32, norms (VN, 3) f32, faces (F, 3)
    i64, face_uv (F, 3) i64, face_n (F, 3) i64), polygons fan-split into
    triangles; face_uv / face_n hold -1 where a corner has no vt / vn."""
    lib = _load()
    nv, nvt, nvn, nt = (ctypes.c_int64() for _ in range(4))
    name = str(path).encode()
    if lib.obj_count_full(name, ctypes.byref(nv), ctypes.byref(nvt),
                          ctypes.byref(nvn), ctypes.byref(nt)) != 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float32)
    uvs = np.empty((max(nvt.value, 1), 2), np.float32)
    norms = np.empty((max(nvn.value, 1), 3), np.float32)
    faces, face_uv, face_n = (np.empty((max(nt.value, 1), 3), np.int64)
                              for _ in range(3))
    if lib.obj_parse_full(name, verts, uvs, norms, faces, face_uv,
                          face_n) != 0:
        raise IOError(f"failed to parse {path}")
    return (verts, uvs[:nvt.value], norms[:nvn.value], faces[:nt.value],
            face_uv[:nt.value], face_n[:nt.value])


def build_bvh(tri_verts):
    """Binned-SAH BVH over (N, 3, 3) float32 triangle vertices
    (native/__init__.py:125): dict of bbox_lo / bbox_hi (M, 3),
    left / right / first / count (M,) and the leaf order `order` (N,)."""
    tv = np.ascontiguousarray(tri_verts, np.float32)
    n = tv.shape[0]
    if n == 0:
        raise ValueError("empty mesh")
    lib = _load()
    m = 2 * n
    lo = np.empty((m, 3), np.float32)
    hi = np.empty((m, 3), np.float32)
    left, right, first, count = (np.empty((m,), np.int32) for _ in range(4))
    order = np.empty((n,), np.int32)
    wrote = lib.bvh_build(tv.reshape(-1), n, lo, hi, left, right, first,
                          count, order)
    if wrote < 0:
        raise RuntimeError("bvh_build failed")
    return dict(bbox_lo=lo[:wrote], bbox_hi=hi[:wrote], left=left[:wrote],
                right=right[:wrote], first=first[:wrote], count=count[:wrote],
                order=order)
