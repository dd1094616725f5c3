"""Build and load the port's CUDA kernels.

The kernel sources in csrc/ (the solid kernel and the record kernel, which
share a header) are compiled by one nvcc each, all started together, and
linked into one shared library with a plain C interface, loaded with
ctypes.  The library lands in the checkout's build/ directory under a
hash of every source (the header included), the flags and nvcc's
version, and is reused while none of them changes.  nvcc runs at first
use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("solid_trace.cu", "record_trace.cu")
# The library is built into the checkout's build/ directory: the package
# runs from a checkout of the repo, not from an installed copy.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytracer_tpu_torch"
# IEEE division and sqrt (no --use_fast_math), and no FMA contraction:
# the kernels then round as their plain versions do on the card, ray for
# ray (PERF.md: contraction would save 13.7% of the solid kernel's time
# and break the exact rays_traced agreement)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

SMEM_LIMIT = 48 * 1024    # bytes of dynamic shared memory without opt-in

_lib = None
build_log = ""            # nvcc's output of the last build (ptxas -v lines)


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME "
                           "(the kernels are compiled at first use)")
    return nvcc


def build():
    """Compile csrc/ into a shared library keyed by a hash of every source
    (the header included), the flags and nvcc's version; returns its
    path.  Reuses a library already built."""
    global build_log
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256((version + " ".join(NVCC_FLAGS)).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(CSRC / src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        for src, p in zip(SOURCES, procs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} ({p.returncode}):\n{build_log}")
        lib = os.path.join(tmp, "kernels.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n"
                               f"{build_log}")
        os.replace(lib, out)
    return out


def load_library():
    """Load (building first, if needed) the kernel library and declare its
    entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.solid_trace_launch.argtypes = [
        vp, vp, vp, vp, ci,             # seed, cam, geom, obj, n_obj
        vp, ci, vp, ci, vp, ci, vp, ci,  # dif, glo, refr, emi tables + rows
        vp, ci, ci, ci, ci,             # lights, rows, n_dir, n_point, n_spot
        vp, ci, vp,                     # is_tab, K, consts
        ci, ci, ci, ci, ci, ci, ci,     # width, height, spp, max_bounces,
                                        # iid, split_k, projection
        ctypes.POINTER(ci), ci,         # dispersive groups' depth caps
        vp, vp, vp]                     # L, count, stream
    lib.solid_trace_launch.restype = ci
    lib.record_trace_launch.argtypes = [
        vp, vp, vp, vp, ci,             # seed, cam, geom, obj, n_obj
        vp, ci, vp, ci, vp, ci, vp, ci,  # dif, glo, refr, emi tables + rows
        vp, ci,                         # tf table + rows
        vp, ci, ci, ci, ci,             # lights, rows, n_dir, n_point, n_spot
        vp, ci, vp,                     # is_tab, K, consts
        ci, ci, ci, ci, ci, ci, ci,     # width, height, spp, max_bounces,
                                        # iid, split_k, projection
        ci,                             # dispersive groups
        vp, vp, vp, vp]                 # rec_g, rec_f, count, stream
    lib.record_trace_launch.restype = ci
    _lib = lib
    return lib


def check_tensor(name, t, dtype, shape, device):
    """Raise unless t is a contiguous `dtype` tensor of `shape` (None
    matches any extent) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != ts
                                    for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
