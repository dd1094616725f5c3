"""Build and load the port's CUDA kernels.

Two source sets in csrc/ become two shared libraries with a plain C
interface, loaded with ctypes: the render kernels (the solid kernel and
the record kernel, which share a header, the wavefront's triangle sweep
W1, ops/mesh_sweep.py, its pair search W2, ops/mesh_pairs.py, and its
analytic sweep W3, ops/analytic_sweep.py) and the Hopper probes (csrc/probe_*.cu,
probes/).  Every source of both sets is compiled by one
nvcc each, all started together; each set is then linked into its
library.  A library lands in the checkout's build/ directory under a hash
of every csrc file (the headers included), the flags and nvcc's version,
and is reused while none of them changes.  nvcc runs at first use, never
at import.
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
SOURCES = ("solid_trace.cu", "record_trace.cu", "mesh_sweep.cu",
           "mesh_pairs.cu", "analytic_sweep.cu")
PROBE_SOURCES = ("probe_issue.cu", "probe_tri.cu", "probe_skip.cu",
                 "probe_gather.cu", "probe_isect.cu")
SETS = {"kernels": SOURCES, "probes": PROBE_SOURCES}
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
# The most dynamic shared memory a block of the render kernels may take:
# the H100's cudaDevAttrMaxSharedMemoryPerBlockOptin (227 KB).  Past
# SMEM_LIMIT a launch opts its kernel in (trace_common.cuh `smem_opt_in`,
# which reads the card's own limit); scenes whose tables pass this constant
# are routed to the wavefront (core/scene.py `route`), on every device
# alike.
SMEM_OPTIN_MAX = 227 * 1024

_libs = {}
build_log = ""            # nvcc's output of the last build (ptxas -v lines)
build_logs = {}           # library path -> nvcc's output of its build


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME "
                           "(the kernels are compiled at first use)")
    return nvcc


def _flags(defines=()):
    """NVCC_FLAGS with a -D flag for each "NAME=VALUE" of defines."""
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _build_key(defines=()):
    """A hash of every csrc file, the flags and nvcc's version."""
    version = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256((version + " ".join(_flags(defines))).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name, key=None, defines=()):
    """Where source set `name` ("kernels" or "probes") is built."""
    return BUILD_DIR / f"{name}_{key or _build_key(defines)}.so"


def build(name="kernels", defines=()):
    """Build source set `name` unless it is built; returns its library's
    path."""
    return build_all((name,), defines)[name]


def build_all(names=tuple(SETS), defines=()):
    """Compile the source sets `names` that are not built yet, one nvcc
    per source, all started together, and link each set into its shared
    library; returns {name: library path}.  defines: "NAME=VALUE" macros
    passed to nvcc, for builds that compare a kernel's compile-time
    constants (scripts/torch_k1_tune.py); the render path passes none."""
    global build_log
    nvcc, key = _nvcc(), _build_key(defines)
    flags = _flags(defines)
    outs = {name: library_path(name, key) for name in names}
    todo = [name for name in names if not outs[name].exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = [src for name in todo for src in SETS[name]]
        objs = {src: os.path.join(tmp, src + ".o") for src in srcs}
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", objs[src],
                                   str(CSRC / src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src in srcs]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        for src, p in zip(srcs, procs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} ({p.returncode}):\n{log}")
        for name in todo:
            lib = os.path.join(tmp, name + ".so")
            res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                                  *(objs[src] for src in SETS[name])],
                                 capture_output=True, text=True)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to link {name} "
                                   f"({res.returncode}):\n{log}")
            os.replace(lib, outs[name])
            build_logs[outs[name]] = log
    build_log = log
    return outs


def load_library(defines=()):
    """Load (building first, if needed) the render kernels' library, built
    with `defines` (see build_all), and declare its entry points."""
    name = ("kernels",) + tuple(defines)
    if name not in _libs:
        _libs[name] = declare(ctypes.CDLL(str(build("kernels", defines))))
    return _libs[name]


def declare(lib):
    """Declare the render kernels' entry points on a loaded library (the
    nvcc build, or the CPU stand-in's that the tests build); returns it."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.solid_trace_launch.argtypes = [
        vp, vp, vp, vp, ci,             # seed, cam, geom, obj, n_obj
        vp, ci, vp, ci, vp, ci, vp, ci,  # dif, glo, refr, emi tables + rows
        vp, ci, ci, ci, ci,             # lights, rows, n_dir, n_point, n_spot
        vp, ci, vp,                     # is_tab, K, consts
        ci, ci, ci, ci, ci, ci, ci,     # width, height, spp, max_bounces,
                                        # iid, split_k, projection
        ctypes.POINTER(ci), ci,         # dispersive groups' depth caps
        vp, vp, vp, vp, vp]             # L, count, work counter, lane stats, stream
    lib.solid_trace_launch.restype = ci
    lib.solid_trace_info.argtypes = [ci, ctypes.POINTER(ci)]
    lib.solid_trace_info.restype = ci
    lib.record_trace_launch.argtypes = [
        vp, vp, vp, vp, ci,             # seed, cam, geom, obj, n_obj
        vp, ci, vp, ci, vp, ci, vp, ci,  # dif, glo, refr, emi tables + rows
        vp, ci,                         # tf table + rows
        vp, ci, ci, ci, ci,             # lights, rows, n_dir, n_point, n_spot
        vp, ci, vp,                     # is_tab, K, consts
        vp, vp, ci,                     # fetch table (int, float) + rows
        vp, ctypes.c_longlong,          # atlas + entries
        ci, ci, ci, ci, ci, ci, ci,     # width, height, spp, max_bounces,
                                        # iid, split_k, projection
        ci,                             # dispersive groups
        vp, vp, vp]                     # L, count, stream
    lib.record_trace_launch.restype = ci
    lib.record_trace_info.argtypes = [ci, ctypes.POINTER(ci)]
    lib.record_trace_info.restype = ci
    return lib


def load_probe_library():
    """Load (building first, if needed) the probes' library; each probe
    module declares the entry points it calls."""
    if "probes" not in _libs:
        _libs["probes"] = ctypes.CDLL(str(build("probes")))
    return _libs["probes"]


def stream_of(device):
    """The stream argument of a launch on `device`: PyTorch's current
    stream on a CUDA device; none for the CPU, where only the CPU stand-in
    of a kernel (csrc/emu) can be launched."""
    if device.type != "cuda":
        return None
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
