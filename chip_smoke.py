#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels (raytracer_tpu_torch/csrc: the solid kernel,
the record kernel, W1, the wavefront's triangle sweep, W2, its pair
search, W3, its analytic sweep, and W4, its shading blocks, one nvcc per
source, started together) from the checkout and drives both kernel paths
and the wavefront:

- solid: holds the solid kernel against its plain PyTorch version,
  renders the reference Cornell box at 400x400 x 256 spp through
  Scene.render (5,120 paths per pixel in 197 chunks of 26 spp), checks
  the image against the plain version, and at the chunk shape (4.16 M
  rays) holds the kernel against the plain version ray by ray and times
  both; prints the kernel's registers and persistent grid, and its
  bounce-loop lane efficiency beside the plain version's (one ray per
  thread) on the Cornell and dispersion chunks.  Every K1 check is bit
  for bit: each ray's L equal and rays_traced identical;
- record: holds the record kernel (one pass: tracing, the texel
  fetches and the path integral) against its plain version (the records
  of record_trace_chunk_reference, replayed by ops/replay.py) on examples
  1-4 at 32x32 x 16 spp, renders example 2 at 400x300 x 64 spp through
  Scene.render (512 paths per pixel with the x8 Fresnel-split fan, 16
  chunks of 32 spp), checks the image against plain-version chunks, and
  at the chunk shape (3.84 M rays) holds the kernel against the plain
  version and times both, with the peak device memory of each and the
  kernel's registers, local memory and blocks an SM.  Every K2 check is
  bit for bit, as K1's are;
- the rest of both kernels (examples/torch_primitives.py): the solid
  kernel against its plain version at 64x64 x 16 spp on the dispersion
  example, example 2 as a solid scene (glossy, shadow rays, split_k 3),
  the shapes scene (triangles, discs, cylinders, point and spot lights)
  and the Cornell box under the fisheye, equirect and orthographic
  cameras; the record kernel at 32x32 x 16 spp on the primitives, fisheye
  and panorama examples and an orthographic still life; Scene.render of
  dispersion 400x300 x 256 spp and example 2 solid 400x300 x 64 spp (the
  solid kernel), primitives 400x300 x 64 spp, fisheye 400x400 x 64 spp
  (pixels outside the image circle exactly 0) and panorama 512x256 x 64
  spp (the record kernel), each image against plain-version chunks; and
  the chunk-shape checks and times of the solid kernel on dispersion and
  the record kernel on primitives against their plain versions;
- the render options around both kernels (Scene.render's chunk loop,
  render_environment, JSON scenes, .hdr files), each driven with the
  launch counts set to 0 just before and read just after: Cornell
  400x400 rendered to 128 spp with a checkpoint every 4 chunks, then to
  256 spp from that checkpoint (it must resume at chunk 99 and equal the
  uninterrupted 256-spp render bit for bit); Cornell with a 256-spp
  budget and target_noise 0.01 (out of reach: the budget spent) and 0.02
  (met before the budget), the last noise estimate recomputed on the CPU
  from the same moments, over the frame and over a fisheye circle, within
  1e-6; example 2 with with_variance (the image bit for bit the one
  without, the variance finite and >= 0); render_environment of Cornell
  at 512x256 x 16 spp (the solid kernel), written with save_hdr and read
  back as a Panorama behind a glossy sphere (the record kernel); the JSON
  scene examples/example_scene.json at its own 400x300 x 16 spp (the
  solid kernel); a preview PNG (the returned image, bit for bit) and a
  torch.profiler trace that names the solid kernel.  After each of these
  runs, the first chunk each kernel ran in it (its arguments as
  Scene.render passed them: that path's chunk shape, seed and tables) is
  held against the plain version bit for bit.  Its files go to
  build/chip_smoke/ (ignored by git);
- the wavefront (core/integrator.py, plain torch on the card around its
  sweeps: W3, csrc/analytic_sweep.cu, for the analytic objects, W1 and
  W2 for triangles): the grid of examples/torch_wavefront.py past the
  kernels' gates (96 spheres, 98 objects) at 400x300 x 64 spp through
  Scene.render three times with one seed (bit-equal, every chunk on
  CUDA, W3 launched and no K1 / K2 launch, the counts set to 0 just
  before the renders and read just after), with its wall, Mrays/s and
  peak memory, and
  at 100x75 x 64 spp on the card against the same render on the CPU
  (image and 3x3 region means within 4 standard errors); the grid at 46
  spheres (48 objects, inside the gate) at 400x300 and Cornell at
  400x400, each at 64 spp through the solid kernel and through
  use_pallas="never", timed, their image and 3x3 region means within 4
  standard errors (from one chunk's samples on each route), and on the
  grid, printed beside it, where the wavefront would stand had its
  camera divided by |D| as the JAX wavefront does (the reference's sphere
  test is sensitive to the last bit of |D| from afar, ROADMAP.md §3);
  one render each of the 98-object grid and of
  Cornell on the wavefront under torch.profiler, with the device time of
  each bounce stage (core/integrator.py's "wavefront.*" ranges); an
  emissive scene through both routes, pixel for pixel;
  Scene.get_distances of the 98-object grid on the card against the
  CPU;
- W3 against its plain loops (geometry/intersect.py `_analytic_nearest`,
  `_analytic_occluded`) bit for bit, a share of exactly 1.0 (t and
  orientation bits, ids; shadow answers): the grid's camera rays at the
  render's chunk (4.08 M) and their first bounce (mirror continuations),
  the primitives example's (planes, discs, cylinders) camera rays, first
  bounce and shadow rays toward its directional light, Cornell's (planes,
  a box, a sphere) camera rays and first bounce; the occluded entry on
  the primitives' shadow rays with the direction and max_dist the
  expand of one row, as materials/shade.py passes them, and one a ray
  (some rays occluded and some not, required of both), and on the
  icosphere's at the render's chunk (1.92 M, from the camera rays' hits,
  one row; no analytic object occludes them); W3's nearest entry alone
  timed through a CUDA graph at the grid's camera rays, its occluded
  entry at those three inputs, and, in a process of its own
  (`w3_events`), the profiler's device events of the occluded wrapper on
  the icosphere's: one W3 kernel a call and nothing else (no copy of the
  expanded inputs); the primitives example at 400x300 x 16 spp through
  Scene.render on the wavefront, both entries launched (counts set to 0
  just before, read just after).  `python3 chip_smoke.py --w3` runs the
  build and this phase alone;
- W4 (csrc/wavefront_shade.cu: the diffuse, refractive and glossy
  blocks) in the driven wavefront renders: the 98-object grid at 400x300
  x 64 spp, Cornell at 400x400 x 64 spp on the wavefront, the icosphere,
  the beach ball and the instance field at 400x300 x 16 spp, the
  normal-mapped scene at 400x300 x 16 spp, and one forward + backward
  pass of the inverse-rendering gradient; each with W4's counts set to 0
  just before and read just after (every entry of its scene launched, no
  plain shading block run on the card but a backward pass's recompute,
  both required); each entry at every bounce of each render's first
  chunk (captured where core/integrator.py `trace` calls it) held against
  the plain dispatch, every field of every ray bit for bit (a share of
  exactly 1.0), W4 alone timed through a CUDA graph at it beside the
  plain block, a line a bounce for Cornell on the wavefront and the
  icosphere (rays of the type, warps of 32 rays holding one, lane
  efficiency, time, bound, share, the bytes its rows occupy counted by
  32-byte sectors and the share of their time; the diffuse and
  refractive entries, which queue their rays, also with their shading
  rounds' lane efficiency and with their rays moved to the front); the
  registers, stack, local memory and blocks an SM of every W4 kernel;
  the diffuse entry's caps sum in registers held against torch.sum on the
  card, bit for bit, at K = 1-127, and W4's restated sinf / cosf against
  libdevice's on all 2^32 floats; the kernels line has a row an entry,
  at its held bounce with the most rays of its type, its bound from the
  bytes it moves there and its issue slots off its kernel's SASS
  (probes/common.py `shaded_pass` for the glossy entry, `queued_pass` for
  the queued ones), and the mean a call over that chunk's bounces.
  `python3 chip_smoke.py --w4` runs the build and this phase alone;
- the meshes (examples/torch_mesh.py, the wavefront's clustered
  triangle sweep through W1, csrc/mesh_sweep.cu, over the pairs of W2,
  csrc/mesh_pairs.cu; corner normals and uvs, mesh instances in plain
  torch): the icosphere (5,120 faces), the
  textured UV sphere (1,224) and the field of 48 instances (61,440
  virtual triangles) at 400x300 x 16 spp through Scene.render, two or
  three renders of one seed bit-equal, every chunk on CUDA, no K1 / K2
  launch and W1 and W2 launched (their counts set to 0 just before the
  renders and read just after), with wall, Mrays/s and peak memory, and
  one profiled render each with the device time by stage and the
  clustered sweep's share, host syncs (one a sweep, required) and device
  events a bounce, W1's and W2's kernels' device time and the rate in
  triangle tests a second; W2 against the plain pair search on the three
  examples' camera rays at the render's chunk and their first hits'
  shadow rays: pairs, records, visit ranks, K and the clusters with
  pairs equal (a share of exactly 1.0), one host sync a search, each
  timed alone through CUDA graphs (search and write) beside the plain
  search; W1 over W2's pairs on the beach ball's camera and shadow rays
  bit for bit against the plain fold; W1 against its
  plain version (geometry/intersect.py) bit for bit, a share of exactly
  1.0, on the icosphere's camera rays at the render's chunk (1.92 M),
  their first bounce and shadow rays (clustered and flat) and the
  instance field's camera rays, W1's clustered nearest alone timed
  through a CUDA graph at the camera rays and the instance field's, its
  clustered occluded at the shadow rays; the clustered sweep against the flat sweep over the
  same leaf-ordered tables on the same rays (t bit-equal, winners equal
  on 99.99%), each timed;
  the icosphere at 100x75 x 16 spp on the card against the CPU and the
  instance field against the same field baked into 48 TriangleMesh
  copies at 4 spp (image and 3x3 region means within 4 standard
  errors), use_pallas="always" raising on the instances; a flat 20-face
  icosahedron inside the gate through the solid kernel (bit for bit
  against its plain version on one chunk) and through the wavefront,
  within 4 standard errors;
- the features (examples/torch_features.py, plain torch on the card but
  where a kernel's route runs): example_env_is at 400x300 x 64 spp with
  the environment's alias tables (the wavefront) and without (the record
  kernel, its first chunk bit for bit against its plain version), the
  two images and 3x3 region means within 4 standard errors and the mean
  pixel variance lower with the tables; the custom-material example at
  400x300 x 32 spp and a normal-mapped scene at 400x300 x 16 spp (its
  168 faces through W1's flat sweep: W1 launched, its wall and peak
  printed beside those of the plain sweep, and W1's flat nearest and
  shadow rays bit for bit against their plain versions on its camera
  rays and their hits' shadow rays, each timed alone through a CUDA
  graph); each of the three small on the card against the CPU (the
  custom scene draws nothing past the jitter, so pixel by pixel);
  Scene.render_denoised of Cornell 400x400 x 16 spp (the solid kernel, its launches counted and
  its first chunk held bit for bit, then the AOV pass and the filter),
  its display MSE against the main path's 256-spp image below the raw
  render's; render_motion_blur of example_motion_blur at 400x300 x 64
  spp twice (32 slices, each one compile, one upload and its chunks on
  the record kernel: launches = slices x chunks, the renders bit-equal,
  the first slice chunk bit for bit against the plain version);
  render_ods of example_vr at 512x256 x 32 spp (ipd 0: bit-equal eyes)
  and at ipd 0.2; `python -m raytracer_tpu_torch devices` and `render
  examples/example_scene.json --spp 16` as processes on the card.  Each
  part prints its wall and peak memory.  `python3 chip_smoke.py
  --features` runs the build and this phase alone;
- diff.py and multi-device rendering (raytracer_tpu_torch/diff.py,
  parallel/): differentiable_render of examples/torch_inverse_rendering.py's
  scene at 96x72 x 8 spp (forward and forward + backward walls and peak
  memory, the IoR gradient against a central difference within rtol
  0.05, two backward passes bit-equal, W3 launched); the
  same scene with the glass sphere as a 1,280-face clustered icosphere
  mesh (W1 launched; its winners' t recomputed for autograd), its IoR
  gradient against a central difference within rtol 0.05;
  Cornell 400x400 x 256 spp over a 4x1 mesh of cuda:0 shards (K1 on each:
  4 launches a chunk, the first shard chunk bit for bit against its plain
  version, image and regions within 4 standard errors of the unsharded
  render, the walls side by side; at eight more seeds the seed-averaged
  difference within 4 standard errors of its scatter); a 1x1 mesh
  bit-equal to the unsharded render; Cornell 100x100 over a 2x2 mesh (the wavefront a band) within 4
  standard errors; an emissive scene across 1x1, 4x1 and 2x2 against the
  unsharded render pixel by pixel (1e-6); F1: one Glossy sphere under
  1,200 point lights (53,220 B of tables) through K1 and its textured
  variant through K2, opted in past 48 KB, each first chunk bit for bit
  against its plain version, with the bytes, blocks an SM and chunk time;
  two gloo processes on cuda:0 (tests/torch_multihost_runner.py, each
  with a timeout) whose frames equal each other and one process's.
  `python3 chip_smoke.py --diff-mesh` runs the build and this phase
  alone;
- the Hopper probes (raytracer_tpu_torch/probes, csrc/probe_*.cu), built
  with the kernels: P1 the FP32 issue peak and the slot cost of special
  ops, P5 the dead-lane cost, P3 / P4 the ray x triangle sweeps (P3 also
  at 16x the rays and on its edge input, with one line of launches a
  call, ms, G tests/s and share of the bound per kernel and shape), P6 the
  per-lane gather beside torch.take (at its script's size and at the
  scale of example 2's replay; in a process of its own, its base
  kernel's profiler events must count its calls and agree with the graph
  timer within gather.PROFILER_TOLERANCE), each at its TPU script's size with every
  timed kernel held against its plain version at the timed shape (P2,
  P3, P4, P6 and the nearest-hit tests bit for bit, P1 and P5 within the
  probe's stated tolerance); the measured cost of one nearest-hit test of
  each kind against the hand count; then P2: the streamed fma chains,
  fused and unfused, and the bound of the solid and record kernels at the
  chunk shapes of Cornell, example 2, dispersion and primitives, from the
  plain versions' event counts and this run's kernel times; and the
  bound of each of W1's four entries at the input it was timed on: the
  triangle tests that input needs (the occluded entries stop at a ray's
  or pair's first occluder) at the issue slots of one test, read off
  the SASS of the entry's loop (probes/common.py `loop_issue`), against
  its bytes; beside the clustered nearest's, its tests at isect_cost's
  measured cost of the render kernels' triangle test; the bound of W2
  at the instance field's camera rays: one box test a (record, ray) slot
  at the issue slots read off the SASS of its count kernel's loop,
  against its bytes; and the bound of each of W3's entries at the input
  it was timed on: the tests of each kind that input needs (the occluded
  entry's up to each ray's first occluder) at the issue slots of that
  kind's test, read off the SASS of the kind's loop in the entry's kernel
  (probes/common.py `kind_loops`), against its bytes (the occluded
  entry's: tests of the casting objects alone; a direction and max_dist
  passed as one row counted once).

Each phase and each probe prints one line; any failure exits non-zero
before the last line, which is {"ok": true, "device": {...}}.  Without a CUDA device it
exits 1.  Imports neither jax nor raytracer_tpu.
"""

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"      # the render options' files
W, H, SPP = 400, 400, 256             # the main path (bench.py's Cornell)
CHECK_W, CHECK_H, CHECK_SPP = 64, 64, 16   # kernel vs plain: 65,536 rays
MATCH_RTOL, MATCH_ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999
REF_SPP = 20                          # plain-version chunk of the image check
TIMED_RENDERS = 3
KERNEL_REPS = 20
# the record path: example 2 at its own settings
REC_W, REC_H, REC_SPP = 400, 300, 64
REC_CHECK = 32, 32, 16                # kernel vs plain on examples 1-4
REC_REF_CHUNKS = 2                    # plain-version chunks of the image check
REC_KERNEL_REPS = 10
# the other paths of both kernels: (example, width, height, spp) of each
# render, the kernel-vs-plain scenes, the timed renders of each
NEW_SOLID_RENDERS = (("dispersion", 400, 300, 256), ("example2_solid", 400, 300, 64))
NEW_RECORD_RENDERS = (("primitives", 400, 300, 64), ("fisheye", 400, 400, 64),
                      ("panorama", 512, 256, 64))
NEW_SOLID_CHECKS = ("dispersion", "example2_solid", "shapes", "cornell-fisheye",
                    "cornell-equirect", "cornell-orthographic")
NEW_RECORD_CHECKS = ("primitives", "fisheye", "panorama", "still_life-orthographic")
NEW_TIMED_RENDERS = 2
NEW_REF_CHUNKS = 2
# the render options: Cornell at 128 then 256 spp (resume), the adaptive
# target and budget, the environment bake and the .hdr scene, the JSON
# scene's samples, the preview and profiled renders' samples
RESUME_SPP, RESUME_EVERY = 128, 4
TARGET_NOISE = 0.01                   # out of reach within the budget
REACH_NOISE = 0.02                    # met at about half the budget
NOISE_ATOL = 1e-6                     # the card's noise_q99 against the CPU's
ENV_W, ENV_H, ENV_SPP = 512, 256, 16
HDR_W, HDR_H, HDR_SPP = 400, 300, 16
JSON_SPP = 16
PREVIEW_SPP, PROFILE_SPP = 16, 8
# the wavefront: the grid of scripts/probe_obj_cap.py past the gate (96
# spheres, 98 objects) and inside it (46 spheres, 48 objects), Cornell,
# each at 64 spp; the emissive scene's samples; the regions a side of the
# per-region hold; the card's depth AOV against the CPU's; the frame of
# the 98-object grid's card-against-CPU hold
GRID_PAST, GRID_INSIDE = 96, 46
GRID_W, GRID_H, WAVE_SPP = 400, 300, 64
CPU_W, CPU_H = 100, 75
WAVE_CORNELL = 400, 400
EMISSIVE_SPP = 16
REGIONS = 3
DIST_ATOL = 1e-6
# the meshes (examples/torch_mesh.py): the three mesh examples at their own
# size, timed renders of each (the instance field's take longest, so it
# has one fewer); the rays of the clustered-against-flat hold (camera rays
# at SWEEP_SPP, then their first bounce), the winners it requires equal;
# the frame of the card-against-CPU hold; the samples of the instanced
# against baked hold
MESH_W, MESH_H, MESH_SPP = 400, 300, 16
MESH_SCENES = (("icosphere", 3), ("beach_ball", 3), ("instances", 2))
# W1 (csrc/mesh_sweep.cu): the CUDA-graph replays of its timing; its
# entries (ops/mesh_sweep.py wrappers), each with its sweep kernel (whose
# SASS loop gives the issue slots of a triangle test) and the TPU sweep it
# replaces; and what the run gathers for the kernels line, a row an entry:
# launches in the driven renders (counts set to 0 just before each, read
# just after), the largest |t| difference of its holds (0: bit-equal;
# occluded: 1 where any ray differs), and its work and times at the held
# input it is timed on
W1_REPS = 5
W1_ENTRIES = {
    "clustered_nearest": ("cluster_nearest_kernel",
                          "raytracer_tpu/geometry/intersect.py:317"),
    "clustered_occluded": ("cluster_occluded_kernel",
                           "raytracer_tpu/geometry/intersect.py:370"),
    "flat_nearest": ("flat_nearest_kernel",
                     "raytracer_tpu/geometry/intersect.py:421"),
    "flat_occluded": ("flat_occluded_kernel",
                      "raytracer_tpu/geometry/intersect.py:421")}
W1 = {"launches": dict.fromkeys(W1_ENTRIES, 0),
      "max_abs_err": dict.fromkeys(W1_ENTRIES, 0.0), "timed": {}}
# W2 (csrc/mesh_pairs.cu), the pair search: the CUDA-graph replays of its
# timing; the kernel whose SASS loop gives the issue slots of a box test,
# and the instruction counted once a test (the warp's ballot); what the
# run gathers for its row: launches in the driven mesh renders, the
# elements that differed from the plain search (0: equal), and its work
# and times at the instance field's camera rays
W2_REPS = 5
W2_LOOP = ("pair_count_kernel", "VOTE")
W2 = {"launches": 0, "max_abs_err": 0.0, "timed": None}
# W3 (csrc/analytic_sweep.cu), the analytic sweep: the CUDA-graph replays
# of its timing; its entries (ops/analytic_sweep.py wrappers), each with
# its kernel (whose SASS holds one loop a kind, in object-id order, each
# giving the issue slots of that kind's test) and the JAX function whose
# analytic part it replaces; what the run gathers for its rows: launches
# in the driven wavefront renders (counts set to 0 just before each, read
# just after), the largest |t| difference of its holds (0: bit-equal;
# occluded: 1 where any ray differs), and its work and times at each held
# input it is timed on, in turn; the samples of the primitives scene's
# render on the wavefront
W3_REPS = 5
W3_ENTRIES = {
    "analytic_nearest": ("analytic_nearest_kernel",
                         "raytracer_tpu/geometry/intersect.py:480"),
    "analytic_occluded": ("analytic_occluded_kernel",
                          "raytracer_tpu/geometry/intersect.py:546")}
W3_KINDS = ("sphere", "plane", "box", "disc", "cylinder")
# W3's held occluded inputs (`held_shadow_rays`): (scene, L and max_dist one row)
HELD_SHADOW = (("primitives", True), ("primitives", False), ("icosphere", True))
W3_EVENT_CALLS = 10       # calls of the occluded wrapper under the profiler
W3 = {"launches": dict.fromkeys(W3_ENTRIES, 0),
      "max_abs_err": dict.fromkeys(W3_ENTRIES, 0.0), "timed": []}
PRIM_W, PRIM_H, PRIM_SPP = 400, 300, 16
# W4 (csrc/wavefront_shade.cu), the shading blocks: the CUDA-graph replays
# of its timing; its entries (ops/wavefront_shade.py wrappers), each with
# its kernel (whose SASS loop over the rays gives a pass's issue slots)
# and the JAX block it replaces; what the run gathers for its rows:
# launches in the driven wavefront renders (counts set to 0 just before
# each, read just after), the largest difference of its holds (0:
# bit-equal), and its work and times at the held bounce with the most rays
# of its type; the bounces captured in the driven renders (the first call
# of each entry a render), and the plain blocks run on the card outside a
# hold or a backward pass (none allowed)
W4_REPS = 5
# the lamp cluster's importance-sampled lamps and frame (examples/
# torch_wavefront.py lamp_cluster)
LAMPS, LAMP_WH = 131, (200, 150)
# the entries that queue their rays (csrc/wavefront_shade.cu shade_queued)
W4_QUEUED = ("shade_diffuse", "shade_refractive")
# the caps sum in registers held against torch.sum on the card: terms a
# row (every register instantiation, and lane counts past a power of
# two) and rows
W4_SUM_KS, W4_SUM_ROWS = (1, 2, 3, 5, 17, 32, 33, 100, 127), 100_003
W4_ENTRIES = {
    "shade_diffuse": ("shade_diffuse_kernel",
                      "raytracer_tpu/materials/shade.py:317"),
    "shade_refractive": ("shade_refractive_kernel",
                         "raytracer_tpu/materials/shade.py:385"),
    "shade_glossy": ("shade_glossy_kernel",
                     "raytracer_tpu/materials/shade.py:215")}
W4 = {"launches": dict.fromkeys(W4_ENTRIES, 0),
      "max_abs_err": dict.fromkeys(W4_ENTRIES, 0.0), "timed": {},
      "chunk_ms": {}, "slots": {},
      "label": None, "captured": {}, "seen": set(), "chunk_done": set(),
      "plain_on_card": 0, "holding": False, "backward": 0}
# the renders whose held bounces print a line each
W4_PER_BOUNCE = ("Cornell on the wavefront", "icosphere")
# the normal-mapped frame through the plain triangle sweep on an H100 80GB
# HBM3 at 700 W, s and GiB (PERF.md)
NMAP_PLAIN = (1.4254, 9.39)
SWEEP_SPP = 4
WINNER_RATE = 0.9999
INST_SPP = 4


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def build_lines(log):
    """ptxas's registers / stack / spill line of the render kernels, of
    W4's and of P3's and P6's kernels, and a summary of the other probe
    kernels."""
    funcs, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif cur and ("registers" in ln or "spill" in ln):
            funcs.setdefault(cur, []).append(ln.split("info    :")[-1].strip())
    render = [f"{name}: {'; '.join(v)}" for name, v in funcs.items()
              if "solid_trace" in name or "record_trace" in name]
    pattern = r"(tri|gather|shade)_[a-z_]+?_kernel"
    p3 = [f"{re.search(pattern, name).group()}: {'; '.join(dict.fromkeys(v))}"
          for name, v in funcs.items() if re.search(pattern, name)]
    probes = [v for name, v in funcs.items()
              if not ("solid_trace" in name or "record_trace" in name)]
    return render + p3 + [f"{len(probes)} probe kernels"]


def nvcc_version(cuda_build):
    res = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[-1]


def cuda_ms(fn, reps):
    """Mean milliseconds of `reps` calls of fn, timed with CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(L_k, L_p, n_k, n_p):
    """Per-ray match rate, max abs error, bit-equal share and both counts."""
    import torch
    torch.cuda.synchronize()
    match = torch.isclose(L_k, L_p, rtol=MATCH_RTOL, atol=MATCH_ATOL).all(dim=1)
    return (match.float().mean().item(), (L_k - L_p).abs().max().item(),
            (L_k == L_p).all(dim=1).float().mean().item(), int(n_k), int(n_p))


def scene_inputs(build_cornell, width, height, device):
    from raytracer_tpu_torch.core.camera import cam_vec

    sc = build_cornell(width, height)
    _, tables, settings = sc._settings_for_render()
    return sc, tables.to(device), cam_vec(sc.camera.params()).to(device), settings


def record_plain(args):
    """The record path's plain version of one chunk: the records of
    record_trace_chunk_reference, replayed (ops/replay.py); (L, count)."""
    from raytracer_tpu_torch.ops import record_trace as rt

    seed, static, tables, cam, W, H, spp, B = args[:8]
    g, f, count = rt.record_trace_chunk_reference(*args)
    return rt.replay(g, f, static, tables, B, spp * W * H), count


def record_check(torch, name, args):
    """The fused record kernel against its plain version on one chunk:
    every ray's L bit for bit, rays_traced identical, L finite.  Returns
    (max abs error, line fragment)."""
    from raytracer_tpu_torch.ops import record_trace as rt

    (L_k, n_k), (L_p, n_p) = rt.record_trace_chunk(*args), record_plain(args)
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    require(bit_eq == 1.0, f"{name}: bit-equal share {bit_eq} < 1")
    require(n_k == n_p, f"{name}: rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), f"{name}: non-finite L")
    return max_err, (f"match {rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err "
                     f"{max_err:.3e} | rays_traced {n_k} vs {n_p}")


def solid_check(torch, name, args):
    """The solid kernel against its plain version on one chunk: every
    ray's L bit for bit, rays_traced identical, L finite.  Returns (max
    abs error, line fragment)."""
    from raytracer_tpu_torch.ops import solid_trace as st

    L_k, n_k = st.solid_trace_chunk(*args)
    L_p, n_p = st.solid_trace_chunk_reference(*args)
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    require(bit_eq == 1.0, f"{name}: bit-equal share {bit_eq} < 1")
    require(n_k == n_p, f"{name}: rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), f"{name}: non-finite kernel output")
    return max_err, (f"match {rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err "
                     f"{max_err:.3e} | rays_traced {n_k} vs {n_p}")


def record_timing(torch, dev, name, static, args):
    """CUDA-event times of the fused record kernel and of its plain
    version (records then replay, for the record) on one chunk, the peak
    device memory of each, and the kernel as built; prints one line and
    returns (kernel ms, plain ms)."""
    from raytracer_tpu_torch.ops import record_trace as rt

    kernel = lambda: rt.record_trace_chunk(*args)
    plain = lambda: record_plain(args)
    kernel(), plain()                               # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    plain_ms = [cuda_ms(plain, 1)]
    plain_peak = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    kernel_ms = [cuda_ms(kernel, REC_KERNEL_REPS), cuda_ms(kernel, REC_KERNEL_REPS)]
    kernel_peak = torch.cuda.max_memory_allocated(dev) - base
    plain_ms.append(cuda_ms(plain, 1))
    ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    info = rt.kernel_info(static, args[2])
    seed, static, tables, cam, W, H, spp, B = args[:8]
    print(f"{name} record chunk timing: {spp} spp x {W}x{H} = {spp * W * H} rays, "
          f"{B} bounces | fused kernel {ms:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in kernel_ms)}), peak {kernel_peak / 2 ** 20:.1f} "
          f"MiB above the inputs | plain records + replay {p_ms:.1f} ms "
          f"({', '.join(f'{x:.1f}' for x in plain_ms)}), peak "
          f"{plain_peak / 2 ** 20:.1f} MiB | K2 as built: {info['registers']} "
          f"registers, {info['local_bytes']} B local a thread, block {info['block']}, "
          f"min blocks {info['min_blocks']}, {info['blocks_per_sm']} blocks an SM",
          flush=True)
    require(info["blocks_per_sm"] >= 1, "K2 fits no block on an SM")
    return ms, p_ms


def record_phases(torch, dev):
    """The record path's phases; returns the record kernel's row of the
    kernels line, and the fused kernel's ms at the chunk shape."""
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import record_trace as rt
    import torch_textured

    # ---- fused record kernel vs plain version on examples 1-4 ----
    W, H, spp = REC_CHECK
    errs = []
    for k, build in torch_textured.EXAMPLES.items():
        sc = build(W, H, **({"blur": 0.0} if k == 4 else {}))
        static, tables, settings = sc._settings_for_render()
        tables = tables.to(dev)
        cam = cam_vec(sc.camera.params()).to(dev)
        seed = torch.tensor([20260916 + k, 4242, 0], dtype=torch.int32,
                            device=dev)
        args = (seed, static, tables, cam, W, H, spp, settings.max_bounces,
                settings.split_k)
        err, line = record_check(torch, f"example {k}", args)
        errs.append(err)
        print(f"record kernel vs plain, example {k}{' (blur 0)' if k == 4 else ''}: "
              f"{W * H * spp} rays, max_bounces {settings.max_bounces}, split_k "
              f"{settings.split_k}, fetch rounds {rt.replay_rounds(static)} | {line}",
              flush=True)

    # ---- the record path's main path: example 2 through Scene.render ----
    sc = torch_textured.example2(REC_W, REC_H)
    static, tables, settings = sc._settings_for_render()
    require(static.pallas_tex_ok and settings.split_k == 3,
            "example 2 does not take the record path with split_k 3")
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(REC_SPP * fan, REC_W, REC_H, fan)
    require((chunk, n_chunks) == (32, 16), f"chunk plan {(chunk, n_chunks)}")
    rt.record_trace_chunk.launches = 0
    walls, stats = [], None
    for _ in range(1 + TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = sc.render(samples_per_pixel=REC_SPP, output="linear",
                               return_stats=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = rt.record_trace_chunk.launches
    require(launches == n_chunks * (1 + TIMED_RENDERS),
            f"{launches} record kernel launches for {1 + TIMED_RENDERS} renders")
    wall = statistics.median(walls[1:])
    mrays = stats["rays_traced"] / wall / 1e6
    require(img.shape == (REC_H, REC_W, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(torch.from_numpy(img)).all()), "non-finite image")
    img_mean = float(img.mean())
    # plain-version chunks of the same frame; the mean of each block of
    # 2^split_k consecutive samples (one of every branch pattern) is one
    # unbiased observation
    tables = tables.to(dev)
    cam = cam_vec(sc.camera.params()).to(dev)
    blocks = []
    for i in range(REC_REF_CHUNKS):
        ref_seed = torch.tensor([777 + i, 31337, i * chunk], dtype=torch.int32,
                                device=dev)
        L_ref, _ = record_plain((ref_seed, static, tables, cam, REC_W, REC_H,
                                 chunk, settings.max_bounces, settings.split_k))
        L_ref = torch.where(torch.isfinite(L_ref), L_ref, 0.0)
        blocks.append(L_ref.view(chunk // fan, -1).mean(dim=1).double())
        del L_ref
    blocks = torch.cat(blocks)
    ref_mean = blocks.mean().item()
    se = (blocks.std() / len(blocks) ** 0.5).item()
    print(f"record main path: Scene.render example 2 {REC_W}x{REC_H} x {REC_SPP} "
          f"spp (x{fan} split fan), {n_chunks} chunks of {chunk} spp, {launches} "
          f"record kernel launches in {1 + TIMED_RENDERS} renders | wall "
          f"{wall:.4f} s (median of {TIMED_RENDERS}; "
          f"{', '.join(f'{w:.4f}' for w in walls)}) | rays_traced "
          f"{stats['rays_traced']} | {mrays:.1f} Mrays/s | image mean "
          f"{img_mean:.6f}, plain {REC_REF_CHUNKS} x {chunk}-spp chunks "
          f"{ref_mean:.6f} +- {se:.6f} ({len(blocks)} blocks)", flush=True)
    require(abs(img_mean - ref_mean) < 4 * se,
            f"image mean {img_mean} vs plain {ref_mean} (4 SE = {4 * se})")

    # ---- fused kernel vs plain at the chunk shape (3.84 M rays) ----
    seed = torch.tensor([99, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, static, tables, cam, REC_W, REC_H, chunk,
            settings.max_bounces, settings.split_k)
    err, line = record_check(torch, "example 2 chunk", args)
    errs.append(err)
    print(f"record kernel vs plain at the chunk shape: {chunk * REC_W * REC_H} "
          f"rays | {line}", flush=True)
    torch.cuda.empty_cache()
    ms, p_ms = record_timing(torch, dev, "example2", static, args)
    return ({"name": "record_trace", "route": "cuda",
             "source": "raytracer_tpu_torch/csrc/record_trace.cu",
             "replaces": "raytracer_tpu/ops/pallas_record.py:182",
             "launches": launches, "max_abs_err": max(errs),
             "ms": ms, "plain_ms": p_ms}, ms)


def new_scene(name, width, height):
    """A scene of the other paths' phases, built with the port."""
    import torch_primitives
    from torch_cornellbox import build_cornell

    if name.startswith("cornell-"):
        return build_cornell(width, height, name.split("-")[1])
    if name == "still_life-orthographic":
        return torch_primitives.orthographic(width, height)
    return torch_primitives.BUILDERS[name](width, height)


def chunk_args(torch, dev, sc, spp, seed):
    """(static, settings, kernel arguments) of one chunk of scene sc on
    the card; the arguments end with split_k, sampler and projection."""
    from raytracer_tpu_torch.core.camera import cam_vec

    static, tables, settings = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    seed = torch.tensor(seed, dtype=torch.int32, device=dev)
    tail = (W, H, spp, settings.max_bounces, settings.split_k,
            settings.sampler, settings.projection)
    cam = cam_vec(sc.camera.params()).to(dev)
    tables = tables.to(dev)
    args = ((seed, tables, cam) if static.pallas_ok
            else (seed, static, tables, cam)) + tail
    return static, settings, args


def plain_L(torch, static, args):
    """The plain version's radiance of one chunk (records then replay on
    the record path), non-finite samples scrubbed as Scene.render does."""
    from raytracer_tpu_torch.ops import solid_trace as st

    if static.pallas_ok:
        L, _ = st.solid_trace_chunk_reference(*args)
    else:
        L, _ = record_plain(args)
    return torch.where(torch.isfinite(L), L, 0.0)


def kernel_vs_plain(torch, dev, name, width, height, spp, seed):
    """One chunk of scene `name` through its kernel and its plain version
    on the same inputs, bit for bit; returns the max abs error of L."""
    sc = new_scene(name, width, height)
    static, settings, args = chunk_args(torch, dev, sc, spp, seed)
    n = spp * width * height
    head = (f"{name} {width}x{height} x {spp} spp ({settings.projection}, "
            f"split_k {settings.split_k}, max_bounces {settings.max_bounces})")
    check = solid_check if static.pallas_ok else record_check
    max_err, line = check(torch, name, args)
    print(f"{'solid' if static.pallas_ok else 'record'} kernel vs plain, {head}: "
          f"{n} rays | {line}", flush=True)
    return max_err


def lane_efficiency(torch, name, args):
    """Print K1's bounce-loop lane efficiency on one chunk (lane-iterations
    with a ray over all lane-iterations, counted by the kernel when asked)
    beside the plain version's with one ray per thread (its alive masks,
    warps of 32 consecutive rays)."""
    from raytracer_tpu_torch.probes import dead_bounce

    plain = dead_bounce.plain_lane_efficiency(args)
    kernel = dead_bounce.kernel_lane_efficiency(args)
    print(f"{name} K1 lane efficiency at the chunk shape: kernel {kernel:.4f} "
          f"(persistent, refilling) | plain {plain:.4f} (one ray per thread)",
          flush=True)
    require(0.0 < kernel <= 1.0 and 0.0 < plain <= 1.0,
            f"{name}: lane efficiency {kernel}, {plain}")
    torch.cuda.empty_cache()


def render_path(torch, dev, name, width, height, spp):
    """Scene.render of example `name` at full width through its kernel,
    one warm-up and NEW_TIMED_RENDERS timed renders, the launch count of
    those renders, and the image mean against NEW_REF_CHUNKS plain-version
    chunks (block means over the split patterns).  Returns the launches."""
    import numpy as np
    from raytracer_tpu_torch.core.camera import projection_mask
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st

    sc = new_scene(name, width, height)
    static, _, settings = sc._settings_for_render()
    fn = st.solid_trace_chunk if static.pallas_ok else rt.record_trace_chunk
    kernel = "solid" if static.pallas_ok else "record"
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(spp * sc._diffuse_fan() * fan, width, height, fan)
    fn.launches = 0
    walls, stats = [], None
    for _ in range(1 + NEW_TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = sc.render(samples_per_pixel=spp, output="linear",
                               return_stats=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = fn.launches
    require(launches == n_chunks * (1 + NEW_TIMED_RENDERS),
            f"{name}: {launches} {kernel} kernel launches for "
            f"{1 + NEW_TIMED_RENDERS} renders of {n_chunks} chunks")
    wall = statistics.median(walls[1:])
    mrays = stats["rays_traced"] / wall / 1e6
    require(img.shape == (height, width, 3), f"{name}: image shape {img.shape}")
    require(bool(np.isfinite(img).all()), f"{name}: non-finite image")
    mask = projection_mask(settings.projection, width, height)
    masked = ""
    if mask is not None:
        outside = img.reshape(-1, 3)[mask == 0]
        require(bool((outside == 0).all()), f"{name}: lit pixels outside the circle")
        masked = f", {len(outside)} pixels outside the image circle all 0"
    img_mean = float(img.mean())
    blocks = []
    for i in range(NEW_REF_CHUNKS):
        _, _, args = chunk_args(torch, dev, sc, chunk, [777 + i, 31337, i * chunk])
        L = plain_L(torch, static, args).view(chunk, width * height, 3)
        if mask is not None:
            L = L * torch.from_numpy(mask).to(dev)[None, :, None]
        per_sample = L.reshape(chunk, -1).mean(dim=1).double()
        blocks.append(per_sample.view(chunk // fan, fan).mean(dim=1))
        del L
    blocks = torch.cat(blocks)
    ref_mean = blocks.mean().item()
    se = (blocks.std() / len(blocks) ** 0.5).item()
    print(f"{kernel} path: Scene.render {name} {width}x{height} x {spp} spp "
          f"(x{sc._diffuse_fan() * fan} fan, {settings.projection}), {n_chunks} "
          f"chunks of {chunk} spp, {launches} {kernel} kernel launches in "
          f"{1 + NEW_TIMED_RENDERS} renders | wall {wall:.4f} s (median of "
          f"{NEW_TIMED_RENDERS}; {', '.join(f'{w:.4f}' for w in walls)}) | "
          f"rays_traced {stats['rays_traced']} | {mrays:.1f} Mrays/s | image "
          f"mean {img_mean:.6f}, plain {NEW_REF_CHUNKS} x {chunk}-spp chunks "
          f"{ref_mean:.6f} +- {se:.6f} ({len(blocks)} blocks){masked}", flush=True)
    require(abs(img_mean - ref_mean) < 4 * se,
            f"{name}: image mean {img_mean} vs plain {ref_mean} (4 SE = {4 * se})")
    return launches


def chunk_timing(torch, dev, name, width, height, spp):
    """Kernel against plain version at scene `name`'s chunk shape: the
    match, bit for bit, then CUDA-event times.  Returns (max abs error,
    kernel ms, plain ms)."""
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import solid_trace as st

    sc = new_scene(name, width, height)
    static, _, settings = sc._settings_for_render()
    fan = 1 << settings.split_k
    chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, width, height, fan)
    static, settings, args = chunk_args(torch, dev, sc, chunk, [99, 4242, 0])
    n = chunk * width * height
    B = settings.max_bounces
    if not static.pallas_ok:
        max_err, line = record_check(torch, f"{name} chunk", args)
        print(f"{name} kernel vs plain at the chunk shape: {n} rays | {line}",
              flush=True)
        torch.cuda.empty_cache()
        ms, p_ms = record_timing(torch, dev, name, static, args)
        return max_err, ms, p_ms
    kernel = lambda: st.solid_trace_chunk(*args)
    plain = lambda: st.solid_trace_chunk_reference(*args)
    (L_k, n_k), (L_p, n_p) = kernel(), plain()
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    print(f"{name} kernel vs plain at the chunk shape: {n} rays | match "
          f"{rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e} | "
          f"rays_traced {n_k} vs {n_p}", flush=True)
    require(bit_eq == 1.0, f"{name} chunk: bit-equal share {bit_eq} < 1")
    require(n_k == n_p, f"{name} chunk-shape rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), f"{name}: non-finite kernel output")
    del L_k, L_p
    torch.cuda.reset_peak_memory_stats(dev)
    plain_ms = [cuda_ms(plain, 1)]
    kernel_ms = [cuda_ms(kernel, REC_KERNEL_REPS), cuda_ms(kernel, REC_KERNEL_REPS)]
    plain_ms.append(cuda_ms(plain, 1))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    print(f"{name} chunk timing: {chunk} spp x {width}x{height} = {n} rays, {B} "
          f"bounces | kernel {ms:.3f} ms ({', '.join(f'{x:.3f}' for x in kernel_ms)}) "
          f"| plain {p_ms:.1f} ms ({', '.join(f'{x:.1f}' for x in plain_ms)}) "
          f"| peak {peak_gib:.2f} GiB", flush=True)
    lane_efficiency(torch, name, args)
    return max_err, ms, p_ms


def other_paths(torch, dev, solid):
    """The new paths of one kernel (solid=True: K1, else K2): kernel vs
    plain on each scene, the full-width renders, the chunk timing.
    Returns (launches in the renders, max abs error, {scene: kernel ms}
    of the chunk timing)."""
    checks = NEW_SOLID_CHECKS if solid else NEW_RECORD_CHECKS
    W, H, spp = (CHECK_W, CHECK_H, CHECK_SPP) if solid else REC_CHECK
    errs = [kernel_vs_plain(torch, dev, name, W, H, spp, [20261016 + i, 4242, 0])
            for i, name in enumerate(checks)]
    launches = 0
    for name, width, height, spp in (NEW_SOLID_RENDERS if solid else NEW_RECORD_RENDERS):
        launches += render_path(torch, dev, name, width, height, spp)
        torch.cuda.empty_cache()
    name, width, height, spp = (NEW_SOLID_RENDERS if solid else NEW_RECORD_RENDERS)[0]
    err, ms, _ = chunk_timing(torch, dev, name, width, height, spp)
    errs.append(err)
    torch.cuda.empty_cache()
    return launches, max(errs), {name: ms}


def replay_scale(sc, spp):
    """(texture atlas entries, (bounce, ray) elements of one record chunk)
    of scene sc rendered at spp: the scale of its replay's gathers."""
    from raytracer_tpu_torch.core.scene import plan_chunks

    _, tables, settings = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    fan = 1 << settings.split_k
    chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, W, H, fan)
    return tables.atlas.numel(), settings.max_bounces * chunk * W * H


def probe_phases(torch, times):
    """The Hopper probes, P1 first (its slot costs feed the bounds of the
    others), each run once with its launch counts set to 0 (inside its
    run) and printed as one line; then P2 with the render kernels' chunk
    times of this run.  Returns (kernels-line rows, P2's result)."""
    import torch_textured
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.probes import (dead_bounce, gather, isect_cost,
                                            issue_peak, roofline, tri_sweep)
    from torch_cornellbox import build_cornell

    def show(out, rows):
        keep = {k: v for k, v in out.items() if k not in ("sass", "events")}
        print(f"probe {out['probe']}: {json.dumps(keep, default=float)}", flush=True)
        for r in rows:
            require(r["launches"] > 0, f"probe kernel {r['name']} never launched")
        return rows

    p1, rows = issue_peak.run()
    rows = show(p1, rows)
    print(f"probe issue_peak SASS (static opcode counts per kernel): "
          f"{json.dumps(p1['sass'])}", flush=True)
    costs = p1["slot_costs"]
    out, r = dead_bounce.run(sin_slots=costs["sin"], sqrt_slots=costs["sqrt"])
    rows += show(out, r)
    out, r = tri_sweep.run(div_slots=costs["div"])
    rows += show(out, r)
    for name in ("thread", "warp"):
        res = out[f"p3_{name}"]
        shapes = (f"{size} {res[size]['rays']} x {res[size]['triangles']}: "
                  f"{res[size]['launches_per_call']} launches a call, "
                  f"{res[size]['ms']:.4f} ms, {res[size]['gtri_tests_per_s']:.1f} G tests/s, "
                  f"{100 * res[size]['share']:.1f}% of its bound {res[size]['bound_ms']:.4f} ms"
                  for size in ("script", "filled"))
        print(f"probe P3 tri_{name}: {' | '.join(shapes)} | edge input "
              f"{res['edge']['rays']} x {res['edge']['triangles']} bit-equal at plan "
              f"{res['edge']['plan']}", flush=True)
    builders = {"cornell": build_cornell, "example2": torch_textured.example2}
    scenes = {name: (builders[name](w, h) if name in builders else new_scene(name, w, h),
                     spp) for name, w, h, spp in roofline.SCENES}
    p6, r = gather.run(costs, replay_scale=replay_scale(*scenes["example2"]))
    rows += show(p6, r)
    for shape, res in (("script", p6), ("replay", p6["replay_scale"])):
        for mode in gather.MODES:
            m = res[mode]
            require(m["launches"] > 0, f"P6 {mode} at the {shape} shape never launched")
            take = (f"torch.take {m['library_ms']:.5f} ms" if m["library_ms"] is not None
                    else "no library call")
            print(f"probe P6 {mode}, {shape} shape: {res['rays']} rays, T {m['T']} | "
                  f"kernel {m['ms']:.5f} ms (graph), wrapper {m['wrapper_ms']:.5f} ms | "
                  f"{m['launches']} launches | {m['ns_per_fetch']:.5f} ns a fetch, "
                  f"{m['g_fetch_per_s']:.1f} G fetches/s | {100 * m['share']:.1f}% of its "
                  f"bound {m['bound_ms']:.5f} ms ({m['bound_by']}, "
                  f"{m['slots_per_fetch']:.2f} slots a fetch) | {take} | bit-equal",
                  flush=True)
    check = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch.probes.gather",
                            "--profile"], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    require(check.returncode == 0, f"P6 profile check: {check.stderr[-2000:]}")
    plan, prof = p6["plan"], json.loads(check.stdout.strip().splitlines()[-1])
    ptxas = [ln for ln in build_lines(cuda_build.build_log) if ln.startswith("gather_")]
    print(f"probe P6 plan: cluster {plan['cluster']}, resident blocks ldg / smem / base "
          f"{plan['ldg_blocks']} / {plan['smem_blocks']} / {plan['base_blocks']}, smem cut "
          f"{plan['smem_entries']} entries | ptxas: {' | '.join(ptxas)} | edge input "
          f"{p6['edge']['rays']} rays bit-equal at {p6['edge']['held']} (mode, T) pairs | "
          f"profiler (a process of its own): gather_base_kernel {prof['kernel_ms']} ms "
          f"a launch over {prof['kernels']} kernel events of {prof['calls']} calls, "
          f"graph {prof['graph_ms']:.5f} ms", flush=True)
    require(prof["kernels"] == prof["calls"],
            f"P6 profiler: {prof['kernels']} base kernel events of {prof['calls']} calls")
    require(abs(prof["kernel_ms"] - prof["graph_ms"])
            <= gather.PROFILER_TOLERANCE * prof["graph_ms"],
            f"P6 profiler: base {prof['kernel_ms']} ms a launch against the graph's "
            f"{prof['graph_ms']} ms, past {gather.PROFILER_TOLERANCE:.0%}")
    rate = p1["unfused_peak_lane_ops_per_s"]
    tests, r = isect_cost.run(costs, rate)
    rows += show(tests, r)
    W1["tri_slots"] = tests["measured_slots_per_test"]["tri"]
    print(f"probe isect_cost SASS: {json.dumps(tests['sass'])}", flush=True)
    p2, r = roofline.run(costs, rate, scenes, p6["ldg"]["ns_per_fetch"],
                         kernel_ms=times,
                         test_slots=tests["measured_slots_per_test"])
    rows += show(p2, r)
    return rows, p2


def hdr_scene(path):
    """A glossy sphere in front of the .hdr panorama at `path`, lit by a
    directional light: the record kernel's path."""
    import raytracer_tpu_torch as T

    sc = T.Scene(ambient_color=T.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=T.vec3(0, 0.3, 2.2), look_at=T.vec3(0, 0, 0),
                  screen_width=HDR_W, screen_height=HDR_H, field_of_view=50)
    sc.add_DirectionalLight(Ldir=T.vec3(0.4, 0.7, 0.5), color=T.rgb(0.5, 0.5, 0.5))
    sc.add(T.Sphere(material=T.Glossy(diff_color=T.rgb(0.8, 0.7, 0.6),
                                      n=T.vec3(1.5, 1.5, 1.5), roughness=0.1,
                                      spec_coeff=0.4, diff_coeff=0.6),
                    center=T.vec3(0, 0, 0), radius=0.7, max_ray_depth=3))
    sc.add(T.Panorama(str(path)))
    return sc


def hold_chunk(torch, name, solid, args):
    """A chunk's kernel launch held against its plain version on the same
    arguments (those Scene.render gave the kernel), bit for bit, with
    rays_traced identical; prints one line, returns the max abs error."""
    max_err, line = (solid_check if solid else record_check)(torch, name, args)
    W, H, spp = args[-7:-4]
    print(f"slice {'solid' if solid else 'record'} kernel vs plain, {name}: "
          f"{spp} spp x {W}x{H} = {spp * W * H} rays (seed "
          f"{args[0].tolist()}) | {line}", flush=True)
    torch.cuda.empty_cache()
    return max_err


def slice_phases(torch, dev, cornell_img):
    """Scene.render's options, render_environment, .hdr files and JSON
    scenes on the card, one line each; each check is driven with both
    launch counts set to 0 just before it and read just after, and the
    first chunk each kernel ran in it is then held against its plain
    version at that shape and seed.  cornell_img is the main path's
    uninterrupted 256-spp Cornell render (seed 0).  Returns the launches
    of (solid kernel, record kernel) in these runs and the max abs error
    of each kernel's held chunks."""
    import numpy as np
    import torch_textured
    from PIL import Image
    from raytracer_tpu_torch import load_scene_file, save_hdr
    from raytracer_tpu_torch.core import scene as tscene
    from raytracer_tpu_torch.core.camera import projection_mask
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st
    from raytracer_tpu_torch.parallel import sharded as tsharded
    from torch_cornellbox import build_cornell

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    totals = [0, 0]
    errs = [[0.0], [0.0]]
    wrappers = ("solid_trace_chunk", "record_trace_chunk")

    def driven(name, fn):
        """fn() with both launch counts set to 0 just before; the counts
        are read just after, then the first chunk of each kernel (its
        arguments as Scene.render passed them) is held against the plain
        version.  Returns fn's result, the (solid, record) launches and
        the wall seconds."""
        real = {w: getattr(tsharded, w) for w in wrappers}
        first = {}

        def spy(w):
            def call(*args):
                first.setdefault(w, args)
                return real[w](*args)
            return call

        for w in wrappers:
            setattr(tsharded, w, spy(w))
        try:
            st.solid_trace_chunk.launches = 0
            rt.record_trace_chunk.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = (st.solid_trace_chunk.launches, rt.record_trace_chunk.launches)
        finally:
            for w in wrappers:
                setattr(tsharded, w, real[w])
        totals[0] += n[0]
        totals[1] += n[1]
        for i, w in enumerate(wrappers):
            if w in first:
                errs[i].append(hold_chunk(torch, f"{name}, first chunk",
                                          i == 0, first[w]))
        return out, n, wall

    def finite(a, name):
        require(bool(np.isfinite(a).all()), f"{name}: non-finite values")

    t_phase = time.perf_counter()
    # ---- resume: 128 spp with checkpoints, then 256 spp from them ----
    sc = build_cornell(W, H)
    fan = sc._diffuse_fan()
    chunk, n_half = plan_chunks(RESUME_SPP * fan, W, H)
    _, n_full = plan_chunks(SPP * fan, W, H)
    ck = WORK / "cornell_resume.npz"
    (_, st1), n1, wall1 = driven("resume 128 spp", lambda: sc.render(
        RESUME_SPP, output="linear", checkpoint_path=ck,
        checkpoint_every=RESUME_EVERY, return_stats=True, device=dev))
    require(n1 == (n_half, 0), f"resume: first render launches {n1}")
    done = int(np.load(ck)["chunks_done"])
    require(done == n_half, f"resume: checkpoint at chunk {done}, not {n_half}")
    (img, st2), n2, wall2 = driven("resume 256 spp", lambda: sc.render(
        SPP, output="linear", checkpoint_path=ck, checkpoint_every=RESUME_EVERY,
        return_stats=True, device=dev))
    require(n2 == (n_full - done, 0), f"resume: resumed render launches {n2}")
    same = bool(np.array_equal(img, cornell_img))
    print(f"slice resume: Cornell {W}x{H}, {RESUME_SPP} spp ({n_half} chunks of "
          f"{chunk} spp, a checkpoint every {RESUME_EVERY}) in {wall1:.4f} s, then "
          f"{SPP} spp resumed from chunk {done} to {n_full} ({n2[0]} solid kernel "
          f"launches, {st2['samples']} samples) in {wall2:.4f} s | bit-equal to the "
          f"uninterrupted {SPP}-spp render: {same}", flush=True)
    require(same, "resume: the resumed image differs from the uninterrupted one")

    # ---- adaptive: Cornell to a noise target within a 256-spp budget:
    # one target out of reach (the budget spent), one met early; the last
    # noise estimate of the second is recomputed on the CPU ----
    checks = []
    real_noise = tscene._noise_q99

    def noise_spy(acc, acc2, k, chunk_, pmask=None):
        out = real_noise(acc, acc2, k, chunk_, pmask)
        checks.append((acc.clone(), acc2.clone(), k, chunk_, out))
        return out

    tscene._noise_q99 = noise_spy
    try:
        for target in (TARGET_NOISE, REACH_NOISE):
            checks.clear()
            (img, stats), n, wall = driven(
                f"adaptive target {target}", lambda: build_cornell(W, H).render(
                    SPP, output="linear", target_noise=target,
                    return_stats=True, device=dev))
            finite(img, "adaptive")
            q99 = stats["noise_q99"]
            spent = stats["samples"] == n_full * chunk
            print(f"slice adaptive: Cornell {W}x{H}, target_noise {target}, "
                  f"budget {SPP} spp ({n_full * chunk} samples) | "
                  f"{stats['samples']} samples in {n[0]} chunks, {len(checks)} "
                  f"noise checks, noise_q99 {q99:.6f}, budget spent: {spent} | "
                  f"wall {wall:.4f} s", flush=True)
            require(n == (stats["samples"] // chunk, 0), f"adaptive: launches {n}")
            require(np.isfinite(q99) and q99 == float(checks[-1][-1]),
                    f"adaptive: noise_q99 {q99}, last check {checks[-1][-1]}")
            if target == TARGET_NOISE:
                require(q99 <= target or spent,
                        "adaptive: neither the target met nor the budget spent")
            else:
                require(q99 <= target and not spent,
                        f"adaptive: target {target} not met before the budget")
    finally:
        tscene._noise_q99 = real_noise
    # the card's noise estimate against the CPU's on the same moments,
    # over the whole frame and over a fisheye circle's pixels
    acc, acc2, k, chunk_, _ = checks[-1]
    mask = torch.from_numpy(projection_mask("fisheye", W, H))
    diffs = []
    for pmask in (None, mask):
        card = float(real_noise(acc, acc2, k, chunk_,
                                None if pmask is None else pmask.to(dev)))
        cpu = float(real_noise(acc.cpu(), acc2.cpu(), k, chunk_, pmask))
        diffs.append(abs(card - cpu))
        require(np.isfinite(card) and diffs[-1] <= NOISE_ATOL,
                f"adaptive: card noise_q99 {card} vs CPU {cpu}")
    print(f"slice adaptive noise estimate: card against CPU after {int(k)} "
          f"chunks, |diff| {diffs[0]:.3e} (frame), {diffs[1]:.3e} (fisheye "
          f"circle; tolerance {NOISE_ATOL})", flush=True)

    # ---- variance: example 2 through the record kernel ----
    ex2 = torch_textured.example2(REC_W, REC_H)
    (lin, var), n, wall = driven("variance", lambda: ex2.render(
        REC_SPP, output="linear", with_variance=True, device=dev))
    plain = ex2.render(REC_SPP, output="linear", device=dev)
    finite(var, "variance")
    same = bool(np.array_equal(lin, plain))
    print(f"slice variance: example 2 {REC_W}x{REC_H} x {REC_SPP} spp with "
          f"with_variance, {n[1]} record kernel launches | wall {wall:.4f} s | "
          f"variance mean {float(var.mean()):.6e}, max {float(var.max()):.6e}, min "
          f"{float(var.min()):.3e} | image bit-equal to the render without: {same}",
          flush=True)
    require(n[1] > 0 and n[0] == 0, f"variance: launches {n}")
    require(bool((var >= 0).all()), "variance: negative values")
    require(same, "variance: with_variance changed the image")

    # ---- the environment bake, saved as .hdr, behind a glossy sphere ----
    center = (278.0, 278.0, -278.0)
    env, n, wall_env = driven("environment", lambda: build_cornell(
        W, H).render_environment(width=ENV_W, height=ENV_H,
                                 samples_per_pixel=ENV_SPP, center=center,
                                 device=dev))
    require(env.shape == (ENV_H, ENV_W, 3), f"environment shape {env.shape}")
    finite(env, "environment")
    require(n[0] > 0 and n[1] == 0, f"environment: launches {n}")
    hdr = WORK / "cornell_env.hdr"
    save_hdr(env, hdr)
    sc_hdr = hdr_scene(hdr)
    static = sc_hdr._settings_for_render()[0]
    require(static.pallas_tex_ok and not static.pallas_ok,
            "the .hdr scene does not take the record kernel")
    (img, stats), n_hdr, wall_hdr = driven(".hdr panorama", lambda: sc_hdr.render(
        HDR_SPP, output="linear", return_stats=True, device=dev))
    finite(img, ".hdr scene")
    print(f"slice environment: Cornell render_environment {ENV_W}x{ENV_H} x "
          f"{ENV_SPP} spp from {center}, {n[0]} solid kernel launches, wall "
          f"{wall_env:.4f} s, mean {float(env.mean()):.6f}, max {float(env.max()):.4f} "
          f"| save_hdr {hdr.stat().st_size} B | Panorama(.hdr) behind a glossy "
          f"sphere {HDR_W}x{HDR_H} x {HDR_SPP} spp, {n_hdr[1]} record kernel "
          f"launches, wall {wall_hdr:.4f} s, image mean {float(img.mean()):.6f}",
          flush=True)
    require(n_hdr[1] > 0 and n_hdr[0] == 0, f".hdr scene: launches {n_hdr}")
    require(float(img.mean()) > 0.0, ".hdr scene: black image")

    # ---- the JSON scene at its own size ----
    sc_json = load_scene_file(ROOT / "examples" / "example_scene.json")
    jw, jh = sc_json.camera.screen_width, sc_json.camera.screen_height
    static, _, settings = sc_json._settings_for_render()
    require(static.pallas_ok and (jw, jh) == (400, 300),
            "example_scene.json: not the solid kernel at 400x300")
    _, n_json_chunks = plan_chunks(JSON_SPP * sc_json._diffuse_fan()
                                   * (1 << settings.split_k), jw, jh)
    (img, stats), n, wall = driven("JSON scene", lambda: sc_json.render(
        JSON_SPP, output="linear", return_stats=True, device=dev))
    finite(img, "example_scene.json")
    print(f"slice JSON scene: examples/example_scene.json {jw}x{jh} x {JSON_SPP} "
          f"spp (x{sc_json._diffuse_fan()} fan), {n[0]} solid kernel launches | "
          f"wall {wall:.4f} s | rays_traced {stats['rays_traced']} | image mean "
          f"{float(img.mean()):.6f}", flush=True)
    require(n == (n_json_chunks, 0), f"JSON scene: launches {n}")
    require(float(img.mean()) > 0.0, "JSON scene: black image")

    # ---- a preview, and a profiled render ----
    pv = WORK / "preview.png"
    img, n, wall = driven("preview", lambda: build_cornell(W, H).render(
        PREVIEW_SPP, preview_path=pv, preview_every=4, device=dev))
    same = bool(np.array_equal(np.asarray(Image.open(pv)), np.asarray(img)))
    prof = WORK / "profile"
    _, n_prof, wall_prof = driven("profile", lambda: build_cornell(W, H).render(
        PROFILE_SPP, output="linear", profile_dir=prof, device=dev))
    traces = list(prof.glob("*.pt.trace.json"))
    require(len(traces) == 1, f"profile: {len(traces)} traces")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = [e for e in kernels if "solid_trace" in str(e.get("name", ""))]
    print(f"slice preview and profile: Cornell {W}x{H} x {PREVIEW_SPP} spp, "
          f"{n[0]} solid kernel launches, wall {wall:.4f} s, final preview "
          f"{pv.stat().st_size} B bit-equal to the returned image: {same} | profiled {PROFILE_SPP} spp, {n_prof[0]} "
          f"launches, wall {wall_prof:.4f} s: {len(kernels)} kernel events, "
          f"{len(named)} named {named[0]['name'] if named else None!r}", flush=True)
    require(n[0] > 0 and n_prof[0] > 0, f"preview / profile: launches {n}, {n_prof}")
    require(same, "preview: the final preview is not the returned image")
    require(len(named) == n_prof[0],
            f"profile: {len(named)} solid_trace events for {n_prof[0]} launches")
    print(f"slice phases: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return tuple(totals), (max(errs[0]), max(errs[1]))


def emissive_scene(width, height):
    """An emissive rotated box on an emissive plane: nothing is drawn past
    the camera's jitter, so both routes give the same pixels."""
    import raytracer_tpu_torch as T

    sc = T.Scene()
    sc.add_Camera(look_from=T.vec3(0.3, 0.2, 3), look_at=T.vec3(0, 0, -1),
                  screen_width=width, screen_height=height)
    cb = T.Cuboid(material=T.Emissive(color=T.rgb(0.9, 0.4, 0.1)),
                  center=T.vec3(0, 0, 0), width=1, height=2, length=1)
    cb.rotate(θ=30, u=T.vec3(0, 1, 0))
    sc.add(cb)
    sc.add(T.Plane(material=T.Emissive(color=T.rgb(0.1, 0.2, 0.9)),
                   center=T.vec3(0, -1, 0), width=50.0, height=50.0,
                   u_axis=T.vec3(1, 0, 0), v_axis=T.vec3(0, 0, -1)))
    return sc


def timed_render(torch, dev, sc, spp, **kw):
    """(linear image, stats, wall s) of one Scene.render on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, stats = sc.render(samples_per_pixel=spp, output="linear",
                           return_stats=True, device=dev, **kw)
    torch.cuda.synchronize()
    return img, stats, time.perf_counter() - t0


def region_samples(torch, L, chunk, width, height):
    """(chunk, REGIONS**2 + 1) float64: each sample's mean over each
    region of the frame, then over the frame."""
    L = L.view(chunk, height, width, 3)
    ys = [round(i * height / REGIONS) for i in range(REGIONS + 1)]
    xs = [round(i * width / REGIONS) for i in range(REGIONS + 1)]
    cols = [L[:, ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean(dim=(1, 2, 3))
            for i in range(REGIONS) for j in range(REGIONS)]
    return torch.stack(cols + [L.mean(dim=(1, 2, 3))], dim=1).double()


def image_regions(img, width, height):
    import numpy as np
    ys = [round(i * height / REGIONS) for i in range(REGIONS + 1)]
    xs = [round(i * width / REGIONS) for i in range(REGIONS + 1)]
    return np.array([img[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean()
                     for i in range(REGIONS) for j in range(REGIONS)]
                    + [img.mean()], np.float64)


def divided_unit(d):
    """camera.unit as the JAX wavefront scales its camera rays: each
    direction divided by its norm."""
    import torch
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))


def stage_profile(torch, dev, name, sc, spp):
    """One render of `sc` on the wavefront under torch.profiler: its wall,
    device span, busy share and the device time of each bounce stage
    (core/integrator.py's "wavefront.*" ranges), printed as one line; on a
    scene with triangle clusters also the clustered sweep's (its own range
    inside nearest_hit and the glossy block's shadow rays): its device
    time and share, its syncs (one a sweep, required: W2's) and device
    events a bounce, the (cluster, ray) pairs it swept and its rate in
    triangle tests a second, over the range and over W1's kernels alone
    (their device time and launches by name), and W2's kernels' device
    time.  Returns the sweep's numbers (empty without clusters)."""
    from torch.profiler import ProfilerActivity, profile
    from torch_render_profile import device_breakdown, wavefront_stages
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import mesh_pairs, mesh_sweep

    static, _, settings = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    fan = 1 << settings.split_k
    _, n_chunks = plan_chunks(spp * sc._diffuse_fan() * fan, W, H, fan)
    bounces = n_chunks * settings.max_bounces
    before = dict(intersect.SWEEP_STATS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.render(samples_per_pixel=spp, output="linear", device=dev, seed=11)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / f"wavefront_profile_{name.split()[0].lower()}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    span, busy, per_name = device_breakdown(events)
    stages, counts = wavefront_stages(events)
    require(stages.get("nearest_hit", 0) > 0, f"{name}: no wavefront stage "
            "on the device in the profile")
    sweep_us = stages.pop("clustered_sweep", 0.0)
    sweep_events = counts.pop("clustered_sweep", 0)
    parts = ", ".join(f"{k} {t / 1e3:.1f} ms ({100 * t / busy:.1f}%)" for k, t in
                      sorted(stages.items(), key=lambda kv: -kv[1]))
    sweep = {}
    line = ""
    w1_us = sum(t for k, (t, _) in per_name.items()
                if any(w in k for w in mesh_sweep.KERNELS))
    w1_events = sum(c for k, (_, c) in per_name.items()
                    if any(w in k for w in mesh_sweep.KERNELS))
    w2_us = sum(t for k, (t, _) in per_name.items()
                if any(w in k for w in mesh_pairs.KERNELS))
    if w1_us:
        line = (f" | W1 kernels {w1_us / 1e3:.2f} ms ({100 * w1_us / busy:.1f}% "
                f"of busy, {w1_events} launches)")
    if w2_us:
        line += (f" | W2 kernels {w2_us / 1e3:.2f} ms ({100 * w2_us / busy:.1f}% "
                 f"of busy)")
    if sweep_us:
        d = {k: intersect.SWEEP_STATS[k] - before[k] for k in before}
        require(d["syncs"] == d["sweeps"] > 0, f"{name}: {d['syncs']} host syncs "
                f"in {d['sweeps']} clustered sweeps (W2 makes one a sweep)")
        sweep = dict(ms=sweep_us / 1e3, share=sweep_us / busy,
                     w1_ms=w1_us / 1e3, w1_share=w1_us / busy,
                     w2_ms=w2_us / 1e3,
                     syncs_per_bounce=d["syncs"] / bounces,
                     events_per_bounce=sweep_events / bounces,
                     sweeps_per_bounce=d["sweeps"] / bounces,
                     pairs=d["pairs"], clusters_run=d["clusters"],
                     tests_per_s=d["pairs"] * intersect.TRI_CLUSTER_SIZE
                     / (sweep_us / 1e6))
        line += (f" | clustered sweep (inside nearest_hit and the shadow rays): "
                f"{sweep['ms']:.1f} ms ({100 * sweep['share']:.1f}% of busy), "
                f"{sweep['sweeps_per_bounce']:.1f} sweeps, "
                f"{sweep['syncs_per_bounce']:.1f} host syncs and "
                f"{sweep['events_per_bounce']:.0f} device events a bounce "
                f"({bounces} bounces), {d['clusters']} cluster runs, "
                f"{d['pairs']} (cluster, ray) pairs, "
                f"{sweep['tests_per_s'] / 1e9:.2f} G triangle tests/s over the "
                f"range, {d['pairs'] * intersect.TRI_CLUSTER_SIZE / max(w1_us, 1e-9) / 1e3:.1f}"
                f" over W1's kernels")
    print(f"wavefront profile: {name}, one render under torch.profiler | wall "
          f"{wall:.4f} s, device span {span / 1e6:.4f} s, busy {busy / 1e6:.4f} s "
          f"({100 * busy / span:.1f}% of span), "
          f"{sum(c for _, c in per_name.values())} device events | by stage "
          f"(share of busy): {parts}{line}", flush=True)
    return sweep


def wavefront_phase(torch, dev):
    """The wavefront (core/integrator.py, plain torch on the card around
    W3, its analytic sweep): the 98-object grid through Scene.render,
    three times bit-equal, W3 launched and K1 / K2 not; the 48-object
    grid and Cornell through both routes, held by image and region means;
    an emissive scene pixel for pixel across the routes; the depth AOV on
    the card against the CPU.  Returns the solid kernel's launches in the
    kernel-route renders."""
    import numpy as np
    import raytracer_tpu_torch as T
    import torch_wavefront
    from raytracer_tpu_torch.core import camera
    from raytracer_tpu_torch.core import scene as scene_mod
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import chunk_seeds, plan_chunks, route
    from raytracer_tpu_torch.ops import analytic_sweep
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st
    from torch_cornellbox import build_cornell

    t_phase = time.perf_counter()
    # ---- past the gate: the 98-object grid, twice with one seed ----
    sc = torch_wavefront.grid(GRID_PAST, GRID_W, GRID_H)
    static, _, settings = sc._settings_for_render()
    require(static.n_objects == GRID_PAST + 2 and
            route(static, settings) == "wavefront", "the grid does not take "
            "the wavefront")
    devices = []
    trace = scene_mod.trace

    def traced(*args, **kw):
        devices.append(args[1].device.type)
        return trace(*args, **kw)

    scene_mod.trace = traced
    st.solid_trace_chunk.launches = rt.record_trace_chunk.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    analytic_sweep.reset_launches()
    try:
        runs = [timed_render(torch, dev, sc, WAVE_SPP, seed=7) for _ in range(3)]
    finally:
        scene_mod.trace = trace
    w3 = w3_launches(analytic_sweep)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    k_launches = st.solid_trace_chunk.launches + rt.record_trace_chunk.launches
    chunk, n_chunks = plan_chunks(WAVE_SPP * sc._diffuse_fan(), GRID_W, GRID_H)
    img, stats, _ = runs[1]
    walls = [w for _, _, w in runs]
    wall = statistics.median(walls[1:])
    bit_equal = all(np.array_equal(r[0], runs[0][0]) for r in runs[1:])
    print(f"wavefront past the gate: Scene.render grid of {GRID_PAST} spheres "
          f"({static.n_objects} objects) {GRID_W}x{GRID_H} x {WAVE_SPP} spp, "
          f"{n_chunks} chunks of {chunk} spp, {settings.max_bounces} bounces, "
          f"{len(devices)} wavefront chunks on {sorted(set(devices))}, K1 / K2 "
          f"launches {k_launches}, W3 launches {w3['analytic_nearest']} nearest, "
          f"{w3['analytic_occluded']} occluded | wall {wall:.4f} s (median of 2; "
          f"{', '.join(f'{w:.4f}' for w in walls)}) | rays_traced "
          f"{stats['rays_traced']} | {stats['rays_traced'] / wall / 1e6:.1f} "
          f"Mrays/s | peak {peak_gib:.2f} GiB | image mean {img.mean():.6f} | "
          f"three renders of seed 7 bit-equal: {bit_equal}", flush=True)
    require(devices == ["cuda"] * (3 * n_chunks),
            f"wavefront chunks ran on {devices}")
    require(k_launches == 0, f"{k_launches} K1 / K2 launches on the wavefront")
    require(w3["analytic_nearest"] > 0, "W3 never launched in the grid renders")
    require(bit_equal, "the same seed gave different images")
    require(img.shape == (GRID_H, GRID_W, 3) and bool(np.isfinite(img).all()),
            "grid image not finite or of the wrong shape")
    stage_profile(torch, dev, f"grid of {GRID_PAST} spheres {GRID_W}x{GRID_H} x "
                  f"{WAVE_SPP} spp", sc, WAVE_SPP)

    # ---- the same grid on the card against the CPU, a smaller frame ----
    sc = torch_wavefront.grid(GRID_PAST, CPU_W, CPU_H)
    static, data = compile_wavefront(sc)
    chunk, n_chunks = plan_chunks(WAVE_SPP * sc._diffuse_fan(), CPU_W, CPU_H)
    L_w, _ = scene_mod.wavefront_chunk(chunk_seeds(99, 1, chunk)[0], static,
                                       data.to(dev), sc.camera.params(),
                                       sc._settings(static), CPU_W, CPU_H, chunk)
    se = torch.sqrt(2 * region_samples(torch, L_w, chunk, CPU_W, CPU_H).var(dim=0)
                    / (chunk * n_chunks)).cpu().numpy()
    del L_w
    card, _, card_wall = timed_render(torch, dev, sc, WAVE_SPP, seed=5)
    t0 = time.perf_counter()
    cpu = sc.render(samples_per_pixel=WAVE_SPP, output="linear", device="cpu",
                    seed=5)
    cpu_wall = time.perf_counter() - t0
    z = (np.abs(image_regions(card, CPU_W, CPU_H) - image_regions(cpu, CPU_W, CPU_H))
         / np.maximum(se, 1e-12))
    print(f"wavefront card vs CPU: grid of {GRID_PAST} spheres {CPU_W}x{CPU_H} x "
          f"{WAVE_SPP} spp, {n_chunks} chunks of {chunk} spp | card {card_wall:.4f}"
          f" s, CPU {cpu_wall:.4f} s ({torch.get_num_threads()} threads) | image "
          f"mean {card.mean():.6f} vs {cpu.mean():.6f}, z {z[-1]:.2f} | "
          f"{REGIONS}x{REGIONS} regions max z {z[:-1].max():.2f}", flush=True)
    require((z < 4).all(), f"grid card vs CPU z {z}")

    # ---- the same estimator as the kernel: both routes, full size ----
    solid_launches = 0
    for name, build, (W, H) in (
            (f"grid of {GRID_INSIDE}", lambda W, H: torch_wavefront.grid(
                GRID_INSIDE, W, H), (GRID_W, GRID_H)),
            ("Cornell", build_cornell, WAVE_CORNELL)):
        sc = build(W, H)
        static, tables, settings = sc._settings_for_render()
        require(route(static, settings) == "solid", f"{name}: not the solid route")
        st.solid_trace_chunk.launches = 0
        k_img, k_stats, k_wall = timed_render(torch, dev, sc, WAVE_SPP, seed=3)
        k_launches = st.solid_trace_chunk.launches
        solid_launches += k_launches
        sc.settings = T.RenderSettings(use_pallas="never")
        _, _, w_settings = sc._settings_for_render()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        w_img, w_stats, w_wall = timed_render(torch, dev, sc, WAVE_SPP, seed=3)
        w_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # on the grid, printed only: the wavefront with its camera rays
        # divided by |D| as the JAX wavefront's are, not scaled as the
        # kernel's; the reference's sphere test assumes |D| = 1, and from
        # afar the last bit of |D| decides some self-hits (ROADMAP.md §3)
        d_img = None
        if name.startswith("grid"):
            unit = camera.unit
            camera.unit = divided_unit
            try:
                d_img, _, _ = timed_render(torch, dev, sc, WAVE_SPP, seed=3)
            finally:
                camera.unit = unit
        require(st.solid_trace_chunk.launches == k_launches,
                f"{name}: the wavefront route launched the solid kernel")
        fan = 1 << settings.split_k
        chunk, n_chunks = plan_chunks(WAVE_SPP * sc._diffuse_fan() * fan, W, H, fan)
        require(k_launches == n_chunks, f"{name}: {k_launches} launches for "
                f"{n_chunks} chunks")
        n_samples = chunk * n_chunks
        # the scatter of one chunk's samples on each route
        row = chunk_seeds(99, 1, chunk)[0]
        L_k, _ = st.solid_trace_chunk(
            torch.from_numpy(row).to(dev), tables.to(dev),
            cam_vec(sc.camera.params()).to(dev), W, H, chunk,
            settings.max_bounces, settings.split_k, settings.sampler,
            settings.projection)
        L_w, _ = scene_mod.wavefront_chunk(row, static,
                                           compile_wavefront(sc)[1].to(dev),
                                           sc.camera.params(), w_settings,
                                           W, H, chunk)
        se = torch.sqrt((region_samples(torch, L_k, chunk, W, H).var(dim=0)
                         + region_samples(torch, L_w, chunk, W, H).var(dim=0))
                        / n_samples).cpu().numpy()
        del L_k, L_w
        k_reg = image_regions(k_img, W, H)
        z = np.abs(k_reg - image_regions(w_img, W, H)) / np.maximum(se, 1e-12)
        divided = ""
        if d_img is not None:
            zd = (np.abs(k_reg - image_regions(d_img, W, H))
                  / np.maximum(se, 1e-12))
            divided = (f" | divided by |D| as in the JAX wavefront: image mean "
                       f"{d_img.mean():.6f}, z {zd[-1]:.2f}, regions max z "
                       f"{zd[:-1].max():.2f} (not held)")
        print(f"wavefront vs solid kernel: {name} {W}x{H} x {WAVE_SPP} spp "
              f"(x{sc._diffuse_fan()} fan), {n_chunks} chunks of {chunk} spp | "
              f"kernel route {k_wall:.4f} s ({k_launches} launches, "
              f"{k_stats['rays_traced'] / k_wall / 1e6:.1f} Mrays/s) | wavefront "
              f"{w_wall:.4f} s ({w_stats['rays_traced'] / w_wall / 1e6:.1f} "
              f"Mrays/s, peak {w_peak:.2f} GiB) | image mean {k_img.mean():.6f} "
              f"vs {w_img.mean():.6f}, z {z[-1]:.2f} | {REGIONS}x{REGIONS} "
              f"regions max z {z[:-1].max():.2f}{divided}", flush=True)
        require((z < 4).all(), f"{name}: wavefront vs kernel z {z}")
        if name == "Cornell":
            stage_profile(torch, dev, f"Cornell {W}x{H} x {WAVE_SPP} spp", sc,
                          WAVE_SPP)

    # ---- deterministic scenes ----
    W, H = GRID_W, GRID_H
    sc = emissive_scene(W, H)
    k_img, _, _ = timed_render(torch, dev, sc, EMISSIVE_SPP, seed=1)
    sc.settings = T.RenderSettings(use_pallas="never")
    w_img, _, _ = timed_render(torch, dev, sc, EMISSIVE_SPP, seed=1)
    equal = float((k_img == w_img).all(axis=-1).mean())
    sc = torch_wavefront.grid(GRID_PAST, W, H)
    d_card = sc.get_distances(seed=2, device=dev, output="linear")
    d_cpu = sc.get_distances(seed=2, device="cpu", output="linear")
    d_err = np.abs(d_card - d_cpu)
    within = float((d_err <= DIST_ATOL).all(axis=-1).mean())
    print(f"wavefront deterministic: emissive box and plane {W}x{H} x "
          f"{EMISSIVE_SPP} spp through both routes, pixel-equal {equal:.6f} | "
          f"Scene.get_distances grid of {GRID_PAST} {W}x{H}, card vs CPU max "
          f"abs {d_err.max():.3e}, within {DIST_ATOL}: {within:.6f} | phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    require(equal >= 0.999, f"emissive pixel-equal share {equal}")
    require(within >= 0.999, f"depth AOV card vs CPU within {DIST_ATOL}: {within}")
    return solid_launches


def w3_nearest(torch, name, geom, O, D):
    """W3's nearest entry against the plain loops on the card, on the rays
    (O, D) of `name`: t and orientation bit-equal and ids equal on every
    ray (a share of exactly 1.0), required.  Returns (text, W3's (t,
    orient, id), the plain loops' ms)."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import analytic_sweep
    from raytracer_tpu_torch.utils.constants import MISS_THRESHOLD

    k, ms_k = sweep_pair(torch, analytic_sweep.analytic_nearest, O, D, geom)
    p, ms_p = sweep_pair(torch, intersect._analytic_nearest, O, D, geom)
    same = ((k[0].view(torch.int32) == p[0].view(torch.int32))
            & (k[1].view(torch.int32) == p[1].view(torch.int32)) & (k[2] == p[2]))
    share = int(same.sum()) / same.numel()          # exact, not a float mean
    hit = p[0] < MISS_THRESHOLD
    err = float((k[0] - p[0])[hit].abs().max()) if bool(hit.any()) else 0.0
    W3["max_abs_err"]["analytic_nearest"] = max(
        W3["max_abs_err"]["analytic_nearest"], err)
    if share < 1.0:
        # the rays that differ and both answers, for a hold on the CPU
        bad = ~same
        WORK.mkdir(parents=True, exist_ok=True)
        path = WORK / f"w3_mismatch_{name.replace(' ', '_')}.pt"
        torch.save({"O": O[bad].cpu(), "D": D[bad].cpu(),
                    "w3": [x[bad].cpu() for x in k],
                    "plain": [x[bad].cpu() for x in p]}, path)
        print(f"W3 {name}: {int(bad.sum())} rays differ, saved to {path}; "
              f"first: O {O[bad][:3].tolist()} D {D[bad][:3].tolist()} W3 "
              f"{[x[bad][:3].tolist() for x in k]} plain "
              f"{[x[bad][:3].tolist() for x in p]}", flush=True)
    require(share == 1.0, f"W3 {name}: bit-equal share {share}")
    return (f"{name}: {O.shape[0]} rays ({float(hit.float().mean()):.4f} hit), "
            f"bit-equal {share}, wrapper {ms_k:.2f} ms, plain {ms_p:.1f} ms",
            k, ms_p)


def w3_occluded(torch, name, geom, O, L, shadow, md):
    """W3's occluded entry against the plain loops on the card: equal on
    every ray, required.  Returns (text, the plain loops' ms, the rays the
    plain loops call occluded)."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import analytic_sweep

    k, ms_k = sweep_pair(torch, analytic_sweep.analytic_occluded, O, L, geom,
                         shadow, md)
    p, ms_p = sweep_pair(torch, intersect._analytic_occluded, O, L, geom,
                         shadow, md)
    share = int((k == p).sum()) / k.numel()
    occluded = int(p.sum())
    W3["max_abs_err"]["analytic_occluded"] = max(
        W3["max_abs_err"]["analytic_occluded"], float(share < 1.0))
    require(share == 1.0, f"W3 {name}: occluded equal on {share}")
    return (f"{name}: {O.shape[0]} rays ({occluded} occluded), equal {share}, "
            f"wrapper {ms_k:.2f} ms, plain {ms_p:.1f} ms"), ms_p, occluded


def w3_time(torch, key, name, fn, kind_tests, n_bytes, plain_ms):
    """W3's entry `key` alone on one held input: fn, its launch on that
    input, through a CUDA graph (`graph_ms`) and with events around the
    calls; its tests of each kind (what this input needs) and bytes.
    Returns (text, the numbers)."""
    from raytracer_tpu_torch.ops import analytic_sweep
    from raytracer_tpu_torch.probes import common

    wrapper = getattr(analytic_sweep, key)
    before = wrapper.launches
    fn()
    per_call = wrapper.launches - before
    ms = common.graph_ms(fn, W3_REPS)[0]
    ev_ms = common.cuda_ms(fn, W3_REPS)
    tests = sum(kind_tests)
    timed = dict(key=key, name=name, ms=ms, event_ms=ev_ms, plain_ms=plain_ms,
                 launches_per_call=per_call, kind_tests=kind_tests,
                 tests=tests, bytes=n_bytes,
                 gtests_per_s=tests / (ms * 1e-3) / 1e9)
    W3["timed"].append(timed)
    return (f" | W3 alone (CUDA graph) {ms:.4f} ms a call of {per_call} "
            f"launch (events {ev_ms:.4f} ms), {tests} tests "
            f"({', '.join(f'{k} {n}' for k, n in zip(W3_KINDS, kind_tests) if n)}), "
            f"{timed['gtests_per_s']:.1f} G tests/s")


def mirror_bounce(torch, geom, static, O, D, t, orient, obj):
    """The first bounce of the rays that hit: mirror continuations off
    the hit points' shading normals, nudged off the surface."""
    from raytracer_tpu_torch.geometry.attrs import hit_attributes
    from raytracer_tpu_torch.utils.constants import MISS_THRESHOLD

    hit = t < MISS_THRESHOLD
    P = (O + D * t[:, None])[hit]
    N = hit_attributes(P, obj[hit], geom, static)[0] * orient[hit][:, None]
    eps = 1e-6 * torch.clamp_min(P.abs().amax(dim=-1), 1.0)
    D2 = D[hit] - 2.0 * (D[hit] * N).sum(-1, keepdim=True) * N
    return (P + N * eps[:, None]).contiguous(), D2.contiguous()


def occluded_tests(torch, geom, O, L, shadow, md):
    """Tests of each kind that the occluded answer needs on these rays: each
    ray tests the casting objects (mask bit set) in id order up to its first
    occluder, all of them without one; an object that casts no shadow is
    never tested."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import analytic_sweep

    counts = analytic_sweep.kind_counts(geom)
    cast = shadow[:sum(counts)]
    kind = torch.repeat_interleave(torch.arange(len(counts), device=O.device),
                                   torch.tensor(counts, device=O.device))[cast]
    occ = torch.cat([(fn(O, L, *tabs)[0] < md[None, :]) for fn, tabs, _ in
                     intersect._type_blocks(geom, skip_tris=True)])[cast]
    first = torch.where(occ.any(0), occ.to(torch.int8).argmax(0),
                        occ.shape[0] - 1)
    # a ray tests the casting objects at list positions <= its first
    return [int((torch.nonzero(kind == k).flatten()[:, None] <= first[None, :])
                .sum()) for k in range(len(counts))]


def occluded_bytes(geom, O, L, shadow, md):
    """Bytes the occluded answer must move on these rays: each origin read
    once and each answer written once; a direction and max_dist read once
    a ray, or once where the caller passes one row for every ray (stride
    0); the object table and the mask."""
    from raytracer_tpu_torch.ops import analytic_sweep

    n, n_obj = O.shape[0], sum(analytic_sweep.kind_counts(geom))
    rows = lambda x: 1 if x.stride(0) == 0 else n
    return (n * 12 + n + rows(L) * 12 + rows(md) * 4
            + n_obj * analytic_sweep.ROW * 4 + n_obj)


def held_shadow_rays(torch, dev, name, uniform):
    """One of W3's held occluded inputs, (geom, O, L, shadow mask,
    max_dist), shadow rays toward the scene's directional light from hits
    nudged off the surface: "primitives", the primitives example's from
    the first bounce of its camera rays at the grid's chunk (0.64 M rays,
    about a third occluded); "icosphere", examples/torch_mesh.py's from its
    camera rays at the render's chunk (400x300 x 16 spp: 1.92 M rays, all
    of which hit, the sky sphere at worst; no analytic object occludes
    them: the light is above the floor plane, and the sky sphere casts no
    shadow).  uniform: L and max_dist the expand of one row (stride 0),
    as materials/shade.py passes a directional light's; else one a ray
    (contiguous)."""
    import raytracer_tpu_torch as T
    import torch_mesh
    import torch_primitives
    from raytracer_tpu_torch.core.camera import generate_rays
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.utils.constants import SKYBOX_DISTANCE

    if name == "primitives":
        sc, spp, seed = torch_primitives.primitives(PRIM_W, PRIM_H), WAVE_SPP, 5
    else:
        obj_dir = WORK / "mesh"
        obj_dir.mkdir(parents=True, exist_ok=True)
        sc = torch_mesh.icosphere(MESH_W, MESH_H, obj_dir=obj_dir)
        spp, seed = MESH_SPP, 3
    sc.settings = T.RenderSettings(use_pallas="never")
    static, data = compile_wavefront(sc)
    data = data.to(dev)
    geom = data.geom
    W, H = sc.camera.screen_width, sc.camera.screen_height
    chunk_spp = plan_chunks(spp * sc._diffuse_fan(), W, H)[0]
    O, D = generate_rays(torch.Generator(device=dev).manual_seed(seed),
                         sc.camera.params(), W, H, chunk_spp)
    for _ in range(2 if name == "primitives" else 1):
        O, D = mirror_bounce(torch, geom, static, O, D,
                             *intersect.nearest_hit(O, D, geom))
    n = O.shape[0]
    L = data.lights.dir_l[0].expand(n, 3)
    md = torch.full((1,), SKYBOX_DISTANCE, device=dev).expand(n)
    if not uniform:
        L, md = L.contiguous(), md.contiguous()
    return geom, O, L, data.obj.shadow, md


def w3_events():
    """Prints, as one JSON line, the device events torch.profiler records
    a call of W3's occluded wrapper on the icosphere's held shadow rays (L
    and max_dist one row) and the wrapper's launches a call; run in a
    process of its own (`python3 -c "import chip_smoke;
    chip_smoke.w3_events()"` from the checkout's root), as a profile taken
    after large ones can lose events."""
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "examples"), str(ROOT / "scripts")]
    from raytracer_tpu_torch.ops import analytic_sweep
    from torch_render_profile import device_events

    geom, O, L, shadow, md = held_shadow_rays(torch, torch.device("cuda:0"),
                                              "icosphere", True)
    fn = lambda: analytic_sweep.analytic_occluded(O, L, geom, shadow, md)
    fn()
    before = analytic_sweep.analytic_occluded.launches
    fn()
    launches = analytic_sweep.analytic_occluded.launches - before
    print(json.dumps({"launches_a_call": launches,
                      **device_events(torch, fn, W3_EVENT_CALLS)}))


def w3_phase(torch, dev):
    """W3, the analytic sweep, against its plain loops on the card (both
    entries bit for bit, a share of exactly 1.0): the 98-object grid's
    camera rays at the render's chunk and their first bounce; the
    primitives example (planes, discs, cylinders) through the wavefront:
    camera rays and first bounce; Cornell (planes, a box, a sphere):
    camera rays and first bounce; the occluded entry at its held inputs
    (HELD_SHADOW, `held_shadow_rays`: the primitives' shadow rays, L and
    max_dist one row and one a ray, each with some rays occluded and
    some not; the icosphere's, one row).  W3's nearest entry alone timed
    through CUDA graphs at the grid's camera rays, its occluded entry at
    each held input; the occluded wrapper's device events a call on the
    icosphere's (`w3_events`), its kernel alone required.  Then the
    primitives example at 400x300 x 16 spp through Scene.render on the
    wavefront, W3's counts set to 0 just before and read just after: both
    entries launched.  Prints three lines."""
    import numpy as np
    import raytracer_tpu_torch as T
    import torch_primitives
    import torch_wavefront
    from raytracer_tpu_torch.core.camera import generate_rays
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import analytic_sweep
    from torch_cornellbox import build_cornell

    t_phase = time.perf_counter()
    holds = []
    never = T.RenderSettings(use_pallas="never")
    for name, sc, spp in (
            ("grid", torch_wavefront.grid(GRID_PAST, GRID_W, GRID_H), WAVE_SPP),
            ("primitives", torch_primitives.primitives(PRIM_W, PRIM_H), WAVE_SPP),
            ("Cornell", build_cornell(*WAVE_CORNELL), WAVE_SPP)):
        sc.settings = never
        static, data = compile_wavefront(sc)
        data = data.to(dev)
        geom = data.geom
        W, H = sc.camera.screen_width, sc.camera.screen_height
        chunk_spp = plan_chunks(spp * sc._diffuse_fan(), W, H)[0]
        O, D = generate_rays(torch.Generator(device=dev).manual_seed(5),
                             sc.camera.params(), W, H, chunk_spp)
        text, (t, orient, obj), plain_ms = w3_nearest(
            torch, f"{name} camera rays", geom, O, D)
        if name == "grid":
            counts = analytic_sweep.kind_counts(geom)
            n = O.shape[0]
            table = analytic_sweep.scene_tables(geom)
            text += w3_time(
                torch, "analytic_nearest", f"{name} camera rays",
                lambda: analytic_sweep._nearest_launch(O, D, geom),
                [c * n for c in counts],
                # rays read once, t, orient and id written once, the table
                n * 24 + n * 16 + table.numel() * 4, plain_ms)
        holds.append(text)
        O, D = mirror_bounce(torch, geom, static, O, D, t, orient, obj)
        holds.append(w3_nearest(torch, f"{name} first bounce", geom, O, D)[0])
        del O, D, t, orient, obj, data, geom
        torch.cuda.empty_cache()
    # the occluded entry alone at its held inputs
    for name, uniform in HELD_SHADOW:
        geom, O, L, shadow, md = held_shadow_rays(torch, dev, name, uniform)
        what = f"{name} shadow rays, {'one row' if uniform else 'one a ray'}"
        text, plain_ms, occluded = w3_occluded(torch, what, geom, O, L, shadow, md)
        if name == "primitives":
            # an answer that is the same on every ray would not tell a
            # kernel that never (or always) occludes from a right one
            require(0 < occluded < O.shape[0], f"W3 {what}: {occluded} of "
                    f"{O.shape[0]} occluded, want some and not all")
        text += w3_time(
            torch, "analytic_occluded", what,
            lambda: analytic_sweep._occluded_launch(O, L, geom, shadow, md),
            occluded_tests(torch, geom, O, L, shadow, md),
            occluded_bytes(geom, O, L, shadow, md), plain_ms)
        holds.append(text)
        del geom, O, L, md
        torch.cuda.empty_cache()
    print(f"W3 vs plain: {' | '.join(holds)}", flush=True)
    # the device events of the occluded wrapper on the icosphere's shadow
    # rays (direction and max_dist one row), in a process of its own: a
    # profile taken after large ones can lose events
    check = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.w3_events()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(check.returncode == 0, f"W3 profile check: {check.stderr[-2000:]}")
    prof = json.loads(check.stdout.strip().splitlines()[-1])
    events = prof["events_a_call"]
    print(f"W3 occluded device events a call (torch.profiler, a process of its "
          f"own, icosphere shadow rays, L and max_dist one row): "
          f"{json.dumps(events)} | {prof['device_ms_a_call']:.4f} ms of device "
          f"time a call | {prof['launches_a_call']} launch a call by the "
          f"wrapper's count", flush=True)
    require(len(events) == 1 and "analytic_occluded_kernel" in next(iter(events))
            and next(iter(events.values())) == 1.0 and prof["launches_a_call"] == 1,
            f"W3 occluded: device events a call {events}, want its kernel alone")

    # ---- the primitives example through Scene.render on the wavefront ----
    sc = torch_primitives.primitives(PRIM_W, PRIM_H)
    sc.settings = never
    sc.render(samples_per_pixel=PRIM_SPP, output="linear", device=dev, seed=3)
    analytic_sweep.reset_launches()
    img, stats, wall = timed_render(torch, dev, sc, PRIM_SPP, seed=3)
    got = w3_launches(analytic_sweep)
    print(f"W3 main path: primitives {PRIM_W}x{PRIM_H} x {PRIM_SPP} spp through "
          f"Scene.render on the wavefront | W3 launches {got['analytic_nearest']} "
          f"nearest, {got['analytic_occluded']} occluded | wall {wall:.4f} s, "
          f"{stats['rays_traced'] / wall / 1e6:.1f} Mrays/s | image mean "
          f"{img.mean():.6f} | phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    require(all(v > 0 for v in got.values()), f"W3 launches {got} in the "
            "primitives render")
    require(img.shape == (PRIM_H, PRIM_W, 3) and bool(np.isfinite(img).all()),
            "primitives image not finite or of the wrong shape")


@contextlib.contextmanager
def w4_spies():
    """Spies for W4's phase, the originals restored after it: trace's three
    wrappers (ops/wavefront_shade.py) capture each entry's call at every
    bounce of a labelled render's first chunk (its ShadeCtx, draws, packed
    words, mask and a copy of the merged output it was handed), and the
    plain blocks count their calls on CUDA tensors outside a hold and
    outside `_Shade`'s backward (which recomputes the plain block for its
    gradient)."""
    from raytracer_tpu_torch.materials import shade
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    names = ("shade_diffuse", "shade_refractive", "shade_glossy")
    saved = ([(ws, n, getattr(ws, n)) for n in names]
             + [(shade, n, getattr(shade, n)) for n in names]
             + [(ws._Shade, "backward", ws._Shade.__dict__["backward"])])

    def spy(mt, real):
        def call(ctx, draws, packed, m, acc):
            lab, name = W4["label"], real.__name__
            key = (lab, name, ctx.bounce)
            if lab is not None and (lab, name) not in W4["chunk_done"]:
                if key in W4["seen"]:       # the render's second chunk
                    W4["chunk_done"].add((lab, name))
                else:
                    W4["seen"].add(key)
                    copy = ws.Merged(*(getattr(acc, f).detach().clone()
                                       for f in ws.FLOAT_FIELDS + ws.BOOL_FIELDS))
                    W4["captured"][key] = (mt, ctx, draws, packed, m, copy)
            return real(ctx, draws, packed, m, acc)
        return call

    def counted(block):
        def call(ctx, *args, **kw):
            if ctx.P.device.type == "cuda" and not W4["holding"]:
                W4["plain_on_card"] += 1
            return block(ctx, *args, **kw)
        return call

    def counted_backward(fctx, *grads):
        W4["holding"], W4["backward"] = True, W4["backward"] + 1
        try:
            return saved[-1][2].__func__(fctx, *grads)
        finally:
            W4["holding"] = False

    for mt, w in ws._WRAPPER.items():
        setattr(ws, w.__name__, spy(mt, w))
    for n in names:
        setattr(shade, n, counted(getattr(shade, n)))
    ws._Shade.backward = staticmethod(counted_backward)
    try:
        yield
    finally:
        for obj, n, v in saved:
            setattr(obj, n, v)


class w4_driven:
    """A driven render labelled `label`: W4's counts set to 0 just before
    and read just after (added to the run's), W4's first call of each
    entry captured; no plain block may run on the card in it (a backward
    pass's recompute aside)."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        from raytracer_tpu_torch.ops import wavefront_shade as ws
        self.ws, self.plain = ws, W4["plain_on_card"]
        W4["label"] = self.label
        ws.reset_launches()
        return self

    def __exit__(self, *exc):
        W4["label"] = None
        self.got = {key: self.ws._WRAPPER[mt].launches
                    for mt, (key, _) in self.ws._BLOCKS.items()}
        for key, n in self.got.items():
            W4["launches"][key] += n
        self.plain_runs = W4["plain_on_card"] - self.plain
        return False


def w4_bytes(mt, ctx, draws, m, tt, occ):
    """The bytes W4's entry moves on a captured bounce, each input read
    once and each output written once: every ray's packed word, and for
    its type's rays their state, draws, texels and the outputs its block
    changes (the merged output starts with the rest); a medium every ray
    shares, and the slot and light tables, once."""
    from raytracer_tpu_torch.materials.base import (MAT_DIFFUSE, MAT_GLOSSY,
                                                    MAT_REFRACTIVE)
    from raytracer_tpu_torch.ops.wavefront_shade import WRITTEN

    n, typed = m.shape[0], int(m.sum())
    # P, N, eps; the float fields the entry writes, cont, and is_diffuse
    # (diffuse) or did_split (refractive)
    per = 12 + 12 + 4 + 12 * len(WRITTEN[mt]) + 1 + (mt != MAT_GLOSSY)
    once = 0
    for x in ((ctx.n_re, ctx.n_im) if mt != MAT_DIFFUSE else ()):
        if x.dim() == 2 and x.stride(0) != 0:
            per += 12
        else:
            once += 12
    data, mats = ctx.data, ctx.data.mats
    if mt == MAT_DIFFUSE:
        per += 8 + 4 + 12 + (8 if draws[mt][1] is not None else 0)
        if ctx.strat_u is not None:       # read where the bounce is the first
            once += 12 * int((m & (ctx.diffuse_reflections == 0)).sum())
        tabs = [mats.diffuse_color, mats.diffuse_ambient_weight, data.is_center,
                data.is_radius, data.env_is_prob, data.env_is_alias,
                data.env_is_pdf]
    elif mt == MAT_REFRACTIVE:
        # D, t, orient, depth, u; hero; the split pattern and count
        per += 12 + 4 + 4 + 4 + 4 + (8 if draws[mt][1] is not None else 0)
        per += 8 if ctx.split_k > 0 else 0
        tabs = [mats.refr_n_re, mats.refr_n_im, mats.refr_dispersive]
    else:
        per += 12 + 8 + 4 + (len(occ) if occ else 0)    # D, uv, depth, answers
        tabs = [mats.glossy_color, mats.glossy_diff, mats.glossy_roughness,
                mats.glossy_spec, mats.glossy_n_re, mats.glossy_n_im,
                *(getattr(data.lights, f) for f in (
                    "dir_l", "dir_color", "point_pos", "point_color", "spot_pos",
                    "spot_dir", "spot_color", "spot_cos_in", "spot_cos_out"))]
    if tt is not None:
        # the texels of the typed rays of textured slots: 4 taps bilinear
        flags = tt[1][ctx.mat_slot.clamp(0, tt[1].shape[0] - 1).long(), 3]
        taps = ((flags & 1) != 0).long() * (1 + 3 * ((flags & 2) != 0).long())
        once += 12 * int((taps * m).sum())
    return 4 * n + per * typed + once + sum(x.numel() * x.element_size()
                                            for x in tabs)


def w4_ops(torch, key, rays, typed):
    """Issue slots of W4's entry `key` on `rays` rays of which `typed` are
    of its type, read once off its kernel's SASS: the glossy entry a
    pass of its loop over the rays for a ray of another type, on the
    shortest path, and the same pass with the type test passed, on the
    cheapest branches, for a ray of its type (`shaded_pass`); the diffuse
    and refractive entries, which queue their rays, a pass of the queueing
    loop shared by the pass's rays and a shading round for each of their
    rays (`queued_pass`; the diffuse entry's kernel for caps sums in
    registers).  Returns (slots, text)."""
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    if key not in W4["slots"]:
        if "sass" not in W4:
            W4["sass"] = common.cuobjdump_sass(cuda_build.build("kernels"))
        kernel = W4_ENTRIES[key][0]
        if key in W4_QUEUED:
            queue, shaded = common.queued_pass(W4["sass"], kernel)
            inf = ws.info(w4_type(key))
            words = inf["rays_per_pass"] // inf["block"]
            W4["slots"][key] = (queue / words, shaded, (
                f"{queue} instructions a queueing pass ({words} ray(s) a "
                f"thread), {shaded} a shading round, {kernel}'s SASS"))
        else:
            other, shaded = common.shaded_pass(W4["sass"], kernel)
            W4["slots"][key] = (other, shaded - other, (
                f"{other} instructions a pass of another type's ray, {shaded} "
                f"of its own on the shortest path, {kernel}'s SASS"))
    each, own, text = W4["slots"][key]
    return rays * each + typed * own, text


def w4_type(key):
    """The material type of W4's entry `key`."""
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    return next(mt for mt, (k, _) in ws._BLOCKS.items() if k == key)


def resource_usage(path):
    """{kernel name: {"REG", "STACK", "SHARED", "LOCAL": int}} of a built
    library, as `cuobjdump -res-usage` prints them."""
    exe = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([exe, "-res-usage", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = m.group(1)
            continue
        vals = dict(re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line))
        if cur and vals:
            out[cur] = {k: int(v) for k, v in vals.items()}
            cur = None
    return out


def sector_bytes(torch, m, reads, writes):
    """The bytes a kernel moves that reads the rows of m's rays of each
    field of `reads` and writes those of `writes` (row sizes in bytes, each
    field an array of n rows), counted by the 32-byte sectors that hold
    such a row: a sector read once; a sector written once, and read once
    more where it also holds rows of other rays (the cache fills it before
    it merges a partial write)."""
    idx = m.nonzero()[:, 0]
    total = 0
    for size, written in [(r, False) for r in reads] + [(r, True) for r in writes]:
        n_sec = (m.shape[0] * size + 31) // 32
        start = idx * size
        end = start + size
        s0, s1 = start // 32, (end - 1) // 32
        have = torch.zeros(n_sec, dtype=torch.int64, device=m.device)
        have.index_add_(0, s0, torch.minimum(end, (s0 + 1) * 32) - start)
        tail = s1 != s0
        have.index_add_(0, s1[tail], end[tail] - s1[tail] * 32)
        cap = torch.clamp(m.shape[0] * size - 32 * torch.arange(
            n_sec, device=m.device), max=32)
        touched = int((have > 0).sum())
        total += 32 * touched
        if written:
            total += 32 * int(((have > 0) & (have < cap)).sum())
    return total


def field_rows(key, ctx, draws, occ=None):
    """(row sizes read, row sizes written) of W4's entry `key` on its
    type's rays, its packed words and any texels aside: the fields its
    block reads and writes (`w4_bytes`), each an array of n rows."""
    from raytracer_tpu_torch.materials.base import MAT_DIFFUSE, MAT_REFRACTIVE

    per_ray = lambda x: x.dim() == 2 and x.stride(0) != 0
    medium = [12 for x in (ctx.n_re, ctx.n_im) if per_ray(x)]
    if key == "shade_refractive":
        reads = [12, 12, 12, 4, 4, 4, 4, 4] + medium  # P N D, t orient eps depth u
        reads += [8] if draws[MAT_REFRACTIVE][1] is not None else []
        reads += [4, 4] if ctx.split_k > 0 and ctx.pattern is not None else []
        return reads, [12] * 5 + [1, 1]
    if key == "shade_glossy":              # P N D uv, eps depth, the answers
        return [12, 12, 12, 8, 4, 4] + medium + [1] * len(occ or ()), [12] * 4 + [1]
    reads = [12, 12, 8, 4, 4, 4, 4, 4]          # P N uv, eps refl, draws
    reads += [8] if draws[MAT_DIFFUSE][1] is not None else []
    reads += [4, 4, 4] if ctx.strat_u is not None else []
    return reads, [12] * 3 + [1, 1]


def w4_sectors(torch, key, ctx, draws, m, occ=None):
    """(bytes, ms at the HBM rate) of W4's entry `key` on a bounce counted
    by sectors: every ray's packed word and its type's rows
    (`sector_bytes` of `field_rows`)."""
    from raytracer_tpu_torch.probes import common

    n_bytes = 4 * m.shape[0] + sector_bytes(torch, m, *field_rows(key, ctx, draws, occ))
    return n_bytes, common.bound(0, n_bytes)[0]


def warps_holding(torch, m):
    """Warps of 32 consecutive rays that hold at least one ray of m."""
    pad = torch.zeros((-m.shape[0]) % 32, dtype=torch.bool, device=m.device)
    return int(torch.cat([m, pad]).view(-1, 32).any(-1).sum())


def queued_efficiency(torch, m, info):
    """The lane efficiency of a queued entry's shading rounds on the rays
    m of its type, from its tiling (`info`: `ws.info`): each block of
    the grid takes every grid-th tile of rays_per_pass rays and shades its
    queue in rounds of a block's threads, all full but its last; the rays
    over 32 lanes of the warps that run a round with at least one."""
    block, tile = info["block"], info["rays_per_pass"]
    tiles = -(-m.shape[0] // tile)
    grid = min(tiles, info["sms"] * info["blocks_per_sm"])
    pad = torch.zeros(tiles * tile - m.shape[0], dtype=torch.bool, device=m.device)
    per_tile = torch.cat([m, pad]).view(tiles, tile).sum(-1)
    per_block = torch.zeros(grid, dtype=torch.int64, device=m.device)
    per_block.index_add_(0, torch.arange(tiles, device=m.device) % grid, per_tile)
    warps = (per_block // block) * (block // 32) + (per_block % block + 31) // 32
    return int(m.sum()) / (32 * int(warps.sum())) if bool(m.any()) else 0.0


def bits_share(torch, got, want, fields):
    """(the bit-equal share of every element of `fields` of two Merged
    outputs, counted in integers; their largest finite difference)."""
    same = total = 0
    err = 0.0
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.is_floating_point():
            eq = (a.view(torch.int32) == b.view(torch.int32)) | (
                torch.isnan(a) & torch.isnan(b))
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a - b)[fin].abs().max()))
        else:
            eq = a == b
        same += int(eq.sum())
        total += eq.numel()
    return same / total, err


def w4_hold(torch, label):
    """W4 against the plain dispatch on the bounces captured in the render
    `label` (every bounce of its first chunk), each entry on the card: its
    merged output and the plain block's merged into the same output, every
    field of every ray bit for bit (floats by their bits, or both NaN; a
    share of exactly 1.0, required); W4 alone timed through a CUDA graph
    (`graph_ms`) at the bounce, the plain block and its merge with events;
    its rays of the type, the warps of 32 rays that hold one, the lane
    efficiency (those rays over 32 lanes of those warps), the bound and
    the share, and the bytes by sectors (`w4_sectors`) with the share of
    their time.  The queued entries (W4_QUEUED) are timed again on the
    bounce's rays with their type's rays moved to the front
    (`ws.pick_rays`; the plain dispatch's on those rays, bit for bit,
    required), and their shading rounds' lane efficiency is computed from
    their tiling.  Keeps each entry's numbers at its
    bounce with the most rays of its type, and its time a bounce; frees
    the captures.  Returns (a line a bounce, the text of a line)."""
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    fields = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
    lines, parts = [], {}
    for lab, key, b in sorted(k for k in W4["captured"] if k[0] == label):
        call = W4["captured"].pop((lab, key, b))
        mt, ctx, draws, packed, m, acc = call
        W4["holding"] = True
        try:
            with torch.no_grad():
                occ = None
                if key == "shade_glossy":
                    nudged, rays = ws.shade.light_rays(ctx)
                    occ = ws.shade.light_occlusion(ctx, nudged, rays)
                got = ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
                    *(getattr(acc, f).clone() for f in fields)))
                want = acc.merge(ws._plain(mt, ctx, draws, occ), m)
                share, err = bits_share(torch, got, want, fields)
                W4["max_abs_err"][key] = max(W4["max_abs_err"][key], err)
                require(share == 1.0, f"W4 {key} on the {label} bounce {b}: "
                        f"bit-equal share {share}")
                del want

                def graph(c, out):
                    # W4 alone through a CUDA graph, on a copy it owns
                    # (the stream read at each call: the graph's capture
                    # runs on a stream of its own)
                    entry, rays_s, block, keep = ws.prepare(c[0], c[1], c[2], c[3],
                                                            out, occ)
                    return common.graph_ms(
                        lambda: ws._call(None, entry, ws.ctypes.byref(rays_s),
                                         ws.ctypes.byref(block),
                                         ws.cuda_build.stream_of(ctx.P.device),
                                         entries=ws.ENTRIES), W4_REPS)[0]

                ms = graph(call, got)
                plain_ms = common.cuda_ms(
                    lambda: acc.merge(ws._plain(mt, ctx, draws, occ), m), 1)
                front_ms = None
                if key in W4_QUEUED:
                    order = torch.argsort((~m).to(torch.int8), stable=True)
                    front = ws.pick_rays(call, order)
                    got_f = ws._kernel_shade(*front[:5], ws.Merged(
                        *(getattr(front[5], f).clone() for f in fields)))
                    # the plain dispatch on the reordered rays (a sum of 128
                    # or more caps terms a row rounds by the row's place)
                    want_f = front[5].merge(ws._plain(*front[:3], None), front[4])
                    require(bits_share(torch, got_f, want_f, fields)[0] == 1.0,
                            f"W4 {key} on the {label} bounce {b} with its rays "
                            "moved to the front: not the plain dispatch's")
                    front_ms = graph(front, got_f)
                    del front, got_f, want_f, order
                tt = None
                if key != "shade_refractive":
                    mats = ctx.data.mats
                    table, refs = ((mats.diffuse_color, ctx.static.diffuse_tex)
                                   if key == "shade_diffuse" else
                                   (mats.glossy_color, ctx.static.glossy_tex))
                    tt = ws.texture_tables(mats, table, refs, ctx.data.textures)
                typed, n = int(m.sum()), m.shape[0]
                warps = warps_holding(torch, m)
                n_bytes = w4_bytes(mt, ctx, draws, m, tt, occ)
                bound_ms, bound_by = common.bound(w4_ops(torch, key, n, typed)[0],
                                                  n_bytes)
                sec_bytes, sec_ms = w4_sectors(torch, key, ctx, draws, m, occ)
        finally:
            W4["holding"] = False
        at = dict(key=key, name=f"{label} bounce {b}", ms=ms, plain_ms=plain_ms,
                  rays=n, typed=typed, bytes=n_bytes)
        if typed >= W4["timed"].get(key, {}).get("typed", -1):
            W4["timed"][key] = at
        W4["chunk_ms"].setdefault((label, key), []).append(ms)
        eff = typed / (32 * warps) if warps else 0.0
        queued = (f" (its shading rounds "
                  f"{queued_efficiency(torch, m, ws.info(mt)):.4f})"
                  if key in W4_QUEUED else "")
        lines.append(
            f"W4 {label} {key[6:]} bounce {b}: {typed} of {n} rays its type, "
            f"{warps} warps hold one, lane efficiency {eff:.4f}{queued}, bit-equal "
            f"{share}, W4 {ms:.4f} ms (CUDA graph), bound {bound_ms:.4f} ms "
            f"({bound_by}), share {bound_ms / ms:.4f}"
            + f"; by sectors {sec_bytes / 1e6:.1f} MB, {sec_ms:.4f} ms, share "
            f"{sec_ms / ms:.4f}"
            + (f"; its rays in front {front_ms:.4f} ms" if front_ms else "")
            + f", plain {plain_ms:.2f} ms")
        p = parts.setdefault(key, [0, 0.0, (b, typed, n, ms, plain_ms)])
        p[0] += 1
        p[1] += ms
        del ctx, draws, packed, m, acc, got, call
    torch.cuda.empty_cache()
    text = " | ".join(
        f"{k[6:]} bounce {b0}: {t0} of {n0} rays, bit-equal 1.0, W4 {ms0:.4f} ms "
        f"(CUDA graph), plain {p0:.2f} ms; {c} bounces held, W4 {tot / c:.4f} ms "
        f"a call" for k, (c, tot, (b0, t0, n0, ms0, p0)) in parts.items())
    return lines, text


def w4_phase(torch, dev):
    """W4, the shading blocks, in the driven wavefront renders: the
    98-object grid at 400x300 x 64 spp, Cornell at 400x400 x 64 spp under
    use_pallas="never", the icosphere, the beach ball and the instance
    field at 400x300 x 16 spp, the normal-mapped scene at 400x300 x 16 spp,
    131 importance-sampled lamps (a caps pdf of 131 terms, ATen's
    four-wide loads) at 200x150 x 16 spp and one forward + backward pass
    of the inverse-rendering gradient at 96x72 x 8 spp; each render with
    W4's counts set to 0 just before and read just after (every entry its
    scene has launched, required; no plain block on the card, required),
    then its captured bounces (every bounce of its first chunk) held
    against the plain dispatch and timed (`w4_hold`).  Prints a line a
    render, and a line a bounce for the renders of W4_PER_BOUNCE.  W4's
    spies (`w4_spies`) are in place for this phase only.  Then a line of
    the W4 kernels' resources (`w4_resources`) and the caps sum held
    against torch.sum (`w4_sum_hold`)."""
    with w4_spies():
        w4_renders(torch, dev)
    w4_resources()
    w4_sum_hold(torch, dev)


def w4_resources():
    """Prints the registers, stack, local memory (spills) and resident
    blocks an SM of each W4 kernel, off the built library (`cuobjdump
    -res-usage`) and the card (`ws.info`); requires the diffuse entry's
    kernel for caps sums in registers to have no stack and no spills."""
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    path = cuda_build.build("kernels")
    use = resource_usage(path)
    ptxas = [ln for ln in build_lines(cuda_build.build_logs.get(path, ""))
             if ln.startswith("shade_")]
    parts = []
    for kernel in ws.KERNELS:
        name = next(k for k in use if re.search(rf"\d{kernel}E", k))
        r = use[name]
        mt = w4_type(next(k for k, (kn, _) in W4_ENTRIES.items()
                          if kernel.replace("_wide", "") == kn))
        inf = ws.info(mt, wide="_wide" in kernel)
        parts.append(f"{kernel} {r['REG']} registers, stack {r['STACK']} B, local "
                     f"{r['LOCAL']} B, {inf['blocks_per_sm']} blocks an SM "
                     f"(bound {inf['min_blocks']})")
        if kernel == "shade_diffuse_kernel":
            require(r["STACK"] == 0 and r["LOCAL"] == 0 and inf["local_bytes"] == 0,
                    f"W4 {kernel}: stack {r['STACK']} B, local {r['LOCAL']} B")
    print("W4 kernels: " + " | ".join(parts + (ptxas or ["no ptxas log in this "
                                                         "process"])), flush=True)


def w4_sum_hold(torch, dev):
    """The diffuse entry's caps sum in registers (`ws.caps_sum`, the plan
    torch's reduction makes for W4_SUM_ROWS rows) against torch.sum(x, -1)
    on the card at each K of W4_SUM_KS, on rows of mixed signs and
    magnitudes from a seed: bit for bit, required.  Then W4's restated
    sinf and cosf against libdevice's on every float (`ws.trig_mismatches`:
    none, required)."""
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    gen = torch.Generator(device=dev).manual_seed(20)
    for K in W4_SUM_KS:
        shape = (W4_SUM_ROWS, K)
        x = torch.randn(shape, generator=gen, device=dev) * torch.pow(
            10.0, torch.rand(shape, generator=gen, device=dev) * 6.0 - 3.0)
        got, want = ws.caps_sum(x), torch.sum(x, dim=-1)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"W4 caps sum in registers at K = {K}: not torch.sum's bits")
    print(f"W4 caps sum in registers vs torch.sum ({W4_SUM_ROWS} rows; K = "
          f"{', '.join(map(str, W4_SUM_KS))}): bit-equal", flush=True)
    t0 = time.perf_counter()
    bad = ws.trig_mismatches(dev)
    require(bad == 0, f"W4's restated sinf / cosf differ from libdevice's at {bad} "
            "inputs")
    print(f"W4 sinf / cosf restated vs libdevice's: equal on all 2^32 floats "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def w4_renders(torch, dev):
    """The renders of `w4_phase`, under its spies."""
    import numpy as np
    import raytracer_tpu_torch as T
    import torch_features
    import torch_mesh
    import torch_wavefront
    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from torch_cornellbox import build_cornell
    from torch_inverse_rendering import TRUE_N, build_scene

    t_phase = time.perf_counter()
    obj_dir = WORK / "w4_obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    never = T.RenderSettings(use_pallas="never")

    def with_never(sc):
        sc.settings = never
        return sc

    renders = (
        ("grid", lambda: torch_wavefront.grid(GRID_PAST, GRID_W, GRID_H), WAVE_SPP),
        ("Cornell on the wavefront", lambda: with_never(build_cornell(*WAVE_CORNELL)),
         WAVE_SPP),
        ("icosphere", lambda: torch_mesh.icosphere(MESH_W, MESH_H, obj_dir=obj_dir),
         MESH_SPP),
        ("beach ball", lambda: torch_mesh.beach_ball(MESH_W, MESH_H, obj_dir=obj_dir),
         MESH_SPP),
        ("instance field", lambda: torch_mesh.instances(MESH_W, MESH_H,
                                                         obj_dir=obj_dir), MESH_SPP),
        ("normal-mapped", lambda: torch_features.normal_mapped(
            MESH_W, MESH_H, obj_dir=obj_dir), NMAP_SPP),
        ("lamps", lambda: torch_wavefront.lamp_cluster(LAMPS, *LAMP_WH), MESH_SPP))
    for label, make, spp in renders:
        sc = make()
        static = sc._settings_for_render()[0]
        present = [ws._BLOCKS[mt][0] for mt in static.mat_types_present
                   if mt in ws._BLOCKS]
        with w4_driven(label) as d:
            img, stats, wall = timed_render(torch, dev, sc, spp, seed=7)
        require(img.shape[:2] == (sc.camera.screen_height, sc.camera.screen_width)
                and bool(np.isfinite(img).all()), f"W4 {label}: image")
        require(present and all(d.got[k] > 0 for k in present),
                f"W4 {label}: launches {d.got} for the present entries {present}")
        require(d.plain_runs == 0, f"W4 {label}: {d.plain_runs} plain blocks "
                "ran on the card")
        lines, text = w4_hold(torch, label)
        if label in W4_PER_BOUNCE:
            print("\n".join(lines), flush=True)
        print(f"W4 vs plain, {label} ({wall:.4f} s, launches "
              f"{ {k[6:]: n for k, n in d.got.items() if n} }, no plain block): "
              + text, flush=True)
        del sc, img
    # the inverse-rendering step: W4 forward through _Shade, the plain
    # block's backward
    fn, data = differentiable_render(build_scene(TRUE_N, DIFF_W, DIFF_H),
                                     DIFF_SPP, seed=0, device=dev)
    label = "inverse rendering"
    backward = W4["backward"]
    with w4_driven(label) as d:
        x = data.mats.refr_n_re.clone().requires_grad_(True)
        g, = torch.autograd.grad(
            torch.mean(fn(update_materials(data, refr_n_re=x)) ** 2), x)
        torch.cuda.synchronize()
    require(d.got["shade_refractive"] > 0 and d.plain_runs == 0
            and W4["backward"] > backward and bool(torch.isfinite(g).all()),
            f"W4 {label}: launches {d.got}, {d.plain_runs} plain blocks "
            f"outside the backward, gradient {g.tolist()}")
    print(f"W4 vs plain, {label} (forward + backward of the IoR gradient, "
          f"launches { {k[6:]: n for k, n in d.got.items() if n} }, "
          f"{W4['backward'] - backward} backward recomputes, gradient "
          f"{g[0].tolist()}): " + w4_hold(torch, label)[1] +
          f" | phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    require(W4["plain_on_card"] == 0, f"{W4['plain_on_card']} plain blocks ran "
            "on the card")


def w4_rows(torch):
    """W4's rows of the kernels line, one an entry at the held bounce it
    was timed on (the most rays of its type): its bound from the bytes it
    moves there and its issue slots off its kernel's SASS (`w4_ops`), and
    beside its time there the mean a call over the bounces of that
    render's first chunk (`chunk_mean_ms`); a line each, with the
    registers, local memory and resident blocks an SM it was built to."""
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    rows = []
    for key, (kernel, replaces) in W4_ENTRIES.items():
        tm, launches = W4["timed"].get(key), W4["launches"][key]
        require(tm is not None, f"W4 {key} was never held")
        ops, text = w4_ops(torch, key, tm["rays"], tm["typed"])
        row = common.row(f"wavefront_shade {key} (W4)", "wavefront_shade.cu",
                         replaces, launches, W4["max_abs_err"][key], tm["ms"],
                         tm["plain_ms"], ops, tm["bytes"])
        label = tm["name"].rsplit(" bounce ", 1)[0]
        per = W4["chunk_ms"][(label, key)]
        row["chunk_mean_ms"] = sum(per) / len(per)
        rows.append(row)
        inf = ws.info(next(mt for mt, (k, _) in ws._BLOCKS.items() if k == key))
        print(f"W4 {key} bound at the {tm['name']} ({tm['typed']} of "
              f"{tm['rays']} rays its type; {text}; {tm['bytes']} bytes): "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), W4 {tm['ms']:.4f} ms, "
              f"share {row['bound_ms'] / tm['ms']:.4f}, mean "
              f"{row['chunk_mean_ms']:.4f} ms a call over the {len(per)} bounces "
              f"of the {label} chunk, plain {tm['plain_ms']:.2f} ms | "
              f"{inf['registers']} registers, {inf['local_bytes']} B local, "
              f"{inf['blocks_per_sm']} blocks an SM | {launches} launches in the "
              "driven renders", flush=True)
        require(launches > 0, f"W4 {key} never launched in the driven renders")
    return rows


def routed_renders(torch, dev, sc, spp, n, seed):
    """n renders of sc on the card with one seed: ([(image, stats, wall)],
    the devices of the wavefront chunks, the render kernels' launches,
    peak GiB, W1's launches, added to the run's by entry, W2's, added to
    the run's, W3's by entry, added to the run's)."""
    from raytracer_tpu_torch.core import scene as scene_mod
    from raytracer_tpu_torch.ops import analytic_sweep, mesh_pairs, mesh_sweep
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st

    devices = []
    trace = scene_mod.trace

    def traced(*args, **kw):
        devices.append(args[1].device.type)
        return trace(*args, **kw)

    scene_mod.trace = traced
    st.solid_trace_chunk.launches = rt.record_trace_chunk.launches = 0
    mesh_sweep.reset_launches()
    mesh_pairs.cluster_pairs.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    analytic_sweep.reset_launches()
    try:
        runs = [timed_render(torch, dev, sc, spp, seed=seed) for _ in range(n)]
    finally:
        scene_mod.trace = trace
    w3 = w3_launches(analytic_sweep)
    launches = st.solid_trace_chunk.launches + rt.record_trace_chunk.launches
    w2 = mesh_pairs.cluster_pairs.launches
    W2["launches"] += w2
    return (runs, devices, launches,
            torch.cuda.max_memory_allocated(dev) / 2 ** 30, w1_launches(mesh_sweep),
            w2, w3)


def w3_launches(analytic_sweep):
    """W3's launches since its counts were set to 0, added to the run's by
    entry; returns them by entry."""
    got = {key: getattr(analytic_sweep, key).launches for key in W3_ENTRIES}
    for key, n in got.items():
        W3["launches"][key] += n
    return got


def w1_launches(mesh_sweep):
    """W1's launches since its counts were set to 0, added to the run's by
    entry; returns their sum."""
    for key in W1_ENTRIES:
        W1["launches"][key] += getattr(mesh_sweep, key).launches
    return mesh_sweep.launches()


def chunk_var(torch, dev, sc, spp, solid=False):
    """(REGIONS**2 + 1,) variance of a render's region and image means
    over spp samples a pixel, from the scatter of one chunk's samples on
    the wavefront (solid=True: the solid kernel)."""
    from raytracer_tpu_torch.core import scene as scene_mod
    from raytracer_tpu_torch.core.camera import cam_vec
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import chunk_seeds, plan_chunks
    from raytracer_tpu_torch.ops import solid_trace as st

    W, H = sc.camera.screen_width, sc.camera.screen_height
    static, tables, settings = sc._settings_for_render()
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(spp * sc._diffuse_fan() * fan, W, H, fan)
    row = chunk_seeds(99, 1, chunk)[0]
    if solid:
        L, _ = st.solid_trace_chunk(
            torch.from_numpy(row).to(dev), tables.to(dev),
            cam_vec(sc.camera.params()).to(dev), W, H, chunk,
            settings.max_bounces, settings.split_k, settings.sampler,
            settings.projection)
    else:
        L, _ = scene_mod.wavefront_chunk(row, static,
                                         compile_wavefront(sc)[1].to(dev),
                                         sc.camera.params(), settings, W, H,
                                         chunk)
    var = region_samples(torch, L, chunk, W, H).var(dim=0)
    return (var / (chunk * n_chunks)).cpu().numpy()


def z_hold(name, a, b, var, W, H):
    """z of two renders' image and REGIONS x REGIONS region means, given
    the summed variance of both means; fails past 4."""
    import numpy as np
    z = (np.abs(image_regions(a, W, H) - image_regions(b, W, H))
         / np.maximum(np.sqrt(var), 1e-12))
    require((z < 4).all(), f"{name}: z {z}")
    return (f"image mean {a.mean():.6f} vs {b.mean():.6f}, z {z[-1]:.2f} | "
            f"{REGIONS}x{REGIONS} regions max z {z[:-1].max():.2f}")


def sweep_pair(torch, fn, *args):
    """(result, CUDA-event ms) of one call of fn."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def analytic_only(geom):
    """geom without its triangles, clusters and instances: its nearest hit
    is the limit the render passes the triangle sweep, its occluded the
    hit0."""
    import dataclasses
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name)[:0] for f in dataclasses.fields(geom)
        if f.name.startswith(("tri_", "inst_"))})


def w1_time(torch, key, name, fn, tests, n_bytes, plain_ms):
    """W1's entry `key` alone on one held input: fn, its launch on that
    input, through a CUDA graph (`graph_ms`) and with events around the
    calls; its launches a call, its triangle tests (what this input needs)
    and bytes, and G tests/s.  Returns (text, the numbers)."""
    from raytracer_tpu_torch.ops import mesh_sweep
    from raytracer_tpu_torch.probes import common

    wrapper = getattr(mesh_sweep, key)
    before = wrapper.launches
    fn()
    per_call = wrapper.launches - before
    ms = common.graph_ms(fn, W1_REPS)[0]
    ev_ms = common.cuda_ms(fn, W1_REPS)
    timed = dict(name=name, ms=ms, event_ms=ev_ms, plain_ms=plain_ms,
                 launches_per_call=per_call, tests=tests, bytes=n_bytes,
                 gtests_per_s=tests / (ms * 1e-3) / 1e9)
    return (f" | W1 alone (CUDA graph) {ms:.4f} ms a call of {per_call} "
            f"launches (events {ev_ms:.4f} ms), {tests} triangle tests, "
            f"{timed['gtests_per_s']:.1f} G tests/s"), timed


def w1_nearest(torch, name, geom, O, D, flat=False, timed=False):
    """W1's nearest hit against its plain version on the card, on the rays
    (O, D) of `name`: clustered, with the limit the render passes it (the
    analytic objects' nearest hit), or flat; t bit-equal and codes equal on
    every ray (a share of exactly 1.0), required.  timed: also W1 alone on
    this input (`w1_time`; clustered: on its pair search, 256 tests a
    pair; flat: every row for every ray).  Returns (text, the timed
    numbers or None)."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import mesh_sweep

    n = O.shape[0]
    key = "flat_nearest" if flat else "clustered_nearest"
    if flat:
        (t_k, c_k), ms_k = sweep_pair(torch, mesh_sweep.flat_nearest, O, D, geom)
        (t_p, c_p), ms_p = sweep_pair(torch, intersect._flat_nearest, O, D, geom)
    else:
        limit = intersect.nearest_hit(O, D, analytic_only(geom))[0]
        (t_k, c_k, _), ms_k = sweep_pair(torch, mesh_sweep.clustered_nearest,
                                         O, D, geom, limit)
        (t_p, c_p), ms_p = sweep_pair(torch, intersect._clustered_nearest, O, D,
                                      geom, limit)
    t_eq = float((t_k.view(torch.int32) == t_p.view(torch.int32)).float().mean())
    c_eq = float((c_k == c_p).float().mean())
    hit = c_p >= 0
    err = float((t_k - t_p)[hit].abs().max()) if bool(hit.any()) else 0.0
    W1["max_abs_err"][key] = max(W1["max_abs_err"][key], err)
    require(t_eq == 1.0 and c_eq == 1.0,
            f"W1 {name}: t bit-equal {t_eq}, codes equal {c_eq}")
    text = (f"{name}: {n} rays ({float(hit.float().mean()):.4f} hit a "
            f"triangle), t bit-equal {t_eq}, codes equal {c_eq}, wrapper "
            f"{ms_k:.2f} ms{'' if flat else ' (pair search included)'}, plain "
            f"{ms_p:.1f} ms")
    if not timed:
        return text, None
    rows, tables = mesh_sweep.scene_tables(geom)
    if flat:
        T = geom.tri_p1.shape[0]
        fn = lambda: mesh_sweep._flat_nearest_launch(O, D, geom)
        # rays and rows read once, t and code written once
        tests, n_bytes = n * T, n * 24 + T * mesh_sweep.ROW * 4 + n * 12
    else:
        C = geom.tri_cl_lo.shape[0]
        sw = one_pair_search(torch, name, O, D, geom, limit)
        fn = lambda: mesh_sweep.nearest_pairs(sw, rows, tables, C)
        require(torch.equal(fn()[0][:n], t_p), f"W1 {name}: the timed call differs")
        tests = sw["rays"].shape[0] * intersect.TRI_CLUSTER_SIZE
        n_bytes = pair_bytes(sw, rows, tables, C) + sw["rank"].numel() * 8 \
            + sw["Op"].shape[1] * 20            # ranks; t, code, record
    more, numbers = w1_time(torch, key, name, fn, tests, n_bytes, ms_p)
    return text + more, numbers


def one_pair_search(torch, name, O, D, geom, limit):
    """The clustered sweep's pair search of rays (O, D) under `limit`, which
    must be one group of tiles (intersect.py `_ray_groups`)."""
    from raytracer_tpu_torch.geometry import intersect

    groups = intersect._ray_groups(O.shape[0], geom.tri_cl_lo.shape[0])
    require(len(groups) == 1, f"W1 {name}: {len(groups)} ray groups")
    return intersect._cluster_pairs(O, D, geom, limit, groups[0][2])


def pair_bytes(sw, rows, tables, C):
    """Bytes a clustered entry reads once on the pair search sw: the rays'
    planes, the pairs, the rows and the record and instance tables."""
    n_inst = tables[3].shape[0]
    return (sw["Op"].shape[1] * 24 + sw["rays"].shape[0] * 16 + rows.numel() * 4
            + C * (12 if tables[2] is not None else 8) + n_inst * 52)


def first_hit_tests(torch, blocks, width):
    """Triangle tests of a sweep that stops at a ray's (or pair's) first
    occluder: blocks yields (first row of the block, (rows, n) occluder
    hits) in row order; each column counts its rows up to its first hit,
    all `width` where it has none."""
    first = None
    for lo, occ in blocks:
        f = torch.where(occ.any(0), occ.to(torch.int8).argmax(0) + lo, width)
        first = f if first is None else torch.minimum(first, f)
    return int(torch.where(first < width, first + 1, width).sum())


def w1_occluded(torch, name, geom, O, L, shadow, md, flat=False, timed=False):
    """W1's shadow rays against its plain version on the card: clustered
    (the analytic objects' answer as hit0) or flat; equal on every ray,
    required.  timed: also W1 alone on this input (`w1_time`), its tests
    those the data needs (each pair's or ray's rows in order up to its
    first occluder, by the plain triangle test).  Returns (text, the timed
    numbers or None)."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import mesh_sweep

    n = O.shape[0]
    key = "flat_occluded" if flat else "clustered_occluded"
    off = sum(c for _, _, c in intersect._type_blocks(geom, skip_tris=True))
    hit0 = intersect.occluded(O, L, analytic_only(geom), shadow, md)
    T = geom.tri_p1.shape[0]
    if flat:
        mask = shadow[off:off + T]
        k, ms_k = sweep_pair(torch, mesh_sweep.flat_occluded, O, L, geom, mask, md)
        p, ms_p = sweep_pair(torch, intersect._flat_occluded, O, L, geom, mask, md)
    else:
        mask = shadow[off:]
        k, ms_k = sweep_pair(torch, mesh_sweep.clustered_occluded, O, L, geom,
                             mask, md, hit0)
        p, ms_p = sweep_pair(torch, intersect._clustered_occluded, O, L, geom,
                             mask, md, hit0)
    eq = float((k == p).float().mean())
    W1["max_abs_err"][key] = max(W1["max_abs_err"][key], float(eq < 1.0))
    require(eq == 1.0, f"W1 {name}: occluded equal on {eq}")
    text = (f"{name}: {n} rays ({float(p.float().mean()):.4f} occluded), "
            f"occluded equal {eq}, wrapper {ms_k:.2f} ms"
            f"{'' if flat else ' (pair search included)'}, plain {ms_p:.1f} ms")
    if not timed:
        return text, None
    rows, tables = mesh_sweep.scene_tables(geom)
    if flat:
        fn = lambda: mesh_sweep._flat_occluded_launch(O, L, geom, mask, md)
        Op, Lp = intersect.planes(O), intersect.planes(L)
        tests = first_hit_tests(torch, (
            (lo, (intersect.intersect_triangles(Op, Lp, *blk)[0] < md[None, :])
             & mask[lo:lo + blk[0].shape[0], None])
            for lo, blk in intersect._blocks(intersect._tri_tables(geom), T,
                                             intersect._tri_block_size(n))), T)
        # rays, max_dist and rows read once, mask bits once, occluded written
        n_bytes = n * 28 + T * (mesh_sweep.ROW * 4 + 1) + n
    else:
        C = geom.tri_cl_lo.shape[0]
        B = intersect.TRI_CLUSTER_SIZE
        sw = one_pair_search(torch, name, O, L, geom, torch.where(hit0, 0.0, md))
        npad = sw["Op"].shape[1]
        mdp = torch.cat([md.to(torch.float32), md.new_zeros((npad - n,))])
        fn = lambda: mesh_sweep.occluded_pairs(sw, rows, tables, mdp, mask)
        require(torch.equal(hit0 | (fn()[:n] > 0), k),
                f"W1 {name}: the timed call differs")
        # each pair a column of its cluster's rows (`_occluded_group`)
        mask_p = torch.cat([mask, mask.new_zeros((B,))])
        j = torch.arange(B, device=O.device)[:, None]
        tests = sum(first_hit_tests(torch, [(0, (
            intersect.intersect_triangles(Oc, Dc, *blk)[0]
            < mdp.index_select(0, r)[None, :]) & mask_p[virt[None, :] + j])], B)
            for r, _, Oc, Dc, blk, virt in intersect._cluster_blocks(geom, sw))
        n_bytes = (pair_bytes(sw, rows, tables, C) + npad * 8  # max_dist, hits
                   + mask.numel())
    more, numbers = w1_time(torch, key, name, fn, tests, n_bytes, ms_p)
    return text + more, numbers


def w2_hold(torch, name, geom, O, D, limit):
    """W2 against the plain search on the card, on rays (O, D) under
    `limit`, one group of tiles: the pairs (rays, records), the visit
    ranks, K and the physical clusters with pairs equal (a share of
    exactly 1.0 over the rays, records and ranks) and one host sync,
    required; then W2 alone through CUDA graphs: its search (five
    launches) and its write (one), the host sync between them left out.
    Returns (text, the timed numbers)."""
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import mesh_pairs
    from raytracer_tpu_torch.probes import common

    groups = intersect._ray_groups(O.shape[0], geom.tri_cl_lo.shape[0])
    require(len(groups) == 1, f"W2 {name}: {len(groups)} ray groups")
    R = groups[0][2]
    # once each first: a search's first call on a shape makes its tables
    # and allocates
    mesh_pairs.cluster_pairs(O, D, geom, limit, R)
    intersect._cluster_pairs(O, D, geom, limit, R)
    before = intersect.SWEEP_STATS["syncs"]
    k, ms_k = sweep_pair(torch, mesh_pairs.cluster_pairs, O, D, geom, limit, R)
    syncs = intersect.SWEEP_STATS["syncs"] - before
    p, ms_p = sweep_pair(torch, intersect._cluster_pairs, O, D, geom, limit, R)
    n_el = eq = 0
    for key in ("rays", "recs", "rank"):
        if k[key].shape == p[key].shape:
            eq += int((k[key] == p[key]).sum())
        n_el += max(k[key].numel(), p[key].numel())
    share = eq / max(n_el, 1)
    K, C, npad = k["rays"].shape[0], geom.tri_cl_lo.shape[0], k["Op"].shape[1]
    W2["max_abs_err"] = max(W2["max_abs_err"], float(n_el - eq))
    require(share == 1.0 and K == p["rays"].shape[0]
            and k["clusters"] == len(p["groups"]),
            f"W2 {name}: equal share {share}, K {K} vs {p['rays'].shape[0]}, "
            f"clusters {k['clusters']} vs {len(p['groups'])}")
    require(syncs == 1, f"W2 {name}: {syncs} host syncs")
    sw = mesh_pairs._prepare(O, D, geom, limit, R)
    mesh_pairs._search(sw)
    sw["rays"] = torch.empty((K,), dtype=torch.int64, device=O.device)
    sw["recs"] = torch.empty_like(sw["rays"])
    search_ms = common.graph_ms(lambda: mesh_pairs._search(sw), W2_REPS)[0]
    write_ms = common.graph_ms(lambda: mesh_pairs._write(sw), W2_REPS)[0] if K else 0.0
    require(torch.equal(sw["rays"], p["rays"]) and torch.equal(sw["recs"], p["recs"])
            and torch.equal(sw["rank"], p["rank"]), f"W2 {name}: the timed calls differ")
    ms = search_ms + write_ms
    # one box test a (record, ray) slot; the rays, limits and record
    # tables read once, the pairs and ranks written once
    tests = C * npad
    n_bytes = npad * 28 + C * 32 + K * 16 + sw["rank"].numel() * 8
    timed = dict(name=name, ms=ms, search_ms=search_ms, write_ms=write_ms,
                 plain_ms=ms_p, wrapper_ms=ms_k, tests=tests, bytes=n_bytes)
    return (f"{name}: {O.shape[0]} rays x {C} records, {K} pairs "
            f"({K / tests:.4f} of the slots), {k['clusters']} clusters with "
            f"pairs, equal share {share} (rays, records, ranks), {syncs} host "
            f"sync, wrapper {ms_k:.2f} ms, plain {ms_p:.1f} ms | W2 alone (CUDA "
            f"graphs) {ms:.4f} ms = search {search_ms:.4f} + write "
            f"{write_ms:.4f}, {tests / ms / 1e6:.1f} G box tests/s"), timed


def w2_phase(torch, dev, build, W, H):
    """W2 against the plain search on the card (`w2_hold`) on the three
    mesh examples' camera rays at the render's chunk (under the analytic
    objects' nearest hit, as nearest_hit passes them) and their first
    hits' shadow rays toward the directional light (under hit0 ? 0 :
    max_dist, as occluded passes them); W1 over W2's pairs against the
    plain fold on the beach ball's (the icosphere's and the instance
    field's are held above).  Prints one line; W2's row is timed at the
    instance field's camera rays."""
    from raytracer_tpu_torch.core.camera import generate_rays
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.utils.constants import MISS_THRESHOLD, SKYBOX_DISTANCE

    holds = []
    for name, _ in MESH_SCENES:
        sc = build(name, W, H)
        data = compile_wavefront(sc)[1].to(dev)
        geom = data.geom
        chunk_spp = plan_chunks(MESH_SPP * sc._diffuse_fan(), W, H)[0]
        O, D = generate_rays(torch.Generator(device=dev).manual_seed(5),
                             sc.camera.params(), W, H, chunk_spp)
        analytic = analytic_only(geom)
        limit = intersect.nearest_hit(O, D, analytic)[0]
        text, timed = w2_hold(torch, f"{name} camera rays", geom, O, D, limit)
        holds.append(text)
        if name == "instances":
            W2["timed"] = timed
        t = intersect.nearest_hit(O, D, geom)[0]
        hit = t < MISS_THRESHOLD
        P = (O + D * t[:, None])[hit]
        L = data.lights.dir_l[0].expand(P.shape).contiguous()
        Os = P + L * (1e-4 * torch.clamp_min(P.abs().amax(dim=-1), 1.0))[:, None]
        md = torch.full((Os.shape[0],), SKYBOX_DISTANCE, device=dev)
        hit0 = intersect.occluded(Os, L, analytic, data.obj.shadow, md)
        holds.append(w2_hold(torch, f"{name} shadow rays", geom, Os, L,
                             torch.where(hit0, 0.0, md))[0])
        if name == "beach_ball":
            holds.append(w1_nearest(torch, "beach ball camera rays", geom, O, D)[0])
            holds.append(w1_occluded(torch, "beach ball shadow rays", geom, Os, L,
                                     data.obj.shadow, md)[0])
        del O, D, Os, L, P, data, geom
        torch.cuda.empty_cache()
    print(f"mesh W2 vs plain: {' | '.join(holds)}", flush=True)


def mesh_phase(torch, dev):
    """The meshes (examples/torch_mesh.py, the wavefront on the card, its
    triangles swept by W1): the three mesh examples at 400x300 x 16 spp
    through Scene.render, repeats bit-equal, every chunk on CUDA, no K1 /
    K2 launch and W1 launched, each profiled by stage with the clustered
    sweep's syncs, device events and rate; W1 against its plain version
    bit for bit on the icosphere's camera rays at the render's chunk,
    their first bounce and shadow rays (clustered and flat) and the
    instance field's camera rays, timed alone at the camera rays; the
    clustered sweep against the flat sweep over the same leaf-ordered
    tables on the same rays; the icosphere on the card against the CPU;
    the instance field against the same field baked into TriangleMesh
    copies; a 20-face flat mesh inside the gate through the solid kernel
    (bit for bit against its plain version) and through the wavefront.
    Returns (the solid kernel's launches in that render, its max abs
    error)."""
    import dataclasses

    import numpy as np
    import raytracer_tpu_torch as T
    import torch_mesh
    from raytracer_tpu_torch.core.camera import generate_rays
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import plan_chunks, route
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import solid_trace as st
    from raytracer_tpu_torch.utils.constants import MISS_THRESHOLD, SKYBOX_DISTANCE

    t_phase = time.perf_counter()
    obj_dir = WORK / "mesh"
    obj_dir.mkdir(parents=True, exist_ok=True)
    build = lambda name, W, H, **kw: torch_mesh.SCENES[name](W, H, obj_dir=obj_dir,
                                                            **kw)
    W, H = MESH_W, MESH_H

    # ---- the three mesh examples through Scene.render ----
    for name, n in MESH_SCENES:
        sc = build(name, W, H)
        static, _, settings = sc._settings_for_render()
        data = compile_wavefront(sc)[1]
        require(route(static, settings) == "wavefront",
                f"{name}: not the wavefront route")
        chunk, n_chunks = plan_chunks(MESH_SPP * sc._diffuse_fan(), W, H)
        runs, devices, k_launches, peak, w1, w2, w3 = routed_renders(
            torch, dev, sc, MESH_SPP, n, seed=7)
        img, stats, _ = runs[-1]
        walls = [w for _, _, w in runs]
        wall = statistics.median(walls[1:])
        bit_equal = all(np.array_equal(r[0], runs[0][0]) for r in runs[1:])
        n_rows = data.geom.tri_p1.shape[0]
        print(f"mesh: {name} {W}x{H} x {MESH_SPP} spp through Scene.render, "
              f"{static.n_tris} triangle ids on {n_rows} table rows, "
              f"{data.geom.tri_cl_lo.shape[0]} cluster records, "
              f"{data.geom.inst_rot.shape[0] - 1 if data.geom.inst_rot.shape[0] else 0} "
              f"instances, corner attributes {static.tri_interp} | {n_chunks} "
              f"chunks of {chunk} spp, {settings.max_bounces} bounces, "
              f"{len(devices)} wavefront chunks on {sorted(set(devices))}, "
              f"K1 / K2 launches {k_launches}, W1 launches {w1} ({w1 // n} a "
              f"render), W2 launches {w2} ({w2 // n} a render), W3 occluded "
              f"launches {w3['analytic_occluded']} | wall "
              f"{wall:.4f} s (median of "
              f"{n - 1} after a warm-up; {', '.join(f'{w:.4f}' for w in walls)}) | "
              f"rays_traced {stats['rays_traced']} | "
              f"{stats['rays_traced'] / wall / 1e6:.2f} Mrays/s | peak "
              f"{peak:.2f} GiB | image mean {img.mean():.6f} | {n} renders of "
              f"seed 7 bit-equal: {bit_equal}", flush=True)
        require(devices == ["cuda"] * (n * n_chunks),
                f"{name}: wavefront chunks ran on {devices}")
        require(k_launches == 0, f"{name}: {k_launches} K1 / K2 launches")
        require(w1 > 0, f"{name}: W1 never launched")
        require(w2 > 0, f"{name}: W2 never launched")
        require(w3["analytic_occluded"] > 0, f"{name}: W3's occluded entry never "
                "launched")
        require(bit_equal, f"{name}: the same seed gave different images")
        require(img.shape == (H, W, 3) and bool(np.isfinite(img).all())
                and img.mean() > 0, f"{name}: image not finite, empty or of "
                "the wrong shape")
        stage_profile(torch, dev, f"{name} {W}x{H} x {MESH_SPP} spp", sc,
                      MESH_SPP)
        del runs
        torch.cuda.empty_cache()

    # ---- W1 against its plain version, and the clustered sweep against
    # the flat sweep, on the card: the icosphere's camera rays at the
    # render's chunk, their first bounce and shadow rays ----
    sc = build("icosphere", W, H)
    static, data = compile_wavefront(sc)
    data = data.to(dev)
    geom = data.geom
    empty = dict(tri_cl_lo=geom.tri_cl_lo[:0], tri_cl_hi=geom.tri_cl_hi[:0],
                 tri_cl_start=geom.tri_cl_start[:0],
                 tri_cl_virt=geom.tri_cl_virt[:0])
    flat = dataclasses.replace(geom, **empty)
    chunk_spp = plan_chunks(MESH_SPP * sc._diffuse_fan(), W, H)[0]
    g = torch.Generator(device=dev).manual_seed(3)
    O, D = generate_rays(g, sc.camera.params(), W, H, chunk_spp)
    rows, holds = [], []
    for what in ("camera rays", "first bounce"):
        text, timed = w1_nearest(torch, f"icosphere {what}", geom, O, D,
                                 timed=what == "camera rays")
        holds.append(text)
        if timed:
            W1["timed"]["clustered_nearest"] = timed
        (t_c, o_c, id_c), ms_c = sweep_pair(torch, intersect.nearest_hit, O, D, geom)
        (t_f, o_f, id_f), ms_f = sweep_pair(torch, intersect.nearest_hit, O, D, flat)
        t_eq = bool(torch.equal(t_c, t_f))
        win = float(((id_c == id_f) & (o_c == o_f)).float().mean())
        hit = t_c < MISS_THRESHOLD
        rows.append(f"{what}: {O.shape[0]} rays ({float(hit.float().mean()):.4f} "
                    f"hit), t bit-equal {t_eq}, winner equal {win:.6f}, "
                    f"clustered {ms_c:.1f} ms vs flat {ms_f:.1f} ms")
        require(t_eq, f"clustered vs flat, {what}: t differs")
        require(win >= WINNER_RATE, f"clustered vs flat, {what}: winners {win}")
        O, D = mirror_bounce(torch, geom, static, O, D, t_c, o_c, id_c)
    # shadow rays toward the directional light from the first bounce's hits
    L = data.lights.dir_l[0].expand(O.shape).contiguous()
    md = torch.full((O.shape[0],), SKYBOX_DISTANCE, device=dev)
    text, W1["timed"]["clustered_occluded"] = w1_occluded(
        torch, "icosphere shadow rays", geom, O, L, data.obj.shadow, md,
        timed=True)
    holds.append(text)
    holds.append(w1_occluded(torch, "icosphere shadow rays, flat", flat, O, L,
                             data.obj.shadow, md, flat=True)[0])
    occ_c, ms_c = sweep_pair(torch, intersect.occluded, O, L, geom,
                             data.obj.shadow, md)
    occ_f, ms_f = sweep_pair(torch, intersect.occluded, O, L, flat,
                             data.obj.shadow, md)
    occ_eq = float((occ_c == occ_f).float().mean())
    rows.append(f"shadow rays: {O.shape[0]} rays ({float(occ_c.float().mean()):.4f} "
                f"occluded), equal {occ_eq:.6f}, clustered {ms_c:.1f} ms vs "
                f"flat {ms_f:.1f} ms")
    print(f"mesh clustered vs flat sweep (both W1): icosphere, {static.n_tris} "
          f"triangles in leaf order, {geom.tri_cl_lo.shape[0]} clusters | "
          + " | ".join(rows), flush=True)
    require(occ_eq >= WINNER_RATE, f"clustered vs flat, shadow rays: {occ_eq}")
    del O, D, L, md, data, geom, flat
    torch.cuda.empty_cache()
    # the instance field's camera rays
    sc = build("instances", W, H)
    data = compile_wavefront(sc)[1].to(dev)
    chunk_spp = plan_chunks(MESH_SPP * sc._diffuse_fan(), W, H)[0]
    O, D = generate_rays(torch.Generator(device=dev).manual_seed(4),
                         sc.camera.params(), W, H, chunk_spp)
    text, timed = w1_nearest(torch, "instance field camera rays", data.geom, O,
                             D, timed=True)
    holds.append(text)
    print(f"mesh W1 vs plain: {' | '.join(holds)}", flush=True)
    del O, D, data
    torch.cuda.empty_cache()
    w2_phase(torch, dev, build, W, H)

    # ---- the icosphere on the card against the CPU ----
    sc = build("icosphere", CPU_W, CPU_H)
    var = 2 * chunk_var(torch, dev, sc, MESH_SPP)
    card, _, card_wall = timed_render(torch, dev, sc, MESH_SPP, seed=5)
    t0 = time.perf_counter()
    cpu = sc.render(samples_per_pixel=MESH_SPP, output="linear", device="cpu",
                    seed=5)
    cpu_wall = time.perf_counter() - t0
    # the scene draws nothing past the camera's lattice jitter (glossy and
    # emissive only), so the two renders also agree pixel by pixel, to
    # rounding
    diff = np.abs(card - cpu)
    print(f"mesh card vs CPU: icosphere {CPU_W}x{CPU_H} x {MESH_SPP} spp | card "
          f"{card_wall:.4f} s, CPU {cpu_wall:.4f} s ({torch.get_num_threads()} "
          f"threads) | {z_hold('icosphere card vs CPU', card, cpu, var, CPU_W, CPU_H)}"
          f" | pixels max abs diff {diff.max():.3e}, within 1e-4: "
          f"{float((diff <= 1e-4).all(axis=-1).mean()):.6f}", flush=True)

    # ---- the instance field against baked copies ----
    sc_i, sc_b = build("instances", W, H), build("instances", W, H, baked=True)
    var = chunk_var(torch, dev, sc_i, INST_SPP) + chunk_var(torch, dev, sc_b,
                                                            INST_SPP)
    img_i, _, wall_i = timed_render(torch, dev, sc_i, INST_SPP, seed=3)
    img_b, _, wall_b = timed_render(torch, dev, sc_b, INST_SPP, seed=3)
    st_b = sc_b._settings_for_render()[0]
    sc_i.settings = T.RenderSettings(use_pallas="always")
    try:
        sc_i.render(1, device=dev)
        raised = False
    except ValueError:
        raised = True
    print(f"mesh instanced vs baked: 48 instances of a 1,280-face icosphere vs "
          f"48 TriangleMesh copies ({st_b.n_tris} triangles, clustered in one "
          f"region) {W}x{H} x {INST_SPP} spp | instanced {wall_i:.4f} s, baked "
          f"{wall_b:.4f} s | {z_hold('instanced vs baked', img_i, img_b, var, W, H)}"
          f" | use_pallas='always' raises: {raised}", flush=True)
    require(raised, "use_pallas='always' rendered an instanced scene")
    torch.cuda.empty_cache()

    # ---- a flat 20-face mesh inside the gate: the solid kernel ----
    sc = build("icosphere", W, H, subdiv=0, smooth=None)
    static, _, settings = sc._settings_for_render()
    require(route(static, settings) == "solid", "the 20-face mesh does not take "
            "the solid kernel")
    _, _, args = chunk_args(torch, dev, sc, MESH_SPP, [20261017, 4242, 0])
    max_err, line = solid_check(torch, "20-face mesh", args)
    var = (chunk_var(torch, dev, sc, MESH_SPP, solid=True)
           + chunk_var(torch, dev, sc, MESH_SPP))
    st.solid_trace_chunk.launches = 0
    k_img, _, k_wall = timed_render(torch, dev, sc, MESH_SPP, seed=3)
    k_launches = st.solid_trace_chunk.launches
    sc.settings = T.RenderSettings(use_pallas="never")
    w_img, _, w_wall = timed_render(torch, dev, sc, MESH_SPP, seed=3)
    require(st.solid_trace_chunk.launches == k_launches, "the wavefront route "
            "launched the solid kernel")
    require(k_launches >= 1, "the 20-face mesh launched no solid kernel")
    print(f"mesh inside the gate: 20-face flat icosphere ({static.n_objects} "
          f"objects) {W}x{H} x {MESH_SPP} spp | solid kernel vs plain, one chunk: "
          f"{line} | solid kernel route {k_wall:.4f} s ({k_launches} launches), "
          f"wavefront {w_wall:.4f} s | "
          f"{z_hold('20-face mesh kernel vs wavefront', k_img, w_img, var, W, H)}"
          f" | phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k_launches, max_err


FEAT_W, FEAT_H = 400, 300             # the features' frames
FEAT_CPU_W, FEAT_CPU_H, FEAT_CPU_SPP = 100, 75, 16   # card against CPU
NMAP_CPU = 64, 48, 8                  # the normal maps' (a flat mesh sweep)
ENV_IS_SPP, CUSTOM_SPP, NMAP_SPP = 64, 32, 16
DENOISE_W, DENOISE_SPP = 400, 16      # render_denoised Cornell (and W == H)
BLUR_SPP = 64
ODS_W, ODS_H, ODS_SPP = 512, 256, 32


def spied(torch, module, names, fn):
    """fn() with both kernels' launch counts set to 0 just before and read
    just after, and the first call of each wrapper named in `names` (as
    `module` calls it) captured.  Returns (fn's result, (solid, record)
    launches, {name: first args}, wall s, peak GiB)."""
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st

    real = {w: getattr(module, w) for w in names}
    first = {}

    def spy(w):
        def call(*args):
            first.setdefault(w, args)
            return real[w](*args)
        return call

    for w in names:
        setattr(module, w, spy(w))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        st.solid_trace_chunk.launches = 0
        rt.record_trace_chunk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = (st.solid_trace_chunk.launches, rt.record_trace_chunk.launches)
    finally:
        for w in names:
            setattr(module, w, real[w])
    return out, n, first, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def card_vs_cpu(torch, dev, name, build, spp, draws=True,
                size=(FEAT_CPU_W, FEAT_CPU_H)):
    """A feature scene at `size` on the card against the same render on
    the CPU: image and region means within 4 standard
    errors (the variance from one card chunk); a scene that draws nothing
    past the camera's lattice jitter (draws=False) renders the same
    pixels on both, so it is held pixel by pixel, within 1e-4 of the
    frame's largest value.  Returns the line."""
    import numpy as np

    w, h = size
    sc = build(w, h)
    card, _, card_wall = timed_render(torch, dev, sc, spp, seed=5)
    t0 = time.perf_counter()
    cpu = sc.render(samples_per_pixel=spp, output="linear", device="cpu",
                    seed=5)
    cpu_wall = time.perf_counter() - t0
    line = (f"card vs CPU {w}x{h} x {spp} spp: card {card_wall:.4f} s, CPU "
            f"{cpu_wall:.4f} s | ")
    if draws:
        var = 2 * chunk_var(torch, dev, sc, spp)
        return line + z_hold(f"{name} card vs CPU", card, cpu, var, w, h)
    diff = float(np.abs(card - cpu).max())
    tol = 1e-4 * max(1.0, float(np.abs(cpu).max()))
    require(diff <= tol, f"{name} card vs CPU: pixels differ by {diff}")
    return line + (f"nothing drawn past the jitter: pixels max abs diff "
                   f"{diff:.3e} (held to {tol:.1e}), image mean "
                   f"{card.mean():.6f} vs {cpu.mean():.6f}")


def features_phase(torch, dev, cornell_img):
    """The features on top of the wavefront and the kernels, one line a
    part with its wall and peak memory: environment importance sampling
    (with against without, and card against CPU), custom materials and
    normal maps (card against CPU), render_denoised on Cornell (the solid
    kernel, then the AOV pass and the filter; display MSE against the
    main path's 256-spp image), render_motion_blur (each slice's chunks on
    the record kernel, repeats bit-equal, the first slice chunk bit-equal
    to the plain version), render_ods (ipd=0 eyes bit-equal), and the
    command line as processes.  Returns the (solid, record) launches in
    these runs and the max abs errors of their held chunks."""
    import numpy as np
    import raytracer_tpu_torch as T
    import torch_features
    from raytracer_tpu_torch import animation
    from raytracer_tpu_torch.core import scene as scene_mod
    from raytracer_tpu_torch.core.camera import generate_rays
    from raytracer_tpu_torch.core.compile import compile_wavefront
    from raytracer_tpu_torch.core.scene import route
    from raytracer_tpu_torch.geometry import intersect
    from raytracer_tpu_torch.ops import mesh_sweep
    from raytracer_tpu_torch.parallel import sharded as sharded_mod
    from raytracer_tpu_torch.utils.colour import srgb_linear_to_srgb
    from raytracer_tpu_torch.utils.constants import MISS_THRESHOLD, SKYBOX_DISTANCE
    from torch_cornellbox import build_cornell

    t_phase = time.perf_counter()
    launches = [0, 0]
    errs = [0.0, 0.0]
    W, H = FEAT_W, FEAT_H
    on_wavefront = lambda sc: route(*sc._settings_for_render()[::2]) == "wavefront"

    # ---- environment importance sampling: with and without the tables ----
    # with the tables the scene is the wavefront's; without, the record
    # kernel's (its first chunk held against the plain version)
    imgs = {}
    for is_ in (True, False):
        sc = torch_features.env_is(W, H, importance_sampled=is_)
        static, _, settings = sc._settings_for_render()
        path = route(static, settings)
        require(path == ("wavefront" if is_ else "record"),
                f"env_is: route {path}")
        require(compile_wavefront(sc)[0].env_is_shape == ((128, 256) if is_
                                                          else (0, 0)),
                "env_is: alias grid")
        (img, var), n, first, wall, peak = spied(
            torch, sharded_mod, ("record_trace_chunk",), lambda: sc.render(
                ENV_IS_SPP, output="linear", with_variance=True, device=dev,
                seed=3))
        _, n_chunks = scene_mod.plan_chunks(ENV_IS_SPP * sc._diffuse_fan(),
                                            W, H)
        require(n == (0, 0 if is_ else n_chunks), f"env_is: launches {n}")
        require(bool(np.isfinite(img).all()), "env_is: non-finite image")
        if not is_:
            launches[1] += n[1]
            errs[1] = max(errs[1], hold_chunk(
                torch, "env_is without the tables, first chunk", False,
                first["record_trace_chunk"]))
        imgs[is_] = (img, var, wall, peak)
    (a, va, wa, pa), (b, vb, wb, pb) = imgs[True], imgs[False]
    var = (chunk_var(torch, dev, torch_features.env_is(W, H), ENV_IS_SPP)
           + chunk_var(torch, dev, torch_features.env_is(
               W, H, importance_sampled=False), ENV_IS_SPP))
    line = z_hold("env_is with vs without", a, b, var, W, H)
    pv_is, pv_plain = float(va.mean()), float(vb.mean())
    print(f"features env IS: example_env_is {W}x{H} x {ENV_IS_SPP} spp, with "
          f"the alias tables (wavefront) {wa:.4f} s ({pa:.2f} GiB), without "
          f"(record kernel) {wb:.4f} s ({pb:.2f} GiB) | {line} | mean pixel variance of the mean "
          f"{pv_is:.6g} with vs {pv_plain:.6g} without "
          f"({pv_plain / max(pv_is, 1e-30):.1f}x)", flush=True)
    require(pv_is < pv_plain, "env IS: the pixel variance is not lower")
    print("features env IS " + card_vs_cpu(
        torch, dev, "env_is", lambda w, h: torch_features.env_is(w, h),
        FEAT_CPU_SPP), flush=True)

    # ---- custom materials and normal maps: the card against the CPU ----
    for name, build, spp, draws, cpu in (
            ("custom materials", torch_features.custom_material, CUSTOM_SPP,
             False, (FEAT_CPU_W, FEAT_CPU_H, FEAT_CPU_SPP)),
            ("normal maps", torch_features.normal_mapped, NMAP_SPP, True,
             NMAP_CPU)):
        sc = build(W, H)
        require(on_wavefront(sc), f"{name}: not the wavefront route")
        mesh_sweep.reset_launches()
        img, n, _, wall, peak = spied(torch, scene_mod, (), lambda: sc.render(
            spp, output="linear", device=dev, seed=1))
        w1 = mesh_sweep.launches()
        require(n == (0, 0) and bool(np.isfinite(img).all()),
                f"{name}: launches {n} or non-finite image")
        parent = ""
        if name == "normal maps":
            # its 192 faces take the flat sweep: W1's flat entries
            require(w1 > 0, "normal maps: W1 never launched")
            w1_launches(mesh_sweep)
            parent = (f" (the plain sweep: {NMAP_PLAIN[0]} s, "
                      f"{NMAP_PLAIN[1]} GiB), W1 launches {w1}")
        print(f"features {name}: {W}x{H} x {spp} spp {wall:.4f} s, peak "
              f"{peak:.2f} GiB{parent}, image mean {img.mean():.6f} | "
              + card_vs_cpu(torch, dev, name, build, cpu[2], draws, cpu[:2]),
              flush=True)
        if name == "normal maps":
            static, data = compile_wavefront(sc)
            data = data.to(dev)
            chunk_spp = scene_mod.plan_chunks(spp * sc._diffuse_fan(), W, H)[0]
            O, D = generate_rays(torch.Generator(device=dev).manual_seed(5),
                                 sc.camera.params(), W, H, chunk_spp)
            text, W1["timed"]["flat_nearest"] = w1_nearest(
                torch, "camera rays", data.geom, O, D, flat=True, timed=True)
            t, _, _ = intersect.nearest_hit(O, D, data.geom)
            hit = t < MISS_THRESHOLD
            O = (O + D * t[:, None])[hit]
            L = data.lights.dir_l[0].expand(O.shape).contiguous()
            O = O + L * 1e-4
            md = torch.full((O.shape[0],), SKYBOX_DISTANCE, device=dev)
            shadow, W1["timed"]["flat_occluded"] = w1_occluded(
                torch, "shadow rays from the hits", data.geom, O, L,
                data.obj.shadow, md, flat=True, timed=True)
            print(f"features normal maps, W1's flat sweep vs plain: "
                  f"{data.geom.tri_p1.shape[0]} triangle rows | {text} | "
                  f"{shadow}", flush=True)
            del data, O, D, t, L, md

    # ---- render_denoised: Cornell through the solid kernel, the AOV pass
    # and the filter, against the main path's 256-spp image ----
    sc = build_cornell(DENOISE_W, DENOISE_W)
    fan = sc._diffuse_fan()
    dn, n, first, wall, peak = spied(
        torch, sharded_mod, ("solid_trace_chunk", "record_trace_chunk"),
        lambda: sc.render_denoised(DENOISE_SPP, output="linear", device=dev))
    raw = sc.render(DENOISE_SPP, output="linear", device=dev)
    chunk, n_chunks = scene_mod.plan_chunks(DENOISE_SPP * fan, DENOISE_W,
                                            DENOISE_W)
    require(n == (n_chunks, 0), f"render_denoised: launches {n}, not "
            f"({n_chunks}, 0)")
    errs[0] = max(errs[0], hold_chunk(torch, "render_denoised, first chunk",
                                      True, first["solid_trace_chunk"]))
    launches[0] += n[0]
    disp = lambda x: srgb_linear_to_srgb(torch.from_numpy(
        np.ascontiguousarray(x, np.float32))).numpy()
    mse = lambda x: float(((disp(x) - disp(cornell_img)) ** 2).mean())
    m_raw, m_dn = mse(raw), mse(dn)
    print(f"features render_denoised: Cornell {DENOISE_W}x{DENOISE_W} x "
          f"{DENOISE_SPP} spp ({n[0]} solid kernel launches, {n_chunks} chunks "
          f"of {chunk} spp), the AOV pass at {min(16, max(4, DENOISE_SPP))} spp "
          f"and the filter in {wall:.4f} s, peak {peak:.2f} GiB | display MSE "
          f"against the {SPP}-spp render: raw {m_raw:.6g}, denoised "
          f"{m_dn:.6g} ({m_raw / max(m_dn, 1e-30):.1f}x lower)", flush=True)
    require(m_dn < m_raw, "render_denoised: the MSE did not drop")

    # ---- render_motion_blur: each slice on the record kernel ----
    sc = torch_features.motion_blur(W, H)
    plan = animation._FramePlan(sc, -(-BLUR_SPP // 32), torch_features.fly,
                                0.0, 0, dev, 32)
    require(plan.path == "record", f"motion blur: route {plan.path}")
    blurs = []
    for _ in range(2):
        sc = torch_features.motion_blur(W, H)
        blurs.append(spied(torch, animation, ("record_trace_chunk",),
                           lambda: T.render_motion_blur(
                               sc, BLUR_SPP, torch_features.fly,
                               output="linear", device=dev)))
    (img, n, first, wall, peak), (img2, n2, _, wall2, _) = blurs
    slices = min(32, BLUR_SPP)
    require(n == n2 == (0, slices * plan.n_chunks),
            f"motion blur: launches {n}, {n2}, not {slices} slices x "
            f"{plan.n_chunks} chunks")
    same = bool(np.array_equal(img, img2))
    require(same, "motion blur: two renders of one seed differ")
    require(bool(np.isfinite(img).all()), "motion blur: non-finite image")
    errs[1] = max(errs[1], hold_chunk(torch, "motion blur, first slice chunk",
                                      False, first["record_trace_chunk"]))
    launches[1] += n[1] + n2[1]
    print(f"features motion blur: example_motion_blur {W}x{H} x {BLUR_SPP} "
          f"spp, {slices} slices x {plan.n_chunks} chunk of {plan.chunk} spp "
          f"({n[1]} record kernel launches a render) in {wall:.4f} s, "
          f"{wall2:.4f} s, peak {peak:.2f} GiB | two renders bit-equal: "
          f"{same} | image mean {img.mean():.6f}", flush=True)

    # ---- render_ods: ipd 0 gives two identical eyes ----
    sc = torch_features.vr(ODS_W, ODS_H)
    (left, right), n, _, wall0, peak = spied(
        torch, scene_mod, (), lambda: T.render_ods(
            sc, ODS_SPP, ipd=0.0, layout="separate", output="linear",
            device=dev))
    same = bool(np.array_equal(left, right))
    pair, n2, _, wall, _ = spied(torch, scene_mod, (), lambda: T.render_ods(
        sc, ODS_SPP, ipd=0.2, output="np", device=dev))
    require(same, "ODS: the ipd=0 eyes differ")
    require(n == n2 == (0, 0), f"ODS: kernel launches {n}, {n2}")
    require(pair.shape == (2 * ODS_H, ODS_W, 3) and bool(np.isfinite(left).all()),
            "ODS: frame shape or values")
    print(f"features ODS: example_vr {ODS_W}x{ODS_H} x {ODS_SPP} spp a eye | "
          f"ipd 0 {wall0:.4f} s, eyes bit-equal: {same} | ipd 0.2 top-bottom "
          f"{wall:.4f} s, peak {peak:.2f} GiB, image mean {left.mean():.6f}",
          flush=True)

    # ---- the command line, as processes on the card ----
    out = WORK / "cli_scene.png"
    for args in (["devices"],
                 ["render", str(ROOT / "examples" / "example_scene.json"),
                  "--spp", "16", "-o", str(out)]):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "raytracer_tpu_torch",
                              *args], cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        wall = time.perf_counter() - t0
        require(res.returncode == 0, f"CLI {args[0]}: rc {res.returncode}: "
                f"{res.stderr[-2000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        if args[0] == "devices":
            require(line["device_count"] >= 1, f"CLI devices: {line}")
        else:
            require(line["device"] == "cuda" and out.exists(),
                    f"CLI render: {line}")
        print(f"features CLI: python -m raytracer_tpu_torch {' '.join(args[:1])}"
              f" in {wall:.2f} s (a process) | {json.dumps(line)}", flush=True)
    print(f"features phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return tuple(launches), tuple(errs)


DIFF_W, DIFF_H, DIFF_SPP = 96, 72, 8      # the inverse-rendering scene
FD_EPS, FD_RTOL = 1e-3, 0.05              # tests/test_diff.py's check
SMALL_W, SMALL_H, SMALL_SPP = 100, 100, 16   # Cornell over a 2x2 mesh
F1_W, F1_H, F1_SPP, F1_LIGHTS = 160, 120, 4, 1200
MP_TIMEOUT = 300                          # each spawned process
MESH_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)     # the 4x1 Cornell hold over seeds


def diff_mesh_phase(torch, dev, cornell_img, cornell_wall):
    """diff.py and multi-device rendering on the card, one line a part:
    differentiable_render of the inverse-rendering scene (forward and
    forward + backward walls, peak memory beside one forward chunk's, the
    IoR gradient against a central difference, two backward passes
    compared); Cornell at the main path's size over a 4x1 mesh of cuda:0
    shards (K1 on each: launches = 4 x chunks, the first shard chunk bit
    for bit against its plain version, image and regions within 4
    standard errors of the unsharded render, wall beside it; at eight more
    seeds the seed-averaged difference within 4 standard errors of its
    scatter, beside two unsharded renders' as calibration); a 1x1 mesh
    bit-equal to the unsharded render; a 2x2 mesh (the wavefront on each
    band) within 4 standard errors; an emissive scene pixel-equal across
    1x1, 4x1 and 2x2; F1: the 1,200-light scene through K1 and its
    textured variant through K2 past 48 KB of shared memory, each first
    chunk bit for bit against its plain version, with the opted-in bytes,
    blocks an SM and chunk time; two gloo processes on cuda:0 whose
    frames agree with each other and with one process.  Returns the
    (solid, record) launches in these runs and the max abs errors of
    their held chunks."""
    import os
    import socket
    import numpy as np
    import raytracer_tpu_torch as T
    import torch_features
    from raytracer_tpu_torch.core import scene as scene_mod
    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from raytracer_tpu_torch.ops import record_trace as rt
    from raytracer_tpu_torch.ops import solid_trace as st
    from raytracer_tpu_torch.parallel import sharded as sharded_mod
    from raytracer_tpu_torch.parallel.multihost import render_multihost
    from raytracer_tpu_torch.parallel.sharded import make_mesh
    from torch_cornellbox import build_cornell
    from raytracer_tpu_torch.ops import analytic_sweep, mesh_sweep
    from torch_inverse_rendering import TRUE_N, build_mesh_scene, build_scene

    t_phase = time.perf_counter()
    launches, errs = [0, 0], [0.0, 0.0]

    # ---- gradients through the wavefront ----
    fn, data = differentiable_render(build_scene(TRUE_N, DIFF_W, DIFF_H),
                                     DIFF_SPP, seed=0, device=dev)
    n0 = data.mats.refr_n_re

    def loss(n):
        return torch.mean(fn(update_materials(data, refr_n_re=n)) ** 2)

    def measured(f):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    def grad():
        x = n0.clone().requires_grad_(True)
        return torch.autograd.grad(loss(x), x)[0]

    with torch.no_grad():
        fn(data)                                    # warm-up
        img, fwd_s, fwd_gib = measured(lambda: fn(data))
    analytic_sweep.reset_launches()
    g1, fb_s, fb_gib = measured(grad)
    g2, fb2_s, _ = measured(grad)
    w3 = w3_launches(analytic_sweep)
    with torch.no_grad():
        e = torch.zeros_like(n0)
        e[0, 0] = FD_EPS
        fd = float((loss(n0 + e) - loss(n0 - e)) / (2 * FD_EPS))
    same = bool(torch.equal(g1, g2))
    gdiff = float((g1 - g2).abs().max())
    rel = gdiff / max(float(g1.abs().max()), 1e-30)
    print(f"diff: differentiable_render {DIFF_W}x{DIFF_H} x {DIFF_SPP} spp "
          f"(inverse-rendering scene, one chunk) | forward {fwd_s:.4f} s, peak "
          f"{fwd_gib:.3f} GiB | forward + backward {fb_s:.4f} s ({fb2_s:.4f} "
          f"s again), peak {fb_gib:.3f} GiB ({fb_gib / max(fwd_gib, 1e-9):.1f}x "
          f"the forward chunk's) | d loss / d refr_n_re[0,0] {float(g1[0, 0]):.6e}"
          f", central difference {fd:.6e} (eps {FD_EPS}) | two backward passes "
          f"bit-equal {same}, max abs diff {gdiff:.3e} ({rel:.3e} of the "
          f"largest) | W3 launches {w3['analytic_nearest']} nearest in the two "
          f"(its winners' t recomputed for autograd)", flush=True)
    require(bool(torch.isfinite(img).all()), "diff: non-finite image")
    require(bool(torch.isfinite(g1).all()), "diff: non-finite gradient")
    require(float(g1.abs().max()) > 1e-5, "diff: the gradient is zero")
    require(bool(np.isclose(fd, float(g1[0, 0]), rtol=FD_RTOL)),
            f"diff: gradient {float(g1[0, 0])} vs central difference {fd}")
    require(same, f"diff: two backward passes differ by {gdiff:.3e} (F4)")
    require(w3["analytic_nearest"] > 0, "diff: W3 never launched")
    del fn, data, img, g1, g2
    torch.cuda.empty_cache()

    # ---- the gradient through W1: the same scene with the glass sphere as
    # a clustered icosphere mesh (1,280 faces); W1 has no backward, so
    # nearest_hit recomputes its winners' t (intersect.winner_t) ----
    (WORK / "mesh").mkdir(parents=True, exist_ok=True)
    fn, data = differentiable_render(
        build_mesh_scene(TRUE_N, DIFF_W, DIFF_H, WORK / "mesh"), DIFF_SPP,
        seed=0, device=dev)
    require(data.geom.tri_cl_lo.shape[0] > 0, "diff mesh: no clusters")
    n0 = data.mats.refr_n_re
    mesh_sweep.reset_launches()
    gm, fbm_s, fbm_gib = measured(grad)
    w1 = w1_launches(mesh_sweep)
    with torch.no_grad():
        e = torch.zeros_like(n0)
        e[0, 0] = FD_EPS
        fd = float((loss(n0 + e) - loss(n0 - e)) / (2 * FD_EPS))
    print(f"diff mesh: differentiable_render {DIFF_W}x{DIFF_H} x {DIFF_SPP} spp "
          f"of the inverse-rendering scene with a 1,280-face glass icosphere "
          f"({data.geom.tri_cl_lo.shape[0]} clusters) | forward + backward "
          f"{fbm_s:.4f} s, peak {fbm_gib:.3f} GiB, W1 launches {w1} | d loss / "
          f"d refr_n_re[0,0] {float(gm[0, 0]):.6e}, central difference "
          f"{fd:.6e} (eps {FD_EPS}, rtol {FD_RTOL})", flush=True)
    require(w1 > 0, "diff mesh: W1 never launched")
    require(bool(torch.isfinite(gm).all()), "diff mesh: non-finite gradient")
    require(float(gm.abs().max()) > 1e-5, "diff mesh: the gradient is zero")
    require(bool(np.isclose(fd, float(gm[0, 0]), rtol=FD_RTOL)),
            f"diff mesh: gradient {float(gm[0, 0])} vs central difference {fd}")
    del fn, data, gm
    torch.cuda.empty_cache()

    # ---- Cornell over a 4x1 mesh of cuda:0 shards: K1 on each ----
    sc = build_cornell(W, H)
    m41 = make_mesh(4, 1, [dev] * 4)
    (img4, stats4), n, first, wall4, peak4 = spied(
        torch, sharded_mod, ("solid_trace_chunk",), lambda: sc.render(
            SPP, output="linear", return_stats=True, mesh=m41))
    eff_dev = -(-SPP * sc._diffuse_fan() // 4)
    chunk_dev, n_chunks = scene_mod.plan_chunks(eff_dev, W, H)
    require(n == (4 * n_chunks, 0), f"4x1 Cornell: launches {n}, want "
            f"{4 * n_chunks} K1")
    launches[0] += n[0]
    errs[0] = max(errs[0], hold_chunk(torch, "Cornell 4x1, first shard chunk",
                                      True, first["solid_trace_chunk"]))
    st.solid_trace_chunk.launches = 0
    _, _, wall4b = timed_render(torch, dev, sc, SPP, mesh=m41)
    launches[0] += st.solid_trace_chunk.launches
    var = 2 * chunk_var(torch, dev, sc, SPP, solid=True)
    line = z_hold("Cornell 4x1 vs unsharded", img4, cornell_img, var, W, H)
    print(f"mesh: Cornell {W}x{H} x {SPP} spp over 4x1 cuda:0 shards, "
          f"{n_chunks} chunks of 4 x {chunk_dev} spp ({stats4['samples']} "
          f"samples), {n[0]} K1 launches | wall {wall4:.4f} s, {wall4b:.4f} s "
          f"again, unsharded {cornell_wall:.4f} s | peak {peak4:.2f} GiB | "
          f"{line}", flush=True)
    require(bool(np.isfinite(img4).all()), "4x1 Cornell: non-finite image")

    # ---- the 4x1 hold over seeds: sharded against unsharded at each seed,
    # beside two unsharded renders of other seeds (no bias possible there)
    # as the calibration of the same statistic ----
    pairs = {"4x1 vs unsharded": [], "unsharded vs unsharded": []}
    st.solid_trace_chunk.launches = 0
    for s in MESH_SEEDS:
        a = sc.render(SPP, output="linear", seed=s, mesh=m41)
        b = sc.render(SPP, output="linear", seed=s, device=dev)
        c = sc.render(SPP, output="linear", seed=s + 1000, device=dev)
        require(all(bool(np.isfinite(x).all()) for x in (a, b, c)),
                f"Cornell seed {s}: non-finite image")
        pairs["4x1 vs unsharded"].append(image_regions(a, W, H)
                                         - image_regions(b, W, H))
        pairs["unsharded vs unsharded"].append(image_regions(b, W, H)
                                               - image_regions(c, W, H))
    launches[0] += st.solid_trace_chunk.launches
    parts, ts = [], {}
    for name, d in pairs.items():
        d = np.stack(d)                             # (seeds, regions + 1)
        z = np.abs(d) / np.sqrt(var)
        # the mean difference over seeds against its scatter: a bias shows
        # here as sqrt(seeds) times its per-seed size
        t = ts[name] = (np.abs(d.mean(0))
                        / (d.std(0, ddof=1) / np.sqrt(len(d))))
        parts.append(f"{name}: per seed image z " + ", ".join(
            f"{x:.2f}" for x in z[:, -1]) + " | regions max z " + ", ".join(
            f"{x:.2f}" for x in z[:, :-1].max(1)) + f" | over the seeds "
            f"image t {t[-1]:.2f}, regions max t {t[:-1].max():.2f}")
    print(f"mesh: Cornell {W}x{H} x {SPP} spp at seeds {list(MESH_SEEDS)} | "
          + " | ".join(parts), flush=True)
    require((ts["4x1 vs unsharded"] < 4).all(),
            f"Cornell 4x1 over seeds: t {ts['4x1 vs unsharded']}")

    # ---- a 1x1 mesh: the unsharded render bit for bit ----
    st.solid_trace_chunk.launches = 0
    img1 = sc.render(SPP, output="linear", mesh=make_mesh(1, 1, [dev]))
    launches[0] += st.solid_trace_chunk.launches
    same1 = bool(np.array_equal(img1, cornell_img))
    require(same1, "1x1 mesh: not the unsharded image")

    # ---- a 2x2 mesh: the wavefront on each band ----
    sc = build_cornell(SMALL_W, SMALL_H)
    st.solid_trace_chunk.launches = 0
    k_img, _, k_wall = timed_render(torch, dev, sc, SMALL_SPP, seed=4)
    launches[0] += st.solid_trace_chunk.launches
    (w_img, _), n, _, w_wall, w_peak = spied(
        torch, sharded_mod, ("solid_trace_chunk",), lambda: sc.render(
            SMALL_SPP, output="linear", return_stats=True, seed=4,
            mesh=make_mesh(2, 2, [dev] * 4)))
    require(n == (0, 0), f"2x2 Cornell: kernel launches {n}")
    wave = build_cornell(SMALL_W, SMALL_H)
    wave.settings = T.RenderSettings(use_pallas="never")
    var = (chunk_var(torch, dev, sc, SMALL_SPP, solid=True)
           + chunk_var(torch, dev, wave, SMALL_SPP))
    line2 = z_hold("Cornell 2x2 vs unsharded", w_img, k_img, var, SMALL_W,
                   SMALL_H)

    # ---- an emissive scene across meshes ----
    esc = emissive_scene(GRID_W, GRID_H)
    ref = esc.render(EMISSIVE_SPP, output="linear", seed=1, device=dev)
    eq = {}
    for shape in ((1, 1), (4, 1), (2, 2)):
        st.solid_trace_chunk.launches = 0
        im = esc.render(EMISSIVE_SPP, output="linear", seed=1,
                        mesh=make_mesh(*shape, [dev] * (shape[0] * shape[1])))
        launches[0] += st.solid_trace_chunk.launches
        eq[shape] = (float((np.abs(im - ref) <= 1e-6).all(axis=-1).mean()),
                     bool(np.array_equal(im, ref)))
    print(f"mesh: 1x1 Cornell {W}x{H} x {SPP} spp bit-equal to the unsharded "
          f"render {same1} | Cornell {SMALL_W}x{SMALL_H} x {SMALL_SPP} spp over "
          f"2x2 cuda:0 shards (the wavefront a band) {w_wall:.4f} s, peak "
          f"{w_peak:.2f} GiB, unsharded (K1) {k_wall:.4f} s | {line2} | emissive "
          f"box {GRID_W}x{GRID_H} x {EMISSIVE_SPP} spp against the unsharded "
          f"render: " + ", ".join(
              f"{a}x{b} within 1e-6 {v[0]:.6f} (bit-equal {v[1]})"
              for (a, b), v in eq.items()), flush=True)
    require(eq[(1, 1)][1], "emissive 1x1: not the unsharded image")
    require(all(v[0] >= 0.999 for v in eq.values()),
            f"emissive across meshes: {eq}")

    # ---- F1: tables past 48 KB of shared memory ----
    cinfo = st.kernel_info(build_cornell(W, H)._settings_for_render()[1]
                           .to(dev))
    parts = []
    for textured in (False, True):
        sc = torch_features.many_lights(F1_W, F1_H, F1_LIGHTS, textured)
        static, tables, settings = sc._settings_for_render()
        path = scene_mod.route(static, settings)
        require(path == ("record" if textured else "solid"),
                f"many lights: route {path}")
        wname = "record_trace_chunk" if textured else "solid_trace_chunk"
        (img, _), n, first, wall, _ = spied(
            torch, sharded_mod, (wname,), lambda: sc.render(
                F1_SPP, output="linear", return_stats=True, device=dev))
        k = 1 if textured else 0
        require(n[k] >= 1 and n[1 - k] == 0, f"many lights: launches {n}")
        require(bool(np.isfinite(img).all()), "many lights: non-finite image")
        launches[k] += n[k]
        args = first[wname]
        errs[k] = max(errs[k], hold_chunk(
            torch, f"{F1_LIGHTS} lights{' textured' if textured else ''}, "
            "first chunk", not textured, args))
        info = (rt.kernel_info(static, args[2]) if textured
                else st.kernel_info(args[1]))
        require(info["smem"] > 48 * 1024 and info["blocks_per_sm"] >= 1,
                f"many lights: {info}")
        wrap = rt.record_trace_chunk if textured else st.solid_trace_chunk
        wrap(*args)                                 # warm-up
        ms = cuda_ms(lambda: wrap(*args), 5)
        spp = args[-5]
        parts.append(f"{'K2' if textured else 'K1'} {info['smem']} B opted in "
                     f"(card maximum {info['smem_optin_max']} B), "
                     f"{info['blocks_per_sm']} blocks an SM, {n[k]} launches, "
                     f"render {wall:.4f} s, chunk {spp} spp x {F1_W}x{F1_H} "
                     f"{ms:.3f} ms")
    print(f"F1: one Glossy sphere under {F1_LIGHTS} point lights, "
          f"{F1_W}x{F1_H} x {F1_SPP} spp | " + " | ".join(parts)
          + f" | Cornell ({cinfo['smem']} B, not opted in) "
          f"{cinfo['blocks_per_sm']} blocks an SM", flush=True)

    # ---- two gloo processes on cuda:0 ----
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_multihost_runner as runner

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    WORK.mkdir(parents=True, exist_ok=True)
    out = str(WORK / "multihost")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_multihost_runner.py"),
         str(rank), "2", str(port), out, "cuda"], env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mp_wall = time.perf_counter() - t0
    require(all(p.returncode == 0 for p in procs),
            "two processes failed:\n" + "\n".join(x[-2000:] for x in logs))
    # one seed (0): each rank's file holds one frame
    f0, f1 = np.load(out + ".rank0.npy")[0], np.load(out + ".rank1.npy")[0]
    one = render_multihost(runner.scene(T), 8, seed=0, mesh=runner.mesh(dev),
                           device=dev)
    same01, same1p = bool(np.array_equal(f0, f1)), bool(np.array_equal(f0, one))
    print(f"multihost: two gloo processes on cuda:0, a 4x2 mesh of 16x16 x 8 "
          f"spp, {mp_wall:.1f} s | rank frames equal {same01} | equal to one "
          f"process {same1p} | image mean {f0.mean():.6f} | phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    require(same01 and same1p, "two-process frames disagree")
    return tuple(launches), tuple(errs)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    sys.path.insert(0, str(ROOT / "scripts"))
    from raytracer_tpu_torch.core.scene import plan_chunks
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import solid_trace as st
    from raytracer_tpu_torch.probes import roofline
    from torch_cornellbox import build_cornell

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # ---- phase 1: device ----
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc_version(cuda_build)}", flush=True)

    # ---- phase 2: build the kernels from the checkout ----
    t0 = time.perf_counter()
    cuda_build.build_all()                  # the kernels and the probes
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s | {' | '.join(build_lines(cuda_build.build_log))}",
          flush=True)

    if "--w4" in sys.argv[1:]:
        # W4's phase alone (after the build), for working on it
        w4_phase(torch, dev)
        print(json.dumps({"kernels": w4_rows(torch)}, default=float))
        return 0

    if "--diff-mesh" in sys.argv[1:]:
        # that phase alone (after the build); its references are the
        # unsharded 256-spp Cornell rendered here, and its wall
        sc = build_cornell(W, H)
        sc.render(SPP, output="linear", device=dev)
        ref, _, wall = timed_render(torch, dev, sc, SPP)
        diff_mesh_phase(torch, dev, ref, wall)
        return 0

    if "--w3" in sys.argv[1:]:
        # W3's phase alone (after the build), for working on it
        w3_phase(torch, dev)
        return 0

    if "--features" in sys.argv[1:]:
        # that phase alone (after the build), for working on it; its
        # reference is a 256-spp Cornell rendered here
        WORK.mkdir(parents=True, exist_ok=True)
        ref = build_cornell(W, H).render(SPP, output="linear", device=dev)
        features_phase(torch, dev, ref)
        return 0

    # ---- phase 3: kernel vs plain version, Cornell 64x64 x 16 spp ----
    _, tables, cam, settings = scene_inputs(build_cornell, CHECK_W, CHECK_H, dev)
    seed = torch.tensor([20260916, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, tables, cam, CHECK_W, CHECK_H, CHECK_SPP, settings.max_bounces)
    L_k, n_k = st.solid_trace_chunk(*args)
    L_p, n_p = st.solid_trace_chunk_reference(*args)
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    print(f"kernel vs plain: {L_k.shape[0]} rays, max_bounces "
          f"{settings.max_bounces}, match {rate:.6f} (rtol {MATCH_RTOL}, atol "
          f"{MATCH_ATOL}), bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e}, "
          f"rays_traced {n_k} vs {n_p}", flush=True)
    require(bit_eq == 1.0, f"bit-equal share {bit_eq} < 1")
    require(n_k == n_p, f"rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), "non-finite kernel output")

    # ---- phase 4: the solid main path through Scene.render ----
    sc, tables, cam, settings = scene_inputs(build_cornell, W, H, dev)
    chunk, n_chunks = plan_chunks(SPP * sc._diffuse_fan(), W, H)
    require((chunk, n_chunks) == (26, 197), f"chunk plan {(chunk, n_chunks)}")
    st.solid_trace_chunk.launches = 0
    walls, stats = [], None
    for _ in range(1 + TIMED_RENDERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, stats = sc.render(samples_per_pixel=SPP, output="linear",
                               return_stats=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = st.solid_trace_chunk.launches
    require(launches == n_chunks * (1 + TIMED_RENDERS),
            f"{launches} kernel launches for {1 + TIMED_RENDERS} renders")
    wall = statistics.median(walls[1:])
    mrays = stats["rays_traced"] / wall / 1e6
    require(img.shape == (H, W, 3), f"image shape {img.shape}")
    require(bool(torch.isfinite(torch.from_numpy(img)).all()), "non-finite image")
    img_mean = float(img.mean())
    # the plain version on one 20-spp chunk of the same frame
    ref_seed = torch.tensor([777, 31337, 0], dtype=torch.int32, device=dev)
    L_ref, _ = st.solid_trace_chunk_reference(ref_seed, tables, cam, W, H,
                                              REF_SPP, settings.max_bounces)
    L_ref = torch.where(torch.isfinite(L_ref), L_ref, 0.0)
    per_sample = L_ref.view(REF_SPP, -1).mean(dim=1).double()
    ref_mean = per_sample.mean().item()
    se = (per_sample.std() / REF_SPP ** 0.5).item()
    print(f"main path: Scene.render {W}x{H} x {SPP} spp, {n_chunks} chunks of "
          f"{chunk} spp, {launches} kernel launches in {1 + TIMED_RENDERS} "
          f"renders | wall {wall:.4f} s (median of {TIMED_RENDERS}; "
          f"{', '.join(f'{w:.4f}' for w in walls)}) | rays_traced "
          f"{stats['rays_traced']} | {mrays:.1f} Mrays/s | image mean "
          f"{img_mean:.6f}, plain {REF_SPP}-spp chunk {ref_mean:.6f} +- "
          f"{se:.6f}", flush=True)
    require(abs(img_mean - ref_mean) < 4 * se,
            f"image mean {img_mean} vs plain {ref_mean} (4 SE = {4 * se})")
    del L_ref, per_sample
    cornell_img = img

    # ---- phase 5: kernel vs plain at the chunk shape (4.16 M rays) ----
    seed = torch.tensor([99, 4242, 0], dtype=torch.int32, device=dev)
    args = (seed, tables, cam, W, H, chunk, settings.max_bounces)
    kernel = lambda: st.solid_trace_chunk(*args)
    plain = lambda: st.solid_trace_chunk_reference(*args)
    (L_k, n_k), (L_p, n_p) = kernel(), plain()     # also the warm-up
    rate, max_err, bit_eq, n_k, n_p = compare(L_k, L_p, n_k, n_p)
    print(f"kernel vs plain at the chunk shape: {L_k.shape[0]} rays, match "
          f"{rate:.6f}, bit-equal {bit_eq:.6f}, max_abs_err {max_err:.3e}, "
          f"rays_traced {n_k} vs {n_p}", flush=True)
    require(bit_eq == 1.0, f"chunk-shape bit-equal share {bit_eq} < 1")
    require(n_k == n_p, f"chunk-shape rays_traced {n_k} != {n_p}")
    require(bool(torch.isfinite(L_k).all()), "non-finite kernel output")
    del L_k, L_p
    torch.cuda.reset_peak_memory_stats(dev)
    plain_ms = [cuda_ms(plain, 1)]
    kernel_ms = [cuda_ms(kernel, KERNEL_REPS), cuda_ms(kernel, KERNEL_REPS)]
    plain_ms.append(cuda_ms(plain, 1))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms, p_ms = statistics.mean(kernel_ms), statistics.mean(plain_ms)
    print(f"chunk timing: {chunk} spp x {W}x{H} = {chunk * W * H} rays | "
          f"kernel {ms:.3f} ms ({', '.join(f'{x:.3f}' for x in kernel_ms)}) | "
          f"plain {p_ms:.1f} ms ({', '.join(f'{x:.1f}' for x in plain_ms)}) | "
          f"peak {peak_gib:.2f} GiB", flush=True)
    info = st.kernel_info(tables)
    print(f"K1 as built: {info['registers']} registers, {info['local_bytes']} B local "
          f"a thread | block {info['block']}, min blocks {info['min_blocks']}, refill "
          f"at {info['refill_min']} free lanes, refractive shading at "
          f"{info['refr_min']} hits | persistent grid {info['sms']} SMs x "
          f"{info['blocks_per_sm']} blocks", flush=True)
    require(info["blocks_per_sm"] >= 1, "K1 fits no block on an SM")
    lane_efficiency(torch, "cornell", args + (settings.split_k, settings.sampler,
                                              settings.projection))

    del tables, cam
    torch.cuda.empty_cache()
    # ---- the solid kernel's other paths: glossy, split, dispersion,
    # triangles / discs / cylinders, the other projections ----
    times = {"cornell": ms}
    new_launches, new_err, t = other_paths(torch, dev, solid=True)
    times.update(t)
    solid_row = {
        "name": "solid_trace", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/solid_trace.cu",
        "replaces": "raytracer_tpu/ops/pallas_trace.py:508",
        "launches": launches + new_launches, "max_abs_err": max(max_err, new_err),
        "ms": ms, "plain_ms": p_ms}
    record_row, times["example2"] = record_phases(torch, dev)
    torch.cuda.empty_cache()
    # ---- the record kernel's other paths: discs, cylinders, dispersion,
    # the other projections ----
    new_launches, new_err, t = other_paths(torch, dev, solid=False)
    times.update(t)
    record_row["launches"] += new_launches
    record_row["max_abs_err"] = max(record_row["max_abs_err"], new_err)
    torch.cuda.empty_cache()

    # ---- the render options, render_environment, .hdr and JSON scenes ----
    (solid_n, record_n), (solid_err, record_err) = slice_phases(torch, dev,
                                                                cornell_img)
    solid_row["launches"] += solid_n
    record_row["launches"] += record_n
    solid_row["max_abs_err"] = max(solid_row["max_abs_err"], solid_err)
    record_row["max_abs_err"] = max(record_row["max_abs_err"], record_err)
    torch.cuda.empty_cache()

    # ---- the wavefront: past the gates, and against the kernel ----
    solid_row["launches"] += wavefront_phase(torch, dev)
    torch.cuda.empty_cache()

    # ---- W3, the wavefront's analytic sweep, against its plain loops ----
    w3_phase(torch, dev)
    torch.cuda.empty_cache()

    # ---- W4, the wavefront's shading blocks, in the driven renders ----
    w4_phase(torch, dev)
    torch.cuda.empty_cache()

    # ---- the meshes: clusters, corner attributes, instances ----
    mesh_n, mesh_err = mesh_phase(torch, dev)
    solid_row["launches"] += mesh_n
    solid_row["max_abs_err"] = max(solid_row["max_abs_err"], mesh_err)
    torch.cuda.empty_cache()

    # ---- the features: env IS, custom materials, normal maps, the
    # denoiser, motion blur, ODS, the command line ----
    (f_solid, f_record), (f_serr, f_rerr) = features_phase(torch, dev,
                                                           cornell_img)
    solid_row["launches"] += f_solid
    record_row["launches"] += f_record
    solid_row["max_abs_err"] = max(solid_row["max_abs_err"], f_serr)
    record_row["max_abs_err"] = max(record_row["max_abs_err"], f_rerr)
    torch.cuda.empty_cache()

    # ---- diff.py and multi-device rendering, F1 ----
    (d_solid, d_record), (d_serr, d_rerr) = diff_mesh_phase(
        torch, dev, cornell_img, wall)
    solid_row["launches"] += d_solid
    record_row["launches"] += d_record
    solid_row["max_abs_err"] = max(solid_row["max_abs_err"], d_serr)
    record_row["max_abs_err"] = max(record_row["max_abs_err"], d_rerr)
    torch.cuda.empty_cache()

    # ---- the Hopper probes, and the render kernels' bounds (P2) ----
    probe_rows, p2 = probe_phases(torch, times)
    for row, scene in ((solid_row, "cornell"), (record_row, "example2")):
        res = p2[scene]
        row.update(bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                   library_ms=None)
    for scene, _, _, _ in roofline.SCENES:
        res = p2[scene]
        print(f"{'record' if res['kernel'] == 'k2' else 'solid'}_trace bound at the "
              f"{scene} chunk: {res['bound_ms']:.4f} ms ({res['bound_by']}), kernel "
              f"{res['kernel_ms']:.3f} ms, share {res['share']:.4f}", flush=True)

    # W1, a row an entry at the held input it was timed on: its bound from
    # the triangle tests that input needs at the issue slots of one test,
    # read off the SASS of its sweep kernel's loop (the instructions a pass
    # issues on the path of a row that is no hit, over the tests a pass
    # makes: one division, FCHK, a test), and its bytes; beside the
    # clustered nearest's, the same tests at isect_cost's measured cost of
    # the render kernels' triangle test, whose loop does more
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.probes import common
    sass = common.cuobjdump_sass(cuda_build.library_path("kernels"))
    w1_rows = []
    for key, (kernel, replaces) in W1_ENTRIES.items():
        tm, launches = W1["timed"][key], W1["launches"][key]
        issued, passes = common.loop_issue(sass, kernel, "FCHK")
        slots = issued / passes
        row = common.row(f"mesh_sweep {key} (W1)", "mesh_sweep.cu", replaces,
                         launches, W1["max_abs_err"][key], tm["ms"],
                         tm["plain_ms"], tm["tests"] * slots, tm["bytes"])
        w1_rows.append(row)
        beside = ""
        if key == "clustered_nearest":
            k1_ms = common.bound(tm["tests"] * W1["tri_slots"], tm["bytes"])[0]
            beside = (f" | at isect_cost's {W1['tri_slots']:.2f} measured slots "
                      f"of the render kernels' test {k1_ms:.4f} ms")
        print(f"W1 {key} bound at the {tm['name']} ({tm['tests']} triangle "
              f"tests at {slots:.2f} slots a test, {kernel}'s loop issuing "
              f"{issued} instructions a pass of {passes} tests, {tm['bytes']} "
              f"bytes): {row['bound_ms']:.4f} ms ({row['bound_by']}), W1 "
              f"{tm['ms']:.4f} ms, share {row['bound_ms'] / tm['ms']:.4f}, plain "
              f"{tm['plain_ms']:.1f} ms{beside} | {launches} launches in the "
              f"driven renders", flush=True)
        require(launches > 0, f"W1 {key} never launched in the driven renders")
    # W2 at the instance field's camera rays: its bound from one box test a
    # (record, ray) slot at the issue slots of a test, read off the SASS of
    # its count kernel's loop (the instructions a pass issues over the
    # ballots it takes, one a test), and its bytes
    tm = W2["timed"]
    issued, passes = common.loop_issue(sass, *W2_LOOP)
    slots = issued / passes
    w2_row = common.row("mesh_pairs (W2)", "mesh_pairs.cu",
                        "raytracer_tpu/geometry/intersect.py:263", W2["launches"],
                        W2["max_abs_err"], tm["ms"], tm["plain_ms"],
                        tm["tests"] * slots, tm["bytes"])
    print(f"W2 bound at the {tm['name']} ({tm['tests']} box tests at "
          f"{slots:.2f} slots a test, {W2_LOOP[0]}'s loop issuing {issued} "
          f"instructions a pass of {passes} tests, {tm['bytes']} bytes): "
          f"{w2_row['bound_ms']:.4f} ms ({w2_row['bound_by']}), W2 {tm['ms']:.4f} "
          f"ms (search {tm['search_ms']:.4f} + write {tm['write_ms']:.4f}), share "
          f"{w2_row['bound_ms'] / tm['ms']:.4f}, plain {tm['plain_ms']:.1f} ms, "
          f"wrapper {tm['wrapper_ms']:.2f} ms | {W2['launches']} launches in the "
          f"driven mesh renders", flush=True)
    require(W2["launches"] > 0, "W2 never launched in the driven renders")
    # W3, a row an entry and held input it was timed on (the occluded
    # entry's two): its bound from the tests of each kind that input needs
    # at the issue slots of that kind's test, read off the SASS of the
    # kind's loop in the entry's kernel (one loop a kind, in object-id
    # order: the innermost loops that hold FP multiplies), and its bytes
    w3_rows = []
    for tm in W3["timed"]:
        key = tm["key"]
        (kernel, replaces), launches = W3_ENTRIES[key], W3["launches"][key]
        loops = common.kind_loops(sass, kernel, "FMUL")
        require(len(loops) >= len(W3_KINDS), f"W3 {key}: {len(loops)} loops "
                f"holding FMUL in {kernel}'s SASS, want one a kind")
        slots = [issued for issued, _ in loops[:len(W3_KINDS)]]
        ops = sum(n * c for n, c in zip(tm["kind_tests"], slots))
        name = f"analytic_sweep {key} (W3)"
        if key == "analytic_occluded":
            name += f", {tm['name']}"
        row = common.row(name, "analytic_sweep.cu", replaces, launches,
                         W3["max_abs_err"][key], tm["ms"], tm["plain_ms"], ops,
                         tm["bytes"])
        w3_rows.append(row)
        print(f"W3 {key} bound at the {tm['name']} ({tm['tests']} tests: "
              f"{', '.join(f'{k} {n} at {c} slots' for k, n, c in zip(W3_KINDS, tm['kind_tests'], slots))}"
              f"; {len(loops)} loops holding FMUL in {kernel}'s SASS, issuing "
              f"{[i for i, _ in loops]} instructions a pass; {tm['bytes']} "
              f"bytes): {row['bound_ms']:.4f} ms ({row['bound_by']}), W3 "
              f"{tm['ms']:.4f} ms (events {tm['event_ms']:.4f}), share "
              f"{row['bound_ms'] / tm['ms']:.4f}, plain {tm['plain_ms']:.1f} ms "
              f"| {launches} launches in the driven renders", flush=True)
        require(launches > 0, f"W3 {key} never launched in the driven renders")
    print(json.dumps({"kernels": [solid_row, record_row, *w1_rows, w2_row,
                                  *w3_rows, *w4_rows(torch)] + probe_rows},
                     default=float))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
