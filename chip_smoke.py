#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels (raytracer_tpu_torch/csrc: the solid kernel,
the record kernel, W1, the wavefront's triangle sweep, W2, its pair
search, W3, its analytic sweep, W4, its shading blocks, W5, its hit
attributes, and W6, its bounce tail, one nvcc per source, started
together) from the checkout and
drives both kernel paths and the wavefront:

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
  blocks) and W5 (csrc/hit_attrs.cu: the hit attributes) in the driven
  wavefront renders: the 98-object grid at 400x300
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
  F5: where torch.sum splits each row of the caps pdf across blocks (few
  rays, 131,072 or more targets), the general caps sum against
  torch.sum at five such shapes and the diffuse entry on 300 rays of
  Cornell's first bounce with 150,000 caps and on 16 with 300,000
  against the plain dispatch, bit for bit (16 x 300,000 and 2 x
  2,200,000 split a row across more blocks than a warp has lanes, where
  the order of the last block's trees shows).  W5 (csrc/hit_attrs.cu: the hit attributes) in the same
  driven renders and the primitives example on the wavefront (planes,
  discs, cylinders with uv): counts set to 0 just before each and read
  just after (launched, required; the plain attribute formulas run
  nowhere on the card but in a hold, required); every call of each
  render's first chunk held against the plain stage as called, with uv
  forced and as the first-hit pass, every field of every ray bit for bit
  (a share of exactly 1.0; in the normal-mapped render the mapped,
  oriented normal, which W5 computes itself); the plain normal maps run
  on the card only in a hold (required); a line a
  bounce of Cornell on the wavefront's first 4.16 M-ray chunk and of the
  normal-mapped render's first 1.92 M-ray chunk, W5 timed through a CUDA
  graph beside the plain stage (with its maps), its bytes, bound and
  share; the registers, stack and blocks an SM of both its instances
  (without and with the maps); its asin against torch.asin on all 2^32
  floats, its atan2 against torch.atan2 on 2^26 random pairs and the
  special values, and its 3 x 3 product against torch's (cuBLAS) at
  17 to 1.92 M rows with signed zeros; the kernels line has a W5 row and
  a W5-with-maps row (bound by bytes) at the first bounce of those
  chunks with the mean a call over their bounces.  W6
  (csrc/bounce_tail.cu: the start of each bounce's merged output with the
  emissive and environment blocks, and the update) in the same driven
  renders and in examples 2 (a cube-cross sky) and 4 (a sky with a
  lightmap, blur 0) at 400x300 x 16 spp on the wavefront: counts set to 0
  just before each and read just after (both entries launched, required;
  the plain start and update run on the card only in a backward pass,
  required); every call of each render's first chunk held against the
  plain stage, every field of every ray bit for bit (a share of exactly
  1.0); a line a call of the first chunk of Cornell on the wavefront
  (an emissive light, no texture) and of example 2 on the wavefront (the
  sky's texels), each entry timed through a CUDA graph beside the plain
  stage, its bytes, bound and share; the registers, stack and blocks an
  SM of both kernels; the kernels line has a row an entry (bound by
  bytes) at Cornell's first bounce with the mean a call over its
  bounces.
  `python3 chip_smoke.py --w4` runs the build and this phase (W4's, W5's
  and W6's) alone;
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
  gradient against a central difference within rtol 0.05; the backward
  kernels (csrc/bounce_tail.cu `bounce_update_bwd`, `bounce_start_bwd`
  and its TAPS instance; csrc/hit_attrs.cu `hit_attrs_bwd` and its TABLES
  and MAPS instances; W4's refractive, diffuse and glossy backward) in
  the IoR gradients of the glass sphere, the icosphere, Cornell and the
  primitives (discs, cylinders) on the wavefront at the same size and in
  the gradients of the primitives' colours and floor texture, every
  texture of a lit scene, the spheres' and the icosphere's geometry
  tables and an enclosed normal-mapped scene's map and tables
  (`backward_phase`): each kernel launched, no plain W6 stage, W5 formula
  or W4 block on the card, no plain-VJP route taken, every backward call
  recorded and held against the plain VJP bit for bit (a share of 1.0
  per kernel), each timed with the L2 cold beside the plain VJP, its
  bound the larger of its FP32 issue slots (`bwd_slots`: a ray's FP32
  instructions off the SASS, `probes/common.py` `bwd_pass`) and its
  bytes, which one binds and its share, the kernels' registers, stack
  and blocks an SM
  (`--backward` runs the build and this part alone);
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
# F5: (rays, importance-sampled targets) where torch.sum splits each row
# of the caps pdf across blocks on the H100 (the last two of F5_SUMS and
# of F5_DIFFUSE across more blocks than a warp has lanes), for the caps
# sum alone, and for the diffuse entry on that many of a Cornell bounce's
# rays
F5_SUMS = ((64, 200_000), (300, 150_000), (512, 131_072), (16, 300_000),
           (2, 2_200_000))
F5_DIFFUSE = ((300, 150_000), (16, 300_000))
# W5 (csrc/hit_attrs.cu), the hit attributes: the CUDA-graph replays of
# its timing; the renders whose first chunk it is timed at, every bounce
# (the kernels line's rows: Cornell's, and the normal-mapped scene's,
# which runs the kernel's instance with the maps); what the run gathers:
# launches in the driven wavefront renders (counts set to 0 just before
# each, read just after; those of renders with maps apart), the largest
# difference of its holds (0: bit-equal), each timed bounce's numbers by
# render, the calls captured in the driven renders (every bounce of each
# render's first chunk), and the plain formulas and the plain normal maps
# run on the card outside a hold (none allowed: the backward is a kernel); each
# call is held as called, with uv forced and as the first-hit pass
# (force_uv, first_hit); the rows at which W5's 3 x 3 product is held
# against torch's (cuBLAS)
W5_REPS = 5
W5_TIMED = ("Cornell on the wavefront", "normal-mapped")
W5_MODES = ((False, False), (True, False), (True, True))
W5_MM3_ROWS = (17, 100, 4096, 1_920_000)
W5 = {"launches": 0, "map_launches": 0, "max_abs_err": 0.0, "timed": {},
      "captured": {}, "calls": {}, "plain_on_card": 0, "maps_on_card": 0,
      "holding": False, "held": 0}
# W6 (csrc/bounce_tail.cu), the bounce tail: the CUDA-graph replays of its
# timing; its entries (ops/bounce_tail.py wrappers), each with its kernel
# and the JAX code it replaces; the renders whose first chunk it is timed
# at, every bounce (the kernels line's rows from the first: Cornell's
# emissive light without a texture; example 2's environment texels); what the run gathers: launches in the driven wavefront
# renders (counts set to 0 just before each, read just after), the largest
# difference of its holds (0: bit-equal), each timed call's numbers, the
# calls captured in the driven renders (every bounce of each render's first
# chunk), the plain stages run on the card outside a hold (none allowed:
# the backward passes are kernels); the samples of examples 2 and 4 on the wavefront
# (the environment's two kinds of texture)
W6_REPS = 5
W6_ENTRIES = {
    "bounce_start": ("bounce_start_kernel",
                     "raytracer_tpu/core/integrator.py:239-287 (the start and the "
                     "emissive and env merges; materials/shade.py:176, :190)"),
    "bounce_update": ("bounce_update_kernel",
                      "raytracer_tpu/core/integrator.py:289-310")}
W6_TIMED = ("Cornell on the wavefront", "example 2 on the wavefront")
W6 = {"launches": dict.fromkeys(W6_ENTRIES, 0),
      "max_abs_err": dict.fromkeys(W6_ENTRIES, 0.0), "timed": {k: [] for k in W6_ENTRIES},
      "captured": {}, "seen": set(), "chunk_done": set(), "plain_on_card": 0,
      "holding": False, "held": dict.fromkeys(W6_ENTRIES, 0)}
# the backward kernels (ops/bounce_tail.py `update_vjp`, `start_vjp`,
# ops/hit_attrs.py `attrs_vjp`): each entry's name in the kernels line,
# source, the JAX code whose gradient it computes and kernel; what the
# backward phase gathers: launches in its gradients (counts set to 0 just
# before each, read just after), the largest difference of its holds (0:
# bit-equal), the kernels line's rows; `holding` while a hold runs the plain
# VJP; the plain W6 stages and W5 formulas run on the card outside a hold
BWD_ENTRIES = {
    "bounce_update_bwd": ("bounce_tail bounce_update_bwd (W6 backward)",
                          "bounce_tail.cu", "raytracer_tpu/core/integrator.py:289-310 "
                          "(the update's VJP under jax.grad, raytracer_tpu/diff.py)",
                          "bounce_update_bwd_kernel"),
    "bounce_start_bwd": ("bounce_tail bounce_start_bwd (W6 backward)", "bounce_tail.cu",
                         "raytracer_tpu/core/integrator.py:239-287 (the start's VJP "
                         "under jax.grad; materials/shade.py:176, :190)",
                         "bounce_start_bwd_kernelILb0E"),
    "bounce_start_bwd_taps": ("bounce_tail bounce_start_bwd TAPS instance (W6 backward "
                              "with the textures' texel taps' rows)", "bounce_tail.cu",
                              "raytracer_tpu/materials/shade.py:81 fetch_texture under "
                              "jax.grad in the start (:130 _slot_color, :190 shade_env; "
                              "raytracer_tpu/diff.py:15-22 texture planes)",
                              "bounce_start_bwd_kernelILb1E"),
    "hit_attrs_bwd": ("hit_attrs_bwd (W5 backward)", "hit_attrs.cu",
                      "raytracer_tpu/geometry/attrs.py:245 (hit_attributes' VJP under "
                      "jax.grad; core/integrator.py:221-236)", "hit_attrs_bwd_kernelILi0E"),
    "hit_attrs_bwd_tables": ("hit_attrs_bwd TABLES instance (W5 backward with the "
                             "geometry tables' per-ray rows)", "hit_attrs.cu",
                             "raytracer_tpu/geometry/attrs.py:24 `_gather` under jax.grad "
                             "(hit_attributes' VJP into data.geom, raytracer_tpu/diff.py:15-22)",
                             "hit_attrs_bwd_kernelILi1E"),
    "hit_attrs_bwd_maps": ("hit_attrs_bwd MAPS instance (W5 backward through the normal "
                           "maps, their textures' taps)", "hit_attrs.cu",
                           "raytracer_tpu/core/integrator.py:120 _apply_normal_maps under "
                           "jax.grad (called at :224)", "hit_attrs_bwd_kernelILi2E"),
    "shade_refractive_bwd": ("wavefront_shade shade_refractive_bwd (W4 refractive "
                             "backward)", "wavefront_shade_bwd.cu",
                             "raytracer_tpu/materials/shade.py:385 (shade_refractive's "
                             "VJP under jax.grad, raytracer_tpu/diff.py)",
                             "shade_refractive_bwd_kernel"),
    "shade_diffuse_bwd": ("wavefront_shade shade_diffuse_bwd (W4 diffuse backward)",
                          "wavefront_diffuse_bwd.cu",
                          "raytracer_tpu/materials/shade.py:317 (shade_diffuse's VJP "
                          "under jax.grad, raytracer_tpu/diff.py)",
                          "shade_diffuse_bwd_kernel"),
    "shade_glossy_bwd": ("wavefront_shade shade_glossy_bwd (W4 glossy backward)",
                         "wavefront_glossy_bwd.cu",
                         "raytracer_tpu/materials/shade.py:215 (shade_glossy's VJP "
                         "under jax.grad, raytracer_tpu/diff.py)",
                         "shade_glossy_bwd_kernel")}
# W4's backward entry of each material type
W4_BWD = {4: "shade_refractive_bwd", 3: "shade_diffuse_bwd", 2: "shade_glossy_bwd"}
BWD = {"launches": dict.fromkeys(BWD_ENTRIES, 0),
       "max_abs_err": dict.fromkeys(BWD_ENTRIES, 0.0), "rows": [], "holding": False,
       "plain_W6": 0, "plain_W5": 0, "plain_W4": 0, "slots": {}}
# the least share of the held gradient entries finite on both sides: of
# every kernel's holds with drawn gradients, and of the recorded ones of
# the sphere and the icosphere (whose IoR gradients are finite)
BWD_FINITE = 0.9
ENV_WF_SPP = 16
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


def card_counted(fn, device_of, state, key, when=None):
    """fn, adding one to state[key] at each call on CUDA tensors (device_of
    its arguments) outside a hold (state["holding"]) where `when` (of its
    arguments) holds: a plain stage that must not run on the card."""
    def call(*args, **kw):
        if (device_of(*args).type == "cuda" and not state["holding"]
                and (when is None or when(*args))):
            state[key] += 1
        return fn(*args, **kw)
    return call


def plain_stages_counted(w6, w6_key, w5, w5_key, maps_key):
    """The plain W6 stages (ops/bounce_tail.py `plain_start`,
    `plain_update`), W5's plain formulas (ops/hit_attrs.py `hit_attributes`)
    and its plain normal maps (`_apply_normal_maps`, where the scene maps
    normals) counted on the card outside a hold, by `card_counted`, in
    w6[w6_key], w5[w5_key] and w5[maps_key]; the caller restores them."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import hit_attrs as ha

    bt.plain_start = card_counted(bt.plain_start, lambda ctx, *a: ctx.P.device,
                                  w6, w6_key)
    bt.plain_update = card_counted(bt.plain_update, lambda c, *a: c.L.device, w6, w6_key)
    ha.hit_attributes = card_counted(ha.hit_attributes, lambda P, *a: P.device, w5, w5_key)
    ha._apply_normal_maps = card_counted(
        ha._apply_normal_maps, lambda N, *a: N.device, w5, maps_key,
        when=lambda *a: bool(a[-1].normal_maps))


@contextlib.contextmanager
def held(state):
    """A hold: the plain stages counted by `card_counted` in `state` run
    uncounted inside."""
    state["holding"] = True
    try:
        yield
    finally:
        state["holding"] = False


@contextlib.contextmanager
def w4_spies():
    """Spies for W4's phase, the originals restored after it: trace's three
    wrappers (ops/wavefront_shade.py) capture each entry's call at every
    bounce of a labelled render's first chunk (its ShadeCtx, draws, packed
    words, mask and a copy of the merged output it was handed), and the
    plain blocks count their calls on CUDA tensors outside a hold and
    outside `_Shade`'s backward (where a plain route's gradient
    recomputes the plain block); likewise W5's attributes and W6's start and update (each
    bounce of the first chunk captured, the plain stages counted outside a
    hold: their backward passes are kernels)."""
    from raytracer_tpu_torch.materials import shade
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    from raytracer_tpu_torch.ops import bounce_tail as bt

    names = ("shade_diffuse", "shade_refractive", "shade_glossy")
    saved = ([(bt, n, getattr(bt, n)) for n in W6_ENTRIES]
             + [(bt, n, getattr(bt, n)) for n in ("plain_start", "plain_update")]
             + [(ws, n, getattr(ws, n)) for n in names]
             + [(shade, n, getattr(shade, n)) for n in names]
             + [(ha, "attributes", ha.attributes),
                (ha, "hit_attributes", ha.hit_attributes),
                (ha, "_apply_normal_maps", ha._apply_normal_maps)]
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

    def counted_backward(fctx, *grads):
        W4["holding"], W4["backward"] = True, W4["backward"] + 1
        try:
            return saved[-1][2].__func__(fctx, *grads)
        finally:
            W4["holding"] = False

    def w5_spy(real):
        def call(*args, **kw):
            lab = W4["label"]
            if lab is not None and not kw:
                got = W5["calls"].get(lab, 0)
                if got < args[7].max_bounces:       # the render's first chunk
                    W5["captured"][(lab, got)] = args
                    W5["calls"][lab] = got + 1
            return real(*args, **kw)
        return call

    def w6_start_spy(real):
        def call(ctx, packed, mat_type):
            lab, b = W4["label"], ctx.bounce
            if lab is not None and lab not in W6["chunk_done"]:
                if (lab, b) in W6["seen"]:          # the render's second chunk
                    W6["chunk_done"].add(lab)
                else:
                    W6["seen"].add((lab, b))
                    W6["captured"][(lab, "bounce_start", b)] = (ctx, packed, mat_type)
                    W6["pending"] = (lab, b)
            return real(ctx, packed, mat_type)
        return call

    def w6_update_spy(real):
        def call(c, miss, acc):
            if W6.get("pending") is not None:       # the captured bounce's update
                lab, b = W6.pop("pending")
                W6["captured"][(lab, "bounce_update", b)] = (c, miss, acc)
            return real(c, miss, acc)
        return call

    bt.bounce_start = w6_start_spy(bt.bounce_start)
    bt.bounce_update = w6_update_spy(bt.bounce_update)
    for mt, w in ws._WRAPPER.items():
        setattr(ws, w.__name__, spy(mt, w))
    for n in names:
        setattr(shade, n, card_counted(getattr(shade, n), lambda ctx, *a: ctx.P.device,
                                       W4, "plain_on_card"))
    ws._Shade.backward = staticmethod(counted_backward)
    ha.attributes = w5_spy(ha.attributes)
    plain_stages_counted(W6, "plain_on_card", W5, "plain_on_card", "maps_on_card")
    try:
        yield
    finally:
        for obj, n, v in saved:
            setattr(obj, n, v)


class w4_driven:
    """A driven render labelled `label`: W4's, W5's and W6's counts set to
    0 just before and read just after (added to the run's), their calls of
    the first chunk captured; no plain block may run on the card in it (a
    backward pass's recompute aside)."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        from raytracer_tpu_torch.ops import bounce_tail as bt
        from raytracer_tpu_torch.ops import hit_attrs as ha
        from raytracer_tpu_torch.ops import wavefront_shade as ws
        self.ws, self.ha, self.bt, self.plain = ws, ha, bt, W4["plain_on_card"]
        self.w5_plain, self.w6_plain = W5["plain_on_card"], W6["plain_on_card"]
        self.w5_maps = W5["maps_on_card"]
        W4["label"] = self.label
        ws.reset_launches()
        ha.reset_launches()
        bt.reset_launches()
        return self

    def __exit__(self, *exc):
        W4["label"] = None
        self.got = {key: self.ws._WRAPPER[mt].launches
                    for mt, (key, _) in self.ws._BLOCKS.items()}
        for key, n in self.got.items():
            W4["launches"][key] += n
        self.plain_runs = W4["plain_on_card"] - self.plain
        self.w5 = self.ha.launches()
        W5["launches"] += self.w5
        self.w5_plain_runs = W5["plain_on_card"] - self.w5_plain
        self.w5_maps_runs = W5["maps_on_card"] - self.w5_maps
        self.w6 = self.bt.launches()
        for key, n in self.w6.items():
            W6["launches"][key] += n
        self.w6_plain_runs = W6["plain_on_card"] - self.w6_plain
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

                if label == W5_TIMED[0] and key == "shade_diffuse" and b == 0:
                    f5_diffuse(torch, call)
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


def f5_diffuse(torch, call):
    """F5: the diffuse entry on each F5_DIFFUSE's rays of a captured
    bounce with that many importance-sampled caps (tests/test_torch_
    wavefront_shade_card.py `split_caps_call`), where torch.sum splits each
    row of the caps pdf across blocks: every field of every ray bit for bit
    with the plain dispatch (required), in two launches (the blocks' sums,
    staged, then the shading); its time (events)."""
    for n, K in F5_DIFFUSE:
        f5_diffuse_case(torch, call, n, K)


def f5_diffuse_case(torch, call, n, K):
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common
    from test_torch_wavefront_shade_card import split_caps_call

    fields = ws.FLOAT_FIELDS + ws.BOOL_FIELDS
    mt, ctx, draws, packed, m, acc = split_caps_call(call, n, K)
    want = acc.merge(ws._plain(mt, ctx, draws, None), m)
    counted = ws._WRAPPER[mt]
    before = counted.launches
    run = lambda: ws._kernel_shade(mt, ctx, draws, packed, m, ws.Merged(
        *(getattr(acc, f).clone() for f in fields)))
    got = run()
    launched = counted.launches - before
    share = bits_share(torch, got, want, fields)[0]
    require(share == 1.0 and launched == 2, f"F5: the diffuse entry on {n} rays "
            f"with {K} caps: bit-equal share {share}, {launched} launches")
    ms = common.cuda_ms(run, 2)
    print(f"F5 diffuse entry on {n} rays ({int(m.sum())} diffuse) with {K} "
          f"importance-sampled caps (each row's caps sum split across blocks): "
          f"bit-equal 1.0, two launches (the blocks' sums, the shading), "
          f"{ms:.3f} ms", flush=True)


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
    w5_resources(torch, dev)
    w6_resources(torch)


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
    for kernel, (mt, variant) in ws.KERNEL_INFO.items():
        name = next(k for k in use if re.search(rf"\d{kernel}E", k))
        r = use[name]
        inf = ws.info(mt, variant=variant)
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
    # F5: rows that torch.sum splits across blocks
    from torch_op_rounding import sum_plan
    props = torch.cuda.get_device_properties(dev)
    plans = []
    for n, K in F5_SUMS:
        plan = sum_plan(K, n, props.multi_processor_count,
                        props.max_threads_per_multi_processor)
        require(plan[3] > 1, f"F5: {n} x {K} is not split across blocks: {plan}")
        x = torch.randn((n, K), generator=gen, device=dev) * torch.pow(
            10.0, torch.rand((n, K), generator=gen, device=dev) * 6.0 - 3.0)
        got, want = ws.caps_sum(x, wide=True), torch.sum(x, dim=-1)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"F5: the caps sum of {n} x {K} is not torch.sum's bits")
        plans.append(f"{n} x {K} (blocks {plan[3]})")
    print(f"F5 caps sum split across blocks vs torch.sum ({', '.join(plans)}): "
          "bit-equal", flush=True)
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
    import torch_primitives
    import torch_textured
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
        ("lamps", lambda: torch_wavefront.lamp_cluster(LAMPS, *LAMP_WH), MESH_SPP),
        ("primitives on the wavefront", lambda: with_never(
            torch_primitives.primitives(MESH_W, MESH_H)), MESH_SPP),
        ("example 2 on the wavefront", lambda: with_never(
            torch_textured.example2(REC_W, REC_H)), ENV_WF_SPP),
        ("example 4 on the wavefront", lambda: with_never(
            torch_textured.example4(REC_W, REC_H, blur=0.0)), ENV_WF_SPP))
    for label, make, spp in renders:
        sc = make()
        static = sc._settings_for_render()[0]
        present = [ws._BLOCKS[mt][0] for mt in static.mat_types_present
                   if mt in ws._BLOCKS]
        with w4_driven(label) as d:
            img, stats, wall = timed_render(torch, dev, sc, spp, seed=7)
        require(img.shape[:2] == (sc.camera.screen_height, sc.camera.screen_width)
                and bool(np.isfinite(img).all()), f"W4 {label}: image")
        require(not present or all(d.got[k] > 0 for k in present),
                f"W4 {label}: launches {d.got} for the present entries {present}")
        require(d.plain_runs == 0, f"W4 {label}: {d.plain_runs} plain blocks "
                "ran on the card")
        lines, text = w4_hold(torch, label)
        if label in W4_PER_BOUNCE:
            print("\n".join(lines), flush=True)
        print(f"W4 vs plain, {label} ({wall:.4f} s, launches "
              f"{ {k[6:]: n for k, n in d.got.items() if n} }, no plain block): "
              + text, flush=True)
        w5_check(torch, label, d, static)
        w6_check(torch, label, d)
        del sc, img
    # the inverse-rendering step: W4 forward through _Shade, its backward
    # kernel
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
          f"{W4['backward'] - backward} backward calls, gradient "
          f"{g[0].tolist()}): " + w4_hold(torch, label)[1] +
          f" | phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    w5_check(torch, label, d, None)
    w6_check(torch, label, d)
    require(W4["plain_on_card"] == 0, f"{W4['plain_on_card']} plain blocks ran "
            "on the card")
    require(W6["plain_on_card"] == 0, f"the plain start or update ran "
            f"{W6['plain_on_card']} times on the card outside a hold")
    require(W5["plain_on_card"] == 0, f"the plain attribute formulas ran "
            f"{W5['plain_on_card']} times on the card")
    require(W5["maps_on_card"] == 0, f"the plain normal maps ran "
            f"{W5['maps_on_card']} times on the card outside a hold")
    require(W5["map_launches"] > 0, "no driven render ran W5 with normal maps")


def w5_check(torch, label, d, static):
    """The driven render `label` (of `static`; None: the gradient's)
    through W5: launched (one launch a bounce of each chunk), the plain
    attribute formulas and the plain normal maps run nowhere on the card
    outside a hold, its captured calls held
    (`w5_hold`); prints its line, and a line a bounce for W5_TIMED."""
    require(d.w5 > 0 and d.w5_plain_runs == 0 and d.w5_maps_runs == 0,
            f"W5 {label}: {d.w5} launches, the plain formulas ran "
            f"{d.w5_plain_runs} times and the plain maps {d.w5_maps_runs} times "
            "on the card")
    maps = static is not None and bool(static.normal_maps)
    if maps:
        W5["map_launches"] += d.w5
    lines, text = w5_hold(torch, label)
    if label in W5_TIMED:
        print("\n".join(lines), flush=True)
    print(f"W5 vs plain, {label} ({d.w5} launches{', maps in the kernel' if maps else ''}"
          f", no plain formula{', no plain map' if maps else ''}): {text}", flush=True)


def w5_bytes(args, oriented):
    """The bytes W5 moves on a call, each input read once and each output
    written once: a ray's O, D, t, obj (and its orientation where W5
    multiplies by it) and its P, N, uv, eps, miss, the word, its three int
    fields and its medium-change bit; the tables it reads (the scene's
    struct: the normal maps' texels, descriptors and tangents among
    them), once."""
    from raytracer_tpu_torch.ops import hit_attrs as ha

    n = args[2].shape[0]
    _, keep = ha.scene_struct(args[5], args[6])
    table, tri, corners, inst, packed, maps = keep
    tabs = [table, packed, *tri.values(), *corners.values(), *inst.values(),
            *maps.values()]
    per = 12 + 12 + 4 + 8 + (4 if oriented else 0) + 12 + 12 + 8 + 4 + 1 + 4 + 12 + 1
    return n * per + sum(x.numel() * x.element_size() for x in tabs)


def w5_hold(torch, label):
    """W5 against the plain stage on the calls captured in the render
    `label` (every bounce of its first chunk), each as called, with uv
    forced and as the first-hit pass (W5_MODES): every field of every ray
    bit for bit (floats by their bits, or both NaN; a share of exactly
    1.0, required).  In the renders of W5_TIMED each bounce as called is
    timed through a CUDA graph (W5 alone) beside the plain stage (events;
    its normal maps among it), with its bytes, bound and share.  Frees the
    captures.  Returns (a line a timed bounce, the text of a line)."""
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.probes import common

    fields = ha.FLOAT_FIELDS + ha.OTHER_FIELDS
    lines, held, ms_all = [], 0, []
    for key in sorted(k for k in W5["captured"] if k[0] == label):
        args = W5["captured"].pop(key)
        b = key[1]
        W5["holding"] = True
        try:
            with torch.no_grad():
                for force_uv, first_hit in W5_MODES:
                    got = ha._kernel_attributes(*args, force_uv=force_uv,
                                                first_hit=first_hit)
                    want = ha.plain_attributes(*args, force_uv=force_uv,
                                               first_hit=first_hit)
                    share, err = bits_share(torch, got, want, fields)
                    W5["max_abs_err"] = max(W5["max_abs_err"], err)
                    require(share == 1.0, f"W5 on the {label} bounce {b} (force_uv "
                            f"{force_uv}, first_hit {first_hit}): bit-equal share "
                            f"{share}")
                    del got, want
                held += 1
                if label not in W5_TIMED:
                    continue
                modes = ha._nudge_uv(args[6], args[7], False)
                ms = common.graph_ms(lambda: ha._launch(*args[:7], *modes, False),
                                     W5_REPS)[0]
                plain_ms = common.cuda_ms(lambda: ha.plain_attributes(*args), 1)
        finally:
            W5["holding"] = False
        if label not in W5_TIMED:
            continue
        n = args[2].shape[0]
        n_bytes = w5_bytes(args, True)
        bound_ms = common.bound(0, n_bytes)[0]
        W5["timed"].setdefault(label, []).append(dict(
            name=f"{label} bounce {b}", rays=n, ms=ms, plain_ms=plain_ms,
            bytes=n_bytes))
        ms_all.append(ms)
        lines.append(f"W5 {label} bounce {b}: {n} rays, bit-equal 1.0 in "
                     f"{len(W5_MODES)} modes, W5 {ms:.4f} ms (CUDA graph), bound "
                     f"{bound_ms:.4f} ms (bytes: {n_bytes / 1e6:.1f} MB), share "
                     f"{bound_ms / ms:.4f}, plain {plain_ms:.2f} ms")
    W5["held"] += held
    torch.cuda.empty_cache()
    text = f"{held} bounces held in {len(W5_MODES)} modes, bit-equal 1.0"
    if ms_all:
        text += (f"; W5 {sum(ms_all) / len(ms_all):.4f} ms a call over the "
                 f"{len(ms_all)} bounces")
    return lines, text


def w5_resources(torch, dev):
    """Prints the registers, stack, local memory and resident blocks an SM
    of W5's kernel, both instances (`cuobjdump -res-usage`, `ha.info`: the
    one without the normal maps, `hit_attrs_kernel<false>`, and the one
    with them); then holds W5's asin against torch.asin on all 2^32
    floats, its atan2 against torch.atan2 on 2^26 pairs of random bit
    patterns and every pair of special values, and its 3 x 3 product
    against torch's (cuBLAS) at W5_MM3_ROWS rows, both layouts of the
    (3, 3) operand, rows with signed zeros (none differing, required)."""
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import hit_attrs as ha

    use = resource_usage(cuda_build.build("kernels"))
    parts = []
    for maps, tag in ((False, "ILb0E"), (True, "ILb1E")):
        r = use[next(k for k in use if "hit_attrs_kernel" in k and tag in k)]
        inf = ha.info(maps=maps)
        parts.append(f"hit_attrs_kernel<{str(maps).lower()}> {r['REG']} registers, "
                     f"stack {r['STACK']} B, local {r['LOCAL']} B, "
                     f"{inf['blocks_per_sm']} blocks an SM")
    print(f"W5 kernels ({inf['block']} threads a block, {inf['sms']} SMs): "
          + "; ".join(parts), flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    bad_mm = bad_bwd = 0
    for n in W5_MM3_ROWS:
        m = torch.rand(n, 3, device=dev, generator=gen) - 0.5
        zero = torch.rand(n, 3, device=dev, generator=gen) < 0.3
        neg = torch.rand(n, 3, device=dev, generator=gen) < 0.5
        a = torch.where(zero, torch.where(neg, -0.0, 0.0), m) * 2.0
        B = torch.randn(3, 3, device=dev, generator=gen)
        B[0, 1], B[1, 2] = 0.0, -0.0
        g = torch.randn(n, 3, device=dev, generator=gen)
        g[::7, 1] = -0.0
        for M in (B, B.T.contiguous().T):
            bad_mm += int((ha.math("mm3", a, M).view(torch.int32)
                           != (a @ M).view(torch.int32)).sum())
            # the backward into the left factor (the maps' backward)
            x = a.clone().requires_grad_()
            ga, = torch.autograd.grad(x @ M, x, g)
            bad_bwd += int((ha.math("mm3_bwd", g, M).view(torch.int32)
                            != ga.view(torch.int32)).sum())
    print(f"W5 3 x 3 product vs torch's (cuBLAS) at {W5_MM3_ROWS} rows, both "
          f"layouts, signed zeros: {bad_mm} elements differ; its backward into the "
          f"left factor vs autograd's: {bad_bwd} differ", flush=True)
    require(bad_mm == 0 and bad_bwd == 0, "W5's 3 x 3 product differs from torch's")

    def differ(a, b):
        return int((~((a.view(torch.int32) == b.view(torch.int32))
                      | (torch.isnan(a) & torch.isnan(b)))).sum())

    t0 = time.perf_counter()
    bad = 0
    for lo in range(0, 1 << 32, 1 << 28):
        x = (torch.arange(lo, lo + (1 << 28), device=dev, dtype=torch.int64)
             .to(torch.int32).view(torch.float32))
        bad += differ(ha.math("asin", x), torch.asin(x))
        del x
    gen = torch.Generator(device=dev).manual_seed(11)
    r = lambda: torch.randint(-(1 << 31), 1 << 31, (1 << 26,), device=dev,
                              generator=gen, dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                            1e-45, -1e-45, 1e-39, -1e-39, 1.1754942e-38, 1.0,
                            -1.0, 0.5, -3.0, 1e30, -1e-30], device=dev)
    sy, sx = torch.meshgrid(special, special, indexing="ij")
    y, x = r(), r()
    bad_a = differ(ha.math("atan2", y, x), torch.atan2(y, x))
    bad_s = differ(ha.math("atan2", sy.flatten(), sx.flatten()),
                   torch.atan2(sy.flatten(), sx.flatten()))
    print(f"W5 asin vs torch.asin on all 2^32 floats: {bad} differ; atan2 vs "
          f"torch.atan2 on 2^26 random pairs: {bad_a} differ, on "
          f"{sy.numel()} special pairs: {bad_s} differ "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    require(bad == 0 and bad_a == 0 and bad_s == 0,
            "W5's asin or atan2 differs from torch's")


def w5_rows(torch):
    """W5's rows of the kernels line, each at its timed render's first
    bounce (its most rays): Cornell on the wavefront's (the kernel without
    the maps; launches: every driven render's) and the normal-mapped
    render's (the kernel with them; launches: the renders with maps); the
    bound from the bytes it moves there (`w5_bytes`), and beside its time
    the mean a call over that chunk's bounces (`chunk_mean_ms`); a line
    each."""
    from raytracer_tpu_torch.probes import common

    require(W5["launches"] > 0, "W5 never launched in the driven renders")
    rows = []
    for label, name, replaces, launches in (
            (W5_TIMED[0], "hit_attrs (W5)", "raytracer_tpu/geometry/attrs.py:245",
             W5["launches"]),
            (W5_TIMED[1], "hit_attrs with normal maps (W5)",
             "raytracer_tpu/core/integrator.py:120", W5["map_launches"])):
        timed = W5["timed"].get(label)
        require(timed, f"W5 was never timed at {label}")
        tm = timed[0]
        row = common.row(name, "hit_attrs.cu", replaces, launches, W5["max_abs_err"],
                         tm["ms"], tm["plain_ms"], 0, tm["bytes"])
        row["chunk_mean_ms"] = sum(t["ms"] for t in timed) / len(timed)
        print(f"{name} bound at the {tm['name']} ({tm['rays']} rays, {tm['bytes']} "
              f"bytes): {row['bound_ms']:.4f} ms ({row['bound_by']}), W5 "
              f"{tm['ms']:.4f} ms, share {row['bound_ms'] / tm['ms']:.4f}, mean "
              f"{row['chunk_mean_ms']:.4f} ms a call over the {len(timed)} bounces "
              f"of its chunk, plain {tm['plain_ms']:.2f} ms | {launches} launches "
              f"in the driven renders, {W5['held']} calls held", flush=True)
        rows.append(row)
    return rows


def w6_check(torch, label, d):
    """The driven render `label` through W6: both entries launched (one
    launch each a bounce of each chunk), the plain start and update run
    nowhere on the card outside a hold, its captured calls held
    (`w6_hold`); prints its line, and a line a bounce for W6_TIMED's."""
    require(all(n > 0 for n in d.w6.values()) and d.w6_plain_runs == 0,
            f"W6 {label}: launches {d.w6}, the plain stages ran "
            f"{d.w6_plain_runs} times on the card")
    lines, text = w6_hold(torch, label)
    if label in W6_TIMED:
        print("\n".join(lines), flush=True)
    print(f"W6 vs plain, {label} (launches {d.w6}, no plain stage): {text}",
          flush=True)


def w6_start_bytes(torch, ctx, packed, mat_type):
    """The bytes W6's start moves on a call, each input read once and each
    output written once: every ray's word, P, D and its medium (a medium
    every ray shares once), and its nine output fields (75 bytes); an
    emissive ray of a textured slot and an environment ray their uv, the
    texels of their taps (four bilinear) and, with a lightmap past the
    camera's bounce, the depth and the lightmap's texel; the colour and
    light-intensity tables once."""
    from raytracer_tpu_torch.materials.base import MAT_EMISSIVE, MAT_ENV
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    n = packed.shape[0]
    per_ray = lambda x: x.dim() == 2 and x.stride(0) != 0
    per = 4 + 12 + 12 + 75 + sum(12 for x in (ctx.n_re, ctx.n_im) if per_ray(x))
    once = sum(12 for x in (ctx.n_re, ctx.n_im) if not per_ray(x))
    data, static, mats = ctx.data, ctx.static, ctx.data.mats
    present = static.mat_types_present
    slot = ctx.mat_slot.long()

    def taps(tt, m):
        """(the rays of m whose slot fetches from tt, their taps)"""
        flags = tt[1][slot.clamp(0, tt[1].shape[0] - 1), 3]
        fetched = m & ((flags & 1) != 0) & (slot < tt[1].shape[0])
        return fetched, int((fetched.long() * (1 + 3 * ((flags & 2) != 0).long())).sum())

    if MAT_EMISSIVE in present:
        tt = ws.texture_tables(mats, mats.emissive_color, static.emissive_tex,
                               data.textures, "w6_emissive")
        once += mats.emissive_color.numel() * 4
        if tt is not None:
            fetched, k = taps(tt, mat_type == MAT_EMISSIVE)
            once += 8 * int(fetched.sum()) + 12 * k
    if MAT_ENV in present and static.env_slots:
        tex, lm = bt.env_tables(data, static)
        once += mats.env_light_intensity.numel() * 4
        m = mat_type == MAT_ENV
        fetched, k = taps(tex, m)
        once += 8 * int(fetched.sum()) + 12 * k
        if lm is not None:        # the depth of a lightmap's ray, its texel past it
            with_lm = taps(lm, m)[0]
            once += 4 * int(with_lm.sum()) + 12 * taps(lm, m & (ctx.depth != 0))[1]
    return n * per + once


def w6_update_bytes(torch, c, miss, acc):
    """The bytes W6's update moves on a call, each input read once and
    each output written once, as this call's data needs them: every ray's
    L, beta, alive, counters and its 85 bytes of output (six (N, 3) float
    rows, alive, three int32 counters); an alive ray's miss; a shaded ray's
    add, cont and did_split, a continuing ray's beta_mult and is_diffuse;
    each of the ray, its direction and its medium from the merged output
    where the ray goes on, else from the carry (a medium every ray shares
    once); rays_traced read and written."""
    n = c.L.shape[0]
    shaded = c.alive & ~miss
    nxt = shaded & acc.cont
    k_al, k_sh, k_nx = int(c.alive.sum()), int(shaded.sum()), int(nxt.sum())
    shared = sum(1 for x in (c.n_re, c.n_im) if x.dim() == 2 and x.stride(0) == 0)
    per = 12 + 12 + 1 + 4 * 3 + (6 * 12 + 1 + 3 * 4) + 12 * 2
    moved = n * per + k_al + k_sh * (12 + 1 + 1) + k_nx * (12 + 1)
    moved += 12 * (2 - shared) * n + 12 * shared * (k_nx + (n - k_nx > 0))
    return moved + (16 if c.rays_traced is not None else 0)


def w6_hold(torch, label):
    """W6 against the plain stages on the calls captured in the render
    `label` (every bounce of its first chunk): every field of every ray
    bit for bit (floats by their bits, or both NaN; a share of exactly
    1.0, required).  In W6_TIMED's each call is timed through a CUDA graph
    (W6 alone) beside the plain stage (events), with its bytes, bound and
    share.  Frees the captures.  Returns (a line a timed call, the text of
    a line)."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    fields = {"bounce_start": ws.FLOAT_FIELDS + ws.BOOL_FIELDS,
              "bounce_update": bt.CARRY_FLOATS + bt.CARRY_OTHERS}
    lines, held = [], dict.fromkeys(W6_ENTRIES, 0)
    for key in sorted(k for k in W6["captured"] if k[0] == label):
        args = W6["captured"].pop(key)
        entry, b = key[1], key[2]
        W6["holding"] = True
        try:
            with torch.no_grad():
                if entry == "bounce_start":
                    got = bt._kernel_start(*args)
                    want = bt.plain_start(args[0], args[2])
                    launch = lambda: bt._launch_start(args[0], args[1])
                    plain = lambda: bt.plain_start(args[0], args[2])
                else:
                    got, want = bt._kernel_update(*args), bt.plain_update(*args)
                    launch = lambda: bt._launch_update(*args)
                    plain = lambda: bt.plain_update(*args)
                share, err = bits_share(torch, got, want, [
                    f for f in fields[entry] if getattr(got, f) is not None])
                W6["max_abs_err"][entry] = max(W6["max_abs_err"][entry], err)
                require(share == 1.0, f"W6 {entry} on the {label} bounce {b}: "
                        f"bit-equal share {share}")
                del got, want
                held[entry] += 1
                if label not in W6_TIMED:
                    continue
                ms = common.graph_ms(launch, W6_REPS)[0]
                plain_ms = common.cuda_ms(plain, 1)
                n_bytes = (w6_start_bytes(torch, *args) if entry == "bounce_start"
                           else w6_update_bytes(torch, *args))
        finally:
            W6["holding"] = False
        if label not in W6_TIMED:
            continue
        n = args[1].shape[0]
        bound_ms = common.bound(0, n_bytes)[0]
        W6["timed"][entry].append(dict(label=label, name=f"{label} bounce {b}", rays=n,
                                       ms=ms, plain_ms=plain_ms, bytes=n_bytes))
        lines.append(f"W6 {entry[7:]} {label} bounce {b}: {n} rays, bit-equal 1.0, "
                     f"W6 {ms:.4f} ms (CUDA graph), bound {bound_ms:.4f} ms (bytes: "
                     f"{n_bytes / 1e6:.1f} MB), share {bound_ms / ms:.4f}, plain "
                     f"{plain_ms:.2f} ms")
        del args
    for k, v in held.items():
        W6["held"][k] += v
    torch.cuda.empty_cache()
    text = (", ".join(f"{k[7:]} {v} calls" for k, v in held.items())
            + " held, bit-equal 1.0")
    for entry, tm in W6["timed"].items():
        mine = [t["ms"] for t in tm if t["label"] == label]
        if mine:
            text += f"; {entry[7:]} {sum(mine) / len(mine):.4f} ms a call"
    return lines, text


def w6_resources(torch):
    """Prints the registers, stack, local memory and resident blocks an SM
    of W6's kernels (`cuobjdump -res-usage`, `bt.info`)."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import cuda_build

    use = resource_usage(cuda_build.build("kernels"))
    parts = []
    for entry, (kernel, _) in W6_ENTRIES.items():
        r = use[next(k for k in use if kernel in k)]
        inf = bt.info(entry)
        parts.append(f"{kernel} {r['REG']} registers, stack {r['STACK']} B, local "
                     f"{r['LOCAL']} B, {inf['blocks_per_sm']} blocks an SM of "
                     f"{inf['block']} threads")
    print("W6 kernels: " + " | ".join(parts), flush=True)


def w6_rows(torch):
    """W6's rows of the kernels line, one an entry at the first timed
    render's first bounce (its most rays): its bound from the bytes it
    moves there, and beside its time the mean a call over that chunk's
    bounces; a line each."""
    from raytracer_tpu_torch.probes import common

    rows = []
    for entry, (kernel, replaces) in W6_ENTRIES.items():
        launches = W6["launches"][entry]
        for label in W6_TIMED:
            require(any(t["label"] == label for t in W6["timed"][entry]),
                    f"W6 {entry} was never timed at {label}")
        timed = [t for t in W6["timed"][entry] if t["label"] == W6_TIMED[0]]
        require(launches > 0, f"W6 {entry} never launched in the driven renders")
        tm = timed[0]
        row = common.row(f"bounce_tail {entry} (W6)", "bounce_tail.cu", replaces,
                         launches, W6["max_abs_err"][entry], tm["ms"], tm["plain_ms"],
                         0, tm["bytes"])
        row["chunk_mean_ms"] = sum(t["ms"] for t in timed) / len(timed)
        rows.append(row)
        print(f"W6 {entry} bound at the {tm['name']} ({tm['rays']} rays, "
              f"{tm['bytes']} bytes): {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"W6 {tm['ms']:.4f} ms, share {row['bound_ms'] / tm['ms']:.4f}, mean "
              f"{row['chunk_mean_ms']:.4f} ms a call over the {len(timed)} bounces "
              f"of its chunk, plain {tm['plain_ms']:.2f} ms | {launches} launches "
              f"in the driven renders, {W6['held'][entry]} calls held", flush=True)
    return rows


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


# ---------------------------------------------------------------------------
# the backward kernels (W6's update and start, W5's): the IoR gradients
# ---------------------------------------------------------------------------


def _bwd_nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bwd_bytes(entry, call, xs, grads, out, wants=None):
    """The bytes a backward kernel moves on a recorded call, each input
    read once and each output written once: the output gradients it reads
    and the forward's tensors it reads (the update: beta, add where L's
    gradient comes, beta_mult where beta's does, the three masks; the
    start: the words' type and slot, uv and the depth where uv or the light
    intensity takes a gradient; W5: the rays' O, D, t, orientation and
    object, and the scene's tables, as `w5_bytes` counts them), and the
    gradients it writes (the tables' per-ray rows of the start; W4's
    diffuse and glossy backward: the tensors they read and write, from one
    more launch of the kernel on the call, `wants` its wanted gradients)."""
    import torch

    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    g = [x for x in grads if x is not None]
    if entry in ("shade_diffuse_bwd", "shade_glossy_bwd"):
        # the saved tensors the kernel reads (a medium every ray shares as
        # its one row, the tables and textures once), the output gradients;
        # the pass-through and input gradients and the tables' rows it
        # writes
        mt, ctx, draws, packed, m = call[:5]
        s = (ws.diff_saved(ctx, draws, packed, m) if entry == "shade_diffuse_bwd"
             else ws.gloss_saved(ctx, draws, packed, m, call[6]))
        one = lambda x: (x[0] if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] > 1
                         and x.stride(0) == 0 else x)
        names = ws._DIFF_SAVED if entry == "shade_diffuse_bwd" else ws._GLOSS_SAVED
        reads = [one(getattr(s, f)) for f in names if f != "mat_slot"]
        rows = (ws._diffuse_rows if entry == "shade_diffuse_bwd" else ws._glossy_rows)(
            grads, s, wants)
        written = [rows[0], rows[1], rows[2]] + ([rows[3]] if len(rows) > 4 else [])
        flat = []
        for part in written:
            vals = part.values() if isinstance(part, dict) else part
            for v in vals:
                flat.extend(x for x in (v if isinstance(v, (tuple, list)) else [v])
                            if isinstance(x, torch.Tensor))
        return _bwd_nbytes(*g, *reads, *flat)
    if entry == "shade_refractive_bwd":
        # the rays' state, draws and words (a medium every ray shares as its
        # one row), the tables; the pass-through and input gradients, and
        # the tables' per-ray rows in place of their gradients
        mt, ctx, draws, packed, m = call[:5]
        s = ws.refr_saved(ctx, draws, packed, m)
        one = lambda x: x[0] if x.shape[0] > 1 and x.stride(0) == 0 else x
        # P is not read: its gradient is new_origin's alone
        reads = [s.m, s.packed, s.N, s.D, s.eps, s.t, s.orient, one(s.n_re),
                 one(s.n_im), s.depth, s.pattern, s.split_cnt, s.u, s.hero, s.m_re,
                 s.m_im, s.dispersive, s.scene_re, s.scene_im]
        nw = len(ws.WRITTEN[mt])
        rows = sum(x is not None for name, x in zip(ws._REFR_INPUTS, out[nw:])
                   if name in ws._REFR_ROWS)
        written = [x for name, x in zip(ws._REFR_INPUTS, out[nw:])
                   if name not in ws._REFR_ROWS]
        return _bwd_nbytes(*g, *reads, *out[:nw], *written) + rows * 12 * m.shape[0]
    if entry == "bounce_update_bwd":
        v = dict(zip(bt._UPDATE_FLOATS, xs)) | dict(zip(bt._UPDATE_OTHERS, call[0]))
        reads = [v["beta"], v["add"] if grads[0] is not None else None,
                 v["beta_mult"] if grads[1] is not None else None,
                 v["alive"], v["miss"], v["cont"]]
        return _bwd_nbytes(*g, *reads, *out)
    if entry in ("bounce_start_bwd", "bounce_start_bwd_taps"):
        # the texel taps' rows and texel rows where a texture takes a
        # gradient (ops/bounce_tail.py `start_texture_refs`)
        ctx, _, mat_type, _, _ = call
        n = mat_type.shape[0]
        k = len(bt._START_RAYS) + 2
        refs = bt.start_texture_refs(ctx.data, ctx.static)
        taps = (sum(4 if r[1] else 1 for r in refs) * n * 20
                if any(out[k + r[0]] is not None for r in refs) else 0)
        rows = out[4] is not None or out[6] is not None or taps
        return _bwd_nbytes(*g, mat_type, ctx.mat_slot, *((ctx.uv, ctx.depth) if rows
                                                          else ()), *out[:5]) \
            + (out[5].numel() * 4 if out[5] is not None else 0) + taps
    obj, data, static, modes, names, texs = call[:6]
    _, keep = ha.scene_struct(data, static)
    table, tri, corners, inst, packed, maps = keep
    tabs = [table, *tri.values(), *corners.values(), *inst.values()]
    if not modes[2] and static.normal_maps:
        # the MAPS instance reads the maps' tables and texels
        tabs += [x for x in maps.values() if isinstance(x, torch.Tensor)]
    # the TABLES instance: a row a ray of each table that took a gradient;
    # the maps' taps' rows (20 bytes a tap a ray) where a map's texture did
    rows = sum(obj.shape[0] * getattr(data.geom, x)[0].numel() * 4
               for x, o in zip(names, out[4:]) if o is not None)
    if any(o is not None for o in out[4 + len(names):]):
        rows += sum(4 if r.bilinear else 1 for r in static.normal_maps) * obj.shape[0] * 20
    return _bwd_nbytes(*g, *xs[:3], obj, None if modes[2] else xs[3], *out[:3],
                       *tabs) + rows


# the SASS function of each backward entry whose name the kernels line's
# (BWD_ENTRIES) leaves ambiguous: the diffuse backward's instances (the caps
# pdf's sum in registers, or by ATen's general plan from 128 caps)
BWD_SASS = {"shade_diffuse_bwd": ("shade_diffuse_bwd_kernelILi0E",
                                  "shade_diffuse_bwd_kernelILi1E")}


def bwd_slots(entry, f, call, xs):
    """The FP32 issue slots of a backward kernel's recorded call: the FP32
    instructions of one ray's pass on the path that takes every gradient
    (`common.bwd_pass` off the kernel's SASS: the float work alone, no
    load, store, integer or control instruction, so that the count does
    not grow with the implementation), its inner loops counted for the
    call (a glossy call's light loop its lights, its texture refs' loops
    its refs on their shortest path, 0 on a call with none; a refractive
    call's Fresnel loops its three channels; W5's loop over the kinds the
    scene's present, its MAPS instance's over the maps first), times the
    call's rays.  The diffuse backward and W6's start, whose rays take exclusive
    branches by their draw (caps, environment or cosine lobe) or material
    (emissive, environment or neither), on their shortest path, and the
    diffuse's caps loops not at all: lower counts.  Returns (slots, FP32
    instructions a ray, trips, the inner loops as `bwd_pass` lists
    them)."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common

    if "sass" not in BWD:
        BWD["sass"] = common.cuobjdump_sass(cuda_build.build("kernels"))
    kernel, heavy, every_if, small = BWD_ENTRIES[entry][3], 20, True, 1
    if f is ws._Shade:
        mt, ctx, m = call[0], call[1], call[4]
        n, st = m.shape[0], ctx.static
        trips = {ws.MAT_GLOSSY: st.n_dir_lights + st.n_point_lights + st.n_spot_lights,
                 ws.MAT_REFRACTIVE: 3, ws.MAT_DIFFUSE: 0}[mt]
        if mt == ws.MAT_GLOSSY:
            # the light loop; a texture ref's loops hold < 50
            heavy, small = 100, len(st.glossy_tex)
        every_if = mt != ws.MAT_DIFFUSE
        if entry in BWD_SASS:
            kernel = BWD_SASS[entry][int(st.n_is_targets >= 128)]
    elif f is ha._Attrs:
        static = call[2]
        kinds = sum(1 for k in ha.KINDS if static.kind_counts[k])
        n = call[0].shape[0]
        trips = (len(static.normal_maps), kinds) if entry.endswith("maps") else kinds
    elif f is bt._Start:
        n, trips, every_if = call[2].shape[0], 1, False
    else:
        n, trips = xs[bt._UPDATE_FLOATS.index("beta")].shape[0], 1
    key = (kernel, trips, heavy, every_if, small)
    if key not in BWD["slots"]:
        BWD["slots"][key] = common.bwd_pass(BWD["sass"], kernel, trips, heavy=heavy,
                                            every_if=every_if, small=small)
    each, loops = BWD["slots"][key]
    return n * each, each, trips, loops


def _bwd_rows_fn(f, call, xs, grads, wants):
    """A function of no argument launching the backward kernel of a
    recorded call of `_Attrs` or `_Start` alone (`hit_attrs._attrs_rows`,
    `bounce_tail._start_rows`: the gradients and the per-ray rows, without
    their reductions)."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    if f is ha._Attrs:
        obj, data, static, modes, names, texs = call[:6]
        g = grads[:len(ha.FLOAT_FIELDS)]
        return lambda: ha._attrs_rows(g, *xs[:4], obj, data, static, modes, wants,
                                      names=names, texs=texs)
    ctx, _, mat_type, _, _ = call
    g = grads[:len(ws.FLOAT_FIELDS)]
    return lambda: bt._start_rows(g, mat_type, ctx.mat_slot, ctx.depth, ctx.uv,
                                  ctx.data, ctx.static, wants)


def bwd_module(f):
    """The ops module of a recorded backward's Function (its
    `backward_pair`)."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    return {ha._Attrs: ha, ws._Shade: ws}.get(f, bt)


def _bwd_holds(torch, calls, gen, name, entries, redraw=False):
    """Each recorded backward call replayed through its kernel and through
    the plain VJP (with output gradients drawn from `gen` where `redraw`,
    finite, in place of the recorded ones, and every input of W4's blocks
    wanted, the textures too), every output compared by its
    bits (NaN equal to NaN): {entry: [entries equal, entries, entries
    finite on both sides, entries the finite share counts]}, and the calls
    that launched their kernel, by entry, as (the Function, call, inputs,
    gradients, wants, outputs).  The finite share of W4's backward kernels
    counts the per-ray entries of the block's own rays (its mask, the rays
    that hit): the others' are the pass-through of the +0 the merge hands
    them, finite whatever the kernel does, and a miss is object 0's hit at
    t = FARAWAY (Cornell's object 0 is its glass sphere), whose normal
    (~1e28) overflows the blocks' products, so its gradients are NaN in
    the plain VJP whatever gradient comes; every entry is held bit for bit
    all the same."""
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws

    kinds = {bt._Update: "bounce_update_bwd", bt._Start: "bounce_start_bwd",
             ha._Attrs: "hit_attrs_bwd"}
    from raytracer_tpu_torch.utils.constants import FARAWAY

    counts = {k: [0, 0, 0, 0] for k in entries}
    launched = {k: [] for k in entries}
    n_bwd = lambda: (sum(bt.backward_launches().values()) + ha.backward_launches()
                     + sum(ws.backward_launches().values()))
    with held(BWD):
        for f, call, xs, grads, wants in calls:
            if redraw:
                grads = tuple(None if g is None else torch.randn(
                    g.shape, generator=gen, device=g.device, dtype=g.dtype) for g in grads)
                if f is ws._Shade:
                    # every input's gradient wanted (the tables' rows and
                    # their reductions too, the textures' taps)
                    wants = (True,) * len(wants)
            entry = W4_BWD[call[0]] if f is ws._Shade else kinds[f]
            kernel, plain = bwd_module(f).backward_pair(f, call, xs, grads, wants)
            require(kernel is not None, f"backward {name}: {entry} took a plain route")
            n0 = n_bwd()
            t0 = (ha.backward_launches(tables=True), bt.backward_launches(taps=True),
                  ha.backward_launches(maps=True))
            got, want = kernel(), plain()
            if ha.backward_launches(tables=True) > t0[0]:
                entry = "hit_attrs_bwd_tables"
            if bt.backward_launches(taps=True) > t0[1]:
                entry = "bounce_start_bwd_taps"
            if ha.backward_launches(maps=True) > t0[2]:
                entry = "hit_attrs_bwd_maps"
            own = call[4] & (call[1].t < FARAWAY) if f is ws._Shade else None
            for x, y in zip(got, want):
                require((x is None) == (y is None),
                        f"backward {name}: {entry} defines other gradients")
                if x is None:
                    continue
                eq = (x.view(torch.int32) == y.view(torch.int32)) | (
                    torch.isnan(x) & torch.isnan(y))
                fin = torch.isfinite(x) & torch.isfinite(y)
                c = counts[entry]
                c[0], c[1] = c[0] + int(eq.sum()), c[1] + eq.numel()
                held_fin = fin
                if own is not None and x.dim() and x.shape[0] == own.shape[0]:
                    held_fin = fin[own]
                c[2], c[3] = c[2] + int(held_fin.sum()), c[3] + held_fin.numel()
                if bool(fin.any()):
                    BWD["max_abs_err"][entry] = max(BWD["max_abs_err"][entry],
                                                    float((x - y)[fin].abs().max()))
            if n_bwd() > n0:
                launched[entry].append((f, call, xs, grads, wants, got))
    return counts, launched


def backward_phase(torch, dev):
    """W6's, W5's and W4's backward kernels on the card, in the gradient of
    the IoR (refr_n_re requiring grad) at DIFF_W x DIFF_H x DIFF_SPP of the
    glass sphere, its icosphere twin, Cornell and the primitives (discs and
    cylinders) on the wavefront, in the primitives' colour gradient
    (diffuse_color, glossy_color and glossy_n_re in one backward pass), and
    in the gradients of textures, geometry tables and normal maps: the
    primitives' checkered floor (a glossy colour texture), every texture of
    examples/torch_features.py `lit_textures` (a diffuse, a glossy, an
    emissive image and the sky), the sphere's centres and radii, the
    icosphere's corners and corner normals, and the enclosed normal-mapped
    scene's map, diffuse colour and the tables its maps read
    (scripts/torch_grad_ab.py `leaf` names each leaf; the gradients finite
    in both packages at 16x16 x 2 spp, tests/test_torch_diff.py, must be
    finite and nonzero here; each but the IoR ones taken twice, the two
    passes bit-equal): each gradient with the backward
    kernels' counts set to 0 just before and read just after, every
    backward call of `_Start`, `_Update`, `_Attrs` and `_Shade` recorded
    (ops/plain_grad.py `recording`), the plain W6 stages, W5's plain
    formulas and W4's plain diffuse, refractive and glossy blocks counted
    on the card (none may run: the backward passes take the kernels), the
    plain-VJP routes of W4 counted (none taken).  Then
    each recorded call replayed through its backward kernel and through the
    plain VJP, every output held bit for bit (a share of exactly 1.0 each),
    beside the share of entries finite on both sides; and again with finite
    output gradients drawn from a seed in place of the recorded ones
    (Cornell's and the primitives' recorded IoR gradients are NaN on many
    rays, in the JAX package's gradient too: there every kind's formula is
    held on finite numbers), whose finite share must reach BWD_FINITE.
    Each call that launched a kernel timed with the L2 cold
    (`common.cold_ms`), its bound the larger of its FP32 issue slots
    (`bwd_slots`) and its bytes (`bwd_bytes`); a kernel's time is the
    mean a call (W4's backward kernels: the kernel alone, and beside it the
    whole VJP with the tables' reductions); the plain VJP on the same calls
    (events); the kernels' registers, stack and blocks an SM.  Returns the
    kernels line's rows (the sphere's calls; W4's diffuse and glossy
    backward: the primitives' colour gradient's; W5's TABLES and MAPS
    instances: the sphere tables' and the normal-mapped scene's; W6's start
    TAPS instance: lit textures')."""
    import raytracer_tpu_torch.ops.plain_grad as pg
    import torch_cornellbox
    import torch_features
    import torch_primitives
    from raytracer_tpu_torch.diff import differentiable_render
    from torch_grad_ab import leaf, with_leaves
    from raytracer_tpu_torch.materials import shade
    from raytracer_tpu_torch.ops import bounce_tail as bt
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.ops import hit_attrs as ha
    from raytracer_tpu_torch.ops import wavefront_shade as ws
    from raytracer_tpu_torch.probes import common
    from torch_inverse_rendering import TRUE_N, build_mesh_scene, build_scene

    t_phase = time.perf_counter()
    (WORK / "bwd").mkdir(parents=True, exist_ok=True)
    w6w5 = ("bounce_update_bwd", "bounce_start_bwd", "hit_attrs_bwd")
    ior = ("refr_n_re",)
    colour = ("diffuse_color", "glossy_color", "glossy_n_re")
    corners = tuple(f"geom.tri_{k}" for k in ("p1", "p2", "p3", "vn1", "vn2", "vn3"))
    tables_bwd = ("bounce_update_bwd", "bounce_start_bwd", "hit_attrs_bwd_tables",
                  "shade_refractive_bwd")
    # (scene, the tables the gradient takes, the backward kernels that must
    # launch in it)
    scenes = {
        "sphere": (lambda: build_scene(TRUE_N, DIFF_W, DIFF_H), ior,
                   (*w6w5, "shade_refractive_bwd")),
        "icosphere": (lambda: build_mesh_scene(TRUE_N, DIFF_W, DIFF_H, WORK / "bwd"), ior,
                      (*w6w5, "shade_refractive_bwd")),
        "Cornell": (lambda: torch_cornellbox.build_cornell(DIFF_W, DIFF_W), ior,
                    (*w6w5, "shade_refractive_bwd", "shade_diffuse_bwd")),
        "primitives": (lambda: torch_primitives.primitives(DIFF_W, DIFF_H), ior,
                       (*w6w5, "shade_refractive_bwd", "shade_diffuse_bwd",
                        "shade_glossy_bwd")),
        # the colour tables: the start's and W5's inputs take no gradient
        "primitives colour": (lambda: torch_primitives.primitives(DIFF_W, DIFF_H), colour,
                              ("bounce_update_bwd", "shade_diffuse_bwd",
                               "shade_glossy_bwd")),
        # the textures: their taps' rows
        "primitives texture": (lambda: torch_primitives.primitives(DIFF_W, DIFF_H),
                               ("textures.0",), ("bounce_update_bwd", "shade_glossy_bwd")),
        "lit textures": (lambda: torch_features.lit_textures(DIFF_W, DIFF_H), ("textures",),
                         ("bounce_update_bwd", "bounce_start_bwd_taps",
                          "shade_diffuse_bwd", "shade_glossy_bwd")),
        # the geometry tables: W5's TABLES instance
        "sphere tables": (lambda: build_scene(TRUE_N, DIFF_W, DIFF_H),
                          ("geom.sphere_center", "geom.sphere_radius"), tables_bwd),
        "icosphere tables": (lambda: build_mesh_scene(TRUE_N, DIFF_W, DIFF_H, WORK / "bwd"),
                             corners, tables_bwd),
        # the normal maps: W5's MAPS instance, the map's taps and the tables
        # the maps read (the scene enclosed: no ray misses, object 0 carries
        # no map)
        "normal-mapped": (lambda: torch_features.normal_mapped(
                              DIFF_W, DIFF_H, obj_dir=WORK / "bwd", enclosed=True),
                          ("textures.0", "diffuse_color", "geom.plane_u_axis",
                           "geom.box_basis", "geom.tri_tan"),
                          ("bounce_update_bwd", "hit_attrs_bwd_maps", "shade_diffuse_bwd",
                           "shade_glossy_bwd")),
    }
    # the gradients finite in both packages (tests/test_torch_diff.py); each
    # but the IoR ones taken twice (F4)
    finite_in_both = ("sphere", "icosphere", "primitives colour", "primitives texture",
                      "lit textures", "sphere tables", "icosphere tables", "normal-mapped")
    saved = [(bt, "plain_start", bt.plain_start), (bt, "plain_update", bt.plain_update),
             (ha, "hit_attributes", ha.hit_attributes),
             (ha, "_apply_normal_maps", ha._apply_normal_maps),
             (shade, "shade_refractive", shade.shade_refractive),
             (shade, "shade_diffuse", shade.shade_diffuse),
             (shade, "shade_glossy", shade.shade_glossy)]
    plain_stages_counted(BWD, "plain_W6", BWD, "plain_W5", "plain_W5")
    # the plain W4 blocks on the card outside a hold: W4's forward is its
    # kernels, and so is its backward
    for name in ("shade_refractive", "shade_diffuse", "shade_glossy"):
        setattr(shade, name, card_counted(getattr(shade, name),
                                          lambda ctx, *a: ctx.P.device, BWD, "plain_W4"))
    gen = torch.Generator(device=dev).manual_seed(24)
    entries = tuple(BWD_ENTRIES)
    rows = {}
    try:
        for name, (make, tables, need) in scenes.items():
            fn, data = differentiable_render(make(), DIFF_SPP, seed=0, device=dev)
            before = {k: BWD[k] for k in ("plain_W6", "plain_W5", "plain_W4")}
            bt.reset_launches()
            ha.reset_launches()
            ws.reset_launches()
            calls = []

            paths = (tuple(f"textures.{k}" for k in range(len(data.textures)))
                     if tables == ("textures",) else tables)

            def grad():
                xs = [leaf(data, p).clone().requires_grad_(True) for p in paths]
                img = fn(with_leaves(data, paths, xs))
                return torch.autograd.grad(torch.mean(img ** 2), xs)

            with pg.recording(calls, bt._Start, bt._Update, ha._Attrs, ws._Shade):
                gs = grad()
                torch.cuda.synchronize()
            launched = {**bt.backward_launches(),
                        "bounce_start_bwd": bt.backward_launches()["bounce_start_bwd"]
                        - bt.backward_launches(taps=True),
                        "bounce_start_bwd_taps": bt.backward_launches(taps=True),
                        "hit_attrs_bwd": ha.backward_launches()
                        - ha.backward_launches(tables=True)
                        - ha.backward_launches(maps=True),
                        "hit_attrs_bwd_tables": ha.backward_launches(tables=True),
                        "hit_attrs_bwd_maps": ha.backward_launches(maps=True),
                        **ws.backward_launches()}
            routes = {f"W4 {k}": v for k, v in ws.plain_routes.items()}
            runs = {k[len("plain_"):]: BWD[k] - before[k] for k in before}
            for k, v in launched.items():
                BWD["launches"][k] += v
            # Cornell's and the primitives' IoR gradients are NaN, as the JAX
            # package's are (tests/test_torch_diff.py); the holds below are
            # what is required of them
            finite = all(bool(torch.isfinite(g).all()) for g in gs)
            require(name not in finite_in_both
                    or (finite and all(float(g.abs().max()) > 0 for g in gs)),
                    f"backward {name}: gradient finite {finite}, largest "
                    f"{[float(g.abs().max()) for g in gs]}")
            require(all(launched[k] > 0 for k in need),
                    f"backward {name}: backward kernel launches {launched}")
            require(runs == {"W6": 0, "W5": 0, "W4": 0},
                    f"backward {name}: plain stages ran on the card {runs}")
            require(not any(routes.values()),
                    f"backward {name}: plain-VJP routes taken {routes}")
            again = ""
            if name in finite_in_both and tables != ior:
                # F4: a second backward pass gives the same bits
                gs2 = grad()
                same = all(bool((a.view(torch.int32) == b.view(torch.int32)).all())
                           for a, b in zip(gs, gs2))
                require(same, f"backward {name}: two backward passes differ")
                again = f", a second pass bit-equal {same}"
            # hold every recorded call bit for bit, then with finite gradients
            counts, timed = _bwd_holds(torch, calls, gen, name, entries)
            drawn, _ = _bwd_holds(torch, calls, gen, name, entries, redraw=True)
            shares = {k: counts[k][0] / max(counts[k][1], 1) for k in need}
            fin = {k: counts[k][2] / max(counts[k][3], 1) for k in need}
            d_shares = {k: drawn[k][0] / max(drawn[k][1], 1) for k in need}
            d_fin = {k: drawn[k][2] / max(drawn[k][3], 1) for k in need}
            require(all(c[0] == c[1] for c in (*counts.values(), *drawn.values()))
                    and all(counts[k][1] > 0 and drawn[k][1] > 0 and timed[k] for k in need),
                    f"backward {name}: bit-equal shares {shares}, with drawn gradients "
                    f"{d_shares}, calls that launched {[k for k in need if timed[k]]}")
            require(all(v >= BWD_FINITE for v in d_fin.values())
                    and (name not in ("sphere", "icosphere")
                         or all(v >= BWD_FINITE for v in fin.values())),
                    f"backward {name}: finite shares {fin}, with drawn gradients {d_fin}")
            # time every call that launched its kernel, the L2 cold
            parts = []
            for entry in need:
                ms, plain_ms, n_bytes, whole_ms, slots = [], [], [], [], []
                for f, call, xs, grads, wants, got in timed[entry]:
                    kernel, plain = bwd_module(f).backward_pair(f, call, xs, grads, wants)
                    if f is ws._Shade:
                        # the kernel alone (its gradients and the tables'
                        # rows), then the whole VJP with the tables'
                        # reductions
                        mt = call[0]
                        s = (ws.refr_saved(*call[1:5]) if mt == ws.MAT_REFRACTIVE
                             else ws.diff_saved(*call[1:5]) if mt == ws.MAT_DIFFUSE
                             else ws.gloss_saved(*call[1:5], call[6]))
                        rows_fn = {ws.MAT_REFRACTIVE: ws._refractive_rows,
                                   ws.MAT_DIFFUSE: ws._diffuse_rows,
                                   ws.MAT_GLOSSY: ws._glossy_rows}[mt]
                        ms.append(common.cold_ms(lambda: rows_fn(grads, s, wants),
                                                 W6_REPS)[0])
                        whole_ms.append(common.cold_ms(kernel, W6_REPS)[0])
                    elif entry in ("hit_attrs_bwd_tables", "hit_attrs_bwd_maps",
                                   "bounce_start_bwd_taps"):
                        # the kernel alone (its rows), then the whole VJP with
                        # the rows' scans
                        ms.append(common.cold_ms(_bwd_rows_fn(f, call, xs, grads, wants),
                                                 W6_REPS)[0])
                        whole_ms.append(common.cold_ms(kernel, W6_REPS)[0])
                    else:
                        ms.append(common.cold_ms(kernel, W6_REPS)[0])
                    with held(BWD):
                        plain_ms.append(common.cuda_ms(plain, 1))
                    n_bytes.append(bwd_bytes(entry, call, xs, grads, got, wants))
                    slots.append(bwd_slots(entry, f, call, xs))
                n = len(ms)
                row = common.row(BWD_ENTRIES[entry][0], BWD_ENTRIES[entry][1],
                                 BWD_ENTRIES[entry][2], 0, 0.0, sum(ms) / n,
                                 sum(plain_ms) / n, sum(x[0] for x in slots) / n,
                                 sum(n_bytes) / n)
                share = [common.bound(x[0], b)[0] / t
                         for x, b, t in zip(slots, n_bytes, ms)]
                whole = (f"; with the tables' reductions {sum(whole_ms) / n:.4f} ms"
                         if whole_ms else "")
                t_ops = common.bound(sum(x[0] for x in slots) / n, 0)[0]
                t_bytes = common.bound(0, sum(n_bytes) / n)[0]
                parts.append(f"{entry} {n} calls of {timed[entry][0][2][0].shape[0]} rays, "
                             f"cold {row['ms']:.4f} ms a call ({min(ms):.4f}-{max(ms):.4f}"
                             f"{whole}; plain VJP {row['plain_ms']:.3f} ms), "
                             f"{sum(n_bytes) / n:.0f} bytes ({t_bytes:.4f} ms), "
                             f"{slots[0][1]} FP32 instructions a ray x {slots[0][2]} trips "
                             f"of its loops {slots[0][3]} ({t_ops:.4f} ms), bound "
                             f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
                             f"share {row['bound_ms'] / row['ms']:.4f} "
                             f"({min(share):.4f}-{max(share):.4f})")
                if (name == "sphere" and entry in w6w5 + ("shade_refractive_bwd",)) or (
                        name == "primitives colour" and entry in ("shade_diffuse_bwd",
                                                                  "shade_glossy_bwd")) or (
                        name == "sphere tables" and entry == "hit_attrs_bwd_tables") or (
                        name == "normal-mapped" and entry == "hit_attrs_bwd_maps") or (
                        name == "lit textures" and entry == "bounce_start_bwd_taps"):
                    rows[entry] = row
            grad_text = ", ".join(f"d loss / d {k}: largest |.| {float(g.abs().max()):.6e}"
                                  for k, g in zip(paths, gs))
            print(f"backward {name}: gradient of {', '.join(paths)} {DIFF_W}x{DIFF_H} x "
                  f"{DIFF_SPP} spp (finite {finite}{again}, {grad_text}), "
                  f"{len(calls)} backward calls recorded | launches {launched} | plain "
                  f"stages on the card {runs} | plain-VJP routes {routes} | bit-equal "
                  f"shares {shares}, finite on both sides {fin} | with drawn gradients "
                  f"bit-equal {d_shares}, finite {d_fin} | " + " | ".join(parts),
                  flush=True)
            del fn, data, calls, timed
            torch.cuda.empty_cache()
    finally:
        for obj, n, v in saved:
            setattr(obj, n, v)
    use = resource_usage(cuda_build.build("kernels"))
    parts = []
    for entry in entries:
        kernel = BWD_ENTRIES[entry][3]
        r = use[next(k for k in use if kernel in k)]
        mt = next((t for t, e in W4_BWD.items() if e == entry), None)
        inf = (ha.info(backward=True, tables=entry.endswith("tables"),
                       maps=entry.endswith("maps"))
               if entry.startswith("hit_attrs_bwd")
               else ws.info(mt, backward=True) if mt is not None else bt.info(entry))
        parts.append(f"{kernel} {r['REG']} registers, stack {r['STACK']} B, local "
                     f"{r['LOCAL']} B, {inf['blocks_per_sm']} blocks an SM of "
                     f"{inf['block']} threads")
    print("backward kernels: " + " | ".join(parts)
          + f" | phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    out = []
    for entry in entries:
        row = rows[entry]
        row["launches"] = BWD["launches"][entry]
        row["max_abs_err"] = BWD["max_abs_err"][entry]
        out.append(row)
    BWD["rows"] = out
    return out


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

    # ---- the backward kernels: W6's and W5's, in the IoR gradients ----
    backward_phase(torch, dev)

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
    sys.path.insert(0, str(ROOT / "tests"))
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
        # the phase of W4 and W5 alone (after the build), for working on
        # them
        w4_phase(torch, dev)
        print(json.dumps({"kernels": [*w4_rows(torch), *w5_rows(torch),
                                      *w6_rows(torch)]}, default=float))
        return 0

    if "--backward" in sys.argv[1:]:
        # the backward kernels' phase alone (after the build), for working
        # on them
        print(json.dumps({"kernels": backward_phase(torch, dev)}, default=float))
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
                                  *w3_rows, *w4_rows(torch), *w5_rows(torch),
                                  *w6_rows(torch), *BWD["rows"]]
                      + probe_rows}, default=float))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
