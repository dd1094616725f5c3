"""Hopper probes: hand-written CUDA kernels that measure the card.

Counterparts of the TPU probes under scripts/ (P1-P6 in PERF.md), each a
kernel in csrc/probe_*.cu with a plain PyTorch version beside it:

- issue_peak (P1, scripts/vpu_peak.py): the unfused FP32 issue peak and
  the slot cost of div, sqrt, rsqrt, exp, sin, select, convert and mask;
- roofline (P2, scripts/roofline.py): the streamed fma chains (the fused
  and unfused peaks; kernels in probe_issue.cu), the work of the render
  kernels K1 and K2 counted from the plain versions' events, and their
  bound;
- isect_cost (the check of P2's count): the measured cost of one
  nearest-hit test of each kind, as the render kernels run it;
- tri_sweep (P3, scripts/probe_pairwise.py / probe_pairwise2.py; P4,
  scripts/probe_mesh_sweep.py): ray x triangle nearest hit, blocked,
  warp-parallel, looped and unrolled;
- dead_bounce (P5, scripts/probe_when_skip.py): what a warp pays for
  lanes whose path has ended;
- gather (P6, scripts/probe_vmem_gather.py): per-lane texel fetches from
  device memory and from shared memory, at the script's size and at the
  replay's.

Each runs on the card as `python -m raytracer_tpu_torch.probes.<name>`
and prints one JSON line with the card's name and power limit.  The
wrappers take CPU tensors to the plain versions (the CPU tests) and launch
the kernel for CUDA tensors; a measurement without a card raises.
"""
