#!/usr/bin/env python3
"""Time the gather probe's kernels (P6: csrc/probe_gather.cu,
raytracer_tpu_torch/probes/gather.py) of a checkout on one CUDA device,
as the device runs them.

    python3 scripts/torch_gather_ab.py [--root DIR] [OUT.json]

--root takes the raytracer_tpu_torch package of another checkout (for
example an older commit unpacked under build/): its `gather` wrapper and
plain version, its kernels built from its own csrc/.  Each mode (ldg,
smem, base) is held bit for bit against that package's plain version,
then timed in ROUNDS rounds by this checkout's `common.graph_ms` (the
wrapper's launches replayed from a CUDA graph, so the Python around a
launch is not in the time) and once by CUDA events around the wrapper's
calls (`common.cuda_ms`, the time a caller sees), at two shapes:

- the script's: scripts/probe_vmem_gather.py's 1 M rays over T = 104,967
  (smem at its cut, that package's `smem_entries()`);
- the replay's: the table entries and rays of chip_smoke.py's
  `replay_scale` for example 2 at 400x300 x 64 spp (the texture atlas's
  1,048,576 entries, 4 bounces x 3.84 M rays).

Run it once per root, "A B B A", to compare two checkouts on one card.
The last line is one JSON object (also written to OUT.json if given).
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPS = 20
ROUNDS = 3
REPLAY = (1 << 20, 4 * 3_840_000)


def load(root):
    """(this checkout's graph_ms and cuda_ms, the gather module of root's
    package).  The timers are taken from this checkout first; then, for
    another root, its package replaces this one in sys.modules (the timer
    functions keep their own module)."""
    sys.path.insert(0, str(HERE))
    from raytracer_tpu_torch.probes.common import cuda_ms, graph_ms
    if root != HERE:
        for name in [m for m in sys.modules if m.split(".")[0] == "raytracer_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(root))
    from raytracer_tpu_torch.probes import gather
    return graph_ms, cuda_ms, gather


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("out", nargs="?")
    opt = ap.parse_args()
    root = opt.root.resolve()
    graph_ms, cuda_ms, gather = load(root)
    import torch

    dev = torch.device("cuda:0")
    cut = gather.smem_entries()
    res = {"root": str(root), "device": torch.cuda.get_device_name(0), "smem_T": cut,
           "shapes": {}}
    for shape, (entries, rays) in (("script", (gather.T, gather.N)),
                                   ("replay", REPLAY)):
        n = -(-rays // 128) * 128
        table, idx = (torch.from_numpy(a).to(dev) for a in gather.inputs(n, entries))
        mods = {"ldg": entries, "smem": min(entries, cut), "base": entries}
        reps = REPS if shape == "script" else REPS // 2
        calls = {m: (lambda m=m: gather.gather(table, idx, m, mods[m]))
                 for m in gather.MODES}
        for mode in gather.MODES:
            got = calls[mode]()
            want = gather.gather_reference(table, idx, mods[mode], mode != "base")
            if not torch.equal(got, want):
                raise RuntimeError(f"{root}: P6 {mode} at the {shape} shape differs "
                                   "from its plain version")
        del got, want
        times = {m: [] for m in gather.MODES}
        for _ in range(ROUNDS):
            for mode in gather.MODES:
                times[mode].append(graph_ms(calls[mode], reps)[0])
        res["shapes"][shape] = {
            "T": entries, "rays": n,
            **{m: {"T": mods[m], "ms": statistics.mean(times[m]), "rounds_ms": times[m],
                   "wrapper_ms": cuda_ms(calls[m], reps),
                   "ns_per_fetch": statistics.mean(times[m]) * 1e6 / (6 * n)}
               for m in gather.MODES}}
        del table, idx
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if opt.out:
        Path(opt.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
