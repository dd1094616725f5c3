#!/usr/bin/env python3
"""How many device events torch.profiler loses at the edges of a session,
on one CUDA device.

    python scripts/torch_profiler_edges.py [--children 8] [--sessions 60]

Runs `--children` processes one after another, alternately without idle
at the session's edges (pad 0) and with `common.PROFILE_PAD_S` of it.
Each process takes `--sessions` profiler sessions of 20 calls of P6's
base gather at the script's shape (what `gather.profile_check` profiles)
through `common.profiled_events`, and counts the gather_base_kernel
events of each.  Prints the card's name and power limit, one line a
process, and as the last line one JSON object: for each pad, the
sessions, those that recorded fewer events than calls, and the events
lost.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CALLS = 20


def child(pad_s, sessions):
    import torch

    from raytracer_tpu_torch.probes import common, gather

    dev = common.require_card()
    table, idx = (torch.from_numpy(a).to(dev) for a in gather.inputs())
    call = lambda: gather.gather(table, idx, "base")
    common.graph_ms(call, CALLS)
    print(json.dumps([sum("gather_base_kernel" in e.name
                          for e in common.profiled_events(call, CALLS, pad_s))
                      for _ in range(sessions)]))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--children", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=60)
    ap.add_argument("--child", type=float, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if a.child is not None:
        return child(a.child, a.sessions)
    from raytracer_tpu_torch.probes import common

    print(common.device_info()["nvidia_smi"], flush=True)
    out = {}
    for i in range(a.children):
        pad = (0.0, common.PROFILE_PAD_S)[i % 2]
        res = subprocess.run([sys.executable, __file__, "--child", str(pad),
                              "--sessions", str(a.sessions)], cwd=ROOT,
                             capture_output=True, text=True, timeout=600, check=True)
        counts = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"pad {pad} s: {counts}", flush=True)
        o = out.setdefault(f"pad_{pad}_s", {"sessions": 0, "short": 0, "lost": 0})
        o["sessions"] += len(counts)
        o["short"] += sum(c < CALLS for c in counts)
        o["lost"] += sum(CALLS - c for c in counts)
    print(json.dumps({"calls_a_session": CALLS, **out}))


if __name__ == "__main__":
    main(sys.argv[1:])
