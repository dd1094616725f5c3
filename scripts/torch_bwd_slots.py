"""The FP32 issue slots a ray of W4's glossy and refractive backward
kernels in one or more checkouts, counted as chip_smoke.py --backward
counts its rows' bound (probes/common.py `bwd_pass`), so that a kernel's
redesign and its parent stand against the same count.

    python3 scripts/torch_bwd_slots.py build/parent .    # needs nvcc, no card

Each checkout's csrc/wavefront_glossy_bwd.cu and csrc/wavefront_shade_bwd.cu
are compiled alone with this checkout's flags (ops/cuda_build.py
NVCC_FLAGS), one nvcc each, all started together; their SASS is read with
cuobjdump and counted by this checkout's `bwd_pass`.  Prints a line a
checkout: the glossy kernel's FP32 instructions a ray outside its loops
and in each loop (the light loop, the texture refs' loops), the
refractive kernel's outside and in its channel loops, and each kernel's
ptxas registers and stack; the count of a call is the outside plus each
loop times its trips (chip_smoke.py `bwd_slots`).  The last line is the
counts as one JSON object.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (source, kernel, bwd_pass's heavy): the glossy's light loop holds about
# 200 FMULs, its texture refs' loops fewer than 50
KERNELS = (("wavefront_glossy_bwd.cu", "shade_glossy_bwd_kernel", 100),
           ("wavefront_shade_bwd.cu", "shade_refractive_bwd_kernel", 20))


def counts(root, tmp):
    """{kernel: {"outside", "loops": [(head, FP32 instructions, FMULs)],
    "ptxas": [...]}} of a checkout's two kernels."""
    from raytracer_tpu_torch.ops import cuda_build
    from raytracer_tpu_torch.probes import common

    csrc = Path(root) / "raytracer_tpu_torch" / "csrc"
    procs = []
    for src, _, _ in KERNELS:
        obj = Path(tmp) / f"{Path(root).resolve().name}_{src}.o"
        procs.append((obj, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-c", "-o", str(obj),
             str(csrc / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = {}
    for (obj, p), (src, kernel, heavy) in zip(procs, KERNELS):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{log}")
        sass = common.cuobjdump_sass(obj)
        # the trips of every loop 1: its loops then list their own counts
        total, loops = common.bwd_pass(sass, kernel, 1, heavy=heavy, small=1)
        out[kernel] = {
            "outside": total - sum(n for _, n, _, _ in loops),
            "loops": [(hex(a), n, n_per) for a, n, n_per, _ in loops],
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if re.search(r"stack frame|Used \d+ registers", ln)]}
    return out


def main(argv):
    if not argv:
        print(__doc__)
        return 2
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for root in argv:
            res[root] = counts(root, tmp)
            print(f"{root}: " + " | ".join(
                f"{k} {v['outside']} FP32 instructions a ray outside its loops, "
                f"loops {v['loops']}, {'; '.join(v['ptxas'])}" for k, v in res[root].items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
