#!/usr/bin/env python3
"""Where the device time of one of the port's renders goes, on one CUDA device.

    python scripts/torch_render_profile.py [--scene cornell|example2|dispersion|primitives] [TRACE.json]

Renders the scene through raytracer_tpu_torch's Scene.render
(output="linear") once to warm up and once under torch.profiler, writes
that render's Chrome trace (to TRACE.json, by default
build/torch_render_trace_<scene>.json), and reads the device events back
from it: the span from the first to the last event, the busy time as the
union of kernel and copy intervals, the time of the scene's path kernel
(solid_trace or record_trace) and of each kernel.  The scenes are the
main paths of chip_smoke.py: the reference Cornell box at 400x400 x 256
spp and the dispersion example at 400x300 x 256 spp (the solid kernel),
example 2 and the primitives example at 400x300 x 64 spp (the record
kernel, which fetches its textures itself).  The last line is one JSON object.  The
end-to-end Mrays/s is chip_smoke.py's; this script times no render of
its own.
"""

import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# scene -> (module, scene function, width, height, spp, path kernel)
SCENES = {"cornell": ("torch_cornellbox", "build_cornell", 400, 400, 256,
                      "solid_trace"),
          "example2": ("torch_textured", "example2", 400, 300, 64,
                       "record_trace"),
          "dispersion": ("torch_primitives", "dispersion", 400, 300, 256,
                         "solid_trace"),
          "primitives": ("torch_primitives", "primitives", 400, 300, 64,
                         "record_trace")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_breakdown(trace_events):
    """Span, busy union and per-name time (all in us) of a Chrome trace's
    device events."""
    iv = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace_events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    per_name = defaultdict(lambda: [0.0, 0])
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi, name in iv:
        per_name[name][0] += hi - lo
        per_name[name][1] += 1
        if cur_hi is None or lo > cur_hi:
            busy += 0.0 if cur_hi is None else cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    span = max(hi for _, hi, _ in iv) - iv[0][0]
    return span, busy, dict(per_name)


def device_events(torch, fn, calls):
    """{"events_a_call": {name: events a call}, "device_ms_a_call": ms}
    of the device events torch.profiler records over `calls` calls of fn
    (after one call outside the profile; `common.profiled_events`)."""
    from collections import Counter

    from raytracer_tpu_torch.probes.common import profiled_events

    ev = profiled_events(fn, calls)
    names = Counter(e.name for e in ev)
    return {"events_a_call": {k: n / calls for k, n in names.items()},
            "device_ms_a_call": sum(e.time_range.elapsed_us() for e in ev)
            / calls / 1e3}


def wavefront_stages(events):
    """Device busy time (us) and device events under each "wavefront.*"
    profiler range of a Chrome trace: the kernels and copies inside each
    of its gpu_user_annotation events (an annotation spans its range's
    first to last device event, idle gaps included)."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    starts = [lo for lo, _ in iv]
    stages, counts = defaultdict(float), defaultdict(int)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                and str(e.get("name", "")).startswith("wavefront.")):
            lo, hi = e["ts"], e["ts"] + e["dur"]
            name = e["name"][len("wavefront."):]
            i = bisect.bisect_left(starts, lo)
            while i < len(iv) and iv[i][0] < hi:
                stages[name] += min(iv[i][1], hi) - iv[i][0]
                counts[name] += 1
                i += 1
    return stages, counts


def report(trace_path, wall_s, kernel_name):
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    span, busy, per_name = device_breakdown(events)
    kern = sum(t for k, (t, _) in per_name.items() if kernel_name in k)
    print(f"profiled render: wall {wall_s * 1e3:.1f} ms, device span "
          f"{span / 1e3:.1f} ms, busy "
          f"(union) {busy / 1e3:.1f} ms ({100 * busy / span:.1f}% of span), "
          f"{kernel_name} kernel {kern / 1e3:.1f} ms ({100 * kern / busy:.1f}% "
          f"of busy)")
    for k, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / 1e3:10.3f} ms  {c:5d}x  {k[:90]}")
    print(json.dumps({"wall_s": wall_s, "device_span_s": span / 1e6,
                      "device_busy_s": busy / 1e6, "kernel_s": kern / 1e6,
                      "device_events": sum(c for _, c in per_name.values())}))


def main(argv):
    import argparse
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    ap.add_argument("trace", nargs="?")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    module, fn, width, height, spp, kernel_name = SCENES[args.scene]
    build = getattr(importlib.import_module(module), fn)

    trace = (Path(args.trace) if args.trace else
             ROOT / "build" / f"torch_render_trace_{args.scene}.json")
    dev = torch.device("cuda:0")
    sc = build(width, height)
    render = lambda: sc.render(samples_per_pixel=spp, output="linear", device=dev)
    render()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"{torch.cuda.get_device_name(0)}: {args.scene} {width}x{height} x "
          f"{spp} spp, trace {trace}")
    report(trace, wall, kernel_name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
