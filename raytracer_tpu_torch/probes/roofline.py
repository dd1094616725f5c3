"""P2: the work of the render kernels, their bound on the card, and the
streamed fma chains.

Counterpart of scripts/roofline.py: `vpu_peak` (:93, pallas_call :118),
whose streamed-chain kernel is `probe_stream_*` in csrc/probe_issue.cu;
the costing of the solid kernel (`kernel_costed_ops` :190), here counted
by hand from the CUDA sources; and the texel fetches, which the TPU's
replay gathers (`gather_path_block` :333) and K2 now fetches itself.

The work of K1 (csrc/solid_trace.cu) and K2 (csrc/record_trace.cu) on one
chunk is

- **operations, in FP32 issue slots**: SLOTS below gives, per device
  function or shading block, how many single-slot operations it issues
  (mul, add, sub, compare, logical and/or, select, min / max, fma; and
  integer ops of the hash; abs and negation are operand modifiers and
  free) and how many special operations (IEEE div and sqrt, expf, sinf /
  cosf, int <-> float conversions, powf), each read off the source line
  it names.  Special operations cost what P1 measured on the card
  (issue_peak, `slot_costs`); powf counts as two exp and 6 single slots.
  Loads, stores, address arithmetic and loop control are not counted, so
  the count is a floor.  The events that multiply each entry (ray-bounces,
  tests by kind, shading by material, lights, shadow tests, draws) come
  from the plain versions' `counts=` hook on the same inputs, which the
  kernels match ray for ray;
- **bytes**: each output written once (12 B of radiance per camera ray
  and the 8-byte count) and each input table read once; K2 also reads
  the texture atlas, 4 B a word, for the words its hits fetch but no more
  than the atlas holds.

The bound is the larger of slots / 33.5 T slots/s (67 TFLOP/s / 2, the
published FP32 rate at 700 W) and bytes / 3.35 TB/s; the share is bound /
measured kernel time.  Beside it: the slots at P1's measured unfused rate,
and the slots with each intersection test at its cost measured by
probes/isect_cost.py, the check of the largest part of the hand count.

    python -m raytracer_tpu_torch.probes.roofline

builds the four scenes of SCENES from the checkout's examples/; callers
in Python pass built scenes to `run`.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

from . import common

SOURCE = "probe_issue.cu"

# ---------------------------------------------------------------------------
# the operation count of every device function and shading block
# ---------------------------------------------------------------------------


def _c(line, alu=0, div=0, sqrt=0, exp=0, sin=0, conv=0, pow=0):
    return {"line": line, "alu": alu, "div": div, "sqrt": sqrt, "exp": exp,
            "sin": sin, "conv": conv, "pow": pow}


TC, K1, K2 = "trace_common.cuh", "solid_trace.cu", "record_trace.cu"
SLOTS = {
    # draws and camera rays (trace_common.cuh)
    "hash_uniform": _c(f"{TC}:75", alu=13, conv=1),      # imul, imad, xor, mix32 8, shift, *2^-24
    "r2_unit": _c(f"{TC}:82", alu=14, conv=1),
    "raygen_pinhole": _c(f"{TC}:209", alu=90, div=5, sqrt=2, conv=6),  # x, y, lens, sincos 32, d, normalize
    "raygen_orthographic": _c(f"{TC}:213", alu=22, div=4, conv=6),
    "raygen_fisheye": _c(f"{TC}:183", alu=48, div=3, sqrt=1, sin=4, conv=4),
    "raygen_equirect": _c(f"{TC}:196", alu=31, div=3, sin=4, conv=4),
    # intersection tests; each test in the nearest-hit loop adds 4 (compare
    # and three selects, trace_common.cuh:514), a shadow test 1 (:558)
    "isect_sphere": _c(f"{TC}:277", alu=50, sqrt=1),
    # axis-aligned planes take the generic formula (trace_common.cuh:297)
    "isect_plane_aa": _c(f"{TC}:304", alu=44, div=1),
    "isect_plane": _c(f"{TC}:304", alu=44, div=1),
    "isect_box": _c(f"{TC}:324", alu=59, div=3),
    "isect_tri": _c(f"{TC}:347", alu=63, div=4),
    "isect_disc": _c(f"{TC}:373", alu=41, div=1),
    "isect_cyl": _c(f"{TC}:408", alu=120, div=6, sqrt=2),
    "nearest_select": _c(f"{TC}:514", alu=4),
    "shadow_compare": _c(f"{TC}:558", alu=1),
    # normals (trace_common.cuh:448) and texture uv (record_trace.cu:224)
    "normal_sphere": _c(f"{TC}:450", alu=6, div=1),
    "normal_plane": _c(f"{TC}:455"), "normal_tri": _c(f"{TC}:455"),
    "normal_disc": _c(f"{TC}:457"),
    "normal_cyl": _c(f"{TC}:459", alu=44, div=5, sqrt=1),
    "normal_box": _c(f"{TC}:469", alu=53, div=3),
    "uv_sphere": _c(f"{K2}:227", alu=49, div=4, sqrt=1),  # atan2_poly 21 + asin_poly 26
    "uv_plane": _c(f"{K2}:232", alu=17, div=4),
    "uv_disc": _c(f"{K2}:238", alu=15, div=4),
    "uv_cyl": _c(f"{K2}:243", alu=48, div=6, sqrt=1),
    "uv_tri": _c(f"{K2}:257", alu=44, div=2),
    "uv_box": _c(f"{K2}:268", alu=54, div=8),
    # one light at a glossy hit (trace_common.cuh:523), with the shading
    # kernels' accumulation of its terms (27: solid_trace.cu:244-245,
    # record_trace.cu:606-609)
    "light_dir": _c(f"{TC}:523", alu=55 + 27, div=3, sqrt=1, pow=1),
    "light_point": _c(f"{TC}:529", alu=66 + 27, div=7, sqrt=2, pow=1),
    "light_spot": _c(f"{TC}:540", alu=81 + 27, div=8, sqrt=2, pow=1),
    # K1 blocks (solid_trace.cu)
    "k1_ray_bounce": _c(f"{K1}:507", alu=1),             # the miss test
    "k1_hit": _c(f"{K1}:189", alu=6),                    # the hit point
    "k1_emissive": _c(f"{K1}:194", alu=6),
    "k1_zero_add": _c(f"{K1}:201", alu=6),
    "k1_shade_setup": _c(f"{K1}:215", alu=13),           # orient, eps, nu
    "k1_glossy": _c(f"{K1}:224", alu=48, div=4),         # dc, acc, F0 x3, a_ph, L
    "k1_glossy_cont": _c(f"{K1}:251", alu=79, div=4, sqrt=1),
    "k1_diffuse": _c(f"{K1}:264", alu=95, div=4, sqrt=3),  # basis, lobe, sincos, pdf, w
    "k1_diffuse_pick": _c(f"{K1}:283", alu=91, div=6, sqrt=4, conv=2),
    "k1_diffuse_cap_term": _c(f"{K1}:304", alu=25, div=5, sqrt=2),
    "k1_diffuse_cap_dir": _c(f"{K1}:297", alu=15),
    "k1_refractive": _c(f"{K1}:328", alu=310, div=24, sqrt=11, exp=3),
    "k1_dispersive": _c(f"{K1}:362", alu=4),
    # K2 blocks (record_trace.cu)
    "k2_ray_bounce": _c(f"{K2}:362", alu=7),             # miss test, hit point
    "k2_hit": _c(f"{K2}:381", alu=7),                    # oriented normal, eps
    "k2_diffuse": _c(f"{K2}:406", alu=67, div=4, sqrt=3, sin=2),
    "k2_diffuse_pick": _c(f"{K2}:424", alu=60, div=7, sqrt=4, sin=2, conv=2),
    "k2_diffuse_cap_term": _c(f"{K2}:442", alu=25, div=5, sqrt=2),
    "k2_diffuse_cap_dir": _c(f"{K2}:436", alu=15),
    "k2_refractive": _c(f"{K2}:467", alu=286, div=23, sqrt=10),  # Fresnel via cdiv_abs2
    "k2_refr_cont": _c(f"{K2}:522", alu=69, div=7, sqrt=1, exp=3),
    "k2_dispersive": _c(f"{K2}:502", alu=4),
    "k2_thinfilm": _c(f"{K2}:553", alu=18, div=1),
    "k2_tf_cont": _c(f"{K2}:568", alu=10),
    "k2_tf_reflect": _c(f"{TC}:160", alu=23, div=1, sqrt=1),
    "k2_glossy": _c(f"{K2}:585", alu=51, div=4),
    "k2_glossy_cont": _c(f"{K2}:620", alu=76, div=4, sqrt=1),
    # K2's texel fetches (record_trace.cu group_texels), per fetch: index
    # products and float -> int64 conversions, each floored wrap of a
    # 64-bit remainder at 20 (its 32-bit fast path), the clip into the
    # atlas, the decode (10-10-10 bits: 3 shift-and pairs, 3 conversions,
    # 4 products); the four weighted taps of a bilinear fetch; the two
    # dependent rounds of a thin film past TF_COMP_LIMIT
    "k2_fetch_uv": _c(f"{K2}:154", alu=77, conv=5),
    "k2_fetch_bilinear": _c(f"{K2}:168", alu=254, conv=14),
    "k2_fetch_comp": _c(f"{K2}:185", alu=82, conv=6),
    "k2_fetch_two": _c(f"{K2}:195", alu=94, conv=8),
    # the texel's use at a textured hit (flag, 1 - F, selects), and every
    # (ray, bounce)'s step of the integral: gid test, m_add, m_beta, L, beta
    "k2_texel_use": _c(f"{K2}:651", alu=5),
    "k2_integrate": _c(f"{K2}:677", alu=20),
}
KINDS = ("sphere", "plane_aa", "plane", "box", "tri", "disc", "cyl")


def slots_of(entry, costs):
    """Issue slots of one SLOTS entry at the special-op slot costs
    `costs` ({div, sqrt, exp, sin, convert: slots})."""
    return (entry["alu"] + 6 * entry["pow"]
            + entry["div"] * costs["div"] + entry["sqrt"] * costs["sqrt"]
            + (entry["exp"] + 2 * entry["pow"]) * costs["exp"]
            + entry["sin"] * costs["sin"] + entry["conv"] * costs["convert"])


def counted_test(kind, costs):
    """The hand count of one test of `kind` in the nearest-hit loop."""
    return slots_of(SLOTS[f"isect_{kind}"], costs) + SLOTS["nearest_select"]["alu"]


def work_terms(kernel, events, projection="pinhole"):
    """[(SLOTS key, multiplicity)] of one chunk of kernel "k1" or "k2"
    from the plain version's event counts."""
    e = lambda k: events.get(k, 0)
    terms = [(f"raygen_{projection}", e("camera_rays")),
             ("r2_unit", e("r2_draws")), ("hash_uniform", e("draws"))]
    for k in KINDS:
        tests = e(f"tests_{k}")
        terms += [(f"isect_{k}", tests + e(f"shadow_{k}")),
                  ("nearest_select", tests), ("shadow_compare", e(f"shadow_{k}"))]
        base = k.replace("_aa", "")
        if k == base:
            terms.append((f"normal_{k}", e(f"normal_{k}")))
            if kernel == "k2":
                terms.append((f"uv_{k}", e(f"uv_{k}")))
    terms += [(f"light_{t}", e(f"light_{t}")) for t in ("dir", "point", "spot")]
    p = kernel + "_"
    terms += [(p + "ray_bounce", e("ray_bounces")), (p + "hit", e("hits")),
              (p + "diffuse", e("diffuse")), (p + "diffuse_pick", e("diffuse_pick")),
              (p + "diffuse_cap_term", e("diffuse_caps")),
              (p + "diffuse_cap_dir", e("diffuse_cap")),
              (p + "refractive", e("refractive")), (p + "dispersive", e("dispersive")),
              (p + "glossy", e("glossy")), (p + "glossy_cont", e("glossy_cont"))]
    if kernel == "k1":
        shaded = sum(e(f"normal_{k}") for k in KINDS)
        terms += [("k1_emissive", e("emissive")), ("k1_zero_add", e("zero_add")),
                  ("k1_shade_setup", shaded)]
    else:
        terms += [("k2_refr_cont", e("refr_cont")), ("k2_thinfilm", e("thinfilm")),
                  ("k2_tf_cont", e("tf_cont")), ("k2_tf_reflect", e("tf_reflect")),
                  ("k2_fetch_uv", e("fetch_uv")),
                  ("k2_fetch_bilinear", e("fetch_bilinear")),
                  ("k2_fetch_comp", e("fetch_comp")), ("k2_fetch_two", e("fetch_two")),
                  ("k2_texel_use", e("texel_hits")), ("k2_integrate", e("records"))]
    return [(key, m) for key, m in terms if m]


def texel_words(events):
    """Atlas words the fused K2 fetches on one chunk: one a nearest or
    composed-table fetch, four a bilinear one, two a two-round thin film."""
    e = lambda k: events.get(k, 0)
    return (e("fetch_uv") + 4 * e("fetch_bilinear") + e("fetch_comp")
            + 2 * e("fetch_two"))


def work(kernel, events, costs, table_bytes, projection="pinhole",
         test_slots=None, atlas_words=0):
    """(issue slots, bytes) of one chunk of kernel "k1" or "k2".
    test_slots: optional {kind: measured slots of one test in the
    nearest-hit loop} (isect_cost.run) that replace the hand count of the
    nearest-hit tests (isect_<kind> + nearest_select).  atlas_words: K2's
    texture atlas entries; the atlas is read for at most its size, and
    for no more words than this chunk's hits fetch (`texel_words`)."""
    terms = work_terms(kernel, events, projection)
    slots = sum(m * slots_of(SLOTS[key], costs) for key, m in terms)
    if test_slots is not None:
        slots += sum(events.get(f"tests_{k}", 0) * (test_slots[k] - counted_test(k, costs))
                     for k in KINDS)
    out_bytes = 12 * events["camera_rays"] + 8
    if kernel == "k2":
        out_bytes += 4 * min(texel_words(events), atlas_words)
    return slots, out_bytes + table_bytes


# ---------------------------------------------------------------------------
# the streamed chains (roofline.py vpu_peak)
# ---------------------------------------------------------------------------

STREAM_K, STREAM_ROWS, STREAM_G, STREAM_REPS = 512, 512, 64, 256


def stream_reference(x, chains, fused=False):
    """The plain version of roofline.py:100-114: per element a, `chains`
    chains b_j = a + 0.1 (j + 1), each stepped b = b * a + 1 for
    512 / chains steps, then summed in order."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    bs = [x + torch.tensor(0.1 * (j + 1), dtype=x.dtype, device=x.device)
          for j in range(chains)]
    for _ in range(STREAM_K // chains):
        if fused:
            bs = [(b.double() * x.double() + 1.0).float() for b in bs]
        else:
            bs = [b * x + one for b in bs]
    r = bs[0]
    for b in bs[1:]:
        r = r + b
    return r


def stream(x, chains, fused=False):
    """The streamed chains over x: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  `stream.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return stream_reference(x, chains, fused)
    common.require_card()
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 vector")
    out = torch.empty_like(x)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    common.launch("probe_stream_launch", [ci, ci, vp, vp, ctypes.c_longlong, vp],
                  chains, int(fused), common.ptr(x), common.ptr(out), x.numel(),
                  common.stream(x))
    stream.launches += 1
    return out


stream.launches = 0


def stream_check(x, chains, fused):
    """The streamed-chain kernel against its plain version on x, and on
    the kernel's output as the next dependent call reads it; returns that
    output.  Raises unless both are bit-equal."""
    y_k, y_p = stream(x, chains, fused), stream_reference(x, chains, fused)
    torch.cuda.synchronize()
    if not torch.equal(y_k, y_p):
        raise RuntimeError(f"streamed chains {chains}{' fused' if fused else ''}: "
                           "kernel and plain version differ")
    y2_k, y2_p = stream(y_k, chains, fused), stream_reference(y_k, chains, fused)
    torch.cuda.synchronize()
    if not torch.equal(y2_k, y2_p):
        raise RuntimeError(f"streamed chains {chains}{' fused' if fused else ''}, "
                           "second call: kernel and plain version differ")
    return y_k


def stream_peak(dev, reps=3):
    """The streamed-chain rates (fma ops / s, as roofline.py counts them)
    at 4, 8 and 16 chains, unfused and fused: STREAM_REPS dependent calls,
    each reading the last one's output.  Every variant is first held bit
    for bit against its plain version at the timed size, on the timed
    input (ones, then its own output) and on an input that varies from
    element to element.  Returns (result dict, kernels-line row)."""
    n = STREAM_G * STREAM_ROWS * 128
    x0 = torch.ones(n, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    xv = torch.rand(n, generator=g, device=dev) * 0.5 + 0.5
    for fused in (False, True):
        for c in (4, 8, 16):
            stream_check(x0, c, fused)
            stream_check(xv, c, fused)
    stream.launches = 0

    def chained(c, f):
        x = x0
        for _ in range(STREAM_REPS):
            x = stream(x, c, f)

    out = {}
    for fused in (False, True):
        for c in (4, 8, 16):
            ms = common.cuda_ms(lambda: chained(c, fused), reps) / STREAM_REPS
            out[f"chains_{c}{'_fused' if fused else ''}"] = {
                "ms_per_call": ms, "fma_per_s": n * STREAM_K / (ms * 1e-3)}
    launches = stream.launches
    out["unfused_fma_per_s"] = max(out[f"chains_{c}"]["fma_per_s"] for c in (4, 8, 16))
    out["fused_fma_per_s"] = max(out[f"chains_{c}_fused"]["fma_per_s"]
                                 for c in (4, 8, 16))
    plain_ms = common.cuda_ms(lambda: stream_reference(x0, 8), 1, 0)
    out["clocks_after"] = common.clocks()
    row = common.row("stream_chain", SOURCE, "scripts/roofline.py:118",
                     launches, 0.0, out["chains_8"]["ms_per_call"], plain_ms,
                     n * (2 * STREAM_K + 8), 8 * n)
    return out, row


# ---------------------------------------------------------------------------
# K1 and K2 at the chunk shapes of the four scenes
# ---------------------------------------------------------------------------

# (scene, width, height, spp): Cornell and example 2 are the two render
# paths' cells (PERF.md section 4), dispersion and primitives the paths
# the other examples add
SCENES = (("cornell", 400, 400, 256), ("example2", 400, 300, 64),
          ("dispersion", 400, 300, 256), ("primitives", 400, 300, 64))


def chunk_args(sc, spp, dev, seed=(99, 4242, 0)):
    """(kernel "k1" or "k2", static, settings, chunk spp, wrapper arguments)
    of one chunk of scene sc at its render plan's chunk shape."""
    from ..core.camera import cam_vec
    from ..core.scene import plan_chunks

    static, tables, settings = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    fan = 1 << settings.split_k
    chunk, _ = plan_chunks(spp * sc._diffuse_fan() * fan, W, H, fan)
    seed = torch.tensor(seed, dtype=torch.int32, device=dev)
    tail = (W, H, chunk, settings.max_bounces, settings.split_k,
            settings.sampler, settings.projection)
    cam = cam_vec(sc.camera.params()).to(dev)
    tables = tables.to(dev)
    solid = static.pallas_ok
    args = ((seed, tables, cam) if solid else (seed, static, tables, cam)) + tail
    return ("k1" if solid else "k2"), static, settings, chunk, args


def kernel_bound(name, sc, spp, costs, unfused_rate, dev, kernel_ms=None,
                 test_slots=None, reps=10):
    """K1 or K2 at scene sc's chunk shape: the plain version's events, the
    work, the bound and the share of the kernel's time (measured here
    unless given), and for K2 its texel fetches.  test_slots: the measured
    cost of a test by kind (see `work`).  Returns a dict."""
    from ..ops.record_trace import record_trace_chunk, record_trace_chunk_reference
    from ..ops.solid_trace import solid_trace_chunk, solid_trace_chunk_reference

    width, height = sc.camera.screen_width, sc.camera.screen_height
    kernel, static, settings, chunk, args = chunk_args(sc, spp, dev)
    fn, plain = ((solid_trace_chunk, solid_trace_chunk_reference) if kernel == "k1"
                 else (record_trace_chunk, record_trace_chunk_reference))
    events = {}
    plain(*args, counts=events)
    if kernel_ms is None:
        kernel_ms = common.cuda_ms(lambda: fn(*args), reps)
    tables = args[1] if kernel == "k1" else args[2]
    names = ("geom", "obj", "dif", "glo", "refr", "emi", "lights", "is_tab",
             "consts") + (("tf", "fetch_i", "fetch_f") if kernel == "k2" else ())
    t_bytes = sum(getattr(tables, k).numel() * 4 for k in names)
    atlas = tables.atlas.numel()
    slots, n_bytes = work(kernel, events, costs, t_bytes, settings.projection,
                          atlas_words=atlas)
    b_ms, by = common.bound(slots, n_bytes)
    n = chunk * width * height
    test_slots_counted = sum(events.get(f"tests_{k}", 0) * counted_test(k, costs)
                             for k in KINDS)
    out = {"scene": name, "kernel": kernel, "rays": n, "chunk_spp": chunk,
           "events": events, "slots": slots, "bytes": n_bytes,
           "slots_per_ray_bounce": slots / events["ray_bounces"],
           "nearest_hit_share_of_slots": test_slots_counted / slots,
           "bound_ms": b_ms, "bound_by": by, "kernel_ms": kernel_ms,
           "share": b_ms / kernel_ms,
           "slots_ms_at_p1_unfused": slots / unfused_rate * 1e3,
           "share_at_p1_unfused": slots / unfused_rate * 1e3 / kernel_ms}
    if test_slots is not None:
        m_slots, _ = work(kernel, events, costs, t_bytes, settings.projection,
                          test_slots, atlas)
        m_ms, m_by = common.bound(m_slots, n_bytes)
        out.update(slots_with_measured_tests=m_slots,
                   bound_ms_with_measured_tests=m_ms,
                   bound_by_with_measured_tests=m_by,
                   share_with_measured_tests=m_ms / kernel_ms)
    if kernel == "k2":
        fetch = sum(m * slots_of(SLOTS[key], costs)
                    for key, m in work_terms(kernel, events, settings.projection)
                    if key.startswith(("k2_fetch", "k2_texel", "k2_integrate")))
        out.update(texel_words=texel_words(events), atlas_words=atlas,
                   fetch_and_integrate_slots=fetch)
    return out


def run(costs, unfused_rate, scenes, fetch_ns=None, kernel_ms=None,
        test_slots=None):
    """Bounds of K1 and K2 at the chunk shapes of `scenes`, {name: (built
    Scene, spp)}, and the streamed chains.  costs, unfused_rate: P1's slot
    costs and measured unfused rate (issue_peak.run); fetch_ns: P6's ns
    per fetch (gather.run); kernel_ms: {scene: ms} measured elsewhere in
    the same run, else measured here; test_slots: the measured cost of a
    nearest-hit test by kind (isect_cost.run).
    Returns (result dict, kernels-line rows)."""
    dev = common.require_card()
    out = {"probe": "roofline", **common.device_info(),
           "peak_slots_per_s": common.PEAK_SLOTS_PER_S,
           "peak_bytes_per_s": common.PEAK_BYTES_PER_S,
           "slot_costs": costs, "p1_unfused_lane_ops_per_s": unfused_rate}
    out["stream"], row = stream_peak(dev)
    for name, (sc, spp) in scenes.items():
        res = kernel_bound(name, sc, spp, costs, unfused_rate, dev,
                           (kernel_ms or {}).get(name), test_slots)
        if "texel_words" in res and fetch_ns is not None:
            res["p6_ns_per_fetch"] = fetch_ns
        out[name] = res
        torch.cuda.empty_cache()
    return out, [row]


def example_scenes():
    """SCENES built by the checkout's examples/ (for the command line)."""
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "examples"))
    from torch_cornellbox import build_cornell
    from torch_primitives import BUILDERS
    from torch_textured import example2

    build = {"cornell": build_cornell, "example2": example2, **BUILDERS}
    return {name: (build[name](w, h), spp) for name, w, h, spp in SCENES}


def main():
    from . import gather, isect_cost, issue_peak

    p1, _ = issue_peak.run()
    costs, rate = p1["slot_costs"], p1["unfused_peak_lane_ops_per_s"]
    p6, _ = gather.run(costs)
    tests, _ = isect_cost.run(costs, rate)
    out, rows = run(costs, rate, example_scenes(), p6["ldg"]["ns_per_fetch"],
                    test_slots=tests["measured_slots_per_test"])
    out["kernels"] = rows
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
