"""The Hopper probes' plain versions against the TPU probes they port.

Each script's kernel function is loaded from scripts/ with importlib (the
scripts stay as they are) and run through pl.pallas_call(...,
interpret=True) at a tiny size; the port's plain version takes the same
inputs.  Where a script's kernel is a closure (roofline.py's streamed
chains) or too slow to trace (probe_pairwise2.py unrolls 128 lanes), the
plain version is held against the numpy that script computes.  The
interpreter runs on XLA:CPU, which contracts a * b + c into an FMA and
approximates sin and exp, so P1, P4 and P5 are held with a stated
tolerance; P3's ids and P6's sums exactly.

Also here: the render kernels' event counts (`counts=`) and the hand
count of their operations (probes/roofline.py).  The JAX-free tests, and
the probe kernels against their plain versions on the card, are in
test_torch_probes_card.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops import solid_trace as st
from raytracer_tpu_torch.core.compile import (KIND_CODES, OBJ_AA_N, OBJ_AA_NSIGN, OBJ_AA_U,
                                              OBJ_AA_V, OBJ_KIND)
from raytracer_tpu_torch.probes import (dead_bounce, gather, isect_cost, issue_peak,
                                        roofline, tri_sweep)

ROOT = Path(__file__).resolve().parents[1]


def script(name):
    """scripts/<name>.py as a module, loaded from its path."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpret(kernel, out_shape, in_specs, grid=(1,), out_specs=None, **kw):
    return pl.pallas_call(kernel, grid=grid, in_specs=in_specs,
                          out_specs=out_specs, out_shape=out_shape,
                          interpret=True, **kw)


def vmem(shape, index):
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


# ---------------------------------------------------------------------------
# P1: vpu_peak.py trees and chains, 2 statements, grid 1
# ---------------------------------------------------------------------------

VPU = script("vpu_peak")
TILE = (128, 128)
X = np.full(TILE, 1.0001, np.float32)
# FMA contraction and the approximated sin / exp / rsqrt of XLA:CPU,
# through 2 statements of 32 leaves; convert truncates to 1/256 steps, so
# a contracted rounding can move it by one step
P1_RTOL = {"convert": 1.0 / 256}


def _vpu_call(kernel):
    call = interpret(kernel, jax.ShapeDtypeStruct(TILE, jnp.float32),
                     [vmem(TILE, lambda i: (0, 0))], out_specs=vmem(TILE, lambda i: (0, 0)))
    return np.asarray(call(jnp.asarray(X))).reshape(-1)


@pytest.mark.parametrize("op", issue_peak.OPS)
def test_p1_tree_matches_vpu_peak(op):
    want = _vpu_call(VPU.make_kernel(op, 2))
    got = issue_peak.tree(torch.from_numpy(X.reshape(-1)), op, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=P1_RTOL.get(op, 2e-5))
    assert VPU._OPS_PER_LEAF[op] == issue_peak.OPS_PER_LEAF[op]
    assert issue_peak.tree_ops_per_element(op, 2) == 2 * (
        VPU.P * VPU._OPS_PER_LEAF[op] + VPU.P - 1 + 2)


@pytest.mark.parametrize("K,D", issue_peak.CHAINS)
def test_p1_chains_match_vpu_peak(K, D):
    kernel, ops_el = VPU.make_chain_kernel(K, D, 2)
    want = _vpu_call(kernel)
    x = torch.from_numpy(X.reshape(-1))
    np.testing.assert_allclose(issue_peak.chain(x, K, D, 2).numpy(), want, rtol=2e-5)
    assert issue_peak.chain_ops_per_element(K, D, 2) == ops_el


@pytest.mark.parametrize("op", issue_peak.SPECIAL)
def test_p1_slot_solve_matches_vpu_peak(op):
    """issue_peak.slot_cost against vpu_peak.py:218-225 on the same two
    tree times: equal where a leaf counts 2 ops as the fma leaf does;
    elsewhere the script's rate ratio understates the statement by the
    ratio of the leaves' op counts, and the port solves from the time
    ratio, which charges the whole statement."""
    P, fma_ms, ms = VPU.P, 14.0, 37.0
    stmt = lambda o: P * VPU._OPS_PER_LEAF[o] + (P - 1) + 2
    base, rate = stmt("fma") / fma_ms, stmt(op) / ms      # the scripts' rates
    ns = VPU._N_SPECIAL.get(op, 1)
    n_1slot = P * (VPU._OPS_PER_LEAF[op] - ns) + (P - 1) + 2
    script = (base / rate * stmt("fma") - n_1slot) / (P * ns)
    got = issue_peak.slot_cost(op, fma_ms, ms)
    assert got == pytest.approx((ms / fma_ms * stmt("fma") - n_1slot) / (P * ns))
    if VPU._OPS_PER_LEAF[op] == 2:
        assert got == pytest.approx(script)
    else:
        assert got > script


# ---------------------------------------------------------------------------
# P2: roofline.py's streamed chains (a closure: held against its numpy)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chains", [4, 8, 16])
def test_p2_stream_matches_numpy_of_roofline(chains):
    """roofline.py:100-114 in numpy float32 (no contraction): bit for bit."""
    a = np.random.default_rng(3).uniform(0.9, 1.01, 4096).astype(np.float32)
    bs = [a + np.float32(0.1 * (j + 1)) for j in range(chains)]
    for _ in range(512 // chains):
        bs = [b * a + np.float32(1.0) for b in bs]
    want = bs[0]
    for b in bs[1:]:
        want = want + b
    got = roofline.stream(torch.from_numpy(a), chains).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chains", [4, 8, 16])
def test_p2_fused_stream_rounds_once(chains):
    """The fused chains' plain version: within 2e-5 of roofline.py's
    unfused numpy, and every step's float64 b * a + 1 is exact on these
    inputs, so its float32 rounding is __fmaf_rn's single rounding."""
    from fractions import Fraction

    a = np.random.default_rng(3).uniform(0.9, 1.01, 4096).astype(np.float32)
    bs = [a + np.float32(0.1 * (j + 1)) for j in range(chains)]
    for _ in range(512 // chains):
        bs = [b * a + np.float32(1.0) for b in bs]
    want = sum(bs[1:], bs[0])
    got = roofline.stream(torch.from_numpy(a), chains, fused=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for x in a[:8]:
        b = x + np.float32(0.1)
        for _ in range(512 // chains):
            exact = Fraction(float(b)) * Fraction(float(x)) + 1
            assert Fraction(float(b) * float(x) + 1.0) == exact
            b = np.float32(float(b) * float(x) + 1.0)


# ---------------------------------------------------------------------------
# P3: probe_pairwise.py make_kernel(1), 128 triangles x 16,384 rays
# ---------------------------------------------------------------------------

PAIR = script("probe_pairwise")


@pytest.fixture(scope="module")
def pairwise():
    mesh, o, d = tri_sweep.pairwise_inputs(128)
    R = PAIR.ROWS
    call = interpret(PAIR.make_kernel(1),
                     [jax.ShapeDtypeStruct((R, 128), jnp.float32)] * 2
                     + [jax.ShapeDtypeStruct((3, R, 128), jnp.float32)],
                     [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3, grid=(),
                     out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
                     scratch_shapes=[pltpu.VMEM((2, R, 128), jnp.float32)])
    want = [np.asarray(a) for a in call(jnp.asarray(mesh), jnp.asarray(o.reshape(3, R, 128)),
                                         jnp.asarray(d.reshape(3, R, 128)))]
    got = tri_sweep.nearest(*(torch.from_numpy(a) for a in (mesh, o, d)))
    return (mesh, o, d), want, [g.numpy() for g in got]


def test_p3_matches_probe_pairwise(pairwise):
    _, (t_w, id_w, n_w), (t_g, id_g, n_g) = pairwise
    t_w, id_w = t_w.reshape(-1), id_w.reshape(-1)
    # the script's own tolerance on t, ids equal on >= 99.9% of rays
    assert (np.abs(t_g - t_w) <= 1e-3 * np.maximum(1, np.abs(t_w))).all()
    assert (id_g == id_w).mean() >= 0.999
    same = id_g == id_w
    np.testing.assert_allclose(n_g[:, same], n_w.reshape(3, -1)[:, same], rtol=0, atol=0)
    assert (id_g >= 0).sum() > 100                    # rays do hit triangles


def test_p3_first_triangle_wins_ties():
    """Two copies of one triangle: the lower id wins, as the script's
    exact-winner select does."""
    mesh, o, d = tri_sweep.pairwise_inputs(128, 512)
    mesh[0, :, 1] = mesh[0, :, 0]
    t, tid, _ = tri_sweep.nearest(*(torch.from_numpy(a) for a in (mesh, o, d)))
    assert not (tid.numpy() == 1).any() and (tid.numpy() == 0).any()


def test_p3_matches_numpy_of_probe_pairwise2():
    """pairwise2 computes the same function with triangles in lanes; its
    kernel unrolls 128 lane columns, too slow to trace here, so the plain
    version is held to the numpy check of probe_pairwise2.py:149-162."""
    mesh, o, d = tri_sweep.pairwise_inputs(256, 4096)
    t, tid, _ = (a.numpy() for a in tri_sweep.nearest(
        *(torch.from_numpy(a) for a in (mesh, o, d))))
    prm = mesh.transpose(0, 2, 1).reshape(-1, 24)
    p1, p2, p3, n, cen = (prm[:, 3 * k:3 * k + 3] for k in range(5))
    n31, n12, n23 = (prm[:, 15 + 3 * k:18 + 3 * k] for k in range(3))
    for i in np.random.default_rng(1).integers(0, o.shape[1], 48):
        O, Dd = o[:, i], d[:, i]
        ndd = (n * Dd).sum(1)
        ndd = np.where(ndd == 0, ndd + 1e-4, ndd)
        ndco = (n * (cen - O)).sum(1)
        tt = ndco / ndd
        M = O + Dd * tt[:, None]
        inside = (((n31 * (M - p1)).sum(1) >= 0) & ((n12 * (M - p2)).sum(1) >= 0)
                  & ((n23 * (M - p3)).sum(1) >= 0) & (ndco * ndd > 0))
        tv = np.where(inside, np.abs(tt), tri_sweep.FARAWAY)
        assert abs(tv.min() - t[i]) < 1e-3 * max(1, abs(tv.min()))
        if tv.min() < tri_sweep.FARAWAY:
            assert tv[int(tid[i])] <= tv.min() * (1 + 1e-5)


# ---------------------------------------------------------------------------
# P4: probe_mesh_sweep.py, T = 64, looped and unrolled
# ---------------------------------------------------------------------------

SWEEP = script("probe_mesh_sweep")


@pytest.mark.parametrize("unrolled", [False, True])
def test_p4_matches_probe_mesh_sweep(unrolled):
    mesh, o, d = tri_sweep.sweep_inputs(64)
    tile = SWEEP.TILE
    call = interpret(
        SWEEP.make_kernel(64, unrolled), jax.ShapeDtypeStruct((1, 3) + tile, jnp.float32),
        [pl.BlockSpec(memory_space=pltpu.SMEM),
         vmem((3,) + tile, lambda i: (0, 0, 0)), vmem((3,) + tile, lambda i: (0, 0, 0))],
        out_specs=vmem((1, 3) + tile, lambda i: (i, 0, 0, 0)))
    want = np.asarray(call(jnp.asarray(mesh), jnp.asarray(o.reshape((3,) + tile)),
                           jnp.asarray(d.reshape((3,) + tile)))).reshape(1, 3, -1)
    got = tri_sweep.sweep(*(torch.from_numpy(a) for a in (mesh, o, d)), 1,
                          unrolled).numpy()
    assert np.array_equal(got[:, 2], want[:, 2])              # winner ids
    # XLA:CPU contracts the plane dot products into FMAs
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# P5: probe_when_skip.py, one tile
# ---------------------------------------------------------------------------

SKIP = script("probe_when_skip")


@pytest.mark.parametrize("kill_after", [0, 1, 6])
def test_p5_matches_probe_when_skip(kill_after):
    R = SKIP.TILE
    x = np.ones((R, 128), np.float32)
    scratch = ([pltpu.VMEM((R, 128), jnp.bool_)]
               + [pltpu.VMEM((R, 128), jnp.float32)] * SKIP.NPLANES)
    call = interpret(SKIP.make(kill_after), jax.ShapeDtypeStruct((R, 128), jnp.float32),
                     [vmem((R, 128), lambda i: (i, 0))],
                     out_specs=vmem((R, 128), lambda i: (i, 0)), scratch_shapes=scratch)
    want = np.asarray(call(jnp.asarray(x))).reshape(-1)
    got = dead_bounce.bounces(torch.from_numpy(x.reshape(-1)), kill_after).numpy()
    # XLA:CPU's sin approximation over up to 6 bounces
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_p5_thread_form_stops_dead_lanes():
    """The fourth input: odd lanes die after bounce 0.  The thread form
    stops them, the warp form carries them with their warp."""
    x = torch.ones(64)
    th = dead_bounce.bounces(x, dead_bounce.BOUNCES, True, "thread")
    wa = dead_bounce.bounces(x, dead_bounce.BOUNCES, True, "warp")
    one = dead_bounce.bounces(x, 0)
    assert torch.equal(th[1::2], one[1::2]) and torch.equal(th[0::2], wa[0::2])
    assert torch.equal(wa[1::2], wa[0::2])


# ---------------------------------------------------------------------------
# P6: probe_vmem_gather.py kernel_baseline and kernel_take, 2 tiles
# ---------------------------------------------------------------------------

GATHER = script("probe_vmem_gather")


@pytest.mark.parametrize("take", [False, True])
def test_p6_matches_probe_vmem_gather(take):
    """The script's inputs, and the same with negative indices and the
    edge input's indices (the whole int32 range, those whose sum wraps
    past 2^31 - 1) over its first rays: jnp.remainder and torch.remainder
    are both floored, and both int32 adds wrap."""
    n = 2 * GATHER.TILE_ROWS * 128
    table, idx = gather.inputs(n)
    signed = idx - 60_000
    edge = gather.edge_inputs()[1]
    signed.reshape(-1)[:edge.size] = edge
    assert (signed < 0).mean() > 0.4
    rows = table.shape[0]
    call = interpret(GATHER.kernel_take if take else GATHER.kernel_baseline,
                     jax.ShapeDtypeStruct((n // 128, 128), jnp.float32),
                     [vmem((rows, 128), lambda i: (0, 0)),
                      vmem((GATHER.TILE_ROWS, 128), lambda i: (i, 0))],
                     grid=(2,), out_specs=vmem((GATHER.TILE_ROWS, 128), lambda i: (i, 0)))
    for ix in (idx, signed):
        want = np.asarray(call(jnp.asarray(table), jnp.asarray(ix)))
        got = gather.gather(torch.from_numpy(table), torch.from_numpy(ix),
                            "ldg" if take else "base").numpy()
        assert np.array_equal(got, want)
    assert (gather.T, gather.FETCHES) == (GATHER.T, GATHER.BOUNCES)


# ---------------------------------------------------------------------------
# the nearest-hit tests of isect_cost against the JAX package's intersectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", isect_cost.KINDS)
def test_isect_cost_matches_jax_intersectors(kind):
    """The probe's plain version (the port's nearest_hit over a table of
    one kind) against pallas_trace.py's per-object intersectors, in the
    loop of its kernel (:594-604), on XLA:CPU, which contracts FMAs:
    ids equal on >= 99.9% of rays, t within 1e-5 where they are."""
    from types import SimpleNamespace

    from raytracer_tpu.ops import pallas_trace as pt

    tab = isect_cost.table(kind, 8)
    r = isect_cost.rays(2048)
    t, _, ids = (a.numpy() for a in isect_cost.isect(tab, r))
    names = {v: k for k, v in KIND_CODES.items()}
    geom = np.asarray(tab.geom)
    rj = [jnp.asarray(x) for x in r.numpy()]
    best_t = jnp.full(r.shape[1], pt.FARAWAY)
    best_id = jnp.full(r.shape[1], -1, jnp.int32)
    for i, row in enumerate(tab.obj_rows):
        aa = (None if row[OBJ_AA_N] < 0 else
              ((row[OBJ_AA_N], row[OBJ_AA_NSIGN]), (row[OBJ_AA_U], 1), (row[OBJ_AA_V], 1)))
        rec = SimpleNamespace(kind=names[row[OBJ_KIND]], aa=aa)
        t_i, _ = pt._isect_for(rec)([jnp.float32(v) for v in geom[i]], *rj)
        better = t_i < best_t
        best_t = jnp.where(better, t_i, best_t)
        best_id = jnp.where(better, i, best_id)
    best_t, best_id = np.asarray(best_t), np.asarray(best_id)
    assert (ids == best_id).mean() >= 0.999 and (ids >= 0).sum() > 20
    same = ids == best_id
    np.testing.assert_allclose(t[same], best_t[same], rtol=1e-5)


# ---------------------------------------------------------------------------
# the render kernels' events and operation count (P2)
# ---------------------------------------------------------------------------


def _cornell(W=16, H=16):
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    from torch_cornellbox import build_cornell
    return build_cornell(W, H)


def test_counts_hook_changes_nothing_and_counts_tests():
    sc = _cornell()
    _, tables, s = sc._settings_for_render()
    args = (torch.tensor([5, 6, 0], dtype=torch.int32), tables,
            cam_vec(sc.camera.params()), 16, 16, 4, s.max_bounces)
    L0, n0 = st.solid_trace_chunk_reference(*args)
    ev = {}
    L1, n1 = st.solid_trace_chunk_reference(*args, counts=ev)
    assert torch.equal(L0, L1) and int(n0) == int(n1)
    assert ev["ray_bounces"] == int(n0)
    n_obj = len(tables.obj_rows)
    assert sum(v for k, v in ev.items() if k.startswith("tests_")) == int(n0) * n_obj
    assert ev["camera_rays"] == 16 * 16 * 4 and ev["hits"] <= ev["ray_bounces"]


def test_counts_hook_on_the_record_path():
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_primitives
    sc = torch_primitives.BUILDERS["primitives"](12, 8)
    static, tables, s = sc._settings_for_render()
    args = (torch.tensor([7, 8, 0], dtype=torch.int32), static, tables,
            cam_vec(sc.camera.params()), 12, 8, 8, s.max_bounces, s.split_k,
            s.sampler, s.projection)
    r0 = rt.record_trace_chunk_reference(*args)
    ev = {}
    r1 = rt.record_trace_chunk_reference(*args, counts=ev)
    assert all(torch.equal(a, b) for a, b in zip(r0, r1))
    assert ev["ray_bounces"] == int(r0[2])
    assert ev["records"] == s.max_bounces * 12 * 8 * 8
    assert sum(v for k, v in ev.items() if k.startswith("shadow_")) > 0
    slots, n_bytes = roofline.work("k2", ev, {k: 4.0 for k in
                                              ("div", "sqrt", "exp", "sin", "convert")}, 0,
                                   atlas_words=tables.atlas.numel())
    # the fused kernel writes L and the count, and reads the texels its
    # hits fetch (here fewer than the atlas holds)
    words = roofline.texel_words(ev)
    assert 0 < words < tables.atlas.numel() and ev["texel_hits"] <= ev["hits"]
    assert slots > 100 * ev["ray_bounces"]
    assert n_bytes == 12 * 12 * 8 * 8 + 8 + 4 * words
    assert dict(roofline.work_terms("k2", ev))["k2_integrate"] == ev["records"]


def test_work_of_k1_on_cornell():
    sc = _cornell()
    _, tables, s = sc._settings_for_render()
    ev = {}
    st.solid_trace_chunk_reference(torch.tensor([1, 2, 0], dtype=torch.int32), tables,
                                   cam_vec(sc.camera.params()), 16, 16, 2,
                                   s.max_bounces, counts=ev)
    terms = roofline.work_terms("k1", ev)
    assert {k for k, _ in terms} <= set(roofline.SLOTS)
    assert dict(terms)["isect_plane_aa"] == 6 * ev["ray_bounces"]   # six aa walls
    ones = {k: 1.0 for k in ("div", "sqrt", "exp", "sin", "convert")}
    slots, n_bytes = roofline.work("k1", ev, ones, 100)
    assert n_bytes == 12 * 16 * 16 * 2 + 8 + 100
    # at unit special costs, slots = the sum of every counted operation
    assert slots == sum(m * sum(roofline.SLOTS[k][f] for f in
                                ("alu", "div", "sqrt", "exp", "sin", "conv"))
                        + m * 8 * roofline.SLOTS[k]["pow"] for k, m in terms)
