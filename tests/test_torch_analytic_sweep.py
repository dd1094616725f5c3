"""The analytic sweep around W3 (ops/analytic_sweep.py,
csrc/analytic_sweep.cu), and the reproducible gather (safemath.take).

On the CPU:
- the two wrappers take their plain versions for CPU tensors and launch
  nothing, and give the JAX package's nearest_hit and occluded on the
  primitives example, the 98-object grid (examples/torch_primitives.py,
  examples/torch_wavefront.py, at 16x16) and a scene of every analytic
  kind, with random rays made from a numpy seed, both packages reading
  the JAX compile's tables; the occluded wrapper also with the direction
  and max_dist passed as the expand of one row, as materials/shade.py
  passes a directional light's, on a scene whose sky sphere casts no
  shadow.  XLA:CPU contracts a*b+c into FMA, so a few
  rays that graze an edge land on the other side of it: hit masks, ids,
  orientations and shadow answers are held on >= 99.9% of rays, and t of
  the rays both sides hit within 1e-5 relative (1e-6 absolute);
- `intersect.analytic_winner_t`, the recompute that carries autograd past
  W3 (which has no backward), gives each ray's t against its winning
  object bit for bit as the plain loops do, and the same gradient with
  respect to the rays and a sphere's centre (in float64 within 1e-9 of
  the largest element: the two graphs add a table gradient's terms in
  other orders).  torch's vectorised CPU sqrt is not correctly rounded,
  and which lanes it takes depends on a tensor's layout, so these holds
  take safe_sqrt's root correctly rounded (through float64), as the card
  does;
- `safemath.take`: the forward of `index_select` bit for bit, its
  gradient `index_select`'s, the same on two calls.

On the card (`cuda`-marked, skipped here):

    python -m pytest --noconftest -m cuda tests/test_torch_analytic_sweep.py

holds W3 against the plain loops bit for bit on the edge scene of
tests/test_torch_analytic_sweep_emu.py (at four block sizes) and on the
primitives example, shows that nearest_hit and occluded on CUDA tensors
sweep the analytic objects only through W3 (the plain loops raise), that
the occluded wrapper given an expanded direction and max_dist launches
W3's kernel alone (torch.profiler's device events: no copy),
holds the gradient through W3's winners against the plain loops', and
requires two backward passes of a small differentiable_render to be
bit-equal.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.compile import compile_wavefront
from raytracer_tpu_torch.core.safemath import take
from raytracer_tpu_torch.geometry import intersect as isect
from raytracer_tpu_torch.ops import analytic_sweep
from raytracer_tpu_torch.utils.constants import FARAWAY

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_primitives  # noqa: E402
import torch_wavefront  # noqa: E402
from test_torch_analytic_sweep_emu import (N_RAYS, edge_rays,  # noqa: E402
                                           edge_scene, edge_shadow, exact_sqrt)

RATE = 0.999
N_SKY = 60.0                  # the sky sphere's radius
GRAD_TOL = 1e-9
SCENES = {
    "primitives": lambda m: torch_primitives.primitives(16, 16, m=m),
    "grid": lambda m: torch_wavefront.grid(96, 16, 16, m=m),
}


def sky_scene(m):
    """The primitives example inside an emissive sky sphere that casts no
    shadow, as the mesh examples have one (examples/torch_mesh.py)."""
    sc = torch_primitives.primitives(16, 16, m=m)
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.7, 0.8, 0.95)),
                    center=m.vec3(0, 0, 0), radius=N_SKY, shadow=False))
    return sc


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_rays(geom, n=N_RAYS, seed=0):
    """(O, D) float32: origins around the scene's objects, aimed at random
    points near them (a fifth of the directions random)."""
    rng = np.random.default_rng(seed)
    C = np.concatenate([x.numpy() for x in (
        geom.sphere_center, geom.plane_center, geom.box_center,
        geom.disc_center, geom.cyl_center)])
    C = C[np.abs(C).max(1) < 20]                 # not the grid's sky
    lo, hi = C.min(0) - 1.0, C.max(0) + 1.0
    O = rng.uniform(lo, hi + [0, 2, 3], (n, 3))
    aim = C[rng.integers(0, C.shape[0], n)] + rng.normal(0, 0.3, (n, 3)) - O
    D = np.where(rng.uniform(size=(n, 1)) < 0.2, rng.normal(size=(n, 3)), aim)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    return (torch.from_numpy(O.astype(np.float32)),
            torch.from_numpy(D.astype(np.float32)))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_scenes(one_thread):
    """{name: (JAX GeometryTables, the port's from the same compile,
    shadow mask, directional lights' directions)}, the scenes of SCENES,
    every analytic kind and the sky scene."""
    pytest.importorskip("jax")
    J = pytest.importorskip("raytracer_tpu")
    from raytracer_tpu.core.compile import compile_scene
    from raytracer_tpu_torch.interop import scene_data_from_jax
    from test_torch_wavefront_intersect import all_kinds

    out = {}
    for name, make in {**SCENES, "all_kinds": all_kinds, "sky": sky_scene}.items():
        j_data = compile_scene(make(J))[1]
        data = scene_data_from_jax(j_data)
        # the analytic objects alone on the JAX side: the port's wrappers
        # sweep no triangles
        j_geom = dataclasses.replace(j_data.geom, **{
            f.name: getattr(j_data.geom, f.name)[:0]
            for f in dataclasses.fields(j_data.geom) if f.name.startswith("tri_")})
        out[name] = (j_geom, data.geom, data.obj.shadow, data.lights.dir_l)
    return out


@pytest.mark.parametrize("name", [*SCENES, "all_kinds"])
def test_the_wrappers_equal_the_jax_package(jax_scenes, name):
    import jax.numpy as jnp
    from raytracer_tpu.geometry import intersect as jsect

    j_geom, geom, shadow, _ = jax_scenes[name]
    O, D = scene_rays(geom, seed=1)
    before = analytic_sweep.launches()
    t, orient, obj = analytic_sweep.analytic_nearest(O, D, geom)
    md = torch.from_numpy(np.random.default_rng(2).uniform(0.1, 8.0, N_RAYS)
                          .astype(np.float32))
    mask = torch.from_numpy(np.random.default_rng(3).uniform(
        size=shadow.shape[0]) < 0.7)
    occ = analytic_sweep.analytic_occluded(O, D, geom, mask, md)
    assert analytic_sweep.launches() == before          # the plain loops
    jt, jo, jobj = jsect.nearest_hit(jnp.asarray(O.numpy()),
                                     jnp.asarray(D.numpy()), j_geom)
    jt, jo, jobj = (np.asarray(x) for x in (jt, jo, jobj))
    hit, jhit = t.numpy() < 1e29, jt < 1e29
    assert (hit == jhit).mean() >= RATE
    both = hit & jhit
    assert both.mean() > 0.2
    np.testing.assert_allclose(t.numpy()[both], jt[both], rtol=1e-5, atol=1e-6)
    assert (obj.numpy()[both] == jobj[both]).mean() >= RATE
    assert (orient.numpy()[both] == jo[both]).mean() >= RATE
    jocc = np.asarray(jsect.occluded(
        jnp.asarray(O.numpy()), jnp.asarray(D.numpy()), j_geom,
        jnp.asarray(mask.numpy()), jnp.asarray(md.numpy())))
    assert (occ.numpy() == jocc).mean() >= RATE
    assert 0.05 < occ.numpy().mean() < 0.95


@pytest.mark.parametrize("name", ["sky", "primitives"])
def test_the_occluded_wrapper_takes_one_row_as_the_jax_package(jax_scenes, name):
    """Shadow rays toward the scene's directional light, direction and
    max_dist the expand of one row, as materials/shade.py passes them: the
    wrapper's answer is the JAX package's occluded on the same rays with
    every row written out.  On the sky scene its sphere, whose mask bit is
    not set, would occlude every ray."""
    import jax.numpy as jnp
    from raytracer_tpu.geometry import intersect as jsect

    from raytracer_tpu_torch.utils.constants import SKYBOX_DISTANCE

    j_geom, geom, shadow, dir_l = jax_scenes[name]
    O, _ = scene_rays(geom, seed=5)
    n = O.shape[0]
    L = dir_l[0].expand(n, 3)
    md = torch.full((1,), SKYBOX_DISTANCE).expand(n)
    assert L.stride(0) == 0 and md.stride(0) == 0
    before = analytic_sweep.launches()
    occ = analytic_sweep.analytic_occluded(O, L, geom, shadow, md)
    assert analytic_sweep.launches() == before          # the plain loops
    jocc = np.asarray(jsect.occluded(
        jnp.asarray(O.numpy()), jnp.asarray(L.contiguous().numpy()), j_geom,
        jnp.asarray(shadow.numpy()), jnp.asarray(md.contiguous().numpy())))
    assert (occ.numpy() == jocc).mean() >= RATE
    assert 0.05 < occ.numpy().mean() < 0.95
    if name == "sky":
        sky = int(torch.nonzero(geom.sphere_radius == N_SKY)[0, 0])  # spheres first
        assert not bool(shadow[sky])
        every = torch.ones_like(shadow)
        assert bool(analytic_sweep.analytic_occluded(O, L, geom, every, md).all())


# ---------------------------------------------------------------------------
# the recompute, the tables, the gather
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_scenes(one_thread):
    """{name: GeometryTables}: SCENES and the emu file's edge scene, built
    with the port alone."""
    out = {k: compile_wavefront(make(T))[1].geom for k, make in SCENES.items()}
    out["edge"] = edge_scene()
    return out


def _rays(port_scenes, name, n=N_RAYS, seed=4):
    geom = port_scenes[name]
    if name == "edge":
        return edge_rays(geom, n)[:2]
    return scene_rays(geom, n, seed)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("name", ["primitives", "grid", "edge"])
def test_winner_t_is_the_plain_loops_t(port_scenes, name, monkeypatch):
    monkeypatch.setattr(isect, "safe_sqrt", exact_sqrt)
    geom = port_scenes[name]
    O, D = _rays(port_scenes, name)
    t, _, obj = isect._analytic_nearest(O, D, geom)
    assert float((t < FARAWAY).float().mean()) > 0.2
    assert torch.equal(_bits(isect.analytic_winner_t(O, D, geom, obj, t)), _bits(t))


def with_grad(geom, names):
    """geom with fresh leaf copies of the tables `names` that require grad."""
    return dataclasses.replace(geom, **{
        k: getattr(geom, k).detach().clone().requires_grad_(True) for k in names})


def as_double(geom):
    return dataclasses.replace(geom, **{
        f.name: getattr(geom, f.name).double() for f in dataclasses.fields(geom)
        if getattr(geom, f.name).is_floating_point()})


def grads(O0, D0, geom, w, nearest, recompute=False):
    """d(sum w t) over the hits with respect to D, O and the spheres'
    centres, t from `nearest` (or, if `recompute`, analytic_winner_t at
    its winners)."""
    O, D = O0.clone().requires_grad_(True), D0.clone().requires_grad_(True)
    g = with_grad(geom, ["sphere_center"])
    t, _, obj = nearest(O, D, g)
    if recompute:
        t = isect.analytic_winner_t(O, D, g, obj.detach(), t.detach())
    loss = (torch.where(t < FARAWAY, t, 0.0) * w).sum()
    return torch.autograd.grad(loss, (D, O, g.sphere_center))


@pytest.mark.parametrize("name", ["grid", "edge"])
def test_winner_t_gradient_is_the_plain_loops(port_scenes, name, monkeypatch):
    """In float64 the rays' and the sphere centres' gradients through the
    recompute equal the plain loops' within 1e-9 of the largest.  The
    plain loops' backward runs through every object's test, and a ray
    that runs parallel to an axis of a box (the edge scene's NaN rays)
    meets 0 * inf there: its gradient is NaN in the plain loops, and
    finite through the recompute, which tests the winner alone."""
    monkeypatch.setattr(isect, "safe_sqrt", exact_sqrt)
    geom = as_double(port_scenes[name])
    O, D = (x.double() for x in _rays(port_scenes, name))
    w = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 1.5, N_RAYS))
    hold_grads(grads(O, D, geom, w, isect._analytic_nearest),
               grads(O, D, geom, w, isect._analytic_nearest, recompute=True),
               (GRAD_TOL,) * 3)


def hold_grads(plain, other, tols):
    """Each gradient of `other` finite and within its tol of the largest
    element of `plain`'s, on the rows where `plain`'s is finite (all but
    a few)."""
    for a, b, tol in zip(plain, other, tols):
        assert bool(torch.isfinite(b).all())
        ok = torch.isfinite(a).reshape(a.shape[0], -1).all(1)
        assert float(ok.double().mean()) > 0.98
        scale = float(a[ok].abs().max())
        assert scale > 0
        assert float((a[ok] - b[ok]).abs().max()) <= tol * scale


def test_needs_grad_sees_the_analytic_tables(port_scenes):
    geom = port_scenes["grid"]
    O, D = _rays(port_scenes, "grid", n=8)
    assert not isect.needs_grad(O, D, geom, analytic=True)
    assert isect.needs_grad(O, D, with_grad(geom, ["sphere_center"]), analytic=True)
    assert not isect.needs_grad(O, D, with_grad(geom, ["sphere_center"]))
    assert isect.needs_grad(O.requires_grad_(True), D, geom, analytic=True)
    with torch.no_grad():
        assert not isect.needs_grad(O, D, geom, analytic=True)


def test_object_table_holds_each_kind(port_scenes):
    g = port_scenes["edge"]
    tab = analytic_sweep.object_table(g)
    counts = analytic_sweep.kind_counts(g)
    assert tab.shape == (sum(counts), analytic_sweep.ROW)
    assert tab.dtype == torch.float32 and tab.is_contiguous()
    s, p, b, d = np.cumsum([0] + counts)[:4]
    assert torch.equal(tab[:s + counts[0], 3], g.sphere_radius * g.sphere_radius)
    assert torch.equal(tab[p:p + counts[1], 4:7], g.plane_normal)
    assert torch.equal(tab[b:b + counts[2], 8:11], g.box_basis[:, 2, :])
    assert torch.equal(tab[b:b + counts[2], 12:15], g.box_rt_local)
    assert torch.equal(tab[d:d + counts[3], 7], g.disc_r_in * g.disc_r_in)
    c = g.cyl_center
    off_a = (g.cyl_axis[:, 0] * c[:, 0] + g.cyl_axis[:, 1] * c[:, 1]
             + g.cyl_axis[:, 2] * c[:, 2])
    assert torch.equal(tab[-counts[4]:, 7], off_a)
    assert torch.equal(tab[-counts[4]:, 14], g.cyl_capped)


def test_object_table_is_made_once_per_geometry(port_scenes):
    g = dataclasses.replace(port_scenes["edge"])
    first = analytic_sweep.scene_tables(g)
    assert analytic_sweep.scene_tables(g) is first
    g.sphere_radius.add_(0.0)                   # a new version
    assert analytic_sweep.scene_tables(g) is not first


def test_cpu_wrappers_take_the_plain_loops(port_scenes):
    geom = port_scenes["edge"]
    O, D, _ = edge_rays(geom)
    mask, md, _ = edge_shadow(geom, O, D)
    before = analytic_sweep.launches()
    for a, b in zip(analytic_sweep.analytic_nearest(O, D, geom),
                    isect._analytic_nearest(O, D, geom)):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(analytic_sweep.analytic_occluded(O, D, geom, mask, md),
                       isect._analytic_occluded(O, D, geom, mask, md))
    assert analytic_sweep.launches() == before


@pytest.mark.parametrize("shape", [(7,), (7, 3), (7, 3, 3)])
def test_take_is_index_select_with_a_reproducible_gradient(shape):
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, shape[0], 5000))
    g_out = torch.from_numpy(rng.normal(size=(5000,) + shape[1:]).astype(np.float32))
    grads = []
    for fn in (take, take, lambda x, i: x.index_select(0, i)):
        x = table.clone().requires_grad_(True)
        y = fn(x, idx)
        assert torch.equal(y, table.index_select(0, idx))
        grads.append(torch.autograd.grad((y * g_out).sum(), x)[0])
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(take(table, idx), table.index_select(0, idx))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (W3 has no CPU mode)")
    return torch.device("cuda")


def _card_hold(geom, O, D, mask, md):
    """W3 against the plain loops on the card, bit for bit: t and orient
    bits, ids, the shadow answers."""
    got = analytic_sweep.analytic_nearest(O, D, geom)
    want = isect._analytic_nearest(O, D, geom)
    occ = analytic_sweep.analytic_occluded(O, D, geom, mask, md)
    occ_want = isect._analytic_occluded(O, D, geom, mask, md)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(occ, occ_want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [None, 1, 2, 5])
def test_w3_on_the_card_matches_plain_on_the_edge_scene(card, B, monkeypatch):
    if B is not None:
        monkeypatch.setattr(isect, "BLOCK_ELEMS", B * N_RAYS)
    geom = edge_scene()
    O, D, _ = edge_rays(geom)
    mask, md, _ = edge_shadow(geom, O, D)
    analytic_sweep.reset_launches()
    _card_hold(geom.to(card), O.to(card), D.to(card), mask.to(card), md.to(card))
    assert analytic_sweep.launches() == 2


@pytest.mark.cuda
def test_w3_on_the_card_matches_plain_on_the_primitives(card):
    geom = compile_wavefront(SCENES["primitives"](T))[1].geom.to(card)
    O, D = (x.to(card) for x in scene_rays(geom.to("cpu"), n=1 << 16, seed=7))
    md = torch.full((O.shape[0],), 5.0, device=card)
    mask = torch.ones((16,), dtype=torch.bool, device=card)
    _card_hold(geom, O, D, mask, md)


@pytest.mark.cuda
def test_card_occluded_on_one_row_launches_its_kernel_alone(card):
    """The occluded wrapper on the card with the direction and max_dist the
    expand of one row (materials/shade.py's directional light): the
    device events torch.profiler records over a few calls are W3's
    occluded kernel, one a call, and nothing else (no copy of the
    expanded inputs, no fill of the answer); the answer is the plain
    loops' on the same rays."""
    from raytracer_tpu_torch.probes.common import profiled_events

    sc = sky_scene(T)
    _, data = compile_wavefront(sc)
    data = data.to(card)
    geom, shadow = data.geom, data.obj.shadow
    O = scene_rays(geom.to("cpu"), n=1 << 16, seed=9)[0].to(card)
    n = O.shape[0]
    L = data.lights.dir_l[0].expand(n, 3)
    md = torch.full((1,), 1.0e6, device=card).expand(n)
    want = isect._analytic_occluded(O, L, geom, shadow, md)
    assert torch.equal(analytic_sweep.analytic_occluded(O, L, geom, shadow, md), want)
    calls = 4
    names = [e.name for e in profiled_events(
        lambda: analytic_sweep.analytic_occluded(O, L, geom, shadow, md), calls)]
    assert len(names) == calls, names
    assert all("analytic_occluded_kernel" in x for x in names), names


@pytest.mark.cuda
def test_card_sweeps_analytic_objects_only_through_w3(card, monkeypatch):
    """nearest_hit and occluded on CUDA tensors with the plain loops
    raising: only W3 tests analytic objects there."""
    geom = edge_scene().to(card)
    O, D, _ = edge_rays(geom.to("cpu"))
    O, D = O.to(card), D.to(card)
    md = torch.full((O.shape[0],), 3.0, device=card)
    mask = torch.ones((40,), dtype=torch.bool, device=card)
    want = isect.nearest_hit(O, D, geom), isect.occluded(O, D, geom, mask, md)

    def plain(*args, **kw):
        raise AssertionError("the plain analytic loops ran on the card")

    monkeypatch.setattr(isect, "_analytic_nearest", plain)
    monkeypatch.setattr(isect, "_analytic_occluded", plain)
    analytic_sweep.reset_launches()
    got = isect.nearest_hit(O, D, geom), isect.occluded(O, D, geom, mask, md)
    assert analytic_sweep.launches() == 2
    for a, b in zip(got[0], want[0]):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_card_gradient_through_w3_is_the_plain_loops(card):
    """nearest_hit's t on the card with grad is W3's winners recomputed
    (analytic_winner_t): t bit for bit W3's, and its gradient the plain
    loops' on the card (float32: the rays' within 1e-6, the centres'
    within 1e-4 of the largest, summed in other orders; where the plain
    loops' is finite, as in test_winner_t_gradient_is_the_plain_loops)."""
    geom = edge_scene().to(card)
    O, D = (x.to(card) for x in edge_rays(geom.to("cpu"), n=N_RAYS)[:2])
    w = torch.from_numpy(np.random.default_rng(8).uniform(0.5, 1.5, N_RAYS)
                         .astype(np.float32)).to(card)
    ts = []

    def through_w3(O, D, g):
        t, o, obj = isect.nearest_hit(O, D, g)
        ts.append(t.detach())
        return t, o, obj

    analytic_sweep.reset_launches()
    kernel = grads(O, D, geom, w, through_w3)
    plain = grads(O, D, geom, w, isect._analytic_nearest)
    assert analytic_sweep.launches() == 1           # the one nearest_hit
    assert torch.equal(_bits(ts[0]), _bits(isect._analytic_nearest(O, D, geom)[0]))
    hold_grads(plain, kernel, (1e-6, 1e-6, 1e-4))


@pytest.mark.cuda
def test_card_backward_passes_are_bit_equal(card):
    """Two backward passes of one differentiable_render on the card give
    the same gradient bit for bit (F4: the gathers' sums in a fixed
    order)."""
    from raytracer_tpu_torch.diff import differentiable_render, update_materials
    from torch_inverse_rendering import TRUE_N, build_scene

    fn, data = differentiable_render(build_scene(TRUE_N, 32, 24), 2, seed=0,
                                     device=card)
    n0 = data.mats.refr_n_re

    def grad():
        x = n0.clone().requires_grad_(True)
        return torch.autograd.grad(torch.mean(fn(update_materials(
            data, refr_n_re=x)) ** 2), x)[0]

    g1, g2 = grad(), grad()
    assert float(g1.abs().max()) > 0
    assert torch.equal(g1, g2)
