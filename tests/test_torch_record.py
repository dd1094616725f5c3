"""The record path's plain version and replay against the JAX package.

`record_trace_chunk_reference` and the Pallas record kernel
(`_record_call(..., interpret=True)`, pallas_record.py:1096) get the same
compiled tables (through `tables_from_jax`), camera and seed_vec, so they
trace the same paths ray by ray and write the same records.  Each scene
is one interpret call of 16,384 rays, one Pallas tile of 128 x 128, so
the kernel has no padding lanes and both count the same rays; the call is
cached per module (the interpreter takes ~40 s a call on a CPU).

For each scene:
- the group words agree on >= 99.9% of (bounce, ray) elements, and the
  12 shading floats (rtol 1e-4, atol 1e-5) on >= 99.9%;
- rays_traced is equal, or differs only through lanes whose paths
  diverged (at most max_bounces rays each, and at most 0.1% of lanes);
- the port's replay fed the JAX kernel's own records agrees with JAX's
  `_replay` at rtol 1e-6 on every ray (observed: bit-equal on every ray
  of all three scenes; RGB9E5 texels below 2^-14 could still differ in
  the last bits, since XLA:CPU's exp2 is off by up to 5.4e-7 relative
  there, where torch's is exact);
- the whole chunk, records then replay, agrees per ray (rtol 1e-4,
  atol 1e-5) on >= 99.9% with pallas_record_chunk's own composition of
  the two, `_replay` of the interpreter's records (pallas_record.py:
  1196-1213 for the flat order without banding).

Observed on the CPU with the seed below: example 2 (32x32 x 16 spp,
split_k 3, r2) rays_traced 30,726 both, words 100% equal, floats
99.997%, replay bit-equal on every ray; the lit scene (iid) equal counts
too.  On the thin-film scene of tests/test_torch_textures.py two lanes of
16,384 diverge, and rays_traced is 19,545 against the interpreter's
19,547 (0.0102%): a ray reflected off the bubble re-hits it at its own
origin in one version and escapes in the other, an intersection decided
by the last bit, where XLA:CPU's FMA contraction rounds differently.  The interpreter's XLA:CPU
contracts a*b+c into FMA and approximates rsqrt, cos and sin, where the
plain version does none of these, so floats match per element with a
rate, not bit for bit.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.ops.pallas_record import _record_call, _replay
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.compile import compile_scene
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.interop import tables_from_jax
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops.replay import replay

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import lit_textures, torch_textured  # noqa: E402

RTOL, ATOL, MATCH_RATE = 1e-4, 1e-5, 0.999
SEED = np.array([1234, -5678, 96], np.int32)


def jax_cam_vec(cam):
    return jnp.concatenate([cam.origin, cam.fwd, cam.right, cam.up,
                            jnp.stack([cam.cam_w, cam.cam_h, cam.lens_radius,
                                       cam.focal, cam.half_fov])])


def hold_case(build, spp, sampler):
    """One interpret call of the Pallas record kernel and everything the
    port computes from the same inputs; build(m) builds the scene with
    package m."""
    sc = build(J)
    j_static, j_data = jax_compile(sc)
    _, _, settings = sc._settings_for_render(False)
    W, H = sc.camera.screen_width, sc.camera.screen_height
    n, B, k = spp * W * H, settings.max_bounces, settings.split_k
    assert n == 16384
    rg, rf, cnt = _record_call(jnp.asarray(SEED), j_data,
                               jax_cam_vec(sc.camera.params()), j_static, W, H,
                               spp, B, interpret=True, split_k=k,
                               sampler=sampler, projection=settings.projection)
    rg = np.asarray(rg).reshape(B, -1)[:, :n]
    rf = np.asarray(rf).reshape(B, 12, -1)[:, :, :n]
    L_j = np.asarray(_replay(jnp.asarray(rg), jnp.asarray(rf), j_data, j_static,
                             B, n))
    static, tables = tables_from_jax(j_static, j_data)
    cam = cam_vec(build(T).camera.params())
    seed = torch.from_numpy(SEED)
    args = (seed, static, tables, cam, W, H, spp, B, k, sampler,
            settings.projection)
    pg, pf, pc = rt.record_trace_chunk_reference(*args)
    L_full, c_full = rt.record_trace_chunk(*args)
    L_rep = replay(torch.from_numpy(rg.copy()), torch.from_numpy(rf.copy()),
                   static, tables, B, n)
    assert int(c_full) == int(pc)
    return dict(rg=rg, rf=rf, count=int(np.asarray(cnt)[:, 0, 0].sum()),
                L_j=L_j, pg=pg.numpy(), pf=pf.numpy(), pc=int(pc),
                L_full=L_full.numpy(), L_rep=L_rep.numpy())


def check_records(c):
    words = (c["pg"] == c["rg"]).mean()
    assert words >= MATCH_RATE, words
    floats = np.isclose(c["pf"], c["rf"], rtol=RTOL, atol=ATOL).mean()
    assert floats >= MATCH_RATE, floats


def check_replay(c):
    """Replay of the interpreter's records: rtol 1e-6 on every ray."""
    ok = np.isclose(c["L_rep"], c["L_j"], rtol=1e-6, atol=1e-12).all(axis=1)
    assert ok.all(), (ok.mean(), (c["L_rep"] == c["L_j"]).all(axis=1).mean())


def check_count(c):
    """rays_traced equal, or off only through the lanes whose paths
    diverged (a lane traces at most max_bounces rays)."""
    diverged = (c["pg"] != c["rg"]).any(axis=0)
    assert diverged.mean() <= 1 - MATCH_RATE, diverged.mean()
    assert abs(c["pc"] - c["count"]) <= c["rg"].shape[0] * diverged.sum(), (
        c["pc"], c["count"], np.nonzero(diverged)[0])


def check_chunk(c):
    match = np.isclose(c["L_full"], c["L_j"], rtol=RTOL, atol=ATOL).all(axis=1)
    assert match.mean() >= MATCH_RATE, (match.mean(), np.nonzero(~match)[0][:10])
    assert np.isfinite(c["L_full"]).all()
    m_t, m_j = c["L_full"].mean(), c["L_j"].mean()
    assert abs(m_t - m_j) <= 1e-3 * abs(m_j), (m_t, m_j)


CASES = {  # scene (package -> scene), spp (spp * H * W = 16,384), sampler
    "example2-split3-r2": (lambda m: torch_textured.example2(32, 32, m=m), 16,
                           "r2"),
    "lit_textures-iid": (lit_textures, 16, "iid"),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return hold_case(*CASES[request.param])


def test_records_match_pallas_kernel(case):
    check_records(case)


def test_rays_traced_equal(case):
    check_count(case)


def test_replay_of_jax_records_matches_jax_replay(case):
    check_replay(case)


def test_chunk_matches_pallas_record_chunk(case):
    check_chunk(case)


def test_cpu_tensors_take_the_plain_version():
    sc = torch_textured.example3(16, 8)
    static, tables, settings = sc._settings_for_render()
    cam = cam_vec(sc.camera.params())
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    args = (seed, static, tables, cam, 16, 8, 8, settings.max_bounces,
            settings.split_k)
    before = rt.record_trace_chunk.launches
    g, f, n = rt.record_trace_chunk_reference(*args)
    B = settings.max_bounces
    assert g.shape == (B, 16 * 8 * 8) and g.dtype == torch.int32
    assert f.shape == (B, 12, 16 * 8 * 8) and f.dtype == torch.float32
    L, c = rt.record_trace_chunk(*args)
    assert L.shape == (16 * 8 * 8, 3) and int(c) == int(n)
    assert torch.equal(L, replay(g, f, static, tables, B, 16 * 8 * 8))
    assert rt.record_trace_chunk.launches == before


def test_out_of_slice_scenes_raise_before_work():
    """Dispersion, triangles and the other projections now run through
    the record path; a bad sampler, projection or device raises
    ValueError, and a normal-mapped scene is outside the record kernel's
    gate, as in the JAX package (normal maps perturb the sampled
    directions), so it renders on the wavefront."""
    sc = torch_textured.example2(16, 8)
    static, tables, settings = sc._settings_for_render()
    cam = cam_vec(sc.camera.params())
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    args = (seed, static, tables, cam, 16, 8, 8, settings.max_bounces)
    for projection in ("fisheye", "equirect", "orthographic"):
        g, f, n = rt.record_trace_chunk_reference(*args, projection=projection)
        assert g.shape == (settings.max_bounces, 16 * 8 * 8)
        assert torch.isfinite(f).all() and int(n) >= 16 * 8 * 8
    for kwargs, what in ((dict(sampler="sobol"), "sampler"),
                         (dict(projection="stereo"), "projection")):
        with pytest.raises(ValueError, match=what):
            rt.record_trace_chunk(*args, **kwargs)
    with pytest.raises(ValueError, match="device"):
        rt.record_trace_chunk(seed.to("meta"), static, tables.to("meta"),
                              cam.to("meta"), 16, 8, 8, 4)
    sc.scene_primitives[0].material.dispersion = True
    disp, disp_tables, _ = sc._settings_for_render()
    L, n = rt.record_trace_chunk(seed, disp, disp_tables, *args[3:])
    assert torch.isfinite(L).all() and int(n) >= 16 * 8 * 8
    # a triangle scene, compiled by the JAX package
    js = J.Scene()
    js.add_Camera(look_from=J.vec3(0, 0, 2), look_at=J.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    js.add(J.Triangle(center=J.vec3(0, 0, 0), material=J.Emissive(
                          color=J.image(np.ones((4, 4, 3), np.float32))),
                      p1=J.vec3(-1, -1, 0), p2=J.vec3(1, -1, 0),
                      p3=J.vec3(0, 1, 0)))
    tri_static, tri_tables = tables_from_jax(*jax_compile(js))
    rt.check_slice(tri_static, 0, "r2", "pinhole")
    L, n = rt.record_trace_chunk(seed, tri_static, tri_tables,
                                 cam_vec(js.camera.params()), 8, 8, 2, 4)
    assert float(L.sum()) > 0
    nm = torch_textured.example2(16, 8)
    nm.scene_primitives[0].material.set_normalmap(np.zeros((2, 2, 3)))
    nm_static, _ = compile_scene(nm)
    assert not nm_static.pallas_tex_ok and not nm_static.pallas_ok
    assert route(nm_static, nm.settings) == "wavefront"
    jnm = torch_textured.example2(16, 8, m=J)
    jnm.scene_primitives[0].material.set_normalmap(np.zeros((2, 2, 3)))
    j_static, _ = jax_compile(jnm)
    assert (j_static.pallas_ok, j_static.pallas_tex_ok) == (False, False)


def test_kernel_wrapper_checks_its_inputs():
    """The CUDA wrapper's checks run before anything is built or launched
    (here on CPU tensors, which the checks treat like any device's)."""
    sc = torch_textured.example2(16, 8)
    static, tables, settings = sc._settings_for_render()
    cam = cam_vec(sc.camera.params())
    seed = torch.tensor([3, 4, 0], dtype=torch.int32)
    ok = (seed, static, tables, cam, 16, 8, 8, 4, 3, "r2")
    with pytest.raises(TypeError, match="seed_vec"):
        rt._launch(seed.long(), *ok[1:])
    with pytest.raises(ValueError, match="cam_vec"):
        rt._launch(seed, static, tables, cam[:16], *ok[4:])
    bad = tables.to("cpu")
    object.__setattr__(bad, "glo", torch.zeros(12, 2).t())
    with pytest.raises(ValueError, match="contiguous"):
        rt._launch(seed, static, bad, *ok[3:])
    bad = tables.to("cpu")
    object.__setattr__(bad, "refr", tables.refr[:1].clone())
    with pytest.raises(ValueError, match="material slot"):
        rt._launch(seed, static, bad, *ok[3:])
    with pytest.raises(ValueError, match="chunk shape"):
        rt._launch(seed, static, tables, cam, 16, 8, 0, 4, 3, "r2")
    # the fetch table must have a row per shading group, and the atlas
    # int32 words
    bad = tables.to("cpu")
    object.__setattr__(bad, "fetch_i", tables.fetch_i[:-1].clone())
    with pytest.raises(ValueError, match="fetch_i"):
        rt._launch(seed, static, bad, *ok[3:])
    bad = tables.to("cpu")
    object.__setattr__(bad, "atlas", tables.atlas.float())
    with pytest.raises(TypeError, match="atlas"):
        rt._launch(seed, static, bad, *ok[3:])


def test_replay_rounds_and_gates():
    """Example 4 replays in two rounds (its composed thin-film table is
    past TF_COMP_LIMIT), the others in one; all four take the record
    path, as in the JAX package."""
    for k, build in torch_textured.EXAMPLES.items():
        kw = {"blur": 0.0} if k == 4 else {}
        static, _ = compile_scene(build(16, 12, **kw))
        j_static, _ = jax_compile(build(16, 12, m=J, **kw))
        assert static.pallas_tex_ok and not static.pallas_ok
        assert rt.replay_rounds(static) == (2 if k == 4 else 1)
        from raytracer_tpu.ops.pallas_record import replay_rounds
        assert rt.replay_rounds(static) == replay_rounds(j_static)
