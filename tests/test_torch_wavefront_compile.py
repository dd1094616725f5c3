"""The wavefront's scene tables, camera rays and lattice draws against the
JAX package's.

`compile_wavefront` gives every scene the wavefront's SceneData (per-kind
geometry, object, material and light tables, float32 textures); it must
equal the JAX package's array for array, on the shared scene builders and
on three scenes past the kernels' gates (49 objects, 9 importance-sampled
targets, 37 shading groups).  `generate_rays` on the R2 lattice and
`first_bounce_uniforms` are integer lattice math and hold per ray: the
lattice bits exactly, the rays to float32 rounding (XLA:CPU approximates
sin, cos and atan2).
"""

import dataclasses
import fcntl
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as J
import raytracer_tpu_torch as T
from raytracer_tpu.core import camera as jcam
from raytracer_tpu.core import lds as jlds
from raytracer_tpu.core.compile import compile_scene as jax_compile
from raytracer_tpu.core.compile import derive_split_k as jax_split_k
from raytracer_tpu_torch.core import camera as tcam
from raytracer_tpu_torch.core import lds as tlds
from raytracer_tpu_torch.core.compile import (TRI_CLUSTER_THRESHOLD,
                                              compile_scene, compile_wavefront,
                                              derive_split_k)
from raytracer_tpu_torch.core.scene import route
from raytracer_tpu_torch.interop import scene_data_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_scenes import (cornell, glass, is_diffuse,  # noqa: E402
                               lights_and_slots, lit_textures, textured_scene,
                               thinfilm_ibl, torch_primitives)
from torch_wavefront import grid  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the wavefront's modules run: their
    renders are thousands of small torch ops, and with several test
    workers on the machine each op's thread team would spin against the
    others' (a 16x16 Cornell render took 100x longer so).  The wavefront
    test modules import this fixture; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native mesh library, loaded, in every module that
    compiles a JAX mesh scene or calls it.

    raytracer_tpu/native builds _mesh_native.so with g++ straight onto its
    final path at first use and latches a failed build or load for the
    life of the process; test workers that start on a fresh checkout
    together build it at the same moment, and a worker that loads a
    half-written file would take the median-split / pure-Python fallback
    for good (another leaf order, other tables).  So the port's workers
    take turns under a file lock and retry the load (clearing the latch)
    until it succeeds, while a JAX test worker's g++ may still be writing
    the file; then it must be available."""
    from raytracer_tpu import native as jnative

    lock = REPO / "build" / "jax_native.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + 60.0
            while jnative._lib is None:
                jnative._load_failed = False
                if (jnative._load() is not None
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.5)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    assert jnative.available()
    return jnative


def grid49(m):
    return grid(47, 16, 12, m=m)


def is_targets9(m):
    """Nine importance-sampled emitters over a diffuse floor: past the
    kernels' limit of 8 targets."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 2, 4), look_at=m.vec3(0, 0, 0),
                  screen_width=12, screen_height=10, field_of_view=50)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.6),
                                      diffuse_rays=2),
                   center=m.vec3(0, 0, 0), width=20.0, height=20.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    for i in range(9):
        x, z = (i % 3 - 1) * 1.2, (i // 3 - 1) * 1.2
        sc.add(m.Sphere(material=m.Emissive(color=m.rgb(2, 1.8, 1.5)),
                        center=m.vec3(x, 1.5, z), radius=0.15, shadow=False),
               importance_sampled=True)
    return sc


def groups37(m):
    """37 glossy spheres, each its own depth cap, so 37 shading groups
    after either kernel's merge, and a directional light with shadows."""
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 3, 9), look_at=m.vec3(0, 0, 0),
                  screen_width=12, screen_height=10, field_of_view=40)
    sc.add_DirectionalLight(Ldir=m.vec3(0.3, 1.0, 0.4), color=m.rgb(0.8, 0.8, 0.8))
    for i in range(37):
        sc.add(m.Sphere(material=m.Glossy(diff_color=m.rgb(0.7, 0.4, 0.3),
                                          roughness=0.3, spec_coeff=0.3,
                                          diff_coeff=0.7, n=m.vec3(1.5, 1.5, 1.5)),
                        center=m.vec3((i % 7 - 3) * 1.1, 0.0, (i // 7 - 3) * 1.1),
                        radius=0.45, max_ray_depth=1 + i))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.9, 0.9, 1.0)),
                    center=m.vec3(0, 0, 0), radius=40.0, shadow=False))
    return sc


def tri_scene(m):
    """Two triangles and a rotated cylinder: the flat-triangle tables."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 3), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    mat = m.Diffuse(diff_color=m.rgb(0.5, 0.6, 0.7))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0, 0),
                      p1=m.vec3(-1, -1, 0), p2=m.vec3(1, -1, 0),
                      p3=m.vec3(0, 1, -0.5)))
    sc.add(m.Triangle(material=mat, center=m.vec3(0, 0, -1),
                      p1=m.vec3(-1, 1, -1), p2=m.vec3(1, 1, -1),
                      p3=m.vec3(0, -1, -1.5)))
    cyl = m.Cylinder(material=mat, center=m.vec3(0.5, 0, -0.5), radius=0.3,
                     height=0.8)
    cyl.rotate(θ=30, u=m.vec3(1, 0, 1))
    sc.add(cyl)
    return sc


def prim(name):
    def build(m):
        return getattr(torch_primitives, name)(32, 24, m=m)
    build.__name__ = name
    return build


SCENES = [cornell, glass, is_diffuse, lights_and_slots, textured_scene,
          thinfilm_ibl, lit_textures, tri_scene, prim("primitives"),
          prim("shapes"), prim("dispersion"), grid49, is_targets9, groups37]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("build", SCENES, ids=[b.__name__ for b in SCENES])
def test_scene_data_equals_jax(build):
    j_static, j_data = jax_compile(build(J))
    static, got = compile_wavefront(build(T))
    want = scene_data_from_jax(j_data)
    for grp in ("geom", "obj", "mats", "lights"):
        for f in dataclasses.fields(getattr(got, grp)):
            _equal(getattr(getattr(got, grp), f.name).numpy(),
                   getattr(getattr(want, grp), f.name).numpy(), f"{grp}.{f.name}")
    for f in ("is_center", "is_radius", "ambient_color", "scene_n_re",
              "scene_n_im"):
        _equal(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
    assert len(got.textures) == len(want.textures)
    for i, (a, b) in enumerate(zip(got.textures, want.textures)):
        _equal(a.numpy(), b.numpy(), f"texture {i}")
    # the tables the port has no counterpart for are empty in the JAX
    # package's compile of these scenes
    for f in ("tri_cl_lo", "tri_vn1", "tri_tan", "tri_virt_row", "inst_rot"):
        assert np.asarray(getattr(j_data.geom, f)).shape[0] == 0, f
    assert np.asarray(j_data.env_is_prob).shape[0] == 0
    # what the wavefront reads of the static side
    assert static.needs_uv == j_static.needs_uv
    assert static.mat_types_present == j_static.mat_types_present
    assert static.n_is_targets == j_static.n_is_targets
    assert static.has_shadow_objects == j_static.has_shadow_objects
    assert static.has_dispersion == j_static.has_dispersion
    assert static.kind_counts == dict(
        sphere=j_static.n_spheres, plane=j_static.n_planes,
        box=j_static.n_boxes, disc=j_static.n_discs,
        cyl=j_static.n_cylinders, tri=j_static.n_tris)
    assert derive_split_k(static) == jax_split_k(j_static)
    assert (static.pallas_ok, static.pallas_tex_ok) == (j_static.pallas_ok,
                                                        j_static.pallas_tex_ok)


@pytest.mark.parametrize("build", [grid49, is_targets9, groups37],
                         ids=["grid49", "is_targets9", "groups37"])
def test_past_the_gates_routes_to_the_wavefront(build):
    sc = build(T)
    static, _, settings = sc._settings_for_render()
    assert not (static.pallas_ok or static.pallas_tex_ok)
    assert route(static, settings) == "wavefront"
    for mode, want in (("never", "wavefront"), ("auto", "wavefront")):
        sc.settings = T.RenderSettings(use_pallas=mode)
        assert route(static, sc._settings_for_render()[2]) == want
    sc.settings = T.RenderSettings(use_pallas="always")
    with pytest.raises(ValueError, match="outside both kernels' gates"):
        sc.render(1, device="cpu")


def test_routes_inside_the_gates():
    for build, kernel in ((cornell, "solid"), (textured_scene, "record")):
        sc = build(T)
        for mode, want in (("auto", kernel), ("always", kernel),
                           ("never", "wavefront")):
            sc.settings = T.RenderSettings(use_pallas=mode)
            static, _, settings = sc._settings_for_render()
            assert route(static, settings) == want
    with pytest.raises(ValueError, match="use_pallas"):
        T.RenderSettings(use_pallas="sometimes")


def test_cluster_sized_triangle_scenes_raise():
    """TRI_CLUSTER_THRESHOLD triangles or more compiled to clusters in the
    JAX package only, and raised here before ROADMAP.md item 4; now they
    compile to the JAX package's clusters (and render: the mesh tests,
    tests/test_torch_mesh_*.py)."""
    def build(m):
        sc = m.Scene()
        mat = m.Diffuse(diff_color=m.rgb(0.5, 0.5, 0.5))
        for i in range(TRI_CLUSTER_THRESHOLD):
            sc.add(m.Triangle(material=mat, center=m.vec3(i, 0, 0),
                              p1=m.vec3(i, 0, 0), p2=m.vec3(i + 1, 0, 0),
                              p3=m.vec3(i, 1, 0)))
        return sc
    static, got = compile_wavefront(build(T))
    j_static, j_data = jax_compile(build(J))
    want = scene_data_from_jax(j_data)
    assert got.geom.tri_cl_lo.shape == (TRI_CLUSTER_THRESHOLD // 256, 3)
    for f in ("tri_p1", "tri_cl_lo", "tri_cl_hi", "tri_cl_start",
              "tri_cl_virt"):
        _equal(getattr(got.geom, f).numpy(), getattr(want.geom, f).numpy(), f)
    assert static.n_objects == j_static.n_objects == TRI_CLUSTER_THRESHOLD
    assert not (static.pallas_ok or static.pallas_tex_ok)


# ---------------------------------------------------------------------------
# camera rays and lattice draws
# ---------------------------------------------------------------------------

CAMERAS = {
    "pinhole": dict(look_from=(0.3, 0.5, 2.0), look_at=(0, 0.2, 0)),
    "thin_lens": dict(look_from=(0.3, 0.5, 2.0), look_at=(0, 0.2, 0),
                      aperture=0.3, focal_distance=2.2),
    "fisheye": dict(look_from=(0.3, 0.5, 2.0), look_at=(0, 0.2, 0),
                    field_of_view=170.0, projection="fisheye"),
    "equirect": dict(look_from=(0.3, 0.5, 2.0), look_at=(1, 0.2, 0),
                     projection="equirect"),
    "orthographic": dict(look_from=(0.3, 0.5, 2.0), look_at=(0, 0.2, 0),
                         focal_distance=3.0, projection="orthographic"),
}


def _cams(name, W, H):
    kw = dict(CAMERAS[name])
    return (J.Camera(screen_width=W, screen_height=H, **kw),
            T.Camera(screen_width=W, screen_height=H, **kw))


@pytest.mark.parametrize("band", [None, (5, 4)], ids=["frame", "band"])
@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays_r2_per_ray(name, band):
    W, H, spp = 12, 10, 3
    row0, rows = band if band else (0, None)
    seed, sample0 = 123456789, 40
    jc, tc = _cams(name, W, H)
    jo, jd = jcam.generate_rays(jax.random.PRNGKey(0), jc.params(), W, H, spp,
                                row0=jnp.float32(row0), rows=rows,
                                strat_seed=jnp.int32(seed),
                                sample0=jnp.int32(sample0),
                                projection=jc.projection)
    to, td = tcam.generate_rays(None, tc.params(), W, H, spp, row0=row0,
                                rows=rows, strat_seed=seed, sample0=sample0,
                                projection=tc.projection, device="cpu")
    n = spp * W * (rows or H)
    assert to.shape == td.shape == (n, 3)
    assert to.dtype == td.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("projection", ["pinhole", "equirect"])
def test_generate_rays_iid_jitter_stays_in_its_pixel(projection):
    """The iid sampler draws from the generator: same seed, same rays; each
    ray stays within its pixel of the zero-jitter (pixel-centre) ray."""
    W, H, spp = 8, 6, 64
    _, tc = _cams(projection, W, H)
    p = tc.params()
    g = lambda: torch.Generator().manual_seed(5)
    o1, d1 = tcam.generate_rays(g(), p, W, H, spp, sampler="iid",
                                projection=projection)
    o2, d2 = tcam.generate_rays(g(), p, W, H, spp, sampler="iid",
                                projection=projection)
    assert torch.equal(d1, d2) and torch.equal(o1, o2)
    d = d1.view(spp, W * H, 3)
    # per-pixel spread of the directions: jitter, about a pixel wide
    spread = (d.amax(0) - d.amin(0)).norm(dim=-1)
    pix = 2 * np.pi / W if projection == "equirect" else float(p.cam_w) / W
    assert float(spread.max()) < 2.5 * pix
    assert float(spread.min()) > 0.3 * pix
    with pytest.raises(ValueError, match="sampler"):
        tcam.generate_rays(g(), p, W, H, 1, sampler="sobol")


@pytest.mark.parametrize("row0", [0, 7])
def test_first_bounce_uniforms_equal_jax(row0):
    W, rows, spp, seed, sample0 = 9, 5, 4, 987654321, 260
    want = jlds.first_bounce_uniforms(W, rows * W, spp, jnp.float32(row0),
                                      jnp.int32(seed), jnp.int32(sample0))
    got = tlds.first_bounce_uniforms(W, rows * W, spp, row0, seed, sample0)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))
