"""Scene descriptions shared by the port's tests, and the port's tests
that need no JAX.

Each scene function takes a package, `raytracer_tpu` or `raytracer_tpu_torch`,
and builds one scene through that package's API, so one description
serves both sides of a comparison.

The tests marked `cuda` need a card and skip without one.  This file
imports no JAX, so they run on a machine without it, skipping
tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_scenes.py
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.scene import chunk_seeds, plan_chunks
from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops import record_trace as rt
from raytracer_tpu_torch.ops import solid_trace as st

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import torch_primitives  # noqa: E402
import torch_textured  # noqa: E402
from torch_cornellbox import projection_camera  # noqa: E402


def cornell(m):
    if m.__name__ == "raytracer_tpu":
        from example_cornellbox import build_cornell
    else:
        from torch_cornellbox import build_cornell
    return build_cornell(16, 16)


# the four solid scenes of tests/test_pallas_trace.py
def emissive(m):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 0), look_at=m.vec3(0, 0, -1),
                  screen_width=16, screen_height=16)
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.3, 0.5, 0.7)),
                    center=m.vec3(0, 0, 0), radius=10.0, shadow=False))
    return sc


def box_and_plane(m):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0.3, 0.2, 3), look_at=m.vec3(0, 0, -1),
                  screen_width=16, screen_height=16)
    cb = m.Cuboid(material=m.Emissive(color=m.rgb(0.9, 0.4, 0.1)),
                  center=m.vec3(0, 0, 0), width=1, height=2, length=1)
    cb.rotate(θ=30, u=m.vec3(0, 1, 0))
    sc.add(cb)
    sc.add(m.Plane(material=m.Emissive(color=m.rgb(0.1, 0.2, 0.9)),
                   center=m.vec3(0, -1, 0), width=50.0, height=50.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    return sc


def glass(m):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 2), look_at=m.vec3(0, 0, -1),
                  screen_width=8, screen_height=8, field_of_view=30)
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(1.5 + 4e-8j, 1.5, 1.5)),
                    center=m.vec3(0, 0, 0), radius=0.5, shadow=False,
                    max_ray_depth=4))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.8, 0.6, 0.4)),
                    center=m.vec3(0, 0, 0), radius=20.0, shadow=False))
    return sc


def is_diffuse(m):
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 1, 0.3), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8, field_of_view=30)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.6)),
                   center=m.vec3(0, 0, 0), width=100.0, height=100.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Plane(material=m.Emissive(color=m.rgb(0.8, 0.8, 0.8)),
                   center=m.vec3(0, 3, 0), width=2.0, height=2.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, 1)),
           importance_sampled=True)
    return sc


def lights_and_slots(m):
    """Shared and distinct material slots, mc, a rotated (generic) plane,
    a thin lens, and all three light kinds (the light table)."""
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.02, 0.01), n=m.vec3(1.1, 1.0, 1.0))
    sc.add_Camera(look_from=m.vec3(0, 0.5, 2.5), look_at=m.vec3(0, 0.3, 0),
                  screen_width=16, screen_height=8, field_of_view=45,
                  aperture=0.2, focal_distance=2.0)
    sc.add_DirectionalLight(Ldir=m.vec3(0.3, -1, -0.4), color=m.rgb(1, 1, 1))
    sc.add_PointLight(pos=m.vec3(0, 3, 1), color=m.rgb(2, 1, 1))
    sc.add_SpotLight(pos=m.vec3(1, 3, 1), direction=m.vec3(0, -1, 0),
                     color=m.rgb(1, 2, 1), angle=40.0)
    white = m.Diffuse(diff_color=m.rgb(0.7, 0.7, 0.7), diffuse_rays=8)
    red = m.Diffuse(diff_color=m.rgb(0.8, 0.2, 0.2), ambient_weight=0.3,
                    diffuse_rays=12)
    sc.add(m.Plane(material=white, center=m.vec3(0, 0, 0), width=8.0,
                   height=8.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    tilted = m.Plane(material=red, center=m.vec3(0, 1, -2), width=3.0,
                     height=2.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0))
    tilted.rotate(θ=25, u=m.vec3(1, 1, 0))
    sc.add(tilted)
    sc.add(m.Sphere(material=white, center=m.vec3(-0.9, 0.3, 0), radius=0.3))
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(1.5, 1.5, 1.5)),
                    center=m.vec3(0.6, 0.9, -0.6), radius=0.25, shadow=False,
                    mc=True, max_ray_depth=7), importance_sampled=True)
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(1.3, 1.3, 1.3)),
                    center=m.vec3(-0.6, 0.9, -0.6), radius=0.25))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(2, 2, 1.8)),
                    center=m.vec3(0, 2.5, 0), radius=0.4, shadow=False),
           importance_sampled=True)
    return sc


def _procedural(m):
    """The package's procedural texture module (numpy in both)."""
    return importlib.import_module(m.__name__ + ".textures.procedural")


def textured_scene(m):
    """tests/test_pallas_record.py's textured scene: a glossy sphere, a
    checkered glossy floor, a directional light, the procedural sky."""
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.25, 1), look_at=m.vec3(0, 0.25, -3),
                  screen_width=20, screen_height=16)
    sc.add_DirectionalLight(Ldir=m.vec3(0.52, 0.45, -0.5),
                            color=m.rgb(0.15, 0.15, 0.15))
    gold = m.Glossy(diff_color=m.rgb(1.0, 0.572, 0.184),
                    n=m.vec3(0.15 + 3.58j, 0.4 + 2.37j, 1.54 + 1.91j),
                    roughness=0.0, spec_coeff=0.2, diff_coeff=0.8)
    sc.add(m.Sphere(material=gold, center=m.vec3(-0.5, 0.1, -3.0), radius=0.6,
                    max_ray_depth=3))
    floor = m.Glossy(diff_color=m.image(_procedural(m).checkerboard(64),
                                        repeat=40.0),
                     n=m.vec3(1.2 + 0.3j, 1.2 + 0.3j, 1.1 + 0.3j),
                     roughness=0.2, spec_coeff=0.3, diff_coeff=0.9)
    sc.add(m.Plane(material=floor, center=m.vec3(0, -0.5, -3.0), width=120.0,
                   height=120.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   max_ray_depth=3))
    sc.add_Background(m.procedural_sky(128, 96))
    return sc


def thinfilm_ibl(m):
    """The thin-film + lightmap scene of tests/test_pallas_record.py:54 at
    example 4's light intensity, 32x32: a blurred 128x96 sky whose
    combined table packs RGB9E5, and a thin film whose composed table is
    too large, so the replay takes two rounds."""
    sc = m.Scene(ambient_color=m.rgb(0.01, 0.01, 0.01))
    sc.add_Camera(screen_height=32, screen_width=32,
                  look_from=m.vec3(-4, 0, 0), look_at=m.vec3(0, 0.05, 0))
    sc.add(m.Sphere(material=m.ThinFilmInterference(thickness=330, noise=60.0),
                    center=m.vec3(1.0, 0.0, 1.5), radius=1.7, shadow=False,
                    max_ray_depth=5))
    sc.add_Background(m.procedural_sky(128, 96), light_intensity=5.0, blur=4.0)
    return sc


def lit_textures(m):
    """Diffuse with an image texture, glossy with a bilinear texture, an
    emissive image (importance-sampled), a solid diffuse box, one point
    and one spot light with shadow rays, and the procedural sky."""
    proc = _procedural(m)
    checker = proc.checkerboard(64, squares=4)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.04, 0.03))
    sc.add_Camera(look_from=m.vec3(0, 1.0, 3.0), look_at=m.vec3(0, 0.3, 0),
                  screen_width=32, screen_height=32, field_of_view=60)
    sc.add_PointLight(pos=m.vec3(1.5, 2.5, 1.0), color=m.rgb(3, 3, 3))
    sc.add_SpotLight(pos=m.vec3(-1.5, 2.5, 1.0), direction=m.vec3(0.5, -1, -0.3),
                     color=m.rgb(2, 2, 3), angle=35.0)
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.image(checker, repeat=4.0),
                                      diffuse_rays=4),
                   center=m.vec3(0, 0, 0), width=8.0, height=8.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=m.Glossy(
                        diff_color=m.image(proc.wood(64), repeat=2.0,
                                           filter="bilinear"),
                        n=m.vec3(1.5, 1.5, 1.5), roughness=0.3,
                        spec_coeff=0.4, diff_coeff=0.6),
                    center=m.vec3(0.6, 0.5, 0.0), radius=0.5, max_ray_depth=2))
    sc.add(m.Sphere(material=m.Emissive(color=m.image(checker * 3.0)),
                    center=m.vec3(-0.8, 0.6, -0.5), radius=0.35),
           importance_sampled=True)
    box = m.Cuboid(material=m.Diffuse(diff_color=m.rgb(0.7, 0.3, 0.2)),
                   center=m.vec3(-0.2, 0.25, 0.8), width=0.4, height=0.5,
                   length=0.3)
    box.rotate(θ=20, u=m.vec3(0, 1, 0))
    sc.add(box)
    sc.add_Background(m.procedural_sky(128, 96))
    return sc


def too_many_objects(m):
    """49 objects: past the gate's object cap in both packages."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 5), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    mat = m.Emissive(color=m.rgb(1, 1, 1))
    for i in range(49):
        sc.add(m.Sphere(material=mat, center=m.vec3(i * 0.1, 0, 0), radius=0.05))
    return sc


def solid_primitives(m):
    """examples/torch_primitives.py's shapes scene at 16x16."""
    return torch_primitives.shapes(16, 16, m=m)


def dispersive_pair(m):
    """Two dispersive glasses in one merged group of the solid kernel (one
    hero-wavelength draw), a third at another depth cap (a second group,
    whose draws stop a bounce earlier), a diffuse floor whose draws come
    first, and an emissive dome (tests/test_pallas_trace.py:223).  16x16."""
    sc = m.Scene(ambient_color=m.rgb(0.02, 0.02, 0.02))
    sc.add_Camera(look_from=m.vec3(0, 0.3, 2.2), look_at=m.vec3(0, 0, 0),
                  screen_width=16, screen_height=16, field_of_view=50)
    for n, x in (((1.45, 1.52, 1.60), -0.45), ((1.30, 1.34, 1.38), 0.45)):
        sc.add(m.Sphere(material=m.Refractive(
                            n=m.vec3(*(c + 0j for c in n)), dispersion=True),
                        center=m.vec3(x, 0, 0), radius=0.42, shadow=False,
                        max_ray_depth=4))
    sc.add(m.Sphere(material=m.Refractive(
                        n=m.vec3(1.5 + 1e-8j, 1.6 + 1e-8j, 1.7 + 1e-8j),
                        dispersion=True),
                    center=m.vec3(0, 0.55, -0.4), radius=0.25, shadow=False,
                    max_ray_depth=2))
    sc.add(m.Plane(material=m.Diffuse(diff_color=m.rgb(0.5, 0.45, 0.4)),
                   center=m.vec3(0, -0.45, 0), width=6.0, height=6.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1)))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(1.5, 1.3, 1.1)),
                    center=m.vec3(0, 0, 0), radius=25.0, shadow=False))
    return sc


def example2_solid(m):
    """examples/torch_primitives.py's Whitted-style example 2 at 16x16:
    glossy, a directional light with shadow rays, refractive spheres at
    split_k 3."""
    return torch_primitives.example2_solid(16, 16, m=m)


def primitives_close(m):
    """examples/torch_primitives.py's primitives at 32x32 seen from 1.5
    units instead of 5 (the record kernel).  From the example's own
    camera the reference's cylinder test, which solves its quadratic in
    the object's frame, loses to cancellation in |o|^2 - r^2 and places
    hits up to ~1e-5 inside the surface, past the 1e-6 offset of the next
    ray; whether that ray re-hits the cylinder is then decided by
    rounding, so a third of the rays leaving a cylinder take another path
    wherever XLA:CPU contracts a*b+c into FMA and the port does not."""
    sc = torch_primitives.primitives(32, 32, m=m)
    sc.camera = m.Camera(look_from=m.vec3(0.1, 0.45, -0.7),
                         look_at=m.vec3(0, 0.0, -2.2), screen_width=32,
                         screen_height=32, field_of_view=80)
    return sc


def primitives_dispersive(m):
    """primitives_close with the glass cylinder dispersive and a dispersive
    triangle of another slot: two hero-wavelength groups of the record
    kernel."""
    sc = primitives_close(m)
    sc.scene_primitives[2].material.dispersion = True
    sc.add(m.Triangle(material=m.Refractive(
                          n=m.vec3(1.45 + 0j, 1.5 + 0j, 1.56 + 0j),
                          dispersion=True),
                      center=m.vec3(0.2, 0.2, -1.6), p1=m.vec3(-0.2, -0.1, -1.6),
                      p2=m.vec3(0.6, 0.0, -1.7), p3=m.vec3(0.2, 0.6, -1.5),
                      max_ray_depth=3))
    return sc


def cornell_projection(projection):
    """The 16x16 Cornell box under a projection, with the cameras of
    examples/torch_cornellbox.py (the pinhole here looks at the back
    wall from the front, with the default field of view)."""
    def build(m):
        sc = cornell(m)
        if projection == "pinhole":
            sc.camera = m.Camera(look_from=m.vec3(278, 278, 800),
                                 look_at=m.vec3(278, 278, -555),
                                 screen_width=16, screen_height=16)
        else:
            sc.camera = projection_camera(m, projection, 16, 16)
        return sc
    build.__name__ = f"cornell_{projection}"
    return build


def still_life_projection(projection, width=32, height=32):
    """examples/torch_primitives.py's still life through the pinhole,
    fisheye, equirect or orthographic camera (the record kernel)."""
    def build(m):
        if projection == "pinhole":
            return torch_primitives.still_life(width, height, m=m)
        if projection == "fisheye":
            return torch_primitives.fisheye(width, height, m=m)
        if projection == "equirect":
            return torch_primitives.panorama(width, height, m=m)
        return torch_primitives.orthographic(width, height, m=m)
    build.__name__ = f"still_life_{projection}"
    return build



def _inputs(build, device):
    sc = build(T)
    _, tables, settings = sc._settings_for_render()
    return sc, tables.to(device), cam_vec(sc.camera.params()).to(device), settings


def test_linear_output_needs_no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = emissive(T).render(samples_per_pixel=1, output="linear", device="cpu")
    assert img.shape == (16, 16, 3) and img.dtype == np.float32
    with pytest.raises(ImportError):
        emissive(T).render(samples_per_pixel=1, device="cpu")


def test_chunk_seeds_layout():
    s = chunk_seeds(7, 5, 26)
    assert s.dtype == np.int32 and s.shape == (5, 3)
    assert np.array_equal(s, chunk_seeds(7, 5, 26))
    assert not np.array_equal(s[:, 0], chunk_seeds(8, 5, 26)[:, 0])
    assert len(set(s[:, 1])) == 1 and len(set(s[:, 0])) == 5
    assert np.array_equal(s[:, 2], np.arange(5) * 26)
    assert (s[:, :2] >= 0).all()


def test_build_is_keyed_by_sources_and_flags(monkeypatch, tmp_path):
    """The kernels' build, with a stand-in for nvcc: the library lands
    under a hash of the sources (the shared header included), the flags
    and nvcc's version, is reused, and a failed build leaves no file
    behind."""
    fake = tmp_path / "nvcc"

    def stand_in(version, compiles):
        body = ('while [ $# -gt 0 ]; do [ "$1" = -o ] && echo lib > "$2"; '
                'shift; done\necho "ptxas info: ok"\n' if compiles else "exit 3\n")
        fake.write_text(f'#!/bin/sh\n[ "$1" = --version ] && echo "{version}" '
                        f'&& exit 0\n{body}')
        fake.chmod(0o755)

    cb = cuda_build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("solid_trace.cu", "record_trace.cu", "trace_common.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    stand_in("release 1.0", compiles=True)
    monkeypatch.setattr(cb, "CSRC", csrc)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cb, "_nvcc", lambda: str(fake))
    out = cb.build()
    assert out.parent == tmp_path / "build" and out.read_text() == "lib\n"
    assert "ptxas info" in cb.build_log
    stand_in("release 1.0", compiles=False)
    assert cb.build() == out                      # reused, nvcc not run
    for flags, version in ((cb.NVCC_FLAGS + ("-DOTHER",), "release 1.0"),
                           (cb.NVCC_FLAGS, "release 2.0")):
        with monkeypatch.context() as m:
            m.setattr(cb, "NVCC_FLAGS", flags)
            stand_in(version, compiles=False)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                cb.build()
    (csrc / "trace_common.cuh").write_text("// changed\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cb.build()                                # a header edit rebuilds
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [out.name]


CUDA_CASES = [(cornell, 16, "r2"), (glass, 64, "r2"), (is_diffuse, 64, "iid"),
              (lights_and_slots, 32, "r2"), (solid_primitives, 16, "r2"),
              (dispersive_pair, 16, "iid"), (example2_solid, 16, "r2")]
CUDA_CASES += [(cornell_projection(p), 16, "r2")
               for p in ("fisheye", "equirect", "orthographic")]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("build,spp,sampler", CUDA_CASES,
                         ids=[f"{c[0].__name__}-{c[2]}" for c in CUDA_CASES])
def test_kernel_matches_plain_version_on_card(build, spp, sampler):
    dev = _need_card()
    sc, tables, cam, settings = _inputs(build, dev)
    W, H = sc.camera.screen_width, sc.camera.screen_height
    seed = torch.tensor([11, 22, 5], dtype=torch.int32, device=dev)
    args = (seed, tables, cam, W, H, spp, settings.max_bounces,
            settings.split_k, sampler, settings.projection)
    before = st.solid_trace_chunk.launches
    L_k, n_k = st.solid_trace_chunk(*args)
    L_p, n_p = st.solid_trace_chunk_reference(*args)
    torch.cuda.synchronize()
    assert st.solid_trace_chunk.launches == before + 1
    assert int(n_k) == int(n_p)
    match = torch.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(dim=1)
    assert match.float().mean().item() >= 0.999


@pytest.mark.cuda
def test_render_on_card_runs_the_kernel_and_matches_cpu():
    """Chunk seeds depend on `seed` alone, so the card and the CPU trace
    the same rays: the images agree up to rounding."""
    dev = _need_card()
    sc = cornell(T)
    chunk, n_chunks = plan_chunks(2 * sc._diffuse_fan(), 16, 16)
    before = st.solid_trace_chunk.launches
    img, stats = sc.render(samples_per_pixel=2, output="linear",
                           return_stats=True, device=dev)
    assert st.solid_trace_chunk.launches == before + n_chunks
    ref, ref_stats = sc.render(samples_per_pixel=2, output="linear",
                               return_stats=True, device="cpu")
    assert np.isfinite(img).all()
    assert abs(stats["rays_traced"] - ref_stats["rays_traced"]) <= 2
    assert abs(img.mean() - ref.mean()) <= 1e-4 * ref.mean()


RECORD_CUDA_CASES = {  # 32x32 scenes of the port, sampler
    # example 4: a two-round thin film and an environment lightmap;
    # lit_textures: a bilinear texture
    "example1": (lambda: torch_textured.example1(32, 32), "r2"),
    "example2": (lambda: torch_textured.example2(32, 32), "r2"),
    "example3": (lambda: torch_textured.example3(32, 32), "r2"),
    "example4-blur0": (lambda: torch_textured.example4(32, 32, blur=0.0), "r2"),
    "lit_textures": (lambda: lit_textures(T), "iid"),
    # the R2 first-diffuse-bounce override, and a thin lens
    "lit_textures-r2": (lambda: lit_textures(T), "r2"),
    "example2-thinlens": (lambda: _thin_lens(torch_textured.example2(32, 32)),
                          "r2"),
    # discs, cylinders, dispersion and the other projections
    "primitives": (lambda: torch_primitives.primitives(32, 32), "r2"),
    "primitives_close": (lambda: primitives_close(T), "r2"),
    "primitives_dispersive": (lambda: primitives_dispersive(T), "iid"),
    "still_life-fisheye": (lambda: still_life_projection("fisheye")(T), "r2"),
    "still_life-equirect": (lambda: still_life_projection("equirect")(T), "r2"),
    "still_life-orthographic": (
        lambda: still_life_projection("orthographic")(T), "r2"),
}


def _thin_lens(sc):
    sc.camera.aperture, sc.camera.focal_distance = 0.1, 2.5
    return sc


def _record_plain(args):
    """The record path's plain version of one chunk: records, then the
    replay."""
    seed, static, tables, cam, W, H, spp, B = args[:8]
    g, f, n = rt.record_trace_chunk_reference(*args)
    return rt.replay(g, f, static, tables, B, spp * W * H), n


@pytest.mark.cuda
@pytest.mark.parametrize("case", RECORD_CUDA_CASES)
def test_record_kernel_matches_plain_version_on_card(case):
    """The fused record kernel (trace, texel fetch, integration) against
    its plain version on the card (records, then the replay): every ray's
    L bit for bit, and rays_traced."""
    dev = _need_card()
    build, sampler = RECORD_CUDA_CASES[case]
    spp = 16
    sc = build()
    static, tables, settings = sc._settings_for_render()
    W, H = sc.camera.screen_width, sc.camera.screen_height
    tables = tables.to(dev)
    cam = cam_vec(sc.camera.params()).to(dev)
    seed = torch.tensor([11, 22, 5], dtype=torch.int32, device=dev)
    args = (seed, static, tables, cam, W, H, spp, settings.max_bounces,
            settings.split_k, sampler, settings.projection)
    before = rt.record_trace_chunk.launches
    L_k, n_k = rt.record_trace_chunk(*args)
    L_p, n_p = _record_plain(args)
    torch.cuda.synchronize()
    assert rt.record_trace_chunk.launches == before + 1
    assert int(n_k) == int(n_p)
    assert L_k.shape == (W * H * spp, 3)
    assert torch.equal(L_k, L_p)


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,spp", [(13, 7, 3), (33, 5, 1)])
def test_record_kernel_on_a_ragged_chunk_on_card(width, height, spp):
    """A chunk whose ray count is no multiple of the block: the last
    block's spare threads write nothing, and every ray matches."""
    dev = _need_card()
    sc = torch_textured.example4(width, height, blur=0.0)
    static, tables, settings = sc._settings_for_render()
    args = (torch.tensor([3, 9, 0], dtype=torch.int32, device=dev), static,
            tables.to(dev), cam_vec(sc.camera.params()).to(dev), width,
            height, spp, settings.max_bounces, settings.split_k)
    L_k, n_k = rt.record_trace_chunk(*args)
    L_p, n_p = _record_plain(args)
    torch.cuda.synchronize()
    assert (width * height * spp) % 128 != 0
    assert int(n_k) == int(n_p) and torch.equal(L_k, L_p)


@pytest.mark.cuda
def test_record_kernel_refuses_out_of_slice_scenes_on_card():
    """A dispersive scene and a fisheye camera launch the record kernel;
    a scene past the kernels' gate (49 objects) renders on the wavefront
    (ROADMAP.md item 3) without a launch."""
    dev = _need_card()
    sc = torch_textured.example2(32, 32)
    sc.scene_primitives[0].material.dispersion = True
    static, tables, settings = sc._settings_for_render()
    cam = cam_vec(sc.camera.params()).to(dev)
    seed = torch.tensor([1, 2, 0], dtype=torch.int32, device=dev)
    before = rt.record_trace_chunk.launches
    for stat, proj in ((static, "pinhole"),
                       (torch_textured.example2(32, 32)._settings_for_render()[0],
                        "fisheye")):
        L, n = rt.record_trace_chunk(seed, stat, tables.to(dev), cam, 32, 32, 8,
                                     settings.max_bounces, settings.split_k,
                                     "r2", proj)
        assert L.shape == (32 * 32 * 8, 3) and int(n) >= 32 * 32 * 8
    assert rt.record_trace_chunk.launches == before + 2
    img = too_many_objects(T).render(samples_per_pixel=1, device=dev,
                                     output="linear")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert rt.record_trace_chunk.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dispersion", "example2_solid", "primitives",
                                  "fisheye", "panorama"])
def test_example_render_on_card_matches_cpu(name):
    """The new examples through Scene.render on the card and on the CPU
    (the plain versions), same chunk seeds: images equal up to rounding,
    one kernel launch a chunk."""
    dev = _need_card()
    sc = torch_primitives.BUILDERS[name](24, 16)
    static, _, _ = sc._settings_for_render()
    fn = st.solid_trace_chunk if static.pallas_ok else rt.record_trace_chunk
    before = fn.launches
    img, stats = sc.render(samples_per_pixel=2, output="linear",
                           return_stats=True, device=dev)
    assert fn.launches > before
    ref, ref_stats = sc.render(samples_per_pixel=2, output="linear",
                               return_stats=True, device="cpu")
    assert np.isfinite(img).all()
    assert abs(stats["rays_traced"] - ref_stats["rays_traced"]) <= (
        0.001 * ref_stats["rays_traced"])
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.mark.cuda
def test_record_render_on_card_runs_the_kernel_and_matches_cpu():
    """Scene.render of a textured scene on the card launches the record
    kernel once a chunk; the CPU traces the same rays with the plain
    version, so the images agree up to rounding."""
    dev = _need_card()
    sc = torch_textured.example2(16, 12)
    _, _, settings = sc._settings_for_render()
    fan = 1 << settings.split_k
    chunk, n_chunks = plan_chunks(2 * fan, 16, 12, fan)
    before = rt.record_trace_chunk.launches
    img, stats = sc.render(samples_per_pixel=2, output="linear",
                           return_stats=True, device=dev)
    assert rt.record_trace_chunk.launches == before + n_chunks
    ref, ref_stats = sc.render(samples_per_pixel=2, output="linear",
                               return_stats=True, device="cpu")
    assert np.isfinite(img).all()
    assert abs(stats["rays_traced"] - ref_stats["rays_traced"]) <= 2
    assert abs(img.mean() - ref.mean()) <= 1e-4 * ref.mean()
