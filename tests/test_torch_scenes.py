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

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as T
from raytracer_tpu_torch.core.camera import cam_vec
from raytracer_tpu_torch.core.scene import chunk_seeds, plan_chunks
from raytracer_tpu_torch.ops import solid_trace as st

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))


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


def too_many_objects(m):
    """49 objects: past the gate's object cap in both packages."""
    sc = m.Scene()
    sc.add_Camera(look_from=m.vec3(0, 0, 5), look_at=m.vec3(0, 0, 0),
                  screen_width=8, screen_height=8)
    mat = m.Emissive(color=m.rgb(1, 1, 1))
    for i in range(49):
        sc.add(m.Sphere(material=mat, center=m.vec3(i * 0.1, 0, 0), radius=0.05))
    return sc



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
    """The kernel build, with a stand-in for nvcc: the library lands under
    a hash of the sources, the flags and nvcc's version, is reused, and a
    failed build leaves no file behind."""
    fake = tmp_path / "nvcc"

    def stand_in(version, compiles):
        body = ('while [ $# -gt 0 ]; do [ "$1" = -o ] && echo lib > "$2"; '
                'shift; done\necho "ptxas info: ok"\n' if compiles else "exit 3\n")
        fake.write_text(f'#!/bin/sh\n[ "$1" = --version ] && echo "{version}" '
                        f'&& exit 0\n{body}')
        fake.chmod(0o755)

    stand_in("release 1.0", compiles=True)
    monkeypatch.setattr(st, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(st, "_nvcc", lambda: str(fake))
    out = st.build()
    assert out.parent == tmp_path / "build" and out.read_text() == "lib\n"
    assert "ptxas info" in st.build_log
    stand_in("release 1.0", compiles=False)
    assert st.build() == out                      # reused, nvcc not run
    for flags, version in ((st.NVCC_FLAGS + ("-DOTHER",), "release 1.0"),
                           (st.NVCC_FLAGS, "release 2.0")):
        with monkeypatch.context() as m:
            m.setattr(st, "NVCC_FLAGS", flags)
            stand_in(version, compiles=False)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                st.build()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [out.name]


CUDA_CASES = [(cornell, 16, "r2"), (glass, 64, "r2"), (is_diffuse, 64, "iid"),
              (lights_and_slots, 32, "r2")]


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
    args = (seed, tables, cam, W, H, spp, settings.max_bounces, 0, sampler)
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
