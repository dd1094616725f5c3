"""The port's public surface against the JAX package's.

`raytracer_tpu_torch.__all__` must hold every public name of
`raytracer_tpu.__all__`, nothing waits in NOT_YET_PORTED any more, the
`diff` and `parallel` modules have the JAX modules' public names,
`RenderSettings` takes every JAX field with its JAX default, and no
module of the port may import jax or the JAX package.
"""

import ast
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import raytracer_tpu as J
import raytracer_tpu_torch as T

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_compile import jax_native  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent

WAITING = {}
# the items of the list that are ported now, with their names (items 7
# and 8 are modules of the package, as in the JAX package)
MODULES = {"diff": ("diff",), "parallel": ("parallel", "parallel.sharded",
                                           "parallel.multihost")}
PORTED = {
    "item 7": {"diff"},
    "item 8": {"parallel"},
    "item 4": {"TriangleMesh", "MeshInstances", "Surface"},
    "item 5": {"CustomMaterial", "ShadeOut", "default_shade_out"},
    "item 6": {"render_aovs", "denoise", "create_animation",
               "create_animation_using_opencv", "render_motion_blur",
               "render_ods"},
}


def test_missing_names_are_the_waiting_list():
    assert set(J.__all__) - set(T.__all__) == (set(T.NOT_YET_PORTED)
                                               & set(J.__all__)) == set()
    assert set(T.NOT_YET_PORTED) == set().union(set(), *WAITING.values())
    assert T.NOT_YET_PORTED == {}
    assert importlib.import_module("raytracer_tpu.diff")
    assert importlib.import_module("raytracer_tpu_torch.diff")
    assert set(T.__all__) - set(J.__all__) == {"tonemap_display"}
    assert len(T.__all__) == len(set(T.__all__))


@pytest.mark.parametrize("item", sorted(WAITING) + sorted(PORTED))
def test_waiting_names_raise_naming_their_item(item):
    if item in PORTED:
        # ported: exported, no longer waiting, the JAX package's kind
        for name in PORTED[item]:
            if name in MODULES:
                # a module of the package, as in the JAX package
                assert name not in T.NOT_YET_PORTED
                for mod in MODULES[name]:
                    assert importlib.import_module(f"raytracer_tpu_torch.{mod}")
                continue
            assert name in T.__all__ and name not in T.NOT_YET_PORTED
            assert callable(getattr(T, name)) == callable(getattr(J, name))
        return
    for name in WAITING[item]:
        assert item in T.NOT_YET_PORTED[name]
        with pytest.raises(AttributeError, match=item):
            getattr(T, name)
    with pytest.raises(AttributeError, match="no attribute 'nonsense'"):
        getattr(T, "nonsense")


def _defined(mod):
    """The public functions and classes a module defines itself."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("mod", ["diff", "parallel.sharded",
                                 "parallel.multihost", "parallel"])
def test_module_names_match_jax(mod):
    a = importlib.import_module(f"raytracer_tpu.{mod}")
    b = importlib.import_module(f"raytracer_tpu_torch.{mod}")
    if mod == "parallel":
        # the package re-exports the same three functions
        pub = lambda m: {n for n in vars(m) if not n.startswith("_")
                         and callable(getattr(m, n))}
        assert pub(a) == pub(b) == {"build_sharded_render", "make_mesh",
                                    "render_sharded"}
        return
    want = set(getattr(a, "__all__", None) or _defined(a))
    assert set(b.__all__) == want
    assert all(callable(getattr(b, n)) for n in b.__all__)


def test_render_settings_takes_every_jax_field():
    import dataclasses

    from raytracer_tpu.core.integrator import RenderSettings as JRS

    jf = {f.name: f.default for f in dataclasses.fields(JRS)}
    tf = {f.name: f.default for f in dataclasses.fields(T.RenderSettings)}
    assert jf == tf
    assert T.RenderSettings(**jf) == T.RenderSettings()
    assert T.RenderSettings(unroll=2).unroll == 2


def test_wavefront_names_are_exported():
    # ROADMAP.md item 3 brought these; none of them waits any more
    for name in ("Ray", "Hit", "get_raycolor", "get_distances", "first_hit"):
        assert name in T.__all__ and name not in T.NOT_YET_PORTED
        assert callable(getattr(T, name))


def test_star_import_gives_every_public_name():
    ns = {}
    exec("from raytracer_tpu_torch import *", ns)
    assert set(T.__all__) <= set(ns)
    # the same kind of object under each name as in the JAX package
    for name in set(T.__all__) & set(J.__all__):
        a, b = getattr(T, name), getattr(J, name)
        assert callable(a) == callable(b), name
        assert isinstance(a, type) == isinstance(b, type), name


def test_camelcase_aliases_and_colour_functions():
    assert T.sRGB_linear_to_sRGB is T.srgb_linear_to_srgb
    assert T.sRGB_to_sRGB_linear is T.srgb_to_srgb_linear
    assert T.load_image_as_linear_sRGB is T.load_image_as_linear_srgb
    x = np.random.default_rng(1).uniform(0, 1, (8, 3))
    assert np.array_equal(T.sRGB_to_sRGB_linear(x), J.sRGB_to_sRGB_linear(x))


def test_blur_functions_are_exported_and_match_jax():
    img = T.procedural_sky(64, 48)
    got = T.blur_skybox_array(img, 2.0)
    assert np.array_equal(got, J.blur_skybox_array(img, 2.0))
    assert got.shape == img.shape


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    [*(REPO / "raytracer_tpu_torch").rglob("*.py"),
                     REPO / "chip_smoke.py",
                     *(REPO / "examples").glob("torch_*.py"),
                     *(REPO / "scripts").glob("torch_*.py")])


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax(rel):
    for mod in _imports(REPO / rel):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "raytracer_tpu"), (rel, mod)
