"""The port's public surface against the JAX package's.

`raytracer_tpu_torch.__all__` must hold every public name of
`raytracer_tpu.__all__`; what waits for a later slice (the JAX package's
`diff` module) the port lists in NOT_YET_PORTED with its ROADMAP.md item;
and no module of the port may import jax or the JAX package.
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

WAITING = {"item 7": {"diff"}}
# the items of the list that are ported now, with their names
PORTED = {
    "item 4": {"TriangleMesh", "MeshInstances", "Surface"},
    "item 5": {"CustomMaterial", "ShadeOut", "default_shade_out"},
    "item 6": {"render_aovs", "denoise", "create_animation",
               "create_animation_using_opencv", "render_motion_blur",
               "render_ods"},
}


def test_missing_names_are_the_waiting_list():
    assert set(J.__all__) - set(T.__all__) == (set(T.NOT_YET_PORTED)
                                               & set(J.__all__)) == set()
    assert set(T.NOT_YET_PORTED) == set().union(*WAITING.values())
    assert importlib.import_module("raytracer_tpu.diff")
    assert set(T.__all__) - set(J.__all__) == {"tonemap_display"}
    assert len(T.__all__) == len(set(T.__all__))


@pytest.mark.parametrize("item", sorted(WAITING) + sorted(PORTED))
def test_waiting_names_raise_naming_their_item(item):
    if item in PORTED:
        # ported: exported, no longer waiting, the JAX package's kind
        for name in PORTED[item]:
            assert name in T.__all__ and name not in T.NOT_YET_PORTED
            assert callable(getattr(T, name)) == callable(getattr(J, name))
        return
    for name in WAITING[item]:
        assert item in T.NOT_YET_PORTED[name]
        with pytest.raises(AttributeError, match=item):
            getattr(T, name)
    with pytest.raises(AttributeError, match="no attribute 'nonsense'"):
        getattr(T, "nonsense")


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
