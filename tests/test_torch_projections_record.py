"""The record kernel's plain version under the fisheye, equirect and
orthographic cameras against the Pallas record kernel.

examples/torch_primitives.py's still life (an image-textured glossy floor,
two glossy balls, a directional light, the procedural sky) at 32x32 x 16
spp, one 16,384-ray interpret call per projection, cached per module,
with tests/test_torch_record.py's checks: group words and shading floats
per element, rays_traced held to the diverged lanes, the replay of the
interpreter's records against JAX's replay, and the whole chunk per ray.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_record import (check_chunk, check_count,  # noqa: E402
                               check_records, check_replay, hold_case)
from test_torch_scenes import still_life_projection  # noqa: E402

PROJECTIONS = ("fisheye", "equirect", "orthographic")


@pytest.fixture(scope="module", params=PROJECTIONS)
def case(request):
    return hold_case(still_life_projection(request.param), 16, "r2")


def test_records_match_pallas_kernel(case):
    check_records(case)


def test_rays_traced_equal(case):
    check_count(case)


def test_replay_of_jax_records_matches_jax_replay(case):
    check_replay(case)


def test_chunk_matches_pallas_record_chunk(case):
    check_chunk(case)
