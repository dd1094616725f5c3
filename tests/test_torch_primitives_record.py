"""The record kernel's plain version on discs, cylinders, triangles and
dispersion against the Pallas record kernel.

`record_trace_chunk_reference` and `_record_call(..., interpret=True)` get
the same tables, camera and seed on two 16,384-ray chunks of
examples/torch_primitives.py's primitives scene (an image-textured glossy
floor, a gold annulus, a glass cylinder, a rotated open tube, a
directional and a spot light) seen from close by (tests/test_torch_scenes.py
primitives_close says why), once as it is and once with two dispersive
glasses, each drawing its own hero wavelength.  The checks are
tests/test_torch_record.py's: group words and shading floats per element,
rays_traced held to the diverged lanes, the replay of the interpreter's
records against JAX's replay, and the whole chunk per ray.  Each case is
one interpret call, cached per module.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_record import (check_chunk, check_count,  # noqa: E402
                               check_records, check_replay, hold_case)
from test_torch_scenes import (primitives_close,  # noqa: E402
                               primitives_dispersive)

CASES = {  # scene (package -> scene), spp (spp * H * W = 16,384), sampler
    "primitives_close-r2": (primitives_close, 16, "r2"),
    "primitives_dispersive-iid": (primitives_dispersive, 16, "iid"),
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
