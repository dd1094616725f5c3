"""The source mutants of W6 (csrc/bounce_tail.cu), each of which must
make some case of tests/test_torch_bounce_tail_emu.py fail: the same
inputs (the renders' start and update calls and the edge updates), the
mutants built with g++ against the stand-in runtime, all started
together.  A file of its own so that two test workers share the
stand-in's launches.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bounce_tail_emu import (MUTANTS, SCENES,  # noqa: E402,F401
                                        build_libs, calls, differences,
                                        one_thread)


@pytest.fixture(scope="module")
def mutant_libs(tmp_path_factory):
    """{name: library} of each mutant of MUTANTS."""
    return build_libs(tmp_path_factory, list(MUTANTS.items()))


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w6_fails(mutant_libs, calls, mutant):
    with one_thread():
        caught = [c for c in ("edge", "emitters") + SCENES
                  if differences(calls[c], mutant_libs[mutant], first=True)]
    assert caught, f"no case catches the mutant {mutant}"
