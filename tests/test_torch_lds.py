"""The port's integer draws and polynomials against the JAX package's.

The hash and lattice draws are integer math, so they must be bit-equal;
the trig polynomials are the same float32 operations in the same order,
held within 2 ulp.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core import lds as jlds
from raytracer_tpu.ops import pallas_trace as jpt
from raytracer_tpu_torch.core import lds
from raytracer_tpu_torch.ops import solid_trace as st

N = 100_000
U32 = np.random.default_rng(20260916).integers(0, 2 ** 32, size=(3, N),
                                               dtype=np.uint64).astype(np.uint32)


def t64(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def test_mix32_bit_equal():
    want = np.asarray(jlds.mix32(jnp.asarray(U32[0])))
    got = lds.mix32(t64(U32[0])).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dim", range(8))
def test_r2_bits_bit_equal(dim):
    seed = np.int32(-123456789)
    want = np.asarray(jlds.r2_bits(jnp.asarray(U32[0]), jnp.asarray(U32[1]),
                                   jnp.asarray(seed), dim))
    got = lds.r2_bits(t64(U32[0]), t64(U32[1]), int(seed), dim).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_raygen_draws_bit_equal():
    seed = np.int32(987654321)
    want = jlds.raygen_draws(jnp.asarray(U32[0]), jnp.asarray(U32[1]),
                             jnp.asarray(seed), jlds.to_float)
    got = lds.raygen_draws(t64(U32[0]), t64(U32[1]), int(seed))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _tile_rng_draws(idx, seed, n_draws):
    """The JAX `_TileRng.uniform` stream, run where it runs: inside a
    Pallas kernel, in interpret mode."""
    rows = idx.size // 128

    def kernel(idx_ref, seed_ref, out_ref):
        rng = jpt._TileRng(idx_ref[...], seed_ref[0])
        for c in range(n_draws):
            out_ref[c] = rng.uniform()

    call = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_shape=jax.ShapeDtypeStruct((n_draws, rows, 128), jnp.float32),
        interpret=pltpu.InterpretParams())
    out = call(jnp.asarray(idx.view(np.int32).reshape(rows, 128)),
               jnp.asarray([seed], jnp.int32))
    return np.asarray(out).reshape(n_draws, -1)


def test_tile_rng_uniform_bit_equal():
    idx = U32[2][: (N // 128) * 128]
    seed = -42
    want = _tile_rng_draws(idx, seed, 3)
    for c in range(3):
        got = st.hash_uniform(t64(idx), seed, c + 1).numpy()
        assert np.array_equal(got, want[c]), c


def _ulp_close(got, want, ulps=2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return np.abs(got.astype(np.float64) - want) <= tol


def test_sincos_2pi_within_2_ulp():
    u = np.random.default_rng(1).uniform(-2.0, 3.0, N).astype(np.float32)
    ws, wc = jpt._sincos_2pi(jnp.asarray(u))
    gs, gc = st.sincos_2pi(torch.from_numpy(u))
    assert _ulp_close(gs.numpy(), ws).all()
    assert _ulp_close(gc.numpy(), wc).all()


def test_atan2_and_asin_within_2_ulp():
    rng = np.random.default_rng(2)
    y, x = rng.normal(size=(2, N)).astype(np.float32) * 3.0
    want = jpt._atan2(jnp.asarray(y), jnp.asarray(x))
    assert _ulp_close(st.atan2_poly(torch.from_numpy(y), torch.from_numpy(x)),
                      want).all()
    s = rng.uniform(-1.2, 1.2, N).astype(np.float32)
    assert _ulp_close(st.asin_poly(torch.from_numpy(s)),
                      jpt._asin(jnp.asarray(s))).all()


def test_cuda_source_constants_match_lds():
    """csrc/trace_common.cuh, which both kernels include, hard-codes the
    lattice generators and salts."""
    src = (Path(st.__file__).resolve().parents[1] / "csrc"
           / "trace_common.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        return tuple(int(v.strip().rstrip("u"), 16) for v in body.split(","))

    assert table("R2_ALPHA") == lds.ALPHA == jlds.ALPHA
    assert table("R2_SALT") == lds.DIM_SALT == jlds._DIM_SALT
