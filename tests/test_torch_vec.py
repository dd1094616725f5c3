"""The port's host-side vec3 against the JAX package's.

Both classes are numpy value types for describing scenes, so every
method must give the same result, bit for bit and of the same type, on
the same components.
"""

import numpy as np
import pytest

from raytracer_tpu.core import vec as jvec
from raytracer_tpu_torch.core import vec as tvec

RNG = np.random.default_rng(20261017)
A = [RNG.uniform(0.1, 2.0, 6) for _ in range(3)]
B = [RNG.uniform(0.1, 2.0, 6) for _ in range(3)]
C = [complex(1.5, 0.2), 0.4 - 2.0j, 1.1]
S = [0.5, -1.25, 3.0]
M = RNG.uniform(-1.0, 1.0, (3, 3))
MASK = np.array([True, False, True, True, False, True])


def flat(r):
    """A comparable form of a result: vec3 components, arrays by dtype,
    shape and bytes, anything else by type and value."""
    if isinstance(r, (jvec.vec3, tvec.vec3)):
        return ("vec3", flat(r.x), flat(r.y), flat(r.z))
    if isinstance(r, (tuple, list)):
        return tuple(flat(x) for x in r)
    if isinstance(r, (np.ndarray, np.generic)):
        a = np.asarray(r)
        return ("arr", a.dtype.str, a.shape, a.tobytes())
    return ("val", type(r).__name__, r)


def basis(m):
    return [m.vec3(1.0, 0.0, 0.0), m.vec3(0.0, 0.6, 0.8), m.vec3(0.0, -0.8, 0.6)]


# name -> f(module, a, b, c, s): a, b array vec3s, c complex, s scalar
CASES = {
    "add": lambda m, a, b, c, s: a + b,
    "add_scalar": lambda m, a, b, c, s: a + 2.5,
    "radd": lambda m, a, b, c, s: 2.5 + a,
    "sub": lambda m, a, b, c, s: a - b,
    "sub_scalar": lambda m, a, b, c, s: a - 0.5,
    "rsub": lambda m, a, b, c, s: 1.0 - a,
    "mul": lambda m, a, b, c, s: a * b,
    "mul_scalar": lambda m, a, b, c, s: a * 3.0,
    "rmul": lambda m, a, b, c, s: 3.0 * a,
    "truediv": lambda m, a, b, c, s: a / b,
    "truediv_scalar": lambda m, a, b, c, s: a / 7.0,
    "rtruediv": lambda m, a, b, c, s: 1.0 / a,
    "neg": lambda m, a, b, c, s: -a,
    "pow": lambda m, a, b, c, s: a ** 1.7,
    "abs": lambda m, a, b, c, s: abs(-a),
    "eq": lambda m, a, b, c, s: (a == a, a == b, s == s),
    "hash": lambda m, a, b, c, s: hash(s),
    "dot": lambda m, a, b, c, s: a.dot(b),
    "cross": lambda m, a, b, c, s: a.cross(b),
    "length": lambda m, a, b, c, s: (a.length(), c.length(), s.length()),
    "square_length": lambda m, a, b, c, s: (a.square_length(), c.square_length()),
    "normalize": lambda m, a, b, c, s: (a.normalize(), s.normalize(),
                                        m.vec3(0.0, 0.0, 0.0).normalize()),
    "average": lambda m, a, b, c, s: (a.average(), s.average()),
    "matmul": lambda m, a, b, c, s: s.matmul(M),
    "conj_if_complex": lambda m, a, b, c, s: (c.conj_if_complex(),
                                              a.conj_if_complex()),
    "components": lambda m, a, b, c, s: a.components(),
    "to_array": lambda m, a, b, c, s: (a.to_array(), s.to_array(np.float32),
                                       c.to_array()),
    "real": lambda m, a, b, c, s: m.vec3.real(c),
    "imag": lambda m, a, b, c, s: m.vec3.imag(c),
    "exp": lambda m, a, b, c, s: m.vec3.exp(a),
    "sqrt": lambda m, a, b, c, s: m.vec3.sqrt(a),
    "where": lambda m, a, b, c, s: m.vec3.where(MASK, a, b),
    "clip": lambda m, a, b, c, s: a.clip(0.5, 1.5),
    "yzx": lambda m, a, b, c, s: a.yzx(),
    "xyz": lambda m, a, b, c, s: a.xyz(),
    "zxy": lambda m, a, b, c, s: a.zxy(),
    "change_basis": lambda m, a, b, c, s: a.change_basis(basis(m)),
    "getitem": lambda m, a, b, c, s: (a[1:4], a[MASK], a[2]),
    "len": lambda m, a, b, c, s: len(a),
    "shape": lambda m, a, b, c, s: (a.shape(), s.shape()),
    "broadcast_to": lambda m, a, b, c, s: s.broadcast_to((2, 3)),
    "extract_method": lambda m, a, b, c, s: (a.extract(MASK), s.extract(MASK)),
    "place": lambda m, a, b, c, s: a.extract(MASK).place(MASK),
    "repeat": lambda m, a, b, c, s: a.repeat(2),
    "reshape": lambda m, a, b, c, s: a.reshape(2, 3),
    "mean": lambda m, a, b, c, s: a.reshape(2, 3).mean(1),
    "concatenate": lambda m, a, b, c, s: m.vec3.concatenate([a, b]),
    "select": lambda m, a, b, c, s: m.vec3.select([MASK, ~MASK], [a, b]),
    "repr": lambda m, a, b, c, s: repr(s),
    "extract": lambda m, a, b, c, s: (m.extract(MASK, a.x), m.extract(MASK, 2.0)),
    "array_to_vec3": lambda m, a, b, c, s: m.array_to_vec3(np.arange(5.0)),
    "rgb": lambda m, a, b, c, s: m.rgb(0.1, 0.2, 0.3),
    "as_float3": lambda m, a, b, c, s: (m.as_float3(s), m.as_float3(2.0),
                                        m.as_float3([1, 2, 3])),
    "as_complex3": lambda m, a, b, c, s: (m.as_complex3(c), m.as_complex3(1.5),
                                          m.as_complex3(s)),
}


def _args(m):
    return (m.vec3(*A), m.vec3(*B), m.vec3(*C), m.vec3(*S))


@pytest.mark.parametrize("name", sorted(CASES))
def test_vec3_method_matches_jax(name):
    fn = CASES[name]
    with np.errstate(all="ignore"):
        got = fn(tvec, *_args(tvec))
        want = fn(jvec, *_args(jvec))
    assert flat(got) == flat(want)


def test_every_jax_method_is_ported():
    ours = {k for k in dir(tvec.vec3) if not k.startswith("__") or k in (
        "__abs__", "__eq__", "__getitem__", "__hash__", "__len__", "__pow__",
        "__rtruediv__")}
    theirs = {k for k in dir(jvec.vec3) if not k.startswith("__") or k in (
        "__abs__", "__eq__", "__getitem__", "__hash__", "__len__", "__pow__",
        "__rtruediv__")}
    assert theirs <= ours


def test_operators_reject_other_types():
    v = tvec.vec3(1.0, 2.0, 3.0)
    for op in ("__add__", "__sub__", "__rsub__", "__mul__", "__truediv__",
               "__rtruediv__", "__eq__"):
        assert getattr(v, op)("x") is NotImplemented, op
    with pytest.raises(ValueError, match="center"):
        tvec.as_float3([1.0, 2.0], "center")
