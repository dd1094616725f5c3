"""Host-side 3-vector used by the scene-description API.

Counterpart of raytracer_tpu/core/vec.py.  ``vec3`` is a small value type
for *describing* a scene (positions, colours, complex indices of
refraction); per-ray math runs on torch tensors inside the render path.
``rgb`` is an alias of ``vec3``, matching the sightpy public API.
"""

from __future__ import annotations

import numbers

import numpy as np

_SCALARS = (numbers.Number, np.ndarray, np.generic)


class vec3:
    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x = x
        self.y = y
        self.z = z

    # -- debugging ---------------------------------------------------------
    def __repr__(self):
        return f"vec3({self.x}, {self.y}, {self.z})"

    # -- arithmetic --------------------------------------------------------
    def __add__(self, v):
        if isinstance(v, vec3):
            return vec3(self.x + v.x, self.y + v.y, self.z + v.z)
        if isinstance(v, _SCALARS):
            return vec3(self.x + v, self.y + v, self.z + v)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, v):
        if isinstance(v, vec3):
            return vec3(self.x - v.x, self.y - v.y, self.z - v.z)
        if isinstance(v, _SCALARS):
            return vec3(self.x - v, self.y - v, self.z - v)
        return NotImplemented

    def __rsub__(self, v):
        if isinstance(v, _SCALARS):
            return vec3(v - self.x, v - self.y, v - self.z)
        return NotImplemented

    def __mul__(self, v):
        if isinstance(v, vec3):
            return vec3(self.x * v.x, self.y * v.y, self.z * v.z)
        if isinstance(v, _SCALARS):
            return vec3(self.x * v, self.y * v, self.z * v)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, v):
        if isinstance(v, vec3):
            return vec3(self.x / v.x, self.y / v.y, self.z / v.z)
        if isinstance(v, _SCALARS):
            return vec3(self.x / v, self.y / v, self.z / v)
        return NotImplemented

    def __rtruediv__(self, v):
        if isinstance(v, _SCALARS):
            return vec3(v / self.x, v / self.y, v / self.z)
        return NotImplemented

    def __neg__(self):
        return vec3(-self.x, -self.y, -self.z)

    def __pow__(self, a):
        return vec3(self.x ** a, self.y ** a, self.z ** a)

    def __abs__(self):
        return vec3(np.abs(self.x), np.abs(self.y), np.abs(self.z))

    def __eq__(self, other):
        if not isinstance(other, vec3):
            return NotImplemented
        return (self.x == other.x) & (self.y == other.y) & (self.z == other.z)

    def __hash__(self):
        return hash((self.x, self.y, self.z))

    # -- geometry ----------------------------------------------------------
    def dot(self, v):
        return self.x * v.x + self.y * v.y + self.z * v.z

    def cross(self, v):
        return vec3(
            self.y * v.z - self.z * v.y,
            self.z * v.x - self.x * v.z,
            self.x * v.y - self.y * v.x,
        )

    def length(self):
        return np.sqrt(np.real(self.dot(self.conj_if_complex())))

    def square_length(self):
        return self.dot(self)

    def normalize(self):
        mag = self.length()
        return self * (1.0 / np.where(mag == 0, 1, mag))

    def average(self):
        return (self.x + self.y + self.z) / 3

    def matmul(self, matrix):
        """Apply a 3x3 matrix (numpy array) to this vector."""
        a = np.asarray(matrix) @ self.to_array()
        return vec3(a[0], a[1], a[2])

    def conj_if_complex(self):
        if any(isinstance(c, complex) or np.iscomplexobj(c)
               for c in (self.x, self.y, self.z)):
            return vec3(np.conj(self.x), np.conj(self.y), np.conj(self.z))
        return self

    # -- component helpers -------------------------------------------------
    def components(self):
        return (self.x, self.y, self.z)

    def to_array(self, dtype=None):
        return np.array([self.x, self.y, self.z], dtype=dtype)

    @staticmethod
    def real(v):
        return vec3(np.real(v.x), np.real(v.y), np.real(v.z))

    @staticmethod
    def imag(v):
        return vec3(np.imag(v.x), np.imag(v.y), np.imag(v.z))

    @staticmethod
    def exp(v):
        return vec3(np.exp(v.x), np.exp(v.y), np.exp(v.z))

    @staticmethod
    def sqrt(v):
        return vec3(np.sqrt(v.x), np.sqrt(v.y), np.sqrt(v.z))

    @staticmethod
    def where(cond, a, b):
        return vec3(np.where(cond, a.x, b.x),
                    np.where(cond, a.y, b.y),
                    np.where(cond, a.z, b.z))

    def clip(self, lo, hi):
        return vec3(np.clip(self.x, lo, hi),
                    np.clip(self.y, lo, hi),
                    np.clip(self.z, lo, hi))

    # -- component shuffles / bundle ops (sightpy vector3.py parity) ---------
    def yzx(self):
        return vec3(self.y, self.z, self.x)

    def xyz(self):
        return vec3(self.x, self.y, self.z)

    def zxy(self):
        return vec3(self.z, self.x, self.y)

    def change_basis(self, new_basis):
        return vec3(self.dot(new_basis[0]), self.dot(new_basis[1]),
                    self.dot(new_basis[2]))

    def __getitem__(self, ind):
        return vec3(np.asarray(self.x)[ind], np.asarray(self.y)[ind],
                    np.asarray(self.z)[ind])

    def __len__(self):
        s = self.shape()
        return s[0] if isinstance(s, tuple) else s

    def shape(self):
        if isinstance(self.x, numbers.Number):
            return 1
        return np.asarray(self.x).shape

    def broadcast_to(self, shape):
        return vec3(np.broadcast_to(self.x, shape),
                    np.broadcast_to(self.y, shape),
                    np.broadcast_to(self.z, shape))

    def extract(self, cond):
        def ex(c):
            return c if isinstance(c, numbers.Number) else np.extract(cond, c)
        return vec3(ex(self.x), ex(self.y), ex(self.z))

    def place(self, cond):
        r = vec3(np.zeros(np.shape(cond)), np.zeros(np.shape(cond)),
                 np.zeros(np.shape(cond)))
        np.place(r.x, cond, self.x)
        np.place(r.y, cond, self.y)
        np.place(r.z, cond, self.z)
        return r

    def repeat(self, n):
        return vec3(np.repeat(self.x, n), np.repeat(self.y, n),
                    np.repeat(self.z, n))

    def reshape(self, *newshape):
        return vec3(np.reshape(self.x, newshape),
                    np.reshape(self.y, newshape),
                    np.reshape(self.z, newshape))

    def mean(self, axis):
        return vec3(np.mean(self.x, axis=axis), np.mean(self.y, axis=axis),
                    np.mean(self.z, axis=axis))

    @staticmethod
    def concatenate(vecs):
        return vec3(np.concatenate([v.x for v in vecs]),
                    np.concatenate([v.y for v in vecs]),
                    np.concatenate([v.z for v in vecs]))

    @staticmethod
    def select(mask_list, out_list):
        return vec3(np.select(mask_list, [o.x for o in out_list]),
                    np.select(mask_list, [o.y for o in out_list]),
                    np.select(mask_list, [o.z for o in out_list]))


# sightpy exposes colours through the same type (vector3.py:233-234).
rgb = vec3


def extract(cond, x):
    """Masked extraction, scalar pass-through (sightpy vector3.py:5-9)."""
    if isinstance(x, numbers.Number):
        return x
    return np.extract(cond, x)


def array_to_vec3(array):
    """First three components of `array` as a vec3 (sightpy
    vector3.py:229-230)."""
    return vec3(array[0], array[1], array[2])


def as_float3(v, name="value"):
    """Lower a vec3 / 3-sequence / scalar to a float64 numpy (3,) array."""
    if isinstance(v, vec3):
        return np.array([v.x, v.y, v.z], dtype=np.float64)
    a = np.asarray(v, dtype=np.float64)
    if a.ndim == 0:
        return np.full(3, float(a))
    if a.shape != (3,):
        raise ValueError(f"{name} must be a vec3 or length-3 sequence, got shape {a.shape}")
    return a


def as_complex3(v, name="value"):
    """Lower a (possibly complex) vec3 to a complex128 numpy (3,) array."""
    if isinstance(v, vec3):
        return np.array([v.x, v.y, v.z], dtype=np.complex128)
    a = np.asarray(v, dtype=np.complex128)
    if a.ndim == 0:
        return np.full(3, complex(a))
    if a.shape != (3,):
        raise ValueError(f"{name} must be a vec3 or length-3 sequence, got shape {a.shape}")
    return a
