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

    def __repr__(self):
        return f"vec3({self.x}, {self.y}, {self.z})"

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

    def __neg__(self):
        return vec3(-self.x, -self.y, -self.z)

    def dot(self, v):
        return self.x * v.x + self.y * v.y + self.z * v.z

    def cross(self, v):
        return vec3(
            self.y * v.z - self.z * v.y,
            self.z * v.x - self.x * v.z,
            self.x * v.y - self.y * v.x,
        )

    def length(self):
        return np.sqrt(np.real(self.dot(vec3(np.conj(self.x), np.conj(self.y),
                                             np.conj(self.z)))))

    def normalize(self):
        mag = self.length()
        return self * (1.0 / np.where(mag == 0, 1, mag))


# sightpy exposes colours through the same type (vector3.py:233-234).
rgb = vec3


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
