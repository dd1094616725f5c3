"""Host-side scene-description primitives.

Counterpart of raytracer_tpu/geometry/primitive.py for the kernels'
primitives: Sphere, Plane, Cuboid, Disc, Cylinder and Triangle (with
`rotate`).  TriangleMesh and MeshInstances come with the meshes' slice
(ROADMAP.md "Modules to port" item 4).  Rotation is the same axis-angle
Rodrigues matrix, applied eagerly to the stored parameters, so compiled
tables match bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..core.vec import as_float3


def rotation_matrix(theta_deg, axis):
    """Axis-angle rotation matrix (sightpy primitive.py:17-42)."""
    u = as_float3(axis, "axis")
    u = u / np.linalg.norm(u)
    th = np.deg2rad(theta_deg)
    c = np.cos(th)
    s = np.sqrt(1 - c ** 2) * np.sign(th)
    x, y, z = u
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])


def stable_unit(v):
    """Normalize to a fixed point of normalization (as the JAX package)."""
    v = np.asarray(v, np.float64)
    for _ in range(4):
        n = np.linalg.norm(v)
        if n == 1.0:
            return v
        v = v / n
    return v


class Primitive:
    """Geometry description + material + per-object limits: the recursion
    cap `max_ray_depth`, the `shadow` flag and the `mc` flag
    (sightpy geometry/primitive.py:6-44)."""

    def __init__(self, center, material, max_ray_depth=5, shadow=True, mc=False):
        self.center = as_float3(center, "center")
        self.material = material
        if material is not None:
            material.assigned_primitive = self
        self.max_ray_depth = int(max_ray_depth)
        self.shadow = bool(shadow)
        self.mc = bool(mc)
        # bounding-sphere radius, read by importance sampling
        self.bounded_sphere_radius = 0.0

    def rotate(self, θ=None, u=None, theta=None, axis=None):
        """Rotate the primitive about its center (axis-angle, degrees)."""
        theta = θ if θ is not None else theta
        axis = u if u is not None else axis
        self._apply_rotation(rotation_matrix(theta, axis))
        # for scene export (scene_io): replaying the list rebuilds the
        # rotated parameters with the same float operations
        self._rotations = getattr(self, "_rotations", []) + [
            (float(theta), [float(c) for c in as_float3(axis, "axis")])]
        return self

    def _apply_rotation(self, M):
        raise NotImplementedError(
            f"{type(self).__name__} does not support rotation")


class Sphere(Primitive):
    def __init__(self, center, material, radius, max_ray_depth=5, shadow=True, mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.radius = float(radius)
        self.bounded_sphere_radius = self.radius

    def _apply_rotation(self, M):
        pass  # rotation-invariant about its own center


class Plane(Primitive):
    """Finite rectangle (sightpy plane.py:7-35)."""

    def __init__(self, center, material, width, height, u_axis, v_axis,
                 max_ray_depth=5, shadow=True, uv_shift=(0.0, 0.0), mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.width = float(width)
        self.height = float(height)
        self.u_axis = as_float3(u_axis, "u_axis")
        self.v_axis = as_float3(v_axis, "v_axis")
        self.uv_shift = (float(uv_shift[0]), float(uv_shift[1]))
        self.bounded_sphere_radius = np.sqrt((width / 2) ** 2 + (height / 2) ** 2)

    @property
    def normal(self):
        n = np.cross(self.u_axis, self.v_axis)
        return n / np.linalg.norm(n)

    def _apply_rotation(self, M):
        self.u_axis = M @ self.u_axis
        self.v_axis = M @ self.v_axis


class Cuboid(Primitive):
    """Oriented box with a rotatable local basis (sightpy cuboid.py:7-32)."""

    def __init__(self, center, material, width, height, length,
                 max_ray_depth=5, shadow=True, mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.width = float(width)
        self.height = float(height)
        self.length = float(length)
        self.bounded_sphere_radius = np.sqrt(
            (width / 2) ** 2 + (height / 2) ** 2 + (length / 2) ** 2)
        half = np.array([width / 2, height / 2, length / 2])
        self.lb = self.center - half
        self.rt = self.center + half
        # rows of `basis` are the box axes (world -> local transform)
        self.basis = np.eye(3)

    def _apply_rotation(self, M):
        self.basis = self.basis @ M.T
        self.lb = self.center + M @ (self.lb - self.center)
        self.rt = self.center + M @ (self.rt - self.center)

    @property
    def lb_local(self):
        return self.basis @ self.lb

    @property
    def rt_local(self):
        return self.basis @ self.rt


def _orthonormal_frame(normal, u_hint=None):
    """(u, v) orthonormal in the plane perpendicular to `normal`; u is
    `u_hint` projected into the plane when given, else a fixed default
    axis (as the JAX package)."""
    n = stable_unit(normal)
    if u_hint is not None:
        u = np.asarray(as_float3(u_hint, "u_axis"), np.float64)
        if np.linalg.norm(u - n * np.dot(u, n)) < 1e-9:
            raise ValueError("u_axis is parallel to the normal")
        # project + normalize to a fixed point
        for _ in range(4):
            u2 = stable_unit(u - n * np.dot(u, n))
            if np.array_equal(u2, u):
                break
            u = u2
    else:
        ref = np.array([0.0, 1.0, 0.0]) if abs(n[1]) < 0.9 \
            else np.array([1.0, 0.0, 0.0])
        u = stable_unit(np.cross(ref, n))
    v = np.cross(n, u)
    return u, v


class Disc(Primitive):
    """Flat disc, or an annulus when `inner_radius > 0`; `normal` faces the
    front side, `u_axis` orients the planar uv."""

    def __init__(self, center, material, radius, normal=(0.0, 1.0, 0.0),
                 inner_radius=0.0, u_axis=None, max_ray_depth=5,
                 shadow=True, mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.radius = float(radius)
        self.inner_radius = float(inner_radius)
        if not 0.0 <= self.inner_radius < self.radius:
            raise ValueError(
                f"inner_radius must be in [0, radius), got "
                f"{self.inner_radius} vs radius {self.radius}")
        self.normal = stable_unit(as_float3(normal, "normal"))
        self.u_axis, self.v_axis = _orthonormal_frame(self.normal, u_axis)
        self.bounded_sphere_radius = self.radius

    def _apply_rotation(self, M):
        self.normal = M @ self.normal
        self.u_axis = M @ self.u_axis
        self.v_axis = M @ self.v_axis


class Cylinder(Primitive):
    """Finite cylinder: `center` is the mid-height point, `axis` the length
    direction, `height` the full length; `capped=False` is an open tube."""

    def __init__(self, center, material, radius, height,
                 axis=(0.0, 1.0, 0.0), capped=True, u_axis=None,
                 max_ray_depth=5, shadow=True, mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.radius = float(radius)
        self.height = float(height)
        if self.radius <= 0 or self.height <= 0:
            raise ValueError("radius and height must be positive")
        self.axis = stable_unit(as_float3(axis, "axis"))
        self.u_axis, self.v_axis = _orthonormal_frame(self.axis, u_axis)
        self.capped = bool(capped)
        self.bounded_sphere_radius = float(
            np.sqrt(self.radius ** 2 + (self.height / 2) ** 2))

    def _apply_rotation(self, M):
        self.axis = M @ self.axis
        self.u_axis = M @ self.u_axis
        self.v_axis = M @ self.v_axis


class Triangle(Primitive):
    """Single triangle (sightpy triangle.py:8-17)."""

    def __init__(self, center, material, p1, p2, p3, max_ray_depth=5,
                 shadow=True, mc=False):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        self.p1 = as_float3(p1, "p1")
        self.p2 = as_float3(p2, "p2")
        self.p3 = as_float3(p3, "p3")
        e = np.stack([self.p1, self.p2, self.p3]) - self.center
        self.bounded_sphere_radius = float(np.max(np.linalg.norm(e, axis=1)))

    def _apply_rotation(self, M):
        self.p1 = self.center + M @ (self.p1 - self.center)
        self.p2 = self.center + M @ (self.p2 - self.center)
        self.p3 = self.center + M @ (self.p3 - self.center)
