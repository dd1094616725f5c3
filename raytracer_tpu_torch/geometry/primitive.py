"""Host-side scene-description primitives.

Counterpart of raytracer_tpu/geometry/primitive.py for the kernels'
primitives: Sphere, Plane, Cuboid, Disc, Cylinder, Triangle, TriangleMesh
(an OBJ file's faces, with optional vertex normals and texture
coordinates) and MeshInstances (rigid, uniformly scaled copies of one
mesh), with `rotate`.  Rotation is the same axis-angle Rodrigues matrix,
applied eagerly to the stored parameters, so compiled tables match bit
for bit.
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


class TriangleMesh(Primitive):
    """Triangle mesh from a Wavefront .obj (v / vt / vn / f records;
    primitive.py:262).  The faces are parsed by the port's native library
    (native.py); vt records give corner uvs that drive the material's
    textures, vn records corner normals for smooth shading, interpolated
    at the hit.

    smooth: None (default) honours the file's vn records when present
    (flat otherwise); True forces smooth shading (area-weighted vertex
    normals when the file has none); False forces flat shading.
    """

    def __init__(self, filename, center, material, scale=1.0,
                 max_ray_depth=5, shadow=True, mc=False, smooth=None):
        super().__init__(center, material, max_ray_depth, shadow=shadow, mc=mc)
        from ..native import parse_obj_full
        verts, uvs, norms, faces, face_uv, face_n = parse_obj_full(filename)
        # for scene_io's export
        self.filename = str(filename)
        self.scale = float(scale)
        self.smooth_arg = smooth
        self.vertices = self.center + np.asarray(verts, dtype=np.float64) * scale
        self.faces = np.asarray(faces, dtype=np.int64)
        d = np.linalg.norm(self.vertices - self.center, axis=1)
        self.bounded_sphere_radius = float(d.max()) if len(d) else 0.0

        # (F, 3, 2) corner uvs wherever the file has vt records (a corner
        # without a vt index reads (0, 0))
        self.corner_uvs = None
        if len(uvs) and (face_uv >= 0).any():
            cu = np.asarray(uvs, np.float64)[np.clip(face_uv, 0, len(uvs) - 1)]
            cu[face_uv < 0] = 0.0
            self.corner_uvs = cu

        # (F, 3, 3) unit corner normals for smooth shading
        self.corner_normals = None
        has_vn = len(norms) and (face_n >= 0).any()
        if has_vn if smooth is None else smooth:
            if has_vn:
                cn = np.asarray(norms, np.float64)[
                    np.clip(face_n, 0, len(norms) - 1)]
                if (face_n < 0).any():    # mixed files: fill the corners
                    vn = _vertex_normals(self.vertices, self.faces)
                    cn[face_n < 0] = vn[self.faces[face_n < 0]]
            else:
                vn = _vertex_normals(self.vertices, self.faces)
                cn = vn[self.faces]
            n = np.linalg.norm(cn, axis=-1, keepdims=True)
            self.corner_normals = cn / np.maximum(n, 1e-20)

    def _apply_rotation(self, M):
        self.vertices = self.center + (self.vertices - self.center) @ M.T
        if self.corner_normals is not None:
            self.corner_normals = self.corner_normals @ M.T

    @property
    def triangles(self):
        """(F, 3, 3) array of triangle vertices."""
        return self.vertices[self.faces]


class MeshInstances(Primitive):
    """Rigid, uniformly scaled copies of one TriangleMesh that share its
    tables (primitive.py:311).

    The compiler lays the mesh's triangles out once, in object space;
    each instance is a rotation, a translation and a scale, and the
    clustered sweep pulls the rays into an instance's space to test its
    clusters, so N instances of a T-face mesh cost O(T) table memory.

        forest = MeshInstances(tree_mesh)
        forest.add(translate=(x, 0, z), theta=40, axis=(0, 1, 0), scale=1.2)
        scene.add(forest)

    An instance may carry its own material (default: the group's).  The
    rotation is about the mesh's centre and comes before the translation.
    Scenes with instances render on the wavefront.
    """

    def __init__(self, mesh, material=None, max_ray_depth=None, shadow=None,
                 mc=None):
        super().__init__(
            mesh.center,
            material if material is not None else mesh.material,
            mesh.max_ray_depth if max_ray_depth is None else max_ray_depth,
            shadow=mesh.shadow if shadow is None else shadow,
            mc=mesh.mc if mc is None else mc)
        if not isinstance(mesh, TriangleMesh):
            raise TypeError("MeshInstances wraps a TriangleMesh")
        self.mesh = mesh
        # (R (3, 3), t (3,), s, material or None): world = R @ (s v) + t
        self.instances = []

    def add(self, translate=(0.0, 0.0, 0.0), theta=0.0, axis=(0.0, 1.0, 0.0),
            scale=1.0, material=None, rotation=None):
        """Append one instance and return self.  rotation: an optional
        (3, 3) matrix in place of theta / axis; scale must be positive
        (uniform only: the shared tables cannot bend normals)."""
        s = float(scale)
        if s <= 0.0:
            raise ValueError("instance scale must be > 0")
        if rotation is not None:
            R = np.asarray(rotation, dtype=np.float64)
            if R.shape != (3, 3):
                raise ValueError("rotation must be a (3, 3) matrix")
        elif theta:
            R = rotation_matrix(theta, axis)
        else:
            R = np.eye(3)
        c = np.asarray(self.mesh.center, np.float64)
        # world = R @ ((v - c) * s) + c + translate == R @ (s v) + t
        t = c + as_float3(translate, "translate") - s * (R @ c)
        self.instances.append((R, t, s, material))
        self._update_bounds()
        return self

    def _update_bounds(self):
        # a bounding sphere over the instances, for importance sampling
        c = np.asarray(self.mesh.center, np.float64)
        r = float(self.mesh.bounded_sphere_radius)
        centers = np.stack([R @ (s * c) + t for R, t, s, _ in self.instances])
        mid = centers.mean(axis=0)
        reach = np.linalg.norm(centers - mid, axis=1) + r * np.asarray(
            [s for _, _, s, _ in self.instances])
        self.center = mid
        self.bounded_sphere_radius = float(reach.max())


# sightpy's `Surface` is an unused near-copy of Primitive
# (sightpy/geometry/surface.py:6-42), kept as an alias for its API
Surface = Primitive


def _vertex_normals(verts, faces):
    """Area-weighted vertex normals: the unnormalised face normals summed
    at shared vertices (primitive.py:425)."""
    v = np.asarray(verts, np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]],
                  v[faces[:, 2]] - v[faces[:, 0]])
    vn = np.zeros_like(v)
    for j in range(3):
        np.add.at(vn, faces[:, j], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-20)


def _parse_obj_full(filename):
    """The OBJ parser's plain Python version (primitive.py:438), which the
    tests hold the native parser against: the same arrays as
    native.parse_obj_full."""
    verts, uvs, norms = [], [], []
    faces, face_uv, face_n = [], [], []

    def corner(tok):
        fields = tok.split("/")
        v = int(fields[0])
        v = v - 1 if v > 0 else len(verts) + v
        t = n = -1
        if len(fields) > 1 and fields[1]:
            t = int(fields[1])
            t = t - 1 if t > 0 else len(uvs) + t
        if len(fields) > 2 and fields[2]:
            n = int(fields[2])
            n = n - 1 if n > 0 else len(norms) + n
        return v, t, n

    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "vn":
                norms.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                cs = [corner(p) for p in parts[1:]]
                for k in range(1, len(cs) - 1):   # fan-split
                    tri = (cs[0], cs[k], cs[k + 1])
                    faces.append([c[0] for c in tri])
                    face_uv.append([c[1] for c in tri])
                    face_n.append([c[2] for c in tri])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(uvs, np.float32).reshape(-1, 2),
            np.asarray(norms, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3),
            np.asarray(face_uv, np.int64).reshape(-1, 3),
            np.asarray(face_n, np.int64).reshape(-1, 3))
