"""The three mesh examples through the PyTorch / CUDA port: a smooth
icosphere, a textured UV sphere and a field of mesh instances.

- `icosphere(...)`: examples/example_mesh.py, a 5,120-face icosphere
  (area-weighted vertex normals, smooth=True) over a glossy floor; 5,120
  triangles are past TRI_CLUSTER_THRESHOLD, so the wavefront sweeps them
  in SAH clusters;
- `beach_ball(...)`: examples/example_mesh_textured.py, a 1,224-face
  UV sphere whose OBJ carries vt and vn records, with a bilinear stripe
  texture fetched through the interpolated uvs;
- `instances(...)`: examples/example_instances.py, 48 instances of a
  1,280-face icosphere (61,440 virtual triangles) with four materials.

Each scene function takes the package to build with (`m=`, default: the port),
so the tests build the same scene with the JAX package, and writes its
OBJ file into `obj_dir` (default: a fresh temporary directory).  The OBJ
writers are copies of the JAX examples' own, so no asset is needed.

    python examples/torch_mesh.py icosphere    # icosphere_torch.png, 16 spp

Pillow is needed only to write the image file.
"""
import importlib
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def write_icosphere_obj(path, subdiv=4):
    """Unit icosphere as a v/f OBJ (examples/example_mesh.py:25)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [tuple(v) for v in verts]
    index = {v: i for i, v in enumerate(verts)}

    def mid(a, b):
        m = tuple(np.asarray(verts[a], np.float64) / 2
                  + np.asarray(verts[b], np.float64) / 2)
        m = tuple(np.asarray(m) / np.linalg.norm(m))
        if m not in index:
            index[m] = len(verts)
            verts.append(m)
        return index[m]

    for _ in range(subdiv):
        nxt = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
    return len(faces)


def write_uv_sphere_obj(path, n_theta=18, n_phi=36):
    """Lat-long unit sphere with vt / vn records
    (examples/example_mesh_textured.py:27); the seam column is written
    twice (u = 0 and u = 1) so uvs never interpolate across the wrap."""
    lines = []
    for i in range(n_theta + 1):
        th = np.pi * i / n_theta
        for j in range(n_phi + 1):
            ph = 2 * np.pi * (j % n_phi) / n_phi
            x, y, z = (np.sin(th) * np.cos(ph), np.cos(th),
                       np.sin(th) * np.sin(ph))
            lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")
            lines.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
            lines.append(f"vt {j / n_phi:.6f} {1 - i / n_theta:.6f}")

    def c(i, j):
        v = i * (n_phi + 1) + j + 1
        return f"{v}/{v}/{v}"

    faces = 0
    for i in range(n_theta):
        for j in range(n_phi):
            a, b2 = c(i, j), c(i, j + 1)
            d, e = c(i + 1, j + 1), c(i + 1, j)
            if i == 0:
                lines.append(f"f {a} {d} {e}")
                faces += 1
            elif i == n_theta - 1:
                lines.append(f"f {a} {b2} {d}")
                faces += 1
            else:
                lines.append(f"f {a} {b2} {d} {e}")
                faces += 2
    Path(path).write_text("\n".join(lines))
    return faces


def beach_ball_texture(w=512, h=256, stripes=6):
    """Linear-space stripe texture with polar caps
    (examples/example_mesh_textured.py:69)."""
    u = np.linspace(0, 1, w, endpoint=False)[None, :]
    v = np.linspace(0, 1, h, endpoint=False)[:, None]
    palette = np.array([[0.85, 0.12, 0.10], [0.92, 0.88, 0.80],
                        [0.10, 0.35, 0.75], [0.92, 0.88, 0.80],
                        [0.95, 0.65, 0.10], [0.92, 0.88, 0.80]])
    seg = (u * stripes).astype(int) % len(palette)
    tex = palette[seg].repeat(h, axis=0).reshape(h, w, 3)
    cap = (v < 0.08) | (v > 0.92)
    tex[np.broadcast_to(cap, (h, w))] = [0.92, 0.88, 0.80]
    return tex.astype(np.float32)


def _package(m):
    return m if m is not None else importlib.import_module("raytracer_tpu_torch")


def _obj(obj_dir, name):
    return str(Path(obj_dir or tempfile.mkdtemp()) / name)


def _floor(m, spec_coeff=0.2, color=(0.3, 0.3, 0.35), diff_coeff=0.8):
    return m.Glossy(diff_color=m.rgb(*color),
                    n=m.vec3(1.1 + 0.2j, 1.1 + 0.2j, 1.1 + 0.2j),
                    roughness=0.0, spec_coeff=spec_coeff, diff_coeff=diff_coeff)


def icosphere(width=400, height=300, subdiv=4, smooth=True, m=None,
              obj_dir=None):
    """examples/example_mesh.py: a copper icosphere (20 * 4**subdiv faces)
    over a glossy floor under an emissive sky sphere."""
    m = _package(m)
    path = _obj(obj_dir, f"icosphere{subdiv}.obj")
    write_icosphere_obj(path, subdiv=subdiv)
    copper = m.Glossy(diff_color=m.rgb(0.7, 0.4, 0.2),
                      n=m.vec3(1.2 + 0.3j, 1.2 + 0.3j, 1.1 + 0.3j),
                      roughness=0.3, spec_coeff=0.4, diff_coeff=0.8)
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 0.6, 4.6), look_at=m.vec3(0, -0.1, 0),
                  screen_width=width, screen_height=height, field_of_view=32)
    sc.add_DirectionalLight(Ldir=m.vec3(0.5, 0.8, 0.3), color=m.rgb(0.6, 0.6, 0.6))
    mesh = m.TriangleMesh(path, center=m.vec3(0, 0, 0), material=copper,
                          max_ray_depth=2, smooth=smooth)
    mesh.rotate(θ=20, u=m.vec3(0, 1, 0))
    sc.add(mesh)
    sc.add(m.Plane(material=_floor(m), center=m.vec3(0, -1.2, 0), width=40.0,
                   height=40.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   max_ray_depth=2))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.7, 0.8, 0.95)),
                    center=m.vec3(0, 0, 0), radius=60.0, shadow=False))
    return sc


def beach_ball(width=400, height=300, n_theta=18, n_phi=36, m=None,
               obj_dir=None):
    """examples/example_mesh_textured.py: a textured, smooth-shaded UV
    sphere ((n_theta - 1) * n_phi * 2 faces; 1,224 at the defaults)."""
    m = _package(m)
    path = _obj(obj_dir, f"beachball{n_theta}x{n_phi}.obj")
    write_uv_sphere_obj(path, n_theta, n_phi)
    ball = m.Glossy(diff_color=m.image(beach_ball_texture(), filter="bilinear"),
                    n=m.vec3(1.3 + 0j, 1.3 + 0j, 1.3 + 0j),
                    roughness=0.15, spec_coeff=0.25, diff_coeff=0.9)
    sc = m.Scene(ambient_color=m.rgb(0.06, 0.06, 0.07))
    sc.add_Camera(look_from=m.vec3(0, 0.8, 4.5), look_at=m.vec3(0, -0.05, 0),
                  screen_width=width, screen_height=height, field_of_view=35)
    sc.add_DirectionalLight(Ldir=m.vec3(0.6, 0.9, 0.4),
                            color=m.rgb(0.8, 0.8, 0.78))
    mesh = m.TriangleMesh(path, center=m.vec3(0, 0, 0), material=ball,
                          max_ray_depth=2)    # smooth=None: the file's vn
    mesh.rotate(θ=25, u=m.vec3(0, 1, 0))
    sc.add(mesh)
    sc.add(m.Plane(material=_floor(m, 0.15, (0.35, 0.32, 0.28), 0.9),
                   center=m.vec3(0, -1.0, 0), width=40.0, height=40.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   max_ray_depth=2))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.75, 0.82, 0.95)),
                    center=m.vec3(0, 0, 0), radius=60.0, shadow=False))
    return sc


def instances(width=400, height=300, count=48, subdiv=3, baked=False, m=None,
              obj_dir=None):
    """examples/example_instances.py: `count` instances of an icosphere
    (20 * 4**subdiv faces) with four glossy materials on a glossy floor.
    baked=True builds the same field from TriangleMesh copies whose
    vertices and corner normals are transformed on the host, the
    instancing's plain version."""
    m = _package(m)
    path = _obj(obj_dir, f"icosphere{subdiv}.obj")
    write_icosphere_obj(path, subdiv=subdiv)
    palette = [
        m.Glossy(diff_color=m.rgb(0.75, 0.35, 0.20),
                 n=m.vec3(1.2 + 0.3j, 1.2 + 0.3j, 1.1 + 0.3j),
                 roughness=0.25, spec_coeff=0.4, diff_coeff=0.8),
        m.Glossy(diff_color=m.rgb(0.25, 0.45, 0.75),
                 n=m.vec3(1.3 + 0.1j, 1.3 + 0.1j, 1.3 + 0.1j),
                 roughness=0.15, spec_coeff=0.35, diff_coeff=0.85),
        m.Glossy(diff_color=m.rgb(0.30, 0.65, 0.35),
                 n=m.vec3(1.25 + 0.2j, 1.25 + 0.2j, 1.25 + 0.2j),
                 roughness=0.35, spec_coeff=0.3, diff_coeff=0.85),
        m.Glossy(diff_color=m.rgb(0.8, 0.75, 0.45),
                 n=m.vec3(1.4 + 0.4j, 1.35 + 0.4j, 1.2 + 0.4j),
                 roughness=0.1, spec_coeff=0.5, diff_coeff=0.7),
    ]
    sc = m.Scene(ambient_color=m.rgb(0.05, 0.05, 0.05))
    sc.add_Camera(look_from=m.vec3(0, 2.2, 9.0), look_at=m.vec3(0, -0.2, 0),
                  screen_width=width, screen_height=height, field_of_view=36)
    sc.add_DirectionalLight(Ldir=m.vec3(0.5, 0.8, 0.3), color=m.rgb(0.6, 0.6, 0.6))
    mesh = m.TriangleMesh(path, center=m.vec3(0, 0, 0), material=palette[0],
                          max_ray_depth=2, smooth=True)
    field = m.MeshInstances(mesh)
    rng = np.random.default_rng(7)
    for i in range(count):
        gx, gz = i % 8, i // 8
        x = (gx - 3.5) * 1.7 + rng.uniform(-0.35, 0.35)
        z = (gz - 2.5) * 1.7 + rng.uniform(-0.35, 0.35)
        s = rng.uniform(0.35, 0.85)
        field.add(translate=(x, -1.2 + s, z),
                  theta=float(rng.uniform(0, 360)), axis=(0, 1, 0), scale=s,
                  material=palette[i % len(palette)])
    if baked:
        for R, t, s, mat in field.instances:
            copy = m.TriangleMesh(path, center=m.vec3(0, 0, 0),
                                  material=mat or field.material,
                                  max_ray_depth=2, smooth=True)
            copy.vertices = (s * copy.vertices) @ R.T + t
            copy.corner_normals = copy.corner_normals @ R.T
            sc.add(copy)
    else:
        sc.add(field)
    sc.add(m.Plane(material=_floor(m), center=m.vec3(0, -1.2, 0), width=60.0,
                   height=60.0, u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 0, -1),
                   max_ray_depth=2))
    sc.add(m.Sphere(material=m.Emissive(color=m.rgb(0.7, 0.8, 0.95)),
                    center=m.vec3(0, 0, 0), radius=80.0, shadow=False))
    return sc


SCENES = {"icosphere": icosphere, "beach_ball": beach_ball,
          "instances": instances}


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "icosphere"
    img = SCENES[name]().render(samples_per_pixel=16, progress_bar=True)
    img.save(f"{name}_torch.png")
