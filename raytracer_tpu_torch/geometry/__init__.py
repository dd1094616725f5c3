from .primitive import (Cuboid, MeshInstances, Plane, Primitive, Sphere,
                        Triangle, TriangleMesh, rotation_matrix)
