"""One rank of a two-process render through the port
(tests/test_torch_multihost.py, chip_smoke.py): joins a gloo group at
127.0.0.1:<port>, renders the scene of tests/multihost_runner.py over a
global 4x2 mesh (four shards a process) at 8 spp with
raytracer_tpu_torch.parallel.multihost.render_multihost on <device>, once
for each seed of <seeds> (default 0), and writes the frames, stacked in
that order, to <out>.rank<k>.npy.

    python tests/torch_multihost_runner.py <rank> <nproc> <port> <out> \
        [device] [seeds, e.g. 0,1,2]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from raytracer_tpu_torch.parallel.multihost import (  # noqa: E402
    init_distributed, render_multihost)
from raytracer_tpu_torch.parallel.sharded import make_mesh  # noqa: E402


def scene(m):
    """The two-process scene (tests/multihost_runner.py)."""
    sc = m.Scene(ambient_color=m.rgb(0, 0, 0))
    sc.add_Camera(look_from=m.vec3(0, 0, 5), look_at=m.vec3(0, 0, 0),
                  screen_width=16, screen_height=16, field_of_view=30)
    sc.add(m.Sphere(material=m.Diffuse(diff_color=m.rgb(0.6, 0.6, 0.6),
                                       diffuse_rays=1),
                    center=m.vec3(0, 0, 0), radius=1.0))
    sc.add(m.Plane(material=m.Emissive(color=m.rgb(1.0, 0.8, 0.6)),
                   center=m.vec3(0, 0, -4), width=60.0, height=60.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    return sc


def mesh(device):
    return make_mesh(4, 2, [torch.device(device)] * 8)


if __name__ == "__main__":
    import raytracer_tpu_torch as T

    rank, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    seeds = [int(x) for x in (sys.argv[6] if len(sys.argv) > 6
                              else "0").split(",")]
    backend = init_distributed(f"127.0.0.1:{port}", nproc, rank,
                               backend="gloo")
    imgs = [render_multihost(scene(T), samples_per_pixel=8, seed=s,
                             mesh=mesh(device), device=device) for s in seeds]
    np.save(f"{out}.rank{rank}.npy", np.stack(imgs))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {rank} done ({backend})", flush=True)
