"""Cornell box with MC path tracing + importance sampling, through the
PyTorch / CUDA port (the scene of example_cornellbox.py, line for line),
and the box under the fisheye, equirect and orthographic cameras.

    python examples/torch_cornellbox.py    # writes cornell_box_torch.png
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import raytracer_tpu_torch  # noqa: E402
from raytracer_tpu_torch import (Cuboid, Diffuse, Emissive, Plane, Refractive,
                                 Scene, Sphere, rgb, vec3)


# the box under the other projections, each camera looking at the back
# wall: a 160-degree fisheye from the pinhole's place, a 360x180 panorama
# from the middle of the box, and an orthographic view whose footprint is
# the box's front face
PROJECTION_CAMERAS = {
    "fisheye": dict(look_from=(278, 278, 800), field_of_view=160.0),
    "equirect": dict(look_from=(278, 278, -278)),
    "orthographic": dict(look_from=(278, 278, 800), focal_distance=800.0),
}


def projection_camera(m, projection, width, height):
    """The Cornell box's camera for `projection` (PROJECTION_CAMERAS),
    built with package m."""
    kw = dict(PROJECTION_CAMERAS[projection])
    return m.Camera(look_from=m.vec3(*kw.pop("look_from")),
                    look_at=m.vec3(278, 278, -555), screen_width=width,
                    screen_height=height, projection=projection, **kw)


def build_cornell(width=100, height=100, projection="pinhole"):
    Sc = Scene(ambient_color=rgb(0.00, 0.00, 0.00))
    Sc.add_Camera(screen_width=width, screen_height=height,
                  look_from=vec3(278, 278, 800), look_at=vec3(278, 278, 0),
                  focal_distance=1.0, field_of_view=40)
    if projection != "pinhole":
        Sc.camera = projection_camera(raytracer_tpu_torch, projection, width,
                                      height)

    green_diffuse = Diffuse(diff_color=rgb(0.12, 0.45, 0.15))
    red_diffuse = Diffuse(diff_color=rgb(0.65, 0.05, 0.05))
    white_diffuse = Diffuse(diff_color=rgb(0.73, 0.73, 0.73))
    emissive_white = Emissive(color=rgb(15.0, 15.0, 15.0))
    blue_glass = Refractive(n=vec3(1.5 + 0.05e-8j, 1.5 + 0.02e-8j, 1.5 + 0.0j))

    # ceiling light
    Sc.add(Plane(material=emissive_white, center=vec3(213 + 130 / 2, 554, -227.0 - 105 / 2),
                 width=130.0, height=105.0, u_axis=vec3(1.0, 0.0, 0), v_axis=vec3(0.0, 0, 1.0)),
           importance_sampled=True)
    # back, left (green), right (red), ceiling, floor
    Sc.add(Plane(material=white_diffuse, center=vec3(555 / 2, 555 / 2, -555.0),
                 width=555.0, height=555.0, u_axis=vec3(0.0, 1.0, 0), v_axis=vec3(1.0, 0, 0.0)))
    Sc.add(Plane(material=green_diffuse, center=vec3(-0.0, 555 / 2, -555 / 2),
                 width=555.0, height=555.0, u_axis=vec3(0.0, 1.0, 0), v_axis=vec3(0.0, 0, -1.0)))
    Sc.add(Plane(material=red_diffuse, center=vec3(555.0, 555 / 2, -555 / 2),
                 width=555.0, height=555.0, u_axis=vec3(0.0, 1.0, 0), v_axis=vec3(0.0, 0, -1.0)))
    Sc.add(Plane(material=white_diffuse, center=vec3(555 / 2, 555, -555 / 2),
                 width=555.0, height=555.0, u_axis=vec3(1.0, 0.0, 0), v_axis=vec3(0.0, 0, -1.0)))
    Sc.add(Plane(material=white_diffuse, center=vec3(555 / 2, 0.0, -555 / 2),
                 width=555.0, height=555.0, u_axis=vec3(1.0, 0.0, 0), v_axis=vec3(0.0, 0, -1.0)))

    cb = Cuboid(material=white_diffuse, center=vec3(182.5, 165, -285 - 160 / 2),
                width=165, height=165 * 2, length=165, shadow=False)
    cb.rotate(θ=15, u=vec3(0, 1, 0))
    Sc.add(cb)

    Sc.add(Sphere(material=blue_glass, center=vec3(370.5, 165 / 2, -65 - 185 / 2),
                  radius=165 / 2, shadow=False, max_ray_depth=3),
           importance_sampled=True)
    return Sc


if __name__ == "__main__":
    Sc = build_cornell(100, 100)
    img = Sc.render(samples_per_pixel=256)
    img.save("cornell_box_torch.png")
