"""Simulation-based inference through the PyTorch / CUDA port
(examples/simulation_inference.py): render a glass sphere at many
refraction indices, record image statistics, fit a small MLP n <-
statistics, and infer the index of a held-out render.

    python examples/torch_simulation_inference.py [--quick] [--device cpu]

Writes rays_dataset.csv next to this script and prints the true and the
inferred index.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import raytracer_tpu_torch as T  # noqa: E402


def glass_scene(n_real, m=None):
    m = m or T
    sc = m.Scene(ambient_color=m.rgb(0, 0, 0))
    sc.add_Camera(look_from=m.vec3(0, 0, 2.5), look_at=m.vec3(0, 0, -1),
                  screen_width=32, screen_height=32, field_of_view=30)
    sc.add(m.Sphere(material=m.Refractive(n=m.vec3(n_real + 4e-8j, n_real,
                                                   n_real)),
                    center=m.vec3(0, 0, 0), radius=0.7, shadow=False,
                    max_ray_depth=4))
    sc.add(m.Plane(material=m.Emissive(color=m.rgb(1.0, 0.6, 0.3)),
                   center=m.vec3(0, 0, -4), width=3.0, height=3.0,
                   u_axis=m.vec3(1, 0, 0), v_axis=m.vec3(0, 1, 0)))
    return sc


def ray_features(img):
    """Summary statistics of the image (refraction bends the emissive
    backdrop, changing its spatial statistics)."""
    a = np.asarray(img, np.float32) / 255.0
    lum = a.mean(-1)
    cy = lum[8:24, 8:24].mean()
    return [lum.mean(), lum.std(), cy, lum.mean() - cy,
            np.abs(np.diff(lum, axis=1)).mean(),
            np.abs(np.diff(lum, axis=0)).mean()]


def simulate(path, n_sims=40, spp=32, device=None):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_sims):
        n_real = float(rng.uniform(1.1, 1.9))
        img = glass_scene(n_real).render(samples_per_pixel=spp, seed=i,
                                         device=device)
        rows.append([n_real] + ray_features(img))
        print(f"sim {i + 1}/{n_sims} n={n_real:.3f}", flush=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["n_real", "mean", "std", "center", "ring", "gx", "gy"])
        w.writerows(rows)
    return np.asarray(rows, np.float32)


def infer(data, observed, steps=800):
    torch.manual_seed(0)
    x = torch.tensor(data[:, 1:])
    y = torch.tensor(data[:, :1])
    mu, sd = x.mean(0), x.std(0) + 1e-6
    x = (x - mu) / sd
    net = torch.nn.Sequential(
        torch.nn.Linear(x.shape[1], 64), torch.nn.ReLU(),
        torch.nn.Linear(64, 64), torch.nn.ReLU(), torch.nn.Linear(64, 1))
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(net(x), y)
        loss.backward()
        opt.step()
    obs = (torch.tensor([observed], dtype=torch.float32) - mu) / sd
    return float(net(obs).item())


def main():
    quick = "--quick" in sys.argv
    device = (sys.argv[sys.argv.index("--device") + 1]
              if "--device" in sys.argv else None)
    out = Path(__file__).parent / "rays_dataset.csv"
    data = simulate(out, n_sims=10 if quick else 40, spp=16 if quick else 32,
                    device=device)
    true_n = 1.52
    obs = ray_features(glass_scene(true_n).render(
        samples_per_pixel=16 if quick else 64, seed=999, device=device))
    print(f"true n_real = {true_n}, inferred = {infer(data, obs):.3f}")


if __name__ == "__main__":
    main()
