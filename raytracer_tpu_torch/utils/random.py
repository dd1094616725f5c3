"""PDF classes of sightpy's object API (sightpy utils/random.py:21-174).

Counterpart of raytracer_tpu/utils/random.py.  The samplers themselves are
the functions of core/rng.py; these thin classes give them sightpy's
`pdf.generate()` / `pdf.value(dir)` form.  `generate` takes a
`torch.Generator` on the device of the pdf's tensors, where sightpy drew
from numpy's hidden global generator.
"""

from __future__ import annotations

import torch

from ..core import rng

random_in_unit_disk = rng.random_in_unit_disk
random_in_unit_sphere = rng.random_in_unit_sphere
random_in_unit_spherical_cap = rng.spherical_cap_sample


class PDF:
    """Probability density function over directions."""

    def value(self, ray_dir):
        raise NotImplementedError

    def generate(self, generator):
        raise NotImplementedError


class hemisphere_pdf(PDF):
    def __init__(self, shape, normal):
        self.shape = shape
        self.normal = normal

    def value(self, ray_dir):
        return rng.hemisphere_pdf_value(ray_dir, self.normal)

    def generate(self, generator):
        return rng.hemisphere_sample(generator, self.normal)


class cosine_pdf(PDF):
    def __init__(self, shape, normal):
        self.shape = shape
        self.normal = normal

    def value(self, ray_dir):
        return rng.cosine_pdf_value(ray_dir, self.normal)

    def generate(self, generator):
        return rng.cosine_sample(generator, self.normal)


class spherical_caps_pdf(PDF):
    """Union of caps toward importance-sampled primitives.

    `importance_sampled_list` takes primitives (with .center and
    .bounded_sphere_radius), as sightpy's does, or a (centers, radii) pair
    of tensors.
    """

    def __init__(self, shape, origin, importance_sampled_list):
        self.shape = shape
        self.origin = origin
        if hasattr(importance_sampled_list[0], "center"):
            self.centers = torch.as_tensor(
                [list(p.center) for p in importance_sampled_list],
                dtype=torch.float32, device=origin.device)
            self.radii = torch.as_tensor(
                [float(p.bounded_sphere_radius) for p in importance_sampled_list],
                dtype=torch.float32, device=origin.device)
        else:
            self.centers, self.radii = importance_sampled_list

    def value(self, ray_dir):
        return rng.caps_pdf_value(ray_dir, self.origin, self.centers, self.radii)

    def generate(self, generator):
        return rng.caps_sample(generator, self.origin, self.centers, self.radii)


class mixed_pdf(PDF):
    def __init__(self, shape, pdf1, pdf2, pdf1_weight=0.5):
        self.shape = shape
        self.pdf1 = pdf1
        self.pdf2 = pdf2
        self.pdf1_weight = pdf1_weight
        self.pdf2_weight = 1.0 - pdf1_weight

    def value(self, ray_dir):
        return (self.pdf1.value(ray_dir) * self.pdf1_weight
                + self.pdf2.value(ray_dir) * self.pdf2_weight)

    def generate(self, generator):
        """Both components' directions, then the mixture choice, all from
        `generator`."""
        d1 = self.pdf1.generate(generator)
        d2 = self.pdf2.generate(generator)
        use1 = torch.rand(d1.shape[:-1], generator=generator, dtype=d1.dtype,
                          device=generator.device) < self.pdf1_weight
        return torch.where(use1[..., None], d1, d2)


def random_in_unit_spherical_caps(generator, shape, origin,
                                  importance_sampled_list):
    """Sample the union of caps; returns (direction, pdf) (sightpy
    random.py:177-236)."""
    pdf = spherical_caps_pdf(shape, origin, importance_sampled_list)
    d = pdf.generate(generator)
    return d, pdf.value(d)
