"""Blinn-Phong lighting for the wavefront shader (counterpart of
``raytracer_tpu/render/shading.py``).

Reference (clayne/CPU-Raytracer): Light.h:12-26 (base Blinn-Phong: N.L diffuse + (N.H)^128
specular, masked to front-facing), PointLight.h:9-11 (1/d^2), SpotLight.h:17-33
(inner/outer cone falloff), DirectionalLight.h:9-11.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm


def blinn_phong(normal, to_light, to_camera, colour):
    """Base Blinn-Phong intensity (Light.h:12-26). All [N,3] except colour [1,3]."""
    intensity = vm.dot(normal, to_light)
    mask = intensity > 0.0
    half_angle = vm.normalize(to_light + to_camera, eps=1e-20)
    specular = vm.dot(normal, half_angle)
    intensity = intensity + vm.pow2_128(specular)
    return torch.where(mask, intensity, 0.0)[:, None] * colour


def point_light(normal, to_light, to_camera, colour, distance_squared):
    """PointLight.h:9-11."""
    return blinn_phong(normal, to_light, to_camera, colour) / distance_squared[:, None]


def spot_light(normal, to_light, to_camera, colour, distance_squared, neg_dir, inner,
               outer):
    """SpotLight.h:17-33: radial falloff (dot-outer)/(inner-outer), clamped at 1,
    zero outside the outer cone, times the point-light term."""
    d = vm.dot(to_light, neg_dir)
    falloff = (d - outer) / (inner - outer)
    falloff = torch.where(falloff > 1.0, 1.0, falloff)
    falloff = torch.where(d > outer, falloff, 0.0)
    return falloff[:, None] * point_light(normal, to_light, to_camera, colour,
                                          distance_squared)


def directional_light(normal, to_camera, colour, neg_dir):
    """DirectionalLight.h:9-11."""
    return blinn_phong(normal, neg_dir.expand(normal.shape), to_camera, colour)
