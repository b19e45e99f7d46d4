"""Batched ray/hit records and analytic primitives (counterpart of
``raytracer_tpu/ops/intersect.py``).

Every function operates on a wavefront of N rays at once, as elementwise torch.
Hit records are NamedTuples of tensors (structure-of-arrays), the analog of the
reference's RayHit packet (RayHit.h:4-36).  The analytic primitives have no
hand-written kernel: they are elementwise and off config3's path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RAY_EPSILON
from ..core import vecmath as vm


class Rays(NamedTuple):
    """SoA wavefront ray batch with Igehy ray differentials (Ray.h:4-17)."""

    origin: torch.Tensor  # [N,3]
    direction: torch.Tensor  # [N,3]
    dO_dx: torch.Tensor  # [N,3]
    dO_dy: torch.Tensor  # [N,3]
    dD_dx: torch.Tensor  # [N,3]
    dD_dy: torch.Tensor  # [N,3]

    @property
    def count(self) -> int:
        return self.origin.shape[0]


def make_rays(origin, direction) -> Rays:
    """Rays without differentials (shadow rays)."""
    z = torch.zeros_like(origin)
    return Rays(origin, direction, z, z, z, z)


class Hits(NamedTuple):
    """SoA wavefront hit record (RayHit.h:4-36)."""

    hit: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N] distance
    point: torch.Tensor  # [N,3] world-space hit point
    normal: torch.Tensor  # [N,3] world-space shading normal
    material_id: torch.Tensor  # [N] int32
    u: torch.Tensor  # [N] texture s
    v: torch.Tensor  # [N] texture t
    # texture-space derivatives w.r.t. screen x/y (for mip LOD)
    ds_dx: torch.Tensor
    ds_dy: torch.Tensor
    dt_dx: torch.Tensor
    dt_dy: torch.Tensor
    # positional/normal differentials (RayHit.h:14-22)
    dO_dx: torch.Tensor  # [N,3]
    dO_dy: torch.Tensor  # [N,3]
    dN_dx: torch.Tensor  # [N,3]
    dN_dy: torch.Tensor  # [N,3]
    bvh_steps: torch.Tensor  # [N] int32 traversal-step heatmap counter


def make_miss_hits(n: int, device) -> Hits:
    """All-miss initialization (RayHit.h:28-35): hit=false, distance=inf."""
    f = torch.zeros((n,), dtype=torch.float32, device=device)
    v3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return Hits(
        hit=torch.zeros((n,), dtype=torch.bool, device=device),
        t=torch.full((n,), float("inf"), dtype=torch.float32, device=device),
        point=v3,
        normal=v3,
        material_id=torch.zeros((n,), dtype=torch.int32, device=device),
        u=f,
        v=f,
        ds_dx=f,
        ds_dy=f,
        dt_dx=f,
        dt_dy=f,
        dO_dx=v3,
        dO_dy=v3,
        dN_dx=v3,
        dN_dy=v3,
        bvh_steps=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _nonzero(x, tiny: float = 1e-20):
    """Push a (possibly zero) denominator away from 0, keeping its sign."""
    return torch.where(
        torch.abs(x) < tiny,
        torch.where(x < 0, -tiny, tiny).to(x.dtype),
        x,
    )


def _transfer_differentials(rays: Rays, t, normal):
    """Igehy '99 transfer: propagate (dO, dD) to the hit point (Sphere.cpp:63-75)."""
    dP_dx_plus = rays.dO_dx + t[:, None] * rays.dD_dx
    dP_dy_plus = rays.dO_dy + t[:, None] * rays.dD_dy
    denom = -1.0 / (vm.dot(rays.direction, normal) + 1e-8)
    dt_dx = vm.dot(dP_dx_plus, normal) * denom
    dt_dy = vm.dot(dP_dy_plus, normal) * denom
    dP_dx = dP_dx_plus + dt_dx[:, None] * rays.direction
    dP_dy = dP_dy_plus + dt_dy[:, None] * rays.direction
    return dP_dx, dP_dy


def _select(mask, new: Hits, old: Hits) -> Hits:
    """Per-lane select of every field of two hit records."""
    m3 = mask[:, None]
    return Hits(*[
        torch.where(m3 if a.dim() == 2 else mask, a, b)
        for a, b in zip(new, old)
    ])


def sphere_trace(rays: Rays, hits: Hits, center, radius, material_id) -> Hits:
    """Closest-hit against one sphere for the whole wavefront (Sphere.cpp:9-90)."""
    r2 = radius * radius
    inv_r = 1.0 / radius

    oc = rays.origin - center
    a = vm.length_squared(rays.direction)
    b = 2.0 * vm.dot(oc, rays.direction)
    c = vm.length_squared(oc) - r2
    d = b * b - 4.0 * a * c

    mask = d >= 0.0
    sqrt_d = vm.safe_sqrt(d)
    inv_denom = -1.0 / (2.0 * a)
    t0 = (b + sqrt_d) * inv_denom
    t1 = (b - sqrt_d) * inv_denom
    t = torch.where(t0 > RAY_EPSILON, t0, t1)
    mask = mask & (t > RAY_EPSILON) & (t < hits.t)

    point = rays.origin + t[:, None] * rays.direction
    normal = (point - center) * inv_r

    # Spherical-coordinate uv (Sphere.cpp:60-61); atan2 guarded off the pole axis
    on_pole = (normal[:, 0] * normal[:, 0] + normal[:, 2] * normal[:, 2]) < 1e-12
    one = torch.ones_like(t)
    u = (
        torch.atan2(
            torch.where(on_pole, one, normal[:, 2]),
            torch.where(on_pole, one, normal[:, 0]),
        )
        * vm.ONE_OVER_TWO_PI
        + 0.5
    )
    v = vm.safe_arccos(normal[:, 1]) * vm.ONE_OVER_PI + 0.5

    dP_dx, dP_dy = _transfer_differentials(rays, t, normal)
    dN_dx = dP_dx * inv_r
    dN_dy = dP_dy * inv_r

    # Closed-form uv derivatives (Sphere.cpp:77-88)
    nonzero = 1e-8
    ds_denom = vm.ONE_OVER_TWO_PI / (
        normal[:, 0] * normal[:, 0] + normal[:, 2] * normal[:, 2] + nonzero
    )
    ds_dx = (normal[:, 0] * dN_dx[:, 2] - normal[:, 2] * dN_dx[:, 0]) * ds_denom
    ds_dy = (normal[:, 0] * dN_dy[:, 2] - normal[:, 2] * dN_dy[:, 0]) * ds_denom
    dt_denom = -vm.ONE_OVER_PI / (vm.safe_sqrt(1.0 - normal[:, 1] * normal[:, 1]) + nonzero)
    dt_dx = dN_dx[:, 1] * dt_denom
    dt_dy = dN_dy[:, 1] * dt_denom

    new = hits._replace(
        hit=torch.ones_like(hits.hit),
        t=t,
        point=point,
        normal=normal,
        material_id=torch.full_like(hits.material_id, int(material_id)),
        u=u,
        v=v,
        ds_dx=ds_dx,
        ds_dy=ds_dy,
        dt_dx=dt_dx,
        dt_dy=dt_dy,
        dO_dx=dP_dx,
        dO_dy=dP_dy,
        dN_dx=dN_dx,
        dN_dy=dN_dy,
    )
    return _select(mask, new, hits)


def sphere_intersect(rays: Rays, max_distance, center, radius) -> torch.Tensor:
    """Cheaper geometric any-hit for shadow rays (Sphere.cpp:92-112). Returns mask."""
    c = center - rays.origin
    t = vm.dot(c, rays.direction)
    q = c - t[:, None] * rays.direction
    p2 = vm.dot(q, q)
    rs = radius * radius
    mask = p2 < rs
    t = t - vm.safe_sqrt(rs - p2)
    return mask & (t > RAY_EPSILON) & (t < max_distance)


def plane_trace(rays: Rays, hits: Hits, normal, distance, u_axis, v_axis,
                material_id) -> Hits:
    """Closest-hit against one infinite plane (Plane.cpp:13-69)."""
    n = normal
    t = -(vm.dot(rays.origin, n) + distance) / _nonzero(vm.dot(rays.direction, n))
    mask = (t > RAY_EPSILON) & (t < hits.t)

    point = rays.origin + t[:, None] * rays.direction
    nb = n.expand(point.shape)

    u = vm.dot(point, u_axis)
    v = vm.dot(point, v_axis)

    dP_dx, dP_dy = _transfer_differentials(rays, t, nb)
    zeros3 = torch.zeros_like(point)

    new = hits._replace(
        hit=torch.ones_like(hits.hit),
        t=t,
        point=point,
        normal=nb,
        material_id=torch.full_like(hits.material_id, int(material_id)),
        u=u,
        v=v,
        ds_dx=vm.dot(dP_dx, u_axis),
        ds_dy=vm.dot(dP_dy, u_axis),
        dt_dx=vm.dot(dP_dx, v_axis),
        dt_dy=vm.dot(dP_dy, v_axis),
        dO_dx=dP_dx,
        dO_dy=dP_dy,
        # dN/dxy = 0 for planes (Plane.cpp:59-62)
        dN_dx=zeros3,
        dN_dy=zeros3,
    )
    return _select(mask, new, hits)


def plane_intersect(rays: Rays, max_distance, normal, distance) -> torch.Tensor:
    """Any-hit against one plane (Plane.cpp:72-80)."""
    t = -(vm.dot(rays.origin, normal) + distance) / _nonzero(vm.dot(rays.direction, normal))
    return (t > RAY_EPSILON) & (t < max_distance)
