"""Batched ray/hit records and analytic primitives (counterpart of
``raytracer_tpu/ops/intersect.py``).

Every function operates on a wavefront of N rays at once.  Hit records are
NamedTuples of tensors (structure-of-arrays), the analog of the reference's
RayHit packet (RayHit.h:4-36).  The analytic primitives are kernel K9:
``pick_closest`` / ``pick_any`` launch ``csrc/primitives.cu`` for CUDA tensors
and run ``pick_closest_plain`` / ``pick_any_plain`` for CPU tensors;
``primitive_hits`` is torch on both devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import RAY_EPSILON
from ..core import vecmath as vm
from ..utils import trace


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


# ---------------------------------------------------------------------------
# Spheres and planes (kernel K9)
#
# The JAX package folds each primitive into the hit record in turn
# (sphere_trace / plane_trace, then sphere_intersect / plane_intersect).  Here
# the work is split as K1 + ``_mesh_hits_into`` split it for meshes: a discrete
# pick (the winning primitive and its t; for shadow rays, whether any primitive
# blocks) and a differentiable re-derivation of the winner's hit record from
# its index.  ``prims`` is any object with the DeviceScene's ``sph_*`` and
# ``pln_*`` fields.  Winner ids: -1 none, 0..S-1 sphere, S..S+P-1 plane.
# ---------------------------------------------------------------------------

# spheres + planes the kernels stage in shared memory (4 floats each, 48 KB)
MAX_PRIMITIVES = 3072


def _sphere_t(o, d, center, radius):
    """sphere_trace's quadratic (Sphere.cpp:9-40): (t, counts) with
    t = t0 > EPS ? t0 : t1.  Broadcasts over the leading dimensions."""
    r2 = radius * radius
    oc = o - center
    a = vm.length_squared(d)
    b = 2.0 * vm.dot(oc, d)
    c = vm.length_squared(oc) - r2
    disc = b * b - 4.0 * a * c
    sqrt_d = vm.safe_sqrt(disc)
    inv_denom = -1.0 / (2.0 * a)
    t0 = (b + sqrt_d) * inv_denom
    t1 = (b - sqrt_d) * inv_denom
    t = torch.where(t0 > RAY_EPSILON, t0, t1)
    return t, (disc >= 0.0) & (t > RAY_EPSILON)


def _plane_t(o, d, normal, distance):
    """plane_trace's distance (Plane.cpp:13-20); broadcasts."""
    return -(vm.dot(o, normal) + distance) / _nonzero(vm.dot(d, normal))


def pick_closest_plain(prims, o, d):
    """Closest primitive per lane: (winner [N] int32, t [N] f32, inf = none).

    Spheres first, then planes, in scene order; a later primitive wins only at
    a strictly smaller t, so the earliest of equal minima wins (argmin)."""
    n = o.shape[0]
    oe, de = o[:, None, :], d[:, None, :]
    ts, oks = [], []
    if prims.sph_center.shape[0]:
        t, ok = _sphere_t(oe, de, prims.sph_center[None], prims.sph_radius[None])
        ts.append(t)
        oks.append(ok)
    if prims.pln_normal.shape[0]:
        t = _plane_t(oe, de, prims.pln_normal[None], prims.pln_distance[None])
        ts.append(t)
        oks.append(t > RAY_EPSILON)
    if not ts:
        return (torch.full((n,), -1, dtype=torch.int32, device=o.device),
                torch.full((n,), float("inf"), dtype=torch.float32, device=o.device))
    t_all = torch.cat(ts, dim=1)
    t_all = torch.where(torch.cat(oks, dim=1), t_all, float("inf"))
    k = torch.argmin(t_all, dim=1, keepdim=True)
    t = torch.gather(t_all, 1, k)[:, 0]
    winner = torch.where(t < float("inf"), k[:, 0].to(torch.int32), -1)
    return winner, t


def pick_any_plain(prims, o, d, max_distance, active):
    """[N] bool: an active lane blocked by any sphere (the geometric test of
    Sphere.cpp:92-112, not the closest-hit quadratic) or plane within
    (EPS, max_distance)."""
    oe, de, tmax = o[:, None, :], d[:, None, :], max_distance[:, None]
    blocked = torch.zeros_like(active)
    if prims.sph_center.shape[0]:
        c = prims.sph_center[None] - oe
        t = vm.dot(c, de)
        q = c - t[..., None] * de
        p2 = vm.dot(q, q)
        rs = prims.sph_radius[None] * prims.sph_radius[None]
        t = t - vm.safe_sqrt(rs - p2)
        blocked = blocked | ((p2 < rs) & (t > RAY_EPSILON) & (t < tmax)).any(dim=1)
    if prims.pln_normal.shape[0]:
        t = _plane_t(oe, de, prims.pln_normal[None], prims.pln_distance[None])
        blocked = blocked | ((t > RAY_EPSILON) & (t < tmax)).any(dim=1)
    return blocked & active


def _check_prims(what, prims, *rays):
    s, p = prims.sph_center.shape[0], prims.pln_normal.shape[0]
    params = (prims.sph_center, prims.sph_radius, prims.pln_normal, prims.pln_distance)
    if (prims.sph_center.shape != (s, 3) or prims.sph_radius.shape != (s,)
            or prims.pln_normal.shape != (p, 3) or prims.pln_distance.shape != (p,)):
        raise ValueError(f"{what}: sph_center [S,3], sph_radius [S], pln_normal [P,3], "
                         "pln_distance [P] expected")
    if s + p > MAX_PRIMITIVES:
        raise ValueError(f"{what}: {s + p} spheres + planes; the kernel takes at most "
                         f"{MAX_PRIMITIVES}")
    floats = [x for x in (*params, *rays) if x.dtype != torch.bool]
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError(f"{what}: float32 rays and primitives expected")
    if any(x.device != rays[0].device for x in (*params, *rays)):
        raise ValueError(f"{what}: inputs on different devices")
    kernels.require_contiguous(what, *params, *rays)
    kernels.require_no_grad(what, *floats)
    return s, p


def pick_closest(prims, o, d):
    """K9 closest hit: (winner [N] int32, t [N] f32).  CPU tensors take
    ``pick_closest_plain``; CUDA tensors launch ``rt_prim_closest`` (counted
    in ``trace.counters["launch.k9.closest"]``)."""
    if o.device.type == "cpu":
        return pick_closest_plain(prims, o, d)
    return _closest_launch(prims, o, d)


def _closest_launch(prims, o, d):
    """One ``rt_prim_closest`` launch: (winner, t)."""
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3):
        raise ValueError("pick_closest: o, d [N,3] expected")
    s, p = _check_prims("pick_closest", prims, o, d)
    winner = torch.empty((n,), dtype=torch.int32, device=o.device)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    if n == 0:
        return winner, t
    P, I = kernels.P, kernels.I
    fn = kernels.entry("primitives", "rt_prim_closest", [P, P, I, P, P, I, P, P, I, P, P, P])
    err = fn(prims.sph_center.data_ptr(), prims.sph_radius.data_ptr(), s,
             prims.pln_normal.data_ptr(), prims.pln_distance.data_ptr(), p,
             o.data_ptr(), d.data_ptr(), n, winner.data_ptr(), t.data_ptr(),
             kernels.stream_ptr(o.device))
    trace.count("launch.k9.closest")
    kernels.check(err, "rt_prim_closest")
    return winner, t


def pick_any(prims, o, d, max_distance, active):
    """K9 any hit: [N] bool, active lanes blocked by a sphere or plane.  CPU
    tensors take ``pick_any_plain``; CUDA tensors launch ``rt_prim_any``
    (counted in ``trace.counters["launch.k9.any"]``)."""
    if o.device.type == "cpu":
        return pick_any_plain(prims, o, d, max_distance, active)
    return _any_launch(prims, o, d, max_distance, active)


def _any_launch(prims, o, d, max_distance, active):
    """One ``rt_prim_any`` launch: blocked."""
    n = o.shape[0]
    if (o.shape != (n, 3) or d.shape != (n, 3) or max_distance.shape != (n,)
            or active.shape != (n,) or active.dtype != torch.bool):
        raise ValueError("pick_any: o, d [N,3], max_distance [N], active [N] bool expected")
    s, p = _check_prims("pick_any", prims, o, d, max_distance, active)
    blocked = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n == 0:
        return blocked
    P, I = kernels.P, kernels.I
    fn = kernels.entry("primitives", "rt_prim_any", [P, P, I, P, P, I, P, P, P, P, I, P, P])
    err = fn(prims.sph_center.data_ptr(), prims.sph_radius.data_ptr(), s,
             prims.pln_normal.data_ptr(), prims.pln_distance.data_ptr(), p,
             o.data_ptr(), d.data_ptr(), max_distance.data_ptr(), active.data_ptr(), n,
             blocked.data_ptr(), kernels.stream_ptr(o.device))
    trace.count("launch.k9.any")
    kernels.check(err, "rt_prim_any")
    return blocked


def _sphere_record(rays: Rays, hits: Hits, center, radius, material) -> Hits:
    """sphere_trace's hit record (Sphere.cpp:42-90) with per-lane sphere
    parameters ([N,3], [N], [N])."""
    t, _ = _sphere_t(rays.origin, rays.direction, center, radius)
    inv_r = (1.0 / radius)[:, None]
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

    return hits._replace(
        hit=torch.ones_like(hits.hit), t=t, point=point, normal=normal,
        material_id=material, u=u, v=v, ds_dx=ds_dx, ds_dy=ds_dy, dt_dx=dt_dx,
        dt_dy=dt_dy, dO_dx=dP_dx, dO_dy=dP_dy, dN_dx=dN_dx, dN_dy=dN_dy,
    )


def _plane_record(rays: Rays, hits: Hits, normal, distance, u_axis, v_axis,
                  material) -> Hits:
    """plane_trace's hit record (Plane.cpp:22-69) with per-lane plane parameters."""
    t = _plane_t(rays.origin, rays.direction, normal, distance)
    point = rays.origin + t[:, None] * rays.direction
    dP_dx, dP_dy = _transfer_differentials(rays, t, normal)
    zeros3 = torch.zeros_like(point)
    return hits._replace(
        hit=torch.ones_like(hits.hit), t=t, point=point, normal=normal,
        material_id=material, u=vm.dot(point, u_axis), v=vm.dot(point, v_axis),
        ds_dx=vm.dot(dP_dx, u_axis), ds_dy=vm.dot(dP_dy, u_axis),
        dt_dx=vm.dot(dP_dx, v_axis), dt_dy=vm.dot(dP_dy, v_axis),
        dO_dx=dP_dx, dO_dy=dP_dy,
        # dN/dxy = 0 for planes (Plane.cpp:59-62)
        dN_dx=zeros3, dN_dy=zeros3,
    )


def primitive_hits(prims, rays: Rays, winner) -> Hits:
    """The hit record of each lane's winning primitive (``pick_closest``),
    re-derived differentiably from its index with sphere_trace's / plane_trace's
    formulas: the same values, and through autograd the same gradients, as the
    JAX package's chain of per-primitive selects.  Lanes with no winner keep
    the all-miss record."""
    hits = make_miss_hits(rays.count, rays.origin.device)
    s, p = prims.sph_center.shape[0], prims.pln_normal.shape[0]
    if s:
        k = torch.clamp(winner, 0, s - 1).long()
        new = _sphere_record(rays, hits, prims.sph_center[k], prims.sph_radius[k],
                             prims.sph_material[k])
        hits = _select((winner >= 0) & (winner < s), new, hits)
    if p:
        k = torch.clamp(winner - s, 0, p - 1).long()
        new = _plane_record(rays, hits, prims.pln_normal[k], prims.pln_distance[k],
                            prims.pln_u[k], prims.pln_v[k], prims.pln_material[k])
        hits = _select(winner >= s, new, hits)
    return hits
