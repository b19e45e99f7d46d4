"""Hit reconstruction from the traversal's ids (kernel K7; counterpart of
``raytracer_tpu/render/renderer.py:_mesh_hits_into``).

The walk (K1/K2, K10) is discrete: it returns the identified triangle and
instance.  This module re-derives (t, u, v) from them with Moller-Trumbore,
then the point, normal, uv, material and the Ray Tracing Gems ch.20
differentials (BottomLevelBVH.cpp:260-305), merged into the prior hit record
(K9's spheres and planes, or the miss record), so that gradients reach the
rays, the vertices and the instance transforms.

``mesh_hits`` runs ``mesh_hits_plain`` (torch, differentiated by autograd) for
CPU tensors.  For CUDA tensors it goes through ``MeshHits``, whose forward
launches ``rt_hits_fwd`` (``csrc/hits.cu``, counted in
``trace.counters["launch.k7"]``) and whose backward launches ``rt_hits_bwd``
(counted in ``"launch.k7.bwd"``): the chain rule by hand, recomputing each
lane's forward from the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..core import vecmath as vm
from ..utils import trace
from .intersect import Hits, Rays, _nonzero

# the triangle tables a lane reads, in csrc/hits.cu's order; the first nine
# take gradients
GEOMETRY = ("tr_p0", "tr_e1", "tr_e2", "tr_n0", "tr_ne1", "tr_ne2", "tr_t0", "tr_te1",
            "tr_te2")
# the record's fields that carry gradients (the others: hit, material_id, bvh_steps)
FLOAT_FIELDS = ("t", "point", "normal", "u", "v", "ds_dx", "ds_dy", "dt_dx", "dt_dy",
                "dO_dx", "dO_dy", "dN_dx", "dN_dy")
_N_GEOM, _N_RAYS, _N_REC = len(GEOMETRY), len(Rays._fields), len(Hits._fields)


def _xp(m, p):
    """Rows of a batch of 3x4 matrices applied to points, as component sums."""
    return torch.stack(
        [m[:, r, 0] * p[:, 0] + m[:, r, 1] * p[:, 1] + m[:, r, 2] * p[:, 2] + m[:, r, 3]
         for r in range(3)], dim=-1,
    )


def _xd(m, d):
    """Rows of a batch of 3x4 matrices applied to directions, as component sums."""
    return torch.stack(
        [m[:, r, 0] * d[:, 0] + m[:, r, 1] * d[:, 1] + m[:, r, 2] * d[:, 2]
         for r in range(3)], dim=-1,
    )


def mesh_hits_plain(scene, rays: Rays, res, hits: Hits,
                    object_space_diffs: bool = False) -> Hits:
    """K7 in torch: reconstruct the hit attributes from the discrete ids ``res.tri``
    and ``res.inst`` (-1 = no mesh hit, where ``hits`` is kept) and merge them into
    ``hits``; ``bvh_steps`` adds ``res.steps``.  ``scene`` is any object with the
    DeviceScene's ``tr_*`` and ``inst_inv`` / ``inst_world`` fields."""
    valid = res.tri >= 0
    ti = torch.clamp_min(res.tri, 0)
    ii = torch.clamp_min(res.inst, 0)

    def g(arr, idx):
        return arr.index_select(0, idx)

    inv = g(scene.inst_inv, ii)  # [N,3,4]
    world = g(scene.inst_world, ii)

    o_obj = _xp(inv, rays.origin)
    d_obj = _xd(inv, rays.direction)

    p0 = g(scene.tr_p0, ti)
    e1 = g(scene.tr_e1, ti)
    e2 = g(scene.tr_e2, ti)

    hmt = vm.cross(d_obj, e2)
    a = vm.dot(e1, hmt)
    f = 1.0 / _nonzero(a)
    s = o_obj - p0
    u = f * vm.dot(s, hmt)
    q = vm.cross(s, e1)
    v = f * vm.dot(d_obj, q)
    t = f * vm.dot(e2, q)

    point = rays.origin + t[:, None] * rays.direction

    n0 = g(scene.tr_n0, ti)
    ne1 = g(scene.tr_ne1, ti)
    ne2 = g(scene.tr_ne2, ti)
    n_raw = n0 + u[:, None] * ne1 + v[:, None] * ne2
    normal = _xd(world, vm.normalize(n_raw, eps=1e-20))

    t0 = g(scene.tr_t0, ti)
    te1 = g(scene.tr_te1, ti)
    te2 = g(scene.tr_te2, ti)
    uv = t0 + u[:, None] * te1 + v[:, None] * te2

    material = g(scene.tr_material, ti)

    dO_dx_o = _xd(inv, rays.dO_dx)
    dO_dy_o = _xd(inv, rays.dO_dy)
    dD_dx_o = _xd(inv, rays.dD_dx)
    dD_dy_o = _xd(inv, rays.dD_dy)
    one_over_k = 1.0 / _nonzero(vm.dot(vm.cross(e1, e2), d_obj))
    qx = dO_dx_o + t[:, None] * dD_dx_o
    qy = dO_dy_o + t[:, None] * dD_dy_o
    c_u = vm.cross(e2, d_obj)
    c_v = vm.cross(d_obj, e1)
    du_dx = one_over_k * vm.dot(c_u, qx)
    du_dy = one_over_k * vm.dot(c_u, qy)
    dv_dx = one_over_k * vm.dot(c_v, qx)
    dv_dy = one_over_k * vm.dot(c_v, qy)

    # cfg.differentials_object_space: identity keeps the reference's object-space
    # differentials; the default rotates them to world space
    rot = (lambda m, x: x) if object_space_diffs else _xd
    dP_dx = rot(world, du_dx[:, None] * e1 + dv_dx[:, None] * e2)
    dP_dy = rot(world, du_dy[:, None] * e1 + dv_dy[:, None] * e2)

    dn_dx = du_dx[:, None] * ne1 + dv_dx[:, None] * ne2
    dn_dy = du_dy[:, None] * ne1 + dv_dy[:, None] * ne2
    n_dot_n = vm.dot(n_raw, n_raw) + 1e-20
    n_denom = (torch.rsqrt(n_dot_n) / n_dot_n)[:, None]
    dN_dx = rot(world, (n_dot_n[:, None] * dn_dx - vm.dot(n_raw, dn_dx)[:, None] * n_raw)
                * n_denom)
    dN_dy = rot(world, (n_dot_n[:, None] * dn_dy - vm.dot(n_raw, dn_dy)[:, None] * n_raw)
                * n_denom)

    ds_dx = du_dx * te1[:, 0] + dv_dx * te2[:, 0]
    ds_dy = du_dy * te1[:, 0] + dv_dy * te2[:, 0]
    dt_dx = du_dx * te1[:, 1] + dv_dx * te2[:, 1]
    dt_dy = du_dy * te1[:, 1] + dv_dy * te2[:, 1]

    m3 = valid[:, None]
    return hits._replace(
        hit=hits.hit | valid,
        t=torch.where(valid, t, hits.t),
        point=torch.where(m3, point, hits.point),
        normal=torch.where(m3, normal, hits.normal),
        material_id=torch.where(valid, material, hits.material_id),
        u=torch.where(valid, uv[:, 0], hits.u),
        v=torch.where(valid, uv[:, 1], hits.v),
        ds_dx=torch.where(valid, ds_dx, hits.ds_dx),
        ds_dy=torch.where(valid, ds_dy, hits.ds_dy),
        dt_dx=torch.where(valid, dt_dx, hits.dt_dx),
        dt_dy=torch.where(valid, dt_dy, hits.dt_dy),
        dO_dx=torch.where(m3, dP_dx, hits.dO_dx),
        dO_dy=torch.where(m3, dP_dy, hits.dO_dy),
        dN_dx=torch.where(m3, dN_dx, hits.dN_dx),
        dN_dy=torch.where(m3, dN_dy, hits.dN_dy),
        bvh_steps=hits.bvh_steps + res.steps,
    )


def _check(what, tri, inst, rays, geom, material, inv, world, record=()) -> int:
    """The kernels' contract: every tensor on one CUDA device, contiguous, of the
    dtypes and shapes below; returns the lane count."""
    n = tri.shape[0]
    n_tri = geom[0].shape[0]
    if tri.device.type != "cuda":
        raise ValueError(f"{what}: CUDA tensors expected (mesh_hits_plain runs on the CPU)")
    lane = [tri, inst, *rays, *record]
    table = [*geom, material, inv, world]
    if any(x.device != tri.device for x in lane + table):
        raise ValueError(f"{what}: inputs on different devices")
    if any(x.shape[0] != n for x in lane) or any(x.shape[0] != n_tri for x in geom + (material,)):
        raise ValueError(f"{what}: per-lane inputs [N, ...] and triangle tables [T, ...] expected")
    if any(x.dim() != 2 or x.shape[1] != 3 for x in (*rays, *geom[:6])):
        raise ValueError(f"{what}: ray fields and tr_p0 .. tr_ne2 must be [., 3]")
    if any(x.dim() != 2 or x.shape[1] != 2 for x in geom[6:]):
        raise ValueError(f"{what}: tr_t0, tr_te1, tr_te2 must be [T, 2]")
    if inv.shape != world.shape or tuple(inv.shape[1:]) != (3, 4) or not 1 <= inv.shape[0] < 255:
        raise ValueError(f"{what}: inst_inv and inst_world [I, 3, 4] with 1 <= I < 255 expected")
    floats = [*rays, *geom, inv, world] + [x for x in record if x.is_floating_point()]
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError(f"{what}: float32 rays, tables and record expected")
    if any(x.dtype != torch.int32 for x in (tri, inst, material)):
        raise TypeError(f"{what}: int32 tri, inst and tr_material expected")
    kernels.require_contiguous(what, *lane, *table)
    return n


def _ptrs(tensors):
    """A C array of the tensors' device pointers (null for None), kept alive by
    the caller for the call."""
    return (ctypes.c_void_p * len(tensors))(*(None if x is None else x.data_ptr()
                                             for x in tensors))


def hits_forward(tri, inst, steps, rays: Rays, geom, material, inv, world, prior: Hits,
                 object_space: bool) -> Hits:
    """K7 forward, one ``rt_hits_fwd`` launch (counted in ``"launch.k7"``): the
    merged record of ``mesh_hits_plain``.  ``geom`` holds the nine ``GEOMETRY``
    tables."""
    n = _check("rt_hits_fwd", tri, inst, rays, geom, material, inv, world, prior)
    if steps.shape != (n,) or steps.dtype != torch.int32 or prior.hit.dtype != torch.bool:
        raise TypeError("rt_hits_fwd: steps int32 [N] and a bool hit field expected")
    kernels.require_contiguous("rt_hits_fwd", steps)
    out = Hits(*(torch.empty_like(x) for x in prior))
    if n == 0:
        return out
    arr = _ptrs([tri, inst, steps, *rays, *geom, material, inv, world, *prior, *out])
    fn = kernels.entry("hits", "rt_hits_fwd", [kernels.P, kernels.I, kernels.I, kernels.P])
    err = fn(ctypes.addressof(arr), n, int(object_space), kernels.stream_ptr(tri.device))
    trace.count("launch.k7")
    kernels.check(err, "rt_hits_fwd")
    return out


def hits_backward(tri, inst, rays: Rays, geom, material, inv, world, cots,
                  object_space: bool, need_rays, need_prior, need_geom, need_inst):
    """K7 backward, one ``rt_hits_bwd`` launch (counted in ``"launch.k7.bwd"``).

    ``cots``: the cotangents of the record's ``FLOAT_FIELDS``.  Returns (6 ray
    gradients, 13 prior-record gradients (``FLOAT_FIELDS``), 9 triangle-table
    gradients, inst_inv's, inst_world's), each None unless its flag in
    ``need_rays`` / ``need_prior`` / ``need_geom`` / ``need_inst`` (two flags)
    asks for it.  The triangle tables' gradients are scattered with float64
    atomics and the instances' summed in float64 (per block, then across
    blocks); each is rounded to float32 once, so the order of the sums, which
    changes from run to run, moves no result by more than that rounding."""
    n = _check("rt_hits_bwd", tri, inst, rays, geom, material, inv, world, cots)
    kernels.require_contiguous("rt_hits_bwd", *cots)
    dev = tri.device

    def empty(x, need):
        return torch.empty_like(x) if need else None

    g_rays = [empty(x, k) for x, k in zip(rays, need_rays)]
    g_prior = [empty(x, k) for x, k in zip(cots, need_prior)]
    geom_sum = [torch.zeros_like(x, dtype=torch.float64) if k else None
                for x, k in zip(geom, need_geom)]
    inst_sum = (torch.zeros((inv.shape[0], 24), dtype=torch.float64, device=dev)
                if any(need_inst) else None)
    if n > 0:
        # cotangent and gradient slots follow the record's layout (Hits._fields)
        by_field = dict(zip(FLOAT_FIELDS, cots))
        rec_cot = [by_field.get(f) for f in Hits._fields]
        by_field = dict(zip(FLOAT_FIELDS, g_prior))
        rec_grad = [by_field.get(f) for f in Hits._fields]
        arr = _ptrs([tri, inst, None, *rays, *geom, material, inv, world, *rec_cot, *g_rays,
                     *rec_grad, *geom_sum, inst_sum])
        fn = kernels.entry("hits", "rt_hits_bwd",
                           [kernels.P, kernels.I, kernels.I, kernels.I, kernels.P])
        err = fn(ctypes.addressof(arr), n, inv.shape[0], int(object_space),
                 kernels.stream_ptr(dev))
        trace.count("launch.k7.bwd")
        kernels.check(err, "rt_hits_bwd")
    g_geom = [None if g is None else g.to(torch.float32) for g in geom_sum]
    g_inst = [None if inst_sum is None or not k
              else inst_sum[:, 12 * j:12 * (j + 1)].to(torch.float32).reshape(inv.shape)
              for j, k in enumerate(need_inst)]
    return g_rays, g_prior, g_geom, g_inst[0], g_inst[1]


# MeshHits.apply's tensor arguments after (object_space, tri, inst, steps,
# tr_material): the geometry, inst_inv, inst_world, the rays, the prior record
_GEOM0 = 5
_INV = _GEOM0 + _N_GEOM
_RAYS0 = _INV + 2
_REC0 = _RAYS0 + _N_RAYS
_FLOAT_SLOTS = [Hits._fields.index(f) for f in FLOAT_FIELDS]


class MeshHits(torch.autograd.Function):
    """K7 on the card: the forward launches ``rt_hits_fwd``, the backward
    ``rt_hits_bwd``, which recomputes each lane from the saved inputs.  Gradients
    reach the ray fields and the prior record's float fields, and the triangle
    tables and instance matrices where they require grad; ``hit``,
    ``material_id`` and ``bvh_steps`` carry none."""

    @staticmethod
    def forward(ctx, object_space, tri, inst, steps, material, *tensors):
        tensors = [x.contiguous() for x in tensors]
        geom = tuple(tensors[:_N_GEOM])
        inv, world = tensors[_N_GEOM], tensors[_N_GEOM + 1]
        rays = Rays(*tensors[_N_GEOM + 2:_N_GEOM + 2 + _N_RAYS])
        prior = Hits(*tensors[_N_GEOM + 2 + _N_RAYS:])
        out = hits_forward(tri, inst, steps, rays, geom, material, inv, world, prior,
                           object_space)
        ctx.object_space = object_space
        ctx.save_for_backward(tri, inst, material, *geom, inv, world, *rays)
        ctx.mark_non_differentiable(out.hit, out.material_id, out.bvh_steps)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        tri, inst, material, *rest = ctx.saved_tensors
        geom = tuple(rest[:_N_GEOM])
        inv, world = rest[_N_GEOM], rest[_N_GEOM + 1]
        rays = Rays(*rest[_N_GEOM + 2:])
        needs = ctx.needs_input_grad
        cots = [grads[k].contiguous() for k in _FLOAT_SLOTS]
        g_rays, g_prior, g_geom, g_inv, g_world = hits_backward(
            tri, inst, rays, geom, material, inv, world, cots, ctx.object_space,
            needs[_RAYS0:_RAYS0 + _N_RAYS], [needs[_REC0 + k] for k in _FLOAT_SLOTS],
            needs[_GEOM0:_GEOM0 + _N_GEOM], needs[_INV:_INV + 2])
        rec = [None] * _N_REC
        for k, g in zip(_FLOAT_SLOTS, g_prior):
            rec[k] = g
        return (None, None, None, None, None, *g_geom, g_inv, g_world, *g_rays, *rec)


def mesh_hits(scene, rays: Rays, res, hits: Hits, object_space_diffs: bool = False) -> Hits:
    """K7, differentiable.  CPU tensors take ``mesh_hits_plain`` (differentiated by
    autograd); CUDA tensors go through ``MeshHits``, whose forward launches
    ``rt_hits_fwd`` (counted in ``trace.counters["launch.k7"]``) and whose
    backward launches ``rt_hits_bwd`` (counted in ``"launch.k7.bwd"``)."""
    if rays.origin.device.type == "cpu":
        return mesh_hits_plain(scene, rays, res, hits, object_space_diffs)
    return Hits(*MeshHits.apply(
        bool(object_space_diffs), res.tri, res.inst, res.steps, scene.tr_material,
        *(getattr(scene, k) for k in GEOMETRY), scene.inst_inv, scene.inst_world, *rays,
        *hits))
