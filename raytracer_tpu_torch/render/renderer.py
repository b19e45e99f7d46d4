"""Wavefront Whitted renderer (counterpart of ``raytracer_tpu/render/renderer.py``).

Every generation traces one wavefront of rays (primary = one ray per pixel), shades
it, adds its contribution into the framebuffer weighted by the throughput along its
ancestry, and compacts the surviving reflection/refraction children into the next
generation's queue.  The recursion's post-multiplications (reflection colour,
Fresnel weights, Beer's law) are re-associated into per-ray throughput state
(``weight``, ``sigma``), exactly as in the JAX package.

Semantics are the JAX package's lossless profile (``lossless_fallback_config``): the
frame is one wavefront, every ray walks its BVH until it is done, and each queue
holds exactly the active candidates, so ``num_dropped`` is 0 by construction.  The
wide walk's stack holds the scene's proven bound unless ``wide_stack_size`` sets
a size, and ``num_incomplete`` counts only the overflow of a size so set.  The
TPU workarounds (iteration ladders, static queue capacities, scanned bounces,
chunking and checkpointing, one-hot matmul gathers) are not rebuilt.

Kernels on this path: the mesh walk, K1/K2 (``ops/traversal_wide``) or, under
``traversal_kernel="threaded"``, K10 (``ops/traversal``); K7 hit reconstruction
(``ops/hits``); K3 texture in every sampling mode (NEAREST, BILINEAR, and MIPMAP
with the TRILINEAR, ANISOTROPIC or EWA filter; ``ops/texture_sample``), K5 sky
(``ops/sky_sample``), K6 compaction (``ops/compaction``) and the framebuffer
scatter of each later generation (``ops/framebuffer``), K9 spheres and planes
(``ops/intersect``); ``present`` runs K8 FXAA (``ops/fxaa``).  On the card,
where no gradient is asked for, a generation's shading is two kernels of
``ops/shade``, and its children two kernels of ``ops/spawn`` around K6; under
autograd and on the CPU both are elementwise torch (``_surface_glue``,
``_lights_glue``, ``_spawn``, ``_compact``).

Under ``cfg.scene_shard_axis`` each rank holds part of the triangles
(``parallel/scene_shard.py``): every closest-hit record is combined by least t
and every shadow mask by OR over that axis of the mesh the sharded renderer
or train step makes active (``parallel/collectives.mesh_axes``), so shading
runs alike on every rank.

The render is differentiable (``diff/train.py``): the hit reconstruction, the
texture and the sky carry their own backward kernels (K7 bwd, K4, K5 bwd), the
rest is torch autograd, and the traversal is discrete, so its inputs are
detached as JAX stops gradients there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import devices
from ..config import AIR_IOR, RenderConfig, TextureSampleMode
from ..core import vecmath as vm
from ..ops import (
    compaction, framebuffer, fxaa, intersect, shade, sky_sample, texture_sample, traversal,
    traversal_wide,
)
from ..ops import hits as mesh_hits
from ..ops import spawn as child_rays
from ..ops.intersect import Hits, Rays
from ..parallel import collectives
from ..scene.tensors import scene_from_numpy
from ..utils import trace
from . import shading

_BEER_DIST_CLAMP = 1.0e8


class RenderStats(NamedTuple):
    """Per-category ray counters (PerformanceStats, Raytracer.h:4-9), counted per
    active lane; each a 0-dim int32 tensor."""

    num_primary: torch.Tensor
    num_shadow: torch.Tensor
    num_reflection: torch.Tensor
    num_refraction: torch.Tensor
    num_dropped: torch.Tensor  # 0 by construction: queues are exact
    num_incomplete: torch.Tensor  # rays whose traversal stack overflowed


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Primary rays
# ---------------------------------------------------------------------------


def primary_rays_for(scene, cfg: RenderConfig, pixel_idx) -> Rays:
    """Camera rays + closed-form direction differentials (Raytracer.cpp:34-59) for a
    batch of global pixel indices (row-major)."""
    i = (pixel_idx % cfg.width).to(torch.float32)
    j = (pixel_idx // cfg.width).to(torch.float32)
    direction = (
        scene.cam_x[None, :] * i[:, None]
        + scene.cam_y[None, :] * j[:, None]
        + scene.cam_top_left[None, :]
    )
    d_dot_d = vm.dot(direction, direction)
    inv_len = torch.rsqrt(d_dot_d)
    denom = (inv_len / d_dot_d)[:, None]  # d_dot_d^-3/2

    dD_dx = (
        d_dot_d[:, None] * scene.cam_x[None, :]
        - vm.dot(direction, scene.cam_x.expand(direction.shape))[:, None] * direction
    ) * denom
    dD_dy = (
        d_dot_d[:, None] * scene.cam_y[None, :]
        - vm.dot(direction, scene.cam_y.expand(direction.shape))[:, None] * direction
    ) * denom

    n = pixel_idx.shape[0]
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=direction.device)
    return Rays(
        origin=scene.cam_pos.expand(n, 3).contiguous(),
        direction=direction * inv_len[:, None],
        dO_dx=zeros,
        dO_dy=zeros,
        dD_dx=dD_dx,
        dD_dy=dD_dy,
    )


def generate_primary_rays(scene, cfg: RenderConfig) -> Rays:
    """Full-frame primary rays in row-major order."""
    idx = torch.arange(cfg.num_pixels, dtype=torch.int32, device=scene.cam_pos.device)
    return primary_rays_for(scene, cfg, idx)


# ---------------------------------------------------------------------------
# Scene intersection (Scene::trace_primitives / intersect_primitives)
# ---------------------------------------------------------------------------


def _traversal_module(cfg: RenderConfig):
    """The mesh walk ``cfg.traversal_kernel`` selects: ``"wide"`` the 8-wide BVH
    (K1/K2), any other value the threaded binary BVH (K10), as in the JAX package."""
    return traversal_wide if cfg.traversal_kernel == "wide" else traversal


def _mesh_hits_into(scene, rays: Rays, res: traversal_wide.TraceResult, hits: Hits,
                    object_space_diffs: bool = False) -> Hits:
    """Reconstruct the hit attributes from the discrete traversal ids (K7,
    ``ops/hits``): Moller-Trumbore re-derives (t, u, v) from the identified
    triangle, then the hit attribute + Ray Tracing Gems ch.20 differential
    formulas (BottomLevelBVH.cpp:260-305), merged into ``hits``."""
    return mesh_hits.mesh_hits(scene, rays, res, hits, object_space_diffs)


def trace_scene(scene, bvh, rays: Rays, active, cfg: RenderConfig):
    """Closest hit over spheres -> planes -> two-level BVH (Scene.cpp:173-177).

    Returns (Hits, incomplete [] int32)."""
    dev = rays.origin.device
    incomplete = torch.zeros((), dtype=torch.int32, device=dev)
    o, d = rays.origin.detach(), rays.direction.detach()
    if scene.n_spheres + scene.n_planes:
        # the pick (K9) is discrete; the winner's record is re-derived
        # differentiably, and its t is the pick's own
        winner, t_max = intersect.pick_closest(scene, o, d)
        hits = intersect.primitive_hits(scene, rays, winner)
    else:
        hits = intersect.make_miss_hits(rays.count, dev)
        t_max = hits.t
    if bvh is not None:
        # traversal is discrete: no gradient flows through the walk (JAX wraps it
        # in stop_gradient); the hit is re-derived differentiably from its ids
        res = _traversal_module(cfg).trace_closest(bvh, o, d, t_max, active, cfg)
        hits = _mesh_hits_into(scene, rays, res, hits,
                               object_space_diffs=cfg.differentials_object_space)
        incomplete = res.incomplete
    # lanes outside the wavefront are misses
    hits = hits._replace(hit=hits.hit & active)
    if cfg.scene_shard_axis is not None:
        hits, incomplete = _combine_hits_over_shards(hits, incomplete, cfg.scene_shard_axis)
    return hits, incomplete


# the hit record's float fields in the order they ride the shard combine; its
# integer fields (hit, material_id, bvh_steps) ride beside them as raw bits
_FLOAT_FIELDS = ("t", "point", "normal", "u", "v", "ds_dx", "ds_dy", "dt_dx", "dt_dy",
                 "dO_dx", "dO_dy", "dN_dx", "dN_dy")


def _combine_hits_over_shards(hits: Hits, incomplete, axis: str):
    """Min-t reduce reconstructed hit records across scene shards.

    The tensor-parallel mode (parallel/scene_shard.py) gives each rank along
    ``axis`` a spatial subset of the triangle geometry; every shard traverses
    the full wavefront against its sub-scene and reconstructs hit attributes
    locally (only the owner of the winning triangle can gather its attributes),
    then the per-ray winner is selected by minimum hit distance.  Misses carry
    t=inf (make_miss_hits), so any real hit beats them; ties and all-miss rays
    keep shard 0's record (``argmin`` takes the first).  Analytic primitives are
    replicated, so ties between shards are identical records.

    One collective: the record as one [N+1, 28] float row a lane (the integer
    fields' bits viewed as float, and this shard's ``incomplete`` in the extra
    row), gathered with autograd so that the gradient of each picked field
    flows back to the shard that won (``collectives.all_gather``)."""
    n = hits.t.shape[0]
    floats = torch.cat([getattr(hits, f).reshape(n, -1) for f in _FLOAT_FIELDS], dim=1)
    ints = torch.stack([hits.hit.to(torch.int32), hits.material_id.to(torch.int32),
                        hits.bvh_steps.to(torch.int32)], dim=1)
    extra = torch.zeros((1, 3), dtype=torch.int32, device=ints.device)
    extra[0, 0] = incomplete
    rows = torch.cat([
        torch.cat([floats, torch.zeros((1, floats.shape[1]), dtype=floats.dtype,
                                       device=floats.device)]),
        torch.cat([ints, extra]).view(torch.float32)], dim=1)
    g = collectives.all_gather(rows, collectives.group(axis))  # [S, N+1, 28]
    k = torch.argmin(g[:, :n, 0].detach(), dim=0)  # [N]
    win = g[:, :n].gather(0, k[None, :, None].expand(1, n, g.shape[2]))[0]
    wints = win[:, floats.shape[1]:].detach().contiguous().view(torch.int32)
    out, col = {}, 0
    for f in _FLOAT_FIELDS:  # each field contiguous again: the kernels index flat memory
        ref = getattr(hits, f)
        width = 1 if ref.dim() == 1 else ref.shape[1]
        out[f] = win[:, col:col + width].reshape(ref.shape).contiguous()
        col += width
    out.update(hit=wints[:, 0] != 0, material_id=wints[:, 1].contiguous(),
               bvh_steps=wints[:, 2].contiguous())
    incomplete = g[:, n, floats.shape[1]:].detach().contiguous().view(torch.int32)[:, 0].sum(
        dtype=torch.int32)
    return Hits(**out), incomplete


def intersect_scene(scene, bvh, origin, direction, max_distance, active, cfg):
    """Any-hit chain with early-outs (Scene.cpp:179-190).

    Returns (blocked mask, incomplete [] int32)."""
    origin, direction, max_distance = origin.detach(), direction.detach(), max_distance.detach()
    incomplete = torch.zeros((), dtype=torch.int32, device=origin.device)
    if scene.n_spheres + scene.n_planes:
        blocked = intersect.pick_any(scene, origin, direction, max_distance, active)
    else:
        blocked = torch.zeros_like(active)
    if bvh is not None:
        found, incomplete = _traversal_module(cfg).trace_any(
            bvh, origin, direction, max_distance, active & ~blocked, cfg
        )
        blocked = blocked | found
    if cfg.scene_shard_axis is not None:
        # a lane is shadowed if ANY scene shard's sub-geometry blocks it: one
        # all-reduce of the blocked lanes with this shard's incomplete count
        summed = collectives.all_reduce_sum(
            torch.cat([blocked.to(torch.int32), incomplete.reshape(1).to(torch.int32)]),
            collectives.group(cfg.scene_shard_axis))
        blocked, incomplete = summed[:-1] > 0, summed[-1]
    return blocked & active, incomplete


# ---------------------------------------------------------------------------
# One bounce generation
# ---------------------------------------------------------------------------


class _Generation(NamedTuple):
    rays: Rays
    weight: torch.Tensor  # [N,3] throughput
    sigma: torch.Tensor  # [N,3] Beer absorption for this segment (<= 0)
    pixel: torch.Tensor  # [N] int32 framebuffer index
    active: torch.Tensor  # [N] bool


def _material_gather(scene, mid):
    """Per-lane material rows: a plain gather (the JAX package's one-hot matmul
    computes the same rows)."""
    return (
        scene.mat_diffuse.index_select(0, mid),
        scene.mat_reflection.index_select(0, mid),
        scene.mat_transmittance.index_select(0, mid),
        scene.mat_ior.index_select(0, mid),
        scene.mat_texture.index_select(0, mid),
    )


def _tex_tuple(scene):
    return (scene.tex_data, scene.tex_width, scene.tex_height, scene.tex_levels,
            scene.tex_offsets, scene.tex_quad)


# the scene's fields that shading reads: a gradient asked of any of them keeps
# the generation on the glue, which autograd records
_SHADING_FIELDS = ("mat_diffuse", "mat_reflection", "mat_transmittance", "mat_ior", "tex_data",
                   "sky_data", "cam_pos", "ambient", "pl_pos", "pl_colour", "sl_pos",
                   "sl_colour", "sl_neg_dir", "sl_inner", "sl_outer", "dl_neg_dir", "dl_colour")


def _wants_grad(scene, gen: _Generation, hits: Hits, fb, tex4) -> bool:
    """Whether autograd would record the generation's shading or its children:
    grad mode is on and one of their inputs asks for a gradient."""
    if not torch.is_grad_enabled():
        return False
    inputs = (fb, tex4, gen.weight, gen.sigma, *gen.rays, *hits,
              *(getattr(scene, f) for f in _SHADING_FIELDS))
    return any(x is not None and x.requires_grad for x in inputs)


def _surface_glue(scene, gen: _Generation, hits: Hits, cfg, tex4) -> shade.Surface:
    """The surface terms of a generation in torch ops (``shade.surface`` on the
    card): the plain version that the CPU and a render under autograd run."""
    rays = gen.rays
    n = rays.count
    dev = rays.origin.device
    hit = hits.hit
    # Beer's law along this segment (evaluated at the child level)
    t_seg = torch.clamp_max(torch.where(hit, hits.t, float("inf")), _BEER_DIST_CLAMP)
    beer = torch.exp(gen.sigma * t_seg[:, None])
    w = gen.weight * beer

    # sky on miss (Raytracer.cpp:104-111), added with the surface term
    miss = gen.active & ~hit
    sky_rgb = sky_sample.sample_sky(scene.sky_data, rays.direction)
    contribution = torch.where(miss[:, None], w * sky_rgb, 0.0)

    # material albedo: per-lane gather + texture filter (Raytracer.cpp:117-141)
    mid = torch.where(hit, hits.material_id, 0)
    diffuse_c, refl_c, trans_c, ior, tex_id = _material_gather(scene, mid)
    if scene.tex_data.shape[0] > 1:
        albedo = diffuse_c * texture_sample.sample(
            _tex_tuple(scene), tex_id, hits.u, hits.v, hits.ds_dx, hits.ds_dy,
            hits.dt_dx, hits.dt_dy, cfg, data4=tex4,
        )
    else:
        # no textures in the scene (the atlas is the white texel)
        albedo = diffuse_c
    albedo = torch.where(hit[:, None], albedo, 0.0)
    shadow_active = vm.length_squared(albedo) > 0.0  # already implies hit

    # direct lighting; all lights' shadow rays in ONE any-hit launch
    to_camera = vm.normalize(scene.cam_pos[None, :] - hits.point, eps=1e-20)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    # shadow rays only where the light could contribute (front-facing, inside
    # the spot cone): culling is result-identical (Light.h:15-19)
    dirs, dists, contribs = [], [], []
    for i in range(scene.n_point_lights):
        to_l = scene.pl_pos[i][None, :] - hits.point
        d2 = vm.length_squared(to_l)
        dist = torch.sqrt(d2)
        to_l = to_l / dist[:, None]
        dirs.append(to_l)
        dists.append(dist)
        contribs.append(shading.point_light(
            hits.normal, to_l, to_camera, scene.pl_colour[i][None, :], d2))
    for i in range(scene.n_spot_lights):
        to_l = scene.sl_pos[i][None, :] - hits.point
        d2 = vm.length_squared(to_l)
        dist = torch.sqrt(d2)
        to_l = to_l / dist[:, None]
        dirs.append(to_l)
        dists.append(dist)
        contribs.append(shading.spot_light(
            hits.normal, to_l, to_camera, scene.sl_colour[i][None, :], d2,
            scene.sl_neg_dir[i][None, :], scene.sl_inner[i], scene.sl_outer[i]))
    for i in range(scene.n_directional_lights):
        dirs.append(scene.dl_neg_dir[i].expand(hits.point.shape))
        dists.append(inf)
        contribs.append(shading.directional_light(
            hits.normal, to_camera, scene.dl_colour[i][None, :], scene.dl_neg_dir[i]))

    shadow = num_shadow = None
    if contribs:
        n_lights = len(contribs)
        origin = hits.point
        if cfg.shadow_normal_offset:
            origin = origin + cfg.shadow_normal_offset * hits.normal
        contrib_mask = torch.stack([vm.length_squared(c) > 0.0 for c in contribs], dim=0)  # [L,N]
        shadow = (origin.repeat(n_lights, 1), torch.cat(dirs).contiguous(), torch.cat(dists),
                  shadow_active.repeat(n_lights) & contrib_mask.reshape(-1))
        num_shadow = _count(shadow_active[None, :] & contrib_mask)
    return shade.Surface(w=w, refl_c=refl_c, trans_c=trans_c, ior=ior, miss=contribution,
                         w_albedo=w * albedo, shadow_active=shadow_active, contribs=contribs,
                         shadow=shadow, num_shadow=num_shadow)


def _lights_glue(scene, surf: shade.Surface, blocked, stats, incomplete, shadow_incomplete):
    """The lights' sum of a generation in torch ops (``shade.lights`` on the
    card): returns (each lane's contribution to its pixel [N,3], stats)."""
    n = surf.w.shape[0]
    stats = stats._replace(num_incomplete=stats.num_incomplete + incomplete)
    light_acc = torch.zeros((n, 3), dtype=torch.float32, device=surf.w.device) + scene.ambient
    if surf.shadow is not None:
        stats = stats._replace(num_incomplete=stats.num_incomplete + shadow_incomplete)
        blocked = blocked.reshape(len(surf.contribs), n)
        for li, c in enumerate(surf.contribs):
            light_acc = light_acc + torch.where(
                (surf.shadow_active & ~blocked[li])[:, None], c, 0.0)
        stats = stats._replace(num_shadow=stats.num_shadow + surf.num_shadow)
    return surf.miss + surf.w_albedo * light_acc, stats


def _shade_generation(scene, bvh, gen: _Generation, fb, spawn: bool, cfg, stats,
                      tex4=None, identity_pixels: bool = False):
    """Trace + shade one generation; returns (fb, its children or None, stats),
    the children as ``_next_queue`` takes them.

    ``identity_pixels`` declares gen.pixel == arange(n) (generation 0): the
    framebuffer accumulation is then a dense add instead of a scatter-add.

    The shading and the children take one of two paths, by what they can
    observe: on CUDA tensors, when autograd would record nothing
    (``_wants_grad``), the kernels of ``ops/shade`` (``shade.surface``,
    ``shade.lights``) and ``ops/spawn`` (``child_rays.flags``); otherwise the
    torch glue (``_surface_glue``, ``_lights_glue``, ``_spawn``), their plain
    version.

    Its stages tile it, each a span: ``rt.trace`` (the closest hits),
    ``rt.shade`` (the surface and the shadow rays' operands, then the lights'
    sum past the shadow rays), ``rt.shadow`` (every light's shadow rays in one
    any-hit call) and ``rt.spawn`` (the children).  A stage deletes its
    temporaries before its span closes, so that they are freed inside it."""
    rays = gen.rays
    with trace.span("rt.trace"):
        hits, incomplete = trace_scene(scene, bvh, rays, gen.active, cfg)

    def fb_add(fb, contribution):
        if identity_pixels:
            return fb + contribution
        return framebuffer.accumulate(fb, gen.pixel, contribution)

    with trace.span("rt.shade"):
        if cfg.visualize_heatmap:
            stats = stats._replace(num_incomplete=stats.num_incomplete + incomplete)
            # Raytracer.cpp:97-102: steps scaled by (1/32, 1/256, 1/512)
            steps = hits.bvh_steps.to(torch.float32)
            heat = torch.stack([steps / 32.0, steps / 256.0, steps / 512.0], dim=-1)
            return fb_add(fb, torch.where(gen.active[:, None], heat, 0.0)), None, stats
        fused = fb.device.type == "cuda" and not _wants_grad(scene, gen, hits, fb, tex4)
        if fused:
            surf = shade.surface(scene, hits, rays.direction, gen.weight, gen.sigma, gen.active,
                                 cfg, tex4)
        else:
            surf = _surface_glue(scene, gen, hits, cfg, tex4)

    blocked = shadow_incomplete = None
    if surf.shadow is not None:
        with trace.span("rt.shadow"):
            blocked, shadow_incomplete = intersect_scene(scene, bvh, *surf.shadow, cfg)

    with trace.span("rt.shade"):
        if fused:
            fb, num_shadow, num_incomplete = shade.lights(
                scene.ambient, surf, blocked, fb, None if identity_pixels else gen.pixel,
                stats.num_shadow, stats.num_incomplete, incomplete, shadow_incomplete)
            stats = stats._replace(num_shadow=num_shadow, num_incomplete=num_incomplete)
        else:
            contribution, stats = _lights_glue(scene, surf, blocked, stats, incomplete,
                                               shadow_incomplete)
            fb = fb_add(fb, contribution)
        w, refl_c, trans_c, ior = surf.w, surf.refl_c, surf.trans_c, surf.ior
        del surf, blocked

    if not spawn:
        return fb, None, stats

    # ---- spawn reflection / refraction children (Raytracer.cpp:204-396) ----
    with trace.span("rt.spawn"):
        if fused:
            cand = child_rays.flags(rays, gen.pixel, hits, w, refl_c, trans_c, ior)
        else:
            cand, stats = _spawn(gen, hits, w, refl_c, trans_c, ior, stats)
        del hits, w, refl_c, trans_c, ior
    return fb, cand, stats


def _spawn(gen: _Generation, hits: Hits, w, refl_c, trans_c, ior, stats):
    """The reflection and refraction children of a generation's hits
    (Raytracer.cpp:204-396), ``w`` the throughput through this segment and the
    rest the hits' material: (candidates, the first the reflections, then the
    refractions, each with its ``active`` flag; stats)."""
    rays = gen.rays
    n = rays.count
    hit = hits.hit
    refl_flag = hit & (vm.length_squared(refl_c) > 0.0)
    refr_flag = hit & (vm.length_squared(trans_c) > 0.0)

    d = rays.direction
    nrm = hits.normal
    dot_dn = vm.dot(d, nrm)
    entering = dot_dn < 0.0  # dot_mask (Raytracer.cpp:275)

    n1 = torch.where(entering, AIR_IOR, ior)
    n2 = torch.where(entering, ior, AIR_IOR)
    cos_theta = torch.where(entering, -dot_dn, dot_dn)
    n_oriented = torch.where(entering[:, None], nrm, -nrm)
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
    tir = refr_flag & (k < 0.0)

    refr_dir = vm.refract(d, n_oriented, eta, cos_theta, k)

    # Schlick Fresnel (Raytracer.cpp:378-391)
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_f = torch.where(n1 > n2, -vm.dot(refr_dir, n_oriented), cos_theta)
    omc = 1.0 - cos_f
    omc2 = omc * omc
    f_r = r0 + ((1.0 - r0) * omc2) * (omc2 * omc)
    f_t = 1.0 - f_r

    # reflection child
    refl_dir = vm.reflect(d, nrm)
    refl_coeff = refl_c * (
        1.0 + torch.where(refr_flag, torch.where(tir, 1.0, f_r), 0.0)[:, None]
    )
    w_refl = w * refl_coeff

    # Igehy reflection differentials (Raytracer.cpp:254-262)
    ddn_dx = vm.dot(rays.dD_dx, nrm) + vm.dot(d, hits.dN_dx)
    ddn_dy = vm.dot(rays.dD_dy, nrm) + vm.dot(d, hits.dN_dy)
    refl_dD_dx = rays.dD_dx - 2.0 * (dot_dn[:, None] * hits.dN_dx + ddn_dx[:, None] * nrm)
    refl_dD_dy = rays.dD_dy - 2.0 * (dot_dn[:, None] * hits.dN_dy + ddn_dy[:, None] * nrm)

    # Igehy refraction differentials (Raytracer.cpp:325-342)
    d_dot_n = -cos_theta
    dprime_dot_n = -vm.safe_sqrt(k)
    mu = -(eta * cos_theta + dprime_dot_n)
    refr_dD_dx = eta[:, None] * rays.dD_dx - (
        (mu * d_dot_n)[:, None] + vm.dot(hits.dN_dx, nrm)[:, None] * nrm
    ) * ddn_dx[:, None]
    refr_dD_dy = eta[:, None] * rays.dD_dy - (
        (mu * d_dot_n)[:, None] + vm.dot(hits.dN_dy, nrm)[:, None] * nrm
    ) * ddn_dy[:, None]

    refr_active = refr_flag & ~tir
    w_refr = w * f_t[:, None]
    refr_sigma = torch.where((refr_active & entering)[:, None], trans_c - 1.0, 0.0)

    stats = stats._replace(
        num_reflection=stats.num_reflection + _count(refl_flag),
        num_refraction=stats.num_refraction + _count(refr_active),
    )

    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=rays.origin.device)
    cand = dict(
        origin=torch.cat([hits.point, hits.point]),
        direction=torch.cat([refl_dir, refr_dir]),
        dO_dx=torch.cat([hits.dO_dx, hits.dO_dx]),
        dO_dy=torch.cat([hits.dO_dy, hits.dO_dy]),
        dD_dx=torch.cat([refl_dD_dx, refr_dD_dx]),
        dD_dy=torch.cat([refl_dD_dy, refr_dD_dy]),
        weight=torch.cat([w_refl, w_refr]),
        sigma=torch.cat([zeros3, refr_sigma]),
        pixel=torch.cat([gen.pixel, gen.pixel]),
        active=torch.cat([refl_flag, refr_active]),
    )
    return cand, stats


def _next_queue(cand, stats):
    """The next generation and the stats from a generation's children: the
    glue's candidates compacted by ``_compact``, or the flagged parents of
    ``child_rays.flags`` through K6 and ``child_rays.write``, which also adds
    the children to the stats."""
    if isinstance(cand, dict):
        return _compact(cand), stats
    q = child_rays.children(cand, stats.num_reflection, stats.num_refraction)
    return (_Generation(rays=q.rays, weight=q.weight, sigma=q.sigma, pixel=q.pixel,
                        active=q.active),
            stats._replace(num_reflection=q.num_reflection, num_refraction=q.num_refraction))


def _compact(cand: dict) -> _Generation:
    """Stable-compact the active child candidates into the next generation's queue
    (K6); the queue holds exactly the active candidates, in candidate order."""
    sel, _n_active = compaction.compact(cand["active"])
    out = {k: v.index_select(0, sel) for k, v in cand.items()}
    return _Generation(
        rays=Rays(origin=out["origin"], direction=out["direction"], dO_dx=out["dO_dx"],
                  dO_dy=out["dO_dy"], dD_dx=out["dD_dx"], dD_dy=out["dD_dy"]),
        weight=out["weight"],
        sigma=out["sigma"],
        pixel=out["pixel"],
        active=out["active"],
    )


# ---------------------------------------------------------------------------
# Top-level render
# ---------------------------------------------------------------------------


def _build_tables(scene, cfg: RenderConfig, bvh=None, tex4=None):
    """(bvh, tex4): the frame's traversal table and quad atlas, each built from
    the scene where not given (no table without instances; no quad atlas
    under NEAREST, which reads only the base atlas, as in the JAX package)."""
    if bvh is None and scene.n_instances > 0:
        bvh = _traversal_module(cfg).build_scene_bvh(scene)
    if (tex4 is None and scene.tex_data.shape[0] > 1
            and cfg.texture_sample_mode != TextureSampleMode.NEAREST):
        tex4 = texture_sample.expand_quads(_tex_tuple(scene))
    return bvh, tex4


def render_wavefront(scene, cfg: RenderConfig, pixel_idx=None, bvh=None, tex4=None):
    """Render a batch of pixels as one wavefront; returns (rgb [n,3], RenderStats).

    ``pixel_idx`` [n] int32 holds global row-major pixel indices in any order
    (default: the whole frame); row k of the result is pixel ``pixel_idx[k]``.
    Negative indices are padding lanes: they trace nothing and contribute zero.
    ``bvh`` and ``tex4`` are the frame's traversal table and quad atlas, built
    here when not given (``_build_tables``).

    The call is span ``rt.render``, tiled by ``rt.tables`` (the tables built
    here), ``rt.primary`` (the stats, the primary rays and the buffers) and one
    ``rt.gen`` a generation: ``_shade_generation``'s stages, then ``rt.compact``
    (the next queue)."""
    n = cfg.num_pixels if pixel_idx is None else pixel_idx.shape[0]
    with trace.span("rt.render"):
        return _render(scene, cfg, n, pixel_idx, lambda: _build_tables(scene, cfg, bvh, tex4))


def _render(scene, cfg: RenderConfig, n: int, pixel_idx, tables):
    """``render_wavefront`` inside its span, ``tables()`` giving (bvh, tex4)
    inside ``rt.tables``: everything this frame makes is freed by the time the
    span ends."""
    with trace.span("rt.tables"):
        bvh, tex4 = tables()
    with trace.span("rt.primary"):
        dev = scene.cam_pos.device
        if pixel_idx is None:
            pixel_idx = torch.arange(n, dtype=torch.int32, device=dev)
        lane_active = pixel_idx >= 0
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        stats = RenderStats(
            num_primary=_count(lane_active), num_shadow=zero, num_reflection=zero,
            num_refraction=zero, num_dropped=zero, num_incomplete=zero,
        )
        gen = _Generation(
            rays=primary_rays_for(scene, cfg, torch.clamp_min(pixel_idx, 0)),
            weight=torch.ones((n, 3), dtype=torch.float32, device=dev),
            sigma=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            pixel=torch.arange(n, dtype=torch.int32, device=dev),
            active=lane_active,
        )
        fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    depth = 0 if cfg.visualize_heatmap else cfg.num_bounces
    for bounce in range(depth + 1):
        with trace.span("rt.gen"):
            fb, cand, stats = _shade_generation(
                scene, bvh, gen, fb, bounce < depth, cfg, stats, tex4=tex4,
                identity_pixels=bounce == 0,
            )
            if cand is None:
                break
            with trace.span("rt.compact"):
                gen, stats = _next_queue(cand, stats)
                del cand
        if gen.pixel.shape[0] == 0:
            break
    return fb, stats


def render_pixels(scene, cfg: RenderConfig, pixel_idx):
    """Render an arbitrary pixel batch as one wavefront; returns (rgb [n,3],
    RenderStats).  Kept under the JAX package's name so that code written
    against ``raytracer_tpu.render.renderer.render_pixels`` (``render_loss``
    among it) ports line for line; it is ``render_wavefront`` with a batch.  The
    JAX package cuts the batch into ``lax.map`` chunks to bound its program
    size; a CUDA wavefront has no such limit."""
    return render_wavefront(scene, cfg, pixel_idx)


def render_with_stats(scene, cfg: RenderConfig):
    """Render one full frame; returns (linear [H,W,3] image, RenderStats)."""
    fb, stats = render_wavefront(scene, cfg)
    return fb.reshape(cfg.height, cfg.width, 3), stats


def present(image, cfg: RenderConfig):
    """Post pass: FXAA + gamma (K8), or plain gamma — the fullscreen shader stage
    (Window.cpp:52-63, fragment_fxaa.glsl / fragment_identity.glsl); span
    ``rt.present``."""
    with trace.span("rt.present"):
        if cfg.enable_fxaa:
            return fxaa.fxaa(image)
        return torch.clamp(image, 0.0, 1.0) ** (1.0 / 2.2)


def render(scene, cfg: RenderConfig):
    """Render one frame -> linear [H,W,3] image."""
    return render_with_stats(scene, cfg)[0]


def render_frames(scenes, cfg: RenderConfig):
    """Render a list of uploaded frames; returns (images [N,H,W,3], RenderStats
    whose counters carry a leading [N] axis), as the JAX package's
    ``render_frames`` returns them.  The JAX version renders a stacked batch in
    one dispatch to amortise the TPU runtime's per-dispatch round trip; a CUDA
    launch has no such cost, so this is a plain loop over the frames."""
    images, stats = zip(*(render_with_stats(s, cfg) for s in scenes))
    return torch.stack(images), RenderStats(*(torch.stack(c) for c in zip(*stats)))


def _table_key(scene, cfg: RenderConfig):
    """What the frame's tables are built from: (objects, values), or None where
    a tensor keeps no version counter (an inference tensor).  The objects are
    ``cfg`` and the tensors of the walk's ``TABLE_FIELDS`` and of
    ``texture_sample.QUAD_FIELDS``, compared by identity (holding them keeps
    their storage from being reused); the values are the instance count, each
    tensor's ``_version`` (bumped by any in-place write, through a view or a
    detached alias too) and the Python ints among the fields."""
    objs, vals = [cfg], [scene.n_instances]
    for f in (*_traversal_module(cfg).TABLE_FIELDS, *texture_sample.QUAD_FIELDS):
        x = getattr(scene, f)
        if not torch.is_tensor(x):
            vals.append(x)
        elif x.is_inference():
            return None
        else:
            objs.append(x)
            vals.append(x._version)
    return objs, vals


def _same_key(key, old) -> bool:
    return (old is not None and len(key[0]) == len(old[0])
            and all(a is b for a, b in zip(key[0], old[0])) and key[1] == old[1])


class Renderer:
    """Entry point: renders packed scenes on one device (``cuda`` by default;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels).

    A frame's tables (the walk's ``bvh`` and the quad atlas ``tex4``) depend on
    the scene alone: the renderer keeps the last scene's, and builds them again
    only when a tensor they are built from is another object or was written in
    place (``_table_key``).  A camera moved through a resident scene
    (``scene._replace`` of the ``cam_*`` fields) reuses them; a scene uploaded
    anew builds.  ``trace.counters["tables.build"]`` and ``["tables.reuse"]``
    count the two."""

    def __init__(self, cfg: RenderConfig, device=None):
        self.cfg = cfg
        self.device = devices.resolve(device)
        self._key = self._tables = None  # the last scene's table key and (bvh, tex4)

    def _scene_tables(self, scene):
        """(bvh, tex4) of ``scene``: the kept ones while its key matches, else
        built (the old ones dropped first, so that one set at most is held)."""
        key = _table_key(scene, self.cfg)
        if key is not None and _same_key(key, self._key):
            trace.count("tables.reuse")
            return self._tables
        self._key = self._tables = None
        tables = _build_tables(scene, self.cfg)
        trace.count("tables.build")
        if key is not None:
            self._key, self._tables = key, tables
        return tables

    def upload(self, packed):
        """A packed scene (``ScenePacker.frame()``, or any mapping of its fields)
        as tensors on this renderer's device (span ``rt.app.upload``)."""
        with trace.span("rt.app.upload"):
            fields = packed._asdict() if hasattr(packed, "_asdict") else packed
            return scene_from_numpy(fields, self.device)

    def __call__(self, scene):
        """(linear [H,W,3] image, RenderStats) of one frame, forward only: the
        frame of ``render_with_stats``, its tables from ``_scene_tables``."""
        cfg = self.cfg
        with torch.no_grad():
            with trace.span("rt.render"):
                fb, stats = _render(scene, cfg, cfg.num_pixels, None,
                                    lambda: self._scene_tables(scene))
        return fb.reshape(cfg.height, cfg.width, 3), stats
