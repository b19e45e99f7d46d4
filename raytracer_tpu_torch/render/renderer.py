"""Wavefront Whitted renderer (counterpart of ``raytracer_tpu/render/renderer.py``).

Every generation traces one wavefront of rays (primary = one ray per pixel), shades
it, adds its contribution into the framebuffer weighted by the throughput along its
ancestry, and compacts the surviving reflection/refraction children into the next
generation's queue.  The recursion's post-multiplications (reflection colour,
Fresnel weights, Beer's law) are re-associated into per-ray throughput state
(``weight``, ``sigma``), exactly as in the JAX package.

Semantics are the JAX package's lossless profile (``lossless_fallback_config``): the
frame is one wavefront, every ray walks its BVH until it is done, and each queue
holds exactly the active candidates, so ``num_dropped`` is 0 by construction and
``num_incomplete`` counts stack overflow only.  The TPU workarounds (iteration
ladders, static queue capacities, scanned bounces, chunking and checkpointing,
one-hot matmul gathers) are not rebuilt.

Kernels on this path: the mesh walk, K1/K2 (``ops/traversal_wide``) or, under
``traversal_kernel="threaded"``, K10 (``ops/traversal``); K7 hit reconstruction
(``ops/hits``); K3 texture in every sampling mode (NEAREST, BILINEAR, and MIPMAP
with the TRILINEAR, ANISOTROPIC or EWA filter; ``ops/texture_sample``), K5 sky
(``ops/sky_sample``), K6 compaction (``ops/compaction``), K9 spheres and planes
(``ops/intersect``); ``present`` runs K8 FXAA (``ops/fxaa``).  Everything else
is elementwise torch.

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
    compaction, fxaa, intersect, sky_sample, texture_sample, traversal, traversal_wide,
)
from ..ops import hits as mesh_hits
from ..ops.intersect import Hits, Rays
from ..scene.tensors import scene_from_numpy
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
    return hits._replace(hit=hits.hit & active), incomplete


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


def _shade_generation(scene, bvh, gen: _Generation, fb, spawn: bool, cfg, stats,
                      tex4=None, identity_pixels: bool = False):
    """Trace + shade one generation; returns (fb, child candidates or None, stats).

    ``identity_pixels`` declares gen.pixel == arange(n) (generation 0): the
    framebuffer accumulation is then a dense add instead of a scatter-add."""
    rays = gen.rays
    n = rays.count
    dev = rays.origin.device
    hits, incomplete = trace_scene(scene, bvh, rays, gen.active, cfg)
    stats = stats._replace(num_incomplete=stats.num_incomplete + incomplete)
    hit = hits.hit

    def fb_add(fb, contribution):
        if identity_pixels:
            return fb + contribution
        return fb.index_add_(0, gen.pixel, contribution)

    if cfg.visualize_heatmap:
        # Raytracer.cpp:97-102: steps scaled by (1/32, 1/256, 1/512)
        steps = hits.bvh_steps.to(torch.float32)
        heat = torch.stack([steps / 32.0, steps / 256.0, steps / 512.0], dim=-1)
        return fb_add(fb, torch.where(gen.active[:, None], heat, 0.0)), None, stats

    # Beer's law along this segment (evaluated at the child level)
    t_seg = torch.clamp_max(torch.where(hit, hits.t, float("inf")), _BEER_DIST_CLAMP)
    beer = torch.exp(gen.sigma * t_seg[:, None])
    w = gen.weight * beer

    # sky on miss (Raytracer.cpp:104-111), added with the surface term below
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
    diffuse_mask = vm.length_squared(albedo) > 0.0

    # direct lighting; all lights' shadow rays in ONE any-hit launch
    to_camera = vm.normalize(scene.cam_pos[None, :] - hits.point, eps=1e-20)
    light_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev) + scene.ambient
    shadow_active = diffuse_mask  # already implies hit
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)

    n_lights = scene.n_point_lights + scene.n_spot_lights + scene.n_directional_lights
    if n_lights:
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
        shadow_origin = hits.point
        if cfg.shadow_normal_offset:
            shadow_origin = shadow_origin + cfg.shadow_normal_offset * hits.normal
        contrib_mask = torch.stack(
            [vm.length_squared(c) > 0.0 for c in contribs], dim=0
        )  # [L,N]
        blocked, shadow_incomplete = intersect_scene(
            scene, bvh,
            shadow_origin.repeat(n_lights, 1),
            torch.cat(dirs).contiguous(),
            torch.cat(dists),
            shadow_active.repeat(n_lights) & contrib_mask.reshape(-1),
            cfg,
        )
        blocked = blocked.reshape(n_lights, n)
        stats = stats._replace(num_incomplete=stats.num_incomplete + shadow_incomplete)
        for li in range(n_lights):
            light_acc = light_acc + torch.where(
                (shadow_active & ~blocked[li])[:, None], contribs[li], 0.0
            )
        stats = stats._replace(
            num_shadow=stats.num_shadow + _count(shadow_active[None, :] & contrib_mask)
        )

    fb = fb_add(fb, contribution + w * albedo * light_acc)

    if not spawn:
        return fb, None, stats

    # ---- spawn reflection / refraction children (Raytracer.cpp:204-396) ----
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

    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
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
    return fb, cand, stats


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


def render_wavefront(scene, cfg: RenderConfig, pixel_idx=None, bvh=None, tex4=None):
    """Render a batch of pixels as one wavefront; returns (rgb [n,3], RenderStats).

    ``pixel_idx`` [n] int32 holds global row-major pixel indices in any order
    (default: the whole frame); row k of the result is pixel ``pixel_idx[k]``.
    Negative indices are padding lanes: they trace nothing and contribute zero.
    ``bvh`` and ``tex4`` are the frame's traversal table and quad atlas, built
    here when not given (no quad atlas under NEAREST, which reads only the base
    atlas, as in the JAX package)."""
    dev = scene.cam_pos.device
    if pixel_idx is None:
        pixel_idx = torch.arange(cfg.num_pixels, dtype=torch.int32, device=dev)
    n = pixel_idx.shape[0]
    lane_active = pixel_idx >= 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    stats = RenderStats(
        num_primary=_count(lane_active), num_shadow=zero, num_reflection=zero,
        num_refraction=zero, num_dropped=zero, num_incomplete=zero,
    )
    if bvh is None and scene.n_instances > 0:
        bvh = _traversal_module(cfg).build_scene_bvh(scene)
    if (tex4 is None and scene.tex_data.shape[0] > 1
            and cfg.texture_sample_mode != TextureSampleMode.NEAREST):
        tex4 = texture_sample.expand_quads(_tex_tuple(scene))

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
        fb, cand, stats = _shade_generation(
            scene, bvh, gen, fb, bounce < depth, cfg, stats, tex4=tex4,
            identity_pixels=bounce == 0,
        )
        if cand is None:
            break
        gen = _compact(cand)
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
    (Window.cpp:52-63, fragment_fxaa.glsl / fragment_identity.glsl)."""
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


class Renderer:
    """Entry point: renders packed scenes on one device (``cuda`` by default;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels)."""

    def __init__(self, cfg: RenderConfig, device=None):
        self.cfg = cfg
        self.device = devices.resolve(device)

    def upload(self, packed):
        """A packed scene (``ScenePacker.frame()``, or any mapping of its fields)
        as tensors on this renderer's device."""
        fields = packed._asdict() if hasattr(packed, "_asdict") else packed
        return scene_from_numpy(fields, self.device)

    def __call__(self, scene):
        """(linear [H,W,3] image, RenderStats) of one frame, forward only."""
        with torch.no_grad():
            return render_with_stats(scene, self.cfg)
