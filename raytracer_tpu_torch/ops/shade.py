"""The shading of a generation on the card, forward only: the glue between the
generation's kernels as two hand-written CUDA launches (``csrc/shade.cu``).

``surface`` runs after the closest-hit trace: Beer's law, the sky term on
misses, the material rows and albedo (K5 and K3 beside it, K3 fed by
``tex_ids``), every light's Blinn-Phong term, and the any-hit call's operands
in its [L*N] layout.  ``lights`` runs after the any-hit call: the ambient and
unblocked lights' terms, added into the frame, and the generation's shadow
and incomplete counts.  Launches count in
``trace.counters["launch.shade.surface"]``, ``"launch.shade.lights"`` and
``"launch.shade.tex_id"``.

The renderer takes this path on CUDA tensors when no shading input asks for
a gradient.  Its plain versions are ``render/renderer.py``'s
``_surface_glue`` and ``_lights_glue``, the torch ops that the CPU and a
render under autograd run; on the card the two give the same bits, but for
the order of the framebuffer scatter's atomics.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..config import RenderConfig
from ..utils import trace
from . import framebuffer, sky_sample, texture_sample
from .intersect import Hits

BLOCK = 256  # csrc/shade.cu kBlock: the surface writes one shadow-ray count a block
# the scene's tables that rt_shade_surface reads, float32, in its order
SURFACE_TABLES = ("mat_diffuse", "mat_reflection", "mat_transmittance", "mat_ior", "cam_pos",
                  "pl_pos", "pl_colour", "sl_pos", "sl_colour", "sl_neg_dir", "sl_inner",
                  "sl_outer", "dl_neg_dir", "dl_colour")


class Surface(NamedTuple):
    """A generation's surface terms, as the lights' sum and the children take
    them (the kernel's outputs, or the glue's tensors)."""

    w: torch.Tensor  # [N,3] throughput through this segment (Beer's law)
    refl_c: torch.Tensor  # [N,3] the hits' material rows, for the children
    trans_c: torch.Tensor  # [N,3]
    ior: torch.Tensor  # [N]
    miss: torch.Tensor  # [N,3] the sky term on misses, 0 elsewhere
    w_albedo: torch.Tensor  # [N,3] w * albedo
    shadow_active: torch.Tensor  # [N] bool: a surface with a diffuse colour was hit
    contribs: object  # each light's unshadowed [N,3] term: [L,N,3] (the glue: a list)
    # (origin [L*N,3], direction [L*N,3], distance [L*N], active [L*N] bool):
    # the any-hit call's operands, light-major; None without a light
    shadow: Optional[tuple]
    # int32 counts of the shadow rays traced, which the lights' step sums: one
    # a block of lanes (the glue: one); None without a light
    num_shadow: Optional[torch.Tensor]


def _blocks(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK


def tex_ids(scene, hits: Hits) -> torch.Tensor:
    """[N] int32 texture id of each lane's material (material 0 where it
    missed): one ``rt_shade_tex_id`` launch (``"launch.shade.tex_id"``)."""
    n = hits.hit.shape[0]
    dev = hits.hit.device
    kernels.require_lanes("rt_shade_tex_id", n,
                          {"hit": (hits.hit, torch.bool),
                           "material_id": (hits.material_id, torch.int32)},
                          {"mat_texture": (scene.mat_texture, torch.int32)}, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    P, I = kernels.P, kernels.I
    fn = kernels.entry("shade", "rt_shade_tex_id", [P, P, P, I, P, P])
    err = fn(hits.hit.data_ptr(), hits.material_id.data_ptr(), scene.mat_texture.data_ptr(), n,
             out.data_ptr(), kernels.stream_ptr(dev))
    trace.count("launch.shade.tex_id")
    kernels.check(err, "rt_shade_tex_id")
    return out


def surface_launch(scene, hits: Hits, weight, sigma, active, sky_rgb, tex,
                   cfg: RenderConfig) -> Surface:
    """One ``rt_shade_surface`` launch (``"launch.shade.surface"``) on the
    generation's hits, its rays' ``weight``, ``sigma`` and ``active``, K5's sky radiance ``sky_rgb`` [N,3] and K3's filtered texels
    ``tex`` [N,3] (None: no textures, the albedo is the diffuse colour)."""
    n = hits.hit.shape[0]
    dev = hits.hit.device
    f32 = torch.float32
    lane = {"hit": (hits.hit, torch.bool), "t": (hits.t, f32),
            "material_id": (hits.material_id, torch.int32), "point": (hits.point, f32),
            "normal": (hits.normal, f32), "weight": (weight, f32), "sigma": (sigma, f32), "active": (active, torch.bool),
            "sky": (sky_rgb, f32)}
    if tex is not None:
        lane["tex"] = (tex, f32)
    tables = [getattr(scene, f) for f in SURFACE_TABLES]
    kernels.require_lanes("rt_shade_surface", n, lane,
                          {f: (x, f32) for f, x in zip(SURFACE_TABLES, tables)}, dev)
    n_point, n_spot = scene.n_point_lights, scene.n_spot_lights
    n_dir = scene.n_directional_lights
    n_lights = n_point + n_spot + n_dir

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    shadow = None
    if n_lights:
        shadow = (empty(n_lights * n, 3), empty(n_lights * n, 3), empty(n_lights * n),
                  empty(n_lights * n, dtype=torch.bool))
    surf = Surface(w=empty(n, 3), refl_c=empty(n, 3), trans_c=empty(n, 3), ior=empty(n),
                   miss=empty(n, 3), w_albedo=empty(n, 3),
                   shadow_active=empty(n, dtype=torch.bool), contribs=empty(n_lights, n, 3),
                   shadow=shadow,
                   num_shadow=empty(_blocks(n), dtype=torch.int32) if n_lights else None)
    if n == 0:
        return surf
    arr = kernels.pointers([
        active, weight, sigma, hits.hit, hits.t, hits.material_id, hits.point, hits.normal,
        sky_rgb, tex, *tables, surf.w, surf.refl_c, surf.trans_c, surf.ior, surf.miss,
        surf.w_albedo, surf.shadow_active, surf.contribs, *(shadow or (None,) * 4),
        surf.num_shadow])
    P, I = kernels.P, kernels.I
    fn = kernels.entry("shade", "rt_shade_surface", [P, I, I, I, I, I, kernels.F, P])
    offset = cfg.shadow_normal_offset
    err = fn(ctypes.addressof(arr), n, n_point, n_spot, n_dir, int(bool(offset)), float(offset),
             kernels.stream_ptr(dev))
    trace.count("launch.shade.surface")
    kernels.check(err, "rt_shade_surface")
    return surf


def surface(scene, hits: Hits, direction, weight, sigma, active, cfg: RenderConfig,
            tex4=None) -> Surface:
    """The surface terms of a generation (``_surface_glue``'s): K5 on every
    lane, the texture ids and K3 where the scene has textures, then one
    ``rt_shade_surface`` launch."""
    sky_rgb = sky_sample.sample_sky(scene.sky_data, direction)
    tex = None
    if scene.tex_data.shape[0] > 1:  # else the atlas is the white texel
        tex = texture_sample.sample(
            (scene.tex_data, scene.tex_width, scene.tex_height, scene.tex_levels,
             scene.tex_offsets, scene.tex_quad), tex_ids(scene, hits), hits.u, hits.v,
            hits.ds_dx, hits.ds_dy, hits.dt_dx, hits.dt_dy, cfg, data4=tex4)
    return surface_launch(scene, hits, weight, sigma, active, sky_rgb, tex, cfg)


def lights_launch(ambient, surf: Surface, blocked, fb, num_shadow, num_incomplete, incomplete,
                  shadow_incomplete):
    """One ``rt_shade_lights`` launch (``"launch.shade.lights"``): each lane's
    ``miss + w_albedo * (ambient + its unblocked lights' terms)``, added in place
    into ``fb`` [N,3] when it is given (the dense add of generation 0), else
    returned [N,3] for the scatter.  ``blocked`` [L*N] bool is the any-hit
    call's (None without a light).  Returns (fb or the contributions,
    num_shadow, num_incomplete): the counts given plus the generation's shadow
    rays (``surf.num_shadow``), its ``incomplete`` rays and its
    ``shadow_incomplete`` ones (None without a light), 0-dim int32."""
    n = surf.w.shape[0]
    dev = surf.w.device
    f32, i32 = torch.float32, torch.int32
    n_lights = 0 if surf.shadow is None else surf.contribs.shape[0]
    lane = {"shadow_active": (surf.shadow_active, torch.bool), "miss": (surf.miss, f32),
            "w_albedo": (surf.w_albedo, f32)}
    if fb is not None:
        lane["fb"] = (fb, f32)
    table = {"ambient": (ambient, f32), "num_shadow": (num_shadow, i32),
             "num_incomplete": (num_incomplete, i32), "incomplete": (incomplete, i32)}
    if n_lights:
        if blocked.shape != (n_lights * n,) or surf.contribs.shape != (n_lights, n, 3):
            raise ValueError("rt_shade_lights: blocked [L*N] and contribs [L,N,3] expected")
        table.update(contribs=(surf.contribs, f32), blocked=(blocked, torch.bool),
                     counts=(surf.num_shadow, i32), shadow_incomplete=(shadow_incomplete, i32))
    kernels.require_lanes("rt_shade_lights", n, lane, table, dev)
    out = torch.empty((n, 3), dtype=f32, device=dev) if fb is None else None
    num_shadow_out = torch.empty((), dtype=i32, device=dev) if n_lights else num_shadow
    num_incomplete_out = torch.empty((), dtype=i32, device=dev)
    # the kernel reads and writes the light slots only where there is a light
    arr = kernels.pointers([
        surf.miss, surf.w_albedo, surf.shadow_active, surf.contribs, blocked, ambient,
        surf.num_shadow, num_shadow, num_incomplete, incomplete, shadow_incomplete, fb, out,
        num_shadow_out, num_incomplete_out])
    P, I = kernels.P, kernels.I
    fn = kernels.entry("shade", "rt_shade_lights", [P, I, I, I, P])
    err = fn(ctypes.addressof(arr), n, n_lights, _blocks(n), kernels.stream_ptr(dev))
    trace.count("launch.shade.lights")
    kernels.check(err, "rt_shade_lights")
    return (out if fb is None else fb), num_shadow_out, num_incomplete_out


def lights(ambient, surf: Surface, blocked, fb, pixel, num_shadow, num_incomplete, incomplete,
           shadow_incomplete):
    """The lights' sum of a generation added into the frame ``fb`` [P,3]:
    densely and in place where ``pixel`` is None (the lanes are the pixels in
    order), else by the framebuffer scatter at ``pixel``.  Returns (fb,
    num_shadow, num_incomplete), as ``lights_launch``."""
    if pixel is None:
        return lights_launch(ambient, surf, blocked, fb, num_shadow, num_incomplete, incomplete,
                             shadow_incomplete)
    contribution, num_shadow, num_incomplete = lights_launch(
        ambient, surf, blocked, None, num_shadow, num_incomplete, incomplete, shadow_incomplete)
    return framebuffer.accumulate(fb, pixel, contribution), num_shadow, num_incomplete
