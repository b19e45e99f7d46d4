"""Concrete scenes: the BASELINE.json config ladder + the reference's two scenes.

Reference assets (OBJ meshes, textures) are used from ``RT_REFERENCE_DATA``
when it is set; every scene has a fully procedural fallback so the framework is
self-contained (the reference snapshot itself is missing sponza.obj and the sky probe,
SURVEY.md section 6).

Reference scene setups: Scene.cpp:7-71 (SCENE_DYNAMIC), Scene.cpp:75-130 (SCENE_SPONZA).
"""

from __future__ import annotations

import os

import numpy as np

from ..accel.blas import build_blas
from ..config import MeshAccelerator, RenderConfig
from ..core import quaternion as quat
from ..utils import trace
from . import meshgen, objloader, sky
from .description import (
    DirectionalLight,
    PointLight,
    SceneDescription,
    SpotLight,
)

# The reference's asset directory (its Data/ folder).  Unset, every scene takes
# its procedural fallback.
REFERENCE_DATA = os.environ.get("RT_REFERENCE_DATA", "")


def _data_path(*parts) -> str:
    """Path of a reference asset, or "" (which never exists) without a data dir."""
    return os.path.join(REFERENCE_DATA, *parts) if REFERENCE_DATA else ""


def _checker_texture(size: int = 256) -> np.ndarray:
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    c = ((i // 32 + j // 32) % 2).astype(np.float32)
    rgb = np.stack([0.2 + 0.6 * c] * 3, axis=-1)
    return rgb


def _load_mesh(name: str, fallback):
    """Load an OBJ from the reference Data dir, else build the procedural fallback."""
    path = _data_path(name)
    if os.path.exists(path):
        try:
            return objloader.load_obj(path)
        except Exception:
            pass
    return fallback()


def _register_mesh(desc, key, mesh, accelerator=MeshAccelerator.SBVH):
    desc.register_blas(key, build_blas(mesh, accelerator))
    # retain the source soup so tensor-parallel mode can re-split it spatially
    # (parallel/scene_shard.py); harmless otherwise
    desc.mesh_sources[key] = mesh


def _default_sky(desc, size=256):
    probe = _data_path("Sky_Probes", "rnl_probe.float")
    if os.path.exists(probe):
        data, s = sky.load_probe(probe)
    else:
        data, s = sky.procedural_probe(size)
    desc.set_sky(data, s)


def config0_sphere_plane(accelerator=MeshAccelerator.SBVH) -> tuple:
    """BASELINE config[0]: one sphere + plane, one point light, diffuse, 256^2,
    primary rays only."""
    desc = SceneDescription()
    _default_sky(desc)
    s = desc.add_sphere((0.0, 0.0, 8.0), 1.0)
    desc.material(s).diffuse = np.array([0.8, 0.3, 0.3])
    p = desc.add_plane((0.0, -1.0, 0.0))
    desc.material(p).diffuse = np.array([0.55, 0.55, 0.6])
    desc.point_lights.append(
        PointLight(np.array([30.0, 30.0, 30.0]), np.array([3.0, 4.0, 4.0]))
    )
    desc.camera.position = np.array([0.0, 0.5, 0.0])
    cfg = RenderConfig(width=256, height=256, num_bounces=0, queue_factor=1.0,
                       mesh_accelerator=accelerator)
    return desc, cfg


def config1_monkey(accelerator=MeshAccelerator.SBVH) -> tuple:
    """BASELINE config[1]: Monkey mesh through SBVH, spot + directional shadows,
    512^2."""
    desc = SceneDescription()
    _default_sky(desc)
    mesh = _load_mesh("Monkey.obj", lambda: meshgen.icosphere(1.0, 4))
    _register_mesh(desc, "monkey", mesh, accelerator)
    inst = desc.add_instance("monkey", (0.0, 1.0, 6.0))
    inst.transform.rotation = quat.axis_angle([0.0, 1.0, 0.0], np.pi)
    p = desc.add_plane((0.0, -1.0, 0.0))
    desc.material(p).diffuse = np.array([0.6, 0.6, 0.6])
    desc.spot_lights.append(
        SpotLight(
            colour=np.array([40.0, 38.0, 30.0]),
            position=np.array([4.0, 6.0, 2.0]),
            direction=np.array([-0.5, -0.8, 0.6]),
            inner_angle_deg=30.0,
            outer_angle_deg=45.0,
        )
    )
    desc.directional_lights.append(
        DirectionalLight(np.array([0.5, 0.5, 0.5]), np.array([0.2, -1.0, 0.1]))
    )
    desc.camera.position = np.array([0.0, 1.5, 0.5])
    cfg = RenderConfig(width=512, height=512, num_bounces=1, queue_factor=1.0,
                       mesh_accelerator=accelerator)
    return desc, cfg


def config2_dielectric(accelerator=MeshAccelerator.SBVH) -> tuple:
    """BASELINE config[2]: Diamond + Magnifier dielectrics, recursion depth 8, ray
    differentials."""
    desc = SceneDescription()
    _default_sky(desc)
    diamond = _load_mesh("Diamond.obj", lambda: meshgen.octahedron_gem(1.0))
    magnifier = _load_mesh("Magnifier.obj", lambda: meshgen.torus(1.0, 0.18, 64, 24))
    for m in diamond.materials + magnifier.materials:
        if float(np.sum(m.transmittance)) == 0.0:
            m.transmittance = np.array([0.95, 0.95, 0.95])
            m.index_of_refraction = 1.52
            m.reflection = np.array([0.1, 0.1, 0.1])
    _register_mesh(desc, "diamond", diamond, accelerator)
    _register_mesh(desc, "magnifier", magnifier, accelerator)
    desc.add_instance("diamond", (-1.6, 1.2, 6.0))
    desc.add_instance("magnifier", (1.6, 1.2, 6.0))

    s = desc.add_sphere((0.0, 1.0, 9.0), 1.0)
    desc.material(s).diffuse = np.array([0.2, 0.2, 0.0])
    desc.material(s).reflection = np.array([0.6, 0.6, 0.0])
    desc.material(s).transmittance = np.array([0.6, 0.6, 0.6])
    desc.material(s).index_of_refraction = 1.33

    p = desc.add_plane((0.0, 0.0, 0.0))
    desc.material(p).texture_array = _checker_texture()
    desc.material(p).reflection = np.array([0.1, 0.1, 0.1])

    desc.point_lights.append(
        PointLight(np.array([60.0, 60.0, 55.0]), np.array([0.0, 6.0, 4.0]))
    )
    desc.directional_lights.append(
        DirectionalLight(np.array([0.4, 0.4, 0.45]), np.array([0.0, -1.0, 0.2]))
    )
    desc.camera.position = np.array([0.0, 1.8, 0.0])
    cfg = RenderConfig(width=512, height=512, num_bounces=8, queue_factor=2.0,
                       mesh_accelerator=accelerator)
    return desc, cfg


# The reference's 27-keyframe sponza fly-through (Scene.cpp:95-126); playback is
# disabled by default there too (commented out at Scene.cpp:157-162).
SPONZA_SPLINE_TIMES = [float(t) for t in range(0, 53, 2)]
SPONZA_SPLINE_POINTS = [
    (0.0, 2.0, 0.0), (-60.6, 17.2, 15.5), (-108.1, 17.2, -1.9),
    (-125.1, 17.2, -15.0), (-129.6, 17.2, -32.9), (-115.1, 17.2, -46.7),
    (-89.1, 17.2, -52.8), (-38.4, 17.2, -55.2), (2.4, 20.3, -46.7),
    (15.4, 29.4, -37.6), (22.8, 31.5, -27.5), (26.5, 43.1, -12.6),
    (37.4, 65.0, 17.3), (39.4, 65.4, 31.4), (39.4, 65.4, 31.4),
    (49.2, 68.8, 37.0), (49.2, 68.8, 37.0), (85.1, 70.0, 42.5),
    (106.1, 70.8, 27.4), (114.9, 72.3, -16.4), (93.1, 73.4, -50.5),
    (61.5, 65.1, -27.1), (44.9, 88.8, -6.7), (18.0, 99.1, -13.6),
    (17.6, 99.1, -13.6), (8.4, 83.9, -11.1), (12.6, 37.4, 1.4),
]


class SponzaScene(SceneDescription):
    """Sponza with an optional spline camera fly-through (CatmullRomSpline)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.spline_playback = False
        self._spline = None

    def update(self, delta: float) -> None:
        with trace.span("rt.app.update"):
            self.time += delta
            if self.spline_playback:
                from ..core.spline import CatmullRomSpline

                if self._spline is None:
                    self._spline = CatmullRomSpline(
                        SPONZA_SPLINE_TIMES, np.array(SPONZA_SPLINE_POINTS)
                    )
                prev = self.camera.position.copy()
                self.camera.position = self._spline.get_point(delta)
                forward = self.camera.position - prev
                if np.linalg.norm(forward) > 1e-9:
                    self.camera.rotation = quat.look_rotation(forward, [0.0, 1.0, 0.0])


def sponza_spline_poses(n: int = 8, fit_standin: bool | None = None):
    """Sample ``n`` camera poses from the reference's sponza fly-through
    (Scene.cpp:95-126): position from the Catmull-Rom spline, rotation looking
    along the motion direction (matching SponzaScene.update's playback).

    The spline is authored for crytek-sponza's extents (x +-130, y up to 99).
    When config3 renders the procedural stand-in (the snapshot is missing
    sponza.obj — SURVEY.md section 6), the control points are mapped affinely
    into the stand-in atrium's interior so every pose still flies THROUGH the
    geometry rather than far outside it.  Used by the pose-robustness sweep
    (tools/pose_sweep.py, tests/test_pose_sweep.py): scene-tuned ladder/queue
    capacities must stay lossless on the reference's own camera path, not just
    the single bench pose (VERDICT r4 #4).
    """
    from ..core.spline import CatmullRomSpline

    pts = np.array(SPONZA_SPLINE_POINTS, np.float64)
    if fit_standin is None:
        fit_standin = not os.path.exists(
            _data_path("sponza", "sponza.obj")
        )
    if fit_standin:
        # per-axis affine map of the spline bbox into the stand-in atrium
        # (meshgen.sponza_like: footprint 36x16, height 12), with margin
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        tlo = np.array([-15.0, 1.5, -5.0])
        thi = np.array([15.0, 10.0, 5.0])
        pts = (pts - lo) / np.maximum(hi - lo, 1e-9) * (thi - tlo) + tlo
    t_end = SPONZA_SPLINE_TIMES[-1]
    poses = []
    rot = quat.axis_angle([0.0, 1.0, 0.0], -np.pi / 2)  # fallback: bench pose
    for i in range(n):
        t = (i + 0.5) / n * t_end
        # the spline API is the reference's stateful playback (one clock per
        # instance): sample absolute times through fresh instances
        pos = CatmullRomSpline(SPONZA_SPLINE_TIMES, pts).get_point(t)
        nxt = CatmullRomSpline(SPONZA_SPLINE_TIMES, pts).get_point(t + 0.05)
        forward = np.asarray(nxt, np.float64) - np.asarray(pos, np.float64)
        if np.linalg.norm(forward) > 1e-9:
            rot = quat.look_rotation(forward, [0.0, 1.0, 0.0])
        poses.append((np.asarray(pos, np.float64).copy(), np.asarray(rot).copy()))
    return poses


def config3_sponza(width: int = 1920, height: int = 1080, target_triangles=260_000,
                   accelerator=MeshAccelerator.SBVH):
    """BASELINE config[3]: Sponza 1080p — full SBVH, mipmapped textures, all light
    types (reference default workload, Scene.cpp:75-130 + Config.h:6-16)."""
    desc = SponzaScene()
    _default_sky(desc)
    sponza_path = _data_path("sponza", "sponza.obj")
    if os.path.exists(sponza_path):
        mesh = objloader.load_obj(sponza_path)
    else:
        mesh = meshgen.sponza_like(target_triangles)
    _register_mesh(desc, "sponza", mesh, accelerator)
    desc.add_instance("sponza", (0.0, 0.0, 0.0))

    magnifier = _load_mesh("Magnifier.obj", lambda: meshgen.torus(1.0, 0.18, 48, 16))
    concave = _load_mesh("Concave.obj", lambda: meshgen.icosphere(1.0, 3))
    for m in magnifier.materials + concave.materials:
        if float(np.sum(m.transmittance)) == 0.0:
            m.transmittance = np.array([0.9, 0.9, 0.9])
            m.index_of_refraction = 1.5
    _register_mesh(desc, "magnifier", magnifier, accelerator)
    _register_mesh(desc, "concave", concave, accelerator)
    desc.add_instance("magnifier", (6.0, 2.0, 0.0))
    c = desc.add_instance("concave", (20.0, 2.0, 0.0))
    c.transform.rotation = quat.axis_angle([0.0, 1.0, 0.0], np.pi)

    desc.directional_lights.append(
        DirectionalLight(np.array([0.9, 0.9, 0.9]), np.array([0.1, -1.0, 0.1]))
    )
    desc.point_lights.append(
        PointLight(np.array([120.0, 110.0, 90.0]), np.array([0.0, 9.0, 0.0]))
    )
    desc.spot_lights.append(
        SpotLight(
            colour=np.array([80.0, 20.0, 15.0]),
            position=np.array([-10.0, 8.0, 0.0]),
            direction=np.array([0.3, -1.0, 0.0]),
            inner_angle_deg=40.0,
            outer_angle_deg=60.0,
        )
    )
    desc.camera.position = np.array([15.0, 4.0, 0.0])
    desc.camera.rotation = quat.axis_angle([0.0, 1.0, 0.0], -np.pi / 2)
    # mostly-diffuse scene: deep generations carry few rays; num_dropped
    # (printed by bench, asserted 0 in the config3 golden) guards every
    # queue-capacity margin below.
    cfg = RenderConfig(
        # Round-5 retune (same-process 1080p fwd+bwd A/Bs, scratch/ab_*.log):
        # - the UNROLLED bounce pipeline beats the scan_bounces path by 178 ms
        #   at IDENTICAL queues (2360 vs 2538 ms): the scan's uniform shared
        #   capacity + masked final iteration + loop machinery cost more than
        #   the extra compile (cold 229 s vs 149 s — tools/warm_bench.py
        #   prewarms the server cache either way);
        # - per-bounce DECAYING queues add another 64 ms: bounce-1 children
        #   measured 6.2% of n, bounces 2-3 only 3.7-5.3% (scratch r3), so
        #   gens 2-3 run at 1/16 and 3/64 instead of all at 3/32
        #   (bench-validated dropped == 0; hot off-bench poses are covered by
        #   the RobustRenderer lossless retry, tests/test_pose_sweep.py);
        # - NOT adopted (slower despite fewer lanes): bounce-1 queue 0.08 /
        #   0.078125 (2596 vs 2538 — 6144=48x128 lanes tiles better; queue
        #   width is not lane-count-monotone), any-ladder tail trim
        #   (1/320,72).
        # - chunk_checkpoint STAYS ON: grad-only programs measure the remat at
        #   43 ms/step (2278 vs 2235, bwd_parts_final), but the bench's
        #   value_and_grad-with-aux program compiled WITHOUT the checkpoint
        #   regressed to 44 s/step (20x — scratch/bench_r5_live5.log;
        #   unbounded per-chunk residual liveness evidently drives the
        #   scheduler into an activation-spill regime on this program shape).
        #   The checkpoint's memory bound is load-bearing, not optional.
        width=width, height=height, num_bounces=3,
        queue_factor=(0.09375, 0.0625, 0.046875), scan_bounces=False,
        mesh_accelerator=accelerator,
        # chunk-size sweep at 1080p with packed boundaries + octant sort
        # (round 4): 2^17 fwd+bwd 3.29 s, 2^16 2.77 s, 2^15 3.11 s — the
        # smaller wavefront's working set plus purer octant groups beat the
        # extra per-chunk fixed cost at 32 chunks, and 2^15's 64 chunks lose
        # to dispatch overhead
        traversal_chunk=1 << 16,
        # shadow ladder tuned to THIS scene's measured post-cull aliveness on
        # the SAH-collapsed tree (scratch/aliveness.py @960x540: active0 34.6%,
        # 15.6% alive @8 wide iterations, 0.70% @16, ~0 @32), with capacities
        # validated at 1080p where activity/decay run slightly hotter than the
        # 960x540 curve (round-4 sweep: (0.5,8),(0.2,8) capacities starved
        # ~4.2k lanes at 1080p; these leave incomplete == 0 at 2.24 s fwd):
        # (round-5 also A/B'd a tail trim (1/192,96) -> (1/320,72): lossless
        # but measured slower in combination — scratch/ab_r5tune.log; kept)
        wide_rounds_any=((0.55, 8), (0.25, 8), (1.0 / 24, 16), (1.0 / 192, 96)),
        # Secondary closest rays walk longer than camera primaries AND their
        # queue is tight (66% active at 3/32 capacity), so the primary ladder's
        # 1/16 round-2 starves them (measured secondary aliveness of capacity,
        # 1080p frame 0: 31% alive @16 iters, 3.7% @24, 0.34% @32, 0 @64 —
        # scratch round 3).  Rounds sized ~2x over that curve:
        wide_rounds_secondary=(
            (1.0, 16), (0.5, 8), (0.08, 8), (1.0 / 64, 32), (1.0 / 256, 192),
        ),
        # secondary shadow wavefronts measured 11-14% active at small
        # resolutions, but 1080p runs much hotter (round-4 sweep: round-0
        # capacities 0.25 / 0.35 starved 45k / 5k lanes at 1080p; the default
        # ladder leaves incomplete == 0) — the full-round-0 default is the
        # honest setting; its dead-lane cost is bounded by the small
        # secondary queues (3/32 n).
        wide_rounds_any_secondary=RenderConfig.wide_rounds_any,
        # octant-sorted ladder compaction: coherent sub-wavefronts walk the
        # same subtrees, so the per-iteration record gathers hit overlapping
        # rows — measured -6.5% whole-frame at 1080p, image bit-identical
        # (round-4 A/B; the stable sort preserves determinism)
        ladder_sort_octant=True,
    )
    return desc, cfg


class DynamicScene(SceneDescription):
    """The reference's SCENE_DYNAMIC (Scene.cpp:7-71) with its per-frame animation
    (Scene.cpp:139-155): 2 dielectric spheres, textured reflective plane, 6 mesh
    instances (2 tori share one BLAS), point+spot+directional lights."""

    def update(self, delta: float) -> None:
        with trace.span("rt.app.update"):
            self.time += delta
            inst = self.instances
            # diamond spins around Y
            inst[0].transform.rotation = quat.multiply(
                quat.axis_angle([0.0, 1.0, 0.0], delta), inst[0].transform.rotation
            )
            # monkey bobs
            inst[1].transform.position[1] = 1.0 + 2.0 * np.sin(self.time)
            # icosphere drifts in -x
            inst[2].transform.position[0] -= delta * 0.5
            # rock orbits
            inst[3].transform.position = np.array(
                [6.0, 4.0 + 2.0 * np.sin(self.time * 0.5), 4.0 + 2.0 * np.cos(self.time * 0.5)]
            )
            inst[3].transform.rotation = quat.multiply(
                quat.axis_angle([0.0, 1.0, 0.0], delta * 0.5), inst[3].transform.rotation
            )
            # torus 1 rolls around X
            inst[4].transform.rotation = quat.multiply(
                quat.axis_angle([1.0, 0.0, 0.0], delta), inst[4].transform.rotation
            )
            # torus 2 nlerps
            inst[5].transform.rotation = quat.nlerp(
                quat.IDENTITY,
                quat.axis_angle([1.0, 0.0, 0.0], np.deg2rad(-90.0)),
                0.5 + 0.5 * np.sin(self.time),
            )


def config4_dynamic(width: int = 900, height: int = 600,
                    accelerator=MeshAccelerator.SBVH) -> tuple:
    """BASELINE config[4] / reference SCENE_DYNAMIC: per-frame TLAS rebuild over
    animated shared-BLAS instances."""
    desc = DynamicScene()
    _default_sky(desc)

    s0 = desc.add_sphere((-2.0, 0.0, 10.0), 1.0)
    s1 = desc.add_sphere((2.0, 0.0, 10.0), 1.0)
    m0, m1 = desc.material(s0), desc.material(s1)
    m0.diffuse = np.array([0.2, 0.2, 0.0])
    m1.diffuse = np.array([0.0, 0.2, 0.2])
    m0.reflection = np.array([0.6, 0.6, 0.0])
    m1.reflection = np.array([0.0, 0.6, 0.6])
    m0.transmittance = np.array([0.6, 0.6, 0.6])
    m1.transmittance = np.array([0.6, 0.6, 0.6])
    m0.index_of_refraction = 1.33
    m1.index_of_refraction = 1.68

    p = desc.add_plane((0.0, -1.0, 0.0), quat.axis_angle([0.0, 1.0, 0.0], 0.25 * np.pi))
    floor_png = _data_path("floor.png")
    if os.path.exists(floor_png):
        desc.material(p).texture_path = floor_png
    else:
        desc.material(p).texture_array = _checker_texture()
    desc.material(p).reflection = np.array([0.1, 0.1, 0.1])

    meshes = {
        "diamond": _load_mesh("Diamond.obj", lambda: meshgen.octahedron_gem(1.0)),
        "monkey": _load_mesh("Monkey.obj", lambda: meshgen.icosphere(1.0, 3)),
        "icosphere": _load_mesh("icosphere.obj", lambda: meshgen.icosphere(1.0, 3)),
        "rock": _load_mesh("Rock.obj", lambda: meshgen.box((1.5, 1.0, 1.2))),
        "torus": _load_mesh("Torus.obj", lambda: meshgen.torus(1.0, 0.35, 48, 24)),
    }
    for k, m in meshes.items():
        _register_mesh(desc, k, m, accelerator)
    desc.add_instance("diamond", (0.0, 1.0, 0.0))
    desc.add_instance("monkey", (4.0, 2.0, 0.0))
    desc.add_instance("icosphere", (0.0, 3.0, 4.0))
    desc.add_instance("rock", (6.0, 4.0, 4.0))
    desc.add_instance("torus", (0.0, 5.0, 8.0))  # shared BLAS: instancing
    desc.add_instance("torus", (-4.0, 2.0, 6.0))

    desc.point_lights.append(
        PointLight(np.array([0.0, 5.0, 10.0]), np.array([0.0, 0.0, 6.0]))
    )
    spot_dir = quat.rotate(
        quat.axis_angle([1.0, 0.0, 0.0], np.deg2rad(70.0)), [0.0, 0.0, 1.0]
    )
    desc.spot_lights.append(
        SpotLight(
            colour=np.array([1.0, 0.0, 0.0]),
            position=np.array([0.0, 0.0, 10.0]),
            direction=np.asarray(spot_dir),
            inner_angle_deg=70.0,
            outer_angle_deg=80.0,
        )
    )
    desc.directional_lights.append(
        DirectionalLight(np.array([0.5, 0.5, 0.5]), np.array([0.0, -1.0, 0.0]))
    )
    desc.camera.position = np.array([-4.694016, 6.446100, -0.572288])
    desc.camera.rotation = np.array([0.268476, 0.423740, -0.133092, 0.854779])
    # Scene-tuned wavefront sizing (measured per-generation activity at
    # 225x150, frame 0, scratch round 4): bounce-1 children are 87.5% of n
    # (the textured floor reflects everywhere), bounce-2/3 only 9.7%/8.0%;
    # primary shadows 55.6% post-cull, secondary shadows 1.4-2.8%.  The
    # animated scene drifts, so capacities carry ~2x headroom and every
    # violation surfaces as num_dropped/num_incomplete (asserted 0 by the
    # config4 golden; printed per frame by app.py / bench_dynamic).
    # scan_bounces off: a shared queue would run bounces 2-3 at the bounce-1
    # capacity (1.0 n) for ~9% activity; the unrolled pipeline sizes each.
    # chunk/ladder capacities re-validated at 900x600 (round-4 sweep: chunk
    # 2^15 + these capacities leave incomplete == 0 at 619 ms fwd; tighter
    # secondary round-0 capacities starve under per-chunk activity variance
    # at small chunks)
    cfg = RenderConfig(width=width, height=height, num_bounces=3,
                       queue_factor=(1.0, 0.2, 0.15), scan_bounces=False,
                       traversal_chunk=1 << 15,
                       wide_rounds_any=(
                           (0.75, 8), (0.25, 8), (1.0 / 24, 16), (1.0 / 192, 96),
                       ),
                       wide_rounds_any_secondary=(
                           (0.2, 8), (1.0 / 16, 16), (1.0 / 256, 96),
                       ),
                       ladder_sort_octant=True,
                       mesh_accelerator=accelerator)
    return desc, cfg


SCENES = {
    "config0": config0_sphere_plane,
    "config1": config1_monkey,
    "config2": config2_dielectric,
    "config3": config3_sponza,
    "config4": config4_dynamic,
}


def make_scene(name: str, **kwargs):
    if name not in SCENES:
        raise ValueError(
            f"unknown scene {name!r}; available: {', '.join(sorted(SCENES))}"
        )
    return SCENES[name](**kwargs)
