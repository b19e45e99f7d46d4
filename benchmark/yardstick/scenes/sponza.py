"""The reference's SCENE_SPONZA (Scene.cpp:75-130) as plain data: a frozen copy of
``raytracer_tpu_torch/scene/scenes.py:243-286`` (``config3_sponza``'s scene, its
procedural fall-backs always taken) and ``scenes.py:63-69`` (the sky).

The Crytek Sponza OBJ, Magnifier.obj, Concave.obj and the sky probe are not in
the repository, so the meshes are ``meshgen``'s stand-ins and the sky is the
procedural probe, as the program's own scene takes them without
``RT_REFERENCE_DATA``.
"""

from __future__ import annotations

import numpy as np

from .. import assets, geometry, meshgen
from ..rawscene import Instance, RawScene, SpotLight


def build(config: dict) -> RawScene:
    mesh = meshgen.sponza_like(int(config["triangles"]))
    magnifier = meshgen.torus(1.0, 0.18, 48, 16)
    concave = meshgen.icosphere(1.0, 3)
    for m in magnifier.materials + concave.materials:
        if float(np.sum(m.transmittance)) == 0.0:
            m.transmittance = np.array([0.9, 0.9, 0.9])
            m.index_of_refraction = 1.5
    sky, size = assets.procedural_probe(int(config["sky_size"]))
    return RawScene(
        meshes={"sponza": mesh, "magnifier": magnifier, "concave": concave},
        instances=[
            Instance("sponza", np.array([0.0, 0.0, 0.0]), geometry.IDENTITY.copy()),
            Instance("magnifier", np.array([6.0, 2.0, 0.0]), geometry.IDENTITY.copy()),
            Instance("concave", np.array([20.0, 2.0, 0.0]),
                     geometry.axis_angle([0.0, 1.0, 0.0], np.pi)),
        ],
        spheres=[],
        planes=[],
        directional_lights=[(np.array([0.9, 0.9, 0.9]), np.array([0.1, -1.0, 0.1]))],
        point_lights=[(np.array([120.0, 110.0, 90.0]), np.array([0.0, 9.0, 0.0]))],
        spot_lights=[SpotLight(np.array([80.0, 20.0, 15.0]), np.array([-10.0, 8.0, 0.0]),
                               np.array([0.3, -1.0, 0.0]), 40.0, 60.0)],
        sky_data=sky,
        sky_size=size,
        camera_position=np.array([15.0, 4.0, 0.0]),
        camera_rotation=geometry.axis_angle([0.0, 1.0, 0.0], -np.pi / 2),
        fov=float(np.deg2rad(float(config["camera_fov_deg"]))),
    )


def camera_path(n: int, phase: float) -> list:
    """The fly-through's ``n`` poses, [(position, rotation)], spaced evenly over the
    reference's spline, the first at ``phase`` of the first interval."""
    return geometry.sponza_spline_poses(n, phase)
