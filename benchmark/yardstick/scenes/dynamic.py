"""The reference's SCENE_DYNAMIC (Scene.cpp:7-71) and its per-frame animation
(Scene.cpp:139-155) as plain data: a frozen copy of
``raytracer_tpu_torch/scene/scenes.py:389-452`` (``config4_dynamic``'s scene, its
procedural fall-backs always taken) and ``scenes.py:354-386``
(``DynamicScene.update``).

The OBJ meshes, floor.png and the sky probe are not in the repository, so the
meshes are ``meshgen``'s stand-ins, the floor a checker and the sky the
procedural probe, as the program's own scene takes them without
``RT_REFERENCE_DATA``.
"""

from __future__ import annotations

import numpy as np

from .. import assets, geometry, meshgen
from ..meshgen import Material
from ..rawscene import Instance, Plane, RawScene, Sphere, SpotLight


def build(config: dict) -> RawScene:
    m0 = Material(diffuse=np.array([0.2, 0.2, 0.0]), reflection=np.array([0.6, 0.6, 0.0]),
                  transmittance=np.array([0.6, 0.6, 0.6]), index_of_refraction=1.33)
    m1 = Material(diffuse=np.array([0.0, 0.2, 0.2]), reflection=np.array([0.0, 0.6, 0.6]),
                  transmittance=np.array([0.6, 0.6, 0.6]), index_of_refraction=1.68)
    floor = Material(texture_array=assets._checker_texture(),
                     reflection=np.array([0.1, 0.1, 0.1]))
    meshes = {
        "diamond": meshgen.octahedron_gem(1.0),
        "monkey": meshgen.icosphere(1.0, 3),
        "icosphere": meshgen.icosphere(1.0, 3),
        "rock": meshgen.box((1.5, 1.0, 1.2)),
        "torus": meshgen.torus(1.0, 0.35, 48, 24),
    }
    ident = geometry.IDENTITY
    spot_dir = geometry.rotate(geometry.axis_angle([1.0, 0.0, 0.0], np.deg2rad(70.0)),
                               [0.0, 0.0, 1.0])
    sky, size = assets.procedural_probe(int(config["sky_size"]))
    return RawScene(
        meshes=meshes,
        instances=[
            Instance("diamond", np.array([0.0, 1.0, 0.0]), ident.copy()),
            Instance("monkey", np.array([4.0, 2.0, 0.0]), ident.copy()),
            Instance("icosphere", np.array([0.0, 3.0, 4.0]), ident.copy()),
            Instance("rock", np.array([6.0, 4.0, 4.0]), ident.copy()),
            Instance("torus", np.array([0.0, 5.0, 8.0]), ident.copy()),
            Instance("torus", np.array([-4.0, 2.0, 6.0]), ident.copy()),
        ],
        spheres=[Sphere(np.array([-2.0, 0.0, 10.0]), 1.0, m0),
                 Sphere(np.array([2.0, 0.0, 10.0]), 1.0, m1)],
        planes=[Plane(np.array([0.0, -1.0, 0.0]),
                      geometry.axis_angle([0.0, 1.0, 0.0], 0.25 * np.pi), floor)],
        point_lights=[(np.array([0.0, 5.0, 10.0]), np.array([0.0, 0.0, 6.0]))],
        spot_lights=[SpotLight(np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 10.0]),
                               np.asarray(spot_dir), 70.0, 80.0)],
        directional_lights=[(np.array([0.5, 0.5, 0.5]), np.array([0.0, -1.0, 0.0]))],
        sky_data=sky,
        sky_size=size,
        camera_position=np.array([-4.694016, 6.446100, -0.572288]),
        camera_rotation=np.array([0.268476, 0.423740, -0.133092, 0.854779]),
        fov=float(np.deg2rad(float(config["camera_fov_deg"]))),
    )


def animate(scene: RawScene, delta: float) -> None:
    """One step of the scene's animation (``scenes.py:359-386``)."""
    scene.time += delta
    inst = scene.instances
    # diamond spins around Y
    inst[0].rotation = geometry.multiply(
        geometry.axis_angle([0.0, 1.0, 0.0], delta), inst[0].rotation
    )
    # monkey bobs
    inst[1].position[1] = 1.0 + 2.0 * np.sin(scene.time)
    # icosphere drifts in -x
    inst[2].position[0] -= delta * 0.5
    # rock orbits
    inst[3].position = np.array(
        [6.0, 4.0 + 2.0 * np.sin(scene.time * 0.5), 4.0 + 2.0 * np.cos(scene.time * 0.5)]
    )
    inst[3].rotation = geometry.multiply(
        geometry.axis_angle([0.0, 1.0, 0.0], delta * 0.5), inst[3].rotation
    )
    # torus 1 rolls around X
    inst[4].rotation = geometry.multiply(
        geometry.axis_angle([1.0, 0.0, 0.0], delta), inst[4].rotation
    )
    # torus 2 nlerps
    inst[5].rotation = geometry.nlerp(
        geometry.IDENTITY,
        geometry.axis_angle([1.0, 0.0, 0.0], np.deg2rad(-90.0)),
        0.5 + 0.5 * np.sin(scene.time),
    )
