"""A scene as plain host data: what the benchmark makes from a configuration and
hands, unchanged, to the program (``benchmark/program.py`` builds its
``SceneDescription`` from it) and to the reference (``benchmark/reference/``).

Part of the benchmark's yardstick.  Later changes add files beside this one and
never edit it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .meshgen import Material, MeshData


@dataclasses.dataclass
class Instance:
    mesh: str  # key into RawScene.meshes
    position: np.ndarray  # [3] float64
    rotation: np.ndarray  # [4] float64 quaternion (x, y, z, w)


@dataclasses.dataclass
class Sphere:
    position: np.ndarray
    radius: float
    material: Material


@dataclasses.dataclass
class Plane:
    """Infinite plane, y-up in object space (Plane.cpp:3-11)."""

    position: np.ndarray
    rotation: np.ndarray
    material: Material


@dataclasses.dataclass
class SpotLight:
    colour: np.ndarray
    position: np.ndarray
    direction: np.ndarray
    inner_angle_deg: float  # full cone angles (SpotLight.h:12-15)
    outer_angle_deg: float


@dataclasses.dataclass
class RawScene:
    """Everything a frame needs, in the reference's terms (Scene.h:19-40)."""

    meshes: dict  # key -> MeshData, in registration order
    instances: list  # [Instance]
    spheres: list  # [Sphere]
    planes: list  # [Plane]
    point_lights: list  # [(colour [3], position [3])]
    spot_lights: list  # [SpotLight]
    directional_lights: list  # [(colour [3], direction [3], pointing from the light)]
    sky_data: np.ndarray  # [S*S,3] float32 angular-map probe
    sky_size: int
    camera_position: np.ndarray
    camera_rotation: np.ndarray
    fov: float = float(np.deg2rad(110.0))  # Scene.cpp:7
    ambient: float = 0.2  # Scene.h:35
    time: float = 0.0


__all__ = ["Instance", "Material", "MeshData", "Plane", "RawScene", "Sphere", "SpotLight"]
