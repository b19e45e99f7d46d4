"""Host-side scene description: primitives, materials, lights, and the scene graph.

Mirrors the reference's Scene layer (Scene.h:19-40): sphere/plane lists, a top-level
BVH over mesh instances, light arrays, ambient constant, sky, camera — but as plain
Python state whose ``update(dt)`` produces the flat device arrays consumed by jit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import aabb as aabb_np
from ..core import matrix as mat4
from ..core import quaternion as quat
from ..utils import trace
from .camera import Camera


@dataclasses.dataclass
class Transform:
    """Position + rotation (Transform.h:6-10)."""

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = dataclasses.field(default_factory=lambda: quat.IDENTITY.copy())

    def world_matrix(self) -> np.ndarray:
        return mat4.compose(self.position, self.rotation)


@dataclasses.dataclass
class Material:
    """POD material (Material.h:8-24)."""

    diffuse: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    texture_path: str | None = None
    texture_array: np.ndarray | None = None  # direct [H,W,3] data (tests/procedural)
    reflection: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    transmittance: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    index_of_refraction: float = 1.0


class MaterialBuffer:
    """Global flat material table with a black default material 0
    (Material.h:28-61)."""

    def __init__(self, max_materials: int = 4096):
        self.max_materials = max_materials
        self.materials: list[Material] = []
        default = Material(diffuse=np.zeros(3))
        self.materials.append(default)

    def reserve(self) -> int:
        """Allocate a slot with a fresh default-white material (Primitive.h:5-8 auto-
        reserves one per analytic primitive)."""
        assert len(self.materials) < self.max_materials, "Max material limit reached"
        self.materials.append(Material())
        return len(self.materials) - 1

    def add(self, material: Material) -> int:
        assert len(self.materials) < self.max_materials, "Max material limit reached"
        self.materials.append(material)
        return len(self.materials) - 1

    def add_all(self, materials: list) -> int:
        """Append a mesh's local material table; returns its offset
        (OBJLoader.cpp:8-10, BottomLevelBVH.h:21-26)."""
        offset = len(self.materials)
        for m in materials:
            self.add(m)
        return offset

    def __getitem__(self, i: int) -> Material:
        return self.materials[i]

    def __len__(self) -> int:
        return len(self.materials)


@dataclasses.dataclass
class SphereDesc:
    """Analytic sphere (Sphere.h)."""

    transform: Transform
    radius: float
    material_id: int


@dataclasses.dataclass
class PlaneDesc:
    """Infinite plane: y-up in object space, oriented by its transform (Plane.cpp:3-11).

    world_arrays() derives the world normal / distance / uv axes per frame.
    """

    transform: Transform
    material_id: int

    def world_arrays(self):
        m = self.transform.world_matrix()
        normal = mat4.transform_direction(m, [0.0, 1.0, 0.0])
        distance = -float(np.dot(normal, self.transform.position))
        u_axis = mat4.transform_direction(m, [1.0, 0.0, 0.0])
        v_axis = np.cross(u_axis, normal)
        return normal, distance, u_axis, v_axis


@dataclasses.dataclass
class MeshInstance:
    """A placed instance of a shared BLAS (Mesh.h; instancing via the BVH cache,
    BottomLevelBVH.cpp:16-22)."""

    transform: Transform
    blas_key: str  # key into SceneDescription.blas_registry

    def world_aabb(self, root_aabb: np.ndarray) -> np.ndarray:
        return aabb_np.transform(root_aabb, self.transform.world_matrix())


@dataclasses.dataclass
class PointLight:
    """Blinn-Phong point light with 1/d^2 falloff (PointLight.h:9-11)."""

    colour: np.ndarray
    position: np.ndarray


@dataclasses.dataclass
class SpotLight:
    """Spot light: point falloff x smooth inner/outer cone falloff (SpotLight.h:17-33).

    Angles are full cone angles in degrees; cutoffs are cos(angle/2) (SpotLight.h:12-15).
    """

    colour: np.ndarray
    position: np.ndarray
    direction: np.ndarray
    inner_angle_deg: float
    outer_angle_deg: float

    @property
    def inner_cutoff(self) -> float:
        return float(np.cos(np.deg2rad(0.5 * self.inner_angle_deg)))

    @property
    def outer_cutoff(self) -> float:
        return float(np.cos(np.deg2rad(0.5 * self.outer_angle_deg)))


@dataclasses.dataclass
class DirectionalLight:
    """Directional light (DirectionalLight.h)."""

    colour: np.ndarray
    direction: np.ndarray  # pointing from the light


class SceneDescription:
    """Host scene graph; pack_scene() (scene/device.py) flattens it for the device."""

    def __init__(self, camera_fov_deg: float = 110.0):
        self.material_buffer = MaterialBuffer()
        self.spheres: list[SphereDesc] = []
        self.planes: list[PlaneDesc] = []
        self.instances: list[MeshInstance] = []
        self.blas_registry: dict = {}
        self.blas_material_offsets: dict = {}
        self.mesh_sources: dict = {}  # key -> MeshData (optional; scene sharding)
        self.point_lights: list[PointLight] = []
        self.spot_lights: list[SpotLight] = []
        self.directional_lights: list[DirectionalLight] = []
        self.ambient = 0.2  # Scene.h:35
        self.camera = Camera(np.deg2rad(camera_fov_deg))
        self.sky_data: np.ndarray = np.zeros((1, 3), np.float32)
        self.sky_size: int = 1
        self.time = 0.0

    # -- construction helpers ------------------------------------------------

    def add_sphere(self, position, radius: float = 1.0) -> SphereDesc:
        mid = self.material_buffer.reserve()
        s = SphereDesc(Transform(np.asarray(position, np.float64)), radius, mid)
        self.spheres.append(s)
        return s

    def add_plane(self, position=(0, 0, 0), rotation=None) -> PlaneDesc:
        mid = self.material_buffer.reserve()
        t = Transform(np.asarray(position, np.float64))
        if rotation is not None:
            t.rotation = np.asarray(rotation, np.float64)
        p = PlaneDesc(t, mid)
        self.planes.append(p)
        return p

    def register_blas(self, key: str, blas) -> None:
        """Register a built BLAS once; its local materials are appended to the global
        buffer and the offset recorded (load_materials, OBJLoader.cpp:8-10)."""
        if key in self.blas_registry:
            return
        self.blas_registry[key] = blas
        self.blas_material_offsets[key] = self.material_buffer.add_all(blas.materials)

    def add_instance(self, blas_key: str, position=(0, 0, 0)) -> MeshInstance:
        assert blas_key in self.blas_registry, f"unknown BLAS {blas_key!r}"
        inst = MeshInstance(Transform(np.asarray(position, np.float64)), blas_key)
        self.instances.append(inst)
        return inst

    def set_sky(self, data: np.ndarray, size: int) -> None:
        self.sky_data = np.asarray(data, np.float32)
        self.sky_size = int(size)

    def material(self, primitive) -> Material:
        return self.material_buffer[primitive.material_id]

    # -- per-frame animation hook (overridden by concrete scenes) ------------

    def update(self, delta: float) -> None:
        """Advance the scene by ``delta`` seconds; every override runs in the
        span ``rt.app.update``."""
        with trace.span("rt.app.update"):
            self.time += delta

    @property
    def triangle_count(self) -> int:
        return sum(
            self.blas_registry[i.blas_key].source_triangle_count for i in self.instances
        )
