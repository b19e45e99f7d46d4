"""The system under test, as the benchmark drives it: ``raytracer_tpu_torch``.

Builds the program's ``SceneDescription`` from the benchmark's plain scene data
(``yardstick/rawscene.py``) through the program's public API, its BLASes with
its own builder, and its ``RenderConfig`` from a configuration file.  Nothing
here is the yardstick: it is where the program starts.
"""

from __future__ import annotations

import numpy as np

from .yardstick.rawscene import RawScene


def render_config(config: dict, **overrides):
    from raytracer_tpu_torch.config import MipmapFilter, RenderConfig, TextureSampleMode

    return RenderConfig(
        width=int(config["resolution"][0]), height=int(config["resolution"][1]),
        num_bounces=int(config["num_bounces"]),
        texture_sample_mode=TextureSampleMode[config["texture_sample_mode"]],
        mipmap_filter=MipmapFilter[config["mipmap_filter"]],
        max_anisotropy=float(config["max_anisotropy"]),
        enable_fxaa=bool(config["fxaa"]),
        traversal_kernel=config.get("traversal_kernel", "wide"),
        **overrides,
    )


def _material(into, m) -> None:
    into.diffuse = np.array(m.diffuse, np.float64)
    into.reflection = np.array(m.reflection, np.float64)
    into.transmittance = np.array(m.transmittance, np.float64)
    into.index_of_refraction = float(m.index_of_refraction)
    into.texture_array = None if m.texture_array is None else np.array(m.texture_array)


def description(raw: RawScene, scene_class: str):
    """The program's scene for ``raw``: an instance of its
    ``raytracer_tpu_torch.scene.scenes.<scene_class>`` (whose ``update`` is the
    program's own animation), filled through ``add_sphere``, ``add_plane``,
    ``register_blas`` (each BLAS built by the program's SBVH builder, cached in
    ``.cache/bvh_torch``) and ``add_instance``."""
    from raytracer_tpu_torch.accel.blas import build_blas
    from raytracer_tpu_torch.config import MeshAccelerator
    from raytracer_tpu_torch.scene import description as d
    from raytracer_tpu_torch.scene import meshgen, scenes

    desc = getattr(scenes, scene_class)()
    desc.camera.fov = raw.fov
    desc.set_sky(raw.sky_data, raw.sky_size)
    desc.ambient = raw.ambient
    for s in raw.spheres:
        _material(desc.material(desc.add_sphere(np.array(s.position), s.radius)), s.material)
    for p in raw.planes:
        _material(desc.material(desc.add_plane(np.array(p.position), np.array(p.rotation))),
                  p.material)
    for key, mesh in raw.meshes.items():
        mats = []
        for m in mesh.materials:
            mats.append(d.Material())
            _material(mats[-1], m)
        prog_mesh = meshgen.MeshData(
            *(np.array(getattr(mesh, f)) for f in ("p0", "p1", "p2", "n0", "n1", "n2",
                                                   "t0", "t1", "t2")),
            material_id=np.array(mesh.material_id), materials=mats)
        desc.register_blas(key, build_blas(prog_mesh, MeshAccelerator.SBVH))
        desc.mesh_sources[key] = prog_mesh
    for inst in raw.instances:
        desc.add_instance(inst.mesh, np.array(inst.position)).transform.rotation = \
            np.array(inst.rotation)
    for colour, position in raw.point_lights:
        desc.point_lights.append(d.PointLight(np.array(colour), np.array(position)))
    for s in raw.spot_lights:
        desc.spot_lights.append(d.SpotLight(np.array(s.colour), np.array(s.position),
                                            np.array(s.direction), s.inner_angle_deg,
                                            s.outer_angle_deg))
    for colour, direction in raw.directional_lights:
        desc.directional_lights.append(d.DirectionalLight(np.array(colour),
                                                          np.array(direction)))
    desc.camera.position = np.array(raw.camera_position)
    desc.camera.rotation = np.array(raw.camera_rotation)
    desc.time = raw.time
    return desc
