"""Frozen copy of the port's procedural meshes (``raytracer_tpu_torch/scene/meshgen.py:1-415``).

Part of the benchmark's yardstick: the scene inputs are made here, and handed both
to the program (through its public ``SceneDescription`` API) and to the reference.
Later changes add files beside this one and never edit it, so that the inputs of
every cell stay what they were when its bounds were set.

The only departure from the source: ``Material`` is this module's own plain record
(``raytracer_tpu_torch/scene/description.py:32-40``), so that nothing here imports
the program.
"""


from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Material:
    """POD material (Material.h:8-24; description.py:32-40)."""

    diffuse: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    texture_array: np.ndarray | None = None
    reflection: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    transmittance: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    index_of_refraction: float = 1.0


@dataclasses.dataclass
class MeshData:
    """Triangle soup in the loader's output layout (OBJLoader.cpp:149-175): flat
    per-triangle vertices, shading normals, (v-flipped) texcoords, local material ids."""

    p0: np.ndarray  # [T,3]
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray  # [T,3] shading normals
    n1: np.ndarray
    n2: np.ndarray
    t0: np.ndarray  # [T,2] texcoords
    t1: np.ndarray
    t2: np.ndarray
    material_id: np.ndarray  # [T] int32 local material index
    materials: list  # list[Material] local material table

    @property
    def triangle_count(self) -> int:
        return self.p0.shape[0]

    @staticmethod
    def concatenate(meshes: list) -> "MeshData":
        assert meshes
        mats = meshes[0].materials
        for m in meshes[1:]:
            assert m.materials is mats or m.materials == mats
        return MeshData(
            *[
                np.concatenate([getattr(m, f) for m in meshes], axis=0)
                for f in ("p0", "p1", "p2", "n0", "n1", "n2", "t0", "t1", "t2")
            ],
            material_id=np.concatenate([m.material_id for m in meshes]),
            materials=mats,
        )


def from_indexed(vertices, faces, normals=None, uvs=None, material_id=0, materials=None):
    """Build a MeshData from an indexed vertex/face list; smooth normals by default."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    if normals is None:
        # area-weighted smooth vertex normals
        fn = np.cross(
            vertices[faces[:, 1]] - vertices[faces[:, 0]],
            vertices[faces[:, 2]] - vertices[faces[:, 0]],
        )
        vn = np.zeros_like(vertices)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = vn / np.maximum(norm, 1e-20)
        normals = vn
    normals = np.asarray(normals, np.float64)
    if uvs is None:
        uvs = np.zeros((len(vertices), 2))
    uvs = np.asarray(uvs, np.float64)

    t = len(faces)
    mat = np.full((t,), material_id, np.int32)
    return MeshData(
        p0=vertices[faces[:, 0]].astype(np.float32),
        p1=vertices[faces[:, 1]].astype(np.float32),
        p2=vertices[faces[:, 2]].astype(np.float32),
        n0=normals[faces[:, 0]].astype(np.float32),
        n1=normals[faces[:, 1]].astype(np.float32),
        n2=normals[faces[:, 2]].astype(np.float32),
        t0=uvs[faces[:, 0]].astype(np.float32),
        t1=uvs[faces[:, 1]].astype(np.float32),
        t2=uvs[faces[:, 2]].astype(np.float32),
        material_id=mat,
        materials=materials if materials is not None else [Material()],
    )


def quad(size=1.0, material_id=0, materials=None) -> MeshData:
    """Unit quad in the XZ plane, +Y normal."""
    s = size * 0.5
    v = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]])
    f = np.array([[0, 2, 1], [0, 3, 2]])
    n = np.tile([0.0, 1.0, 0.0], (4, 1))
    uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    return from_indexed(v, f, n, uv, material_id, materials)


def box(extents=(1.0, 1.0, 1.0), material_id=0, materials=None) -> MeshData:
    e = np.asarray(extents, np.float64) * 0.5
    corners = np.array(
        [[x, y, z] for x in (-e[0], e[0]) for y in (-e[1], e[1]) for z in (-e[2], e[2])]
    )
    # 6 faces, flat normals -> build per-face quads
    faces_idx = [
        ([0, 1, 3, 2], [-1, 0, 0]),
        ([4, 6, 7, 5], [1, 0, 0]),
        ([0, 4, 5, 1], [0, -1, 0]),
        ([2, 3, 7, 6], [0, 1, 0]),
        ([0, 2, 6, 4], [0, 0, -1]),
        ([1, 5, 7, 3], [0, 0, 1]),
    ]
    verts, norms, uvs, faces = [], [], [], []
    for quad_idx, n in faces_idx:
        base = len(verts)
        for i, ci in enumerate(quad_idx):
            verts.append(corners[ci])
            norms.append(n)
            uvs.append([[0, 0], [1, 0], [1, 1], [0, 1]][i])
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    return from_indexed(
        np.array(verts), np.array(faces), np.array(norms, np.float64), np.array(uvs),
        material_id, materials,
    )


def icosphere(radius=1.0, subdivisions=3, material_id=0, materials=None) -> MeshData:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdivisions):
        cache = {}
        verts = list(map(tuple, v))
        new_f = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = 0.5 * (np.array(verts[a]) + np.array(verts[b]))
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts)
        f = np.array(new_f)
    v = v * radius
    normals = v / np.linalg.norm(v, axis=1, keepdims=True)
    uvs = np.stack(
        [
            np.arctan2(normals[:, 2], normals[:, 0]) / (2 * np.pi) + 0.5,
            np.arccos(np.clip(normals[:, 1], -1, 1)) / np.pi + 0.5,
        ],
        axis=1,
    )
    return from_indexed(v, f, normals, uvs, material_id, materials)


def torus(major=1.0, minor=0.35, seg_major=48, seg_minor=24, material_id=0, materials=None):
    i = np.arange(seg_major)
    j = np.arange(seg_minor)
    theta = 2 * np.pi * i / seg_major
    phi = 2 * np.pi * j / seg_minor
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    cx = (major + minor * np.cos(ph)) * np.cos(th)
    cy = minor * np.sin(ph)
    cz = (major + minor * np.cos(ph)) * np.sin(th)
    v = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    nx = np.cos(ph) * np.cos(th)
    ny = np.sin(ph)
    nz = np.cos(ph) * np.sin(th)
    n = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3)
    uv = np.stack([th / (2 * np.pi), ph / (2 * np.pi)], axis=-1).reshape(-1, 2)

    faces = []
    for a in range(seg_major):
        for b in range(seg_minor):
            i00 = a * seg_minor + b
            i01 = a * seg_minor + (b + 1) % seg_minor
            i10 = ((a + 1) % seg_major) * seg_minor + b
            i11 = ((a + 1) % seg_major) * seg_minor + (b + 1) % seg_minor
            faces += [[i00, i10, i11], [i00, i11, i01]]
    return from_indexed(v, np.array(faces), n, uv, material_id, materials)


def cylinder(radius=0.5, height=2.0, segments=24, material_id=0, materials=None, cap=True):
    i = np.arange(segments)
    th = 2 * np.pi * i / segments
    ring = np.stack([radius * np.cos(th), np.zeros(segments), radius * np.sin(th)], -1)
    bot = ring + [0, -height / 2, 0]
    top = ring + [0, height / 2, 0]
    v = np.concatenate([bot, top], axis=0)
    n_side = np.concatenate([ring / radius, ring / radius], axis=0)
    uv = np.concatenate(
        [
            np.stack([i / segments, np.zeros(segments)], -1),
            np.stack([i / segments, np.ones(segments)], -1),
        ]
    )
    faces = []
    for a in range(segments):
        b = (a + 1) % segments
        faces += [[a, segments + a, segments + b], [a, segments + b, b]]
    mesh = from_indexed(v, np.array(faces), n_side, uv, material_id, materials)
    if cap:
        caps = []
        for y, flip in ((-height / 2, True), (height / 2, False)):
            center = np.array([[0, y, 0]])
            ringy = ring + [0, y, 0]
            vv = np.concatenate([center, ringy])
            nrm = np.tile([0, -1.0 if flip else 1.0, 0], (segments + 1, 1))
            ff = []
            for a in range(segments):
                b = (a + 1) % segments
                ff.append([0, 1 + b, 1 + a] if not flip else [0, 1 + a, 1 + b])
            caps.append(
                from_indexed(vv, np.array(ff), nrm, None, material_id, mesh.materials)
            )
        mesh = MeshData.concatenate([mesh] + caps)
    return mesh


def octahedron_gem(radius=1.0, material_id=0, materials=None) -> MeshData:
    """Simple 'diamond': elongated octahedron with flat facets (Diamond.obj stand-in)."""
    v = np.array(
        [
            [0, 1.2, 0], [0, -1.6, 0],
            [1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, 0, -1],
        ]
    ) * radius
    f = []
    for a in range(4):
        b = (a + 1) % 4
        f.append([0, 2 + a, 2 + b])
        f.append([1, 2 + b, 2 + a])
    verts, faces, norms = [], [], []
    for tri in f:  # flat facets
        base = len(verts)
        p = v[tri]
        n = np.cross(p[1] - p[0], p[2] - p[0])
        n /= np.linalg.norm(n)
        verts += list(p)
        norms += [n] * 3
        faces.append([base, base + 1, base + 2])
    return from_indexed(
        np.array(verts), np.array(faces), np.array(norms), None, material_id, materials
    )


def transformed(mesh: MeshData, position=(0, 0, 0), scale=1.0, rotation_y=0.0) -> MeshData:
    """Bake a rigid transform + uniform scale into a mesh (for scene assembly)."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pos = np.asarray(position, np.float64)

    def xp(p):
        return ((p * scale) @ r.T + pos).astype(np.float32)

    def xn(n):
        return (n @ r.T).astype(np.float32)

    return dataclasses.replace(
        mesh,
        p0=xp(mesh.p0), p1=xp(mesh.p1), p2=xp(mesh.p2),
        n0=xn(mesh.n0), n1=xn(mesh.n1), n2=xn(mesh.n2),
    )


def sponza_like(target_triangles: int = 260_000, seed: int = 7) -> MeshData:
    """Procedural stand-in for crytek-sponza (~262k tris): a two-story colonnaded
    atrium — floor, walls, column rows, arched beams, and rubble spheres.

    The reference's sponza.obj is absent from the snapshot (SURVEY.md section 6); this
    generates a workload with comparable triangle count, depth complexity, and material
    variety for the config[3] benchmark.
    """
    rng = np.random.default_rng(seed)

    def _noise_texture(size, base, variation, seed_, stripes=0):
        """Procedural texture (the real sponza is textured; keep the filter chain
        honest in benchmarks)."""
        r = np.random.default_rng(seed_)
        img = np.ones((size, size, 3), np.float32) * np.asarray(base, np.float32)
        n = r.normal(scale=variation, size=(size // 8, size // 8, 1)).astype(np.float32)
        n = n.repeat(8, 0).repeat(8, 1)
        img = np.clip(img + n, 0.02, 1.0)
        if stripes:
            y = np.arange(size)[:, None, None]
            img *= (0.82 + 0.18 * ((y // stripes) % 2)).astype(np.float32)
        return img

    materials = [
        Material(diffuse=np.array([0.65, 0.62, 0.55]),
                 texture_array=_noise_texture(256, [1, 0.97, 0.9], 0.08, 11)),  # stone
        Material(diffuse=np.array([0.55, 0.30, 0.20]),
                 texture_array=_noise_texture(256, [1, 0.8, 0.7], 0.1, 12, stripes=16)),  # brick
        Material(diffuse=np.array([0.70, 0.15, 0.12]),
                 texture_array=_noise_texture(128, [1, 0.9, 0.9], 0.05, 13)),  # fabric red
        Material(diffuse=np.array([0.20, 0.45, 0.25]),
                 texture_array=_noise_texture(128, [0.9, 1, 0.9], 0.05, 14)),  # fabric green
        Material(diffuse=np.array([0.8, 0.8, 0.85]), reflection=np.array([0.15, 0.15, 0.15])),
    ]
    parts = []

    def add(mesh, **kw):
        parts.append(transformed(mesh, **kw))

    # atrium footprint 36 x 16, height 12
    floor = quad(1.0, material_id=0, materials=materials)
    add(floor, position=(0, 0, 0), scale=40.0)

    # estimate budget-driven tessellation
    n_cols = 14
    col_segments = max(12, int(np.sqrt(target_triangles) / 6))
    sphere_sub = 3 if target_triangles < 150_000 else 4

    # column rows along +-z
    for zsign in (-1, 1):
        for i in range(n_cols):
            x = -16.0 + i * (32.0 / (n_cols - 1))
            for storey in range(2):
                y = 2.0 + storey * 4.2
                add(
                    cylinder(0.45, 4.0, col_segments, material_id=0, materials=materials),
                    position=(x, y, zsign * 6.0),
                )
                # capital + base
                add(
                    box((1.2, 0.35, 1.2), material_id=1, materials=materials),
                    position=(x, y + 2.15, zsign * 6.0),
                )
                add(
                    box((1.3, 0.3, 1.3), material_id=1, materials=materials),
                    position=(x, y - 2.1, zsign * 6.0),
                )

    # arches between columns: half-tori
    arch_major = 32.0 / (n_cols - 1) / 2.0
    arch_seg = max(16, col_segments)
    for zsign in (-1, 1):
        for i in range(n_cols - 1):
            x = -16.0 + (i + 0.5) * (32.0 / (n_cols - 1))
            for storey in range(2):
                y = 4.1 + storey * 4.2
                t = torus(arch_major, 0.25, arch_seg, 12, material_id=1, materials=materials)
                keep = t.p0[:, 1] + t.p1[:, 1] + t.p2[:, 1] > -0.2  # upper half
                t = MeshData(
                    *[getattr(t, f)[keep] for f in ("p0", "p1", "p2", "n0", "n1", "n2", "t0", "t1", "t2")],
                    material_id=t.material_id[keep],
                    materials=materials,
                )
                add(t, position=(x, y, zsign * 6.0))

    # outer walls
    for zsign in (-1, 1):
        add(box((40.0, 12.0, 0.5), material_id=1, materials=materials), position=(0, 6.0, zsign * 8.5))
    for xsign in (-1, 1):
        add(box((0.5, 12.0, 17.5), material_id=1, materials=materials), position=(xsign * 19.75, 6.0, 0))
    # ceiling slabs around the open atrium
    for zsign in (-1, 1):
        add(box((40.0, 0.4, 3.2), material_id=0, materials=materials), position=(0, 12.0, zsign * 7.0))

    # hanging fabric banners (subdivided quads with sine displacement)
    def banner(material_id):
        res = 24
        xs, ys = np.meshgrid(np.linspace(-1, 1, res), np.linspace(-1.6, 1.6, res))
        zs = 0.15 * np.sin(xs * 3.0) * np.cos(ys * 2.0)
        v = np.stack([xs, ys, zs], -1).reshape(-1, 3)
        uv = np.stack([(xs + 1) / 2, (ys + 1.6) / 3.2], -1).reshape(-1, 2)
        faces = []
        for a in range(res - 1):
            for b in range(res - 1):
                i00 = a * res + b
                faces += [[i00, i00 + 1, i00 + res], [i00 + 1, i00 + res + 1, i00 + res]]
        return from_indexed(v, np.array(faces), None, uv, material_id, materials)

    for i in range(8):
        x = -14.0 + i * 4.0
        add(banner(2 + (i % 2)), position=(x, 6.0, 0.0))

    # rubble spheres until the triangle budget is met
    base = MeshData.concatenate(parts)
    budget = target_triangles - base.triangle_count
    sph = icosphere(1.0, sphere_sub, material_id=4, materials=materials)
    n_spheres = max(0, budget // sph.triangle_count)
    for _ in range(n_spheres):
        pos = (rng.uniform(-17, 17), rng.uniform(0.3, 0.9), rng.uniform(-5, 5))
        add(sph, position=pos, scale=float(rng.uniform(0.25, 0.7)))

    return MeshData.concatenate(parts)
