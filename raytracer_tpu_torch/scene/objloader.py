"""Host-side Wavefront OBJ/MTL loader.

Replaces the reference's tinyobjloader wrapper (OBJLoader.cpp): flattens all shapes into
one triangle soup with per-triangle local material ids, v-flips texcoords
(OBJLoader.cpp:141-143), and maps MTL fields the same way load_materials does
(OBJLoader.cpp:8-41): Kd -> diffuse, map_Kd -> texture, Ks -> reflection, Tf/Kt ->
transmittance, Ni -> index_of_refraction.  A mesh with no .mtl gets the magenta
fallback material (OBJLoader.cpp:33-38).
"""

from __future__ import annotations

import os

import numpy as np

from .meshgen import MeshData


def load_mtl(path: str) -> dict:
    """Parse a .mtl file -> {name: Material}. Missing file -> empty dict."""
    from .description import Material

    materials = {}
    if not os.path.exists(path):
        return materials
    cur = None
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = Material()
                materials[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.diffuse = np.array([float(x) for x in parts[1:4]])
            elif key == "Ks":
                cur.reflection = np.array([float(x) for x in parts[1:4]])
            elif key in ("Tf", "Kt"):
                cur.transmittance = np.array([float(x) for x in parts[1:4]])
            elif key == "Ni":
                cur.index_of_refraction = float(parts[1])
            elif key == "map_Kd":
                # normalize Windows separators: real-world MTLs (e.g. the
                # crytek sponza.mtl shipped in the reference Data dir) write
                # "textures\\lion.tga"; the reference is a Windows program so
                # tinyobj resolves them natively — a portable loader must too
                rel = " ".join(parts[1:]).replace("\\", "/")
                cur.texture_path = os.path.normpath(os.path.join(base, rel))
    return materials


def load_obj(path: str) -> MeshData:
    """Load an .obj (+ sibling .mtl) into a flat triangle soup (OBJLoader.cpp:69-188)."""
    from .description import Material

    positions: list = []
    texcoords: list = []
    normals: list = []
    tris: list = []  # (v_idx[3], vt_idx[3], vn_idx[3], mat_id)

    mtl_materials: dict = {}
    mat_ids: dict = {}
    materials: list = []
    cur_mat = -1

    def get_mat_id(name: str) -> int:
        if name not in mat_ids:
            if name in mtl_materials:
                mat_ids[name] = len(materials)
                materials.append(mtl_materials[name])
            else:
                return -1
        return mat_ids[name]

    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "mtllib":
                mtl_materials.update(load_mtl(os.path.join(base, " ".join(parts[1:]))))
            elif key == "usemtl":
                cur_mat = get_mat_id(parts[1] if len(parts) > 1 else "")
            elif key == "f":
                corners = []
                for token in parts[1:]:
                    comps = token.split("/")
                    vi = int(comps[0])
                    vti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    vni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    corners.append((vi, vti, vni))
                # fan-triangulate polygons
                for i in range(1, len(corners) - 1):
                    tris.append((corners[0], corners[i], corners[i + 1], cur_mat))

    if not materials:
        # magenta fallback (OBJLoader.cpp:33-38)
        materials = [Material(diffuse=np.array([1.0, 0.0, 1.0]))]

    n_pos, n_tex, n_nrm = len(positions), len(texcoords), len(normals)
    pos = np.asarray(positions, np.float64).reshape(n_pos, 3)
    tex = (
        np.asarray(texcoords, np.float64).reshape(n_tex, 2)
        if n_tex
        else np.zeros((1, 2))
    )
    nrm = (
        np.asarray(normals, np.float64).reshape(n_nrm, 3) if n_nrm else np.zeros((1, 3))
    )

    t = len(tris)
    vi = np.zeros((t, 3), np.int64)
    vti = np.zeros((t, 3), np.int64)
    vni = np.zeros((t, 3), np.int64)
    mat = np.zeros((t,), np.int32)
    for k, (c0, c1, c2, m) in enumerate(tris):
        for j, c in enumerate((c0, c1, c2)):
            vi[k, j] = c[0] - 1 if c[0] > 0 else n_pos + c[0]
            vti[k, j] = c[1] - 1 if c[1] > 0 else (n_tex + c[1] if c[1] < 0 else -1)
            vni[k, j] = c[2] - 1 if c[2] > 0 else (n_nrm + c[2] if c[2] < 0 else -1)
        mat[k] = m if m >= 0 else 0

    p = [pos[vi[:, j]] for j in range(3)]

    # texcoords: v-flip (OBJLoader.cpp:141-143); missing -> (0,0)
    tc = []
    for j in range(3):
        has = vti[:, j] >= 0
        tj = tex[np.where(has, vti[:, j], 0)]
        tj = np.where(has[:, None], np.stack([tj[:, 0], 1.0 - tj[:, 1]], axis=1), 0.0)
        tc.append(tj)

    # normals: per-vertex if present, else geometric face normal
    face_n = np.cross(p[1] - p[0], p[2] - p[0])
    face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-20)
    nn = []
    for j in range(3):
        has = vni[:, j] >= 0
        nj = nrm[np.where(has, vni[:, j], 0)]
        nn.append(np.where(has[:, None], nj, face_n))

    return MeshData(
        p0=p[0].astype(np.float32), p1=p[1].astype(np.float32), p2=p[2].astype(np.float32),
        n0=nn[0].astype(np.float32), n1=nn[1].astype(np.float32), n2=nn[2].astype(np.float32),
        t0=tc[0].astype(np.float32), t1=tc[1].astype(np.float32), t2=tc[2].astype(np.float32),
        material_id=mat,
        materials=materials,
    )
