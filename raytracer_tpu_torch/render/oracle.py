"""Scalar oracle renderer: the reference's recursive Whitted kernel, re-expressed
formula-for-formula in numpy, with NO acceleration structure (brute force over
every primitive) and NO wavefront machinery.

Purpose: an independent cross-implementation parity target for the wavefront
renderer (tests/test_oracle.py).  The production renderer re-associates the
reference's recursion into per-ray throughput state, batches all lights into one
traversal, compacts queues, runs straggler ladders, etc.; this module instead
keeps the reference's exact recursive composition (Raytracer.cpp:87-400):
per-pixel recursion, Beer's law applied by the PARENT on the child's returned
distance, Fresnel blending of the two recursive child colours, per-light
sequential shadow rays.  Agreement between the two ties the whole composed
pipeline — shading, Fresnel/Beer/TIR, light falloffs, differentials, texture
LOD — to the reference's math through two structurally unrelated evaluations.

Reference citations (everything here is a port of these, scalarized):
  - bounce/shading/Fresnel/Beer/TIR:  Raytracer.cpp:87-400
  - primary rays + differentials:     Raytracer.cpp:28-59
  - sphere closest/any hit:           Sphere.cpp:9-112
  - plane closest/any hit:            Plane.cpp:13-99
  - Moller-Trumbore + RTG ch.20:      BottomLevelBVH.cpp:214-346
  - instance transforms:              Mesh.cpp:17-40
  - lights:                           Light.h:12-26, PointLight.h:9-11,
                                      SpotLight.h:17-33, DirectionalLight.h:9-11
  - sky:                              Sky.cpp:28-67
  - texture filters:                  Texture.cpp:131-337
  - reflect/refract:                  Math.h:28-36

Known deliberate divergences from the reference binary (documented, matching
the production renderer where noted):
  - Beer distance is clamped to 1e8 instead of inf on a refracted miss
    (renderer.py module docstring: avoids the reference's NaN at
    transmittance == 1; identical for transmittance < 1).
  - The reference leaves mesh hit differentials in OBJECT space
    (BottomLevelBVH.cpp:291-301 never rotates dO/dN by the world matrix); the
    production renderer rotates them to world space.  The oracle keeps the
    reference behavior, so parity scenes use identity-rotation instances where
    the two conventions coincide (see tests/test_oracle.py).
"""

from __future__ import annotations

import numpy as np

from ..config import (
    AIR_IOR,
    MipmapFilter,
    RAY_EPSILON,
    RenderConfig,
    TextureSampleMode,
)

_F = np.float32
ONE_OVER_PI = _F(1.0 / np.pi)
ONE_OVER_TWO_PI = _F(0.5 / np.pi)
_EWA_ALPHA = 2.0
_EWA_TABLE_SIZE = 128


def _f2i(x):
    """Util::float_to_int (cvtss round-to-nearest); half-up like the scalar
    parity tests (ties are measure-zero under f32 workloads)."""
    return int(np.floor(x + 0.5))


def _pow2_128(x):
    """Math::pow2<128> repeated squaring (Math.h:80-96)."""
    for _ in range(7):
        x = x * x
    return x


def _normalize(v):
    return v / np.sqrt(np.dot(v, v))


class _Hit:
    """Scalar RayHit (RayHit.h:14-35)."""

    __slots__ = ("hit", "t", "point", "normal", "material_id", "u", "v",
                 "ds_dx", "ds_dy", "dt_dx", "dt_dy", "dO_dx", "dO_dy",
                 "dN_dx", "dN_dy")

    def __init__(self):
        self.hit = False
        self.t = np.inf
        self.point = np.zeros(3, _F)
        self.normal = np.zeros(3, _F)
        self.material_id = 0
        self.u = 0.0
        self.v = 0.0
        self.ds_dx = self.ds_dy = self.dt_dx = self.dt_dy = 0.0
        self.dO_dx = np.zeros(3, _F)
        self.dO_dy = np.zeros(3, _F)
        self.dN_dx = np.zeros(3, _F)
        self.dN_dy = np.zeros(3, _F)


class OracleRenderer:
    """Brute-force recursive scalar renderer over a packed DeviceScene."""

    def __init__(self, scene, cfg: RenderConfig):
        self.cfg = cfg
        s = {k: np.asarray(v) for k, v in scene._asdict().items()}
        self.s = type("NS", (), s)()
        # per-instance triangle id lists: walk each instance's binary BLAS
        # (internal: nd_left = left child, right = left + 1; leaf: nd_count > 0,
        # nd_left = first global triangle — scene/device.py packing)
        self.inst_tris = []
        for r in s["inst_root"]:
            ids = []
            stack = [int(r)]
            while stack:
                i = stack.pop()
                c = int(s["nd_count"][i])
                if c > 0:
                    ids.extend(range(int(s["nd_left"][i]),
                                     int(s["nd_left"][i]) + c))
                else:
                    stack.append(int(s["nd_left"][i]))
                    stack.append(int(s["nd_left"][i]) + 1)
            self.inst_tris.append(np.asarray(ids, np.int64))

    # ---- texture filtering (Texture.cpp:131-337), scalar ----

    def _fetch_texel(self, tid, x, y, level):
        s = self.s
        w = max(int(s.tex_width[tid]) >> level, 1)
        h = max(int(s.tex_height[tid]) >> level, 1)
        return s.tex_data[int(s.tex_offsets[tid, level]) + (x % w) + (y % h) * w]

    def _sample_bilinear(self, tid, u, v, level=0):
        s = self.s
        lw = max(int(s.tex_width[tid]) >> level, 1)
        lh = max(int(s.tex_height[tid]) >> level, 1)
        ss = _F(u * lw - 0.5)
        tt = _F(v * lh - 0.5)
        fs = ss - np.floor(ss)
        ft = tt - np.floor(tt)
        w0 = (1 - fs) * (1 - ft)
        w1 = fs * (1 - ft)
        w2 = (1 - fs) * ft
        w3 = 1 - w0 - w1 - w2
        x0 = _f2i(ss - 0.5)
        y0 = _f2i(tt - 0.5)
        return (
            w0 * self._fetch_texel(tid, x0, y0, level)
            + w1 * self._fetch_texel(tid, x0 + 1, y0, level)
            + w2 * self._fetch_texel(tid, x0, y0 + 1, level)
            + w3 * self._fetch_texel(tid, x0 + 1, y0 + 1, level)
        )

    def _sample_trilinear(self, tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy):
        s = self.s
        levels = int(s.tex_levels[tid])
        width = 2.0 * max(abs(ds_dx), abs(ds_dy), abs(dt_dx), abs(dt_dy))
        lam = levels - 1.0 + np.log2(max(width, 1e-8))
        level = _f2i(lam - 0.5)
        if level < 0:
            return self._sample_bilinear(tid, u, v)
        if level >= levels - 1:
            return self._fetch_texel(tid, 0, 0, levels - 1)
        f = lam - np.floor(lam)
        return (1.0 - f) * self._sample_bilinear(tid, u, v, level) + \
            f * self._sample_bilinear(tid, u, v, level + 1)

    def _sample_aniso(self, tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy):
        s = self.s
        levels = int(s.tex_levels[tid])
        p_x = max(abs(ds_dx), abs(dt_dx))
        p_y = max(abs(ds_dy), abs(dt_dy))
        p_min, p_max = min(p_x, p_y), max(p_x, p_y)
        n = min(np.ceil(p_max / p_min) if p_min > 0 else np.inf,
                self.cfg.max_anisotropy)
        lam = levels - 1.0 + np.log2(p_max / n) if p_max > 0 else -np.inf
        level = _f2i(lam) if np.isfinite(lam) else -1
        if level < 0:
            return self._sample_bilinear(tid, u, v)
        if level >= levels - 1:
            return self._fetch_texel(tid, 0, 0, levels - 1)
        x_major = p_x > p_y
        step_s = ds_dx if x_major else ds_dy
        step_t = dt_dx if x_major else dt_dy
        inv_np1 = 1.0 / (n + 1.0)
        acc = np.zeros(3, _F)
        i = 1.0
        while i <= n + 0.001:
            acc = acc + self._sample_bilinear(
                tid, u + step_s * (i * inv_np1 - 0.5),
                v + step_t * (i * inv_np1 - 0.5), level)
            i += 1.0
        return acc / n

    def _sample_ewa(self, tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy):
        s = self.s
        levels = int(s.tex_levels[tid])
        wf = float(s.tex_width[tid])
        hf = float(s.tex_height[tid])
        maj = np.array([ds_dx, dt_dx], _F)
        mnr = np.array([ds_dy, dt_dy], _F)
        maj_len = float(np.hypot(*maj))
        min_len = float(np.hypot(*mnr))
        if min_len > maj_len:
            maj, mnr = mnr, maj
            maj_len, min_len = min_len, maj_len
        if min_len < 1e-5:
            return self._sample_bilinear(tid, u, v)
        if maj_len > wf:
            return self._fetch_texel(tid, 0, 0, levels - 1)
        if min_len * self.cfg.max_anisotropy < maj_len:
            scale = maj_len / (min_len * self.cfg.max_anisotropy)
            mnr = mnr * scale
            min_len *= scale
        lam = max(0.0, levels - 1.0 + np.log2(min_len))
        level = _f2i(lam)
        if level >= levels - 1:
            return self._fetch_texel(tid, 0, 0, levels - 1)
        lw = float(max(int(s.tex_width[tid]) >> level, 1))
        lh = float(max(int(s.tex_height[tid]) >> level, 1))
        ss = u * lw - 0.5
        tt = v * lh - 0.5
        majx, majy = maj[0] * lw, maj[1] * lh
        mnrx, mnry = mnr[0] * lw, mnr[1] * lh
        a = 1.0 + (majy * majy + mnry * mnry)
        b = -2.0 * (majx * majy + mnrx * mnry)
        c = 1.0 + (majx * majx + mnrx * mnrx)
        inv_f = 1.0 / (a * c - b * b * 0.25)
        a, b, c = a * inv_f, b * inv_f, c * inv_f
        det = -b * b + 4.0 * a * c
        sqrt_u = np.sqrt(det * c)
        sqrt_v = np.sqrt(det * a)
        tid2 = 2.0 / det
        s0, s1 = _f2i(ss - tid2 * sqrt_u + 0.5), _f2i(ss + tid2 * sqrt_u - 0.5)
        t0, t1 = _f2i(tt - tid2 * sqrt_v + 0.5), _f2i(tt + tid2 * sqrt_v - 0.5)
        acc = np.zeros(3, _F)
        wsum = 0.0
        exp_na = np.exp(-_EWA_ALPHA)
        for tj in range(t0, t1 + 1):
            for si in range(s0, s1 + 1):
                uu = si - ss
                vv = tj - tt
                r2 = a * uu * uu + b * uu * vv + c * vv * vv
                if r2 < 1.0:
                    idx = min(_f2i(r2 * _EWA_TABLE_SIZE), _EWA_TABLE_SIZE - 1)
                    r2q = idx / (_EWA_TABLE_SIZE - 1)
                    w = np.exp(-_EWA_ALPHA * r2q) - exp_na
                    acc = acc + w * self._fetch_texel(tid, si, tj, level)
                    wsum += w
        return acc / wsum

    def _get_albedo(self, mid, u, v, ds_dx, ds_dy, dt_dx, dt_dy):
        """Material::get_albedo (Material.h:16-22) with the Texture::sample
        compile-time dispatch (Texture.h:33-49)."""
        s = self.s
        diffuse = s.mat_diffuse[mid]
        tid = int(s.mat_texture[mid])
        if tid == 0:
            return diffuse
        mode = self.cfg.texture_sample_mode
        if mode == TextureSampleMode.NEAREST:
            x = _f2i(u * float(s.tex_width[tid]))
            y = _f2i(v * float(s.tex_height[tid]))
            return diffuse * self._fetch_texel(tid, x, y, 0)
        if mode == TextureSampleMode.BILINEAR or int(s.tex_levels[tid]) == 1:
            return diffuse * self._sample_bilinear(tid, u, v)
        f = self.cfg.mipmap_filter
        if f == MipmapFilter.TRILINEAR:
            tex = self._sample_trilinear(tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy)
        elif f == MipmapFilter.ANISOTROPIC:
            tex = self._sample_aniso(tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy)
        else:
            tex = self._sample_ewa(tid, u, v, ds_dx, ds_dy, dt_dx, dt_dy)
        return diffuse * tex

    # ---- closest hit (Scene::trace_primitives, Scene.cpp:173-177) ----

    def _trace(self, o, d, dO_dx, dO_dy, dD_dx, dD_dy):
        s = self.s
        hit = _Hit()
        # spheres (Sphere.cpp:9-90)
        for i in range(s.sph_center.shape[0]):
            center = s.sph_center[i]
            radius = float(s.sph_radius[i])
            oc = o - center
            a = np.dot(d, d)
            b = 2.0 * np.dot(oc, d)
            c = np.dot(oc, oc) - radius * radius
            disc = b * b - 4.0 * a * c
            if disc < 0.0:
                continue
            sq = np.sqrt(disc)
            inv_denom = -1.0 / (2.0 * a)
            t0 = (b + sq) * inv_denom
            t1 = (b - sq) * inv_denom
            t = t0 if t0 > RAY_EPSILON else t1
            if not (RAY_EPSILON < t < hit.t):
                continue
            hit.hit = True
            hit.t = t
            hit.point = o + t * d
            hit.normal = (hit.point - center) / radius
            hit.material_id = int(s.sph_material[i])
            hit.u = float(np.arctan2(hit.normal[2], hit.normal[0])
                          * ONE_OVER_TWO_PI + 0.5)
            hit.v = float(np.arccos(np.clip(hit.normal[1], -1.0, 1.0))
                          * ONE_OVER_PI + 0.5)
            # Igehy transfer differentials (Sphere.cpp:63-88)
            qx = dO_dx + t * dD_dx
            qy = dO_dy + t * dD_dy
            denom = -1.0 / np.dot(d, hit.normal)
            dt_dx = np.dot(qx, hit.normal) * denom
            dt_dy = np.dot(qy, hit.normal) * denom
            dP_dx = qx + dt_dx * d
            dP_dy = qy + dt_dy * d
            hit.dO_dx, hit.dO_dy = dP_dx, dP_dy
            hit.dN_dx = dP_dx / radius
            hit.dN_dy = dP_dy / radius
            nx, ny, nz = hit.normal
            ds_den = ONE_OVER_TWO_PI / (nx * nx + nz * nz + 1e-8)
            hit.ds_dx = (nx * hit.dN_dx[2] - nz * hit.dN_dx[0]) * ds_den
            hit.ds_dy = (nx * hit.dN_dy[2] - nz * hit.dN_dy[0]) * ds_den
            dt_den = -ONE_OVER_PI / np.sqrt(1.0 - ny * ny + 1e-8)
            hit.dt_dx = hit.dN_dx[1] * dt_den
            hit.dt_dy = hit.dN_dy[1] * dt_den
        # planes (Plane.cpp:13-69)
        for i in range(s.pln_normal.shape[0]):
            normal = s.pln_normal[i]
            dist = float(s.pln_distance[i])
            t = -(np.dot(normal, o) + dist) / np.dot(normal, d)
            if not (RAY_EPSILON < t < hit.t):
                continue
            hit.hit = True
            hit.t = t
            hit.point = o + t * d
            hit.normal = normal.copy()
            hit.material_id = int(s.pln_material[i])
            hit.u = float(np.dot(hit.point, s.pln_u[i]))
            hit.v = float(np.dot(hit.point, s.pln_v[i]))
            qx = dO_dx + t * dD_dx
            qy = dO_dy + t * dD_dy
            denom = -1.0 / (np.dot(d, normal) + 1e-8)
            dt_dx = np.dot(qx, normal) * denom
            dt_dy = np.dot(qy, normal) * denom
            dP_dx = qx + dt_dx * d
            dP_dy = qy + dt_dy * d
            hit.dO_dx, hit.dO_dy = dP_dx, dP_dy
            hit.dN_dx = np.zeros(3, _F)
            hit.dN_dy = np.zeros(3, _F)
            hit.ds_dx = np.dot(dP_dx, s.pln_u[i])
            hit.ds_dy = np.dot(dP_dy, s.pln_u[i])
            hit.dt_dx = np.dot(dP_dx, s.pln_v[i])
            hit.dt_dy = np.dot(dP_dy, s.pln_v[i])
        # mesh instances: brute force every triangle (Mesh.cpp:17-31 +
        # BottomLevelBVH.cpp:214-309, no BVH)
        for ii in range(s.inst_root.shape[0]):
            inv = s.inst_inv[ii]  # [3,4]
            world = s.inst_world[ii]
            oo = inv[:, :3] @ o + inv[:, 3]
            dd = inv[:, :3] @ d
            ids = self.inst_tris[ii]
            p0 = s.tr_p0[ids]
            e1 = s.tr_e1[ids]
            e2 = s.tr_e2[ids]
            h = np.cross(np.broadcast_to(dd, e2.shape), e2)
            a = np.einsum("ij,ij->i", e1, h)
            with np.errstate(divide="ignore", invalid="ignore"):
                f = 1.0 / a
            sv = oo - p0
            u = f * np.einsum("ij,ij->i", sv, h)
            q = np.cross(sv, e1)
            v = f * (q @ dd)
            t = f * np.einsum("ij,ij->i", e2, q)
            ok = (u > 0) & (u < 1) & (v > 0) & (u + v < 1) & \
                 (t > RAY_EPSILON) & (t < hit.t)
            if not ok.any():
                continue
            j = int(np.flatnonzero(ok)[np.argmin(t[ok])])
            tj, uj, vj = float(t[j]), float(u[j]), float(v[j])
            gid = int(ids[j])
            hit.hit = True
            hit.t = tj
            # object-space differentials in, object-space out (Mesh.cpp:23-28,
            # BottomLevelBVH.cpp:277-305 — see module docstring)
            dOx_o = inv[:, :3] @ dO_dx
            dOy_o = inv[:, :3] @ dO_dy
            dDx_o = inv[:, :3] @ dD_dx
            dDy_o = inv[:, :3] @ dD_dy
            point_obj = oo + tj * dd
            hit.point = world[:, :3] @ point_obj + world[:, 3]
            n_raw = s.tr_n0[gid] + uj * s.tr_ne1[gid] + vj * s.tr_ne2[gid]
            hit.normal = world[:, :3] @ _normalize(n_raw)
            hit.material_id = int(s.tr_material[gid])
            uv = s.tr_t0[gid] + uj * s.tr_te1[gid] + vj * s.tr_te2[gid]
            hit.u, hit.v = float(uv[0]), float(uv[1])
            one_over_k = 1.0 / np.dot(np.cross(e1[j], e2[j]), dd)
            qx = dOx_o + tj * dDx_o
            qy = dOy_o + tj * dDy_o
            c_u = np.cross(e2[j], dd)
            c_v = np.cross(dd, e1[j])
            du_dx = one_over_k * np.dot(c_u, qx)
            du_dy = one_over_k * np.dot(c_u, qy)
            dv_dx = one_over_k * np.dot(c_v, qx)
            dv_dy = one_over_k * np.dot(c_v, qy)
            hit.dO_dx = du_dx * e1[j] + dv_dx * e2[j]
            hit.dO_dy = du_dy * e1[j] + dv_dy * e2[j]
            ne1, ne2 = s.tr_ne1[gid], s.tr_ne2[gid]
            dn_dx = du_dx * ne1 + dv_dx * ne2
            dn_dy = du_dy * ne1 + dv_dy * ne2
            n_dot_n = np.dot(n_raw, n_raw)
            n_den = 1.0 / (np.sqrt(n_dot_n) * n_dot_n)
            hit.dN_dx = (n_dot_n * dn_dx - np.dot(n_raw, dn_dx) * n_raw) * n_den
            hit.dN_dy = (n_dot_n * dn_dy - np.dot(n_raw, dn_dy) * n_raw) * n_den
            te1, te2 = s.tr_te1[gid], s.tr_te2[gid]
            hit.ds_dx = du_dx * te1[0] + dv_dx * te2[0]
            hit.ds_dy = du_dy * te1[0] + dv_dy * te2[0]
            hit.dt_dx = du_dx * te1[1] + dv_dx * te2[1]
            hit.dt_dy = du_dy * te1[1] + dv_dy * te2[1]
        return hit

    # ---- any hit (Scene::intersect_primitives, Scene.cpp:179-190) ----

    def _intersect(self, o, d, max_distance):
        s = self.s
        # spheres: cheap geometric any-hit (Sphere.cpp:92-112)
        for i in range(s.sph_center.shape[0]):
            c = s.sph_center[i] - o
            t = np.dot(c, d)
            qv = c - t * d
            p2 = np.dot(qv, qv)
            r2 = float(s.sph_radius[i]) ** 2
            if p2 < r2:
                t = t - np.sqrt(r2 - p2)
                if RAY_EPSILON < t < max_distance:
                    return True
        # planes (Plane.cpp:72-80)
        for i in range(s.pln_normal.shape[0]):
            normal = s.pln_normal[i]
            t = -(np.dot(normal, o) + float(s.pln_distance[i])) / np.dot(normal, d)
            if RAY_EPSILON < t < max_distance:
                return True
        # meshes (BottomLevelBVH.cpp:311-346)
        for ii in range(s.inst_root.shape[0]):
            inv = s.inst_inv[ii]
            oo = inv[:, :3] @ o + inv[:, 3]
            dd = inv[:, :3] @ d
            ids = self.inst_tris[ii]
            e1 = s.tr_e1[ids]
            e2 = s.tr_e2[ids]
            h = np.cross(np.broadcast_to(dd, e2.shape), e2)
            a = np.einsum("ij,ij->i", e1, h)
            with np.errstate(divide="ignore", invalid="ignore"):
                f = 1.0 / a
            sv = oo - s.tr_p0[ids]
            u = f * np.einsum("ij,ij->i", sv, h)
            q = np.cross(sv, e1)
            v = f * (q @ dd)
            t = f * np.einsum("ij,ij->i", e2, q)
            if ((u > 0) & (u < 1) & (v > 0) & (u + v < 1)
                    & (t > RAY_EPSILON) & (t < max_distance)).any():
                return True
        return False

    # ---- sky (Sky.cpp:28-67) ----

    def _sky(self, d):
        s = self.s
        size = int(s.sky_size)
        denom = np.sqrt(d[0] * d[0] + d[1] * d[1])
        r = 0.5 * ONE_OVER_PI * np.arccos(np.clip(d[2], -1.0, 1.0)) / \
            max(denom, 1e-12)
        u = d[0] * r + 0.5
        v = d[1] * r + 0.5
        x = _f2i(u * size)
        y = _f2i(v * size)
        idx = min(max(y * size + x, 0), size * size - 1)
        return ONE_OVER_PI * s.sky_data[idx]

    # ---- lights (Light.h:12-26 + subclasses) ----

    def _blinn_phong(self, normal, to_light, to_camera, colour):
        intensity = np.dot(normal, to_light)
        if intensity <= 0.0:
            return np.zeros(3, _F)
        half = _normalize(to_light + to_camera)
        intensity = intensity + _pow2_128(np.dot(normal, half))
        return intensity * colour

    # ---- the recursive bounce kernel (Raytracer.cpp:87-400) ----

    def bounce(self, o, d, dO_dx, dO_dy, dD_dx, dD_dy, bounces_left):
        """Returns (colour [3], distance) exactly like Raytracer::bounce."""
        s = self.s
        hit = self._trace(o, d, dO_dx, dO_dy, dD_dx, dD_dy)
        if not hit.hit:
            return self._sky(d), np.inf
        distance = hit.t

        albedo = self._get_albedo(hit.material_id, hit.u, hit.v, hit.ds_dx,
                                  hit.ds_dy, hit.dt_dx, hit.dt_dy)
        result = np.zeros(3, _F)
        if np.dot(albedo, albedo) > 0.0:
            diffuse = np.full(3, float(s.ambient), _F)
            to_camera = _normalize(s.cam_pos - hit.point)
            for i in range(s.pl_pos.shape[0]):
                to_l = s.pl_pos[i] - hit.point
                d2 = np.dot(to_l, to_l)
                dist = np.sqrt(d2)
                to_l = to_l / dist
                if not self._intersect(hit.point, to_l, dist):
                    diffuse = diffuse + self._blinn_phong(
                        hit.normal, to_l, to_camera, s.pl_colour[i]) / d2
            for i in range(s.sl_pos.shape[0]):
                to_l = s.sl_pos[i] - hit.point
                d2 = np.dot(to_l, to_l)
                dist = np.sqrt(d2)
                to_l = to_l / dist
                if not self._intersect(hit.point, to_l, dist):
                    dot = np.dot(to_l, s.sl_neg_dir[i])
                    outer = float(s.sl_outer[i])
                    inner = float(s.sl_inner[i])
                    if dot > outer:
                        radial = min((dot - outer) / (inner - outer), 1.0)
                        diffuse = diffuse + radial * self._blinn_phong(
                            hit.normal, to_l, to_camera, s.sl_colour[i]) / d2
            for i in range(s.dl_neg_dir.shape[0]):
                neg = s.dl_neg_dir[i]
                if not self._intersect(hit.point, neg, np.inf):
                    diffuse = diffuse + self._blinn_phong(
                        hit.normal, neg, to_camera, s.dl_colour[i])
            result = result + diffuse * albedo

        if bounces_left > 0:
            refl_c = s.mat_reflection[hit.material_id]
            trans_c = s.mat_transmittance[hit.material_id]
            colour_reflection = np.zeros(3, _F)
            has_refl = np.dot(refl_c, refl_c) > 0.0
            has_refr = np.dot(trans_c, trans_c) > 0.0

            if has_refl:
                refl_dir = d - 2.0 * np.dot(d, hit.normal) * hit.normal
                ddn_dx = np.dot(dD_dx, hit.normal) + np.dot(d, hit.dN_dx)
                ddn_dy = np.dot(dD_dy, hit.normal) + np.dot(d, hit.dN_dy)
                dot_dn = np.dot(d, hit.normal)
                refl_dD_dx = dD_dx - 2.0 * (dot_dn * hit.dN_dx
                                            + ddn_dx * hit.normal)
                refl_dD_dy = dD_dy - 2.0 * (dot_dn * hit.dN_dy
                                            + ddn_dy * hit.normal)
                child, _ = self.bounce(hit.point, refl_dir, hit.dO_dx,
                                       hit.dO_dy, refl_dD_dx, refl_dD_dy,
                                       bounces_left - 1)
                colour_reflection = refl_c * child
                result = result + colour_reflection

            if has_refr:
                dot = np.dot(d, hit.normal)
                entering = dot < 0.0
                ior = float(s.mat_ior[hit.material_id])
                n_1 = AIR_IOR if entering else ior
                n_2 = ior if entering else AIR_IOR
                cos_theta = -dot if entering else dot
                normal = hit.normal if entering else -hit.normal
                eta = n_1 / n_2
                k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
                if k < 0.0:  # total internal reflection (Raytracer.cpp:311-314)
                    return result + colour_reflection, distance
                refr_dir = eta * d + (eta * cos_theta - np.sqrt(k)) * normal
                ddn_dx = np.dot(dD_dx, hit.normal) + np.dot(d, hit.dN_dx)
                ddn_dy = np.dot(dD_dy, hit.normal) + np.dot(d, hit.dN_dy)
                mu = -(eta * cos_theta + (-np.sqrt(k)))
                refr_dD_dx = eta * dD_dx - (
                    mu * (-cos_theta) + np.dot(hit.dN_dx, hit.normal)
                    * hit.normal) * ddn_dx
                refr_dD_dy = eta * dD_dy - (
                    mu * (-cos_theta) + np.dot(hit.dN_dy, hit.normal)
                    * hit.normal) * ddn_dy
                child, refr_dist = self.bounce(
                    hit.point, refr_dir, hit.dO_dx, hit.dO_dy, refr_dD_dx,
                    refr_dD_dy, bounces_left - 1)
                if entering:  # Beer's law (Raytracer.cpp:348-376)
                    child = child * np.exp(
                        (trans_c - 1.0) * min(refr_dist, 1.0e8))
                r0 = (n_1 - n_2) / (n_1 + n_2)
                r0 = r0 * r0
                if n_1 > n_2:
                    cos_theta = -np.dot(refr_dir, normal)
                omc = 1.0 - cos_theta
                omc2 = omc * omc
                f_r = r0 + ((1.0 - r0) * omc2) * (omc2 * omc)
                f_t = 1.0 - f_r
                result = result + f_r * colour_reflection + f_t * child

        return result, distance

    def render(self):
        """Full-frame render (Raytracer.cpp:3-85): [H,W,3] linear radiance."""
        cfg = self.cfg
        s = self.s
        img = np.zeros((cfg.height, cfg.width, 3), _F)
        zeros = np.zeros(3, _F)
        for j in range(cfg.height):
            for i in range(cfg.width):
                direction = s.cam_x * i + s.cam_y * j + s.cam_top_left
                d_dot_d = np.dot(direction, direction)
                inv_len = 1.0 / np.sqrt(d_dot_d)
                denom = inv_len / d_dot_d
                dD_dx = (d_dot_d * s.cam_x
                         - np.dot(direction, s.cam_x) * direction) * denom
                dD_dy = (d_dot_d * s.cam_y
                         - np.dot(direction, s.cam_y) * direction) * denom
                colour, _ = self.bounce(
                    s.cam_pos, direction * inv_len, zeros, zeros,
                    dD_dx, dD_dy, cfg.num_bounces)
                img[j, i] = colour
        return img
