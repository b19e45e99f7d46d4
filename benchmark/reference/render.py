"""The plain reference renderer: the reference's recursive Whitted kernel
(clayne/CPU-Raytracer Raytracer.cpp:87-400), evaluated in plain PyTorch over a
batch of pixels, brute force over every primitive, with no acceleration structure
and no wavefront machinery.

It is the formulas of the program's scalar oracle (``raytracer_tpu_torch/
render/oracle.py:99-614``) vectorised over rays, and it imports nothing of the
program.  It starts from the benchmark's plain scene data (``yardstick/rawscene``)
and works out again what the program derives from it: triangle edges, world and
inverse instance matrices, plane axes, light directions and cut-offs, the
material table, every texture's mip chain, and the camera's view pyramid.

Departures from the oracle, each the program's stated semantics:
  - mesh hit differentials are rotated to world space (the oracle keeps the
    reference binary's object space, oracle.py:34-40; the program's default
    ``differentials_object_space=False``);
  - a mesh hit's point is ``o + t d`` in world space (hits.py:92), which equals
    the oracle's transformed object-space point for the rigid instances here;
  - normalisation is ``x * rsqrt(|x|^2 + eps)`` (vecmath.py:37-39).
Only the texture modes the configurations use are written: MIPMAP with the
ANISOTROPIC filter, and its bilinear fall-backs.  Another mode raises.

``dtype`` sets the precision of every floating-point tensor.  The benchmark runs
it in float32, the precision the configurations state; the control runs it in
bfloat16 (``benchmark/run.py --control 1``), and must fail the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from ..yardstick import assets, geometry

RAY_EPSILON = 0.005  # Ray.h:5
AIR_IOR = 1.0  # Material.h:24
BEER_CLAMP = 1.0e8  # renderer.py:58, oracle.py:30-33
ONE_OVER_PI = 1.0 / np.pi
ONE_OVER_TWO_PI = 0.5 / np.pi
# rays x triangles a brute-force block holds (64 M elements of float32 a temporary)
BLOCK_ELEMENTS = 1 << 24


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(a, eps=0.0):
    return a * torch.rsqrt(_dot(a, a) + eps)[..., None]


def _xp(m, p):
    """[3,4] matrix applied to points [N,3], as component sums."""
    return torch.stack([m[r, 0] * p[:, 0] + m[r, 1] * p[:, 1] + m[r, 2] * p[:, 2] + m[r, 3]
                        for r in range(3)], dim=-1)


def _xd(m, d):
    return torch.stack([m[r, 0] * d[:, 0] + m[r, 1] * d[:, 1] + m[r, 2] * d[:, 2]
                        for r in range(3)], dim=-1)


def _pow2_128(x):
    for _ in range(7):  # Math.h:80-96
        x = x * x
    return x


class Reference:
    """Renders pixels of a ``RawScene`` at a render size (``config``:
    ``resolution``, ``num_bounces``, ``texture_sample_mode``, ``mipmap_filter``,
    ``max_anisotropy``)."""

    def __init__(self, raw, config: dict, device, dtype=torch.float32):
        if config["texture_sample_mode"] != "MIPMAP" or config["mipmap_filter"] != "ANISOTROPIC":
            raise NotImplementedError("the reference samples MIPMAP + ANISOTROPIC only")
        self.dev = torch.device(device)
        self.dtype = dtype
        self.width, self.height = (int(x) for x in config["resolution"])
        self.bounces = int(config["num_bounces"])
        self.max_aniso = float(config["max_anisotropy"])
        self.raw = raw
        f = self._f

        # materials: one table; 0 is unused, textures get atlas ids from 1
        mats, textures = [], []

        def material(m) -> int:
            tid = 0
            if m.texture_array is not None:
                textures.append(assets.mip_chain(m.texture_array))
                tid = len(textures)
            mats.append((m.diffuse, m.reflection, m.transmittance, m.index_of_refraction, tid))
            return len(mats) - 1

        self.spheres = [(f(s.position), float(np.float32(s.radius)), material(s.material))
                        for s in raw.spheres]
        self.planes = []
        for p in raw.planes:  # PlaneDesc.world_arrays (description.py:99-106)
            r = geometry.to_matrix3(p.rotation)
            normal = r @ np.array([0.0, 1.0, 0.0])
            u_axis = r @ np.array([1.0, 0.0, 0.0])
            self.planes.append((f(normal), float(np.float32(-np.dot(normal, p.position))),
                                f(u_axis), f(np.cross(u_axis, normal)), material(p.material)))
        self.meshes = {}
        for key, mesh in raw.meshes.items():
            base = len(mats)
            for m in mesh.materials:
                material(m)
            p0 = np.asarray(mesh.p0, np.float32)
            self.meshes[key] = dict(
                p0=f(p0), e1=f(np.asarray(mesh.p1, np.float32) - p0),
                e2=f(np.asarray(mesh.p2, np.float32) - p0),
                n0=f(mesh.n0), ne1=f(np.asarray(mesh.n1, np.float32) - mesh.n0),
                ne2=f(np.asarray(mesh.n2, np.float32) - mesh.n0),
                t0=f(mesh.t0), te1=f(np.asarray(mesh.t1, np.float32) - mesh.t0),
                te2=f(np.asarray(mesh.t2, np.float32) - mesh.t0),
                mid=torch.as_tensor(np.asarray(mesh.material_id, np.int64) + base,
                                    device=self.dev))
        self.mat_diffuse = f(np.stack([m[0] for m in mats]))
        self.mat_reflection = f(np.stack([m[1] for m in mats]))
        self.mat_transmittance = f(np.stack([m[2] for m in mats]))
        self.mat_ior = f(np.array([m[3] for m in mats]))
        self.mat_texture = torch.as_tensor([m[4] for m in mats], device=self.dev)

        # textures: one flat table of every level, with each level's size and offset
        data, widths, heights, levels, offsets = [np.zeros((1, 3), np.float32)], [1], [1], [1], [[0]]
        total = 1
        for chain in textures:
            widths.append(chain[0].shape[1])
            heights.append(chain[0].shape[0])
            levels.append(len(chain))
            offs = []
            for lv in chain:
                offs.append(total)
                data.append(lv.reshape(-1, 3))
                total += lv.shape[0] * lv.shape[1]
            offsets.append(offs)
        pad = max(len(o) for o in offsets)
        self.tex_data = f(np.concatenate(data))
        self.tex_width = torch.as_tensor(widths, device=self.dev)
        self.tex_height = torch.as_tensor(heights, device=self.dev)
        self.tex_levels = torch.as_tensor(levels, device=self.dev)
        self.tex_offsets = torch.as_tensor([o + [0] * (pad - len(o)) for o in offsets],
                                           device=self.dev)

        def unit(v):
            v = np.asarray(v, np.float64)
            return v / np.linalg.norm(v)

        self.point_lights = [(f(c), f(p)) for c, p in raw.point_lights]
        self.spot_lights = [(f(s.colour), f(s.position), f(-unit(s.direction)),
                             float(np.float32(np.cos(np.deg2rad(0.5 * s.inner_angle_deg)))),
                             float(np.float32(np.cos(np.deg2rad(0.5 * s.outer_angle_deg)))))
                            for s in raw.spot_lights]
        self.directional_lights = [(f(c), f(-unit(d))) for c, d in raw.directional_lights]
        self.sky = f(raw.sky_data)
        self.sky_size = int(raw.sky_size)
        self.ambient = float(np.float32(raw.ambient))
        self.set_instances(raw.instances)

    def _f(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.dev).to(self.dtype)

    def set_instances(self, instances) -> None:
        """World and inverse [3,4] matrices of each instance (description.py:27-28,
        device.py:292-294), from its position and rotation."""
        self.instances = []
        for inst in instances:
            m = np.eye(4)
            m[:3, :3] = geometry.to_matrix3(inst.rotation)
            m[:3, 3] = inst.position
            self.instances.append((inst.mesh, self._f(m[:3, :4]),
                                   self._f(np.linalg.inv(m)[:3, :4])))

    def camera(self, position, rotation) -> dict:
        cam = geometry.camera_arrays(position, rotation, self.width, self.height,
                                     self.raw.fov)
        return {k: self._f(v) for k, v in cam.items()}

    # ---- primary rays (Raytracer.cpp:28-59; renderer.py:81-113) ----

    def render(self, cam: dict, pixels: torch.Tensor) -> torch.Tensor:
        """[N,3] float32 linear radiance of the row-major pixel indices ``pixels``."""
        pixels = pixels.to(self.dev)
        i = (pixels % self.width).to(self.dtype)
        j = (pixels // self.width).to(self.dtype)
        cx, cy = cam["cam_x"], cam["cam_y"]
        direction = cx[None] * i[:, None] + cy[None] * j[:, None] + cam["cam_top_left"][None]
        d_dot_d = _dot(direction, direction)
        inv_len = torch.rsqrt(d_dot_d)
        denom = (inv_len / d_dot_d)[:, None]
        dD_dx = (d_dot_d[:, None] * cx - _dot(direction, cx.expand(direction.shape))[:, None]
                 * direction) * denom
        dD_dy = (d_dot_d[:, None] * cy - _dot(direction, cy.expand(direction.shape))[:, None]
                 * direction) * denom
        n = pixels.shape[0]
        zeros = torch.zeros((n, 3), dtype=self.dtype, device=self.dev)
        rays = (cam["cam_pos"].expand(n, 3), direction * inv_len[:, None], zeros, zeros,
                dD_dx, dD_dy)
        colour, _ = self._bounce(cam["cam_pos"], rays, self.bounces)
        return colour.float()

    # ---- closest hit (Scene::trace_primitives; oracle.py:277-420) ----

    def _miss(self, n):
        z = torch.zeros((n,), dtype=self.dtype, device=self.dev)
        z3 = torch.zeros((n, 3), dtype=self.dtype, device=self.dev)
        return dict(hit=torch.zeros((n,), dtype=torch.bool, device=self.dev),
                    t=torch.full((n,), float("inf"), dtype=self.dtype, device=self.dev),
                    point=z3, normal=z3, mid=torch.zeros((n,), dtype=torch.long, device=self.dev),
                    u=z, v=z, ds_dx=z, ds_dy=z, dt_dx=z, dt_dy=z, dO_dx=z3, dO_dy=z3,
                    dN_dx=z3, dN_dy=z3)

    @staticmethod
    def _take(rec, new, mask):
        for k, v in new.items():
            m = mask if v.dim() == 1 else mask[:, None]
            rec[k] = torch.where(m, v, rec[k])

    @staticmethod
    def _transfer(rays, t, normal):
        o, d, dO_dx, dO_dy, dD_dx, dD_dy = rays
        qx = dO_dx + t[:, None] * dD_dx
        qy = dO_dy + t[:, None] * dD_dy
        den = -1.0 / (_dot(d, normal) + 1e-8)
        return qx + (_dot(qx, normal) * den)[:, None] * d, qy + (_dot(qy, normal) * den)[:, None] * d

    def _trace(self, rays):
        o, d = rays[0], rays[1]
        n = o.shape[0]
        rec = self._miss(n)
        for center, radius, mid in self.spheres:  # Sphere.cpp:9-90
            oc = o - center
            a = _dot(d, d)
            b = 2.0 * _dot(oc, d)
            c = _dot(oc, oc) - radius * radius
            disc = b * b - 4.0 * a * c
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            inv_denom = -1.0 / (2.0 * a)
            t0 = (b + sq) * inv_denom
            t1 = (b - sq) * inv_denom
            t = torch.where(t0 > RAY_EPSILON, t0, t1)
            ok = (disc >= 0.0) & (t > RAY_EPSILON) & (t < rec["t"])
            point = o + t[:, None] * d
            normal = (point - center) / radius
            nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
            pole = nx * nx + nz * nz < 1e-12
            one = torch.ones_like(t)
            u = torch.atan2(torch.where(pole, one, nz), torch.where(pole, one, nx)) \
                * ONE_OVER_TWO_PI + 0.5
            v = torch.arccos(torch.clamp(ny, -1.0 + 1e-6, 1.0 - 1e-6)) * ONE_OVER_PI + 0.5
            dP_dx, dP_dy = self._transfer(rays, t, normal)
            dN_dx, dN_dy = dP_dx / radius, dP_dy / radius
            ds_den = ONE_OVER_TWO_PI / (nx * nx + nz * nz + 1e-8)
            dt_den = -ONE_OVER_PI / (torch.sqrt(torch.clamp_min(1.0 - ny * ny, 0.0)) + 1e-8)
            self._take(rec, dict(
                hit=torch.ones_like(ok), t=t, point=point, normal=normal,
                mid=torch.full_like(rec["mid"], mid), u=u, v=v,
                ds_dx=(nx * dN_dx[:, 2] - nz * dN_dx[:, 0]) * ds_den,
                ds_dy=(nx * dN_dy[:, 2] - nz * dN_dy[:, 0]) * ds_den,
                dt_dx=dN_dx[:, 1] * dt_den, dt_dy=dN_dy[:, 1] * dt_den,
                dO_dx=dP_dx, dO_dy=dP_dy, dN_dx=dN_dx, dN_dy=dN_dy), ok)
        for normal, dist, u_axis, v_axis, mid in self.planes:  # Plane.cpp:13-69
            den = _dot(d, normal[None])
            den = torch.where(den.abs() < 1e-20, torch.where(den < 0, -1e-20, 1e-20).to(den.dtype), den)
            t = -(_dot(o, normal[None]) + dist) / den
            ok = (t > RAY_EPSILON) & (t < rec["t"])
            point = o + t[:, None] * d
            nrm = normal.expand(n, 3)
            dP_dx, dP_dy = self._transfer(rays, t, nrm)
            z3 = torch.zeros_like(point)
            self._take(rec, dict(
                hit=torch.ones_like(ok), t=t, point=point, normal=nrm,
                mid=torch.full_like(rec["mid"], mid), u=_dot(point, u_axis[None]),
                v=_dot(point, v_axis[None]), ds_dx=_dot(dP_dx, u_axis[None]),
                ds_dy=_dot(dP_dy, u_axis[None]), dt_dx=_dot(dP_dx, v_axis[None]),
                dt_dy=_dot(dP_dy, v_axis[None]), dO_dx=dP_dx, dO_dy=dP_dy, dN_dx=z3,
                dN_dy=z3), ok)
        for key, world, inv in self.instances:  # Mesh.cpp:17-31, BottomLevelBVH.cpp:214-309
            mesh = self.meshes[key]
            oo, dd = _xp(inv, o), _xd(inv, d)
            t, j, u, v = self._closest(mesh, oo, dd, rec["t"])
            ok = j >= 0
            if not bool(ok.any()):
                continue
            self._take(rec, self._mesh_record(mesh, rays, world, inv, dd, t, j.clamp_min(0),
                                              u, v), ok)
        return rec

    def _mt(self, mesh, o, d, lo, hi):
        """Moller-Trumbore (BottomLevelBVH.cpp:214-258) of rays [R] against
        triangles [lo, hi): (t, u, v, valid) [R, hi - lo]."""
        p0, e1, e2 = mesh["p0"][lo:hi][None], mesh["e1"][lo:hi][None], mesh["e2"][lo:hi][None]
        dx, dy, dz = d[:, 0, None], d[:, 1, None], d[:, 2, None]
        hx = dy * e2[..., 2] - dz * e2[..., 1]
        hy = dz * e2[..., 0] - dx * e2[..., 2]
        hz = dx * e2[..., 1] - dy * e2[..., 0]
        a = e1[..., 0] * hx + e1[..., 1] * hy + e1[..., 2] * hz
        f = 1.0 / torch.where(torch.abs(a) < 1e-30, 1e-30, a)
        sx = o[:, 0, None] - p0[..., 0]
        sy = o[:, 1, None] - p0[..., 1]
        sz = o[:, 2, None] - p0[..., 2]
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1[..., 2] - sz * e1[..., 1]
        qy = sz * e1[..., 0] - sx * e1[..., 2]
        qz = sx * e1[..., 1] - sy * e1[..., 0]
        v = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz)
        ok = (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > RAY_EPSILON)
        return t, u, v, ok

    def _blocks(self, n_rays, n_tris):
        rays = max(1, BLOCK_ELEMENTS // max(n_tris, 1))
        tris = min(n_tris, BLOCK_ELEMENTS)
        for r0 in range(0, n_rays, rays):
            for t0 in range(0, n_tris, tris):
                yield r0, min(r0 + rays, n_rays), t0, min(t0 + tris, n_tris)

    def _closest(self, mesh, o, d, t_max):
        """Per ray the nearest triangle hit with t < t_max: (t, index or -1, u, v);
        the lowest index wins a tie."""
        n, nt = o.shape[0], mesh["p0"].shape[0]
        best_t = t_max.clone()
        best_j = torch.full((n,), -1, dtype=torch.long, device=self.dev)
        best_u = torch.zeros_like(best_t)
        best_v = torch.zeros_like(best_t)
        for r0, r1, t0, t1 in self._blocks(n, nt):
            t, u, v, ok = self._mt(mesh, o[r0:r1], d[r0:r1], t0, t1)
            t = torch.where(ok, t, float("inf"))
            k = torch.argmin(t, dim=1, keepdim=True)
            tk = torch.gather(t, 1, k)[:, 0]
            better = tk < best_t[r0:r1]
            best_t[r0:r1] = torch.where(better, tk, best_t[r0:r1])
            best_j[r0:r1] = torch.where(better, k[:, 0] + t0, best_j[r0:r1])
            best_u[r0:r1] = torch.where(better, torch.gather(u, 1, k)[:, 0], best_u[r0:r1])
            best_v[r0:r1] = torch.where(better, torch.gather(v, 1, k)[:, 0], best_v[r0:r1])
        return best_t, best_j, best_u, best_v

    def _any(self, mesh, o, d, t_max):
        n, nt = o.shape[0], mesh["p0"].shape[0]
        found = torch.zeros((n,), dtype=torch.bool, device=self.dev)
        for r0, r1, t0, t1 in self._blocks(n, nt):
            t, _, _, ok = self._mt(mesh, o[r0:r1], d[r0:r1], t0, t1)
            found[r0:r1] |= (ok & (t < t_max[r0:r1, None])).any(dim=1)
        return found

    def _mesh_record(self, mesh, rays, world, inv, dd, t, j, u, v):
        """The hit record of triangle j (BottomLevelBVH.cpp:260-309, hits.py:58-157),
        its differentials rotated to world space."""
        o, d, dO_dx, dO_dy, dD_dx, dD_dy = rays
        g = {k: mesh[k].index_select(0, j) for k in ("e1", "e2", "n0", "ne1", "ne2", "t0",
                                                      "te1", "te2")}
        e1, e2 = g["e1"], g["e2"]
        n_raw = g["n0"] + u[:, None] * g["ne1"] + v[:, None] * g["ne2"]
        uv = g["t0"] + u[:, None] * g["te1"] + v[:, None] * g["te2"]
        one_over_k = 1.0 / _dot(_cross(e1, e2), dd)
        qx = _xd(inv, dO_dx) + t[:, None] * _xd(inv, dD_dx)
        qy = _xd(inv, dO_dy) + t[:, None] * _xd(inv, dD_dy)
        c_u, c_v = _cross(e2, dd), _cross(dd, e1)
        du_dx, du_dy = one_over_k * _dot(c_u, qx), one_over_k * _dot(c_u, qy)
        dv_dx, dv_dy = one_over_k * _dot(c_v, qx), one_over_k * _dot(c_v, qy)
        dn_dx = du_dx[:, None] * g["ne1"] + dv_dx[:, None] * g["ne2"]
        dn_dy = du_dy[:, None] * g["ne1"] + dv_dy[:, None] * g["ne2"]
        n_dot_n = _dot(n_raw, n_raw) + 1e-20
        n_den = (torch.rsqrt(n_dot_n) / n_dot_n)[:, None]
        te1, te2 = g["te1"], g["te2"]
        return dict(
            hit=torch.ones_like(j, dtype=torch.bool), t=t, point=o + t[:, None] * d,
            normal=_xd(world, _normalize(n_raw, 1e-20)), mid=mesh["mid"].index_select(0, j),
            u=uv[:, 0], v=uv[:, 1],
            ds_dx=du_dx * te1[:, 0] + dv_dx * te2[:, 0],
            ds_dy=du_dy * te1[:, 0] + dv_dy * te2[:, 0],
            dt_dx=du_dx * te1[:, 1] + dv_dx * te2[:, 1],
            dt_dy=du_dy * te1[:, 1] + dv_dy * te2[:, 1],
            dO_dx=_xd(world, du_dx[:, None] * e1 + dv_dx[:, None] * e2),
            dO_dy=_xd(world, du_dy[:, None] * e1 + dv_dy[:, None] * e2),
            dN_dx=_xd(world, (n_dot_n[:, None] * dn_dx - _dot(n_raw, dn_dx)[:, None] * n_raw)
                      * n_den),
            dN_dy=_xd(world, (n_dot_n[:, None] * dn_dy - _dot(n_raw, dn_dy)[:, None] * n_raw)
                      * n_den))

    # ---- any hit (Scene::intersect_primitives; oracle.py:422-463) ----

    def _blocked(self, o, d, max_distance):
        blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=self.dev)
        for center, radius, _ in self.spheres:  # Sphere.cpp:92-112
            c = center[None] - o
            t = _dot(c, d)
            q = c - t[:, None] * d
            p2 = _dot(q, q)
            r2 = radius * radius
            t = t - torch.sqrt(torch.clamp_min(r2 - p2, 0.0))
            blocked |= (p2 < r2) & (t > RAY_EPSILON) & (t < max_distance)
        for normal, dist, _, _, _ in self.planes:  # Plane.cpp:72-80
            den = _dot(d, normal[None])
            den = torch.where(den.abs() < 1e-20, torch.where(den < 0, -1e-20, 1e-20).to(den.dtype), den)
            t = -(_dot(o, normal[None]) + dist) / den
            blocked |= (t > RAY_EPSILON) & (t < max_distance)
        for key, _, inv in self.instances:  # BottomLevelBVH.cpp:311-346
            left = ~blocked
            if not bool(left.any()):
                break
            idx = torch.nonzero(left)[:, 0]
            oo, dd = _xp(inv, o[idx]), _xd(inv, d[idx])
            blocked[idx] |= self._any(self.meshes[key], oo, dd, max_distance[idx])
        return blocked

    # ---- textures (Texture.cpp:131-239; oracle.py:126-275) ----

    def _fetch(self, tid, x, y, level):
        w = torch.clamp_min(self.tex_width[tid] >> level, 1)
        h = torch.clamp_min(self.tex_height[tid] >> level, 1)
        row = self.tex_offsets[tid, level] + torch.remainder(x, w) + torch.remainder(y, h) * w
        return self.tex_data[row]

    def _bilinear(self, tid, u, v, level):
        lw = torch.clamp_min(self.tex_width[tid] >> level, 1).to(self.dtype)
        lh = torch.clamp_min(self.tex_height[tid] >> level, 1).to(self.dtype)
        ss = u * lw - 0.5
        tt = v * lh - 0.5
        fs = (ss - torch.floor(ss))[:, None]
        ft = (tt - torch.floor(tt))[:, None]
        w0 = (1 - fs) * (1 - ft)
        w1 = fs * (1 - ft)
        w2 = (1 - fs) * ft
        w3 = 1 - w0 - w1 - w2
        x0 = torch.floor(ss).long()
        y0 = torch.floor(tt).long()
        return (w0 * self._fetch(tid, x0, y0, level) + w1 * self._fetch(tid, x0 + 1, y0, level)
                + w2 * self._fetch(tid, x0, y0 + 1, level)
                + w3 * self._fetch(tid, x0 + 1, y0 + 1, level))

    def _albedo(self, rec):
        mid = rec["mid"]
        diffuse = self.mat_diffuse[mid]
        tid = self.mat_texture[mid]
        textured = tid > 0
        if not bool(textured.any()):
            return diffuse
        idx = torch.nonzero(textured)[:, 0]
        tid = tid[idx]
        u, v = rec["u"][idx], rec["v"][idx]
        ds_dx, ds_dy = rec["ds_dx"][idx], rec["ds_dy"][idx]
        dt_dx, dt_dy = rec["dt_dx"][idx], rec["dt_dy"][idx]
        levels = self.tex_levels[tid]
        zero = torch.zeros_like(tid)
        base = self._bilinear(tid, u, v, zero)
        # anisotropic (Texture.cpp:207-239): up to max_anisotropy probes along the
        # major axis at a sharper level
        p_x = torch.maximum(ds_dx.abs(), dt_dx.abs())
        p_y = torch.maximum(ds_dy.abs(), dt_dy.abs())
        p_min, p_max = torch.minimum(p_x, p_y), torch.maximum(p_x, p_y)
        n = torch.where(p_min > 0, torch.ceil(p_max / torch.where(p_min > 0, p_min, 1.0)),
                        float("inf"))
        n = torch.clamp(n, max=self.max_aniso)
        lam = levels.to(self.dtype) - 1.0 + torch.log2(p_max / n)
        level = torch.where(torch.isfinite(lam), torch.floor(lam + 0.5),
                            torch.full_like(lam, -1.0)).long()
        level_c = torch.clamp(level, min=0)
        level_c = torch.minimum(level_c, levels - 1)
        x_major = p_x > p_y
        step_s = torch.where(x_major, ds_dx, ds_dy)
        step_t = torch.where(x_major, dt_dx, dt_dy)
        inv_np1 = 1.0 / (n + 1.0)
        acc = torch.zeros_like(base)
        for i in range(1, int(self.max_aniso) + 1):
            use = (i <= n + 0.001)[:, None]
            tap = self._bilinear(tid, u + step_s * (i * inv_np1 - 0.5),
                                 v + step_t * (i * inv_np1 - 0.5), level_c)
            acc = acc + torch.where(use, tap, 0.0)
        mip = acc / n[:, None]
        top = self._fetch(tid, zero, zero, levels - 1)
        mip = torch.where((level < 0)[:, None], base, mip)
        mip = torch.where((level >= levels - 1)[:, None], top, mip)
        tex = torch.where((levels > 1)[:, None], mip, base)
        return diffuse.index_put((idx,), diffuse[idx] * tex)

    # ---- sky (Sky.cpp:28-67) ----

    def _sky(self, d):
        size = self.sky_size
        denom = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        r = 0.5 * ONE_OVER_PI * torch.arccos(torch.clamp(d[:, 2], -1.0 + 1e-6, 1.0 - 1e-6)) \
            / torch.clamp_min(denom, 1e-12)
        x = torch.floor((d[:, 0] * r + 0.5) * size + 0.5).long()
        y = torch.floor((d[:, 1] * r + 0.5) * size + 0.5).long()
        return ONE_OVER_PI * self.sky[torch.clamp(y * size + x, 0, size * size - 1)]

    # ---- the bounce (Raytracer.cpp:87-400; oracle.py:490-592) ----

    @staticmethod
    def _blinn_phong(normal, to_light, to_camera, colour):
        intensity = _dot(normal, to_light)
        half = _normalize(to_light + to_camera, 1e-20)
        intensity2 = intensity + _pow2_128(_dot(normal, half))
        return torch.where(intensity > 0.0, intensity2, 0.0)[:, None] * colour

    def _direct(self, rec, cam_pos):
        """Ambient plus every light that reaches the hit point unblocked."""
        point, normal = rec["point"], rec["normal"]
        n = point.shape[0]
        to_camera = _normalize(cam_pos[None] - point, 1e-20)
        acc = torch.full((n, 3), self.ambient, dtype=self.dtype, device=self.dev)
        terms = []
        for colour, position in self.point_lights:  # PointLight.h:9-11
            to_l = position[None] - point
            d2 = _dot(to_l, to_l)
            dist = torch.sqrt(d2)
            to_l = to_l / dist[:, None]
            terms.append((to_l, dist, self._blinn_phong(normal, to_l, to_camera, colour[None])
                          / d2[:, None]))
        for colour, position, neg_dir, inner, outer in self.spot_lights:  # SpotLight.h:17-33
            to_l = position[None] - point
            d2 = _dot(to_l, to_l)
            dist = torch.sqrt(d2)
            to_l = to_l / dist[:, None]
            dot = _dot(to_l, neg_dir[None])
            radial = torch.clamp_max((dot - outer) / (inner - outer), 1.0)
            radial = torch.where(dot > outer, radial, 0.0)
            terms.append((to_l, dist, radial[:, None] * self._blinn_phong(
                normal, to_l, to_camera, colour[None]) / d2[:, None]))
        for colour, neg_dir in self.directional_lights:  # DirectionalLight.h:9-11
            to_l = neg_dir.expand(n, 3)
            terms.append((to_l, torch.full((n,), float("inf"), dtype=self.dtype,
                                           device=self.dev),
                          self._blinn_phong(normal, to_l, to_camera, colour[None])))
        for to_l, dist, term in terms:
            lit = _dot(term, term) > 0.0  # a shadow ray only where the light adds
            idx = torch.nonzero(lit)[:, 0]
            if idx.numel():
                free = ~self._blocked(point[idx], to_l[idx], dist[idx])
                acc = acc.index_add(0, idx[free], term[idx[free]])
        return acc

    def _bounce(self, cam_pos, rays, depth):
        """(colour [N,3], distance [N]) of each ray, as Raytracer::bounce."""
        o, d, dO_dx, dO_dy, dD_dx, dD_dy = rays
        n = o.shape[0]
        rec = self._trace(rays)
        hit = rec["hit"]
        colour = torch.where(hit[:, None], 0.0, self._sky(d))
        distance = torch.where(hit, rec["t"], float("inf"))
        idx = torch.nonzero(hit)[:, 0]
        if not idx.numel():
            return colour, distance
        h = {k: v[idx] for k, v in rec.items()}
        ray = tuple(x[idx] for x in rays)
        result = torch.zeros((idx.numel(), 3), dtype=self.dtype, device=self.dev)
        albedo = self._albedo(h)
        lit = _dot(albedo, albedo) > 0.0
        li = torch.nonzero(lit)[:, 0]
        if li.numel():
            sub = {k: v[li] for k, v in h.items()}
            result = result.index_add(0, li, self._direct(sub, cam_pos) * albedo[li])

        if depth > 0:
            mid = h["mid"]
            refl_c = self.mat_reflection[mid]
            trans_c = self.mat_transmittance[mid]
            d_ = ray[1]
            nrm = h["normal"]
            dot_dn = _dot(d_, nrm)
            ddn_dx = _dot(ray[4], nrm) + _dot(d_, h["dN_dx"])
            ddn_dy = _dot(ray[5], nrm) + _dot(d_, h["dN_dy"])
            colour_reflection = torch.zeros_like(result)
            has_refl = _dot(refl_c, refl_c) > 0.0
            ri = torch.nonzero(has_refl)[:, 0]
            if ri.numel():  # Raytracer.cpp:204-262
                dn = dot_dn[ri, None]
                nr = nrm[ri]
                child_rays = (
                    h["point"][ri], d_[ri] - 2.0 * dn * nr, h["dO_dx"][ri], h["dO_dy"][ri],
                    ray[4][ri] - 2.0 * (dn * h["dN_dx"][ri] + ddn_dx[ri, None] * nr),
                    ray[5][ri] - 2.0 * (dn * h["dN_dy"][ri] + ddn_dy[ri, None] * nr))
                child, _ = self._bounce(cam_pos, child_rays, depth - 1)
                colour_reflection = colour_reflection.index_put((ri,), refl_c[ri] * child)
                result = result + colour_reflection
            has_refr = _dot(trans_c, trans_c) > 0.0
            if bool(has_refr.any()):  # Raytracer.cpp:264-396
                entering = dot_dn < 0.0
                ior = self.mat_ior[mid]
                n1 = torch.where(entering, AIR_IOR, ior)
                n2 = torch.where(entering, ior, AIR_IOR)
                cos_theta = torch.where(entering, -dot_dn, dot_dn)
                normal = torch.where(entering[:, None], nrm, -nrm)
                eta = n1 / n2
                k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
                tir = has_refr & (k < 0.0)
                result = result + torch.where(tir[:, None], colour_reflection, 0.0)
                go = has_refr & ~tir
                gi = torch.nonzero(go)[:, 0]
                if gi.numel():
                    sq = torch.sqrt(k[gi])
                    e, ct, nn = eta[gi], cos_theta[gi], normal[gi]
                    refr_dir = e[:, None] * d_[gi] + (e * ct - sq)[:, None] * nn
                    mu = -(e * ct - sq)
                    nr = nrm[gi]
                    child_rays = (
                        h["point"][gi], refr_dir, h["dO_dx"][gi], h["dO_dy"][gi],
                        e[:, None] * ray[4][gi] - ((mu * -ct)[:, None]
                                                   + _dot(h["dN_dx"][gi], nr)[:, None] * nr)
                        * ddn_dx[gi, None],
                        e[:, None] * ray[5][gi] - ((mu * -ct)[:, None]
                                                   + _dot(h["dN_dy"][gi], nr)[:, None] * nr)
                        * ddn_dy[gi, None])
                    child, refr_dist = self._bounce(cam_pos, child_rays, depth - 1)
                    beer = torch.exp((trans_c[gi] - 1.0)
                                     * torch.clamp_max(refr_dist, BEER_CLAMP)[:, None])
                    child = torch.where(entering[gi, None], child * beer, child)
                    r0 = (n1[gi] - n2[gi]) / (n1[gi] + n2[gi])
                    r0 = r0 * r0
                    cos_f = torch.where(n1[gi] > n2[gi], -_dot(refr_dir, nn), ct)
                    omc = 1.0 - cos_f
                    omc2 = omc * omc
                    f_r = r0 + ((1.0 - r0) * omc2) * (omc2 * omc)
                    result = result.index_add(0, gi, f_r[:, None] * colour_reflection[gi]
                                              + (1.0 - f_r)[:, None] * child)
        colour = colour.index_put((idx,), result)
        return colour, distance
