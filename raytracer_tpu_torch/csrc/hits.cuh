// K7 per lane: hit reconstruction (forward) and its chain rule (backward).
//
// The forward is raytracer_tpu_torch/ops/hits.py:mesh_hits_plain for one lane,
// the same float32 operations in the same order (each dot and cross an
// explicit component sum, left to right; each multiply and add rounded on its
// own under --fmad=false), so the merged record equals the plain version's.
// The backward is autograd of that forward written out by hand: every
// intermediate is recomputed from the lane's inputs, then the cotangents run
// back through the uv / ds / dt interpolation, dN (with its rsqrt(n.n) / n.n
// term), dP, the RTG ch.20 differentials, the normal's normalisation and
// rotation, the point and Moller-Trumbore.  A denominator clamped by
// _nonzero passes no gradient, as torch.where gives none to the branch it
// does not take.
#pragma once

#include <math.h>

#define RT_HD __device__ __forceinline__

namespace k7 {

struct V3 {
  float x, y, z;
};

RT_HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
RT_HD V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
RT_HD V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
RT_HD V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
RT_HD V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
RT_HD V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
RT_HD void operator+=(V3& a, V3 b) { a = a + b; }
RT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RT_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// rows of a 3x4 matrix applied to a direction / a point (ops/hits.py _xd / _xp)
RT_HD V3 xd(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z, m[4] * p.x + m[5] * p.y + m[6] * p.z,
            m[8] * p.x + m[9] * p.y + m[10] * p.z);
}
RT_HD V3 xp(const float* m, V3 p) {
  return v3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
}
// backward of xd: the input's cotangent M^T g; g p^T added into the matrix's
// (columns 0-2; xp's translation column gets g itself)
RT_HD V3 xd_t(const float* m, V3 g) {
  return v3(m[0] * g.x + m[4] * g.y + m[8] * g.z, m[1] * g.x + m[5] * g.y + m[9] * g.z,
            m[2] * g.x + m[6] * g.y + m[10] * g.z);
}
RT_HD void outer_add(float* gm, V3 g, V3 p) {
  const float gr[3] = {g.x, g.y, g.z};
  for (int r = 0; r < 3; ++r) {
    gm[4 * r + 0] += gr[r] * p.x;
    gm[4 * r + 1] += gr[r] * p.y;
    gm[4 * r + 2] += gr[r] * p.z;
  }
}

constexpr float kTiny = 1e-20f;  // intersect._nonzero, and normalize's eps

// intersect._nonzero: push |x| < 1e-20 away from 0 keeping its sign (+ for 0)
RT_HD float nonzero(float x) { return fabsf(x) < kTiny ? (x < 0.0f ? -kTiny : kTiny) : x; }

struct Rays {
  V3 o, d, ox, oy, dx, dy;  // origin, direction, dO_dx, dO_dy, dD_dx, dD_dy
};

struct Geom {
  V3 p0, e1, e2, n0, ne1, ne2;
  float t0[2], te1[2], te2[2];
};

// the differentiable fields of the reconstructed record
struct Out {
  float t;
  V3 point, normal;
  float u, v, ds_dx, ds_dy, dt_dx, dt_dy;
  V3 dP_dx, dP_dy, dN_dx, dN_dy;
};

// every intermediate the backward needs
struct Fwd {
  V3 dd, hmt, s, q;
  float f, su, sv, st, u, v, t;
  bool a_clamped, k_clamped;
  V3 nr, nl;
  float nn, r, nd;
  V3 oxo, oyo, dxo, dyo, c12, qx, qy, cu, cv;
  float ook, aux, auy, avx, avy, dux, duy, dvx, dvy;
  V3 px, py, dnx, dny, wx, wy, nxo, nyo;
  float dxn, dyn;
};

// mesh_hits_plain for one valid lane: inv / world are the instance's 3x4 rows
RT_HD void forward(const float* inv, const float* world, const Rays& R, const Geom& G,
                   bool object_space, Fwd& F, Out& out) {
  const V3 oo = xp(inv, R.o);
  F.dd = xd(inv, R.d);
  F.hmt = cross(F.dd, G.e2);
  const float a = dot(G.e1, F.hmt);
  F.a_clamped = fabsf(a) < kTiny;
  F.f = 1.0f / nonzero(a);
  F.s = oo - G.p0;
  F.su = dot(F.s, F.hmt);
  F.u = F.f * F.su;
  F.q = cross(F.s, G.e1);
  F.sv = dot(F.dd, F.q);
  F.v = F.f * F.sv;
  F.st = dot(G.e2, F.q);
  F.t = F.f * F.st;
  out.t = F.t;
  out.point = R.o + F.t * R.d;

  F.nr = G.n0 + F.u * G.ne1 + F.v * G.ne2;
  F.nn = dot(F.nr, F.nr) + kTiny;
  F.r = rsqrtf(F.nn);  // torch's CUDA rsqrt for float32
  F.nl = F.nr * F.r;
  out.normal = xd(world, F.nl);

  out.u = G.t0[0] + F.u * G.te1[0] + F.v * G.te2[0];
  out.v = G.t0[1] + F.u * G.te1[1] + F.v * G.te2[1];

  F.oxo = xd(inv, R.ox);
  F.oyo = xd(inv, R.oy);
  F.dxo = xd(inv, R.dx);
  F.dyo = xd(inv, R.dy);
  F.c12 = cross(G.e1, G.e2);
  const float k = dot(F.c12, F.dd);
  F.k_clamped = fabsf(k) < kTiny;
  F.ook = 1.0f / nonzero(k);
  F.qx = F.oxo + F.t * F.dxo;
  F.qy = F.oyo + F.t * F.dyo;
  F.cu = cross(G.e2, F.dd);
  F.cv = cross(F.dd, G.e1);
  F.aux = dot(F.cu, F.qx);
  F.auy = dot(F.cu, F.qy);
  F.avx = dot(F.cv, F.qx);
  F.avy = dot(F.cv, F.qy);
  F.dux = F.ook * F.aux;
  F.duy = F.ook * F.auy;
  F.dvx = F.ook * F.avx;
  F.dvy = F.ook * F.avy;

  F.px = F.dux * G.e1 + F.dvx * G.e2;
  F.py = F.duy * G.e1 + F.dvy * G.e2;
  out.dP_dx = object_space ? F.px : xd(world, F.px);
  out.dP_dy = object_space ? F.py : xd(world, F.py);

  F.dnx = F.dux * G.ne1 + F.dvx * G.ne2;
  F.dny = F.duy * G.ne1 + F.dvy * G.ne2;
  F.nd = F.r / F.nn;  // rsqrt(n_dot_n) / n_dot_n
  F.dxn = dot(F.nr, F.dnx);
  F.dyn = dot(F.nr, F.dny);
  F.wx = F.nn * F.dnx - F.dxn * F.nr;
  F.wy = F.nn * F.dny - F.dyn * F.nr;
  F.nxo = F.wx * F.nd;
  F.nyo = F.wy * F.nd;
  out.dN_dx = object_space ? F.nxo : xd(world, F.nxo);
  out.dN_dy = object_space ? F.nyo : xd(world, F.nyo);

  out.ds_dx = F.dux * G.te1[0] + F.dvx * G.te2[0];
  out.ds_dy = F.duy * G.te1[0] + F.dvy * G.te2[0];
  out.dt_dx = F.dux * G.te1[1] + F.dvx * G.te2[1];
  out.dt_dy = F.duy * G.te1[1] + F.dvy * G.te2[1];
}

// cotangents of the lane's inputs; the caller zeroes them
struct Grads {
  Rays rays;
  Geom geom;
  float inv[12], world[12];
};

// The backward of forward() for one valid lane, given the cotangent `g` of its
// outputs.  Adds into `out` (zeroed by the caller).
RT_HD void backward(const float* inv, const float* world, const Rays& R, const Geom& G,
                    bool object_space, const Out& g, Grads& out) {
  Fwd F;
  Out fwd_out;
  forward(inv, world, R, G, object_space, F, fwd_out);

  // point = o + t d; the output t
  out.rays.o += g.point;
  float g_t = g.t + dot(g.point, R.d);
  out.rays.d += F.t * g.point;

  // uv, ds, dt: interpolations by (u, v) and by the four differentials
  out.geom.t0[0] += g.u;
  out.geom.t0[1] += g.v;
  float g_u = g.u * G.te1[0] + g.v * G.te1[1];
  float g_v = g.u * G.te2[0] + g.v * G.te2[1];
  out.geom.te1[0] += F.u * g.u + F.dux * g.ds_dx + F.duy * g.ds_dy;
  out.geom.te1[1] += F.u * g.v + F.dux * g.dt_dx + F.duy * g.dt_dy;
  out.geom.te2[0] += F.v * g.u + F.dvx * g.ds_dx + F.dvy * g.ds_dy;
  out.geom.te2[1] += F.v * g.v + F.dvx * g.dt_dx + F.dvy * g.dt_dy;
  float g_dux = g.ds_dx * G.te1[0] + g.dt_dx * G.te1[1];
  float g_dvx = g.ds_dx * G.te2[0] + g.dt_dx * G.te2[1];
  float g_duy = g.ds_dy * G.te1[0] + g.dt_dy * G.te1[1];
  float g_dvy = g.ds_dy * G.te2[0] + g.dt_dy * G.te2[1];

  // normal = world . (nr * r)
  const V3 g_nl = xd_t(world, g.normal);
  outer_add(out.world, g.normal, F.nl);
  V3 g_nr = F.r * g_nl;
  float g_r = dot(g_nl, F.nr);

  // dN = rot(world, (nn dn - (nr . dn) nr) * nd)
  V3 g_nxo = g.dN_dx, g_nyo = g.dN_dy;
  if (!object_space) {
    g_nxo = xd_t(world, g.dN_dx);
    g_nyo = xd_t(world, g.dN_dy);
    outer_add(out.world, g.dN_dx, F.nxo);
    outer_add(out.world, g.dN_dy, F.nyo);
  }
  const V3 g_wx = F.nd * g_nxo, g_wy = F.nd * g_nyo;
  const float g_nd = dot(g_nxo, F.wx) + dot(g_nyo, F.wy);
  float g_nn = dot(g_wx, F.dnx) + dot(g_wy, F.dny);
  V3 g_dnx = F.nn * g_wx, g_dny = F.nn * g_wy;
  const float g_dxn = -dot(g_wx, F.nr), g_dyn = -dot(g_wy, F.nr);
  g_nr += -F.dxn * g_wx;
  g_nr += -F.dyn * g_wy;
  g_nr += g_dxn * F.dnx + g_dyn * F.dny;
  g_dnx += g_dxn * F.nr;
  g_dny += g_dyn * F.nr;
  // nd = r / nn, r = rsqrt(nn), nn = nr . nr + eps
  g_r += g_nd / F.nn;
  g_nn += -g_nd * F.r / (F.nn * F.nn);
  g_nn += -0.5f * g_r * (F.r * F.r * F.r);
  g_nr += (2.0f * g_nn) * F.nr;
  // dn = du ne1 + dv ne2
  g_dux += dot(g_dnx, G.ne1);
  g_dvx += dot(g_dnx, G.ne2);
  g_duy += dot(g_dny, G.ne1);
  g_dvy += dot(g_dny, G.ne2);
  out.geom.ne1 += F.dux * g_dnx + F.duy * g_dny;
  out.geom.ne2 += F.dvx * g_dnx + F.dvy * g_dny;

  // dP = rot(world, du e1 + dv e2)
  V3 g_px = g.dP_dx, g_py = g.dP_dy;
  if (!object_space) {
    g_px = xd_t(world, g.dP_dx);
    g_py = xd_t(world, g.dP_dy);
    outer_add(out.world, g.dP_dx, F.px);
    outer_add(out.world, g.dP_dy, F.py);
  }
  g_dux += dot(g_px, G.e1);
  g_dvx += dot(g_px, G.e2);
  g_duy += dot(g_py, G.e1);
  g_dvy += dot(g_py, G.e2);
  V3 g_e1 = F.dux * g_px + F.duy * g_py;
  V3 g_e2 = F.dvx * g_px + F.dvy * g_py;

  // du_dx = ook (cu . qx), and the three others
  const float g_ook = g_dux * F.aux + g_duy * F.auy + g_dvx * F.avx + g_dvy * F.avy;
  const V3 g_cu = F.ook * (g_dux * F.qx + g_duy * F.qy);
  const V3 g_cv = F.ook * (g_dvx * F.qx + g_dvy * F.qy);
  const V3 g_qx = F.ook * (g_dux * F.cu + g_dvx * F.cv);
  const V3 g_qy = F.ook * (g_duy * F.cu + g_dvy * F.cv);
  // cu = e2 x dd, cv = dd x e1
  V3 g_dd = cross(g_cu, G.e2) + cross(G.e1, g_cv);
  g_e2 += cross(F.dd, g_cu);
  g_e1 += cross(g_cv, F.dd);
  // qx = oxo + t dxo, qy = oyo + t dyo
  g_t += dot(g_qx, F.dxo) + dot(g_qy, F.dyo);
  const V3 g_dxo = F.t * g_qx, g_dyo = F.t * g_qy;
  // ook = 1 / nonzero(c12 . dd), c12 = e1 x e2
  const float g_k = F.k_clamped ? 0.0f : -g_ook * (F.ook * F.ook);
  const V3 g_c12 = g_k * F.dd;
  g_dd += g_k * F.c12;
  g_e1 += cross(G.e2, g_c12);
  g_e2 += cross(g_c12, G.e1);
  // the ray differentials in object space
  out.rays.ox += xd_t(inv, g_qx);
  out.rays.oy += xd_t(inv, g_qy);
  out.rays.dx += xd_t(inv, g_dxo);
  out.rays.dy += xd_t(inv, g_dyo);
  outer_add(out.inv, g_qx, R.ox);
  outer_add(out.inv, g_qy, R.oy);
  outer_add(out.inv, g_dxo, R.dx);
  outer_add(out.inv, g_dyo, R.dy);

  // nr = n0 + u ne1 + v ne2
  out.geom.n0 += g_nr;
  g_u += dot(g_nr, G.ne1);
  g_v += dot(g_nr, G.ne2);
  out.geom.ne1 += F.u * g_nr;
  out.geom.ne2 += F.v * g_nr;

  // Moller-Trumbore: u = f su, v = f sv, t = f st
  const float g_f = g_u * F.su + g_v * F.sv + g_t * F.st;
  const float g_su = F.f * g_u, g_sv = F.f * g_v, g_st = F.f * g_t;
  V3 g_s = g_su * F.hmt;
  V3 g_hmt = g_su * F.s;
  g_dd += g_sv * F.q;
  V3 g_q = g_sv * F.dd;
  g_e2 += g_st * F.q;
  g_q += g_st * G.e2;
  // q = s x e1
  g_s += cross(G.e1, g_q);
  g_e1 += cross(g_q, F.s);
  // f = 1 / nonzero(e1 . hmt)
  const float g_a = F.a_clamped ? 0.0f : -g_f * (F.f * F.f);
  g_e1 += g_a * F.hmt;
  g_hmt += g_a * G.e1;
  // hmt = dd x e2
  g_dd += cross(G.e2, g_hmt);
  g_e2 += cross(g_hmt, F.dd);
  // s = inv . o - p0 (a point), dd = inv . d
  out.geom.p0 += -g_s;
  out.rays.o += xd_t(inv, g_s);
  outer_add(out.inv, g_s, R.o);
  out.inv[3] += g_s.x;
  out.inv[7] += g_s.y;
  out.inv[11] += g_s.z;
  out.rays.d += xd_t(inv, g_dd);
  outer_add(out.inv, g_dd, R.d);
  out.geom.e1 += g_e1;
  out.geom.e2 += g_e2;
}

}  // namespace k7
