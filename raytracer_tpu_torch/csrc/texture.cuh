// Lane set-up shared by K3 (texture.cu, forward) and K4 (texture_bwd.cu, its
// gradient), for every mode of `sample`: the wrapped texel fetch, the bilinear
// tap position and weights, and each filter's footprint (NEAREST's texel,
// TRILINEAR's two levels and blend, ANISOTROPIC's level, tap count and step,
// EWA's ellipse and box) with the branch a lane takes.  Both kernels call the same
// helpers, so the backward takes the forward's level, tap and window decisions bit
// for bit instead of saving them.
//
// Every expression is JAX's (raytracer_tpu/ops/texture_sample.py:29-339) in its
// order, so that the float32 rounding matches the plain PyTorch version
// (raytracer_tpu_torch/ops/texture_sample.py) under --fmad=false.
#pragma once

#include "common.cuh"

namespace rt {

// The modes of `sample`, in the order of texture_sample.py's MODES.
enum Mode { kNearest = 0, kBilinearMode = 1, kTrilinear = 2, kAnisotropic = 3, kEwa = 4 };

struct Atlas {
  const float* data;     // [X,3]
  const float* data4;    // [X,12]; null under NEAREST
  const int* width;      // [K]
  const int* height;     // [K]
  const int* levels;     // [K]
  const int* offsets;    // [K,16]
};

// The per-lane inputs, each [N].
struct Lanes {
  const int* tex_id;
  const float* s;
  const float* t;
  const float* ds_dx;
  const float* ds_dy;
  const float* dt_dx;
  const float* dt_dy;
};

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ float dot(Rgb a, Rgb b) { return a.r * b.r + a.g * b.g + a.b * b.b; }

// vecmath.safe_sqrt: 0 for x <= 0 (and for NaN)
__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// _fetch_texel's wrap (texture_sample.py:29-41): the row of data holding texel
// (x, y) of `level`, x and y taken modulo the level's size.
__device__ __forceinline__ long long texel_row(const Atlas& a, int tid, int x, int y,
                                               int level) {
  int w = max(a.width[tid] >> level, 1);
  int h = max(a.height[tid] >> level, 1);
  return (long long)(a.offsets[tid * 16 + level] + floor_mod(x, w) + floor_mod(y, h) * w);
}

__device__ __forceinline__ Rgb texel(const Atlas& a, long long row) {
  const float* p = a.data + 3ll * row;
  return {p[0], p[1], p[2]};
}

// _sample_nearest (texture_sample.py:53-61): rintf rounds half to even, as
// jnp.round does.
__device__ __forceinline__ long long nearest_row(const Atlas& a, int tid, float s, float t) {
  int x = (int)rintf(s * (float)a.width[tid]);
  int y = (int)rintf(t * (float)a.height[tid]);
  return texel_row(a, tid, x, y, 0);
}

// One bilinear tap (_sample_bilinear with data4, texture_sample.py:64-105): the
// quad-atlas row it reads and its four weights.
struct Tap {
  long long row;  // row of data4
  float fs, ft;   // fractional position inside the 2x2 footprint
  float lw, lh;   // level size as float (d fs / d s = lw, d ft / d t = lh)
  float w0, w1, w2, w3;
};

__device__ __forceinline__ Tap bilinear_tap(const Atlas& a, int tid, float s, float t,
                                            int level) {
  Tap p;
  int lwi = max(a.width[tid] >> level, 1);
  int lhi = max(a.height[tid] >> level, 1);
  p.lw = (float)lwi;
  p.lh = (float)lhi;
  float ss = s * p.lw - 0.5f;
  float tt = t * p.lh - 0.5f;
  float fss = floorf(ss), ftt = floorf(tt);
  p.fs = ss - fss;
  p.ft = tt - ftt;
  p.w0 = (1.0f - p.fs) * (1.0f - p.ft);
  p.w1 = p.fs * (1.0f - p.ft);
  p.w2 = (1.0f - p.fs) * p.ft;
  p.w3 = 1.0f - p.w0 - p.w1 - p.w2;
  int x = floor_mod((int)fss, lwi);
  int y = floor_mod((int)ftt, lhi);
  p.row = (long long)(a.offsets[tid * 16 + level] + x + y * lwi);
  return p;
}

__device__ __forceinline__ Rgb tap_value(const Atlas& a, const Tap& p) {
  const float* q = a.data4 + 12ll * p.row;
  Rgb o;
  o.r = p.w0 * q[0] + p.w1 * q[3] + p.w2 * q[6] + p.w3 * q[9];
  o.g = p.w0 * q[1] + p.w1 * q[4] + p.w2 * q[7] + p.w3 * q[10];
  o.b = p.w0 * q[2] + p.w1 * q[5] + p.w2 * q[8] + p.w3 * q[11];
  return o;
}

// Row of data holding the 1x1 top mip of texture tid (_top_texel).
__device__ __forceinline__ long long top_row(const Atlas& a, int tid, int levels) {
  return (long long)a.offsets[tid * 16 + levels - 1];
}

// Which term of `sample` a MIPMAP lane returns: the level-0 bilinear tap, the top
// texel, or the filter's own result.
enum Branch { kBilinear = 0, kTop = 1, kFilter = 2 };

// The selects of `sample` and of the filters (level < 0 -> bilinear, then
// level >= levels - 1 -> top), in JAX's order; levels == 1 -> bilinear.
__device__ __forceinline__ Branch mip_branch(int levels, bool use_bil, bool use_top) {
  if (levels <= 1) return kBilinear;
  if (use_top) return kTop;
  return use_bil ? kBilinear : kFilter;
}

// _sample_trilinear's levels and blend (texture_sample.py:123-134).
struct Trilinear {
  float width;  // 2 max(|ds_dx|, |ds_dy|, |dt_dx|, |dt_dy|)
  float f;      // lam - floor(lam): the weight of level hi
  int lo, hi;
  Branch branch;
};

__device__ __forceinline__ Trilinear trilinear_setup(int levels, float ds_dx, float ds_dy,
                                                     float dt_dx, float dt_dy) {
  Trilinear f;
  float lf = (float)levels;
  f.width = 2.0f * nan_max(nan_max(fabsf(ds_dx), fabsf(ds_dy)),
                           nan_max(fabsf(dt_dx), fabsf(dt_dy)));
  float lam = lf - 1.0f + log2f(nan_max(f.width, 1e-8f));
  float fl = floorf(lam);
  int level = (int)fl;
  f.lo = min(max(level, 0), levels - 1);
  f.hi = min(max(level + 1, 0), levels - 1);
  f.f = lam - fl;
  f.branch = mip_branch(levels, level < 0, level >= levels - 1);
  return f;
}

// _sample_anisotropic's footprint (texture_sample.py:154-169).
struct Aniso {
  int level, level_c;
  float nt;       // tap count n (float, as in JAX)
  bool x_major;
  float step_s, step_t;
  float inv_np1;
  Branch branch;
};

__device__ __forceinline__ Aniso aniso_setup(int levels, float ds_dx, float ds_dy,
                                             float dt_dx, float dt_dy,
                                             float max_anisotropy) {
  Aniso f;
  float lf = (float)levels;
  float p_x = nan_max(fabsf(ds_dx), fabsf(dt_dx));
  float p_y = nan_max(fabsf(ds_dy), fabsf(dt_dy));
  float p_min = nan_min(p_x, p_y);
  float p_max = nan_max(p_x, p_y);
  float nt = nan_min(ceilf(p_max / nan_max(p_min, 1e-20f)), max_anisotropy);
  f.nt = nan_max(nt, 1.0f);
  float lam = lf - 1.0f + log2f(nan_max(p_max / f.nt, 1e-20f));
  f.level = (int)rintf(lam);  // jnp.round: half to even
  f.level_c = min(max(f.level, 0), levels - 1);
  f.x_major = p_x > p_y;
  f.step_s = f.x_major ? ds_dx : ds_dy;
  f.step_t = f.x_major ? dt_dx : dt_dy;
  f.inv_np1 = 1.0f / (f.nt + 1.0f);
  f.branch = mip_branch(levels, f.level < 0, f.level >= levels - 1);
  return f;
}

// Tap k (1-based) counts when k <= n + 0.001; it sits at s + step * c, t + step * c.
__device__ __forceinline__ bool tap_used(int k, const Aniso& f) {
  return (float)k <= f.nt + 0.001f;
}

__device__ __forceinline__ float tap_coeff(int k, const Aniso& f) {
  return (float)k * f.inv_np1 - 0.5f;
}

// _sample_ewa's ellipse (texture_sample.py:205-260) at level_c: the quadratic
// form (a, b, c) about the texel-space centre (ss, tt), and the texels scanned,
// the box [s0, s1] x [t0, t1] cut to the span x span window.  Set only for the
// lanes whose branch is kFilter: on the others the ellipse may overflow (inf or
// NaN), and they read no window.
struct Ewa {
  int level_c;
  float ss, tt, a, b, c;
  int s0, t0;  // the box's first texel
  int ns, nt;  // texels scanned along s and t, each in [0, span]
  Branch branch;
};

// A box edge as an int32: NaN -> 0, clamped to +-2^30 so that s0 + di cannot
// overflow (edges that far out occur only on lanes with an overflowed ellipse).
__device__ __forceinline__ int box_edge(float x) {
  return isnan(x) ? 0 : (int)fminf(fmaxf(x, -1073741824.0f), 1073741824.0f);
}

__device__ __forceinline__ int window_count(int lo, int hi, int span) {
  long long n = (long long)hi - (long long)lo + 1;
  return n <= 0 ? 0 : (n >= span ? span : (int)n);
}

__device__ __forceinline__ Ewa ewa_setup(const Atlas& at, int tid, int levels, float s,
                                         float t, float ds_dx, float ds_dy, float dt_dx,
                                         float dt_dy, float max_anisotropy, int span) {
  Ewa e;
  float lf = (float)levels;
  float wf = (float)at.width[tid];
  float maj_x = ds_dx, maj_y = dt_dx, min_x = ds_dy, min_y = dt_dy;
  float maj_len = safe_sqrt(maj_x * maj_x + maj_y * maj_y);
  float min_len = safe_sqrt(min_x * min_x + min_y * min_y);
  if (min_len > maj_len) {
    float x = maj_x, y = maj_y, l = maj_len;
    maj_x = min_x, maj_y = min_y, maj_len = min_len;
    min_x = x, min_y = y, min_len = l;
  }
  bool degenerate = min_len < 1e-5f;
  bool too_big = maj_len > wf;
  // eccentricity clamp (Texture.cpp:262-268)
  float scale = maj_len / nan_max(min_len * max_anisotropy, 1e-20f);
  if (min_len * max_anisotropy < maj_len) {
    min_x = min_x * scale;
    min_y = min_y * scale;
    min_len = min_len * scale;
  }
  float lam = nan_max(0.0f, lf - 1.0f + log2f(nan_max(min_len, 1e-20f)));
  int level = (int)rintf(lam);  // jnp.round: half to even
  e.level_c = min(max(level, 0), levels - 1);
  e.branch = mip_branch(levels, degenerate, too_big || level >= levels - 1);
  e.ns = e.nt = 0;
  if (e.branch != kFilter) return e;

  float lw = (float)max(at.width[tid] >> e.level_c, 1);
  float lh = (float)max(at.height[tid] >> e.level_c, 1);
  e.ss = s * lw - 0.5f;
  e.tt = t * lh - 0.5f;
  float majx = maj_x * lw, majy = maj_y * lh;
  float minx = min_x * lw, miny = min_y * lh;
  float a = 1.0f + (majy * majy + miny * miny);
  float b = -2.0f * (majx * majy + minx * miny);
  float c = 1.0f + (majx * majx + minx * minx);
  float inv_f = 1.0f / (a * c - b * b * 0.25f);
  e.a = a * inv_f;
  e.b = b * inv_f;
  e.c = c * inv_f;
  float det = -e.b * e.b + 4.0f * e.a * e.c;
  float sqrt_u = safe_sqrt(det * e.c);
  float sqrt_v = safe_sqrt(det * e.a);
  float two_inv_det = 2.0f / det;
  e.s0 = box_edge(floorf(e.ss - two_inv_det * sqrt_u + 1.0f));
  int s1 = box_edge(floorf(e.ss + two_inv_det * sqrt_u));
  e.t0 = box_edge(floorf(e.tt - two_inv_det * sqrt_v + 1.0f));
  int t1 = box_edge(floorf(e.tt + two_inv_det * sqrt_v));
  e.ns = window_count(e.s0, s1, span);
  e.nt = window_count(e.t0, t1, span);
  return e;
}

// r2 of texel (si, tj) under the ellipse's form, in JAX's order.
__device__ __forceinline__ float ewa_r2(const Ewa& e, int si, int tj) {
  float uu = (float)si - e.ss;
  float vv = (float)tj - e.tt;
  return e.a * uu * uu + e.b * uu * vv + e.c * vv * vv;
}

// _ewa_weight (texture_sample.py:191-197): the reference's 128-entry gaussian
// table, exp(-2 r2q) - exp(-2) at r2q = round(r2 * 128) / 127 (index capped at
// 127).  The constant is exp(-2) rounded to float32, as the plain version's
// Python float is.
__device__ __forceinline__ float ewa_weight(float r2) {
  float idx = nan_min(floorf(r2 * 128.0f + 0.5f), 127.0f);
  float r2q = idx / 127.0f;
  return expf(-2.0f * r2q) - 0.1353352832366127f;
}

}  // namespace rt
