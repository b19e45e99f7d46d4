// Lane set-up shared by K3 (texture.cu, forward) and K4 (texture_bwd.cu, its
// gradient): the bilinear tap position and weights, the anisotropic footprint
// (level, tap count, major axis, step) and the branch a lane takes.  Both kernels
// call the same helpers, so the backward takes the forward's level and tap
// decisions bit for bit instead of saving them.
//
// Every expression is JAX's (raytracer_tpu/ops/texture_sample.py:64-188) in its
// order, so that the float32 rounding matches the plain PyTorch version
// (raytracer_tpu_torch/ops/texture_sample.py) under --fmad=false.
#pragma once

#include "common.cuh"

namespace rt {

struct Atlas {
  const float* data;     // [X,3]
  const float* data4;    // [X,12]
  const int* width;      // [K]
  const int* height;     // [K]
  const int* levels;     // [K]
  const int* offsets;    // [K,16]
};

struct Rgb {
  float r, g, b;
};

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

// Which term of `sample` a lane returns: the level-0 bilinear (levels == 1, or
// level < 0), the top texel (level >= levels - 1) or the anisotropic average.
enum Branch { kBilinear = 0, kTop = 1, kAniso = 2 };

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
  // the selects of sample and _sample_anisotropic, in JAX's order
  Branch b = kBilinear;
  if (levels > 1) {
    b = f.level < 0 ? kBilinear : kAniso;
    if (f.level >= levels - 1) b = kTop;
  }
  f.branch = b;
  return f;
}

// Tap k (1-based) counts when k <= n + 0.001; it sits at s + step * c, t + step * c.
__device__ __forceinline__ bool tap_used(int k, const Aniso& f) {
  return (float)k <= f.nt + 0.001f;
}

__device__ __forceinline__ float tap_coeff(int k, const Aniso& f) {
  return (float)k * f.inv_np1 - 0.5f;
}

}  // namespace rt
