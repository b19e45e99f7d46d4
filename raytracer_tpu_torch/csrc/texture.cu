// K3: filtered albedo, MIPMAP + ANISOTROPIC texture filtering (forward only).
//
// Replaces raytracer_tpu/ops/texture_sample.py:sample in its MIPMAP/ANISOTROPIC
// form (_sample_bilinear, _top_texel, _sample_anisotropic and the levels > 1
// select, :64-188 and :311-339) (JAX); its plain PyTorch version is
// raytracer_tpu_torch/ops/texture_sample.py:sample_plain.
//
// Per lane: the level-0 bilinear tap (`bil`), the 1x1 top mip (`top`), and up to
// max_anisotropy bilinear taps along the footprint's major axis at level_c; then
// the level < 0, level >= levels-1 and levels > 1 selects.  A bilinear tap reads
// ONE 48-byte row of the quad atlas data4 [X,12] (the 2x2 footprint, wrap baked
// in at pack time).
//
// Bound on the H100: bytes.  Up to 10 gathered 48-byte rows and 7 floats in,
// 12 bytes out per lane, against ~200 float operations; the atlases (~13 MB)
// stay in L2.  The gathers are scattered, so the real limit is L2 sector
// traffic, not DRAM.
//
// This first version is one thread per lane, right and simple: taps are
// unrolled scalar code and each row is read with 32-bit loads.  16-byte vector
// loads of the quad rows and a fused material/texture/shading pass are for
// later PRs.
#include "common.cuh"

namespace {

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

// _sample_bilinear with data4 (texture_sample.py:64-105)
__device__ __forceinline__ Rgb bilinear(const Atlas& a, int tid, float s, float t, int level) {
  int lwi = max(a.width[tid] >> level, 1);
  int lhi = max(a.height[tid] >> level, 1);
  float lw = (float)lwi, lh = (float)lhi;
  float ss = s * lw - 0.5f;
  float tt = t * lh - 0.5f;
  float fss = floorf(ss), ftt = floorf(tt);
  float fs = ss - fss;
  float ft = tt - ftt;
  float w0 = (1.0f - fs) * (1.0f - ft);
  float w1 = fs * (1.0f - ft);
  float w2 = (1.0f - fs) * ft;
  float w3 = 1.0f - w0 - w1 - w2;
  int x = rt::floor_mod((int)fss, lwi);
  int y = rt::floor_mod((int)ftt, lhi);
  const float* q = a.data4 + 12ll * (a.offsets[tid * 16 + level] + x + y * lwi);
  Rgb o;
  o.r = w0 * q[0] + w1 * q[3] + w2 * q[6] + w3 * q[9];
  o.g = w0 * q[1] + w1 * q[4] + w2 * q[7] + w3 * q[10];
  o.b = w0 * q[2] + w1 * q[5] + w2 * q[8] + w3 * q[11];
  return o;
}

__global__ void texture_kernel(Atlas a, const int* __restrict__ tex_id,
                               const float* __restrict__ s_in, const float* __restrict__ t_in,
                               const float* __restrict__ ds_dx_in,
                               const float* __restrict__ ds_dy_in,
                               const float* __restrict__ dt_dx_in,
                               const float* __restrict__ dt_dy_in, int n,
                               float max_anisotropy, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = tex_id[i];
  const float s = s_in[i], t = t_in[i];
  const float ds_dx = ds_dx_in[i], ds_dy = ds_dy_in[i];
  const float dt_dx = dt_dx_in[i], dt_dy = dt_dy_in[i];
  const int levels = a.levels[tid];

  Rgb bil = bilinear(a, tid, s, t, 0);
  Rgb res = bil;
  if (levels > 1) {
    // _top_texel: texel (0, 0) of the last level
    const float* tp = a.data + 3ll * a.offsets[tid * 16 + levels - 1];
    Rgb top = {tp[0], tp[1], tp[2]};

    // _sample_anisotropic (texture_sample.py:147-188)
    float lf = (float)levels;
    float p_x = rt::nan_max(fabsf(ds_dx), fabsf(dt_dx));
    float p_y = rt::nan_max(fabsf(ds_dy), fabsf(dt_dy));
    float p_min = rt::nan_min(p_x, p_y);
    float p_max = rt::nan_max(p_x, p_y);
    float nt = rt::nan_min(ceilf(p_max / rt::nan_max(p_min, 1e-20f)), max_anisotropy);
    nt = rt::nan_max(nt, 1.0f);
    float lam = lf - 1.0f + log2f(rt::nan_max(p_max / nt, 1e-20f));
    int level = (int)rintf(lam);  // jnp.round: half to even
    int level_c = min(max(level, 0), levels - 1);
    bool x_major = p_x > p_y;
    float step_s = x_major ? ds_dx : ds_dy;
    float step_t = x_major ? dt_dx : dt_dy;
    float inv_np1 = 1.0f / (nt + 1.0f);
    Rgb acc = {0.0f, 0.0f, 0.0f};
    const int max_taps = (int)max_anisotropy;
    for (int k = 1; k <= max_taps; ++k) {
      float fi = (float)k;
      if (!(fi <= nt + 0.001f)) continue;
      float x = s + step_s * (fi * inv_np1 - 0.5f);
      float y = t + step_t * (fi * inv_np1 - 0.5f);
      Rgb tap = bilinear(a, tid, x, y, level_c);
      acc.r = acc.r + tap.r;
      acc.g = acc.g + tap.g;
      acc.b = acc.b + tap.b;
    }
    Rgb aniso = {acc.r / nt, acc.g / nt, acc.b / nt};
    res = level < 0 ? bil : aniso;
    if (level >= levels - 1) res = top;
  }
  out[3 * i + 0] = res.r;
  out[3 * i + 1] = res.g;
  out[3 * i + 2] = res.b;
}

}  // namespace

extern "C" int rt_texture_aniso(const void* data, const void* data4, const void* width,
                                const void* height, const void* levels,
                                const void* offsets, const void* tex_id, const void* s,
                                const void* t, const void* ds_dx, const void* ds_dy,
                                const void* dt_dx, const void* dt_dy, int n,
                                float max_anisotropy, void* out, void* stream) {
  constexpr int kBlock = 256;
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  texture_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      a, (const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
      (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy, n, max_anisotropy,
      (float*)out);
  return (int)cudaGetLastError();
}
