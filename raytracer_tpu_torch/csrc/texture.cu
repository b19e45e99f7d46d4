// K3: filtered albedo, MIPMAP + ANISOTROPIC texture filtering (forward; its
// gradient is K4 in texture_bwd.cu, with the lane set-up shared in texture.cuh).
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
// in at pack time).  Only the branch a lane returns is evaluated: the selects
// pick one term, so the others cannot change the result.
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
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::Rgb;

__device__ __forceinline__ Rgb bilinear(const Atlas& a, int tid, float s, float t, int level) {
  return rt::tap_value(a, rt::bilinear_tap(a, tid, s, t, level));
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
  const int levels = a.levels[tid];
  const rt::Aniso f = rt::aniso_setup(levels, ds_dx_in[i], ds_dy_in[i], dt_dx_in[i],
                                      dt_dy_in[i], max_anisotropy);
  Rgb res;
  if (f.branch == rt::kTop) {
    // _top_texel: texel (0, 0) of the last level
    const float* tp = a.data + 3ll * rt::top_row(a, tid, levels);
    res = {tp[0], tp[1], tp[2]};
  } else if (f.branch == rt::kBilinear) {
    res = bilinear(a, tid, s, t, 0);
  } else {
    // _sample_anisotropic (texture_sample.py:147-188)
    Rgb acc = {0.0f, 0.0f, 0.0f};
    const int max_taps = (int)max_anisotropy;
    for (int k = 1; k <= max_taps; ++k) {
      if (!rt::tap_used(k, f)) continue;
      const float c = rt::tap_coeff(k, f);
      Rgb tap = bilinear(a, tid, s + f.step_s * c, t + f.step_t * c, f.level_c);
      acc.r = acc.r + tap.r;
      acc.g = acc.g + tap.g;
      acc.b = acc.b + tap.b;
    }
    res = {acc.r / f.nt, acc.g / f.nt, acc.b / f.nt};
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
