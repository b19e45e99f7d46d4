// K3: filtered albedo, every texture sampling mode (forward; its gradient is K4
// in texture_bwd.cu, with the lane set-up shared in texture.cuh).
//
// Replaces raytracer_tpu/ops/texture_sample.py:sample (JAX) in each of its modes,
// one instance of texture_kernel<Mode> each:
//   NEAREST      _sample_nearest (:53): one wrapped texel of data at level 0;
//   BILINEAR     _sample_bilinear at level 0 (:316-317, :64-105);
//   TRILINEAR    _sample_trilinear (:115-144): bilinear taps at floor(lam) and
//                floor(lam) + 1, blended by frac(lam);
//   ANISOTROPIC  _sample_anisotropic (:147-188): up to max_anisotropy bilinear
//                taps along the footprint's major axis;
//   EWA          _ewa_weight and _sample_ewa (:191-287): the gaussian-weighted
//                texels of data inside the ellipse, within the ewa_max_span^2
//                window;
// for the MIPMAP filters with the level-0 bilinear and top-texel fallbacks and the
// levels > 1 select (:319-339).  Its plain PyTorch version is
// raytracer_tpu_torch/ops/texture_sample.py:sample_plain.
//
// A bilinear tap reads ONE 48-byte row of the quad atlas data4 [X,12] (the 2x2
// footprint, wrap baked in at pack time); NEAREST and EWA read 12-byte texels of
// data [X,3].  Only the branch a lane returns is evaluated: the selects pick one
// term, so the others cannot change the result.  EWA loops only over the texels
// of the ellipse's box inside the window, in JAX's dj-major order: the taps JAX
// adds with weight 0 change no sum (x + 0 == x).
//
// Bound on the H100: bytes for the bilinear modes (up to 10 gathered 48-byte rows
// and 7 floats in, 12 bytes out per lane, against ~30 float operations a tap);
// EWA does ~20 operations and an expf for each texel of its window, up to 256 a
// lane.  The atlases (~13 MB on config3) stay in L2 and the gathers are
// scattered, so the real limit is L2 sector traffic, not DRAM.
//
// One thread per lane, right and simple: taps are scalar code and rows are read
// with 32-bit loads.  16-byte vector loads, shared-memory tiles for EWA's windows
// and a fused material/texture/shading pass are for later PRs.
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::Rgb;

__device__ __forceinline__ Rgb bilinear(const Atlas& a, int tid, float s, float t, int level) {
  return rt::tap_value(a, rt::bilinear_tap(a, tid, s, t, level));
}

// _sample_anisotropic's average of the used taps (texture_sample.py:170-180).
__device__ __forceinline__ Rgb aniso_average(const Atlas& a, int tid, float s, float t,
                                             const rt::Aniso& f, float max_anisotropy) {
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
  return {acc.r / f.nt, acc.g / f.nt, acc.b / f.nt};
}

// _sample_ewa's weighted average (texture_sample.py:262-278).
__device__ __forceinline__ Rgb ewa_average(const Atlas& a, int tid, const rt::Ewa& e) {
  Rgb acc = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  for (int dj = 0; dj < e.nt; ++dj) {
    const int tj = e.t0 + dj;
    for (int di = 0; di < e.ns; ++di) {
      const int si = e.s0 + di;
      const float r2 = rt::ewa_r2(e, si, tj);
      if (!(r2 < 1.0f)) continue;
      const float w = rt::ewa_weight(r2);
      const Rgb p = rt::texel(a, rt::texel_row(a, tid, si, tj, e.level_c));
      acc.r = acc.r + w * p.r;
      acc.g = acc.g + w * p.g;
      acc.b = acc.b + w * p.b;
      wsum = wsum + w;
    }
  }
  const float m = rt::nan_max(wsum, 1e-20f);
  return {acc.r / m, acc.g / m, acc.b / m};
}

template <int kMode>
__global__ void texture_kernel(Atlas a, rt::Lanes l, int n, float max_anisotropy, int span,
                               float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = l.tex_id[i];
  const float s = l.s[i], t = l.t[i];
  Rgb res;
  if constexpr (kMode == rt::kNearest) {
    res = rt::texel(a, rt::nearest_row(a, tid, s, t));
  } else if constexpr (kMode == rt::kBilinearMode) {
    res = bilinear(a, tid, s, t, 0);
  } else {
    const int levels = a.levels[tid];
    const float dsx = l.ds_dx[i], dsy = l.ds_dy[i], dtx = l.dt_dx[i], dty = l.dt_dy[i];
    rt::Branch branch;
    if constexpr (kMode == rt::kTrilinear) {
      const rt::Trilinear f = rt::trilinear_setup(levels, dsx, dsy, dtx, dty);
      branch = f.branch;
      if (branch == rt::kFilter) {
        const Rgb lo = bilinear(a, tid, s, t, f.lo);
        const Rgb hi = bilinear(a, tid, s, t, f.hi);
        const float omf = 1.0f - f.f;
        res = {omf * lo.r + f.f * hi.r, omf * lo.g + f.f * hi.g, omf * lo.b + f.f * hi.b};
      }
    } else if constexpr (kMode == rt::kAnisotropic) {
      const rt::Aniso f = rt::aniso_setup(levels, dsx, dsy, dtx, dty, max_anisotropy);
      branch = f.branch;
      if (branch == rt::kFilter) res = aniso_average(a, tid, s, t, f, max_anisotropy);
    } else {
      const rt::Ewa e = rt::ewa_setup(a, tid, levels, s, t, dsx, dsy, dtx, dty,
                                      max_anisotropy, span);
      branch = e.branch;
      if (branch == rt::kFilter) res = ewa_average(a, tid, e);
    }
    if (branch == rt::kTop) {
      res = rt::texel(a, rt::top_row(a, tid, levels));  // texel (0, 0) of the last level
    } else if (branch == rt::kBilinear) {
      res = bilinear(a, tid, s, t, 0);
    }
  }
  out[3 * i + 0] = res.r;
  out[3 * i + 1] = res.g;
  out[3 * i + 2] = res.b;
}

template <int kMode>
void launch(unsigned grid, cudaStream_t st, Atlas a, rt::Lanes l, int n, float max_anisotropy,
            int span, float* out) {
  texture_kernel<kMode><<<grid, 256, 0, st>>>(a, l, n, max_anisotropy, span, out);
}

}  // namespace

extern "C" int rt_texture(int mode, const void* data, const void* data4, const void* width,
                          const void* height, const void* levels, const void* offsets,
                          const void* tex_id, const void* s, const void* t,
                          const void* ds_dx, const void* ds_dy, const void* dt_dx,
                          const void* dt_dy, int n, float max_anisotropy, int span, void* out,
                          void* stream) {
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  rt::Lanes l{(const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
              (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy};
  const unsigned grid = rt::grid_for(n, 256);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (mode) {
    case rt::kNearest: launch<rt::kNearest>(grid, st, a, l, n, max_anisotropy, span, o); break;
    case rt::kBilinearMode:
      launch<rt::kBilinearMode>(grid, st, a, l, n, max_anisotropy, span, o);
      break;
    case rt::kTrilinear: launch<rt::kTrilinear>(grid, st, a, l, n, max_anisotropy, span, o); break;
    case rt::kAnisotropic:
      launch<rt::kAnisotropic>(grid, st, a, l, n, max_anisotropy, span, o);
      break;
    case rt::kEwa: launch<rt::kEwa>(grid, st, a, l, n, max_anisotropy, span, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
