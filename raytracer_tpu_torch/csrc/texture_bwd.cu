// K4: the gradient of K3, every texture sampling mode.
//
// Replaces the VJP that JAX derives for raytracer_tpu/ops/texture_sample.py:sample
// (_sample_nearest, _sample_bilinear, _top_texel, _sample_trilinear,
// _sample_anisotropic, _ewa_weight, _sample_ewa and the selects, :29-339); its
// plain PyTorch version is torch.autograd of
// raytracer_tpu_torch/ops/texture_sample.py:sample_plain.
//
// One thread per lane, one instance of texture_bwd_kernel<Mode> per mode.  The
// lane set-up (levels, taps, window and branch) is recomputed by the helpers K3
// uses (texture.cuh), not saved, so both kernels take the same decisions.  The
// backward is the chain rule of the forward's expressions term by term, in JAX's
// form, not a closed form, which keeps it within float rounding of autograd:
//   bilinear tap: out = w0 q0 + w1 q1 + w2 q2 + w3 q3, w3 = 1 - w0 - w1 - w2
//     -> cot q_k = w_k g;  cot w_k = g.q_k - g.q3 (k < 3)
//   w0 = (1-fs)(1-ft), w1 = fs(1-ft), w2 = (1-fs)ft; fs = ss - floor(ss), ss = s lw - 0.5
//     -> cot s = cot fs * lw (floor has no gradient)
//   NEAREST: out = data[texel] -> g into that texel; round carries no gradient.
//   TRILINEAR: out = (1-f) A + f B -> (1-f) g and f g into the lo and hi taps;
//     cot f = g.B - g.A, f = lam - floor(lam), lam = lf - 1 + log2(max(width, 1e-8)),
//     width = 2 max(max(|ds_dx|, |ds_dy|), max(|dt_dx|, |dt_dy|)); each max sends
//     its cotangent to the larger operand and half to each at a tie, as
//     jnp.maximum and torch.maximum do.
//   ANISOTROPIC: tap x = s + step_s (k/(n+1) - 0.5) -> cot s += cot x;
//     cot step_s += (k/(n+1) - 0.5) cot x; step_s = x_major ? ds_dx : ds_dy
//     (likewise t); aniso = acc / n -> g / n per tap.
//   EWA: ewa = acc / max(wsum, 1e-20), acc = sum w texel -> w g / max(wsum, 1e-20)
//     into each texel of the window inside the ellipse; the weights come through
//     floor, so EWA's lanes get no gradient (only its level-0 fallback does).
// n, lam, level and the window come through ceil / floor / round and carry no
// gradient; only the branch the lane returns receives the cotangent.
//
// Outputs: grad_data4 [X,12] (12 atomicAdds per bilinear tap into its quad row;
// the renderer's expand_quads gather carries them back to tex_data), grad_data
// [X,3] (3 atomicAdds for a top texel, NEAREST's texel or each EWA texel inside
// the ellipse), and the lane gradients [6,N] (s, t, ds_dx, ds_dy, dt_dx, dt_dy),
// written for every lane.  Any of the three may be null.
//
// Bound on the H100: bytes.  Per lane 7 floats and the 12-byte cotangent in, the
// gathered rows or texels and their atomic read-modify-writes, 24 bytes of lane
// gradients out.  fp32 atomics make the order of the atlas sums change from run
// to run; coarse mips, top texels and EWA's windows at coarse levels are hot
// spots that many lanes add into.  EWA walks its window twice (the weight sum
// first, then the scatter).  Warp-aggregated atomics are for a later PR.
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::Rgb;

__device__ __forceinline__ void scatter3(float* grad_data, long long row, Rgb h) {
  if (grad_data == nullptr) return;
  float* gp = grad_data + 3ll * row;
  atomicAdd(gp + 0, h.r);
  atomicAdd(gp + 1, h.g);
  atomicAdd(gp + 2, h.b);
}

// The backward of one bilinear tap with cotangent h: scatters w_k h into the
// tap's quad row and returns the cotangents of the tap position (x, y).
__device__ __forceinline__ void tap_backward(const Atlas& a, const rt::Tap& p, Rgb h,
                                             float* grad_data4, float& cot_x,
                                             float& cot_y) {
  const float* q = a.data4 + 12ll * p.row;
  if (grad_data4 != nullptr) {
    float* gq = grad_data4 + 12ll * p.row;
    const float w[4] = {p.w0, p.w1, p.w2, p.w3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      atomicAdd(gq + 3 * k + 0, w[k] * h.r);
      atomicAdd(gq + 3 * k + 1, w[k] * h.g);
      atomicAdd(gq + 3 * k + 2, w[k] * h.b);
    }
  }
  // cot w_k = g . q_k, then w3 = 1 - w0 - w1 - w2 sends -cot w3 to the others
  float d0 = h.r * q[0] + h.g * q[1] + h.b * q[2];
  float d1 = h.r * q[3] + h.g * q[4] + h.b * q[5];
  float d2 = h.r * q[6] + h.g * q[7] + h.b * q[8];
  float d3 = h.r * q[9] + h.g * q[10] + h.b * q[11];
  float c0 = d0 - d3, c1 = d1 - d3, c2 = d2 - d3;
  // w0 = (1-fs)(1-ft), w1 = fs(1-ft), w2 = (1-fs)ft
  float omfs = 1.0f - p.fs, omft = 1.0f - p.ft;
  float cot_omfs = c0 * omft + c2 * p.ft;
  float cot_omft = c0 * omfs + c1 * p.fs;
  float cot_fs = c1 * omft - cot_omfs;
  float cot_ft = c2 * omfs - cot_omft;
  cot_x = cot_fs * p.lw;
  cot_y = cot_ft * p.lh;
}

// d max(x, y): all of cot to the larger operand, half to each at a tie.
__device__ __forceinline__ void max_backward(float x, float y, float cot, float& cot_x,
                                             float& cot_y) {
  cot_x = x > y ? cot : (x < y ? 0.0f : 0.5f * cot);
  cot_y = y > x ? cot : (y < x ? 0.0f : 0.5f * cot);
}

// d |x| = sign(x), 0 at 0 as torch.abs (only a width of 0 reaches it, and there
// max(width, 1e-8) takes the constant)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// TRILINEAR's lane gradients: the taps' positions and the blend's cot f through
// lam and width to the four derivatives (cot_d: ds_dx, ds_dy, dt_dx, dt_dy).
__device__ __forceinline__ void trilinear_backward(const Atlas& a, int tid, float s, float t,
                                                   const float d[4], const rt::Trilinear& f,
                                                   Rgb g, float* grad_data4, float& cot_s,
                                                   float& cot_t, float cot_d[4]) {
  const rt::Tap lo = rt::bilinear_tap(a, tid, s, t, f.lo);
  const rt::Tap hi = rt::bilinear_tap(a, tid, s, t, f.hi);
  const float omf = 1.0f - f.f;
  float xl, yl, xh, yh;
  tap_backward(a, lo, {g.r * omf, g.g * omf, g.b * omf}, grad_data4, xl, yl);
  tap_backward(a, hi, {g.r * f.f, g.g * f.f, g.b * f.f}, grad_data4, xh, yh);
  cot_s = xl + xh;
  cot_t = yl + yh;
  // cot f = g.B - g.A -> cot lam; lam = lf - 1 + log2(mw): d log2(mw) = 1 / (mw ln 2)
  const float cot_f = rt::dot(g, rt::tap_value(a, hi)) - rt::dot(g, rt::tap_value(a, lo));
  const float mw = rt::nan_max(f.width, 1e-8f);
  const float cot_mw = cot_f / (mw * 0.6931471805599453f);
  float cot_width, cot_const;
  max_backward(f.width, 1e-8f, cot_mw, cot_width, cot_const);
  // width = 2 max(m1, m2), m1 = max(|ds_dx|, |ds_dy|), m2 = max(|dt_dx|, |dt_dy|)
  const float ax = fabsf(d[0]), ay = fabsf(d[1]), bx = fabsf(d[2]), by = fabsf(d[3]);
  float cot_m1, cot_m2, c[4];
  max_backward(rt::nan_max(ax, ay), rt::nan_max(bx, by), 2.0f * cot_width, cot_m1, cot_m2);
  max_backward(ax, ay, cot_m1, c[0], c[1]);
  max_backward(bx, by, cot_m2, c[2], c[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) cot_d[k] = sign_of(d[k]) * c[k];
}

// ANISOTROPIC's taps (aniso = acc / n): returns cot s, cot t and the steps'.
__device__ __forceinline__ void aniso_backward(const Atlas& a, int tid, float s, float t,
                                               const rt::Aniso& f, float max_anisotropy,
                                               Rgb g, float* grad_data4, float& cot_s,
                                               float& cot_t, float& cot_step_s,
                                               float& cot_step_t) {
  const Rgb h = {g.r / f.nt, g.g / f.nt, g.b / f.nt};
  const int max_taps = (int)max_anisotropy;
  for (int k = 1; k <= max_taps; ++k) {
    if (!rt::tap_used(k, f)) continue;
    const float c = rt::tap_coeff(k, f);
    float cot_x, cot_y;
    tap_backward(a, rt::bilinear_tap(a, tid, s + f.step_s * c, t + f.step_t * c, f.level_c),
                 h, grad_data4, cot_x, cot_y);
    cot_s = cot_s + cot_x;
    cot_t = cot_t + cot_y;
    cot_step_s = cot_step_s + c * cot_x;
    cot_step_t = cot_step_t + c * cot_y;
  }
}

// EWA's window: w g / max(wsum, 1e-20) into each texel inside the ellipse, the
// weight sum taken first in the forward's order.
__device__ __forceinline__ void ewa_backward(const Atlas& a, int tid, const rt::Ewa& e, Rgb g,
                                             float* grad_data) {
  if (grad_data == nullptr) return;
  float wsum = 0.0f;
  for (int dj = 0; dj < e.nt; ++dj) {
    for (int di = 0; di < e.ns; ++di) {
      const float r2 = rt::ewa_r2(e, e.s0 + di, e.t0 + dj);
      if (r2 < 1.0f) wsum = wsum + rt::ewa_weight(r2);
    }
  }
  const float m = rt::nan_max(wsum, 1e-20f);
  const Rgb h = {g.r / m, g.g / m, g.b / m};
  for (int dj = 0; dj < e.nt; ++dj) {
    const int tj = e.t0 + dj;
    for (int di = 0; di < e.ns; ++di) {
      const int si = e.s0 + di;
      const float r2 = rt::ewa_r2(e, si, tj);
      if (!(r2 < 1.0f)) continue;
      const float w = rt::ewa_weight(r2);
      scatter3(grad_data, rt::texel_row(a, tid, si, tj, e.level_c),
               {h.r * w, h.g * w, h.b * w});
    }
  }
}

template <int kMode>
__global__ void texture_bwd_kernel(Atlas a, rt::Lanes l, const float* __restrict__ cot,
                                   int n, float max_anisotropy, int span,
                                   float* __restrict__ grad_data,
                                   float* __restrict__ grad_data4,
                                   float* __restrict__ grad_lanes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = l.tex_id[i];
  const float s = l.s[i], t = l.t[i];
  const Rgb g = {cot[3 * i + 0], cot[3 * i + 1], cot[3 * i + 2]};
  float cot_s = 0.0f, cot_t = 0.0f;
  float cot_d[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // ds_dx, ds_dy, dt_dx, dt_dy
  if constexpr (kMode == rt::kNearest) {
    scatter3(grad_data, rt::nearest_row(a, tid, s, t), g);
  } else if constexpr (kMode == rt::kBilinearMode) {
    tap_backward(a, rt::bilinear_tap(a, tid, s, t, 0), g, grad_data4, cot_s, cot_t);
  } else {
    const int levels = a.levels[tid];
    const float d[4] = {l.ds_dx[i], l.ds_dy[i], l.dt_dx[i], l.dt_dy[i]};
    rt::Branch branch;
    if constexpr (kMode == rt::kTrilinear) {
      const rt::Trilinear f = rt::trilinear_setup(levels, d[0], d[1], d[2], d[3]);
      branch = f.branch;
      if (branch == rt::kFilter)
        trilinear_backward(a, tid, s, t, d, f, g, grad_data4, cot_s, cot_t, cot_d);
    } else if constexpr (kMode == rt::kAnisotropic) {
      const rt::Aniso f = rt::aniso_setup(levels, d[0], d[1], d[2], d[3], max_anisotropy);
      branch = f.branch;
      if (branch == rt::kFilter) {
        float cot_step_s = 0.0f, cot_step_t = 0.0f;
        aniso_backward(a, tid, s, t, f, max_anisotropy, g, grad_data4, cot_s, cot_t,
                       cot_step_s, cot_step_t);
        cot_d[f.x_major ? 0 : 1] = cot_step_s;
        cot_d[f.x_major ? 2 : 3] = cot_step_t;
      }
    } else {
      const rt::Ewa e = rt::ewa_setup(a, tid, levels, s, t, d[0], d[1], d[2], d[3],
                                      max_anisotropy, span);
      branch = e.branch;
      if (branch == rt::kFilter) ewa_backward(a, tid, e, g, grad_data);
    }
    if (branch == rt::kTop) {
      scatter3(grad_data, rt::top_row(a, tid, levels), g);
    } else if (branch == rt::kBilinear) {
      tap_backward(a, rt::bilinear_tap(a, tid, s, t, 0), g, grad_data4, cot_s, cot_t);
    }
  }
  if (grad_lanes != nullptr) {
    grad_lanes[0ll * n + i] = cot_s;
    grad_lanes[1ll * n + i] = cot_t;
#pragma unroll
    for (int k = 0; k < 4; ++k) grad_lanes[(2ll + k) * n + i] = cot_d[k];
  }
}

template <int kMode>
void launch(unsigned grid, cudaStream_t st, Atlas a, rt::Lanes l, const float* cot, int n,
            float max_anisotropy, int span, float* gd, float* gd4, float* gl) {
  texture_bwd_kernel<kMode><<<grid, 256, 0, st>>>(a, l, cot, n, max_anisotropy, span, gd, gd4,
                                                 gl);
}

}  // namespace

extern "C" int rt_texture_bwd(int mode, const void* data, const void* data4, const void* width,
                              const void* height, const void* levels, const void* offsets,
                              const void* tex_id, const void* s, const void* t,
                              const void* ds_dx, const void* ds_dy, const void* dt_dx,
                              const void* dt_dy, const void* cot, int n, float maxa, int span,
                              void* grad_data, void* grad_data4, void* grad_lanes,
                              void* stream) {
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  rt::Lanes l{(const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
              (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy};
  const unsigned grid = rt::grid_for(n, 256);
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)cot;
  float *gd = (float*)grad_data, *gd4 = (float*)grad_data4, *gl = (float*)grad_lanes;
  switch (mode) {
    case rt::kNearest: launch<rt::kNearest>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl); break;
    case rt::kBilinearMode:
      launch<rt::kBilinearMode>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
      break;
    case rt::kTrilinear:
      launch<rt::kTrilinear>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
      break;
    case rt::kAnisotropic:
      launch<rt::kAnisotropic>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
      break;
    case rt::kEwa: launch<rt::kEwa>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
