// K4: the gradient of K3, MIPMAP + ANISOTROPIC texture filtering.
//
// Replaces the VJP that JAX derives for raytracer_tpu/ops/texture_sample.py:sample
// (_sample_bilinear, _top_texel, _sample_anisotropic and the selects, :64-188 and
// :311-339); its plain PyTorch version is torch.autograd of
// raytracer_tpu_torch/ops/texture_sample.py:sample_plain.
//
// One thread per lane.  The lane set-up (level, tap count, major axis, step, the
// tap positions and the branch) is recomputed by the helpers K3 uses
// (texture.cuh), not saved, so both kernels take the same decisions.  The
// backward is the chain rule of the forward's expressions term by term, in JAX's
// form, not a closed form, which keeps it within float rounding of autograd:
//   out = w0 q0 + w1 q1 + w2 q2 + w3 q3, w3 = 1 - w0 - w1 - w2
//     -> cot q_k = w_k g;  cot w_k = g.q_k - g.q3 (k < 3)
//   w0 = (1-fs)(1-ft), w1 = fs(1-ft), w2 = (1-fs)ft; fs = ss - floor(ss), ss = s lw - 0.5
//     -> cot s = cot fs * lw (floor has no gradient)
//   tap x = s + step_s (k/(n+1) - 0.5) -> cot s += cot x; cot step_s += (k/(n+1) - 0.5) cot x
//   step_s = x_major ? ds_dx : ds_dy (likewise t); aniso = acc / n -> g / n per tap
// n, lam and level come through ceil / round and carry no gradient; only the
// branch the lane returns receives the cotangent.
//
// Outputs: grad_data4 [X,12] (12 atomicAdds per used tap into its quad row; the
// renderer's expand_quads gather carries them back to tex_data), grad_data [X,3]
// (3 atomicAdds for a lane that returns the top texel), and the lane gradients
// [6,N] (s, t, ds_dx, ds_dy, dt_dx, dt_dy).  Any of the three may be null.
//
// Bound on the H100: bytes.  Per lane 7 floats and the 12-byte cotangent in, up
// to 9 gathered 48-byte rows and 9 x 12 atomic read-modify-writes, 24 bytes of
// lane gradients out, against ~70 float operations per tap.  fp32 atomics make
// the order of the atlas sums change from run to run; coarse mips and top texels
// are hot spots that many lanes add into.  Warp-aggregated atomics are for a
// later PR.
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::Rgb;

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

__global__ void texture_bwd_kernel(Atlas a, const int* __restrict__ tex_id,
                                   const float* __restrict__ s_in,
                                   const float* __restrict__ t_in,
                                   const float* __restrict__ ds_dx_in,
                                   const float* __restrict__ ds_dy_in,
                                   const float* __restrict__ dt_dx_in,
                                   const float* __restrict__ dt_dy_in,
                                   const float* __restrict__ cot, int n,
                                   float max_anisotropy, float* __restrict__ grad_data,
                                   float* __restrict__ grad_data4,
                                   float* __restrict__ grad_lanes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = tex_id[i];
  const float s = s_in[i], t = t_in[i];
  const int levels = a.levels[tid];
  const rt::Aniso f = rt::aniso_setup(levels, ds_dx_in[i], ds_dy_in[i], dt_dx_in[i],
                                      dt_dy_in[i], max_anisotropy);
  const Rgb g = {cot[3 * i + 0], cot[3 * i + 1], cot[3 * i + 2]};
  float cot_s = 0.0f, cot_t = 0.0f, cot_step_s = 0.0f, cot_step_t = 0.0f;
  if (f.branch == rt::kTop) {
    if (grad_data != nullptr) {
      float* gp = grad_data + 3ll * rt::top_row(a, tid, levels);
      atomicAdd(gp + 0, g.r);
      atomicAdd(gp + 1, g.g);
      atomicAdd(gp + 2, g.b);
    }
  } else if (f.branch == rt::kBilinear) {
    tap_backward(a, rt::bilinear_tap(a, tid, s, t, 0), g, grad_data4, cot_s, cot_t);
  } else {
    const Rgb h = {g.r / f.nt, g.g / f.nt, g.b / f.nt};  // aniso = acc / n
    const int max_taps = (int)max_anisotropy;
    for (int k = 1; k <= max_taps; ++k) {
      if (!rt::tap_used(k, f)) continue;
      const float c = rt::tap_coeff(k, f);
      float cot_x, cot_y;
      tap_backward(a, rt::bilinear_tap(a, tid, s + f.step_s * c, t + f.step_t * c,
                                       f.level_c),
                   h, grad_data4, cot_x, cot_y);
      cot_s = cot_s + cot_x;
      cot_t = cot_t + cot_y;
      cot_step_s = cot_step_s + c * cot_x;
      cot_step_t = cot_step_t + c * cot_y;
    }
  }
  if (grad_lanes != nullptr) {
    grad_lanes[0ll * n + i] = cot_s;
    grad_lanes[1ll * n + i] = cot_t;
    grad_lanes[2ll * n + i] = f.x_major ? cot_step_s : 0.0f;  // ds_dx
    grad_lanes[3ll * n + i] = f.x_major ? 0.0f : cot_step_s;  // ds_dy
    grad_lanes[4ll * n + i] = f.x_major ? cot_step_t : 0.0f;  // dt_dx
    grad_lanes[5ll * n + i] = f.x_major ? 0.0f : cot_step_t;  // dt_dy
  }
}

}  // namespace

extern "C" int rt_texture_aniso_bwd(const void* data, const void* data4, const void* width,
                                    const void* height, const void* levels,
                                    const void* offsets, const void* tex_id, const void* s,
                                    const void* t, const void* ds_dx, const void* ds_dy,
                                    const void* dt_dx, const void* dt_dy, const void* cot,
                                    int n, float max_anisotropy, void* grad_data,
                                    void* grad_data4, void* grad_lanes, void* stream) {
  constexpr int kBlock = 256;
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  texture_bwd_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      a, (const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
      (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy, (const float*)cot, n,
      max_anisotropy, (float*)grad_data, (float*)grad_data4, (float*)grad_lanes);
  return (int)cudaGetLastError();
}
