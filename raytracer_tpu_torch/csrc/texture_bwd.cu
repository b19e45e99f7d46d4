// K4: the gradient of K3, every texture sampling mode.
//
// Replaces the VJP that JAX derives for raytracer_tpu/ops/texture_sample.py:sample
// (_sample_nearest, _sample_bilinear, _top_texel, _sample_trilinear,
// _sample_anisotropic, _ewa_weight, _sample_ewa and the selects, :29-339); its
// plain PyTorch version is torch.autograd of
// raytracer_tpu_torch/ops/texture_sample.py:sample_plain.
//
// One thread per lane, one instance of texture_bwd_kernel<Mode> per mode.  The
// lane set-up (levels, taps, window and branch) is
// recomputed by the helpers K3 uses (texture.cuh), not saved, so both kernels
// take the same decisions.  The backward is the chain rule of the forward's
// expressions term by term, in JAX's form, not a closed form, which keeps it
// within float rounding of autograd:
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
// Outputs: grad_data4 [X,12] (a bilinear tap's 12 values w_k g into its quad
// row; the renderer's expand_quads gather carries them back to tex_data),
// grad_data [X,3] (a top texel, NEAREST's texel or each EWA texel inside the
// ellipse), and the lane gradients [6,N] (s, t, ds_dx, ds_dy, dt_dx, dt_dy),
// written for every lane.  Any of the three may be null.
//
// Bound on the H100: bytes.  Per lane 7 floats and the 12-byte cotangent in,
// the rows it reads, the atlas gradients and 24 bytes of lane gradients out.
//
// A per-lane scatter (the first design, removed; PERF.md section 6) issued 12
// one-float atomicAdds a tap, every lane, zero cotangents too: on the training
// step's generation 0 (config3, 1080p,
// ANISOTROPIC) 34.9 M atomics in 3.36 ms of device time on an NVIDIA H100
// 80GB HBM3 at 700 W, against a byte bound of 0.047 ms.  Its time followed
// the atomics, not the bytes or the taps (BILINEAR, one tap a lane, took as
// long).  On those lanes 81% take the level-0 bilinear tap of a magnified
// texture; within a warp (32 pixels of one image row) a quad row's run is 2.1
// lanes on the mean (p50 1, p90 4), 15 distinct rows a warp, and the later
// anisotropic taps' runs are 1.0-1.3 lanes (chip_smoke.py, microbench/
// scatter.py:k4_runs).  So a warp's runs are summed first:
//  - a lane whose cotangent is all +-0 reads no row and issues no atomic
//    (exact: the gradients start at +0, and adding +-0 leaves a value as it
//    is; a NaN is not zero and reaches its rows);
//  - every lane of a warp runs the same tap slots, converged: ANISOTROPIC's
//    max_anisotropy taps (slot 1 also carries a bilinear-branch lane's level-0
//    tap), TRILINEAR's lo and hi taps, one for BILINEAR, then a top-texel
//    slot; a lane without a tap in a slot carries key -1, and the slot loop
//    ends where no lane of the warp has a tap;
//  - each run of neighbouring lanes of a warp on one quad row is summed by a
//    segmented shuffle scan of its 12 values, no more steps than the warp's
//    longest run needs, and the run's last lane adds the 48-byte row as
//    three 16-byte vector atomics (atomicAdd(float4*, float4), sm_90 global
//    memory): 3 L2 requests a run where the per-lane scatter made 12 a lane,
//    5.2 M in all;
//  - texel rows (grad_data: NEAREST, the top texel, EWA's window) go through
//    warp_scatter3 (scatter.cuh), K5 bwd's scatter; EWA walks the warp's
//    largest window, its lanes masked outside their own.
// Two other ways to sum a run were measured on the same inputs: each lane's
// 12 values through the warp's slice of shared memory, summed there by lane
// (run, quarter), and the scan with its runs' sums issued from a list in
// shared memory, a row's three quarters from neighbouring lanes.  On the
// step's generation 0 they took 0.168 and 0.172 ms of device time against the
// scan's 0.141 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): the shared
// memory round trip costs more than runs of ~2 lanes save.  They win where
// every lane is its own run (a permutation: 0.256 against 0.414), which the
// renderer's lanes do not give.  (fs, ft) differ from lane to lane, so a run
// cannot sum h alone.  The per-lane arithmetic is a lane-by-lane scatter's
// (--fmad=false), so the lane gradients are its values; only the order of the
// atlas sums differs, and fp32 atomics still change it from run to run.
#include "scatter.cuh"
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::kFullWarp;
using rt::Rgb;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

// One vector atomic of a quad row's quarter (16-byte aligned: the rows are
// 48 B from a 16-byte aligned base, which the wrapper checks).
__device__ __forceinline__ void add_quarter(float* row, int q, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(row) + q, v);
}

// The 12 values a tap adds to its quad row: w_k h for k = 0..3.
__device__ __forceinline__ void quad_values(const rt::Tap& p, Rgb h, float v[12]) {
  const float w[4] = {p.w0, p.w1, p.w2, p.w3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[3 * k + 0] = w[k] * h.r;
    v[3 * k + 1] = w[k] * h.g;
    v[3 * k + 2] = w[k] * h.b;
  }
}

// Adds v[0..11] of each lane with key >= 0 into grad_data4's row `key`.
// Called by all 32 lanes of a warp, converged.
__device__ __forceinline__ void scatter_quad(float* __restrict__ gd4, int key, float v[12]) {
  if (gd4 == nullptr) return;
  if (__ballot_sync(kFullWarp, key >= 0) == 0) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFullWarp, key, 1);
  const unsigned heads = __ballot_sync(kFullWarp, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (kFullWarp >> (31 - lane)));
  // segmented inclusive scan, its steps bounded by the warp's longest run:
  // none where every run is one lane (a later anisotropic tap)
  const int longest = __reduce_max_sync(kFullWarp, key >= 0 ? lane - start + 1 : 0);
  for (int d = 1; d < longest; d <<= 1) {
    float y[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) y[c] = __shfl_up_sync(kFullWarp, v[c], d);
    if (lane - d >= start) {
#pragma unroll
      for (int c = 0; c < 12; ++c) v[c] = y[c] + v[c];
    }
  }
  // a run's last lane holds its sums: three 16-byte vector atomics
  const int next = __shfl_down_sync(kFullWarp, key, 1);
  if (key >= 0 && (lane == 31 || next != key)) {
    float* row = gd4 + 12ll * key;
    add_quarter(row, 0, make_float4(v[0], v[1], v[2], v[3]));
    add_quarter(row, 1, make_float4(v[4], v[5], v[6], v[7]));
    add_quarter(row, 2, make_float4(v[8], v[9], v[10], v[11]));
  }
}

// Adds h into grad_data's row `key` (>= 0); converged warp.
__device__ __forceinline__ void scatter_texel(float* __restrict__ gd, int key, Rgb h,
                                              rt::Scatter3List& list) {
  if (gd != nullptr) rt::warp_scatter3(gd, key, h.r, h.g, h.b, list);
}

// The lane's part of one bilinear tap's backward with cotangent h: the
// cotangents of the tap position (x, y), from the quad row it reads.
__device__ __forceinline__ void tap_cot(const Atlas& a, const rt::Tap& p, Rgb h, float& cot_x,
                                        float& cot_y) {
  const float* q = a.data4 + 12ll * p.row;
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

// One tap of a lane: its cotangents into (cot_x, cot_y), its row into key and
// its 12 values into v.
__device__ __forceinline__ void tap(const Atlas& a, const rt::Tap& p, Rgb h, float& cot_x,
                                    float& cot_y, int& key, float v[12]) {
  tap_cot(a, p, h, cot_x, cot_y);
  quad_values(p, h, v);
  key = (int)p.row;
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

// TRILINEAR's lane gradients after its two taps (cot_s, cot_t hold the taps'
// sums): the blend's cot f through lam and width to the four derivatives
// (cot_d: ds_dx, ds_dy, dt_dx, dt_dy).
__device__ __forceinline__ void trilinear_blend_backward(const Atlas& a, const rt::Tap& lo,
                                                         const rt::Tap& hi, const float d[4],
                                                         const rt::Trilinear& f, Rgb g,
                                                         float cot_d[4]) {
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

template <int kMode>
__global__ void __launch_bounds__(kBlock)
texture_bwd_kernel(Atlas a, rt::Lanes l, const float* __restrict__ cot, int n,
                   float max_anisotropy, int span, float* __restrict__ grad_data,
                   float* __restrict__ grad_data4, float* __restrict__ grad_lanes) {
  __shared__ rt::Scatter3List lists[kWarps];
  rt::Scatter3List& list = lists[threadIdx.x >> 5];
  // no lane returns early: the warp's shuffles need all 32
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Rgb g = {0.0f, 0.0f, 0.0f};
  if (i < n) g = {cot[3 * i + 0], cot[3 * i + 1], cot[3 * i + 2]};
  // a lane whose cotangent is all +-0 is skipped (NaN != 0)
  const bool live = i < n && (g.r != 0.0f || g.g != 0.0f || g.b != 0.0f);
  int tid = 0;
  float s = 0.0f, t = 0.0f;
  if (live) {
    tid = l.tex_id[i];
    s = l.s[i];
    t = l.t[i];
  }
  float cot_s = 0.0f, cot_t = 0.0f;
  float cot_d[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // ds_dx, ds_dy, dt_dx, dt_dy
  float v[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kMode == rt::kNearest) {
    scatter_texel(grad_data, live ? (int)rt::nearest_row(a, tid, s, t) : -1, g,
                         list);
  } else if constexpr (kMode == rt::kBilinearMode) {
    int key = -1;
    if (live) tap(a, rt::bilinear_tap(a, tid, s, t, 0), g, cot_s, cot_t, key, v);
    scatter_quad(grad_data4, key, v);
  } else {
    int levels = 1;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      levels = a.levels[tid];
      d[0] = l.ds_dx[i];
      d[1] = l.ds_dy[i];
      d[2] = l.dt_dx[i];
      d[3] = l.dt_dy[i];
    }
    rt::Branch branch = rt::kBilinear;
    if constexpr (kMode == rt::kTrilinear) {
      rt::Trilinear f{};
      if (live) {
        f = rt::trilinear_setup(levels, d[0], d[1], d[2], d[3]);
        branch = f.branch;
      }
      const bool filt = live && branch == rt::kFilter;
      const bool bil = live && branch == rt::kBilinear;
      // slot 0: the lo tap, or a bilinear-branch lane's level-0 tap; slot 1: hi
      rt::Tap lo{}, hi{};
      float xl = 0.0f, yl = 0.0f, xh = 0.0f, yh = 0.0f;
      int key = -1;
      if (filt) {
        const float omf = 1.0f - f.f;
        lo = rt::bilinear_tap(a, tid, s, t, f.lo);
        tap(a, lo, {g.r * omf, g.g * omf, g.b * omf}, xl, yl, key, v);
      } else if (bil) {
        tap(a, rt::bilinear_tap(a, tid, s, t, 0), g, cot_s, cot_t, key, v);
      }
      scatter_quad(grad_data4, key, v);
      if (__any_sync(kFullWarp, filt)) {
        key = -1;
        if (filt) {
          hi = rt::bilinear_tap(a, tid, s, t, f.hi);
          tap(a, hi, {g.r * f.f, g.g * f.f, g.b * f.f}, xh, yh, key, v);
        }
        scatter_quad(grad_data4, key, v);
      }
      if (filt) {
        cot_s = xl + xh;
        cot_t = yl + yh;
        trilinear_blend_backward(a, lo, hi, d, f, g, cot_d);
      }
    } else if constexpr (kMode == rt::kAnisotropic) {
      rt::Aniso f{};
      if (live) {
        f = rt::aniso_setup(levels, d[0], d[1], d[2], d[3], max_anisotropy);
        branch = f.branch;
      }
      const bool filt = live && branch == rt::kFilter;
      const bool bil = live && branch == rt::kBilinear;
      const Rgb h = filt ? Rgb{g.r / f.nt, g.g / f.nt, g.b / f.nt} : g;
      float cot_step_s = 0.0f, cot_step_t = 0.0f;
      const int max_taps = (int)max_anisotropy;
      // slot k holds tap k of the filter lanes (tap_used falls to false as k
      // grows) and, in slot 1, the bilinear-branch lanes' level-0 tap
      for (int k = 1; k <= max_taps; ++k) {
        const bool use = filt && rt::tap_used(k, f);
        const bool base = bil && k == 1;
        if (!__any_sync(kFullWarp, use || base)) break;
        int key = -1;
        if (use) {
          const float c = rt::tap_coeff(k, f);
          float cot_x, cot_y;
          tap(a, rt::bilinear_tap(a, tid, s + f.step_s * c, t + f.step_t * c, f.level_c), h,
              cot_x, cot_y, key, v);
          cot_s = cot_s + cot_x;
          cot_t = cot_t + cot_y;
          cot_step_s = cot_step_s + c * cot_x;
          cot_step_t = cot_step_t + c * cot_y;
        } else if (base) {
          tap(a, rt::bilinear_tap(a, tid, s, t, 0), g, cot_s, cot_t, key, v);
        }
        scatter_quad(grad_data4, key, v);
      }
      if (filt) {
        cot_d[f.x_major ? 0 : 1] = cot_step_s;
        cot_d[f.x_major ? 2 : 3] = cot_step_t;
      }
    } else {
      rt::Ewa e{};
      if (live) {
        e = rt::ewa_setup(a, tid, levels, s, t, d[0], d[1], d[2], d[3], max_anisotropy, span);
        branch = e.branch;
      }
      const bool filt = live && branch == rt::kFilter;
      const bool bil = live && branch == rt::kBilinear;
      int key = -1;
      if (bil) tap(a, rt::bilinear_tap(a, tid, s, t, 0), g, cot_s, cot_t, key, v);
      scatter_quad(grad_data4, key, v);
      if (grad_data != nullptr) {
        // the weight sum first, in the forward's order
        Rgb h = {0.0f, 0.0f, 0.0f};
        if (filt) {
          float wsum = 0.0f;
          for (int dj = 0; dj < e.nt; ++dj) {
            for (int di = 0; di < e.ns; ++di) {
              const float r2 = rt::ewa_r2(e, e.s0 + di, e.t0 + dj);
              if (r2 < 1.0f) wsum = wsum + rt::ewa_weight(r2);
            }
          }
          const float m = rt::nan_max(wsum, 1e-20f);
          h = {g.r / m, g.g / m, g.b / m};
        }
        // the warp's largest window, each lane masked outside its own
        const int ns = filt ? e.ns : 0, nt = filt ? e.nt : 0;
        const int wns = __reduce_max_sync(kFullWarp, ns);
        const int wnt = __reduce_max_sync(kFullWarp, nt);
        for (int dj = 0; dj < wnt; ++dj) {
          for (int di = 0; di < wns; ++di) {
            int texel = -1;
            Rgb x = {0.0f, 0.0f, 0.0f};
            if (dj < nt && di < ns) {
              const int si = e.s0 + di, tj = e.t0 + dj;
              const float r2 = rt::ewa_r2(e, si, tj);
              if (r2 < 1.0f) {
                const float w = rt::ewa_weight(r2);
                texel = (int)rt::texel_row(a, tid, si, tj, e.level_c);
                x = {h.r * w, h.g * w, h.b * w};
              }
            }
            scatter_texel(grad_data, texel, x, list);
          }
        }
      }
    }
    // the top-texel slot
    scatter_texel(grad_data, live && branch == rt::kTop ?
                         (int)rt::top_row(a, tid, levels) : -1, g, list);
  }
  if (grad_lanes != nullptr && i < n) {
    grad_lanes[0ll * n + i] = cot_s;
    grad_lanes[1ll * n + i] = cot_t;
#pragma unroll
    for (int k = 0; k < 4; ++k) grad_lanes[(2ll + k) * n + i] = cot_d[k];
  }
}

template <int kMode>
int launch(unsigned grid, cudaStream_t st, Atlas a, rt::Lanes l, const float* cot, int n,
           float max_anisotropy, int span, float* gd, float* gd4, float* gl) {
  texture_bwd_kernel<kMode><<<grid, kBlock, 0, st>>>(a, l, cot, n, max_anisotropy, span, gd,
                                                     gd4, gl);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_data4 16-byte aligned.
extern "C" int rt_texture_bwd(int mode, const void* data, const void* data4,
                              const void* width, const void* height, const void* levels,
                              const void* offsets, const void* tex_id, const void* s,
                              const void* t, const void* ds_dx, const void* ds_dy,
                              const void* dt_dx, const void* dt_dy, const void* cot, int n,
                              float maxa, int span, void* grad_data, void* grad_data4,
                              void* grad_lanes, void* stream) {
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  rt::Lanes l{(const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
              (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy};
  const unsigned grid = rt::grid_for(n, kBlock);
  cudaStream_t st = (cudaStream_t)stream;
  const float* c = (const float*)cot;
  float *gd = (float*)grad_data, *gd4 = (float*)grad_data4, *gl = (float*)grad_lanes;
  switch (mode) {
    case rt::kNearest:
      return launch<rt::kNearest>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
    case rt::kBilinearMode:
      return launch<rt::kBilinearMode>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
    case rt::kTrilinear:
      return launch<rt::kTrilinear>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
    case rt::kAnisotropic:
      return launch<rt::kAnisotropic>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
    case rt::kEwa:
      return launch<rt::kEwa>(grid, st, a, l, c, n, maxa, span, gd, gd4, gl);
    default: return (int)cudaErrorInvalidValue;
  }
}
