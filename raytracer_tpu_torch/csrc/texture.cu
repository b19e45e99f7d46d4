// K3: filtered albedo, every texture sampling mode (forward; its gradient is K4
// in texture_bwd.cu, with the lane set-up shared in texture.cuh).
//
// Replaces raytracer_tpu/ops/texture_sample.py:sample (JAX) in each of its modes,
// one instance of vector_kernel<Mode> each:
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
// EWA does ~20 operations for each texel of its window, up to 256 a lane.  The
// atlases (~13 MB on config3) stay in L2 and the gathers are scattered: what
// sets the pace is instructions issued, not bytes (a scalar kernel's BILINEAR,
// one tap a lane, ran at 1.9x its byte bound; PERF.md section 6).
//
// One thread a lane, the same float32 expressions in the same order as the
// plain version; what the design does about the instructions:
//  - a lane reads its level (size, first row) once;
//  - a quad row is three 16-byte loads (the wrapper checks data4's alignment);
//  - a tap of s in [0, 1] wraps with a compare and an add (wrap), integer
//    division only beyond [-w, 2w);
//  - ANISOTROPIC's and TRILINEAR's level-0 fallback is the first tap of the
//    filter's loop, so a warp with both kinds of lane pays max(taps), not the
//    filter's taps and then the fallback's (81% of config3's lanes take it);
//  - EWA walks its window as one loop over ns x nt texels in JAX's dj-major
//    order (a warp pays its largest window, not its largest ns times its
//    largest nt), steps the wrap, and takes its weights from a 128-entry
//    table in device memory built once by the kernel's own expf;
//  - a warp's outputs go out as 16-byte stores through shared memory.
// Left undone: EWA's set-up (two square roots, three divisions and a log2 a
// lane, ~300 instructions) is ~40% of its time, and a warp still runs its
// largest window (2.4x the mean on config3); lanes handed out again by window
// size within a block, texel loads issued a texel ahead, texels read from the
// quad rows and a bank-spread table were all slower.  A fused
// material/texture/shading pass is later work.
#include "texture.cuh"

namespace {

using rt::Atlas;
using rt::Rgb;

constexpr int kBlock = 256;

// A level of one texture, read once a lane: its size and its first row.
struct Level {
  int w, h;
  float fw, fh;
  int base;
};

__device__ __forceinline__ Level level_of(int w0, int h0, const int* offsets, int tid,
                                          int level) {
  Level v;
  v.w = max(w0 >> level, 1);
  v.h = max(h0 >> level, 1);
  v.fw = (float)v.w;
  v.fh = (float)v.h;
  v.base = __ldg(offsets + tid * 16 + level);
  return v;
}

// floor_mod(x, w) for w >= 1: a compare and an add for x in [-w, 2w), which
// holds every texel a tap of s in [0, 1] reaches; the integer division only
// beyond (taps far outside [0, 1], windows wrapped more than once).
__device__ __forceinline__ int wrap(int x, int w) {
  const unsigned ux = (unsigned)x, uw = (unsigned)w;
  if (ux < uw) return x;
  if (ux + uw < uw) return x + w;  // x in [-w, 0)
  if (ux - uw < uw) return x - w;  // x in [w, 2w)
  return rt::floor_mod(x, w);
}

__device__ __forceinline__ Rgb texel_at(const float* __restrict__ data, long long row) {
  const float* p = data + 3ll * row;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// rt::bilinear_tap + rt::tap_value on a level read once: the 48-byte quad row
// as three 16-byte loads (data4 is 16-byte aligned, checked by the wrapper).
__device__ __forceinline__ Rgb tap4(const float* __restrict__ data4, const Level& v, float s,
                                    float t) {
  const float ss = s * v.fw - 0.5f;
  const float tt = t * v.fh - 0.5f;
  const float fss = floorf(ss), ftt = floorf(tt);
  const float fs = ss - fss, ft = tt - ftt;
  const float w0 = (1.0f - fs) * (1.0f - ft);
  const float w1 = fs * (1.0f - ft);
  const float w2 = (1.0f - fs) * ft;
  const float w3 = 1.0f - w0 - w1 - w2;
  const int row = v.base + wrap((int)fss, v.w) + wrap((int)ftt, v.h) * v.w;
  const float4* q = reinterpret_cast<const float4*>(data4 + 12ll * row);
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  // q[0..11] = a.xyzw b.xyzw c.xyzw; the four texels at 0, 3, 6, 9
  return {w0 * a.x + w1 * a.w + w2 * b.z + w3 * c.y,
          w0 * a.y + w1 * b.x + w2 * b.w + w3 * c.z,
          w0 * a.z + w1 * b.y + w2 * c.x + w3 * c.w};
}

// EWA's weights, rt::ewa_weight at each of its 128 indices, in device memory:
// written once a device by ewa_table_kernel (rt_texture launches it before its
// first EWA launch), read through the L1 cache.  Built by
// the kernel's own expf, so the values are rt::ewa_weight's bits.
__device__ float ewa_weights[128];

__global__ void ewa_table_kernel() {
  const float r2q = (float)threadIdx.x / 127.0f;
  ewa_weights[threadIdx.x] = expf(-2.0f * r2q) - 0.1353352832366127f;
}

// rt::ewa_weight from the table; an index below 0 (r2 rounded below 0) takes
// rt::ewa_weight itself.  r2 < 1 here, so the index is at most 128 and floor's
// integer is rt::ewa_weight's index.
__device__ __forceinline__ float table_weight(float r2) {
  const int idx = min(__float2int_rd(r2 * 128.0f + 0.5f), 127);
  if (idx < 0) return rt::ewa_weight(r2);
  return __ldg(ewa_weights + idx);
}

// What EWA's window loop needs of a lane: its ellipse, its box and its level.
struct EwaLane {
  float ss, tt, a, b, c;
  int s0, t0, ns, nt;
  int base, w, h;
};

__device__ __forceinline__ EwaLane ewa_lane(const rt::Ewa& e, const Level& v) {
  return {e.ss, e.tt, e.a, e.b, e.c, e.s0, e.t0, e.ns, e.nt, v.base, v.w, v.h};
}

// _sample_ewa's weighted average (texture_sample.py:262-278) over the window in
// JAX's dj-major order, one loop over its
// ns x nt texels (a warp runs its largest window, not its largest ns times its
// largest nt); the wrap is taken once and stepped, r2's t term once a row.
__device__ __forceinline__ Rgb ewa_window(const float* __restrict__ data, const EwaLane& e) {
  Rgb acc = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  const int count = e.ns * e.nt;
  int di = 0, tj = e.t0, x = wrap(e.s0, e.w), y = wrap(e.t0, e.h), x0 = x;
  float vv = (float)tj - e.tt;
  float cvv = e.c * vv * vv;
  for (int k = 0; k < count; ++k) {
    const float uu = (float)(e.s0 + di) - e.ss;
    const float r2 = e.a * uu * uu + e.b * uu * vv + cvv;
    if (r2 < 1.0f) {
      const float w = table_weight(r2);
      const Rgb p = texel_at(data, (long long)(e.base + x + y * e.w));
      acc.r = acc.r + w * p.r;
      acc.g = acc.g + w * p.g;
      acc.b = acc.b + w * p.b;
      wsum = wsum + w;
    }
    x = x + 1 == e.w ? 0 : x + 1;
    if (++di == e.ns) {
      di = 0;
      x = x0;
      y = y + 1 == e.h ? 0 : y + 1;
      vv = (float)(++tj) - e.tt;
      cvv = e.c * vv * vv;
    }
  }
  const float m = rt::nan_max(wsum, 1e-20f);
  return {acc.r / m, acc.g / m, acc.b / m};
}

// One lane of sample() in mode kMode: the level read once a lane, the vector
// taps and the table.
template <int kMode>
__device__ __forceinline__ Rgb vector_lane(const Atlas& a, const rt::Lanes& l, int i,
                                           float max_anisotropy, int span) {
  const int tid = __ldg(l.tex_id + i);
  const float s = __ldg(l.s + i), t = __ldg(l.t + i);
  const int w0 = __ldg(a.width + tid), h0 = __ldg(a.height + tid);
  if constexpr (kMode == rt::kNearest) {
    const int x = (int)rintf(s * (float)w0);
    const int y = (int)rintf(t * (float)h0);
    const Level v = level_of(w0, h0, a.offsets, tid, 0);
    return texel_at(a.data, (long long)(v.base + wrap(x, v.w) + wrap(y, v.h) * v.w));
  } else if constexpr (kMode == rt::kBilinearMode) {
    return tap4(a.data4, level_of(w0, h0, a.offsets, tid, 0), s, t);
  } else {
    const int levels = __ldg(a.levels + tid);
    const float dsx = __ldg(l.ds_dx + i), dsy = __ldg(l.ds_dy + i);
    const float dtx = __ldg(l.dt_dx + i), dty = __ldg(l.dt_dy + i);
    rt::Branch branch;
    Rgb res;
    // A lane on the level-0 bilinear branch takes its tap where a filter lane
    // takes its first, so a warp with both runs the taps once, not the
    // filter's and then the fallback's.
    if constexpr (kMode == rt::kTrilinear) {
      const rt::Trilinear f = rt::trilinear_setup(levels, dsx, dsy, dtx, dty);
      branch = f.branch;
      if (branch != rt::kTop) {
        const bool filt = branch == rt::kFilter;
        const Rgb lo = tap4(a.data4, level_of(w0, h0, a.offsets, tid, filt ? f.lo : 0), s, t);
        if (filt) {
          const Rgb hi = tap4(a.data4, level_of(w0, h0, a.offsets, tid, f.hi), s, t);
          const float omf = 1.0f - f.f;
          res = {omf * lo.r + f.f * hi.r, omf * lo.g + f.f * hi.g, omf * lo.b + f.f * hi.b};
        } else {
          res = lo;
        }
      }
    } else if constexpr (kMode == rt::kAnisotropic) {
      const rt::Aniso f = rt::aniso_setup(levels, dsx, dsy, dtx, dty, max_anisotropy);
      branch = f.branch;
      if (branch != rt::kTop) {
        const bool filt = branch == rt::kFilter;
        const Level v = level_of(w0, h0, a.offsets, tid, filt ? f.level_c : 0);
        const int max_taps = (int)max_anisotropy;
        Rgb acc = {0.0f, 0.0f, 0.0f};
        for (int k = 1;; ++k) {
          // tap_used(k) fails for every later k once it fails
          if (filt ? k > max_taps || !rt::tap_used(k, f) : k > 1) break;
          float ts = s, tt = t;
          if (filt) {
            const float c = rt::tap_coeff(k, f);
            ts = s + f.step_s * c;
            tt = t + f.step_t * c;
          }
          const Rgb tap = tap4(a.data4, v, ts, tt);
          if (filt) {
            acc.r = acc.r + tap.r;
            acc.g = acc.g + tap.g;
            acc.b = acc.b + tap.b;
          } else {
            acc = tap;  // 0 + tap would turn a -0 into +0
          }
        }
        res = filt ? Rgb{acc.r / f.nt, acc.g / f.nt, acc.b / f.nt} : acc;
      }
    } else {
      const rt::Ewa e = rt::ewa_setup(a, tid, levels, s, t, dsx, dsy, dtx, dty,
                                      max_anisotropy, span);
      branch = e.branch;
      if (branch == rt::kFilter)
        res = ewa_window(a.data, ewa_lane(e, level_of(w0, h0, a.offsets, tid, e.level_c)));
      else if (branch == rt::kBilinear)
        res = tap4(a.data4, level_of(w0, h0, a.offsets, tid, 0), s, t);
    }
    if (branch == rt::kTop) res = texel_at(a.data, rt::top_row(a, tid, levels));
    return res;
  }
}

// A warp's 32 results through its slice of shared memory, out as 24 16-byte
// stores (the block's first lane is a multiple of 256, so 16-byte aligned in out).
__device__ __forceinline__ void store_warp(float* stage, float* __restrict__ out, int n, int i,
                                           Rgb res) {
  const int lane = threadIdx.x & 31;
  float* w = stage + 3 * (threadIdx.x - lane);
  w[3 * lane] = res.r;
  w[3 * lane + 1] = res.g;
  w[3 * lane + 2] = res.b;
  __syncwarp();
  const int first = i - lane;
  const int m = 3 * min(32, n - first);  // this warp's floats; <= 0 past the end
  float* o = out + 3ll * first;
  if (m == 96) {
    if (lane < 24) reinterpret_cast<float4*>(o)[lane] = reinterpret_cast<const float4*>(w)[lane];
  } else {
    for (int j = lane; j < m; j += 32) o[j] = w[j];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kBlock)
vector_kernel(Atlas a, rt::Lanes l, int n, float max_anisotropy, int span,
              float* __restrict__ out) {
  __shared__ __align__(16) float stage[3 * kBlock];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Rgb res = {0.0f, 0.0f, 0.0f};
  if (i < n) res = vector_lane<kMode>(a, l, i, max_anisotropy, span);
  store_warp(stage, out, n, i, res);
}

}  // namespace

extern "C" int rt_texture(int mode, const void* data, const void* data4,
                          const void* width, const void* height, const void* levels,
                          const void* offsets, const void* tex_id, const void* s,
                          const void* t, const void* ds_dx, const void* ds_dy,
                          const void* dt_dx, const void* dt_dy, int n, float max_anisotropy,
                          int span, void* out, void* stream) {
  Atlas a{(const float*)data, (const float*)data4, (const int*)width,
          (const int*)height, (const int*)levels, (const int*)offsets};
  rt::Lanes l{(const int*)tex_id, (const float*)s, (const float*)t, (const float*)ds_dx,
              (const float*)ds_dy, (const float*)dt_dx, (const float*)dt_dy};
  const unsigned grid = rt::grid_for(n, kBlock);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  if (mode == rt::kEwa) {
    static bool built[64] = {};  // the weight table, once a device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!built[dev]) {  // and waited for, so that a launch on any stream finds it
      ewa_table_kernel<<<1, 128, 0, st>>>();
      const cudaError_t err = cudaStreamSynchronize(st);
      if (err != cudaSuccess) return (int)err;
      built[dev] = true;
    }
  }
  switch (mode) {
    case rt::kNearest:
      vector_kernel<rt::kNearest><<<grid, kBlock, 0, st>>>(a, l, n, max_anisotropy, span, o);
      break;
    case rt::kBilinearMode:
      vector_kernel<rt::kBilinearMode><<<grid, kBlock, 0, st>>>(a, l, n, max_anisotropy, span,
                                                                o);
      break;
    case rt::kTrilinear:
      vector_kernel<rt::kTrilinear><<<grid, kBlock, 0, st>>>(a, l, n, max_anisotropy, span, o);
      break;
    case rt::kAnisotropic:
      vector_kernel<rt::kAnisotropic><<<grid, kBlock, 0, st>>>(a, l, n, max_anisotropy, span,
                                                               o);
      break;
    case rt::kEwa:
      vector_kernel<rt::kEwa><<<grid, kBlock, 0, st>>>(a, l, n, max_anisotropy, span, o);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
