// K1/K2: closest-hit and any-hit walks of the unified 8-wide BVH table.
//
// Replaces raytracer_tpu/ops/traversal_wide.py:trace_closest and trace_any
// (JAX; one iteration of their walk is _step, :155-336); the plain PyTorch
// version is raytracer_tpu_torch/ops/traversal_wide.py:trace_plain.
//
// Table: rows [0, node_rows) are octant-major wide node records (row
// oct * n_nodes + node: 48 box floats component-major, col c*8 + j, then 8 x f_a,
// 8 x f_b as exact float values), rows node_rows + r are 8-triangle leaf
// records (component-major p0|e1|e2, col c*8 + j).  A stack entry is
// ((kind << 20 | payload) << 8) | inst1, inst1 = instance + 1 (0 = world).
//
// Semantics are _step's, one iteration of the while loop per _step iteration:
//   - pop the stack when cur == POP (retire when it is empty);
//   - leaf: eight Moller-Trumbore tests, strict inequalities, |a| < 1e-30 guard;
//     the smallest t wins, the earliest j on a tie, and must beat the best t
//     strictly; any-hit retires at its first hit;
//   - node: slab test of the 8 children with NaN-propagating min/max (0 * inf is
//     NaN when a direction component is 0); the nearest hit child is taken now,
//     the rest pushed far to near; a push beyond the stack is dropped (the
//     NEAREST ones are lost) and sets the overflow flag that `incomplete` counts;
//   - `steps` counts node visits.
// Built with --fmad=false: the ray transform, slab and triangle arithmetic are
// the plain version's sequence of float32 operations, so ids and steps are
// bit-identical to it.
//
// Bound on the H100: memory latency of dependent gathers.  Each iteration reads
// one 288-byte record chosen by the previous one; the ~40 MB table of the 1080p
// scene fits the 50 MB L2, so the walk is bound by L2 latency and sector
// traffic, not by DRAM bandwidth.  The roofline bound is computed from the
// counted node and leaf visits (chip_smoke.py).
//
// This first version is one thread per ray, right and simple: a per-thread
// stack in local memory, records read with 32-bit loads, no ray reordering.
// Warp-cooperative traversal, 16-byte record loads, TMA and wgmma-free
// restructuring are for later PRs.
#include "common.cuh"

namespace {

constexpr int kPayloadBits = 20;
constexpr int kPayloadMask = (1 << kPayloadBits) - 1;
constexpr int kKindInternal = 0;
constexpr int kKindLeaf = 1;
constexpr int kKindEmpty = 7;
constexpr int kPop = -1;
constexpr int kMaxStack = 64;
constexpr float kRayEpsilon = 0.005f;
// Guard against a malformed table: a walk of a valid table visits each
// (node, instance) pair at most once, far below this.  A walk that reaches it
// stops and is counted incomplete instead of hanging the card.
constexpr long long kMaxIterations = 1ll << 26;

struct Scene {
  const float* table;     // [node_rows + leaf_rows, 72]
  const float* inst_mat;  // [I+1, 12] inverse 3x4 rows, slot 0 identity
  int node_rows;
  int n_nodes;  // node_rows / 8
  int root;
  int stack_size;
  int ordered;
};

template <bool kAnyHit>
__global__ void traverse_kernel(Scene sc, const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ t_max,
                                const uint8_t* __restrict__ active, int n,
                                float* __restrict__ t_out, int* __restrict__ best_out,
                                int* __restrict__ steps_out, uint8_t* __restrict__ found_out,
                                int* __restrict__ incomplete) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float owx = o[3 * i], owy = o[3 * i + 1], owz = o[3 * i + 2];
  const float dwx = d[3 * i], dwy = d[3 * i + 1], dwz = d[3 * i + 2];
  float tb = t_max[i];
  int best = -1, steps = 0, sp = 0;
  bool found = false, ovf = false, done = false;
  int stack[kMaxStack];
  int cur = active[i] ? ((kKindInternal << kPayloadBits | sc.root) << 8) : kPop;
  if (!active[i]) done = true;

  for (long long it = 0; !done; ++it) {
    if (it == kMaxIterations) {
      ovf = true;
      break;
    }
    if (cur == kPop) {
      if (sp == 0) break;
      cur = stack[--sp];
    }
    const int kind = cur >> (kPayloadBits + 8);
    const int payload = (cur >> 8) & kPayloadMask;
    const int inst1 = cur & 255;
    const float* m = sc.inst_mat + 12 * inst1;
    const float ox = m[0] * owx + m[1] * owy + m[2] * owz + m[3];
    const float oy = m[4] * owx + m[5] * owy + m[6] * owz + m[7];
    const float oz = m[8] * owx + m[9] * owy + m[10] * owz + m[11];
    const float dx = m[0] * dwx + m[1] * dwy + m[2] * dwz;
    const float dy = m[4] * dwx + m[5] * dwy + m[6] * dwz;
    const float dz = m[8] * dwx + m[9] * dwy + m[10] * dwz;

    if (kind == kKindLeaf) {
      const float* r = sc.table + 72ll * (sc.node_rows + payload);
      float tmin = INFINITY;
      int jmin = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0x = r[j], p0y = r[8 + j], p0z = r[16 + j];
        const float e1x = r[24 + j], e1y = r[32 + j], e1z = r[40 + j];
        const float e2x = r[48 + j], e2y = r[56 + j], e2z = r[64 + j];
        const float hx = dy * e2z - dz * e2y;
        const float hy = dz * e2x - dx * e2z;
        const float hz = dx * e2y - dy * e2x;
        const float a = e1x * hx + e1y * hy + e1z * hz;
        const float f = 1.0f / (fabsf(a) < 1e-30f ? 1e-30f : a);
        const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
        const float u = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = f * (dx * qx + dy * qy + dz * qz);
        const float t = f * (e2x * qx + e2y * qy + e2z * qz);
        const bool hit = (u > 0.0f) && (u < 1.0f) && (v > 0.0f) && (u + v < 1.0f) &&
                         (t > kRayEpsilon) && (t < tb);
        if (kAnyHit) {
          found = found || hit;
        } else if (hit && t < tmin) {
          tmin = t;
          jmin = j;
        }
      }
      if (kAnyHit) {
        if (found) break;
      } else if (tmin < tb) {
        tb = tmin;
        best = ((payload * 8 + jmin) << 8) | inst1;
      }
      cur = kPop;
    } else if (kind == kKindInternal) {
      ++steps;
      const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
      const int oct = sc.ordered ? ((dx > 0.0f) | ((dy > 0.0f) << 1) | ((dz > 0.0f) << 2)) : 0;
      const float* r = sc.table + 72ll * (oct * sc.n_nodes + payload);
      int entries[8];
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t0x = (r[j] - ox) * ix, t1x = (r[24 + j] - ox) * ix;
        const float t0y = (r[8 + j] - oy) * iy, t1y = (r[32 + j] - oy) * iy;
        const float t0z = (r[16 + j] - oz) * iz, t1z = (r[40 + j] - oz) * iz;
        const float t_near = rt::nan_max(rt::nan_max(kRayEpsilon, rt::nan_min(t0x, t1x)),
                                         rt::nan_max(rt::nan_min(t0y, t1y), rt::nan_min(t0z, t1z)));
        const float t_far = rt::nan_min(rt::nan_min(tb, rt::nan_max(t0x, t1x)),
                                        rt::nan_min(rt::nan_max(t0y, t1y), rt::nan_max(t0z, t1z)));
        const int fa = (int)r[48 + j];  // exact float values: convert, never bitcast
        const int fb = (int)r[56 + j];
        entries[j] = (fa << 8) | (fb > 0 ? fb : inst1);
        if ((t_near < t_far) && ((fa >> kPayloadBits) != kKindEmpty)) bits |= 1u << j;
      }
      if (bits == 0) {
        cur = kPop;
      } else {
        const int first = __ffs(bits) - 1;
        cur = entries[first];
        // the rest, far to near: the nearest ends on top; when the stack is
        // full the remaining (nearer) ones are dropped
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (j > first && (bits >> j) & 1u) {
            if (sp < sc.stack_size) {
              stack[sp++] = entries[j];
            } else {
              ovf = true;
            }
          }
        }
      }
    } else {
      cur = kPop;  // not produced by a valid table
    }
  }

  if (kAnyHit) {
    found_out[i] = found;
    if (ovf && !found) atomicAdd(incomplete, 1);
  } else {
    t_out[i] = tb;
    best_out[i] = best;
    steps_out[i] = steps;
    if (ovf) atomicAdd(incomplete, 1);
  }
}

}  // namespace

// o, d: [n,3] f32 world rays; t_max: [n] f32; active: [n] bool.
// Closest: writes t_out [n] f32, best_out [n] i32 (tri << 8 | inst1, -1 = miss),
// steps_out [n] i32.  Any: writes found_out [n] bool.  Both add the lanes they
// could not finish (stack overflow) to *incomplete, which the caller zeroes.
extern "C" int rt_trace(int any_hit, const void* table, int node_rows, int root,
                        const void* inst_mat, int stack_size, int ordered, const void* o,
                        const void* d, const void* t_max, const void* active, int n,
                        void* t_out, void* best_out, void* steps_out, void* found_out,
                        void* incomplete, void* stream) {
  if (stack_size < 1 || stack_size > kMaxStack) return (int)cudaErrorInvalidValue;
  Scene sc{(const float*)table, (const float*)inst_mat, node_rows, node_rows / 8, root,
           stack_size, ordered};
  constexpr int kBlock = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    traverse_kernel<true><<<rt::grid_for(n, kBlock), kBlock, 0, s>>>(
        sc, (const float*)o, (const float*)d, (const float*)t_max, (const uint8_t*)active,
        n, nullptr, nullptr, nullptr, (uint8_t*)found_out, (int*)incomplete);
  } else {
    traverse_kernel<false><<<rt::grid_for(n, kBlock), kBlock, 0, s>>>(
        sc, (const float*)o, (const float*)d, (const float*)t_max, (const uint8_t*)active,
        n, (float*)t_out, (int*)best_out, (int*)steps_out, nullptr, (int*)incomplete);
  }
  return (int)cudaGetLastError();
}
