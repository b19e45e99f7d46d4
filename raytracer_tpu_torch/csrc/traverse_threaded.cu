// K10: closest-hit and any-hit walks of the stackless threaded binary BVH.
//
// Replaces raytracer_tpu/ops/traversal.py:trace_closest and trace_any (JAX,
// :361 and :381; one iteration of their walk is _step, :230-318); the plain
// PyTorch version is raytracer_tpu_torch/ops/traversal.py:trace_plain.
//
// rec_kernel reads one 32-byte, 32-byte aligned node record a visit with two
// 16-byte loads, and an 80-byte row a triangle pair with five
// (ops/traversal.py: octant_records, pair_rows); the any-hit walk runs over
// the active lanes only, which K6 lists on the device.  Links carry the DONE
// (-1) and BLAS_EXIT (-2) sentinels; inst_mat [I+1,12] (slot 0 identity);
// inst_root [I+1] i32.  The octant records, [8,U] x 8 words, hold a node's
// box and the octant's near and skip; a leaf's near
// (never followed) holds its payload, bit 31 set so it never is a child, bit
// 30 set for a TLAS leaf: BLAS leaf count / 2 << 21 | left / 2, TLAS leaf
// count << 8 | instance (0x80000000 | ... is never DONE or BLAS_EXIT).
//
// One thread per ray walks [TLAS | BLASes] by the links until DONE: no stack,
// one `resume` register for the TLAS -> BLAS entry, a (pair, remaining)
// cursor over the current leaf.  The ray of the current space, its
// reciprocals and its octant are set when the walk enters a space: once for
// the TLAS (through slot 0's identity rows, as the plain version: they can
// turn a -0 component into +0, and so an infinite reciprocal's sign), once on
// each TLAS-leaf entry, and restored on each BLAS exit (the world and TLAS
// rays are kept in shared memory).  JAX's
// vectorised _step transforms on every iteration; the inputs are the same
// floats, so the results are the same.  Each iteration is one _step:
//   - a BLAS exit (cur == BLAS_EXIT, no pair left) restores the TLAS ray and
//     continues at `resume`;
//   - with pairs left: two Moller-Trumbore tests (|a| < 1e-20 guard as
//     _nonzero), hit1 against the t that hit0 may have lowered (strict <), so
//     ties resolve as in JAX; any-hit tests both against t_max and retires;
//   - otherwise a node visit (counted in `steps`): slab test against the best
//     t with NaN-propagating min/max; internal -> near, miss or BLAS leaf ->
//     skip (a BLAS leaf arms the cursor), TLAS leaf -> the instance's BLAS root
//     with resume = skip, and the ray into the instance's space.
// NAIVE (ordered = 0) takes octant 0's links.  Built with --fmad=false: the
// transform, slab and triangle arithmetic are the plain version's float32
// operations, so ids, t and steps equal it.  The reciprocals are
// __frcp_rn (IEEE 1/x rounded to nearest: the bits of the division), and its
// min / max are PTX min.NaN / max.NaN (slab_hit_rec says why zeros' signs do
// not matter there).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// threaded_closest / threaded_any rows, PERF.md section 6): instructions
// issued, then the latency of one dependent row a step; not bytes.  On
// config3's 1080p primaries the octant records cut the sectors the lanes
// touch 2.9x against separate box, node, link and triangle tables read with
// 32-bit loads (475 M to 161 M) but the time only 1.19x (1.47 to 1.24 ms);
// cutting instructions then took it to 0.68 ms: single-instruction NaN
// min / max in the slab test (12 a node visit, each a compare, two NaN tests
// and a select before), __frcp_rn for IEEE division, and the TLAS ray kept
// in shared memory instead of transformed again at a BLAS exit.  A warp runs
// the pair path in most iterations (some lane of 32 is in a leaf), so a
// pair's ~100 operations ride on every node visit.  Tried and slower: the
// node layout (a [U] record beside the [8,U] links, two sectors a visit),
// one triangle an iteration, warp-uniform steps (pairs only once enough lanes
// wait), and persistent warps refilled from a counter.  Compacting any hit's
// active lanes (38% of config3's shadow lanes) lifts its warp efficiency from
// 0.65 to 0.77 and takes 0.73 to 0.64 ms, the K6 launch included.
#include "common.cuh"

namespace {

constexpr int kDone = -1;
constexpr int kBlasExit = -2;
constexpr int kInternal = 0;
constexpr int kTlasLeaf = 1;
constexpr int kBlasLeaf = 2;
constexpr float kRayEpsilon = 0.005f;
constexpr float kTiny = 1e-20f;
constexpr int kTlasBit = 1 << 30;  // the octant records: a TLAS leaf's payload
constexpr int kBlock = 128;
constexpr int kMinBlocks = 8;  // rec_kernel blocks an SM: at most 64 registers a thread
// Guard against a malformed table: a walk of a valid table visits each node
// at most once per instance.  A walk that reaches it stops and is counted
// incomplete instead of hanging the card.
constexpr long long kMaxIterations = 1ll << 26;

struct RecTables {
  const int4* rec;         // [8U] octant records, two int4 each
  int n_nodes;
  const float4* inst_mat;  // [I+1] x 3 float4
  const int* inst_root;
  const float4* pairs;     // [T/2] x 5 float4
  int ordered;
};

template <bool kAnyHit>
__device__ __forceinline__ void write_lane(int i, float tb, int best, int steps, bool found,
                                           bool lost, float* t_out, int* best_out,
                                           int* steps_out, uint8_t* found_out, int* incomplete) {
  if (kAnyHit) {
    found_out[i] = found;
  } else {
    t_out[i] = tb;
    best_out[i] = best;
    steps_out[i] = steps;
  }
  if (lost) atomicAdd(incomplete, 1);
}

// NaN-propagating min / max in one instruction each (PTX min.NaN, max.NaN).
// Zeros of either sign may come out differently from rt::nan_min / nan_max,
// which the slab test cannot see: t_near >= kRayEpsilon, and < ignores signs.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bool slab_hit_rec(float lx, float ly, float lz, float hx, float hy,
                                             float hz, float ox, float oy, float oz, float ix,
                                             float iy, float iz, float t_best) {
  const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  const float t_near = max_nan(max_nan(kRayEpsilon, min_nan(t0x, t1x)),
                               max_nan(min_nan(t0y, t1y), min_nan(t0z, t1z)));
  const float t_far = min_nan(min_nan(t_best, max_nan(t0x, t1x)),
                              min_nan(max_nan(t0y, t1y), max_nan(t0z, t1z)));
  return t_near < t_far;
}

// intersect.triangle_hit: (hit, t) of the ray against one triangle, with the
// reciprocal as __frcp_rn: IEEE 1/x rounded to nearest, the same bits as the
// division 1.0f / x
__device__ __forceinline__ bool triangle_hit_rec(float p0x, float p0y, float p0z, float e1x,
                                                 float e1y, float e1z, float e2x, float e2y,
                                                 float e2z, float ox, float oy, float oz,
                                                 float dx, float dy, float dz, float t_max,
                                                 float* t_out) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = __frcp_rn(fabsf(a) < kTiny ? (a < 0.0f ? -kTiny : kTiny) : a);
  const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  *t_out = t;
  return (u > 0.0f) && (u < 1.0f) && (v > 0.0f) && (u + v < 1.0f) && (t > kRayEpsilon) &&
         (t < t_max);
}

// The record walk: one thread a lane, in lane order or over the compacted
// active lanes (thread k walks lane_list[k]).  The world ray and the TLAS ray
// live in shared memory, read at an instance entry and a BLAS exit.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    rec_kernel(RecTables tb_, const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, const uint8_t* __restrict__ active, int n,
               const int* __restrict__ lane_list, const int* __restrict__ lane_count,
               float* __restrict__ t_out, int* __restrict__ best_out,
               int* __restrict__ steps_out, uint8_t* __restrict__ found_out,
               int* __restrict__ incomplete) {
  __shared__ float ray[16][kBlock];  // world o, d; TLAS o, d, 1/d; octant bits
  const int tid = threadIdx.x;
  int i = blockIdx.x * blockDim.x + tid;
  if (lane_list) {
    if (i >= __ldg(lane_count)) return;
    i = __ldg(lane_list + i);
  } else if (i >= n) {
    return;
  }
  float tb = t_max[i];  // any hit: stays t_max
  if (!active[i]) {
    write_lane<kAnyHit>(i, tb, -1, 0, false, false, t_out, best_out, steps_out, found_out,
                        incomplete);
    return;
  }
  int best = -1, steps = 0, cur = 0, resume = -1, inst = -1;
  int pi = 0, rem = 0;  // pair cursor
  bool found = false, lost = false;
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // the ray in the current space
  int oct;
  auto enter = [&](int slot) {
    const float4 m0 = __ldg(tb_.inst_mat + 3 * slot);
    const float4 m1 = __ldg(tb_.inst_mat + 3 * slot + 1);
    const float4 m2 = __ldg(tb_.inst_mat + 3 * slot + 2);
    const float owx = ray[0][tid], owy = ray[1][tid], owz = ray[2][tid];
    const float dwx = ray[3][tid], dwy = ray[4][tid], dwz = ray[5][tid];
    ox = m0.x * owx + m0.y * owy + m0.z * owz + m0.w;
    oy = m1.x * owx + m1.y * owy + m1.z * owz + m1.w;
    oz = m2.x * owx + m2.y * owy + m2.z * owz + m2.w;
    dx = m0.x * dwx + m0.y * dwy + m0.z * dwz;
    dy = m1.x * dwx + m1.y * dwy + m1.z * dwz;
    dz = m2.x * dwx + m2.y * dwy + m2.z * dwz;
    ix = __frcp_rn(dx);
    iy = __frcp_rn(dy);
    iz = __frcp_rn(dz);
    oct = tb_.ordered ? ((dx > 0.0f) | ((dy > 0.0f) << 1) | ((dz > 0.0f) << 2)) : 0;
  };
  ray[0][tid] = o[3 * i], ray[1][tid] = o[3 * i + 1], ray[2][tid] = o[3 * i + 2];
  ray[3][tid] = d[3 * i], ray[4][tid] = d[3 * i + 1], ray[5][tid] = d[3 * i + 2];
  enter(0);
  ray[6][tid] = ox, ray[7][tid] = oy, ray[8][tid] = oz;
  ray[9][tid] = dx, ray[10][tid] = dy, ray[11][tid] = dz;
  ray[12][tid] = ix, ray[13][tid] = iy, ray[14][tid] = iz;
  ray[15][tid] = __int_as_float(oct);

  for (long long it = 0;; ++it) {
    if (rem <= 0 && cur < 0 && cur != kBlasExit) break;  // done
    if (it == kMaxIterations) {
      lost = true;
      break;
    }
    if (rem > 0) {  // a pair: five 16-byte loads of its 80-byte row
      const float4* r = tb_.pairs + 5 * pi;
      const float4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2), q3 = __ldg(r + 3),
                   q4 = __ldg(r + 4);
      float t0, t1;
      const bool hit0 = triangle_hit_rec(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x,
                                         ox, oy, oz, dx, dy, dz, tb, &t0);
      if (!kAnyHit && hit0) tb = t0;
      const bool hit1 = triangle_hit_rec(q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y,
                                         ox, oy, oz, dx, dy, dz, tb, &t1);
      if (kAnyHit) {
        if (hit0 || hit1) {
          found = true;
          break;
        }
      } else {
        if (hit1) tb = t1;
        if (hit0 || hit1) best = ((hit1 ? 2 * pi + 1 : 2 * pi) << 8) | (inst + 1);
      }
      ++pi;
      --rem;
      continue;
    }
    if (cur == kBlasExit) {  // back to the TLAS's space
      cur = resume;
      resume = -1;
      inst = -1;
      ox = ray[6][tid], oy = ray[7][tid], oz = ray[8][tid];
      dx = ray[9][tid], dy = ray[10][tid], dz = ray[11][tid];
      ix = ray[12][tid], iy = ray[13][tid], iz = ray[14][tid];
      oct = __float_as_int(ray[15][tid]);
      if (cur < 0) continue;  // an exit to DONE
    }

    ++steps;  // a node visit: its record in two 16-byte loads
    const int4* r = tb_.rec + 2 * (oct * tb_.n_nodes + cur);
    const int4 a = __ldg(r), b = __ldg(r + 1);
    const bool box_hit =
        slab_hit_rec(__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z),
                     __int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y), ox, oy, oz,
                     ix, iy, iz, tb);
    const int near = b.z, skip = b.w;
    if (!box_hit) {
      cur = skip;
    } else if (near >= 0) {
      cur = near;
    } else if (near & kTlasBit) {
      inst = near & 0xff;
      cur = __ldg(tb_.inst_root + inst + 1);
      resume = skip;
      enter(inst + 1);
    } else {
      pi = near & 0x1fffff;
      rem = (near >> 21) & 0x1ff;
      cur = skip;
    }
  }
  write_lane<kAnyHit>(i, tb, best, steps, found, lost, t_out, best_out, steps_out, found_out,
                      incomplete);
}

template <bool kAnyHit>
void launch(const RecTables& rec, const float* o, const float* d, const float* t_max,
            const uint8_t* active, int n, const int* lane_list, const int* lane_count,
            float* t_out, int* best_out, int* steps_out, uint8_t* found_out, int* incomplete,
            cudaStream_t s) {
  rec_kernel<kAnyHit><<<rt::grid_for(n, kBlock), kBlock, 0, s>>>(
      rec, o, d, t_max, active, n, lane_list, lane_count, t_out, best_out, steps_out,
      found_out, incomplete);
}

}  // namespace

// The octant records `rec` [8U,8] i32 and the pair rows `pairs` [T/2,20] f32,
// which with inst_mat lie on 16-byte aligned bases.  o, d: [n,3] f32 world
// rays; t_max: [n] f32; active: [n] bool.  Closest: writes t_out [n] f32,
// best_out [n] i32 (tri << 8 | inst + 1, -1 = miss), steps_out [n] i32 (node
// visits).  Any: writes found_out [n] bool.  Both add the lanes that hit the
// iteration guard to *incomplete (zeroed by the caller).  lane_list (null:
// every lane): [n] i32 whose first *lane_count entries are the lanes to walk;
// the other lanes' outputs are the caller's.
extern "C" int rt_trace_threaded(int any_hit, const void* rec, const void* pairs, int n_nodes,
                                 const void* inst_mat, const void* inst_root, int ordered,
                                 const void* o, const void* d, const void* t_max,
                                 const void* active, int n, const void* lane_list,
                                 const void* lane_count, void* t_out, void* best_out,
                                 void* steps_out, void* found_out, void* incomplete,
                                 void* stream) {
  const RecTables recs{(const int4*)rec, n_nodes, (const float4*)inst_mat,
                       (const int*)inst_root, (const float4*)pairs, ordered};
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    launch<true>(recs, (const float*)o, (const float*)d, (const float*)t_max,
                 (const uint8_t*)active, n, (const int*)lane_list, (const int*)lane_count,
                 nullptr, nullptr, nullptr, (uint8_t*)found_out, (int*)incomplete, s);
  else
    launch<false>(recs, (const float*)o, (const float*)d, (const float*)t_max,
                  (const uint8_t*)active, n, (const int*)lane_list, (const int*)lane_count,
                  (float*)t_out, (int*)best_out, (int*)steps_out, nullptr, (int*)incomplete,
                  s);
  return (int)cudaGetLastError();
}
