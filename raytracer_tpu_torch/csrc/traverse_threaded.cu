// K10: closest-hit and any-hit walks of the stackless threaded binary BVH.
//
// Replaces raytracer_tpu/ops/traversal.py:trace_closest and trace_any (JAX,
// :361 and :381; one iteration of their walk is _step, :230-318); the plain
// PyTorch version is raytracer_tpu_torch/ops/traversal.py:trace_plain.
//
// Tables (ops/traversal.py:build_scene_bvh): box [U,6] f32 min|max; node [U,3]
// i32 left | kind | count; links [8,U,2] i32 near | skip per octant, with the
// DONE (-1) and BLAS_EXIT (-2) sentinels; inst_mat [I+1,12] (slot 0 identity);
// inst_root [I+1] i32; tri [T,9] f32 p0|e1|e2.
//
// One thread per ray walks [TLAS | BLASes] by the links until DONE: no stack,
// one `resume` register for the TLAS -> BLAS entry, a (pair, remaining)
// cursor over the current leaf.  The ray of the current space, its
// reciprocals and its octant are set when the walk enters a space: once for
// the TLAS (through slot 0's identity rows, as the plain version: they can
// turn a -0 component into +0, and so an infinite reciprocal's sign), once on
// each TLAS-leaf entry, and restored from registers on each BLAS exit.  JAX's
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
// operations, so ids, t and steps equal it.
//
// Bound on the H100: latency of dependent gathers.  Each iteration reads one
// node (24 + 12 + 8 bytes) or one triangle pair (72 bytes) chosen by the
// previous iteration, and does one slab test or two Moller-Trumbore tests;
// the 1080p scene's tables (~30 MB) fit the 50 MB L2.
// A binary walk takes several times K1's iterations (one node or one pair each,
// against K1's 8 children or 8 triangles), so it is expected slower than K1.
// This first version is one thread per ray with 32-bit loads.
#include "common.cuh"

namespace {

constexpr int kDone = -1;
constexpr int kBlasExit = -2;
constexpr int kInternal = 0;
constexpr int kTlasLeaf = 1;
constexpr int kBlasLeaf = 2;
constexpr float kRayEpsilon = 0.005f;
constexpr float kTiny = 1e-20f;
// Guard against a malformed table: a walk of a valid table visits each node
// at most once per instance.  A walk that reaches it stops and is counted
// incomplete instead of hanging the card.
constexpr long long kMaxIterations = 1ll << 26;

struct Tables {
  const float* box;
  const int* node;
  const int* links;
  int n_nodes;
  const float* inst_mat;
  const int* inst_root;
  const float* tri;
  int ordered;
};

// intersect.triangle_hit: (hit, t) of the ray against the triangle at row r
__device__ __forceinline__ bool triangle_hit(const float* r, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float t_max,
                                             float* t_out) {
  const float p0x = r[0], p0y = r[1], p0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(a) < kTiny ? (a < 0.0f ? -kTiny : kTiny) : a);
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

template <bool kAnyHit>
__global__ void threaded_kernel(Tables tb_, const float* __restrict__ o,
                                const float* __restrict__ d, const float* __restrict__ t_max,
                                const uint8_t* __restrict__ active, int n,
                                float* __restrict__ t_out, int* __restrict__ best_out,
                                int* __restrict__ steps_out, uint8_t* __restrict__ found_out,
                                int* __restrict__ incomplete) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float owx = o[3 * i], owy = o[3 * i + 1], owz = o[3 * i + 2];
  const float dwx = d[3 * i], dwy = d[3 * i + 1], dwz = d[3 * i + 2];
  const float t_fixed = t_max[i];
  float tb = t_fixed;
  int best = -1, steps = 0;
  int cur = active[i] ? 0 : kDone;
  int resume = -1, inst = -1;  // the TLAS continuation and the entered instance
  int pi = 0, rem = 0;         // pair cursor
  bool found = false, lost = false;

  // the ray in the current space, its reciprocals and octant
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;
  auto enter = [&](int slot) {
    const float* m = tb_.inst_mat + 12 * slot;
    ox = m[0] * owx + m[1] * owy + m[2] * owz + m[3];
    oy = m[4] * owx + m[5] * owy + m[6] * owz + m[7];
    oz = m[8] * owx + m[9] * owy + m[10] * owz + m[11];
    dx = m[0] * dwx + m[1] * dwy + m[2] * dwz;
    dy = m[4] * dwx + m[5] * dwy + m[6] * dwz;
    dz = m[8] * dwx + m[9] * dwy + m[10] * dwz;
    ix = 1.0f / dx;
    iy = 1.0f / dy;
    iz = 1.0f / dz;
    oct = tb_.ordered ? ((dx > 0.0f) | ((dy > 0.0f) << 1) | ((dz > 0.0f) << 2)) : 0;
  };
  enter(0);
  const float tox = ox, toy = oy, toz = oz, tdx = dx, tdy = dy, tdz = dz;
  const float tix = ix, tiy = iy, tiz = iz;
  const int toct = oct;

  for (long long it = 0;; ++it) {
    const bool has_tri = rem > 0;
    if (!has_tri && cur < 0 && cur != kBlasExit) break;  // done
    if (it == kMaxIterations) {
      lost = true;
      break;
    }
    if (cur == kBlasExit && !has_tri) {
      cur = resume;
      resume = -1;
      inst = -1;
      ox = tox, oy = toy, oz = toz, dx = tdx, dy = tdy, dz = tdz;
      ix = tix, iy = tiy, iz = tiz;
      oct = toct;
    }

    if (has_tri) {
      const float* r = tb_.tri + 18ll * pi;
      float t0, t1;
      const bool hit0 = triangle_hit(r, ox, oy, oz, dx, dy, dz, kAnyHit ? t_fixed : tb, &t0);
      if (!kAnyHit && hit0) tb = t0;
      const bool hit1 =
          triangle_hit(r + 9, ox, oy, oz, dx, dy, dz, kAnyHit ? t_fixed : tb, &t1);
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
    if (cur < 0) continue;  // an exit to DONE: nothing left to visit

    ++steps;
    const float* bx = tb_.box + 6ll * cur;
    const int* nd = tb_.node + 3ll * cur;
    const int* lk = tb_.links + 2ll * ((long long)oct * tb_.n_nodes + cur);
    const float t0x = (bx[0] - ox) * ix, t1x = (bx[3] - ox) * ix;
    const float t0y = (bx[1] - oy) * iy, t1y = (bx[4] - oy) * iy;
    const float t0z = (bx[2] - oz) * iz, t1z = (bx[5] - oz) * iz;
    const float t_near = rt::nan_max(rt::nan_max(kRayEpsilon, rt::nan_min(t0x, t1x)),
                                     rt::nan_max(rt::nan_min(t0y, t1y), rt::nan_min(t0z, t1z)));
    const float t_far = rt::nan_min(rt::nan_min(kAnyHit ? t_fixed : tb, rt::nan_max(t0x, t1x)),
                                    rt::nan_min(rt::nan_max(t0y, t1y), rt::nan_max(t0z, t1z)));
    const int left = nd[0], kind = nd[1], count = nd[2];
    const int near = lk[0], skip = lk[1];
    if (!(t_near < t_far)) {
      cur = skip;
    } else if (kind == kInternal) {
      cur = near;
    } else if (kind == kBlasLeaf) {
      pi = left >> 1;
      rem = count >> 1;
      cur = skip;
    } else if (kind == kTlasLeaf) {
      cur = tb_.inst_root[left + 1];
      resume = skip;
      inst = left;
      enter(left + 1);
    } else {
      cur = skip;  // not produced by build_scene_bvh
    }
  }

  if (kAnyHit) {
    found_out[i] = found;
    if (lost) atomicAdd(incomplete, 1);
  } else {
    t_out[i] = tb;
    best_out[i] = best;
    steps_out[i] = steps;
    if (lost) atomicAdd(incomplete, 1);
  }
}

}  // namespace

// o, d: [n,3] f32 world rays; t_max: [n] f32; active: [n] bool.  Closest:
// writes t_out [n] f32, best_out [n] i32 (tri << 8 | inst + 1, -1 = miss),
// steps_out [n] i32 (node visits).  Any: writes found_out [n] bool.  Both add
// the lanes that hit the iteration guard to *incomplete (zeroed by the caller).
extern "C" int rt_trace_threaded(int any_hit, const void* box, const void* node,
                                 const void* links, int n_nodes, const void* inst_mat,
                                 const void* inst_root, const void* tri, int ordered,
                                 const void* o, const void* d, const void* t_max,
                                 const void* active, int n, void* t_out, void* best_out,
                                 void* steps_out, void* found_out, void* incomplete,
                                 void* stream) {
  Tables tb{(const float*)box, (const int*)node, (const int*)links, n_nodes,
            (const float*)inst_mat, (const int*)inst_root, (const float*)tri, ordered};
  constexpr int kBlock = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    threaded_kernel<true><<<rt::grid_for(n, kBlock), kBlock, 0, s>>>(
        tb, (const float*)o, (const float*)d, (const float*)t_max, (const uint8_t*)active, n,
        nullptr, nullptr, nullptr, (uint8_t*)found_out, (int*)incomplete);
  } else {
    threaded_kernel<false><<<rt::grid_for(n, kBlock), kBlock, 0, s>>>(
        tb, (const float*)o, (const float*)d, (const float*)t_max, (const uint8_t*)active, n,
        (float*)t_out, (int*)best_out, (int*)steps_out, nullptr, (int*)incomplete);
  }
  return (int)cudaGetLastError();
}
