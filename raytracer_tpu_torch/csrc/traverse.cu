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
//   - leaf: Moller-Trumbore tests, strict inequalities, |a| < 1e-30 guard;
//     the smallest t wins, the earliest j on a tie, and must beat the best t
//     strictly; any-hit retires at its first hit;
//   - node: slab test of the 8 children with NaN-propagating min/max (0 * inf is
//     NaN when a direction component is 0); the nearest hit child is taken now,
//     the rest pushed far to near; a push beyond the stack is dropped (the
//     NEAREST ones are lost) and sets the overflow flag that `incomplete` counts.
//     The renderer launches with the scene's proven bound
//     (accel/wide.py:stack_bound), which no walk exceeds, unless the caller
//     sets a size;
//   - `steps` counts node visits.
// Built with --fmad=false: the ray transform, slab and triangle arithmetic are
// the plain version's sequence of float32 operations, so ids and steps are
// bit-identical to it.
//
// quant_kernel (K1 / K2): a node visit reads the node's
//     128-byte quantised record (accel/wide.py:quantised_records) with seven
//     16-byte loads instead of 64 floats of the exact row.  Each live child's
//     outer box (which holds its exact box) and inner box (inside it) are
//     decoded as the packer fitted them: a byte permute puts a plane's byte q
//     into the mantissa of 2^(23+e), the record's bias is added, and the slab
//     test's ((plane - o) * inv) follows, each operation rounded.  Addition,
//     subtraction, multiplication by a fixed value, min and max are monotone
//     under round-to-nearest, so a ray that misses the outer box misses the
//     exact one and a ray that hits the inner box hits it: the bit is decided.
//     The rest (undecided) read their six exact floats from the table row and
//     take today's test.  A lane whose inverse direction is not finite or 0,
//     or whose origin is not finite, could see NaN, which today's test turns
//     into a miss: it takes the exact test for every child.  Dead children
//     (empty, or flat on an axis) are out of the record's live mask: today's
//     test never sets them on a NaN-free lane (t_near >= t_far on the flat
//     axis).  So the bits, hence the stack, steps, ids, t and found, are those
//     of the exact test.  A leaf visit reads its row with 16-byte loads (the
//     upper half only when it holds more than 4 live triangles) and tests only
//     its live slots: the packer's padding repeats a leaf's last triangle,
//     which gives the same t and so never wins (earliest j on a tie) nor
//     changes found.  The live count rides in bits 29-31 of a leaf's stack
//     entry.  The ray's transform into an instance's space, its inverse and
//     its octant are kept until the instance changes: the same operations on
//     the same inputs, once a BLAS walk.
//
// Bound on the H100.  Each iteration reads one record chosen by the previous
// one; the ~40 MB table of the 1080p scene fits the 50 MB L2.  An exact row
// is 256 bytes, and K12 over those rows (chip_smoke.py gather_wide_table) is
// as slow as a walk of them.  The quantised record reads 112 bytes a node
// visit; its pace is then set as much by the
// instructions a visit issues (four a plane: the permute, the bias, the slab
// test's two) and by the warps in flight (64 registers, 8 blocks an SM) as by
// the bytes.  The roofline bound is computed from the counted node and leaf
// visits (chip_smoke.py).
#include "common.cuh"

namespace {

constexpr int kPayloadBits = 20;
constexpr int kPayloadMask = (1 << kPayloadBits) - 1;
constexpr int kKindInternal = 0;
constexpr int kKindLeaf = 1;
constexpr int kKindEmpty = 7;
constexpr int kPop = -1;
// The stack's capacity (accel/wide.py STACK_CAPACITY): a dynamically indexed
// local array, so an entry costs only when a ray pushes it.
constexpr int kMaxStack = 128;
constexpr float kRayEpsilon = 0.005f;
// Guard against a malformed table: a walk of a valid table visits each
// (node, instance) pair at most once, far below this.  A walk that reaches it
// stops and is counted incomplete instead of hanging the card.
constexpr long long kMaxIterations = 1ll << 26;

// quant_kernel's counters (chip_smoke.py reads them; STATS in
// ops/traversal_wide.py names them): node visits on the quantised test, node
// visits of exact lanes, undecided children, children decided hit by the inner
// box, leaf visits, leaf visits past 4 live slots, live triangle tests, lanes
// with an exact node visit, transforms into an instance's space
constexpr int kStats = 9;

constexpr int kBlock = 128;  // threads a block

struct Scene {
  const float* table;     // [node_rows + leaf_rows, 72]
  const int4* qrec;       // [node_rows, 8] int4: the quantised node records
  const float* inst_mat;  // [I+1, 12] inverse 3x4 rows, slot 0 identity
  unsigned long long* stats;  // [kStats] (the counting instance only)
  int node_rows;
  int n_nodes;  // node_rows / 8
  int root;
  int stack_size;
  int ordered;
};

// Today's slab test of child j of an exact row r (cols c*8 + j).
__device__ __forceinline__ bool exact_child_hit(const float* __restrict__ r, int j, float ox,
                                                float oy, float oz, float ix, float iy,
                                                float iz, float tb) {
  const float t0x = (r[j] - ox) * ix, t1x = (r[24 + j] - ox) * ix;
  const float t0y = (r[8 + j] - oy) * iy, t1y = (r[32 + j] - oy) * iy;
  const float t0z = (r[16 + j] - oz) * iz, t1z = (r[40 + j] - oz) * iz;
  const float t_near = rt::nan_max(rt::nan_max(kRayEpsilon, rt::nan_min(t0x, t1x)),
                                   rt::nan_max(rt::nan_min(t0y, t1y), rt::nan_min(t0z, t1z)));
  const float t_far = rt::nan_min(rt::nan_min(tb, rt::nan_max(t0x, t1x)),
                                  rt::nan_min(rt::nan_max(t0y, t1y), rt::nan_max(t0z, t1z)));
  return t_near < t_far;
}

// The bits of 2^(23+e) for the signed exponent byte a of w (|e| <= 100).
__device__ __forceinline__ unsigned exp_word(int w, int a) {
  return (unsigned)((int)(signed char)((w >> (8 * a)) & 255) + 150) << 23;
}

// +2^e where the inverse is positive (the lo plane is near), else -2^e: X of
// the plane one step inward of the near plane is X + this (exact).
__device__ __forceinline__ float step_of(int w, int a, bool pos) {
  const float s = __int_as_float(((int)(signed char)((w >> (8 * a)) & 255) + 127) << 23);
  return pos ? s : -s;
}

// X = 2^(23+e) + q * 2^e for plane byte j & 3 of w: the byte permute puts q in
// the low mantissa byte of c, the bits of 2^(23+e).
__device__ __forceinline__ float plane_x(unsigned w, int j, unsigned c) {
  return __uint_as_float(__byte_perm(w, c, (unsigned)(j & 3) | 0x7650u));
}

__device__ __forceinline__ int word_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float comp(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Child j's stack entry: the record's (f_a << 8) | f_b, the current instance
// where f_b = 0 inherits it, a leaf's live slots - 1 (its meta byte) in bits 29-31.
__device__ __forceinline__ int child_entry(const int4& e0, const int4& e1, const int4& mi, int j,
                                           int inst1) {
  const int e = word_of(j < 4 ? e0 : e1, j & 3);
  const unsigned meta = (unsigned)(j < 4 ? mi.x : mi.y) >> (8 * (j & 3));
  return e | ((e & 255) ? 0 : inst1) | (int)((meta & 7u) << 29);
}

// One Moller-Trumbore test of slot j (strict inequalities, |a| < 1e-30 guard):
// folds the hit into found (any hit) or (tmin, jmin) (closest, earliest j on a tie).
template <bool kAnyHit>
__device__ __forceinline__ void tri_test(float p0x, float p0y, float p0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y, float e2z, float ox,
                                         float oy, float oz, float dx, float dy, float dz,
                                         float tb, int j, bool& found, float& tmin, int& jmin) {
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

// The ray in the space of instance inst (inst1 - 1): trace_plain's transform,
// its inverse direction and octant, and whether its slab tests are NaN-free.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct, inst1;
  bool quant;
};

__device__ __forceinline__ void enter(Ray& ry, const Scene& sc, int inst1,
                                      const float* __restrict__ o, const float* __restrict__ d,
                                      int i) {
  const float owx = o[3 * i], owy = o[3 * i + 1], owz = o[3 * i + 2];
  const float dwx = d[3 * i], dwy = d[3 * i + 1], dwz = d[3 * i + 2];
  const float* m = sc.inst_mat + 12 * inst1;
  ry.inst1 = inst1;
  ry.ox = m[0] * owx + m[1] * owy + m[2] * owz + m[3];
  ry.oy = m[4] * owx + m[5] * owy + m[6] * owz + m[7];
  ry.oz = m[8] * owx + m[9] * owy + m[10] * owz + m[11];
  ry.dx = m[0] * dwx + m[1] * dwy + m[2] * dwz;
  ry.dy = m[4] * dwx + m[5] * dwy + m[6] * dwz;
  ry.dz = m[8] * dwx + m[9] * dwy + m[10] * dwz;
  ry.ix = 1.0f / ry.dx;
  ry.iy = 1.0f / ry.dy;
  ry.iz = 1.0f / ry.dz;
  ry.oct = sc.ordered ? ((ry.dx > 0.0f) | ((ry.dy > 0.0f) << 1) | ((ry.dz > 0.0f) << 2)) : 0;
  // NaN-free slab tests: a finite, nonzero inverse and a finite origin
  ry.quant = isfinite(ry.ix) && isfinite(ry.iy) && isfinite(ry.iz) && ry.ix != 0.0f &&
             ry.iy != 0.0f && ry.iz != 0.0f && isfinite(ry.ox) && isfinite(ry.oy) &&
             isfinite(ry.oz);
}

// A node visit: the children's bits, then the nearest set child into cur and the
// rest pushed far to near (the nearest ends on top; when the stack is full the
// remaining, nearer, ones are dropped and ovf set).
template <bool kCount>
__device__ __forceinline__ void quant_node(const Scene& sc, const Ray& ry, int payload, float tb,
                                           int& cur, int* stack, int& sp, bool& ovf,
                                           unsigned* cnt) {
  const int row = ry.oct * sc.n_nodes + payload;
  const int4* qr = sc.qrec + 8ll * row;
  const float* r = sc.table + 72ll * row;
  const int4 e0 = __ldg(qr + 4), e1 = __ldg(qr + 5), mi = __ldg(qr + 6);
  unsigned bits = 0;
  if (ry.quant) {
    const int4 h = __ldg(qr), p0 = __ldg(qr + 1), p1 = __ldg(qr + 2), p2 = __ldg(qr + 3);
    // per axis: the bias g and the bits c of 2^(23+e); one byte permute of a
    // plane byte q into c's low mantissa byte gives X = 2^(23+e) + q * 2^e, and
    // the plane decodes as X + g (accel/wide.py).  The near and far planes'
    // words: the lo plane is near where the inverse is positive.  Plane words:
    // lo_x p0.xy, lo_y p0.zw, lo_z p1.xy, hi_x p1.zw, hi_y p2.xy, hi_z p2.zw
    const float gx = __int_as_float(h.x), gy = __int_as_float(h.y), gz = __int_as_float(h.z);
    const unsigned cx = exp_word(h.w, 0), cy = exp_word(h.w, 1), cz = exp_word(h.w, 2);
    const unsigned alive = (unsigned)h.w >> 24;  // neither empty nor flat
    const bool px = ry.ix > 0.0f, py = ry.iy > 0.0f, pz = ry.iz > 0.0f;
    const unsigned nx0 = px ? p0.x : p1.z, nx1 = px ? p0.y : p1.w;
    const unsigned fx0 = px ? p1.z : p0.x, fx1 = px ? p1.w : p0.y;
    const unsigned ny0 = py ? p0.z : p2.x, ny1 = py ? p0.w : p2.y;
    const unsigned fy0 = py ? p2.x : p0.z, fy1 = py ? p2.y : p0.w;
    const unsigned nz0 = pz ? p1.x : p2.z, nz1 = pz ? p1.y : p2.w;
    const unsigned fz0 = pz ? p2.z : p1.x, fz1 = pz ? p2.w : p1.y;
    // the inward bits of the near / far planes, and a step inward of the near
    // plane (+-2^e; the far plane steps the other way)
    const int bnx = px ? 0 : 3, bny = py ? 1 : 4, bnz = pz ? 2 : 5;
    const int bfx = px ? 3 : 0, bfy = py ? 4 : 1, bfz = pz ? 5 : 2;
    const float ux = step_of(h.w, 0, px), uy = step_of(h.w, 1, py), uz = step_of(h.w, 2, pz);
    const float ox = ry.ox, oy = ry.oy, oz = ry.oz, ix = ry.ix, iy = ry.iy, iz = ry.iz;
    unsigned undecided = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!((alive >> j) & 1u)) continue;
      const bool up = j >= 4;
      // X of each plane; its t is ((X + g) - o) * inv, each operation rounded,
      // as the packer's decode and today's test compute it
      const float qnx = plane_x(up ? nx1 : nx0, j, cx), qfx = plane_x(up ? fx1 : fx0, j, cx);
      const float qny = plane_x(up ? ny1 : ny0, j, cy), qfy = plane_x(up ? fy1 : fy0, j, cy);
      const float qnz = plane_x(up ? nz1 : nz0, j, cz), qfz = plane_x(up ? fz1 : fz0, j, cz);
      const float tn = fmaxf(fmaxf(kRayEpsilon, ((qnx + gx) - ox) * ix),
                             fmaxf(((qny + gy) - oy) * iy, ((qnz + gz) - oz) * iz));
      const float tf = fminf(fminf(tb, ((qfx + gx) - ox) * ix),
                             fminf(((qfy + gy) - oy) * iy, ((qfz + gz) - oz) * iz));
      if (tn < tf) {  // the outer box is hit: try the inner one
        const unsigned in = ((unsigned)(up ? mi.w : mi.z) >> (8 * (j & 3))) & 255u;
        const float inx = qnx + ((in >> bnx) & 1u ? ux : 0.0f);
        const float iny = qny + ((in >> bny) & 1u ? uy : 0.0f);
        const float inz = qnz + ((in >> bnz) & 1u ? uz : 0.0f);
        const float ifx = qfx - ((in >> bfx) & 1u ? ux : 0.0f);
        const float ify = qfy - ((in >> bfy) & 1u ? uy : 0.0f);
        const float ifz = qfz - ((in >> bfz) & 1u ? uz : 0.0f);
        const float tni = fmaxf(fmaxf(kRayEpsilon, ((inx + gx) - ox) * ix),
                                fmaxf(((iny + gy) - oy) * iy, ((inz + gz) - oz) * iz));
        const float tfi = fminf(fminf(tb, ((ifx + gx) - ox) * ix),
                                fminf(((ify + gy) - oy) * iy, ((ifz + gz) - oz) * iz));
        if (tni < tfi)
          bits |= 1u << j;
        else
          undecided |= 1u << j;
      }
    }
    if (kCount) {
      cnt[0] += 1;
      cnt[2] += __popc(undecided);
      cnt[3] += __popc(bits);
    }
    while (undecided) {
      const int j = __ffs(undecided) - 1;
      undecided &= undecided - 1;
      bits |= (unsigned)exact_child_hit(r, j, ox, oy, oz, ix, iy, iz, tb) << j;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool nonempty = (word_of(j < 4 ? e0 : e1, j & 3) >> 28) != kKindEmpty;
      bits |= (unsigned)(nonempty && exact_child_hit(r, j, ry.ox, ry.oy, ry.oz, ry.ix, ry.iy,
                                                     ry.iz, tb)) << j;
    }
    if (kCount) {
      cnt[1] += 1;
      cnt[7] = 1;
    }
  }
  cur = kPop;
  if (bits) {
    const int first = __ffs(bits) - 1;
    unsigned rest = bits & (bits - 1);
    while (rest) {
      const int j = 31 - __clz(rest);
      rest ^= 1u << j;
      if (sp < sc.stack_size)
        stack[sp++] = child_entry(e0, e1, mi, j, ry.inst1);
      else
        ovf = true;
    }
    cur = child_entry(e0, e1, mi, first, ry.inst1);
  }
}

// A leaf visit of its live slots (16-byte loads: component c's slots 0-3 are
// float4 2c, slots 4-7 float4 2c + 1); any hit sets found, closest updates
// (tb, best).
template <bool kAnyHit, bool kCount>
__device__ __forceinline__ void quant_leaf(const Scene& sc, const Ray& ry, int payload, int live,
                                           float& tb, int& best, bool& found, unsigned* cnt) {
  const float4* r4 = reinterpret_cast<const float4*>(sc.table + 72ll * (sc.node_rows + payload));
  float tmin = INFINITY;
  int jmin = 0;
  if (kCount) {
    cnt[4] += 1;
    cnt[5] += live > 4;
    cnt[6] += live;
  }
#pragma unroll 1
  for (int half = 0; half < 2 && 4 * half < live; ++half) {
    float4 v[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) v[c] = __ldg(r4 + 2 * c + half);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * half + k < live)
        tri_test<kAnyHit>(comp(v[0], k), comp(v[1], k), comp(v[2], k), comp(v[3], k),
                          comp(v[4], k), comp(v[5], k), comp(v[6], k), comp(v[7], k),
                          comp(v[8], k), ry.ox, ry.oy, ry.oz, ry.dx, ry.dy, ry.dz, tb,
                          4 * half + k, found, tmin, jmin);
    }
  }
  if (!kAnyHit && tmin < tb) {
    tb = tmin;
    best = ((payload * 8 + jmin) << 8) | ry.inst1;
  }
}


template <bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kBlock, 8) quant_kernel(
    Scene sc, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const uint8_t* __restrict__ active, int n,
    float* __restrict__ t_out, int* __restrict__ best_out, int* __restrict__ steps_out,
    uint8_t* __restrict__ found_out, int* __restrict__ incomplete) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tb = t_max[i];
  int best = -1, steps = 0, sp = 0;
  bool found = false, ovf = false;
  unsigned cnt[kStats] = {};
  int stack[kMaxStack];
  Ray ry;
  ry.inst1 = -1;
  int cur = active[i] ? ((kKindInternal << kPayloadBits | sc.root) << 8) : kPop;
  bool done = !active[i];
  // entries carry a leaf's live slots in bits 29-31; kind 7 (empty) is never
  // pushed, so bit 28 tells a leaf from a node
  for (int it = 0; !done; ++it) {
    if (it == kMaxIterations) {
      ovf = true;
      break;
    }
    if (cur == kPop) {
      if (sp == 0) break;
      cur = stack[--sp];
    }
    const int inst1 = cur & 255;
    if (inst1 != ry.inst1) {
      enter(ry, sc, inst1, o, d, i);
      if (kCount) cnt[8] += 1;
    }
    const int payload = (cur >> 8) & kPayloadMask;
    if ((cur >> (kPayloadBits + 8)) & 1) {
      quant_leaf<kAnyHit, kCount>(sc, ry, payload, (int)((unsigned)cur >> 29) + 1, tb, best,
                                  found, cnt);
      if (kAnyHit && found) break;
      cur = kPop;
    } else {
      ++steps;
      quant_node<kCount>(sc, ry, payload, tb, cur, stack, sp, ovf, cnt);
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
  if constexpr (kCount) {
    const unsigned mask = __activemask();
    const int leader = __ffs(mask) - 1;
#pragma unroll
    for (int k = 0; k < kStats; ++k) {
      const unsigned s = __reduce_add_sync(mask, cnt[k]);
      if ((int)(threadIdx.x & 31) == leader) atomicAdd(sc.stats + k, (unsigned long long)s);
    }
  }
}

template <bool kCount>
void launch(bool any_hit, const Scene& sc, const float* o, const float* d, const float* t_max,
            const uint8_t* active, int n, float* t_out, int* best_out, int* steps_out,
            uint8_t* found_out, int* incomplete, cudaStream_t s) {
  const unsigned grid = rt::grid_for(n, kBlock);
  if (any_hit)
    quant_kernel<true, kCount><<<grid, kBlock, 0, s>>>(sc, o, d, t_max, active, n, nullptr,
                                                       nullptr, nullptr, found_out, incomplete);
  else
    quant_kernel<false, kCount><<<grid, kBlock, 0, s>>>(sc, o, d, t_max, active, n, t_out,
                                                        best_out, steps_out, nullptr, incomplete);
}

}  // namespace

// o, d: [n,3] f32 world rays; t_max: [n] f32; active: [n] bool; qrec:
// [node_rows, 32] int32, 16-byte aligned.  count: 0 the renderer's walk, 1 the
// same walk adding its counters to stats [9] u64 (which the caller zeroes).
// Closest: writes t_out [n] f32, best_out [n] i32 (tri << 8 | inst1, -1 = miss),
// steps_out [n] i32.  Any: writes found_out [n] bool.  Both add the lanes they
// could not finish (stack overflow) to *incomplete, which the caller zeroes.
extern "C" int rt_trace(int any_hit, int count, const void* table, const void* qrec,
                        int node_rows, int root, const void* inst_mat, int stack_size,
                        int ordered, const void* o, const void* d, const void* t_max,
                        const void* active, int n, void* t_out, void* best_out,
                        void* steps_out, void* found_out, void* incomplete, void* stats,
                        void* stream) {
  if (stack_size < 1 || stack_size > kMaxStack) return (int)cudaErrorInvalidValue;
  if (qrec == nullptr || ((uintptr_t)qrec & 15)) return (int)cudaErrorInvalidValue;
  if (count != 0 && (count != 1 || stats == nullptr)) return (int)cudaErrorInvalidValue;
  Scene sc{(const float*)table, (const int4*)qrec, (const float*)inst_mat,
           (unsigned long long*)stats, node_rows, node_rows / 8, root, stack_size, ordered};
  auto launcher = count ? launch<true> : launch<false>;
  launcher(any_hit != 0, sc, (const float*)o, (const float*)d, (const float*)t_max,
           (const uint8_t*)active, n, (float*)t_out, (int*)best_out, (int*)steps_out,
           (uint8_t*)found_out, (int*)incomplete, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
