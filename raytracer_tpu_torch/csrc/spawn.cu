// The children of a generation on the no-grad path: its reflection and
// refraction rays, compacted into the next generation's queue, in two launches
// around K6.
//
// Replaces no TPU kernel: on the TPU, XLA fused this elementwise glue of
// raytracer_tpu/render/renderer.py:_spawn and _compact into its program.  In
// PyTorch each step of it is one launch over every lane, ~160 a spawning
// generation besides 10 cats and 10 gathers, issued by the host, which set the
// pace of a frame.  The plain versions are
// raytracer_tpu_torch/render/renderer.py:_spawn and _compact, which the CPU and
// a render under autograd run; this file does the same float32 operations in
// the same order, built with --fmad=false, so that every value it writes
// equals theirs on the card bit for bit (sqrtf and IEEE division as torch's
// CUDA kernels take them).
//
// rt_spawn_flags, one thread a parent lane, after the lights' sum: the
// reflection flag (a hit with |refl_c|^2 > 0) at i and the refraction flag (a
// hit with |trans_c|^2 > 0 that is not totally reflected) at n + i of one [2n]
// array, the candidates' order that K6 compacts; and each block's count of
// either.
// rt_spawn_write, one thread a slot of the next queue, after K6: slot j takes
// candidate c = sel[j], the child of kind c >= n of parent lane c mod n, and
// computes it from the parent's state: the direction (reflect or refract),
// Schlick's Fresnel term and the throughput, Igehy's direction differentials,
// Beer's absorption inside a dielectric; it copies the hit point, its
// differentials and the pixel.  Block 0 also adds the flags' block counts to
// the frame's reflection and refraction counts.
//
// Bound on the H100: bytes.  The flags read ~55 B a lane (hit, both material
// rows, and on a refracting lane its direction, normal and ior) and write 2;
// a child reads ~156 B of its parent's state (its index, direction, normal,
// ior, both material rows, throughput, the ray's and the hit's differentials,
// point and pixel) and writes 101 B (eight float3 fields, the pixel and the
// flag) for ~60-110 float32 operations.  Config3's generation 0 at 1080p
// (2,073,600 lanes): ~0.12 GB for the flags, ~0.04 ms at 3.35 TB/s, and
// ~260 B a child.  What the design does about it: no candidate is written.
// The glue writes ten [2n] candidate fields (~200 B a lane) and reads them
// back to gather the queue; here a lane writes 2 B of flags, and a child is
// computed where it is stored, once, from its parent's rows.  The next queue
// is one allocation whose eight [n, 3] fields are contiguous slabs, each
// 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// the parent lanes' state, in the order ops/spawn.py passes it (PARENT_FIELDS)
enum Parent {
  kHit, kReflC, kTransC, kIor, kDirection, kNormal,  // what the flags read
  kW, kDDdx, kDDdy, kDNdx, kDNdy,                    // and the children besides
  kPoint, kDOdx, kDOdy, kPixel,                      // copied to the children
  kNumParent
};

struct ParentArgs {
  const void* p[kNumParent];
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const void* base, long long i) {
  const float* p = (const float*)base + 3 * i;
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(float* base, long long i, V3 v) {
  float* p = base + 3 * i;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

// vm.dot: the component products summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// a float3 plus a scalar, as torch broadcasts v + s[:, None]
__device__ __forceinline__ V3 add(float s, V3 a) { return {s + a.x, s + a.y, s + a.z}; }

// Snell's law at a hit (Raytracer.cpp:275-300), _spawn's names: the ray
// enters where it meets the normal's front, and k < 0 is total internal
// reflection
struct Snell {
  float dot_dn;
  bool entering;
  float n1, n2, cos_theta, eta, k;
};

__device__ __forceinline__ Snell snell(V3 d, V3 nrm, float ior) {
  Snell s;
  s.dot_dn = dot(d, nrm);
  s.entering = s.dot_dn < 0.0f;
  s.n1 = s.entering ? 1.0f : ior;  // AIR_IOR
  s.n2 = s.entering ? ior : 1.0f;
  s.cos_theta = s.entering ? -s.dot_dn : s.dot_dn;
  s.eta = s.n1 / s.n2;
  s.k = 1.0f - s.eta * s.eta * (1.0f - s.cos_theta * s.cos_theta);
  return s;
}

// vm.safe_sqrt
__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// vm.refract(d, n_oriented, eta, cos_theta, k)
__device__ __forceinline__ V3 refract(V3 d, V3 n_oriented, const Snell& s) {
  return s.eta * d + (s.eta * s.cos_theta - safe_sqrt(s.k)) * n_oriented;
}

// Schlick's reflectance (Raytracer.cpp:378-391) given the refracted direction
__device__ __forceinline__ float schlick(const Snell& s, V3 refr_dir, V3 n_oriented) {
  float r0 = (s.n1 - s.n2) / (s.n1 + s.n2);
  r0 = r0 * r0;
  const float cos_f = s.n1 > s.n2 ? -dot(refr_dir, n_oriented) : s.cos_theta;
  const float omc = 1.0f - cos_f;
  const float omc2 = omc * omc;
  return r0 + ((1.0f - r0) * omc2) * (omc2 * omc);
}

// The sums over the block of each thread's a and b, by thread 0 (every thread
// calls it)
__device__ __forceinline__ int2 block_sum2(int a, int b) {
  __shared__ int2 warp_sums[kWarps];
  a = __reduce_add_sync(kFullWarp, a);
  b = __reduce_add_sync(kFullWarp, b);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 total = make_int2(0, 0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) {
      total.x += warp_sums[w].x;
      total.y += warp_sums[w].y;
    }
  return total;
}

__global__ void __launch_bounds__(kBlock)
flags_kernel(ParentArgs a, int n, bool* __restrict__ flags, int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  int refl = 0, refr = 0;
  if (i < n) {
    const bool hit = ((const bool*)a.p[kHit])[i];
    const V3 refl_c = load3(a.p[kReflC], i);
    const V3 trans_c = load3(a.p[kTransC], i);
    refl = hit && dot(refl_c, refl_c) > 0.0f;
    if (hit && dot(trans_c, trans_c) > 0.0f) {
      const Snell s = snell(load3(a.p[kDirection], i), load3(a.p[kNormal], i),
                            ((const float*)a.p[kIor])[i]);
      refr = !(s.k < 0.0f);
    }
    flags[i] = refl;
    flags[n + i] = refr;
  }
  const int2 total = block_sum2(refl, refr);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = total.x;
    counts[gridDim.x + blockIdx.x] = total.y;
  }
}

struct QueueArgs {
  // [8][stride] floats: origin, direction, dO_dx, dO_dy, dD_dx, dD_dy, weight, sigma
  float* fields;
  long long stride;
  int* pixel;
  bool* active;
  const int* counts;  // the flags launch's: n_counts reflection counts, then as many refraction
  const int* num_reflection_in;
  const int* num_refraction_in;
  int* num_reflection_out;
  int* num_refraction_out;
};

__global__ void __launch_bounds__(kBlock)
write_kernel(ParentArgs a, int n, const int* __restrict__ sel, int n_active, QueueArgs q,
             int n_counts) {
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j < n_active) {
    const int c = sel[j];
    const bool refracted = c >= n;
    const long long p = refracted ? c - n : c;
    const V3 d = load3(a.p[kDirection], p);
    const V3 nrm = load3(a.p[kNormal], p);
    const V3 trans_c = load3(a.p[kTransC], p);
    const V3 w = load3(a.p[kW], p);
    const V3 dD_dx = load3(a.p[kDDdx], p);
    const V3 dD_dy = load3(a.p[kDDdy], p);
    const V3 dN_dx = load3(a.p[kDNdx], p);
    const V3 dN_dy = load3(a.p[kDNdy], p);
    const Snell s = snell(d, nrm, ((const float*)a.p[kIor])[p]);
    const V3 n_oriented = s.entering ? nrm : -nrm;
    const float ddn_dx = dot(dD_dx, nrm) + dot(d, dN_dx);
    const float ddn_dy = dot(dD_dy, nrm) + dot(d, dN_dy);
    V3 direction, weight, out_dx, out_dy, sigma;
    if (!refracted) {
      // a refracting parent shares its light with the reflection by Fresnel's
      // term, all of it on total internal reflection (the lane is hit)
      float share = 0.0f;
      if (dot(trans_c, trans_c) > 0.0f)
        share = s.k < 0.0f ? 1.0f : schlick(s, refract(d, n_oriented, s), n_oriented);
      direction = d - (2.0f * s.dot_dn) * nrm;  // vm.reflect
      const float scale = 1.0f + share;
      weight = w * (scale * load3(a.p[kReflC], p));
      // Igehy reflection differentials (Raytracer.cpp:254-262)
      out_dx = dD_dx - 2.0f * (s.dot_dn * dN_dx + ddn_dx * nrm);
      out_dy = dD_dy - 2.0f * (s.dot_dn * dN_dy + ddn_dy * nrm);
      sigma = {0.0f, 0.0f, 0.0f};
    } else {
      direction = refract(d, n_oriented, s);
      const float f_t = 1.0f - schlick(s, direction, n_oriented);
      weight = f_t * w;
      // Igehy refraction differentials (Raytracer.cpp:325-342)
      const float d_dot_n = -s.cos_theta;
      const float dprime_dot_n = -safe_sqrt(s.k);
      const float mu = -(s.eta * s.cos_theta + dprime_dot_n);
      const float mu_d = mu * d_dot_n;
      out_dx = s.eta * dD_dx - ddn_dx * add(mu_d, dot(dN_dx, nrm) * nrm);
      out_dy = s.eta * dD_dy - ddn_dy * add(mu_d, dot(dN_dy, nrm) * nrm);
      sigma = s.entering ? add(-1.0f, trans_c) : V3{0.0f, 0.0f, 0.0f};
    }
    store3(q.fields, j, load3(a.p[kPoint], p));
    store3(q.fields + q.stride, j, direction);
    store3(q.fields + 2 * q.stride, j, load3(a.p[kDOdx], p));
    store3(q.fields + 3 * q.stride, j, load3(a.p[kDOdy], p));
    store3(q.fields + 4 * q.stride, j, out_dx);
    store3(q.fields + 5 * q.stride, j, out_dy);
    store3(q.fields + 6 * q.stride, j, weight);
    store3(q.fields + 7 * q.stride, j, sigma);
    q.pixel[j] = ((const int*)a.p[kPixel])[p];
    q.active[j] = true;
  }
  if (blockIdx.x != 0) return;  // uniform over the block
  int refl = 0, refr = 0;
  for (int k = threadIdx.x; k < n_counts; k += kBlock) {
    refl += q.counts[k];
    refr += q.counts[n_counts + k];
  }
  const int2 total = block_sum2(refl, refr);
  if (threadIdx.x == 0) {
    *q.num_reflection_out = *q.num_reflection_in + total.x;
    *q.num_refraction_out = *q.num_refraction_in + total.y;
  }
}

}  // namespace

// ptrs: the kNumParent parent fields, [n] or [n, 3], contiguous; flags: [2n]
// bool; counts: [2 * ceil(n / 256)] int32.  n >= 1.
extern "C" int rt_spawn_flags(const void* const* ptrs, int n, void* flags, void* counts,
                              void* stream) {
  ParentArgs a;
  for (int k = 0; k < kNumParent; ++k) a.p[k] = ptrs[k];
  flags_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      a, n, (bool*)flags, (int*)counts);
  return (int)cudaGetLastError();
}

// ptrs: as rt_spawn_flags's; sel: [n_active] int32, K6's indices into the
// flags; fields: [8][stride] float32, each field [n_active, 3] at the start of
// its slab; pixel: [n_active] int32; active: [n_active] bool; counts: the
// flags launch's (n_counts = its blocks, 0 when n is 0); the two counts in,
// 0-dim int32, and the two out.  Any n_active >= 0: block 0 always runs.
extern "C" int rt_spawn_write(const void* const* ptrs, int n, const void* sel, int n_active,
                              void* fields, long long stride, void* pixel, void* active,
                              const void* counts, int n_counts, const void* num_reflection_in,
                              const void* num_refraction_in, void* num_reflection_out,
                              void* num_refraction_out, void* stream) {
  ParentArgs a;
  for (int k = 0; k < kNumParent; ++k) a.p[k] = ptrs[k];
  const QueueArgs q{(float*)fields, stride, (int*)pixel, (bool*)active, (const int*)counts,
                    (const int*)num_reflection_in, (const int*)num_refraction_in,
                    (int*)num_reflection_out, (int*)num_refraction_out};
  const unsigned grid = n_active > 0 ? rt::grid_for(n_active, kBlock) : 1u;
  write_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a, n, (const int*)sel, n_active, q,
                                                          n_counts);
  return (int)cudaGetLastError();
}
