// K9: closest and any hit of the analytic primitives (spheres, then planes).
//
// Replaces raytracer_tpu/ops/intersect.py:sphere_trace, plane_trace,
// sphere_intersect and plane_intersect as renderer.py chains them
// (trace_scene, intersect_scene); the plain PyTorch versions are
// raytracer_tpu_torch/ops/intersect.py:pick_closest_plain and pick_any_plain.
//
// The kernels make only the discrete decisions: the closest hit writes each
// lane's winner (-1 none, 0..S-1 sphere, S..S+P-1 plane) and its t; the any hit
// writes whether an active lane is blocked.  The hit record is re-derived from
// the winner in torch (primitive_hits), which carries the gradients.
//   - spheres first, then planes, in scene order; a later primitive wins only
//     at a strictly smaller t;
//   - sphere t = t0 > EPS ? t0 : t1 from the quadratic, counted when the
//     discriminant is >= 0 and EPS < t;
//   - plane t = -(o.n + dist) / nonzero(d.n), nonzero(0) = +1e-20;
//   - the any hit uses the geometric sphere test of Sphere.cpp:92-112.
// Built with --fmad=false: each t is the plain version's sequence of float32
// operations (sqrtf and the divisions are IEEE-rounded), so winners and t are
// bit-identical to it, and t equals the re-derived t handed to K1 as t_max.
//
// Bound on the H100: bytes.  Per lane 24 B of ray in (29 B for the any hit)
// and 8 B out (1 B), against ~30 float operations per sphere and ~12 per plane;
// the scenes have S + P <= 3.  The primitives are staged once per block in
// shared memory.  One thread per lane, right and simple.
#include "common.cuh"

namespace {

constexpr float kRayEpsilon = 0.005f;
const float kTiny = (float)1e-20;

__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// intersect._nonzero: |x| < tiny goes to +-tiny, 0 to +tiny
__device__ __forceinline__ float nonzero(float x) {
  return fabsf(x) < kTiny ? (x < 0.0f ? -kTiny : kTiny) : x;
}

// shared layout: S spheres (cx, cy, cz, r), then P planes (nx, ny, nz, dist)
__device__ void stage(const float* sph_c, const float* sph_r, int S, const float* pln_n,
                      const float* pln_d, int P, float* sm) {
  for (int k = threadIdx.x; k < S + P; k += blockDim.x) {
    const float* v = k < S ? sph_c + 3 * k : pln_n + 3 * (k - S);
    sm[4 * k + 0] = v[0];
    sm[4 * k + 1] = v[1];
    sm[4 * k + 2] = v[2];
    sm[4 * k + 3] = k < S ? sph_r[k] : pln_d[k - S];
  }
  __syncthreads();
}

__device__ __forceinline__ float plane_t(const float* pl, float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  float num = (ox * pl[0] + oy * pl[1] + oz * pl[2]) + pl[3];
  float den = nonzero(dx * pl[0] + dy * pl[1] + dz * pl[2]);
  return -num / den;
}

__global__ void prim_closest_kernel(const float* __restrict__ sph_c,
                                    const float* __restrict__ sph_r, int S,
                                    const float* __restrict__ pln_n,
                                    const float* __restrict__ pln_d, int P,
                                    const float* __restrict__ o, const float* __restrict__ d,
                                    int n, int* __restrict__ winner, float* __restrict__ t_out) {
  extern __shared__ float sm[];
  stage(sph_c, sph_r, S, pln_n, pln_d, P, sm);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float best = INFINITY;
  int win = -1;
  float a = dx * dx + dy * dy + dz * dz;
  float inv_denom = -1.0f / (2.0f * a);
  for (int k = 0; k < S; ++k) {
    const float* sp = sm + 4 * k;
    float r2 = sp[3] * sp[3];
    float ocx = ox - sp[0], ocy = oy - sp[1], ocz = oz - sp[2];
    float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
    float c = (ocx * ocx + ocy * ocy + ocz * ocz) - r2;
    float disc = b * b - 4.0f * a * c;
    float sq = safe_sqrt(disc);
    float t0 = (b + sq) * inv_denom;
    float t1 = (b - sq) * inv_denom;
    float t = t0 > kRayEpsilon ? t0 : t1;
    if (disc >= 0.0f && t > kRayEpsilon && t < best) {
      best = t;
      win = k;
    }
  }
  for (int k = S; k < S + P; ++k) {
    float t = plane_t(sm + 4 * k, ox, oy, oz, dx, dy, dz);
    if (t > kRayEpsilon && t < best) {
      best = t;
      win = k;
    }
  }
  winner[i] = win;
  t_out[i] = best;
}

__global__ void prim_any_kernel(const float* __restrict__ sph_c,
                                const float* __restrict__ sph_r, int S,
                                const float* __restrict__ pln_n,
                                const float* __restrict__ pln_d, int P,
                                const float* __restrict__ o, const float* __restrict__ d,
                                const float* __restrict__ t_max,
                                const uint8_t* __restrict__ active, int n,
                                uint8_t* __restrict__ blocked) {
  extern __shared__ float sm[];
  stage(sph_c, sph_r, S, pln_n, pln_d, P, sm);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool hit = false;
  if (active[i]) {
    float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    float tm = t_max[i];
    for (int k = 0; k < S && !hit; ++k) {
      const float* sp = sm + 4 * k;
      float cx = sp[0] - ox, cy = sp[1] - oy, cz = sp[2] - oz;
      float t = cx * dx + cy * dy + cz * dz;
      float qx = cx - t * dx, qy = cy - t * dy, qz = cz - t * dz;
      float p2 = qx * qx + qy * qy + qz * qz;
      float rs = sp[3] * sp[3];
      t = t - safe_sqrt(rs - p2);
      hit = p2 < rs && t > kRayEpsilon && t < tm;
    }
    for (int k = S; k < S + P && !hit; ++k) {
      float t = plane_t(sm + 4 * k, ox, oy, oz, dx, dy, dz);
      hit = t > kRayEpsilon && t < tm;
    }
  }
  blocked[i] = hit;
}

}  // namespace

// sph_c [S,3], sph_r [S], pln_n [P,3], pln_d [P]; o, d [n,3] f32.
// Writes winner [n] i32 and t [n] f32 (inf where no primitive is hit).
extern "C" int rt_prim_closest(const void* sph_c, const void* sph_r, int S, const void* pln_n,
                               const void* pln_d, int P, const void* o, const void* d, int n,
                               void* winner, void* t, void* stream) {
  constexpr int kBlock = 256;
  size_t shared = (size_t)(S + P) * 4 * sizeof(float);
  prim_closest_kernel<<<rt::grid_for(n, kBlock), kBlock, shared, (cudaStream_t)stream>>>(
      (const float*)sph_c, (const float*)sph_r, S, (const float*)pln_n, (const float*)pln_d,
      P, (const float*)o, (const float*)d, n, (int*)winner, (float*)t);
  return (int)cudaGetLastError();
}

// As above, plus t_max [n] f32 and active [n] bool; writes blocked [n] bool
// (false on inactive lanes).
extern "C" int rt_prim_any(const void* sph_c, const void* sph_r, int S, const void* pln_n,
                           const void* pln_d, int P, const void* o, const void* d,
                           const void* t_max, const void* active, int n, void* blocked,
                           void* stream) {
  constexpr int kBlock = 256;
  size_t shared = (size_t)(S + P) * 4 * sizeof(float);
  prim_any_kernel<<<rt::grid_for(n, kBlock), kBlock, shared, (cudaStream_t)stream>>>(
      (const float*)sph_c, (const float*)sph_r, S, (const float*)pln_n, (const float*)pln_d,
      P, (const float*)o, (const float*)d, (const float*)t_max, (const uint8_t*)active, n,
      (uint8_t*)blocked);
  return (int)cudaGetLastError();
}
