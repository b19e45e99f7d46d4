// K7: hit reconstruction from the traversal's ids, forward and backward.
//
// Replaces raytracer_tpu/render/renderer.py:_mesh_hits_into (JAX, :124-241),
// whose XLA loop re-derives (t, u, v) by Moller-Trumbore from the identified
// triangle, evaluates the point, normal, uv, material and the Ray Tracing Gems
// ch.20 differentials, and merges them into the prior hit record.  The plain
// PyTorch version is raytracer_tpu_torch/ops/hits.py:mesh_hits_plain; the
// per-lane arithmetic of both directions is in hits.cuh.
//
// Forward (rt_hits_fwd): one thread per lane.  A lane with tri < 0 writes the
// prior record through unchanged (K9's sphere / plane record, or the miss
// record), so the sixteen torch.where merges are part of the kernel;
// bvh_steps += steps.  Built with --fmad=false, rsqrtf as torch's CUDA rsqrt:
// the record equals the plain version's on the card.
//
// Backward (rt_hits_bwd): one thread per lane recomputes the forward from the
// saved inputs (as K4 recomputes K3) and runs the chain rule by hand.  Per lane,
// without atomics: the six ray fields' cotangents (0 on lanes with tri < 0),
// and the prior record's (the output's cotangent on those lanes, 0 on the
// others).  Only where asked for: the nine triangle tables' rows, by float64
// atomics into float64 copies of the tables (rounded once to float32 by the
// caller, so the sum's order moves no float32 result by more than a rounding),
// and the instance matrices, summed in float64 per block in shared memory (a
// warp whose lanes share an instance first sums by shuffles) and added once per
// block into a float64 [I,24] sum: config3's 3 instances take 2M lanes each,
// more than a float32 sum holds to 1e-5.
//
// Bound on the H100: bytes.  The forward reads ~0.3 KB a lane (ray fields,
// prior record, gathered geometry rows) and writes 109 B for ~400 float32
// operations; the backward reads ~0.25 KB and writes up to 0.2 KB for ~1,000.
// This first version is one thread per lane with 32-bit loads.
#include "common.cuh"
#include "hits.cuh"

namespace {

// pointer slots, in the order ops/hits.py passes them
enum In {
  kTri, kInst, kSteps,
  kOrigin, kDirection, kRayDOx, kRayDOy, kRayDDx, kRayDDy,
  kP0, kE1, kE2, kN0, kNe1, kNe2, kT0, kTe1, kTe2, kMaterial,
  kInv, kWorld,
  kNumIn
};
// the record's fields (prior, output, and their cotangents), ops/hits.py RECORD
enum Rec {
  kHit, kT, kPoint, kNormal, kMatId, kU, kV, kDsDx, kDsDy, kDtDx, kDtDy,
  kDOx, kDOy, kDNx, kDNy, kBvhSteps,
  kNumRec
};
// its float fields: scalars per lane, and 3-vectors
__device__ const int kScalarFields[7] = {kT, kU, kV, kDsDx, kDsDy, kDtDx, kDtDy};
__device__ const int kVectorFields[6] = {kPoint, kNormal, kDOx, kDOy, kDNx, kDNy};

struct FwdArgs {
  const void* in[kNumIn];
  const void* prior[kNumRec];
  void* out[kNumRec];
};

struct BwdArgs {
  const void* in[kNumIn];
  const float* cot[kNumRec];    // the float fields' cotangents (others unused)
  float* g_rays[6];             // origin .. dD_dy, or null
  float* g_prior[kNumRec];      // the float fields, or null
  double* g_geom[9];            // tr_p0 .. tr_te2 in float64, or null
  double* g_inst;               // [I,24] inst_inv | inst_world, or null
};

__device__ __forceinline__ k7::V3 ld3(const void* p, long long i) {
  const float* f = (const float*)p + 3 * i;
  return k7::v3(f[0], f[1], f[2]);
}

__device__ __forceinline__ void st3(void* p, long long i, k7::V3 v) {
  float* f = (float*)p + 3 * i;
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
}

__device__ __forceinline__ void load_lane(const void* const* in, int i, int ti, k7::Rays& R,
                                          k7::Geom& G) {
  R.o = ld3(in[kOrigin], i);
  R.d = ld3(in[kDirection], i);
  R.ox = ld3(in[kRayDOx], i);
  R.oy = ld3(in[kRayDOy], i);
  R.dx = ld3(in[kRayDDx], i);
  R.dy = ld3(in[kRayDDy], i);
  G.p0 = ld3(in[kP0], ti);
  G.e1 = ld3(in[kE1], ti);
  G.e2 = ld3(in[kE2], ti);
  G.n0 = ld3(in[kN0], ti);
  G.ne1 = ld3(in[kNe1], ti);
  G.ne2 = ld3(in[kNe2], ti);
  const float* t0 = (const float*)in[kT0] + 2ll * ti;
  const float* te1 = (const float*)in[kTe1] + 2ll * ti;
  const float* te2 = (const float*)in[kTe2] + 2ll * ti;
  G.t0[0] = t0[0];
  G.t0[1] = t0[1];
  G.te1[0] = te1[0];
  G.te1[1] = te1[1];
  G.te2[0] = te2[0];
  G.te2[1] = te2[1];
}

__global__ void hits_fwd_kernel(FwdArgs a, int n, int object_space) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tri = ((const int*)a.in[kTri])[i];
  const int steps = ((const int*)a.in[kSteps])[i];
  const float* const* pf = (const float* const*)a.prior;
  float* const* of = (float* const*)a.out;
  ((int*)a.out[kBvhSteps])[i] = ((const int*)a.prior[kBvhSteps])[i] + steps;
  if (tri < 0) {  // the prior record, unchanged
    ((uint8_t*)a.out[kHit])[i] = ((const uint8_t*)a.prior[kHit])[i];
    ((int*)a.out[kMatId])[i] = ((const int*)a.prior[kMatId])[i];
    for (int f : kScalarFields) of[f][i] = pf[f][i];
    for (int f : kVectorFields) st3(of[f], i, ld3(pf[f], i));
    return;
  }
  const int ii = max(((const int*)a.in[kInst])[i], 0);
  k7::Rays R;
  k7::Geom G;
  load_lane(a.in, i, tri, R, G);
  k7::Fwd F;
  k7::Out o;
  k7::forward((const float*)a.in[kInv] + 12 * ii, (const float*)a.in[kWorld] + 12 * ii, R, G,
              object_space != 0, F, o);
  ((uint8_t*)a.out[kHit])[i] = 1;
  ((int*)a.out[kMatId])[i] = ((const int*)a.in[kMaterial])[tri];
  of[kT][i] = o.t;
  of[kU][i] = o.u;
  of[kV][i] = o.v;
  of[kDsDx][i] = o.ds_dx;
  of[kDsDy][i] = o.ds_dy;
  of[kDtDx][i] = o.dt_dx;
  of[kDtDy][i] = o.dt_dy;
  st3(of[kPoint], i, o.point);
  st3(of[kNormal], i, o.normal);
  st3(of[kDOx], i, o.dP_dx);
  st3(of[kDOy], i, o.dP_dy);
  st3(of[kDNx], i, o.dN_dx);
  st3(of[kDNy], i, o.dN_dy);
}

__device__ __forceinline__ void atomic3(double* p, int row, k7::V3 v) {
  atomicAdd(p + 3 * row, (double)v.x);
  atomicAdd(p + 3 * row + 1, (double)v.y);
  atomicAdd(p + 3 * row + 2, (double)v.z);
}

// dynamic shared memory: n_inst x 24 doubles (inv | world) when the instance
// gradients are asked for (at most 254 x 24 x 8 = 48,768 bytes)
__global__ void hits_bwd_kernel(BwdArgs a, int n, int n_inst, int object_space) {
  extern __shared__ double inst_acc[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool need_inst = a.g_inst != nullptr;
  if (need_inst) {
    for (int k = threadIdx.x; k < n_inst * 24; k += blockDim.x) inst_acc[k] = 0.0;
    __syncthreads();
  }

  const bool lane = i < n;
  const int tri = lane ? ((const int*)a.in[kTri])[i] : -1;
  const bool valid = tri >= 0;
  const int ii = lane ? max(((const int*)a.in[kInst])[i], 0) : 0;

  // the prior record's cotangent: passes through where the lane kept it
  if (lane) {
    for (int f : kScalarFields) {
      if (a.g_prior[f]) a.g_prior[f][i] = valid ? 0.0f : a.cot[f][i];
    }
    for (int f : kVectorFields) {
      if (a.g_prior[f]) st3(a.g_prior[f], i, valid ? k7::v3(0.f, 0.f, 0.f) : ld3(a.cot[f], i));
    }
  }

  k7::Grads g = {};
  if (valid) {
    k7::Rays R;
    k7::Geom G;
    load_lane(a.in, i, tri, R, G);
    k7::Out c;
    c.t = a.cot[kT][i];
    c.u = a.cot[kU][i];
    c.v = a.cot[kV][i];
    c.ds_dx = a.cot[kDsDx][i];
    c.ds_dy = a.cot[kDsDy][i];
    c.dt_dx = a.cot[kDtDx][i];
    c.dt_dy = a.cot[kDtDy][i];
    c.point = ld3(a.cot[kPoint], i);
    c.normal = ld3(a.cot[kNormal], i);
    c.dP_dx = ld3(a.cot[kDOx], i);
    c.dP_dy = ld3(a.cot[kDOy], i);
    c.dN_dx = ld3(a.cot[kDNx], i);
    c.dN_dy = ld3(a.cot[kDNy], i);
    k7::backward((const float*)a.in[kInv] + 12 * ii, (const float*)a.in[kWorld] + 12 * ii, R,
                 G, object_space != 0, c, g);
  }
  if (lane) {
    const k7::V3 rg[6] = {g.rays.o, g.rays.d, g.rays.ox, g.rays.oy, g.rays.dx, g.rays.dy};
    for (int k = 0; k < 6; ++k) {
      if (a.g_rays[k]) st3(a.g_rays[k], i, rg[k]);
    }
  }
  if (valid) {
    const k7::V3 tg[6] = {g.geom.p0, g.geom.e1, g.geom.e2, g.geom.n0, g.geom.ne1, g.geom.ne2};
    for (int k = 0; k < 6; ++k) {
      if (a.g_geom[k]) atomic3(a.g_geom[k], tri, tg[k]);
    }
    const float* t2[3] = {g.geom.t0, g.geom.te1, g.geom.te2};
    for (int k = 0; k < 3; ++k) {
      if (a.g_geom[6 + k]) {
        atomicAdd(a.g_geom[6 + k] + 2 * tri, (double)t2[k][0]);
        atomicAdd(a.g_geom[6 + k] + 2 * tri + 1, (double)t2[k][1]);
      }
    }
  }
  if (!need_inst) return;  // uniform across the block

  // instance matrices: a warp whose contributing lanes share one instance sums
  // by shuffles; otherwise each lane adds into the block's shared rows
  const int key = valid ? ii : -1;
  const unsigned full = 0xffffffffu;
  const int lead = __ffs(__ballot_sync(full, key >= 0)) - 1;
  const int key_lead = __shfl_sync(full, key, lead < 0 ? 0 : lead);
  const bool same = lead >= 0 && __all_sync(full, key == key_lead || key < 0);
  for (int c = 0; c < 24; ++c) {
    double v = c < 12 ? g.inv[c] : g.world[c - 12];
    if (same) {
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(full, v, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(&inst_acc[key_lead * 24 + c], v);
    } else if (key >= 0) {
      atomicAdd(&inst_acc[key * 24 + c], v);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_inst * 24; k += blockDim.x) {
    if (inst_acc[k] != 0.0) atomicAdd(a.g_inst + k, inst_acc[k]);
  }
}

constexpr int kBlock = 128;

}  // namespace

// ptrs: the kNumIn inputs, the kNumRec prior fields, the kNumRec outputs
// (ops/hits.py's order).  The rays, tri/inst/steps and the prior record are
// per lane ([n,3] or [n]); the geometry tables are per triangle, the instance
// matrices [I,12].
extern "C" int rt_hits_fwd(const void* const* ptrs, int n, int object_space, void* stream) {
  FwdArgs a;
  for (int k = 0; k < kNumIn; ++k) a.in[k] = ptrs[k];
  for (int k = 0; k < kNumRec; ++k) a.prior[k] = ptrs[kNumIn + k];
  for (int k = 0; k < kNumRec; ++k) a.out[k] = const_cast<void*>(ptrs[kNumIn + kNumRec + k]);
  hits_fwd_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(a, n,
                                                                              object_space);
  return (int)cudaGetLastError();
}

// ptrs: the kNumIn inputs, the kNumRec cotangents (null for hit, material_id,
// bvh_steps), then the outputs, each null when not asked for: 6 ray fields,
// the kNumRec prior fields, 9 float64 triangle tables (zeroed by the caller),
// and one float64 [I,24] sum of inst_inv's and inst_world's gradients (zeroed by the
// caller).
extern "C" int rt_hits_bwd(const void* const* ptrs, int n, int n_inst, int object_space,
                           void* stream) {
  if (n_inst < 1 || n_inst > 254) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  int k = 0;
  for (int j = 0; j < kNumIn; ++j) a.in[j] = ptrs[k++];
  for (int j = 0; j < kNumRec; ++j) a.cot[j] = (const float*)ptrs[k++];
  for (int j = 0; j < 6; ++j) a.g_rays[j] = (float*)ptrs[k++];
  for (int j = 0; j < kNumRec; ++j) a.g_prior[j] = (float*)ptrs[k++];
  for (int j = 0; j < 9; ++j) a.g_geom[j] = (double*)ptrs[k++];
  a.g_inst = (double*)ptrs[k++];
  const size_t smem = a.g_inst ? sizeof(double) * 24 * n_inst : 0;
  hits_bwd_kernel<<<rt::grid_for(n, kBlock), kBlock, smem, (cudaStream_t)stream>>>(
      a, n, n_inst, object_space);
  return (int)cudaGetLastError();
}
