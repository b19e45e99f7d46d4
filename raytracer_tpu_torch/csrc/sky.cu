// K5: sky radiance on misses, Debevec angular-map light probe, and its gradient.
//
// Replaces raytracer_tpu/ops/sky_sample.py:sample_sky (JAX) and the VJP JAX
// derives for it; the plain PyTorch versions are
// raytracer_tpu_torch/ops/sky_sample.py:sample_sky_plain and its autograd.
//
// Bound on the H100: bytes.  Per lane it reads one direction (12 B) and one probe
// texel (12 B, a gather from a 256x256 probe that lives in L2) and writes 12 B,
// against ~30 float operations; the acos is the only transcendental.
//
// This first version is one thread per lane, right and simple: the direction
// is read as three scalar loads and the texel gather goes through L1/L2.
// Vectorised 16-byte loads and a fused shading pass are for later PRs.
//
// Backward (sky_bwd_kernel): the forward gathers texel `index` and scales it by
// 1/pi, so the gradient of sky_data is the cotangent / pi scattered to `index`
// (three atomicAdds per lane), and the direction gets none (floor to a texel).
// When a gradient is needed the forward also writes `index` [N] int32.  Bound:
// bytes (16 B in and 3 atomic read-modify-writes of 8 B per lane, and the
// zero fill of the [S*S,3] gradient).  fp32 atomics make the order of the sums
// change from run to run.
#include "common.cuh"

namespace {

constexpr double kPi = 3.14159265358979323846;

__global__ void sky_kernel(const float* __restrict__ dir, int n,
                           const float* __restrict__ sky, int size,
                           float* __restrict__ out, int* __restrict__ index_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = dir[3 * i + 0], y = dir[3 * i + 1], z = dir[3 * i + 2];
  // vm.safe_sqrt(x*x + y*y)
  float d2 = x * x + y * y;
  float denom = d2 > 0.0f ? sqrtf(d2) : 0.0f;
  // vm.safe_arccos: clip to +-(1 - 1e-6), constants rounded from double
  const float lo = (float)(-1.0 + 1e-6), hi = (float)(1.0 - 1e-6);
  float zc = fminf(fmaxf(z, lo), hi);
  const float half_over_pi = (float)(0.5 * (1.0 / kPi));
  float r = half_over_pi * acosf(zc) / rt::nan_max(denom, 1e-12f);
  float size_f = (float)size;
  float u = x * r + 0.5f;
  float v = y * r + 0.5f;
  int px = (int)floorf(u * size_f + 0.5f);
  int py = (int)floorf(v * size_f + 0.5f);
  int index = py * size + px;
  index = min(max(index, 0), size * size - 1);
  const float one_over_pi = (float)(1.0 / kPi);
  out[3 * i + 0] = one_over_pi * sky[3 * index + 0];
  out[3 * i + 1] = one_over_pi * sky[3 * index + 1];
  out[3 * i + 2] = one_over_pi * sky[3 * index + 2];
  if (index_out != nullptr) index_out[i] = index;
}

__global__ void sky_bwd_kernel(const int* __restrict__ index, const float* __restrict__ cot,
                               int n, float* __restrict__ grad_sky) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float one_over_pi = (float)(1.0 / kPi);
  float* g = grad_sky + 3ll * index[i];
  atomicAdd(g + 0, cot[3 * i + 0] * one_over_pi);
  atomicAdd(g + 1, cot[3 * i + 1] * one_over_pi);
  atomicAdd(g + 2, cot[3 * i + 2] * one_over_pi);
}

}  // namespace

// index may be null: it is written only when a gradient is needed.
extern "C" int rt_sky_sample(const void* dir, int n, const void* sky, int size, void* out,
                             void* index, void* stream) {
  constexpr int kBlock = 256;
  sky_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)dir, n, (const float*)sky, size, (float*)out, (int*)index);
  return (int)cudaGetLastError();
}

// grad_sky [S*S,3] must be zeroed by the caller.
extern "C" int rt_sky_sample_bwd(const void* index, const void* cot, int n, void* grad_sky,
                                 void* stream) {
  constexpr int kBlock = 256;
  sky_bwd_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)index, (const float*)cot, n, (float*)grad_sky);
  return (int)cudaGetLastError();
}
