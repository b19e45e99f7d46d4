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
// Backward (rt_sky_sample_bwd): the forward gathers texel `index` and scales it by
// 1/pi, so the gradient of sky_data is the cotangent / pi scattered to `index`,
// and the direction gets none (floor to a texel).  When a gradient is needed the
// forward also writes `index` [N] int32.  Bound: bytes (12 B of cotangent a
// lane, the index of the lanes that scatter, and the [S*S,3] gradient).
//
// The scatter is rt::scatter3_kernel (scatter.cuh), with a scale of 1/pi,
// into float64 rows that the wrapper rounds to float32 once: a texel that all
// of a 2 M-lane launch names takes ~65 k atomic adds, and their float32 sum
// was ~1e-5 off the exact one.
#include "common.cuh"
#include "scatter.cuh"

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

}  // namespace

// index may be null: it is written only when a gradient is needed.
extern "C" int rt_sky_sample(const void* dir, int n, const void* sky, int size, void* out,
                             void* index, void* stream) {
  constexpr int kBlock = 256;
  sky_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)dir, n, (const float*)sky, size, (float*)out, (int*)index);
  return (int)cudaGetLastError();
}

// grad_sky [S*S,3] float64 must be zeroed by the caller.
extern "C" int rt_sky_sample_bwd(const void* index, const void* cot, int n, void* grad_sky,
                                 void* stream) {
  rt::scatter3_kernel<double><<<rt::grid_for(n, rt::kScatterBlock), rt::kScatterBlock, 0,
                                (cudaStream_t)stream>>>((const int*)index, (const float*)cot,
                                                        n, (float)(1.0 / kPi),
                                                        (double*)grad_sky);
  return (int)cudaGetLastError();
}
