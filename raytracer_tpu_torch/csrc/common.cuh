// Helpers shared by the kernels of raytracer_tpu_torch/csrc.
//
// Every kernel here is built with --fmad=false so that its float32 arithmetic is
// the same sequence of IEEE operations as its plain PyTorch version (each
// multiply and add rounded on its own), and so bit-comparable with it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

// jnp.minimum / jnp.maximum / torch.minimum propagate NaN; fminf / fmaxf return the
// other operand.  The slab test produces 0 * inf = NaN whenever a ray direction
// component is 0, and its outcome depends on NaN propagating, so use these.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// jnp.mod / torch.remainder on ints: the result takes the divisor's sign.
__device__ __forceinline__ int floor_mod(int x, int w) { return ((x % w) + w) % w; }

inline unsigned grid_for(int n, int block) { return (unsigned)((n + block - 1) / block); }

}  // namespace rt
