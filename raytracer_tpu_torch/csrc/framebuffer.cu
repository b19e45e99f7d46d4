// The framebuffer accumulation of a generation after the first: each lane's
// contribution added to its pixel's row of the frame.
//
// Replaces the scatter-add fb.at[gen.pixel].add(contribution) of
// raytracer_tpu/render/renderer.py:439 (JAX); its plain PyTorch version is
// raytracer_tpu_torch/ops/framebuffer.py:accumulate_plain (index_add_).  The
// first generation's lanes are the pixels in order, and the renderer adds its
// contributions densely.
//
// A later generation's queue holds the reflection children, then the
// refraction children, each in their parents' order, so a pixel takes few
// lanes of a generation (at most two after the first bounce) and they seldom
// share a warp: the shared scatter (scatter.cuh) has little to sum in a warp
// here, and carries each lane's three floats in one L2 request.
#include "scatter.cuh"

// out [P,3] float32, added to in place; index [n] int32 rows of out; values [n,3].
extern "C" int rt_scatter_add3(const void* index, const void* values, int n, void* out,
                               void* stream) {
  rt::scatter3_kernel<float><<<rt::grid_for(n, rt::kScatterBlock), rt::kScatterBlock, 0,
                        (cudaStream_t)stream>>>((const int*)index, (const float*)values, n,
                                                1.0f, (float*)out);
  return (int)cudaGetLastError();
}
