// The scatter-add of [n,3] float rows onto the rows `index` names, each row
// scaled first: out[index[i]] += scale * values[i].  K5's backward (sky.cu,
// scale 1/pi onto the probe's gradient) and the framebuffer accumulation
// (framebuffer.cu, scale 1 onto the frame) launch it.
//
// Bound on the H100: bytes (12 B of values a lane, the index of the lanes that
// add, and the rows they reach), if the atomics do not serialise.
//
// The first version of K5's backward, one thread a lane and three atomicAdds,
// took 0.224 ms on a training step's generation 0 (94% of its lanes with a
// zero cotangent: the renderer keeps the sky only where a ray misses), 0.364
// ms on 25x25-pixel texel tiles (config3's rays: ~25 neighbouring pixels read
// one texel), 0.080 ms on random texels and 10.9 ms with every lane on one
// texel; index_add_ took 0.099, 0.141, 0.050 and 3.76 ms on the same inputs
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py and microbench/scatter.py).
// So its time followed the contention on one address, and where there was
// none its three one-float atomics a lane were three L2 requests.  This
// kernel:
//  - skips a lane whose three values are all +-0: it reads no index and
//    issues no atomic.  Exact where out holds no -0: adding +-0 to any other
//    value leaves it as it is.  K5's gradient starts at +0 and the frame
//    starts as +0 + a sum, and a round-to-nearest sum never reaches -0 from
//    +0.  A NaN is not 0, so it reaches its row;
//  - sums each run of neighbouring lanes of a warp that name one row by a
//    segmented scan over shuffles, in a fixed tree order in lane order; the
//    run's last lane puts the sums in the warp's list in shared memory; then
//    neighbouring lanes issue the list's atomics, the three floats of a row
//    side by side, so that one L2 request carries them.  Runs, not
//    __match_any_sync groups: the scan costs five shuffle steps whatever the
//    groups, where summing a group of g scattered lanes takes g steps; a row
//    that a warp names in two runs costs it two atomics, which coherent rays
//    rarely give.  A row's atomics come one a run from each warp that names
//    it, and fp32 atomics still change the order of those sums from run to
//    run.
#pragma once

#include "common.cuh"

namespace rt {
namespace {

constexpr int kScatterBlock = 256;

__global__ void __launch_bounds__(kScatterBlock)
scatter3_kernel(const int* __restrict__ index, const float* __restrict__ values, int n,
                float scale, float* __restrict__ out) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int s_key[kScatterBlock / 32][32];
  __shared__ float s_sum[kScatterBlock / 32][3 * 32];
  const int i = blockIdx.x * kScatterBlock + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (i < n) {
    c0 = values[3 * i + 0];
    c1 = values[3 * i + 1];
    c2 = values[3 * i + 2];
  }
  // key -1: a lane past the end or whose values are all zero; it adds nothing
  const bool live = c0 != 0.0f || c1 != 0.0f || c2 != 0.0f;  // NaN != 0
  const int key = live ? index[i] : -1;
  float g0 = c0 * scale, g1 = c1 * scale, g2 = c2 * scale;
  // the run of `lane`: the nearest lane at or below it where the key changes
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  // segmented inclusive scan: after offset d a lane holds the sum of its run's
  // lanes in (lane - 2d, lane]
  for (int d = 1; d < 32; d <<= 1) {
    const float y0 = __shfl_up_sync(kFull, g0, d);
    const float y1 = __shfl_up_sync(kFull, g1, d);
    const float y2 = __shfl_up_sync(kFull, g2, d);
    if (lane - d >= start) {
      g0 = y0 + g0;
      g1 = y1 + g1;
      g2 = y2 + g2;
    }
  }
  // a run's last lane holds its sum: the k-th such run of the warp takes the
  // slots 3k .. 3k+2 of the warp's list, one a float
  const int next = __shfl_down_sync(kFull, key, 1);
  const bool tail = key >= 0 && (lane == 31 || next != key);
  const unsigned tails = __ballot_sync(kFull, tail);
  if (tail) {
    const int k = __popc(tails & ((1u << lane) - 1u));
    s_key[warp][k] = key;
    s_sum[warp][3 * k + 0] = g0;
    s_sum[warp][3 * k + 1] = g1;
    s_sum[warp][3 * k + 2] = g2;
  }
  __syncwarp();
  for (int slot = lane; slot < 3 * __popc(tails); slot += 32)
    atomicAdd(out + 3ll * s_key[warp][slot / 3] + slot % 3, s_sum[warp][slot]);
}

}  // namespace
}  // namespace rt
