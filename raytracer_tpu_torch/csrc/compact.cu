// K6: stable stream compaction of a boolean flag array into lane indices.
//
// Replaces raytracer_tpu/ops/compaction.py:compact_indices and the partition in
// raytracer_tpu/render/renderer.py:_compact (JAX); its plain PyTorch version is
// raytracer_tpu_torch/ops/compaction.py:compact_plain.  Unlike compact_indices
// there is no capacity and no fallback lane: the output holds exactly the
// flagged lanes, in lane order (stable, because queue order sets the order of
// the framebuffer sums).
//
// Bound on the H100: bytes.  It reads the flags twice (1 B a lane) and writes
// 4 B per flagged lane; a 4M-lane call moves ~12 MB.
//
// This first version is right and simple: three launches of one thread per
// lane — a per-block count (__syncthreads_count), one block that scans the
// block counts, and a scatter that ranks each flagged lane inside its block by
// warp ballots.  A single-pass decoupled look-back scan is for a later PR.
#include "common.cuh"

namespace {

constexpr int kBlock = 1024;  // lanes per block, one per thread
constexpr unsigned kFull = 0xffffffffu;

__global__ void count_kernel(const uint8_t* __restrict__ flags, int n,
                             int* __restrict__ block_counts) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  int f = (i < n) && flags[i];
  int c = __syncthreads_count(f);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// Exclusive scan of block_counts[0..nb) in place, by one block of kBlock
// threads walking the array kBlock entries at a time; the total goes to
// block_counts[nb].
__global__ void scan_kernel(int* __restrict__ block_counts, int nb) {
  __shared__ int warp_sums[kBlock / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kBlock) {
    int i = base + threadIdx.x;
    int v = i < nb ? block_counts[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0) + carry;
    if (i < nb) block_counts[i] = incl - v;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kBlock - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) block_counts[nb] = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ flags, int n,
                               const int* __restrict__ block_offsets,
                               int* __restrict__ out) {
  __shared__ int warp_base[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i = blockIdx.x * kBlock + threadIdx.x;
  int f = (i < n) && flags[i];
  unsigned ballot = __ballot_sync(kFull, f);
  int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = warp_base[lane];
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    warp_base[lane] = x - c;  // exclusive over warps
  }
  __syncthreads();
  if (f) out[block_offsets[blockIdx.x] + warp_base[warp] + rank] = i;
}

}  // namespace

// flags: [n] bool (1 byte each); block_offsets: [ceil(n/1024) + 1] int32 scratch,
// whose last entry receives the number of flagged lanes; out: [n] int32, of which
// the first (number of flagged lanes) entries are written.
extern "C" int rt_compact(const void* flags, int n, void* block_offsets, void* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned nb = rt::grid_for(n, kBlock);
  count_kernel<<<nb, kBlock, 0, s>>>((const uint8_t*)flags, n, (int*)block_offsets);
  scan_kernel<<<1, kBlock, 0, s>>>((int*)block_offsets, (int)nb);
  scatter_kernel<<<nb, kBlock, 0, s>>>((const uint8_t*)flags, n,
                                       (const int*)block_offsets, (int*)out);
  return (int)cudaGetLastError();
}
