// K6: stable stream compaction of a boolean flag array into lane indices.
//
// Replaces raytracer_tpu/ops/compaction.py:compact_indices and the partition in
// raytracer_tpu/render/renderer.py:_compact (JAX); its plain PyTorch version is
// raytracer_tpu_torch/ops/compaction.py:compact_plain.  Unlike compact_indices
// there is no capacity and no fallback lane: the output holds exactly the
// flagged lanes, in lane order (stable, because queue order sets the order of
// the framebuffer sums).
//
// Bound on the H100: bytes.  It reads the flags once (1 B a lane) and writes
// 4 B per flagged lane; a 4M-lane call moves ~4-20 MB, ~1-5 us.
//
// The first version took three dependent launches (a block count, one block
// scanning all ~4,000 block counts, a scatter), each thread loading one byte:
// 0.026 ms of device time on config3's generation-0 flags and 0.077 ms a call
// with the count read back, against 0.040 ms for torch.nonzero (NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py).  Its time was the launches and the
// serial scan, not the bytes.  This one is a single launch, a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016):
//  - a tile is kTile = 8192 flags, kItems = 32 a thread by two 16-byte loads
//    (~500 tiles for a 1080p generation's 4.1 M candidates: every block takes
//    its tile number and reports its end by one atomic on one address, and
//    ~500 of them queue for less time than ~1,000).  The tiles cut the frame
//    that starts at the 16-byte boundary at or below `flags`, so a view such
//    as flags[1:] loads by 16 bytes too; a thread whose 32 bytes reach past
//    either end of the array reads its valid bytes one by one;
//  - a block takes its tile number from an atomic counter, so every tile
//    before it has started and the look-back always makes progress;
//  - the block scans its threads' counts (popc of each thread's flag bits,
//    a shuffle scan), stages its indices in shared memory in lane order (a
//    word of padding every 32, or a dense tile's 32 threads of a warp would
//    write one bank at a time), and
//    publishes its count in its tile's status word (tile 0 its inclusive
//    prefix at once).  Warp 0 then reads the status words of the 32 tiles
//    before it at once, adds the counts up to the nearest one that holds an
//    inclusive prefix, and steps back 32 tiles until it meets one; then it
//    publishes its own inclusive prefix.  Flag and count share one 64-bit word,
//    so a reader never sees one without the other;
//  - the block writes its staged indices out contiguously, and the last tile
//    writes the total, the count, to device memory: nothing is read back here.
// The status words and the two counters live in scratch that the wrapper keeps
// for each device and stream, and the kernel leaves them at zero: the last
// block to finish (a second counter says which) clears them.  Not a memset
// before each call: this call is host-bound (the count's read-back waits for
// it), and a memset costs a launch of host time.  Not epoch tags either: the
// epoch would come from the host, and a CUDA graph that captures the call
// would replay it with the same epoch.  Cleared scratch replays as it is.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;  // flags a thread: two 16-byte loads
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// a tile's status word: its count in the low 32 bits, above it what the count is
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own count
constexpr unsigned long long kPrefix = 2ull << 32;     // the count of tiles 0..this one

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// where position p of a tile's staged indices lives in shared memory: one word
// of padding every 32, so that the 32 threads of a warp, each writing its own
// run of positions, write 32 different banks
__device__ __forceinline__ int staged(int p) { return p + (p >> 5); }

// bit j of the result: byte j of w is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u) & 0x01010101u;
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xfu;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ flags, int n, int head,
               unsigned long long* __restrict__ status, int* __restrict__ counters,
               int* __restrict__ out, int* __restrict__ count) {
  __shared__ int s_idx[kTile + kTile / 32];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile, s_prefix, s_last;
  int* tile_counter = counters;
  int* done_counter = counters + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;

  // this thread's flags: positions v0 .. v0+31 of the frame that starts `head`
  // bytes before flags[0]; lane = position - head
  const long long v0 = (long long)tile * kTile + tid * kItems;
  const long long end = (long long)head + n;
  unsigned bits = 0;
  if (v0 >= head && v0 + kItems <= end) {
    const uint4* p = reinterpret_cast<const uint4*>(flags + (v0 - head));
    const uint4 w = p[0], u = p[1];
    bits = nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 |
           nonzero_bytes(w.w) << 12 | nonzero_bytes(u.x) << 16 | nonzero_bytes(u.y) << 20 |
           nonzero_bytes(u.z) << 24 | nonzero_bytes(u.w) << 28;
  } else {
    for (int j = 0; j < kItems; ++j) {
      const long long v = v0 + j;
      if (v >= head && v < end && flags[v - head]) bits |= 1u << j;
    }
  }

  // exclusive scan of the threads' counts over the block (popc of 32 flag bits)
  const int c = __popc(bits);
  int x = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int total = s_warp[kWarps - 1];
  if (tid == 0) store_status(&status[tile], (tile == 0 ? kPrefix : kAggregate) | (unsigned)total);

  // stage the tile's indices in lane order
  int r = x - c + (warp > 0 ? s_warp[warp - 1] : 0);
  const int lane0 = (int)(v0 - head);  // a set bit j is the lane lane0 + j >= 0
  for (unsigned b = bits; b; b &= b - 1) s_idx[staged(r++)] = lane0 + __ffs(b) - 1;

  // the tile's exclusive prefix: decoupled look-back by warp 0
  if (warp == 0) {
    int prefix = 0;
    for (int top = tile - 1; top >= 0; top -= 32) {
      const int k = top - lane;  // lane 0 reads the nearest tile
      unsigned long long s = kPrefix;  // below tile 0: a prefix of 0
      if (k >= 0) {
        do {
          s = load_status(&status[k]);
        } while ((s >> 32) == 0);
      }
      const unsigned is_prefix = __ballot_sync(kFull, (s >> 32) == 2);
      const int stop = is_prefix ? __ffs(is_prefix) - 1 : 31;
      int v = lane <= stop ? (int)(unsigned)s : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      prefix += v;
      if (is_prefix) break;
    }
    if (lane == 0) {
      if (tile > 0) store_status(&status[tile], kPrefix | (unsigned)(prefix + total));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const int prefix = s_prefix;
  for (int k = tid; k < total; k += kThreads) out[prefix + k] = s_idx[staged(k)];
  if (tid == 0 && tile == (int)gridDim.x - 1) *count = prefix + total;

  // the last block to get here clears the scratch: every block has made its
  // last read and write of the status words by then
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(done_counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (int k = tid; k < (int)gridDim.x; k += kThreads) status[k] = 0;
    if (tid == 0) {
      *tile_counter = 0;
      *done_counter = 0;
    }
  }
}

}  // namespace

// flags: [n] bool (1 byte each, any alignment), n >= 1; tiles: ceil((flags % 16 +
// n) / kTile), which the caller passes so that it sizes scratch as this file
// cuts the tiles; scratch: >= [1 + tiles] int64, zero at the first call and
// left zero by each (the two counters, then a status word a tile), used by one
// stream; out: [n] int32, of which the first (number of flagged lanes) entries
// are written; count: [1] int32, the number of flagged lanes.
extern "C" int rt_compact(const void* flags, int n, int tiles, void* scratch, void* out,
                          void* count, void* stream) {
  const int head = (int)((uintptr_t)flags % 16);
  if (n < 1 || tiles != (int)(((long long)head + n + kTile - 1) / kTile))
    return (int)cudaErrorInvalidValue;
  unsigned long long* words = (unsigned long long*)scratch;
  compact_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, n, head, words + 1, (int*)words, (int*)out, (int*)count);
  return (int)cudaGetLastError();
}
