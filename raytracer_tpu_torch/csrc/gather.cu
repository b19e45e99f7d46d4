// K11-K13: row gathers from a float32 table, independent and chained.
//
// Replaces the Pallas kernels of the four row-gather harnesses in scratch/,
// each of which times the gather of 72-float (288-byte) rows, the wide walk's
// node record; the plain PyTorch versions are raytracer_tpu_torch/ops/gather.py.
//
// K11: out[n, :] = table[idx[n], :], a copy of bits, in two schedules.
//   - direct (row_gather_kernel) replaces scratch/bench_pallas_gather.py:63
//     row_kernel (one row a grid step, its index by scalar prefetch; Mosaic
//     rejects that form) and scratch/bench_vmem_gather.py:33 kernel_take and :37
//     kernel_tala (the table whole in VMEM).  Each thread copies one 16-byte
//     piece: a warp covers one row of 128 floats or 1.8 rows of 72, every load
//     independent, so each SM holds many rows in flight.  A table held whole on
//     chip has no shared-memory form here: B4's 2.40 MB is 10x the 227 KB a
//     block may have, and lives in the 50 MB L2 instead.
//   - staged (staged_gather_kernel) replaces scratch/bench_pallas_gather.py:92
//     block_kernel (and its copy inside scratch/bench_pallas_chained.py:25
//     pallas_gather): rows pass through a ring in shared memory filled by
//     async copies, the card's counterpart of make_async_copy and its DMA
//     semaphores.  A stage is kRingRows consecutive indices; each row is one
//     1-D bulk async copy (cp.async.bulk, the TMA unit: a 16-byte multiple
//     from a 16-byte aligned address), issued by the lane of warp 0 that
//     reads its index, and completing on the stage's mbarrier, armed with the
//     stage's bytes.  TMA's tensor-map row gather exists only on sm_100, so
//     on this card each row is its own copy.  The ring holds kRingStages
//     stages (8 x 16 rows: 64 KB at 512-byte rows, in dynamic shared memory),
//     so a block keeps up to 7 stages in flight; the grid is persistent,
//     blocks as many as fit the SMs, each striding over the stages.  The
//     earlier form (a 4 x 8-row ring of 16-byte cp.async, N/512 blocks of 128
//     threads) held at most 12 KB an SM in flight and took 0.059 ms for
//     65,536 rows of 512 B where index_select took 0.043 (NVIDIA H100 80GB
//     HBM3, 700 W): starved of bytes in flight, not of shared memory.
//     One warp a block: lane 0 waits on a stage's barrier and writes the
//     stage out with one bulk copy from shared memory (a bulk group, waited
//     on for its reads before the slot is refilled).  Every thread of a
//     128-thread block storing 16-byte pieces, coalesced, took 0.0260 and
//     0.0262 ms of device time against the bulk copy's 0.0256 and 0.0257
//     (chip_smoke.py, two runs, NVIDIA H100 80GB HBM3, 700 W).
//   Bound: bytes.  It reads the rows it names (each distinct row once) and the
//   indices, and writes N x R floats.
//
// K12 chain_kernel<kR4, kIndep> replaces the loop of
// scratch/bench_pallas_chained.py:67-84 make_fn (and of
// scratch/bench_vmem_gather.py:61-75 bench_loop) around those gathers.  One
// thread walks one chain, as K1 and K10 walk one ray:
//     j = idx0; acc = 0
//     for i in [0, iters): row = table[j]; s = row[0] + ... + row[R-1];
//                          acc += s; j = next_index(j, row[0] * T, i, T)
// With kIndep the indices come from idx_all[i, n] instead
// (bench_pallas_chained.py:107-113).  A row is read as R/4 independent 16-byte
// loads (R = 72 and 128 unrolled whole); its sum runs left to right, as
// ops/gather.py's, so acc and j equal the plain version's.  chain_scalar_kernel
// reads rows of any width with 32-bit loads (the threaded walk's 24-byte box
// rows, whose stride straddles 32-byte sectors).
// Bound: bytes (each distinct row once) at the harness's shapes with a table
// beyond L2; operations (R + 5 a step) once the table is small.  The measure of
// interest is its time a lane-iteration: one dependent 16-byte-load round trip
// per row, the floor under K1's and K10's walks.
//
// K13 rowsum_kernel<kChain> replaces scratch/bench_vmem_invreg.py:63
// gather_kernel (single: out[n] = sum_c tab[c, idx[n]]) and :39 in_kernel (the
// chain inside the kernel: s from the table, j = next_index(j, s * 7, i, U)).
// Each block stages the [C, U] table (records in columns, 36 KB at C = 72,
// U = 128) once in shared memory transposed to [U][C | 1]: the odd row stride
// puts the same component of 32 different records in 32 different banks.  Then
// one thread a lane, summing c = 0 .. C-1 left to right (bit-exact with the
// plain version under --fmad=false).  Bound: bytes single, operations chained.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRingStages = 8;       // the staged ring's depth, in stages
constexpr int kRingRows = 16;        // rows a stage
// |x| below which a chain's step trunc(x) counts (ops/gather.py next_index)
constexpr float kStepLimit = 536870912.0f;  // 2^29

// The next row of a chain: (j + trunc(x) + i) mod t, the modulus taking the
// divisor's sign; a step |x| >= 2^29, NaN or infinity counts as 0.
__device__ __forceinline__ int next_index(int j, float x, int i, int t) {
  int k = fabsf(x) < kStepLimit ? (int)x : 0;
  int r = (j + k + i) % t;
  return r < 0 ? r + t : r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// The barrier expects `bytes` more of this phase's copies, and one arrival.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One row, global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One stage, shared -> global, in its own bulk group.
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               "cp.async.bulk.commit_group;\n" ::"l"(gmem),
               "r"(smem_addr(smem)), "r"(bytes)
               : "memory");
}

// Until at most kPending of this thread's bulk stores still read shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void row_gather_kernel(const float4* __restrict__ table, int r4,
                                     const int* __restrict__ idx, int n,
                                     float4* __restrict__ out) {
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)n * r4) return;
  int row = (int)(e / r4), q = (int)(e - (long long)row * r4);
  out[e] = __ldg(table + (size_t)idx[row] * r4 + q);
}

__global__ void __launch_bounds__(32)
staged_gather_kernel(const float4* __restrict__ table, int r4, const int* __restrict__ idx,
                     int n, float4* __restrict__ out) {
  extern __shared__ __align__(128) float4 ring[];  // kRingStages x kRingRows x r4
  __shared__ __align__(8) unsigned long long full[kRingStages];
  const unsigned row_bytes = 16u * (unsigned)r4;
  const int stage_pieces = kRingRows * r4;
  const int stages = (n + kRingRows - 1) / kRingRows;
  // this block's stages: blockIdx.x + k gridDim.x, k = 0 .. mine - 1
  const int mine = (int)blockIdx.x < stages ? (stages - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                                            : 0;
  const int lane = threadIdx.x;  // one warp a block
  if (lane == 0) {
    for (int k = 0; k < kRingStages; ++k) mbar_init(&full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto first_row = [&](int k) { return ((int)blockIdx.x + k * (int)gridDim.x) * kRingRows; };
  // local stage k into slot k % kRingStages: lane r copies the stage's row r
  auto issue = [&](int k) {
    const int first = first_row(k);
    const int rows = min(kRingRows, n - first);
    unsigned long long* bar = &full[k % kRingStages];
    float4* slot = ring + (k % kRingStages) * stage_pieces;
    if (lane == 0) mbar_arrive_expect_tx(bar, (unsigned)rows * row_bytes);
    if (lane < rows)
      bulk_load(slot + lane * r4, table + (size_t)idx[first + lane] * r4, row_bytes, bar);
  };
  for (int k = 0; k < min(mine, kRingStages); ++k) issue(k);
  for (int k = 0; k < mine; ++k) {
    const int first = first_row(k);
    const int rows = min(kRingRows, n - first);
    // lane 0 waits for stage k and writes it out with one bulk copy
    if (lane == 0) {
      mbar_wait(&full[k % kRingStages], (unsigned)(k / kRingStages) & 1u);
      bulk_store(out + (size_t)first * r4, ring + (k % kRingStages) * stage_pieces,
                 (unsigned)rows * row_bytes);
    }
    // refill the slot of stage k - 1 once its store has read it
    if (k >= 1 && k - 1 + kRingStages < mine) {
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
      issue(k - 1 + kRingStages);
    }
  }
  if (lane == 0) bulk_wait_all();
}

// One row's float32 sum, c = 0 first; *first receives row[0].  kR4 > 0: the
// row's kR4 16-byte loads are unrolled, none waiting on another.
template <int kR4>
__device__ __forceinline__ float row_sum(const float4* __restrict__ row, int r4,
                                         float* first) {
  if constexpr (kR4 > 0) {
    float4 v[kR4];
#pragma unroll
    for (int q = 0; q < kR4; ++q) v[q] = __ldg(row + q);
    float s = v[0].x;
    s += v[0].y;
    s += v[0].z;
    s += v[0].w;
#pragma unroll
    for (int q = 1; q < kR4; ++q) {
      s += v[q].x;
      s += v[q].y;
      s += v[q].z;
      s += v[q].w;
    }
    *first = v[0].x;
    return s;
  } else {
    float4 v = __ldg(row);
    float s = v.x;
    s += v.y;
    s += v.z;
    s += v.w;
    *first = v.x;
    for (int q = 1; q < r4; ++q) {
      v = __ldg(row + q);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    return s;
  }
}

template <int kR4, bool kIndep>
__global__ void chain_kernel(const float4* __restrict__ table, int t, int r4,
                             const int* __restrict__ idx, int n, int iters,
                             float* __restrict__ acc_out, int* __restrict__ j_out) {
  int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  float acc = 0.0f;
  int j = kIndep ? 0 : idx[lane];
  for (int i = 0; i < iters; ++i) {
    if (kIndep) j = idx[(size_t)i * n + lane];
    float first;
    float s = row_sum<kR4>(table + (size_t)j * r4, r4, &first);
    acc = acc + s;
    if (!kIndep) j = next_index(j, first * (float)t, i, t);
  }
  acc_out[lane] = acc;
  if (!kIndep) j_out[lane] = j;
}

// K12 over rows of any width R, read with 32-bit loads (R = 6: the threaded
// walk's [U,6] box rows at their own 24-byte stride; kR = 0 for other widths)
template <int kR>
__global__ void chain_scalar_kernel(const float* __restrict__ table, int t, int r,
                                    const int* __restrict__ idx, int n, int iters,
                                    float* __restrict__ acc_out, int* __restrict__ j_out) {
  int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int w = kR > 0 ? kR : r;
  float acc = 0.0f;
  int j = idx[lane];
  for (int i = 0; i < iters; ++i) {
    const float* row = table + (size_t)j * w;
    const float first = __ldg(row);
    float s = first;
#pragma unroll
    for (int c = 1; c < w; ++c) s += __ldg(row + c);
    acc = acc + s;
    j = next_index(j, first * (float)t, i, t);
  }
  acc_out[lane] = acc;
  j_out[lane] = j;
}

template <bool kChain>
__global__ void rowsum_kernel(const float* __restrict__ tab, int c_dim, int u_dim,
                              const int* __restrict__ idx, int n, int iters,
                              float* __restrict__ acc_out, int* __restrict__ j_out) {
  extern __shared__ float sm[];  // [U][C | 1]
  const int stride = c_dim | 1;
  for (int e = threadIdx.x; e < c_dim * u_dim; e += kThreads) {
    int c = e / u_dim, u = e - c * u_dim;  // coalesced along a component's row
    sm[u * stride + c] = tab[e];
  }
  __syncthreads();
  for (int lane = blockIdx.x * kThreads + threadIdx.x; lane < n;
       lane += gridDim.x * kThreads) {
    int j = idx[lane];
    float acc = 0.0f;
    for (int i = 0; i < (kChain ? iters : 1); ++i) {
      const float* rec = sm + j * stride;
      float s = rec[0];
      for (int c = 1; c < c_dim; ++c) s += rec[c];
      if (!kChain) {
        acc = s;
        break;
      }
      acc = acc + s;
      j = next_index(j, s * 7.0f, i, u_dim);
    }
    acc_out[lane] = acc;
    if (kChain) j_out[lane] = j;
  }
}

template <int kR4>
void launch_chain(bool indep, const float4* table, int t, int r4, const int* idx, int n,
                  int iters, float* acc, int* j_out, cudaStream_t s) {
  unsigned grid = rt::grid_for(n, kThreads);
  if (indep)
    chain_kernel<kR4, true><<<grid, kThreads, 0, s>>>(table, t, r4, idx, n, iters, acc, j_out);
  else
    chain_kernel<kR4, false><<<grid, kThreads, 0, s>>>(table, t, r4, idx, n, iters, acc, j_out);
}

}  // namespace

namespace {

int launch_staged(const float4* tab, int r4, const int* idx, int n, float4* out,
                  cudaStream_t s) {
  // the ring's size and the blocks that fit the card, kept for the last r4
  static int last_r4 = -1, last_device = -1, grid_cap = 0;
  const size_t smem = (size_t)kRingStages * kRingRows * r4 * sizeof(float4);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (r4 != last_r4 || device != last_device) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(staged_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, staged_gather_kernel, 32,
                                                          smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_r4 = r4, last_device = device, grid_cap = sms * per_sm;
  }
  const int stages = (n + kRingRows - 1) / kRingRows;
  staged_gather_kernel<<<(unsigned)min(stages, grid_cap), 32, smem, s>>>(tab, r4, idx, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [T, 4 * r4] f32, 16-byte aligned; idx: [n] int32 in [0, T); out: [n, 4 * r4],
// 16-byte aligned; staged: rows of at most the ring's share of the block's
// shared memory.
extern "C" int rt_row_gather(int staged, const void* table, int r4, const void* idx, int n,
                             void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tab = (const float4*)table;
  if (staged) return launch_staged(tab, r4, (const int*)idx, n, (float4*)out, s);
  long long pieces = (long long)n * r4;
  unsigned grid = (unsigned)((pieces + kThreads - 1) / kThreads);
  row_gather_kernel<<<grid, kThreads, 0, s>>>(tab, r4, (const int*)idx, n, (float4*)out);
  return (int)cudaGetLastError();
}

// table: [t, 4 * r4] f32, 16-byte aligned; idx: [n] int32 (chained: the first
// rows) or [iters, n] (indep); acc: [n] f32; j_out: [n] int32 (chained only).
extern "C" int rt_chained_gather(int indep, const void* table, int t, int r4, const void* idx,
                                 int n, int iters, void* acc, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tab = (const float4*)table;
  if (r4 == 8)  // the wide walk's 32-float quantised node record
    launch_chain<8>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  else if (r4 == 18)  // the wide walk's 72-float row
    launch_chain<18>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  else if (r4 == 32)  // the harnesses' 128-float padded row
    launch_chain<32>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  else
    launch_chain<0>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  return (int)cudaGetLastError();
}

// K12 chained over rows of r floats with 32-bit loads: table [t, r] f32; idx:
// [n] int32, the first rows; acc: [n] f32; j_out: [n] int32.
extern "C" int rt_chained_gather_scalar(const void* table, int t, int r, const void* idx, int n,
                                        int iters, void* acc, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned grid = rt::grid_for(n, kThreads);
  if (r == 6)
    chain_scalar_kernel<6><<<grid, kThreads, 0, s>>>((const float*)table, t, r, (const int*)idx,
                                                     n, iters, (float*)acc, (int*)j_out);
  else
    chain_scalar_kernel<0><<<grid, kThreads, 0, s>>>((const float*)table, t, r, (const int*)idx,
                                                     n, iters, (float*)acc, (int*)j_out);
  return (int)cudaGetLastError();
}

// tab: [c_dim, u_dim] f32, u_dim * (c_dim | 1) floats within 48 KB; idx: [n]
// int32 in [0, u_dim).  j_out null: single (acc_out[n] = the record's sum);
// else the chain of iters steps, its acc and last j.
extern "C" int rt_table_rowsum(const void* tab, int c_dim, int u_dim, const void* idx, int n,
                               int iters, void* acc_out, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // a few blocks an SM, each staging the table once, walk the lanes by grid stride
  unsigned grid = rt::grid_for(n, kThreads);
  if (grid > 4u * sms) grid = 4u * sms;
  size_t smem = (size_t)u_dim * (c_dim | 1) * sizeof(float);
  if (j_out)
    rowsum_kernel<true><<<grid, kThreads, smem, s>>>((const float*)tab, c_dim, u_dim,
                                                     (const int*)idx, n, iters,
                                                     (float*)acc_out, (int*)j_out);
  else
    rowsum_kernel<false><<<grid, kThreads, smem, s>>>((const float*)tab, c_dim, u_dim,
                                                      (const int*)idx, n, iters,
                                                      (float*)acc_out, nullptr);
  return (int)cudaGetLastError();
}
