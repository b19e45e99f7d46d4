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
// K12 replaces the loop of scratch/bench_pallas_chained.py:67-84 make_fn (and
// of scratch/bench_vmem_gather.py:61-75 bench_loop) around those gathers:
//     j = idx0; acc = 0
//     for i in [0, iters): row = table[j]; s = row[0] + ... + row[R-1];
//                          acc += s; j = next_index(j, row[0] * T, i, T)
// With kIndep the indices come from idx_all[i, n] instead
// (bench_pallas_chained.py:107-113).  Every step reads the whole row from
// global memory and sums it left to right, as ops/gather.py's, so acc and j
// equal the plain version's.  chain_warp_kernel<kR4, kIndep>: a warp's 32
// chains fetch their rows together, 32 consecutive 16-byte pieces an
// instruction, through a slot of shared memory (see the kernel); a thread that
// reads its own row, as K1 and K10 read a node record, touches 32 different
// lines a load instruction of a warp, and took twice as long (the first
// design, removed; PERF.md section 6).  chain_scalar_kernel reads rows of any
// width with 32-bit loads (the threaded walk's 24-byte box rows, whose stride
// straddles 32-byte sectors), one thread a chain.
// Bound: bytes (each distinct row once) at the harness's shapes with a table
// beyond L2; operations (R + 5 a step) once the table is small.  The measure of
// interest is its time a lane-iteration and its rate of rows as issued: the
// floor under K1's and K10's walks.
//
// K13 replaces scratch/bench_vmem_invreg.py:63 gather_kernel (single: out[n] =
// sum_c tab[c, idx[n]]) and :39 in_kernel (the chain inside the kernel: s from
// the table, j = next_index(j, s * 7, i, U)).  The [C, U] table (records in
// columns, 36 KB at C = 72, U = 128) is staged in shared memory, then one
// thread a lane sums c = 0 .. C-1 left to right (bit-exact with the plain
// version under --fmad=false).  rowsum_sm_kernel<kChain, kC>: one block of
// 1024 threads an SM stages the table once, in its own [C][U] layout with one
// bulk async copy, and walks the lanes by grid stride.
// Bound: bytes single, operations chained; with random records shared
// memory's bank conflicts set the pace.
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

// 16 bytes, global -> shared, through L1 (.ca)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until every cp.async of this thread has landed in shared memory.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// K12: a warp walks 32 chains, one a lane, and fetches their rows
// together.  Each step, piece p of the 32 rows laid end to end (p = 32k + lane,
// k = 0 .. r4 - 1) is one 16-byte cp.async into the warp's slot in shared
// memory, so that instruction k reads 32 consecutive pieces (a 512-byte row is
// 4 lines, not 32); the row's index comes from its lane by a shuffle.  The
// slot's rows lie (r4 | 1) pieces apart: each lane then reads its own row, 16
// bytes a load, the 8 lanes of each phase on 8 different 4-bank groups, and
// sums it left to right.  One slot a warp: the next step's copies go out once
// every lane has summed its row.  Measured slower on the harnesses' tables
// (device time, NVIDIA H100 80GB HBM3, 700 W): two slots a warp (the next
// step's copies issued before the sum, half the warps an SM), copies through
// L2 only (.cg; .ca goes through L1), one bulk async copy a row, and plain
// loads and stores.
constexpr int kWarpBlock = 4;  // warps a block at most

template <int kR4, bool kIndep>
__global__ void __launch_bounds__(32 * kWarpBlock)
chain_warp_kernel(const float4* __restrict__ table, int t, int r4_arg,
                  const int* __restrict__ idx, int n, int iters,
                  float* __restrict__ acc_out, int* __restrict__ j_out) {
  extern __shared__ __align__(16) float4 slot_mem[];  // warps x 32 rows x (r4 | 1)
  const int r4 = kR4 > 0 ? kR4 : r4_arg;
  const int stride = r4 | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (first >= n) return;  // no barrier spans the block's warps
  const int rows = min(32, n - first);  // the warp's chains
  const bool live = lane < rows;
  const int me = first + lane;
  float4* const slot = slot_mem + warp * 32 * stride;
  // the rows of one step into the slot: row r is chain r's, jv on lane r its index
  auto issue = [&](int jv) {
#pragma unroll
    for (int k = 0; k < r4; ++k) {
      const int p = k * 32 + lane, r = p / r4, q = p - r * r4;
      const int jr = __shfl_sync(0xffffffffu, jv, r);
      if (r < rows) cp_async16(slot + r * stride + q, table + (size_t)jr * r4 + q);
    }
    cp_async_commit();
  };
  float acc = 0.0f;
  int j = (!kIndep && live) ? idx[me] : 0;
  if (iters > 0) issue(kIndep ? (live ? idx[me] : 0) : j);
  for (int i = 0; i < iters; ++i) {
    // indep: the next step's index, read while this step's rows land
    const int jn = (kIndep && i + 1 < iters && live) ? idx[(size_t)(i + 1) * n + me] : 0;
    cp_async_wait_all();
    __syncwarp();  // every lane's copies have landed
    const float4* row = slot + lane * stride;
    float4 v = row[0];
    float s = v.x;
    if (!kIndep) j = next_index(j, v.x * (float)t, i, t);
    s += v.y;
    s += v.z;
    s += v.w;
#pragma unroll
    for (int q = 1; q < r4; ++q) {
      v = row[q];
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    acc = acc + s;
    if (i + 1 < iters) {
      __syncwarp();  // every lane has read its row
      issue(kIndep ? jn : j);
    }
  }
  if (live) {
    acc_out[me] = acc;
    if (!kIndep) j_out[me] = j;
  }
}

// K13: one block an SM, which stages the table once, in its own [C][U] layout,
// and walks the lanes by grid stride.  One bulk async copy brings the table's
// 16-byte body, completing on an mbarrier (threads copy a tail, or all of it
// from a base that is not 16-byte aligned).  kC > 0: the record's width, its
// reads unrolled ahead of the adds.  Measured against a [U][C | 1] layout (the
// first design's, a few blocks an SM each staging the table) and a [U][C4 | 1]
// of 16-byte pieces, read 16 bytes a load: on the harness's random records
// their bank conflicts differ little, and [C][U], which needs no
// transposition, was the fastest (PERF.md, Findings).
constexpr int kSmThreads = 1024;

template <bool kChain, int kC>
__global__ void __launch_bounds__(kSmThreads, 1)
rowsum_sm_kernel(const float* __restrict__ tab, int c_arg, int u_dim,
                 const int* __restrict__ idx, int n, int iters, float* __restrict__ acc_out,
                 int* __restrict__ j_out) {
  extern __shared__ __align__(16) float sm[];  // [C][U]
  __shared__ __align__(8) unsigned long long bar;
  const int c_dim = kC > 0 ? kC : c_arg;
  const int lane0 = blockIdx.x * kSmThreads + threadIdx.x;
  int j_first = lane0 < n ? idx[lane0] : 0;  // read while the table lands
  const int total = c_dim * u_dim;
  const int body = ((uintptr_t)tab % 16 == 0) ? (total & ~3) : 0;
  if (body && threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(&bar, (unsigned)body * 4u);
    bulk_load(sm, tab, (unsigned)body * 4u, &bar);
  }
  for (int e = body + threadIdx.x; e < total; e += kSmThreads) sm[e] = tab[e];
  __syncthreads();  // the barrier's init and the tail
  if (body) mbar_wait(&bar, 0);
  // record j's sum, c = 0 first
  auto record_sum = [&](int j) {
    const float* r = sm + j;
    float s = r[0];
#pragma unroll
    for (int c = 1; c < c_dim; ++c) s += r[c * u_dim];
    return s;
  };
  for (int lane = lane0; lane < n; lane += gridDim.x * kSmThreads) {
    int j = lane == lane0 ? j_first : idx[lane];
    float acc = 0.0f;
    if constexpr (kChain) {
      for (int i = 0; i < iters; ++i) {
        const float s = record_sum(j);
        acc = acc + s;
        j = next_index(j, s * 7.0f, i, u_dim);
      }
      j_out[lane] = j;
    } else {
      acc = record_sum(j);
    }
    acc_out[lane] = acc;
  }
}

// shared memory a block may opt in to on the H100 (232,448 B), less room for the
// kernels' static barriers
constexpr int kSmemOptIn = 232448 - 1024;

// Once a device: `kern` may take up to kSmemOptIn bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int* set_device) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || *set_device == device) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err == cudaSuccess) *set_device = device;
  return err;
}

template <int kR4, bool kIndep>
int launch_chain_warp(const float4* table, int t, int r4, const int* idx, int n, int iters,
                      float* acc, int* j_out, cudaStream_t s) {
  static int set_device = -1;
  auto kern = chain_warp_kernel<kR4, kIndep>;
  cudaError_t err = allow_smem(kern, &set_device);
  if (err != cudaSuccess) return (int)err;
  // a warp's slot; blocks of kWarpBlock warps where the slots are small, so
  // that the SM's limit on blocks does not cap its warps
  const size_t warp_smem = (size_t)32 * (r4 | 1) * sizeof(float4);
  const int warps = warp_smem * kWarpBlock <= 48 * 1024 ? kWarpBlock : 1;
  kern<<<rt::grid_for(n, 32 * warps), 32 * warps, warp_smem * warps, s>>>(table, t, r4, idx, n,
                                                                        iters, acc, j_out);
  return (int)cudaGetLastError();
}

template <bool kIndep>
int dispatch_chain_warp(const float4* table, int t, int r4, const int* idx, int n, int iters,
                        float* acc, int* j_out, cudaStream_t s) {
  if (r4 == 8)
    return launch_chain_warp<8, kIndep>(table, t, r4, idx, n, iters, acc, j_out, s);
  if (r4 == 18)
    return launch_chain_warp<18, kIndep>(table, t, r4, idx, n, iters, acc, j_out, s);
  if (r4 == 32)
    return launch_chain_warp<32, kIndep>(table, t, r4, idx, n, iters, acc, j_out, s);
  return launch_chain_warp<0, kIndep>(table, t, r4, idx, n, iters, acc, j_out, s);
}

template <bool kChain, int kC>
int launch_rowsum_sm(const float* tab, int c_dim, int u_dim, const int* idx, int n, int iters,
                     float* acc, int* j_out, cudaStream_t s) {
  static int set_device = -1;
  auto kern = rowsum_sm_kernel<kChain, kC>;
  cudaError_t err = allow_smem(kern, &set_device);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = rt::grid_for(n, kSmThreads);
  if (grid > (unsigned)sms) grid = (unsigned)sms;
  kern<<<grid, kSmThreads, (size_t)c_dim * u_dim * sizeof(float), s>>>(tab, c_dim, u_dim, idx, n,
                                                                        iters, acc, j_out);
  return (int)cudaGetLastError();
}

template <bool kChain>
int dispatch_rowsum_sm(const float* tab, int c_dim, int u_dim, const int* idx, int n, int iters,
                       float* acc, int* j_out, cudaStream_t s) {
  if (c_dim == 72)  // the harness's record: the wide walk's 72-float node row
    return launch_rowsum_sm<kChain, 72>(tab, c_dim, u_dim, idx, n, iters, acc, j_out, s);
  return launch_rowsum_sm<kChain, 0>(tab, c_dim, u_dim, idx, n, iters, acc, j_out, s);
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
// A warp fetches its 32 chains' rows into 32 rows of (r4 | 1) pieces of
// shared memory.
extern "C" int rt_chained_gather(int indep, const void* table, int t, int r4, const void* idx,
                                 int n, int iters, void* acc, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tab = (const float4*)table;
  const int* ix = (const int*)idx;
  return indep ? dispatch_chain_warp<true>(tab, t, r4, ix, n, iters, (float*)acc, nullptr, s)
               : dispatch_chain_warp<false>(tab, t, r4, ix, n, iters, (float*)acc,
                                            (int*)j_out, s);
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
// else the chain of iters steps, its acc and last j.  One block an SM.
extern "C" int rt_table_rowsum(const void* tab, int c_dim, int u_dim, const void* idx, int n,
                               int iters, void* acc_out, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)tab;
  const int* ix = (const int*)idx;
  return j_out ? dispatch_rowsum_sm<true>(t, c_dim, u_dim, ix, n, iters, (float*)acc_out,
                                          (int*)j_out, s)
               : dispatch_rowsum_sm<false>(t, c_dim, u_dim, ix, n, iters, (float*)acc_out,
                                           nullptr, s);
}
