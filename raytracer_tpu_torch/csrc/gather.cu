// K11-K13: row gathers from a float32 table, independent and chained.
//
// Replaces the Pallas kernels of the four row-gather harnesses in scratch/,
// each of which times the gather of 72-float (288-byte) rows, the wide walk's
// node record; the plain PyTorch versions are raytracer_tpu_torch/ops/gather.py.
//
// K11 row_gather_kernel<kStaged>: out[n, :] = table[idx[n], :], a copy of bits.
//   - direct (kStaged = false) replaces scratch/bench_pallas_gather.py:63
//     row_kernel (one row a grid step, its index by scalar prefetch; Mosaic
//     rejects that form) and scratch/bench_vmem_gather.py:33 kernel_take and :37
//     kernel_tala (the table whole in VMEM).  Each thread copies one 16-byte
//     piece: a warp covers one row of 128 floats or 1.8 rows of 72, every load
//     independent, so each SM holds many rows in flight.  A table held whole on
//     chip has no shared-memory form here: B4's 2.40 MB is 10x the 227 KB a
//     block may have, and lives in the 50 MB L2 instead.
//   - staged (kStaged = true) replaces scratch/bench_pallas_gather.py:92
//     block_kernel (and its copy inside scratch/bench_pallas_chained.py:25
//     pallas_gather): a block takes G consecutive indices and streams their rows
//     through a ring of kStages x kStageRows rows in shared memory, filled by
//     16-byte cp.async copies (one commit group a stage, the card's counterpart
//     of make_async_copy and its DMA semaphores), and writes each stage out
//     coalesced.
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
// ops/gather.py's, so acc and j equal the plain version's.
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
constexpr int kStagedThreads = 128;
constexpr int kStages = 4;     // the ring's depth, in stages
constexpr int kStageRows = 8;  // rows a stage
// |x| below which a chain's step trunc(x) counts (ops/gather.py next_index)
constexpr float kStepLimit = 536870912.0f;  // 2^29

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The next row of a chain: (j + trunc(x) + i) mod t, the modulus taking the
// divisor's sign; a step |x| >= 2^29, NaN or infinity counts as 0.
__device__ __forceinline__ int next_index(int j, float x, int i, int t) {
  int k = fabsf(x) < kStepLimit ? (int)x : 0;
  int r = (j + k + i) % t;
  return r < 0 ? r + t : r;
}

template <bool kStaged>
__global__ void row_gather_kernel(const float4* __restrict__ table, int r4,
                                  const int* __restrict__ idx, int n, int rows_per_block,
                                  float4* __restrict__ out) {
  if constexpr (!kStaged) {
    long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)n * r4) return;
    int row = (int)(e / r4), q = (int)(e - (long long)row * r4);
    out[e] = __ldg(table + (size_t)idx[row] * r4 + q);
  } else {
    extern __shared__ float4 ring[];  // kStages x kStageRows x r4
    const int first = blockIdx.x * rows_per_block;
    const int rows = min(rows_per_block, n - first);
    const int stages = (rows + kStageRows - 1) / kStageRows;
    const int stage_pieces = kStageRows * r4;
    auto pieces = [&](int c) { return min(kStageRows, rows - c * kStageRows) * r4; };
    // every thread commits one group a stage, empty past the end, so that
    // wait_group<kStages - 1> always means "stage c has landed"
    auto issue = [&](int c) {
      if (c < stages) {
        float4* slot = ring + (c % kStages) * stage_pieces;
        const int* rid = idx + first + c * kStageRows;
        for (int e = threadIdx.x; e < pieces(c); e += kStagedThreads) {
          int r = e / r4;
          cp_async16(slot + e, table + (size_t)rid[r] * r4 + (e - r * r4));
        }
      }
      cp_async_commit();
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    for (int c = 0; c < stages; ++c) {
      issue(c + kStages - 1);  // into the slot read in iteration c - 1
      cp_async_wait<kStages - 1>();
      __syncthreads();  // every thread's pieces of stage c have landed
      const float4* slot = ring + (c % kStages) * stage_pieces;
      float4* dst = out + (size_t)(first + c * kStageRows) * r4;
      for (int e = threadIdx.x; e < pieces(c); e += kStagedThreads) dst[e] = slot[e];
      __syncthreads();  // the slot is read before iteration c + 1 refills it
    }
  }
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

// table: [T, 4 * r4] f32, 16-byte aligned; idx: [n] int32 in [0, T); out: [n, 4 * r4].
// staged: each block takes rows_per_block consecutive indices.
extern "C" int rt_row_gather(int staged, const void* table, int r4, const void* idx, int n,
                             int rows_per_block, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tab = (const float4*)table;
  if (staged) {
    unsigned grid = rt::grid_for(n, rows_per_block);
    size_t smem = (size_t)kStages * kStageRows * r4 * sizeof(float4);
    row_gather_kernel<true><<<grid, kStagedThreads, smem, s>>>(
        tab, r4, (const int*)idx, n, rows_per_block, (float4*)out);
  } else {
    long long pieces = (long long)n * r4;
    unsigned grid = (unsigned)((pieces + kThreads - 1) / kThreads);
    row_gather_kernel<false><<<grid, kThreads, 0, s>>>(tab, r4, (const int*)idx, n,
                                                       rows_per_block, (float4*)out);
  }
  return (int)cudaGetLastError();
}

// table: [t, 4 * r4] f32, 16-byte aligned; idx: [n] int32 (chained: the first
// rows) or [iters, n] (indep); acc: [n] f32; j_out: [n] int32 (chained only).
extern "C" int rt_chained_gather(int indep, const void* table, int t, int r4, const void* idx,
                                 int n, int iters, void* acc, void* j_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* tab = (const float4*)table;
  if (r4 == 18)  // the wide walk's 72-float row
    launch_chain<18>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  else if (r4 == 32)  // the harnesses' 128-float padded row
    launch_chain<32>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
  else
    launch_chain<0>(indep, tab, t, r4, (const int*)idx, n, iters, (float*)acc, (int*)j_out, s);
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
