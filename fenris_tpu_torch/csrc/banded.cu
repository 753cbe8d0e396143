// Banded gather and scatter of unstructured element data, for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/ops/banded.py:
//   * _gather_blocked_tpu  (body _gather_kernel)  -> fenris_banded_gather
//   * _scatter_blocked_tpu (body _scatter_kernel, plus the halo combine)
//                                                 -> fenris_banded_scatter
//
// What is computed.  The padded row layout of a BandedPlan has rows_total
// rows, one per (element, local node), grouped into blocks of
// rows_per_block rows whose first block_rows[k] rows are valid.
//   gather:  out[r][c] = u[nodes[r]][c] * (r valid ? 1 : 0)
//            (bitwise u[cells[perm]] on valid rows, zero on padding rows);
//   scatter: out[node][c] = sum over the node's valid rows r, in ascending
//            row order from 0.0f, of f[r][c]; the rows come from the plan's
//            CSR map (row_ptr, node_rows).
//
// Design.  The TPU kernels reach a 128-node window with one-hot matmuls on
// the MXU and carry the scatter sum in VMEM across sequential grid steps.
// Neither carries over: Hopper blocks run in no order, and float atomics
// would add in a different order on every run (CG would drift).
//   gather:  the grid is (owner block, tile of kGatherTile rows inside it),
//            so a thread block never straddles two owner blocks: validity is
//            one compare of the row against block_rows[k], with no division,
//            and all index arithmetic is 32-bit (the launcher refuses
//            rows_total * s >= 2^31).  For s = 1, 2, 3 (rows_per_block a
//            multiple of 4) a thread takes 4 consecutive rows: one int4 index
//            load, then all 4 s loads of u, before any store.  At s = 1 the
//            4 values leave as one float4 from registers (neighbouring threads
//            16 bytes apart); at s = 2 and 3 a thread's 4 s floats would sit 32
//            or 48 bytes from its neighbour's, so the tile goes through shared
//            memory and leaves as one contiguous float4 run.  Padding rows are
//            written as zeros without reading u.  Other s (no caller) take a
//            scalar body.  (8 rows a thread, two int4 loads, measured no
//            faster: PERF.md section 6.)
//   scatter: one thread per (node, component) walks its node's rows in
//            ascending order and writes once, with no atomics, so repeats
//            are bitwise equal and equal to the plain version's layered
//            index_add_.  At s = 1 and 2 it loads kScatterBatch row indices,
//            then their values, before it adds any, so a node's rows cost two
//            load latencies a batch instead of two a row; at s = 3 (hex8's
//            uniform 8 rows a node) the one-row walk is the faster, measured.
//            (A block-cooperative walk that staged each node range's rows in
//            shared memory ran 21-40% slower at the res-149 layouts: PERF.md
//            section 6.)
// What bounds them on the H100: bytes.  The gather reads 4 B of index per
// valid row and writes 4 s B per row (u itself, 4 s B per node, mostly hits
// L2); the scatter reads 4 s B of element data and 4 B of row index per
// row, the element reads landing in 32 B sectors of which it uses 4 s B.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupRows = 4;                      // rows a thread gathers: one int4 of indices
constexpr int kGatherTile = kThreads * kGroupRows;  // rows of one gather thread block
constexpr int kScatterBatch = 8;                   // rows a scatter thread loads before it adds them (s = 1, 2)

// S = 1, 2, 3: the tiled body (rows_per_block % 4 == 0, nodes and out 16-byte
// aligned, u aligned to its rows at s = 2); S = 0: any s, scalar.
template <int S>
__global__ void __launch_bounds__(kThreads)
    banded_gather_kernel(const float* __restrict__ u, const int32_t* __restrict__ nodes,
                         const int32_t* __restrict__ block_rows, float* __restrict__ out,
                         int rows_per_block, int s_any) {
  const int k = blockIdx.x;
  const int tile0 = blockIdx.y * kGatherTile;
  const int local = tile0 + threadIdx.x * kGroupRows;  // first row of this thread inside block k
  const int nvalid = __ldg(block_rows + k);
  const int base = k * rows_per_block;
  if constexpr (S == 0) {
    const int s = s_any;
    if (local >= rows_per_block) return;
    for (int j = 0; j < kGroupRows && local + j < rows_per_block; ++j) {
      float* dst = out + (base + local + j) * s;
      if (local + j < nvalid) {
        const float* src = u + (int64_t)__ldg(nodes + base + local + j) * s;
        for (int c = 0; c < s; ++c) dst[c] = __ldg(src + c);
      } else {
        for (int c = 0; c < s; ++c) dst[c] = 0.0f;
      }
    }
  } else {
    int4 idx = make_int4(0, 0, 0, 0);
    if (local < nvalid) idx = __ldg(reinterpret_cast<const int4*>(nodes + base + local));
    const int id[kGroupRows] = {idx.x, idx.y, idx.z, idx.w};
    float o[kGroupRows * S];
#pragma unroll
    for (int j = 0; j < kGroupRows; ++j) {
      const bool valid = local + j < nvalid;
      if constexpr (S == 2) {
        float2 v = make_float2(0.0f, 0.0f);
        if (valid) v = __ldg(reinterpret_cast<const float2*>(u) + id[j]);
        o[2 * j] = v.x;
        o[2 * j + 1] = v.y;
      } else {
#pragma unroll
        for (int c = 0; c < S; ++c) o[S * j + c] = valid ? __ldg(u + (int64_t)id[j] * S + c) : 0.0f;
      }
    }
    if constexpr (S == 1) {
      if (local < rows_per_block)
        *reinterpret_cast<float4*>(out + base + local) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      // stride S float4 a thread (32 or 48 bytes) from registers; through
      // shared memory the tile's rows leave as one contiguous float4 run
      __shared__ __align__(16) float s_out[kGatherTile * S];
      float4* so = reinterpret_cast<float4*>(s_out) + threadIdx.x * S;
#pragma unroll
      for (int q = 0; q < S; ++q) so[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
      __syncthreads();
      const int n4 = min(kGatherTile, rows_per_block - tile0) * S / 4;  // rows_per_block % 4 == 0
      const float4* src = reinterpret_cast<const float4*>(s_out);
      float4* dst = reinterpret_cast<float4*>(out + (base + tile0) * S);
      for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = src[i];
    }
  }
}

// One thread per (node, component).  S = 1, 2: the thread walks its node's
// CSR rows in batches of kScatterBatch: the batch's row indices, then their
// f values, then the adds in ascending row order.  S = 0 (any s, s = 3
// included): one row at a time.
template <int S>
__global__ void __launch_bounds__(kThreads)
    banded_scatter_kernel(const float* __restrict__ f, const int32_t* __restrict__ row_ptr,
                          const int32_t* __restrict__ node_rows, float* __restrict__ out, int64_t num_nodes,
                          int s_any) {
  const int s = S ? S : s_any;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= num_nodes * s) return;
  const int64_t node = t / s;
  const int c = (int)(t - node * s);
  const int begin = __ldg(row_ptr + node), end = __ldg(row_ptr + node + 1);
  float acc = 0.0f;
  if constexpr (S == 0) {
    for (int i = begin; i < end; ++i) acc += __ldg(f + (int64_t)__ldg(node_rows + i) * s + c);
  } else {
    for (int i0 = begin; i0 < end; i0 += kScatterBatch) {
      int row[kScatterBatch];
      float v[kScatterBatch];
#pragma unroll
      for (int j = 0; j < kScatterBatch; ++j) row[j] = i0 + j < end ? __ldg(node_rows + i0 + j) : -1;
#pragma unroll
      for (int j = 0; j < kScatterBatch; ++j)
        if (row[j] >= 0) v[j] = __ldg(f + (int64_t)row[j] * S + c);
#pragma unroll
      for (int j = 0; j < kScatterBatch; ++j)
        if (row[j] >= 0) acc += v[j];
    }
  }
  out[t] = acc;
}

template <int S>
int launch_gather(dim3 grid, cudaStream_t st, const void* u, const void* nodes, const void* block_rows, void* out,
                  int rows_per_block, int s) {
  banded_gather_kernel<S><<<grid, kThreads, 0, st>>>((const float*)u, (const int32_t*)nodes,
                                                      (const int32_t*)block_rows, (float*)out, rows_per_block, s);
  return (int)cudaGetLastError();
}

template <int S>
int launch_scatter(cudaStream_t st, const void* f, const void* row_ptr, const void* node_rows, void* out,
                   long long num_nodes, int s) {
  const int64_t threads = (int64_t)num_nodes * s;
  banded_scatter_kernel<S><<<(unsigned int)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const float*)f, (const int32_t*)row_ptr, (const int32_t*)node_rows, (float*)out, num_nodes, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  All arrays are
// contiguous device arrays: u f32 [N, s], nodes int32 [rows_total],
// block_rows int32 [rows_total / rows_per_block], out f32 [rows_total, s]
// (gather); f f32 [rows, s], row_ptr int32 [num_nodes + 1], node_rows int32
// [row_ptr[num_nodes]], out f32 [num_nodes, s] (scatter).  Each returns
// cudaGetLastError() after its launch (0 = success).  The gather returns
// cudaErrorInvalidValue without launching when rows_total * s >= 2^31,
// rows_total is not a multiple of rows_per_block, rows_per_block exceeds
// 65535 tiles, or, at s = 1, 2, 3, rows_per_block is not a multiple of 4 or
// nodes, out (16 bytes) or u (its row, at s = 2) is not aligned; the scatter
// when s < 1.

extern "C" int fenris_banded_gather(const void* u, const void* nodes, const void* block_rows,
                                    void* out, long long rows_total, int rows_per_block, int s,
                                    void* stream) {
  if (rows_total == 0) return 0;
  if (rows_per_block <= 0 || s <= 0 || rows_total % rows_per_block != 0 ||
      rows_total * s >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool tiled = s <= 3;
  if (tiled && (rows_per_block % kGroupRows != 0 || (uintptr_t)nodes % 16 != 0 || (uintptr_t)out % 16 != 0 ||
                (uintptr_t)u % (s == 2 ? 8 : 4) != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(rows_total / rows_per_block),
                  (unsigned int)((rows_per_block + kGatherTile - 1) / kGatherTile));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1: return launch_gather<1>(grid, st, u, nodes, block_rows, out, rows_per_block, s);
    case 2: return launch_gather<2>(grid, st, u, nodes, block_rows, out, rows_per_block, s);
    case 3: return launch_gather<3>(grid, st, u, nodes, block_rows, out, rows_per_block, s);
    default: return launch_gather<0>(grid, st, u, nodes, block_rows, out, rows_per_block, s);
  }
}

extern "C" int fenris_banded_scatter(const void* f, const void* row_ptr, const void* node_rows,
                                     void* out, long long num_nodes, int s, void* stream) {
  if (s <= 0) return (int)cudaErrorInvalidValue;
  if (num_nodes == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1: return launch_scatter<1>(st, f, row_ptr, node_rows, out, num_nodes, s);
    case 2: return launch_scatter<2>(st, f, row_ptr, node_rows, out, num_nodes, s);
    default: return launch_scatter<0>(st, f, row_ptr, node_rows, out, num_nodes, s);
  }
}
