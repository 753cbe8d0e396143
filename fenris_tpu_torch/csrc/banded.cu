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
//            row order, of f[r][c]; the rows come from the plan's CSR map
//            (row_ptr, node_rows).
//
// Design.  The TPU kernels reach a 128-node window with one-hot matmuls on
// the MXU and carry the scatter sum in VMEM across sequential grid steps.
// Neither carries over: Hopper blocks run in no order, and float atomics
// would add in a different order on every run (CG would drift).
//   gather:  a thread handles kRowsPerThread consecutive rows.  The grid is
//            (owner block, tile of kGatherTile rows inside it), so a thread
//            block never straddles two owner blocks: validity is one compare
//            of the row against block_rows[k], loaded once per warp, with no
//            division, and all index arithmetic is 32-bit (the launcher
//            refuses rows_total * s >= 2^31).  For s = 3 (rows_per_block a
//            multiple of 4) the four rows' indices are one int4 load; their
//            12 floats go to shared memory as three float4, and the tile's
//            rows, one contiguous run, leave as float4 stores with
//            neighbouring threads on neighbouring 16 bytes (straight from
//            registers, a warp's float4 stores would sit 48 bytes apart;
//            PERF.md has both times); other s take a scalar path.  Padding rows are written as zeros without reading u.
//   scatter: one thread per (node, component) walks its rows in ascending
//            order and writes once, with no atomics, so repeats are bitwise
//            equal and equal to the plain version's layered index_add_.
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
constexpr int kRowsPerThread = 4;
constexpr int kGatherTile = kThreads * kRowsPerThread;  // rows of one thread block

// Grid (k_blocks, ceil(rows_per_block / kGatherTile)).  S = 3: the vector
// path (rows_per_block % 4 == 0, 16-byte aligned nodes and out); S = 0: any s.
template <int S>
__global__ void __launch_bounds__(kThreads)
    banded_gather_kernel(const float* __restrict__ u, const int32_t* __restrict__ nodes,
                         const int32_t* __restrict__ block_rows, float* __restrict__ out,
                         int rows_per_block, int s_any) {
  const int s = S ? S : s_any;
  const int k = blockIdx.x;
  const int tile0 = blockIdx.y * kGatherTile;
  const int local = tile0 + threadIdx.x * kRowsPerThread;
  const int nvalid = __ldg(block_rows + k);
  const int r0 = k * rows_per_block + local;
  if (S == 3) {
    __shared__ __align__(16) float s_out[3 * kGatherTile];
    float o[3 * kRowsPerThread];
#pragma unroll
    for (int i = 0; i < 3 * kRowsPerThread; ++i) o[i] = 0.0f;
    if (local < nvalid) {
      const int4 idx = __ldg(reinterpret_cast<const int4*>(nodes + r0));
      const int id[kRowsPerThread] = {idx.x, idx.y, idx.z, idx.w};
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        if (local + j < nvalid) {
          const float* src = u + (int64_t)id[j] * 3;
          o[3 * j] = __ldg(src);
          o[3 * j + 1] = __ldg(src + 1);
          o[3 * j + 2] = __ldg(src + 2);
        }
    }
    // thread stride 48 bytes: a quarter-warp's float4 stores hit 8 distinct bank groups
    float4* so = reinterpret_cast<float4*>(s_out) + threadIdx.x * 3;
    so[0] = make_float4(o[0], o[1], o[2], o[3]);
    so[1] = make_float4(o[4], o[5], o[6], o[7]);
    so[2] = make_float4(o[8], o[9], o[10], o[11]);
    __syncthreads();
    const int n4 = min(kGatherTile, rows_per_block - tile0) * 3 / 4;  // rows_per_block % 4 == 0
    const float4* src = reinterpret_cast<const float4*>(s_out);
    float4* dst = reinterpret_cast<float4*>(out + (k * rows_per_block + tile0) * 3);
    for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = src[i];
  } else {
    if (local >= rows_per_block) return;
    for (int j = 0; j < kRowsPerThread && local + j < rows_per_block; ++j) {
      float* dst = out + (r0 + j) * s;
      if (local + j < nvalid) {
        const float* src = u + (int64_t)__ldg(nodes + r0 + j) * s;
        for (int c = 0; c < s; ++c) dst[c] = __ldg(src + c);
      } else {
        for (int c = 0; c < s; ++c) dst[c] = 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    banded_scatter_kernel(const float* __restrict__ f, const int32_t* __restrict__ row_ptr,
                          const int32_t* __restrict__ node_rows, float* __restrict__ out,
                          int64_t num_nodes, int s) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= num_nodes * s) return;
  const int64_t node = t / s;
  const int c = (int)(t - node * s);
  const int begin = __ldg(row_ptr + node), end = __ldg(row_ptr + node + 1);
  float acc = 0.0f;
  for (int i = begin; i < end; ++i) acc += __ldg(f + (int64_t)__ldg(node_rows + i) * s + c);
  out[t] = acc;
}

unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  All arrays are
// contiguous device arrays: u f32 [N, s], nodes int32 [rows_total],
// block_rows int32 [rows_total / rows_per_block], out f32 [rows_total, s]
// (gather); f f32 [rows, s], row_ptr int32 [num_nodes + 1], node_rows int32
// [row_ptr[num_nodes]], out f32 [num_nodes, s] (scatter).  Each returns
// cudaGetLastError() after its launch (0 = success); the gather returns
// cudaErrorInvalidValue without launching when rows_total * s >= 2^31 or
// rows_total is not a multiple of rows_per_block, or rows_per_block
// exceeds 65535 tiles.

extern "C" int fenris_banded_gather(const void* u, const void* nodes, const void* block_rows,
                                    void* out, long long rows_total, int rows_per_block, int s,
                                    void* stream) {
  if (rows_total == 0) return 0;
  if (rows_per_block <= 0 || s <= 0 || rows_total % rows_per_block != 0 ||
      rows_total * s >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(rows_total / rows_per_block),
                  (unsigned int)((rows_per_block + kGatherTile - 1) / kGatherTile));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)nodes % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (s == 3 && rows_per_block % kRowsPerThread == 0 && aligned) {
    banded_gather_kernel<3><<<grid, kThreads, 0, st>>>(
        (const float*)u, (const int32_t*)nodes, (const int32_t*)block_rows, (float*)out,
        rows_per_block, s);
  } else {
    banded_gather_kernel<0><<<grid, kThreads, 0, st>>>(
        (const float*)u, (const int32_t*)nodes, (const int32_t*)block_rows, (float*)out,
        rows_per_block, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int fenris_banded_scatter(const void* f, const void* row_ptr, const void* node_rows,
                                     void* out, long long num_nodes, int s, void* stream) {
  const int64_t n = (int64_t)num_nodes * s;
  if (n == 0) return 0;
  banded_scatter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (const int32_t*)row_ptr, (const int32_t*)node_rows, (float*)out,
      num_nodes, s);
  return (int)cudaGetLastError();
}
