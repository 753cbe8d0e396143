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
// would add in a different order on every run (CG would drift).  Here the
// gather is one thread per output value, reading its row's int32 node index
// (s threads read the same index, one L1 line) and writing coalesced; the
// scatter is one thread per (node, component) that walks its rows in
// ascending order and writes once, with no atomics, so repeats are bitwise
// equal and equal to the plain version's layered index_add_.
// What bounds them on the H100: bytes.  The gather reads 4 B of index and
// writes 4 s B per row (u itself, 4 s B per node, mostly hits L2); the
// scatter reads 4 s B of element data and 4 B of row index per row, the
// element reads landing in 32 B sectors of which it uses 4 s B.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    banded_gather_kernel(const float* __restrict__ u, const int32_t* __restrict__ nodes,
                         const int32_t* __restrict__ block_rows, float* __restrict__ out,
                         int64_t rows_total, int rows_per_block, int s) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows_total * s) return;
  const int64_t r = t / s;
  const int c = (int)(t - r * s);
  const int64_t k = r / rows_per_block;
  const float valid = (r - k * rows_per_block) < __ldg(block_rows + k) ? 1.0f : 0.0f;
  out[t] = __ldg(u + (int64_t)__ldg(nodes + r) * s + c) * valid;
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
// cudaGetLastError() after its launch (0 = success).

extern "C" int fenris_banded_gather(const void* u, const void* nodes, const void* block_rows,
                                    void* out, long long rows_total, int rows_per_block, int s,
                                    void* stream) {
  const int64_t n = (int64_t)rows_total * s;
  if (n == 0) return 0;
  banded_gather_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const int32_t*)nodes, (const int32_t*)block_rows, (float*)out,
      rows_total, rows_per_block, s);
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
