// Block-DIA band-sweep SpMV for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/sparse/dia_kernel.py:
//   * packed_dia_matvec_wm (body _sweep_kernel_w, the windowed sweep)  -> fenris_dia_sweep
//   * packed_dia_matvec_cm (body _sweep_kernel, the staged fallback)    -> the same kernel
//
// What is computed: the component-major product of an assembled block-DIA
// operator,
//     y2[i][n] = sum_d sum_j bands[(d*s + i)*s + j][n] * x2[j][n + offsets[d]],
// with x2 read as zero outside [0, N).  The band stack is taken exactly as
// assemble_block_dia lays it out ([D*s*s, N], node axis minor): the TPU
// packing (8-sublane row padding, lane chunks, the VMEM halo window) is TPU
// layout and there is no pack copy per Newton step.
//
// Design: one thread per node.  Consecutive threads read consecutive lanes
// of each band row, so every band load is coalesced, and the shifted x
// reads of neighbouring threads fall on neighbouring addresses (x is 40 MB
// at 10M dofs, inside the 50 MB L2, so its D-fold reuse is served from
// cache).  The sum runs in the plain version's order (d, then j) with one
// FMA per term, so kernel and plain differ by FMA rounding only.  The
// offsets come in as a small device array and are staged in shared memory
// per block; nothing lives in constant memory, so operators never share state.
// What bounds it on the H100: it reads every band value once, D*s*s*N*4
// bytes (3.28 GB for D = 27, s = 3, N = 3,375,000), against 2 flops per
// value: memory-bound, with a floor of ~1.0 ms per product at 3.35 TB/s.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC
//             (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int S>
__global__ void __launch_bounds__(kThreads)
    dia_sweep_kernel(const float* __restrict__ bands, const int* __restrict__ offsets, int D,
                     const float* __restrict__ x, float* __restrict__ y, int64_t N) {
  extern __shared__ int soff[];
  for (int t = threadIdx.x; t < D; t += blockDim.x) soff[t] = offsets[t];
  __syncthreads();
  const int64_t n = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const int64_t c = n + soff[d];
    const bool inside = c >= 0 && c < N;
    const float* brow = bands + (int64_t)d * S * S * N + n;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float xv = inside ? __ldg(x + j * N + c) : 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) acc[i] = fmaf(__ldg(brow + (int64_t)(i * S + j) * N), xv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) y[i * N + n] = acc[i];
}

template <int S>
int launch(const float* bands, const int* offsets, int D, const float* x, float* y, int64_t N,
           cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((N + kThreads - 1) / kThreads);
  dia_sweep_kernel<S><<<blocks, kThreads, D * sizeof(int), stream>>>(bands, offsets, D, x, y, N);
  return (int)cudaGetLastError();
}

}  // namespace

// bands: f32 [D*s*s, N]; offsets: int32 [D] on the device; x, y: f32 [s, N];
// all contiguous, on the card.  s in {1, 2, 3}.  Returns cudaGetLastError()
// after the launch (0 = success); an unsupported s returns
// cudaErrorInvalidValue without launching.
extern "C" int fenris_dia_sweep(const void* bands, const void* offsets, int D, const void* x,
                                void* y, long long N, int s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bands;
  const int* o = (const int*)offsets;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  if (N <= 0) return 0;
  switch (s) {
    case 1: return launch<1>(b, o, D, xx, yy, (int64_t)N, st);
    case 2: return launch<2>(b, o, D, xx, yy, (int64_t)N, st);
    case 3: return launch<3>(b, o, D, xx, yy, (int64_t)N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
