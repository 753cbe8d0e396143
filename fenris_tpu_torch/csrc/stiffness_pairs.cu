// Constant-contraction element stiffness matrices (component-pair layout) for sm_90a.
//
// Replaces the Pallas TPU kernel fenris_tpu/ops/stiffness_kernel.py:
//   * stiffness_pairs_pallas (body _kernel) -> fenris_stiffness_pairs
//
// What is computed (identical to the TPU kernel): for operators whose
// contraction tensor D is independent of grad u, of position and of the
// element (Laplace, linear elasticity with scalar parameters), element e's
// matrix in the layout out[i*s + j][a*n + b][e] = A_e((a, i), (b, j)):
//   per quadrature point q: J[a][b] = sum_m X[e][m][a] gd[q][m][b], J^-1, det;
//   lhs[(a*d + b)*Q + q] = sum_k (J^-1[a][k] w_q |det|) sum_m C[k][m] J^-1[b][m],
//     C the contraction scalars of the pair (i, j) (the Ft-pair average for
//     symmetric operators);
//   block (i, j) = Wc^T lhs with the reference projector
//     Wc[(a*d + b)*Q + q][n*n_ + p] = dphi[q][n][a] dphi[q][p][b].
// For symmetric operators only the upper pairs are computed; the mirror
// block (j, i) is written as the node transpose of block (i, j), as the
// TPU kernel does.
//
// Design: one thread per element, 64 elements per block.  The block stages
// its constants (gd, w, the pair scalars C and the [d*d*Q, n*n] projector:
// 18 KB for hex8) and its elements' coordinates in shared memory; each
// thread keeps its lhs column in shared memory ([d*d*Q][64], conflict-free
// because neighbouring threads use neighbouring words) and forms the
// projector product with f32 FMAs, four outputs at a time against float4
// broadcast reads of the projector.  Writes are coalesced: neighbouring
// threads write neighbouring elements of each output row.  No tensor cores
// (TF32 would lose the f32 accuracy the JAX package pins).
// What bounds it on the H100: per hex8 element of linear elasticity, 6
// pairs x 72 x 64 = 27.6k FMAs against 2.3 KB of output, so about 12 flops
// per byte: near the f32 ridge, and in this simple form limited by the
// shared-memory reads of the projector product (one lhs read and one
// float4 projector read per four FMAs).  Generic in (m, n, Q, d, s) with
// d in {2, 3}, as the TPU kernel is; the projector must fit shared memory
// beside the per-thread columns, which holds for hex8 and quad4 but not for
// hex20 (27 points, a 389 KB projector) -- such elements need a projector
// tiled through shared memory, which is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC
//             (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr size_t kMaxSmem = 232448;  // per block on sm_90

// Closed-form inverse (cofactors over det, as the JAX package's _inv_det);
// returns det.
template <int D>
__device__ __forceinline__ float inv_det(const float (&J)[D][D], float (&Jinv)[D][D]) {
  if constexpr (D == 2) {
    const float det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float r = 1.0f / det;
    Jinv[0][0] = J[1][1] * r;
    Jinv[0][1] = -J[0][1] * r;
    Jinv[1][0] = -J[1][0] * r;
    Jinv[1][1] = J[0][0] * r;
    return det;
  } else {
    static_assert(D == 3, "d must be 2 or 3");
    float c[3][3];
    c[0][0] = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    c[0][1] = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    c[0][2] = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    c[1][0] = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    c[1][1] = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    c[1][2] = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    c[2][0] = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    c[2][1] = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    c[2][2] = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float det = J[0][0] * c[0][0] + J[0][1] * c[1][0] + J[0][2] * c[2][0];
    const float r = 1.0f / det;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) Jinv[a][b] = c[a][b] * r;
    return det;
  }
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared floats: constants (padded to 4), coordinates [m*d][T], lhs [d*d*Q][T].
__host__ __device__ __forceinline__ size_t smem_floats(int m, int q, int d, int nconst) {
  return (size_t)round4(nconst) + (size_t)m * d * kThreads + (size_t)d * d * q * kThreads;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    stiffness_pairs_kernel(const float* __restrict__ X, const float* __restrict__ consts,
                           float* __restrict__ out, int64_t E, int m, int n, int q, int s,
                           int sym, int w_off, int cf_off, int wc_off, int nconst) {
  extern __shared__ __align__(16) float smem[];
  const int md = m * D;
  float* xs = smem + round4(nconst);
  float* lhs = xs + md * kThreads;
  const int tid = threadIdx.x;
  for (int k = tid; k < nconst; k += kThreads) smem[k] = consts[k];
  const int64_t e0 = (int64_t)blockIdx.x * kThreads;
  // coalesced copy of the block's [T, m*d] coordinates, transposed to
  // [m*d][T]; a ragged last block repeats its first element
  for (int k = tid; k < kThreads * md; k += kThreads) {
    const int el = k / md, c = k - el * md;
    xs[c * kThreads + el] = X[(e0 + el < E) ? e0 * md + k : e0 * md + c];
  }
  __syncthreads();

  const float* gd = smem;  // [Q][m][D]
  const float* w = smem + w_off;
  const float* cf = smem + cf_off;
  const float* wc = smem + wc_off;  // [D*D*Q][n*n], 16-byte aligned
  const int K = D * D * q;
  const int nn2 = n * n;
  const int64_t e = e0 + tid;
  const bool valid = e < E;
  int pu = 0;
  for (int i = 0; i < s; ++i) {
    for (int j = sym ? i : 0; j < s; ++j, ++pu) {
      const float* C = cf + pu * D * D;
      for (int qq = 0; qq < q; ++qq) {
        float J[D][D], Jinv[D][D];
#pragma unroll
        for (int a = 0; a < D; ++a) {
#pragma unroll
          for (int b = 0; b < D; ++b) {
            float acc = 0.0f;
            for (int mm = 0; mm < m; ++mm)
              acc = fmaf(gd[(qq * m + mm) * D + b], xs[(mm * D + a) * kThreads + tid], acc);
            J[a][b] = acc;
          }
        }
        const float wdet = w[qq] * fabsf(inv_det<D>(J, Jinv));
        float t[D][D];  // t[k][b] = sum_m C[k][m] Jinv[b][m]
#pragma unroll
        for (int k = 0; k < D; ++k)
#pragma unroll
          for (int b = 0; b < D; ++b) {
            float acc = 0.0f;
#pragma unroll
            for (int mm = 0; mm < D; ++mm) acc = fmaf(C[k * D + mm], Jinv[b][mm], acc);
            t[k][b] = acc;
          }
#pragma unroll
        for (int a = 0; a < D; ++a)
#pragma unroll
          for (int b = 0; b < D; ++b) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < D; ++k) acc = fmaf(Jinv[a][k] * wdet, t[k][b], acc);
            lhs[((a * D + b) * q + qq) * kThreads + tid] = acc;
          }
      }
      if (!valid) continue;
      float* up = out + (int64_t)(i * s + j) * nn2 * E + e;
      float* lo = out + (int64_t)(j * s + i) * nn2 * E + e;
      const bool mirror = sym && i != j;
      if ((nn2 & 3) == 0) {
        for (int nb = 0; nb < nn2; nb += 4) {
          float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
          for (int k = 0; k < K; ++k) {
            const float l = lhs[k * kThreads + tid];
            const float4 wv = *reinterpret_cast<const float4*>(wc + k * nn2 + nb);
            r0 = fmaf(wv.x, l, r0);
            r1 = fmaf(wv.y, l, r1);
            r2 = fmaf(wv.z, l, r2);
            r3 = fmaf(wv.w, l, r3);
          }
          const float r[4] = {r0, r1, r2, r3};
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            const int ab = nb + t4;
            up[(int64_t)ab * E] = r[t4];
            if (mirror) lo[(int64_t)((ab % n) * n + ab / n) * E] = r[t4];
          }
        }
      } else {
        for (int ab = 0; ab < nn2; ++ab) {
          float r = 0.0f;
          for (int k = 0; k < K; ++k) r = fmaf(wc[k * nn2 + ab], lhs[k * kThreads + tid], r);
          up[(int64_t)ab * E] = r;
          if (mirror) lo[(int64_t)((ab % n) * n + ab / n) * E] = r;
        }
      }
    }
  }
}

template <int D>
int launch(const float* X, const float* consts, float* out, int64_t E, int m, int n, int q,
           int s, int sym, int w_off, int cf_off, int wc_off, int nconst, cudaStream_t stream) {
  const size_t bytes = smem_floats(m, q, D, nconst) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stiffness_pairs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)((E + kThreads - 1) / kThreads);
  stiffness_pairs_kernel<D><<<blocks, kThreads, bytes, stream>>>(
      X, consts, out, E, m, n, q, s, sym, w_off, cf_off, wc_off, nconst);
  return (int)cudaGetLastError();
}

}  // namespace

// X: f32 [E, m, d] element coordinates; consts: f32 device buffer
// [gd (Q*m*d) | w (Q) at w_off | C (P*d*d) at cf_off | Wc (d*d*Q*n*n) at
// wc_off, wc_off a multiple of 4], nconst floats in all; out: f32
// [s*s, n*n, E].  All contiguous, on the card.  Returns cudaGetLastError()
// after the launch (0 = success); d outside {2, 3} or a shared-memory need
// beyond the block limit returns cudaErrorInvalidValue without launching.
extern "C" int fenris_stiffness_pairs(const void* X, const void* consts, void* out, long long E,
                                      int m, int n, int q, int d, int s, int sym, int w_off,
                                      int cf_off, int wc_off, int nconst, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem_floats(m, q, d, nconst) * sizeof(float) > kMaxSmem || (wc_off & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  const float* x = (const float*)X;
  const float* c = (const float*)consts;
  float* o = (float*)out;
  switch (d) {
    case 2: return launch<2>(x, c, o, (int64_t)E, m, n, q, s, sym, w_off, cf_off, wc_off, nconst, st);
    case 3: return launch<3>(x, c, o, (int64_t)E, m, n, q, s, sym, w_off, cf_off, wc_off, nconst, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
