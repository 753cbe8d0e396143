// A variant of csrc/stiffness_pairs.cu for measurement only (tools/stiffness_ab.py): the element matrices
// of one contraction pair (Laplace) on the affine elements (tet4, tet10, tet20, tri3, tri6) from the
// reference sums that every element shares, instead of a sum over the points an element.
//
// On a simplex J is the same at every point, so
//   A_e(a, b) = sum_q w_q |det J| G_q[a] . C G_q[b] = sum_{l,l'} K[l][l'] R_ab[l][l'],
//   K = |det J| J^-1 C J^-T,   R_ab[l][l'] = sum_q w_q dphi_q[a][l] dphi_q[b][l'],
// d^2 FMAs a node pair (tet20: 9 where the point sum takes 14 x 3).  A first kernel forms R for the upper
// node pairs from the tables, in the points' order; the second takes 32 elements a warp, forms K once an
// element, and sums each pair the warp owns from R in shared memory (its nodes from a table there),
// storing (a, b) and (b, a) as whole 128-byte runs (st.global.cs).  The same C interface as
// csrc/stiffness_pairs.cu; it returns cudaErrorInvalidValue for anything but one contraction pair on a
// simplex.
//
// Built by tools/stiffness_ab.py as one of its libraries (nvcc -gencode arch=compute_90a,code=sm_90a -O3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <int D>
__global__ void reference_sums(const float* __restrict__ tables, float* __restrict__ R, int m, int n, int q) {
  const float* dphi = tables + q * m * D;
  const float* w = dphi + q * n * D;
  const int pairs = n * (n + 1) / 2;
  for (int it = blockIdx.x * blockDim.x + threadIdx.x; it < pairs * D * D; it += gridDim.x * blockDim.x) {
    const int p = it / (D * D), l = (it / D) % D, l2 = it % D;
    int a = 0, r = p;
    while (r >= n - a) r -= n - a++;
    const int b = a + r;
    float acc = 0.0f;
    for (int qq = 0; qq < q; ++qq) acc = fmaf(w[qq] * dphi[(qq * n + a) * D + l], dphi[(qq * n + b) * D + l2], acc);
    R[it] = acc;
  }
}

template <int D, int N>
__global__ void __launch_bounds__(32 * kWarps) pairs_from_sums(const float* __restrict__ X, const float* __restrict__ tables,
                                                              const float* __restrict__ R, float* __restrict__ out,
                                                              float c00, float c01, float c02, float c10, float c11,
                                                              float c12, float c20, float c21, float c22, int64_t E,
                                                              int64_t ld) {
  constexpr int M = D + 1, P = N * (N + 1) / 2;
  __shared__ float rs[P * D * D];
  __shared__ int ab_of[P];  // pair p's nodes a * N + b
  for (int i = threadIdx.x; i < P * D * D; i += blockDim.x) rs[i] = R[i];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int a = 0, r = p;
    while (r >= N - a) r -= N - a++;
    ab_of[p] = a * N + a + r;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * 32, e = e0 + lane;
  const int64_t ee = e < E ? e : e0;
  float J[D][D] = {};
  for (int mm = 0; mm < M; ++mm)
    for (int a = 0; a < D; ++a) {
      const float x = X[(ee * M + mm) * D + a];
      for (int b = 0; b < D; ++b) J[a][b] = fmaf(__ldg(tables + mm * D + b), x, J[a][b]);
    }
  float Ji[D][D], det;
  if constexpr (D == 2) {
    det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float r = 1.0f / det;
    Ji[0][0] = J[1][1] * r, Ji[0][1] = -J[0][1] * r, Ji[1][0] = -J[1][0] * r, Ji[1][1] = J[0][0] * r;
  } else {
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
    det = J[0][0] * c[0][0] + J[0][1] * c[1][0] + J[0][2] * c[2][0];
    const float r = 1.0f / det;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) Ji[a][b] = c[a][b] * r;
  }
  const float C[3][3] = {{c00, c01, c02}, {c10, c11, c12}, {c20, c21, c22}};
  float K[D][D];  // |det| J^-1 C J^-T
  for (int l = 0; l < D; ++l)
    for (int l2 = 0; l2 < D; ++l2) {
      float acc = 0.0f;
      for (int k = 0; k < D; ++k)
        for (int k2 = 0; k2 < D; ++k2) acc = fmaf(Ji[l][k] * C[k][k2], Ji[l2][k2], acc);
      K[l][l2] = fabsf(det) * acc;
    }
  if (e >= E) return;
  float* o = out + e;
  for (int p = warp; p < P; p += kWarps) {
    const int a = ab_of[p] / N, b = ab_of[p] % N;
    const float* rp = rs + p * D * D;
    float ab = 0.0f, ba = 0.0f;
#pragma unroll
    for (int l = 0; l < D; ++l)
#pragma unroll
      for (int l2 = 0; l2 < D; ++l2) {
        ab = fmaf(K[l][l2], rp[l * D + l2], ab);
        ba = fmaf(K[l2][l], rp[l * D + l2], ba);
      }
    __stcs(o + (int64_t)(a * N + b) * ld, ab);
    if (a != b) __stcs(o + (int64_t)(b * N + a) * ld, ba);
  }
}

template <int D, int N>
int launch(const float* X, const float* t, const float* c, float* out, int64_t E, int64_t ld, int m, int q,
           cudaStream_t st) {
  static float* R = nullptr;
  if (R == nullptr && cudaMalloc(&R, sizeof(float) * N * (N + 1) / 2 * D * D) != cudaSuccess) return 2;
  reference_sums<D><<<8, 256, 0, st>>>(t, R, m, N, q);
  float C[9] = {};
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) C[i * 3 + j] = c[i * D + j];
  pairs_from_sums<D, N><<<(unsigned)((E + 31) / 32), 32 * kWarps, 0, st>>>(
      X, t, R, out, C[0], C[1], C[2], C[3], C[4], C[5], C[6], C[7], C[8], E, ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fenris_stiffness_pairs(const void* X, const void* tables, const void* cf, void* out, long long E,
                                      long long ld, int m, int n, int q, int d, int s, int sym, void* stream) {
  (void)sym;
  if (s != 1 || m != d + 1 || q <= 0) return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  const float* x = (const float*)X;
  const float* t = (const float*)tables;
  const float* c = (const float*)cf;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 3 && n == 4) return launch<3, 4>(x, t, c, o, E, ld, m, q, st);
  if (d == 3 && n == 10) return launch<3, 10>(x, t, c, o, E, ld, m, q, st);
  if (d == 3 && n == 20) return launch<3, 20>(x, t, c, o, E, ld, m, q, st);
  if (d == 2 && n == 3) return launch<2, 3>(x, t, c, o, E, ld, m, q, st);
  if (d == 2 && n == 6) return launch<2, 6>(x, t, c, o, E, ld, m, q, st);
  return (int)cudaErrorInvalidValue;
}
