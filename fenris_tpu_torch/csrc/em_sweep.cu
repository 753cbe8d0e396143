// Fused Neo-Hookean element sweeps on unstructured hex8 elements, for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/ops/em_sweep.py:
//   * em_vector_sweep         (body _vector_kernel)         -> fenris_em_sweep, v == NULL
//   * em_vector_tangent_sweep (body _vector_tangent_kernel) -> fenris_em_sweep, v != NULL
//
// What is computed (the element-minor sweeps of assembly/local_em.py for a
// Neo-Hookean MaterialEllipticOperator with scalar Lame parameters, d = s = 3,
// m = n = 8): for every element e and quadrature point q,
//   J[i][j] = sum_m geo_dphi[q][m][j] (X[m][i][e] - X[0][i][e]),  J^-1, det J by cofactors,
//   gp[a][i] = sum_k dphi[q][a][k] J^-1[k][i],    wdet = w[q] |det J|,
//   G[d][c] = sum_a gp[a][d] u[a][c][e]           (grad u; F = I + G^T),
//   log J = log1p(gamma) from the symbolic expansion det F = 1 + gamma
//           (libdevice log1pf; -inf where gamma <= -1, as the plain version),
//   P = (-mu + lam log J) F^-T + mu F             (vector sweep), or its
//   dP = mu dF + lam tr(F^-1 dF) F^-T - (-mu + lam log J) F^-T dF^T F^-T
//           with dF = (grad v)^T                  (tangent sweep),
//   out[a][c][e] += wdet sum_d gp[a][d] P[c][d]   (P or dP).
// The TPU kernel body is traced from the generic operator code; here the
// material is written out (solid/__init__.py: stress_du, stress_tangent_du).
//
// Design.  One thread per element: its 24 node coordinates, 24 (48) dofs
// and 24 outputs stay in registers through the q loop; the basis tables
// (geo_dphi [q][8][3], dphi [q][8][3], w [q]) sit in shared memory, read as
// broadcasts.  Inputs and output are element-minor views [node][comp][E]
// with arbitrary strides: element-minor arrays read coalesced, and the
// element-major rows of the banded gather (strides 3, 1, 24) are read
// without a transposing copy.  No reduction across threads, so results are
// bitwise reproducible.
// What bounds it on the H100: about 5.6k (vector) and 7.8k (tangent) f32
// operations per element against 288 (384) bytes of inputs and outputs per
// element, which puts the two limits close together (~20 operations per
// byte at 67 TFLOP/s and 3.35 TB/s).  Register pressure is the design risk:
// read `-Xptxas -v` in _build/build.log for spills.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTab = 2 * 8 * 3 + 1;  // floats of the tables per quadrature point

struct Strides {  // [node][comp][element] strides, in floats
  int64_t x[3], u[3], v[3], o[3];
};

__device__ __forceinline__ void load_nodes(const float* __restrict__ a, const int64_t* st,
                                           int64_t e, float A[8][3]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 3; ++c) A[n][c] = __ldg(a + n * st[0] + c * st[1] + e * st[2]);
}

// Physical basis gradients gp[a][i] and wdet at one quadrature point.  X
// holds the coordinates relative to node 0 (X[0] = 0; the columns of gd sum
// to zero, so J is unchanged and keeps its f32 digits when the coordinates
// are large against the element size).
__device__ __forceinline__ float geometry(const float* gd, const float* dp, float w,
                                          const float X[8][3], float gp[8][3]) {
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = gd[3 + j] * X[1][i];
#pragma unroll
      for (int m = 2; m < 8; ++m) acc += gd[m * 3 + j] * X[m][i];
      J[i][j] = acc;
    }
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
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      gp[a][i] = (dp[a * 3 + 0] * c[0][i] + dp[a * 3 + 1] * c[1][i] + dp[a * 3 + 2] * c[2][i]) * r;
  return w * fabsf(det);
}

// G[d][c] = sum_a gp[a][d] U[a][c]
__device__ __forceinline__ void gradient(const float gp[8][3], const float U[8][3],
                                         float G[3][3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = gp[0][d] * U[0][c];
#pragma unroll
      for (int a = 1; a < 8; ++a) acc += gp[a][d] * U[a][c];
      G[d][c] = acc;
    }
}

// F = I + G^T, F^-T and alpha = -mu + lam log J (log J log1p-stable).
__device__ __forceinline__ float kinematics(const float G[3][3], float mu, float lam,
                                            float F[3][3], float FinvT[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = G[j][i] + (i == j ? 1.0f : 0.0f);
  const float a = G[0][0], b = G[1][0], c = G[2][0];
  const float d = G[0][1], e = G[1][1], f = G[2][1];
  const float g = G[0][2], h = G[1][2], i = G[2][2];
  const float gamma = (a + e + i) + (a * e - b * d + a * i - c * g + e * i - f * h) +
                      (a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g));
  const float logJ = gamma > -1.0f ? log1pf(gamma) : -INFINITY;
  // adjugate of F; F^-T[i][j] = adj[j][i] / det F
  float adj[3][3];
  adj[0][0] = F[1][1] * F[2][2] - F[1][2] * F[2][1];
  adj[0][1] = F[0][2] * F[2][1] - F[0][1] * F[2][2];
  adj[0][2] = F[0][1] * F[1][2] - F[0][2] * F[1][1];
  adj[1][0] = F[1][2] * F[2][0] - F[1][0] * F[2][2];
  adj[1][1] = F[0][0] * F[2][2] - F[0][2] * F[2][0];
  adj[1][2] = F[0][2] * F[1][0] - F[0][0] * F[1][2];
  adj[2][0] = F[1][0] * F[2][1] - F[1][1] * F[2][0];
  adj[2][1] = F[0][1] * F[2][0] - F[0][0] * F[2][1];
  adj[2][2] = F[0][0] * F[1][1] - F[0][1] * F[1][0];
  const float detF = F[0][0] * adj[0][0] + F[0][1] * adj[1][0] + F[0][2] * adj[2][0];
  const float rdet = 1.0f / detF;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) FinvT[r][k] = adj[k][r] * rdet;
  return -mu + lam * logJ;
}

// out[a][c] += wdet sum_d gp[a][d] S[c][d]
__device__ __forceinline__ void contract(const float gp[8][3], const float S[3][3], float wdet,
                                         float out[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[a][c] += wdet * (gp[a][0] * S[c][0] + gp[a][1] * S[c][1] + gp[a][2] * S[c][2]);
}

template <bool TANGENT>
__global__ void __launch_bounds__(kThreads)
    em_sweep_kernel(const float* __restrict__ X, const float* __restrict__ u,
                    const float* __restrict__ v, float* __restrict__ out, const Strides st,
                    int64_t E, const float* __restrict__ tables, int q, float mu, float lam) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < q * kTab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= E) return;
  float Xe[8][3], U[8][3], V[8][3], f[8][3];
  load_nodes(X, st.x, e, Xe);
#pragma unroll
  for (int m = 1; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 3; ++i) Xe[m][i] -= Xe[0][i];
  load_nodes(u, st.u, e, U);
  if (TANGENT) load_nodes(v, st.v, e, V);
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) f[a][c] = 0.0f;
#pragma unroll 1
  for (int iq = 0; iq < q; ++iq) {
    float gp[8][3];
    const float wdet = geometry(tab + iq * 24, tab + q * 24 + iq * 24, tab[q * 48 + iq], Xe, gp);
    float G[3][3], F[3][3], FinvT[3][3], S[3][3];
    gradient(gp, U, G);
    const float alpha = kinematics(G, mu, lam, F, FinvT);
    if (!TANGENT) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) S[i][j] = alpha * FinvT[i][j] + mu * F[i][j];
    } else {
      float dG[3][3];
      gradient(gp, V, dG);
      // dF = dG^T; tr(F^-1 dF) = sum_ij F^-T[j][i] dF[j][i]
      float dlogJ = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) dlogJ += FinvT[i][j] * dG[j][i];
      // M = F^-T dF^T, M[i][l] = sum_k F^-T[i][k] dF[l][k] = sum_k F^-T[i][k] dG[k][l]
      float M[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l)
          M[i][l] = FinvT[i][0] * dG[0][l] + FinvT[i][1] * dG[1][l] + FinvT[i][2] * dG[2][l];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float dFinvT =
              -(M[i][0] * FinvT[0][j] + M[i][1] * FinvT[1][j] + M[i][2] * FinvT[2][j]);
          S[i][j] = mu * dG[j][i] + lam * dlogJ * FinvT[i][j] + alpha * dFinvT;
        }
    }
    contract(gp, S, wdet, f);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[a * st.o[0] + c * st.o[1] + e * st.o[2]] = f[a][c];
}

}  // namespace

// Launcher with a plain C interface (loaded with ctypes).  X f32 [8, 3, E],
// u, v (NULL for the vector sweep) and out f32 [8, 3, E], all device arrays
// with the element-minor strides given in the host array strides[12]
// (X, u, v, out; each node, component, element); tables a device f32 array
// [q * 49]: geo_dphi [q][8][3], dphi [q][8][3], weights [q].  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int fenris_em_sweep(const void* X, const void* u, const void* v, void* out,
                               const long long* strides, long long E, const void* tables, int q,
                               float mu, float lam, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.u[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  if (E == 0) return 0;
  const unsigned int blocks = (unsigned int)((E + kThreads - 1) / kThreads);
  const size_t smem = (size_t)q * kTab * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (v != nullptr) {
    em_sweep_kernel<true><<<blocks, kThreads, smem, s>>>(
        (const float*)X, (const float*)u, (const float*)v, (float*)out, st, E,
        (const float*)tables, q, mu, lam);
  } else {
    em_sweep_kernel<false><<<blocks, kThreads, smem, s>>>(
        (const float*)X, (const float*)u, nullptr, (float*)out, st, E, (const float*)tables, q,
        mu, lam);
  }
  return (int)cudaGetLastError();
}
