// Fused element sweeps on unstructured 3D elements, for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/ops/em_sweep.py:
//   * em_vector_sweep         (body _vector_kernel)         -> fenris_banded_sweep, v == NULL
//                                                              (fused with the banded gather),
//                                                              fenris_em_sweep, v == NULL
//   * em_vector_tangent_sweep (body _vector_tangent_kernel) -> fenris_banded_sweep, v != NULL
//                                                              (fused with the banded gather),
//                                                              fenris_em_sweep, v != NULL
//
// What is computed (the element-minor sweeps of assembly/local_em.py for a
// MaterialEllipticOperator with scalar Lame parameters, d = s = 3, on an
// element of m geometry and n solution nodes: tet4 (m, n) = (4, 4), tet10
// (4, 10), tet20 (4, 20), hex8 (8, 8), hex20 (8, 20), hex27 (8, 27); q
// quadrature points, given at run time): for every element e and point q,
//   J[i][j] = sum_b geo_dphi[q][b][j] (X[b][i][e] - X[0][i][e]),  J^-1, det J by cofactors,
//   wdet = w[q] |det J|,  gp[a][d] = sum_k dphi[q][a][k] J^-1[k][d],
//   G[d][c] = sum_a gp[a][d] u[a][c][e] = sum_k J^-1[k][d] H[k][c],
//           H[k][c] = sum_a dphi[q][a][k] u[a][c][e]   (the reference gradient),
//   F = I + G^T, and the first Piola-Kirchhoff stress P (vector sweep) or its
//   derivative dP along dF = (grad v)^T (tangent sweep), solid/__init__.py's
//   stress_du and stress_tangent_du:
//     Neo-Hookean:  P = alpha F^-T + mu F, alpha = -mu + lam log J, log J =
//                   log1p(gamma) from the symbolic expansion det F = 1 + gamma
//                   (libdevice log1pf; -inf where gamma <= -1, as the plain version);
//                   dP = mu dF + lam tr(F^-1 dF) F^-T - alpha F^-T dF^T F^-T;
//     StVK:         E = (F^T F - I) / 2, S = 2 mu E + lam tr(E) I, P = F S;
//                   dE = sym(F^T dF), dP = dF S + F (2 mu dE + lam tr(dE) I);
//     linear:       P = mu (G + G^T) + lam tr(G) I; dP the same of grad v, so
//                   the linear tangent sweep does not read u at all;
//   out[a][c][e] += wdet sum_d gp[a][d] P[c][d] = sum_k dphi[q][a][k] T[k][c],
//           T[k][c] = wdet sum_d J^-1[k][d] P[c][d]   (P or dP).
//
// One body, sweep_kernel<BANDED, TANGENT, M, N, MAT>, serves all four
// launchers, the six elements and the three materials.  Blocks are one warp;
// L lanes share an element, a tile is 32 / L elements:
//   * hex8 (L = 8, the path the matrix-free solve at 10M dofs runs): lane l
//     takes quadrature points l, l + 8, ..., computing gp[8][3] and its 24
//     partial outputs, and the 8 lanes reduce them by a fixed reduce-scatter
//     of __shfl_xor_sync (xor 4, 2, 1; 21 shuffles), after which lane l holds
//     node l's 3 sums.  80 registers under the launch bound of 24 blocks an
//     SM (20 blocks, 96 registers, for the strided sweeps, which spill at 80);
//   * the others (L = 4 for tet4 and tet10, 8 for tet20, hex20, hex27): an
//     n x 3 partial output a lane (60 floats at hex20, 81 at hex27) would
//     spill, so each element's work is split twice.  Lanes take its points
//     (l, l + L, ...), and each writes its point's T (9 floats) to shared
//     memory, with no gp: both gradients come from the reference gradient H
//     (9 sums over the n nodes).  Then lanes take its nodes (a = l, l + L,
//     ...) and each sums its nodes' 3 outputs over all q points in point
//     order, reading each point's T once: no lane holds n x 3 sums and no
//     shuffle reduce is needed.  A
//     table row is read as float4 per node ([q][geo_dphi 3m | dphi n x 4 | w],
//     rows an odd number of float4 apart: lanes at different points read
//     distinct bank groups; lanes at different nodes consecutive float4);
//     u and v are staged [n][4].  Launch bounds of 12 blocks an SM (168
//     registers: the Neo-Hookean tangents spill at 128); shared memory holds
//     the 20- and 27-node elements to 8-15 blocks anyway (tables and T grow
//     with q: 22.7 KB a block at hex20).
//   Both: a block works on tiles, staging X and u (and v) in shared memory
//   with cp.async; the tables sit there re-laid per point; persistent blocks
//   (as many as fit on the card) walk the tiles with a two-stage pipeline:
//   the next tile's copies, and the node indices of the one after, are in
//   flight while the current tile computes;
//   * banded mode (fenris_banded_sweep): u and v are read straight from the
//     node vectors through the plan's row -> node table, so the gather's rows
//     never go to device memory; padding elements' rows are zeros.  hex8:
//     lane l copies node l of its element, and padding elements read nothing
//     (their u and v are zero-filled, as the banded gather gives them); the
//     others: consecutive threads copy consecutive words of the tile's
//     (element, node, component) run, 3 threads a node (a copy instruction
//     touches about a third of the lines lanes copying whole nodes would),
//     and padding rows read node 0, whose values nothing uses.  X is the padded
//     element-minor geometry [3m][E_pad], read as contiguous runs of each
//     row a tile.  The output, element-major rows [E_pad][n][3], is a tile's
//     one contiguous run, written from shared memory with float4 stores;
//   * strided mode (fenris_em_sweep): element-minor views with any strides
//     (32-bit offsets) in and out, the same body;
//   * no atomics: every sum is taken in one fixed order, so two launches are
//     bitwise equal.  hex8 differs from the plain version only in the order
//     of its sums, the others also in taking the gradients through H and the
//     contraction through T: f32 roundoff either way.
// What bounds it on the H100: f32 operations for the hex elements (hex8:
// about 7.5k (tangent) or 5.4k (vector) an element; hex20 about 1,600 a point
// at 27 points), bytes for the tets (tet10: X 48, node indices 40 and rows
// out 120 bytes an element, u and v once a node; the copies gather 240 bytes
// an element of u and v from L2).  Register pressure is the design risk:
// read `-Xptxas -v` in the library's log, _build/libfenris_kernels_<hash>.log,
// for registers and spills.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
// -fPIC, once per element (-DFENRIS_EM_ELEMENT=0..5, all started together;
// part 0 also holds the launchers), then linked into the shared library (see
// fenris_tpu_torch/ops/_build.py).  Without FENRIS_EM_ELEMENT the one
// translation unit instantiates every element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

struct Strides32 {  // [node][comp][element] strides, in floats; every offset < 2^31
  int x[3], u[3], v[3], o[3];
};

namespace {

enum : int { kNeoHookean = 0, kStVK = 1, kLinear = 2 };  // the launchers' material codes

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// x (a multiple of 4) made an odd number of float4: rows this far apart fall
// in distinct groups of 4 banks for 8 lanes
__host__ __device__ constexpr int odd4(int x) { return (x / 4) % 2 ? x : x + 4; }

// -- materials ---------------------------------------------------------------------

// hex8: physical basis gradients gp[a][i] and wdet at one quadrature point.  X
// holds the coordinates relative to node 0, [m][i] (X[0] is not read; the
// columns of gd sum to zero, so J is unchanged and keeps its f32 digits when
// the coordinates are large against the element size).
__device__ __forceinline__ float geometry(const float* gd, const float* dp, float w,
                                          const float* X, float gp[8][3]) {
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = gd[3 + j] * X[3 + i];
#pragma unroll
      for (int m = 2; m < 8; ++m) acc += gd[m * 3 + j] * X[m * 3 + i];
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

// hex8: G[d][c] = sum_a gp[a][d] U[a][c], U given as [a][c]
__device__ __forceinline__ void gradient(const float gp[8][3], const float* U, float G[3][3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = gp[0][d] * U[c];
#pragma unroll
      for (int a = 1; a < 8; ++a) acc += gp[a][d] * U[a * 3 + c];
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

// dP = mu dF + lam tr(F^-1 dF) F^-T - alpha F^-T dF^T F^-T, dF = dG^T
__device__ __forceinline__ void tangent_stress(const float FinvT[3][3], const float dG[3][3],
                                               float mu, float lam, float alpha, float S[3][3]) {
  // tr(F^-1 dF) = sum_ij F^-T[j][i] dF[j][i]
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
      const float dFinvT = -(M[i][0] * FinvT[0][j] + M[i][1] * FinvT[1][j] + M[i][2] * FinvT[2][j]);
      S[i][j] = mu * dG[j][i] + lam * dlogJ * FinvT[i][j] + alpha * dFinvT;
    }
}

// A material at one point: at(G) takes the displacement gradient G[d][c]
// (F = I + G^T), then stress() gives P[i][j] and tangent(dG) gives dP along
// dF = dG^T.  kTangentReadsU: whether the tangent depends on u.
template <int MAT>
struct Material;

template <>
struct Material<kNeoHookean> {
  static constexpr bool kTangentReadsU = true;
  float F[3][3], FinvT[3][3], alpha;
  __device__ __forceinline__ void at(const float G[3][3], float mu, float lam) {
    alpha = kinematics(G, mu, lam, F, FinvT);
  }
  __device__ __forceinline__ void stress(float mu, float lam, float P[3][3]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = alpha * FinvT[i][j] + mu * F[i][j];
  }
  __device__ __forceinline__ void tangent(const float dG[3][3], float mu, float lam, float dP[3][3]) const {
    tangent_stress(FinvT, dG, mu, lam, alpha, dP);
  }
};

template <>
struct Material<kStVK> {
  static constexpr bool kTangentReadsU = true;
  float F[3][3], S[3][3];  // F and the second Piola-Kirchhoff stress S
  __device__ __forceinline__ void at(const float G[3][3], float mu, float lam) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) F[i][j] = G[j][i] + (i == j ? 1.0f : 0.0f);
    float E[3][3];  // (F^T F - I) / 2
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        E[i][j] = 0.5f * (F[0][i] * F[0][j] + F[1][i] * F[1][j] + F[2][i] * F[2][j] - (i == j ? 1.0f : 0.0f));
    const float ltr = lam * (E[0][0] + E[1][1] + E[2][2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) S[i][j] = 2.0f * mu * E[i][j] + (i == j ? ltr : 0.0f);
  }
  __device__ __forceinline__ void stress(float mu, float lam, float P[3][3]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = F[i][0] * S[0][j] + F[i][1] * S[1][j] + F[i][2] * S[2][j];
  }
  __device__ __forceinline__ void tangent(const float dG[3][3], float mu, float lam, float dP[3][3]) const {
    // A = F^T dF, dS = mu (A + A^T) + lam tr(A) I, dP = dF S + F dS
    float A[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = F[0][i] * dG[j][0] + F[1][i] * dG[j][1] + F[2][i] * dG[j][2];
    const float ltr = lam * (A[0][0] + A[1][1] + A[2][2]);
    float dS[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) dS[i][j] = mu * (A[i][j] + A[j][i]) + (i == j ? ltr : 0.0f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dP[i][j] = dG[0][i] * S[0][j] + dG[1][i] * S[1][j] + dG[2][i] * S[2][j] +
                   F[i][0] * dS[0][j] + F[i][1] * dS[1][j] + F[i][2] * dS[2][j];
  }
};

template <>
struct Material<kLinear> {
  static constexpr bool kTangentReadsU = false;
  float G[3][3];
  // P = mu (G + G^T) + lam tr(G) I
  static __device__ __forceinline__ void linear(const float G[3][3], float mu, float lam, float P[3][3]) {
    const float ltr = lam * (G[0][0] + G[1][1] + G[2][2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = mu * (G[i][j] + G[j][i]) + (i == j ? ltr : 0.0f);
  }
  __device__ __forceinline__ void at(const float Gu[3][3], float, float) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) G[i][j] = Gu[i][j];
  }
  __device__ __forceinline__ void stress(float mu, float lam, float P[3][3]) const { linear(G, mu, lam, P); }
  __device__ __forceinline__ void tangent(const float dG[3][3], float mu, float lam, float dP[3][3]) const {
    linear(dG, mu, lam, dP);
  }
};

// -- layouts -----------------------------------------------------------------------

// The tiling of an element of M geometry and N solution nodes.  hex8 keeps
// one quadrature point a lane and the reduce-scatter (kNodeLanes); the
// others split an element's points, then its nodes, over its lanes.
template <int M, int N>
struct Layout {
  static constexpr bool kNodeLanes = M == 8 && N == 8;
  static constexpr int kLanes = (N == 4 || N == 10) ? 4 : 8;  // lanes an element
  static constexpr int kThreads = 32;                            // one warp a block
  static constexpr int kElems = kThreads / kLanes;               // elements a tile
  // banded: the node words a thread stages a tile (hex8: its element's node l; the others: items
  // t, t + 32, ... of the tile's (element, node, component) words)
  static constexpr int kStaged = kNodeLanes ? 1 : (kElems * N * 3 + kThreads - 1) / kThreads;
  static constexpr int kNS = kNodeLanes ? 3 : 4;  // floats a node in the staged u, v and the table's dphi
  // an element's staged floats: X [M][3] (relative to node 0 after staging), u [N][kNS] at kU, v at kV
  static constexpr int kU = 3 * M;
  static constexpr int kV = kU + kNS * N;
  // a table row: geo_dphi [M][3], dphi [N][kNS] at kD, w at kW
  static constexpr int kD = 3 * M;
  static constexpr int kW = kD + kNS * N;
  static constexpr int kTab = odd4(round4(kW + 1));
  static constexpr int kOut = 3 * N;  // an element's output floats
  static constexpr int kOutFloats = round4(kElems * kOut);
  template <bool TANGENT>
  __host__ __device__ static constexpr int elem() {  // shared floats an element in a staging buffer, a multiple of 4
    return round4((TANGENT ? kV + kNS * N : kV) + 1);
  }
  static_assert(kElems * kOut % 4 == 0, "a tile's output run must start 16-byte aligned");
  static_assert(kU % 4 == 0 && kV % 4 == 0 && kD % 4 == 0, "float4 reads need 16-byte offsets");
};

// Launch bounds' blocks an SM: hex8 24 (80 registers, no spills) for the
// banded sweeps, 20 (96) for the strided ones, which spill at 80; the other
// elements 12 (168: their Neo-Hookean tangents spill at 128), which shared
// memory holds to 8-15 blocks at 20 and 27 nodes anyway.
template <bool BANDED, int M, int N>
__host__ __device__ constexpr int sweep_min_blocks() {
  return Layout<M, N>::kNodeLanes ? (BANDED ? 24 : 20) : 12;
}

// Shared memory, each part 16-byte aligned: out [kElems][kOut], two element
// buffers [2][kElems][elem], T [kElems][q][12] (not for hex8), tables [q][kTab].
template <bool TANGENT, int M, int N>
__host__ __device__ constexpr size_t sweep_smem_floats(int q) {
  using Ly = Layout<M, N>;
  return (size_t)Ly::kOutFloats + 2 * (size_t)Ly::kElems * Ly::template elem<TANGENT>() +
         (Ly::kNodeLanes ? 0 : (size_t)Ly::kElems * q * 12) + (size_t)q * Ly::kTab;
}

// Shared-memory reads of K floats as K / 4 float4 (p 16-byte aligned).  hex8:
// each quarter-warp reads one element's words (its 8 lanes broadcast) or, for
// the tables, 8 points' words at a stride of 52 floats, which fall in 8
// distinct groups of 4 banks: no bank conflicts.
template <int K>
__device__ __forceinline__ void lds(const float* p, float a[K]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 x = p4[i];
    a[4 * i] = x.x;
    a[4 * i + 1] = x.y;
    a[4 * i + 2] = x.z;
    a[4 * i + 3] = x.w;
  }
}

// Sum f[8][3] over the 8 lanes of a group (lane l = lane id % 8), leaving
// node l's 3 sums in r: at xor 4 a lane keeps the half of the nodes its lane
// bit 2 selects and adds its partner's copy of it, then bits 1 and 0 (21
// shuffles; each sum is taken once, in a fixed order).
__device__ __forceinline__ void reduce_scatter8(const float f[8][3], int l, float r[3]) {
  const unsigned full = 0xffffffffu;
  const float* fl = &f[0][0];
  const bool b2 = l & 4, b1 = l & 2, b0 = l & 1;
  float h[12], p[6];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float keep = b2 ? fl[12 + j] : fl[j], send = b2 ? fl[j] : fl[12 + j];
    h[j] = keep + __shfl_xor_sync(full, send, 4);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float keep = b1 ? h[6 + j] : h[j], send = b1 ? h[j] : h[6 + j];
    p[j] = keep + __shfl_xor_sync(full, send, 2);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float keep = b0 ? p[3 + j] : p[j], send = b0 ? p[j] : p[3 + j];
    r[j] = keep + __shfl_xor_sync(full, send, 1);
  }
}

// The other elements: J^-1 (J from node-relative X [M][3] and the row's
// geo_dphi [M][3]) and wdet at one point.
template <int M>
__device__ __forceinline__ float inverse_jacobian(const float* gd_row, const float* X_rel, float w,
                                                  float Jinv[3][3]) {
  float gd[3 * M], X[3 * M];
  lds<3 * M>(gd_row, gd);
  lds<3 * M>(X_rel, X);
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = gd[3 + j] * X[3 + i];
#pragma unroll
      for (int b = 2; b < M; ++b) acc += gd[b * 3 + j] * X[b * 3 + i];
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
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) Jinv[k][i] = c[k][i] * r;
  return w * fabsf(det);
}

// G[d][c] = sum_k J^-1[k][d] H[k][c], H[k][c] = sum_a dphi[a][k] U[a][c]
// (dphi and U as [N][4], 16-byte aligned).  The node loop is unrolled by 4
// past 10 nodes: fully unrolled, ptxas hoists its loads and the 20- and
// 27-node Neo-Hookean tangents spill even at 168 registers (and unrolled
// partly, even by its trip count, tet10's spills at 128).
template <int N>
__device__ __forceinline__ void ref_gradient(const float* dphi, const float* U, const float Jinv[3][3],
                                             float G[3][3]) {
  const float4* d4 = reinterpret_cast<const float4*>(dphi);
  const float4* u4 = reinterpret_cast<const float4*>(U);
  float H[3][3];
  {
    const float4 d = d4[0], f = u4[0];
    H[0][0] = d.x * f.x, H[0][1] = d.x * f.y, H[0][2] = d.x * f.z;
    H[1][0] = d.y * f.x, H[1][1] = d.y * f.y, H[1][2] = d.y * f.z;
    H[2][0] = d.z * f.x, H[2][1] = d.z * f.y, H[2][2] = d.z * f.z;
  }
  auto add = [&](int a) {
    const float4 d = d4[a], f = u4[a];
    H[0][0] += d.x * f.x, H[0][1] += d.x * f.y, H[0][2] += d.x * f.z;
    H[1][0] += d.y * f.x, H[1][1] += d.y * f.y, H[1][2] += d.y * f.z;
    H[2][0] += d.z * f.x, H[2][1] += d.z * f.y, H[2][2] += d.z * f.z;
  };
  if constexpr (N > 10) {
#pragma unroll 4
    for (int a = 1; a < N; ++a) add(a);
  } else {
#pragma unroll
    for (int a = 1; a < N; ++a) add(a);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int c = 0; c < 3; ++c) G[d][c] = Jinv[0][d] * H[0][c] + Jinv[1][d] * H[1][c] + Jinv[2][d] * H[2][c];
}

// Asynchronous 4-byte copy global -> shared (cp.async, sm_80+); when valid
// is false nothing is read and a zero is written.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Banded mode: the node indices a thread stages in a tile (Layout::kStaged),
// loaded a tile before the staging that needs them, and whether its element
// g is real (not padding, not past E): iff offset < valid_rows (its row
// offset in its owner block against block_rows[k]); the loads are in flight
// together.
template <int K>
struct LaneNodes {
  int node[K];
  int offset, valid_rows;
  __device__ bool real() const { return offset < valid_rows; }
};

template <int M, int N>
__device__ __forceinline__ LaneNodes<Layout<M, N>::kStaged> lane_nodes(
    int tile, int ntiles, int E, int t, int g, int l, const int32_t* __restrict__ nodes,
    const int32_t* __restrict__ block_rows, int elements_per_block) {
  using Ly = Layout<M, N>;
  LaneNodes<Ly::kStaged> r;
  r.offset = 1;
  r.valid_rows = 0;
#pragma unroll
  for (int j = 0; j < Ly::kStaged; ++j) r.node[j] = 0;
  if (tile >= ntiles) return r;
  const int e = tile * Ly::kElems + g;
  if (e < E) {
    const int k = e / elements_per_block;
    r.offset = (e - k * elements_per_block) * N;
    r.valid_rows = __ldg(block_rows + k);
    if (Ly::kNodeLanes) r.node[0] = __ldg(nodes + e * N + l);
  }
  if (!Ly::kNodeLanes) {  // the tile's rows are one contiguous run of the row -> node table
#pragma unroll
    for (int j = 0; j < Ly::kStaged; ++j) {
      const int i = t + j * Ly::kThreads, row = tile * Ly::kElems * N + i / 3;
      if (i < Ly::kElems * N * 3 && row < E * N) r.node[j] = __ldg(nodes + row);
    }
  }
  return r;
}

// Start the cp.asyncs of one tile's X and u (and v) into buf.  X (and,
// strided, the fields) as (component row, element) pairs, element fastest:
// coalesced on element-minor arrays.  Banded, hex8: lane l copies node l of
// element g, and padding elements are zero-filled without a read (the
// tangent computes their zero rows); the others: thread t copies words t, t
// + 32, ... of the tile's (element, node, component) words, so consecutive
// threads copy one node's 3 words, and padding rows read node 0 (their
// elements' arithmetic is skipped).  Elements past E are zero-filled without
// a read.  READ_U: whether u is staged (not for the linear tangent).
template <bool BANDED, bool TANGENT, bool READ_U, int M, int N>
__device__ __forceinline__ void stage_tile(float* buf, int tile, int E, const float* __restrict__ X,
                                           const float* __restrict__ u, const float* __restrict__ v,
                                           const Strides32& st,
                                           const LaneNodes<Layout<M, N>::kStaged>& ln, int t, int g, int l) {
  using Ly = Layout<M, N>;
  constexpr int kElem = Ly::template elem<TANGENT>(), kE = Ly::kElems, kT = Ly::kThreads;
  const int e0 = tile * kE;
  for (int i = t; i < 3 * M * kE; i += kT) {
    const int row = i / kE, el = i - row * kE;
    const bool ok = e0 + el < E;
    const int e = ok ? e0 + el : 0;
    float* dst = buf + el * kElem + row;
    if (BANDED) {
      cp_async4(dst, X + row * E + e, ok);  // X contiguous [3M][E]
    } else {
      const int m = row / 3, c = row - m * 3;
      cp_async4(dst, X + m * st.x[0] + c * st.x[1] + e * st.x[2], ok);
    }
  }
  if (BANDED && Ly::kNodeLanes) {
    const bool ok = ln.real();
    const int64_t n3 = (int64_t)ln.node[0] * 3;  // node 0 on padding rows: in range, and not read
    float* dst = buf + g * kElem + l * Ly::kNS;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (READ_U) cp_async4(dst + Ly::kU + c, u + n3 + c, ok);
      if (TANGENT) cp_async4(dst + Ly::kV + c, v + n3 + c, ok);
    }
  } else if (BANDED) {
#pragma unroll
    for (int j = 0; j < Ly::kStaged; ++j) {
      const int i = t + j * kT;
      if (i < kE * N * 3) {
        const int el = i / (3 * N), w = i - el * 3 * N, a = w / 3, c = w - a * 3;
        const bool ok = e0 + el < E;
        const int64_t src = (int64_t)ln.node[j] * 3 + c;
        float* dst = buf + el * kElem + a * Ly::kNS + c;
        if (READ_U) cp_async4(dst + Ly::kU, u + src, ok);
        if (TANGENT) cp_async4(dst + Ly::kV, v + src, ok);
      }
    }
  } else {
    for (int i = t; i < 3 * N * kE; i += kT) {
      const int row = i / kE, el = i - row * kE;
      const bool ok = e0 + el < E;
      const int e = ok ? e0 + el : 0;
      const int a = row / 3, c = row - a * 3;
      float* dst = buf + el * kElem + a * Ly::kNS + c;
      if (READ_U) cp_async4(dst + Ly::kU, u + a * st.u[0] + c * st.u[1] + e * st.u[2], ok);
      if (TANGENT) cp_async4(dst + Ly::kV, v + a * st.v[0] + c * st.v[1] + e * st.v[2], ok);
    }
  }
}

// hex8: the tile's element g, lane l taking points l, l + 8, ...; node l's
// outputs to o[l * 3 + c].
template <bool TANGENT, int MAT>
__device__ __forceinline__ void hex8_element(const float* el, const float* s_tab, int q, int l, bool work,
                                             float mu, float lam, float* o) {
  using Ly = Layout<8, 8>;
  constexpr bool kReadU = !TANGENT || Material<MAT>::kTangentReadsU;
  // rounds of 8 quadrature points, one a lane; each round's 24 partial
  // outputs are reduced over the lanes at once, so only node l's 3 sums
  // stay live from round to round
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const int rounds = (q + 7) / 8;
#pragma unroll 1
  for (int round = 0; round < rounds; ++round) {
    const int iq = round * 8 + l;
    float f[8][3];
    if (work && iq < q) {
      const float* tq = s_tab + iq * Ly::kTab;
      float gd[24], dp[24], A[24], gp[8][3];
      lds<24>(tq, gd);
      lds<24>(tq + Ly::kD, dp);
      lds<24>(el, A);  // X relative to node 0
      const float wdet = geometry(gd, dp, tq[Ly::kW], A, gp);
      float G[3][3], S[3][3];
      Material<MAT> mat;
      if (kReadU) {
        lds<24>(el + Ly::kU, A);  // u
        gradient(gp, A, G);
        mat.at(G, mu, lam);
      }
      if (TANGENT) {
        lds<24>(el + Ly::kV, A);  // v
        gradient(gp, A, G);
        mat.tangent(G, mu, lam, S);
      } else {  // the weight after the sum: the sum cancels to O(strain) at small strains
        mat.stress(mu, lam, S);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) S[i][j] *= wdet;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) f[a][c] = gp[a][0] * S[c][0] + gp[a][1] * S[c][1] + gp[a][2] * S[c][2];
    } else {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) f[a][c] = 0.0f;
    }
    float r[3];
    reduce_scatter8(f, l, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += r[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o[l * 3 + c] = acc[c];
}

// The other elements: the tile's element g, lanes taking its points (T to
// sT [q][12]), then its nodes (outputs to o[a * 3 + c]).
template <bool TANGENT, int M, int N, int MAT>
__device__ __forceinline__ void split_element(const float* el, const float* s_tab, float* sT, int q, int l,
                                              bool work, float mu, float lam, float* o) {
  using Ly = Layout<M, N>;
  constexpr int L = Ly::kLanes;
  constexpr bool kReadU = !TANGENT || Material<MAT>::kTangentReadsU;
  if (work) {
#pragma unroll 1
    for (int iq = l; iq < q; iq += L) {
      const float* tq = s_tab + iq * Ly::kTab;
      float Jinv[3][3], G[3][3], S[3][3];
      const float wdet = inverse_jacobian<M>(tq, el, tq[Ly::kW], Jinv);
      Material<MAT> mat;
      if (kReadU) {
        ref_gradient<N>(tq + Ly::kD, el + Ly::kU, Jinv, G);
        mat.at(G, mu, lam);
      }
      if (TANGENT) {
        ref_gradient<N>(tq + Ly::kD, el + Ly::kV, Jinv, G);
        mat.tangent(G, mu, lam, S);
      } else {
        mat.stress(mu, lam, S);
      }
      // T[k][c] = wdet sum_d J^-1[k][d] P[c][d], one float4 a row k
      float4* T4 = reinterpret_cast<float4*>(sT + iq * 12);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float t[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = wdet * (Jinv[k][0] * S[c][0] + Jinv[k][1] * S[c][1] + Jinv[k][2] * S[c][2]);
        T4[k] = make_float4(t[0], t[1], t[2], 0.0f);
      }
    }
  }
  __syncwarp();  // the element's T, written by its L lanes, is read by all of them
  // lane l's nodes a = l + j L: each point's T is read once for all of them
  constexpr int K = (N + L - 1) / L;
  float acc[K][3] = {};
  if (work) {
    const float4* T4 = reinterpret_cast<const float4*>(sT);
    const float* dl = s_tab + Ly::kD + 4 * l;
#pragma unroll 1
    for (int iq = 0; iq < q; ++iq) {
      const float4 t0 = T4[iq * 3], t1 = T4[iq * 3 + 1], t2 = T4[iq * 3 + 2];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (l + j * L < N) {
          const float4 d = *reinterpret_cast<const float4*>(dl + iq * Ly::kTab + 4 * j * L);
          acc[j][0] += d.x * t0.x + d.y * t1.x + d.z * t2.x;
          acc[j][1] += d.x * t0.y + d.y * t1.y + d.z * t2.y;
          acc[j][2] += d.x * t0.z + d.y * t1.z + d.z * t2.z;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int a = l + j * L;
    if (a < N) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[a * 3 + c] = acc[j][c];
    }
  }
}

// BANDED: u (and v) are node vectors [N_nodes][3] read through nodes (the
// padded row -> node table, N rows an element) and block_rows /
// elements_per_block (the element's owner block and its valid rows); X is
// contiguous [M][3][E]; out is element-major [E][N][3].  Otherwise X, u, v and
// out are element-minor views with the strides st.  TANGENT: the Hessian
// actions (reads v); otherwise the internal forces.  Persistent blocks walk
// tiles of kElems elements (tile, tile + gridDim.x, ...); the cp.asyncs of
// the next tile and the node indices of the one after run while the current
// tile computes.
template <bool BANDED, bool TANGENT, int M, int N, int MAT>
__global__ void __launch_bounds__(Layout<M, N>::kThreads, sweep_min_blocks<BANDED, M, N>())
    sweep_kernel(const float* __restrict__ X, const float* __restrict__ u,
                 const float* __restrict__ v, const int32_t* __restrict__ nodes,
                 const int32_t* __restrict__ block_rows, int elements_per_block,
                 float* __restrict__ out, const Strides32 st, int E,
                 const float* __restrict__ tables, int q, float mu, float lam) {
  using Ly = Layout<M, N>;
  constexpr int kElem = Ly::template elem<TANGENT>(), kE = Ly::kElems, kT = Ly::kThreads, L = Ly::kLanes;
  constexpr bool kReadU = !TANGENT || Material<MAT>::kTangentReadsU;
  extern __shared__ __align__(16) float smem[];
  float* s_out = smem;
  float* s_buf = s_out + Ly::kOutFloats;
  float* s_T = s_buf + 2 * kE * kElem;
  float* s_tab = s_T + (Ly::kNodeLanes ? 0 : kE * q * 12);
  const int t = threadIdx.x, g = t / L, l = t % L;
  const int ntiles = (E + kE - 1) / kE, step = gridDim.x;
  int tile = blockIdx.x;

  // real: element g of the tile being staged is not padding (always, strided); padding
  // elements get zero rows without their arithmetic
  LaneNodes<Ly::kStaged> ln = {};
  ln.offset = 0;
  ln.valid_rows = 1;
  if (BANDED) ln = lane_nodes<M, N>(tile, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
  stage_tile<BANDED, TANGENT, kReadU, M, N>(s_buf, tile, E, X, u, v, st, ln, t, g, l);
  bool real = ln.real();
  cp_async_commit();
  if (BANDED) ln = lane_nodes<M, N>(tile + step, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
  // tables [q][geo_dphi 3M | dphi N x kNS | w | 0 ...] from geo_dphi [q][M][3], dphi [q][N][3], w [q]
  for (int i = t; i < q * Ly::kTab; i += kT) {
    const int iq = i / Ly::kTab, j = i - iq * Ly::kTab;
    float x = 0.0f;
    if (j < Ly::kD) {
      x = __ldg(tables + iq * 3 * M + j);
    } else if (j < Ly::kW) {
      const int a = (j - Ly::kD) / Ly::kNS, k = j - Ly::kD - a * Ly::kNS;
      if (k < 3) x = __ldg(tables + q * 3 * M + (iq * N + a) * 3 + k);
    } else if (j == Ly::kW) {
      x = __ldg(tables + q * 3 * (M + N) + iq);
    }
    s_tab[i] = x;
  }

  for (int b = 0; tile < ntiles; tile += step, b ^= 1) {
    const int next = tile + step;
    if (next < ntiles)
      stage_tile<BANDED, TANGENT, kReadU, M, N>(s_buf + (b ^ 1) * kE * kElem, next, E, X, u, v, st, ln, t, g, l);
    const bool real_next = ln.real();
    cp_async_commit();
    if (BANDED) ln = lane_nodes<M, N>(next + step, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
    cp_async_wait_prior();  // this thread's copies of the current tile have landed
    __syncthreads();
    const int e0 = tile * kE, nel = min(kE, E - e0);
    float* el = s_buf + b * kE * kElem + g * kElem;
    // coordinates relative to node 0 (node 0 itself is not read)
    for (int i = l; i < M; i += L) {
      if (i > 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) el[i * 3 + c] -= el[c];
      }
    }
    __syncwarp();
    if constexpr (Ly::kNodeLanes) {
      hex8_element<TANGENT, MAT>(el, s_tab, q, l, g < nel && (TANGENT || real), mu, lam, s_out + g * Ly::kOut);
    } else {
      split_element<TANGENT, M, N, MAT>(el, s_tab, s_T + g * q * 12, q, l, g < nel && real, mu, lam,
                                         s_out + g * Ly::kOut);
    }
    __syncthreads();

    if (BANDED) {  // the tile's rows are one contiguous run of nel * kOut floats
      const int nf = nel * Ly::kOut, n4 = nf / 4;
      const float4* src = reinterpret_cast<const float4*>(s_out);
      float4* dst = reinterpret_cast<float4*>(out + (int64_t)e0 * Ly::kOut);
      for (int i = t; i < n4; i += kT) dst[i] = src[i];
      if constexpr (Ly::kOut % 4 != 0) {
        for (int i = 4 * n4 + t; i < nf; i += kT) out[(int64_t)e0 * Ly::kOut + i] = s_out[i];
      }
    } else {
      for (int i = t; i < Ly::kOut * kE; i += kT) {
        const int row = i / kE, el_i = i - row * kE;
        if (el_i < nel) {
          const int a = row / 3, c = row - a * 3;
          out[a * st.o[0] + c * st.o[1] + (e0 + el_i) * st.o[2]] = s_out[el_i * Ly::kOut + row];
        }
      }
    }
    real = real_next;
  }
}

}  // namespace

// The launch arguments shared by the two entry points.
struct SweepArgs {
  const float *X, *u, *v;
  const int32_t *nodes, *block_rows;
  int elements_per_block;
  float* out;
  Strides32 st;
  int E;
  const float* tables;
  int q;
  float mu, lam;
  cudaStream_t stream;
};

namespace {

// One persistent block per resident slot: min(tiles, blocks an SM x SMs).
template <bool BANDED, bool TANGENT, int M, int N, int MAT>
int launch_sweep(const SweepArgs& a) {
  using Ly = Layout<M, N>;
  auto kernel = sweep_kernel<BANDED, TANGENT, M, N, MAT>;
  const size_t smem = sweep_smem_floats<TANGENT, M, N>(a.q) * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default: ask for it (fails past the card's 227 KB)
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Ly::kThreads, smem);
  const long long tiles = (a.E + Ly::kElems - 1) / Ly::kElems;
  const unsigned int blocks = (unsigned int)std::max(1LL, std::min(tiles, (long long)std::max(per_sm, 1) * sms));
  kernel<<<blocks, Ly::kThreads, smem, a.stream>>>(a.X, a.u, a.v, a.nodes, a.block_rows, a.elements_per_block,
                                                   a.out, a.st, a.E, a.tables, a.q, a.mu, a.lam);
  return (int)cudaGetLastError();
}

template <int M, int N, int MAT>
int launch_mode(const SweepArgs& a, bool banded) {
  const bool tangent = a.v != nullptr;
  if (banded) return tangent ? launch_sweep<true, true, M, N, MAT>(a) : launch_sweep<true, false, M, N, MAT>(a);
  return tangent ? launch_sweep<false, true, M, N, MAT>(a) : launch_sweep<false, false, M, N, MAT>(a);
}

// The 12 host strides (X, u, v, out) as Strides32 for views X [m][3][E] and
// u, v, out [n][3][E]; false if a stride is negative or a view's last offset
// reaches 2^31.
bool strides32(const long long* strides, long long m, long long n, long long E, Strides32* st) {
  int* dst[4] = {st->x, st->u, st->v, st->o};
  for (int a = 0; a < 4; ++a) {
    const long long extent[3] = {a == 0 ? m : n, 3, E};
    long long last = 0;
    for (int d = 0; d < 3; ++d) {
      if (strides[3 * a + d] < 0) return false;
      last += (extent[d] - 1) * strides[3 * a + d];
    }
    if (last >= (1LL << 31)) return false;
    for (int d = 0; d < 3; ++d) dst[a][d] = (int)strides[3 * a + d];
  }
  return true;
}

}  // namespace

// One element's launches (every material and mode), defined in the
// translation unit of its FENRIS_EM_ELEMENT.
template <int M, int N>
int launch_element(const SweepArgs& a, bool banded, int material) {
  switch (material) {
    case kNeoHookean:
      return launch_mode<M, N, kNeoHookean>(a, banded);
    case kStVK:
      return launch_mode<M, N, kStVK>(a, banded);
    case kLinear:
      return launch_mode<M, N, kLinear>(a, banded);
  }
  return (int)cudaErrorInvalidValue;
}

#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 0
template int launch_element<4, 4>(const SweepArgs&, bool, int);
#else
extern template int launch_element<4, 4>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 1
template int launch_element<4, 10>(const SweepArgs&, bool, int);
#else
extern template int launch_element<4, 10>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 2
template int launch_element<4, 20>(const SweepArgs&, bool, int);
#else
extern template int launch_element<4, 20>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 3
template int launch_element<8, 8>(const SweepArgs&, bool, int);
#else
extern template int launch_element<8, 8>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 4
template int launch_element<8, 20>(const SweepArgs&, bool, int);
#else
extern template int launch_element<8, 20>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 5
template int launch_element<8, 27>(const SweepArgs&, bool, int);
#else
extern template int launch_element<8, 27>(const SweepArgs&, bool, int);
#endif

#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 0

namespace {

// The element's launches by (m, n): tet4, tet10, tet20, hex8, hex20, hex27.
int launch(const SweepArgs& a, bool banded, int m, int n, int material) {
  if (m == 4 && n == 4) return launch_element<4, 4>(a, banded, material);
  if (m == 4 && n == 10) return launch_element<4, 10>(a, banded, material);
  if (m == 4 && n == 20) return launch_element<4, 20>(a, banded, material);
  if (m == 8 && n == 8) return launch_element<8, 8>(a, banded, material);
  if (m == 8 && n == 20) return launch_element<8, 20>(a, banded, material);
  if (m == 8 && n == 27) return launch_element<8, 27>(a, banded, material);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  Each returns
// cudaGetLastError() after its launch (0 = success), or
// cudaErrorInvalidValue without launching when E * 3n >= 2^31, a strided
// view's offsets reach 2^31, or (m, n) or the material is not one the kernels
// take.  v == NULL selects the vector sweep (internal forces), otherwise the
// tangent sweep (Hessian actions of v).  m, n: the element's geometry and
// solution nodes (tet4 4, 4; tet10 4, 10; tet20 4, 20; hex8 8, 8; hex20 8, 20;
// hex27 8, 27); material: 0 Neo-Hookean, 1 StVK, 2 linear elasticity (whose
// tangent sweep does not read u).  tables: a device f32 array [q * (3m + 3n +
// 1)]: geo_dphi [q][m][3], dphi [q][n][3], weights [q].
//
// fenris_em_sweep: X f32 [m, 3, E], u, v and out f32 [n, 3, E], all device
// arrays with the element-minor strides given in the host array strides[12]
// (X, u, v, out; each node, component, element; v's are not read when v is
// NULL).
extern "C" int fenris_em_sweep(const void* X, const void* u, const void* v, void* out,
                               const long long* strides, long long E, const void* tables, int q, int m,
                               int n, int material, float mu, float lam, void* stream) {
  if (E == 0) return 0;
  SweepArgs a = {(const float*)X, (const float*)u, (const float*)v, nullptr, nullptr, 1, (float*)out, {},
                 (int)E, (const float*)tables, q, mu, lam, (cudaStream_t)stream};
  if (E * 3 * n >= (1LL << 31) || !strides32(strides, m, n, E, &a.st)) return (int)cudaErrorInvalidValue;
  return launch(a, false, m, n, material);
}

// fenris_banded_sweep: the vector or tangent sweep fused with the banded
// gather.  X f32 [m, 3, E] contiguous (the padded geometry, E = E_pad); u, v
// f32 [N, 3] contiguous node vectors; nodes int32 [E * n] (the plan's
// nodes_padded); block_rows int32 [E / elements_per_block] (valid rows per
// owner block); out f32 [E, n, 3] contiguous, 16-byte aligned.
extern "C" int fenris_banded_sweep(const void* X, const void* u, const void* v, const void* nodes,
                                   const void* block_rows, void* out, long long E, int elements_per_block,
                                   const void* tables, int q, int m, int n, int material, float mu,
                                   float lam, void* stream) {
  if (E == 0) return 0;
  if (E * 3 * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const SweepArgs a = {(const float*)X, (const float*)u, (const float*)v, (const int32_t*)nodes,
                       (const int32_t*)block_rows, elements_per_block, (float*)out, {}, (int)E,
                       (const float*)tables, q, mu, lam, (cudaStream_t)stream};
  return launch(a, true, m, n, material);
}

#endif
