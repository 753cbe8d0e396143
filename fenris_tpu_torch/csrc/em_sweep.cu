// Fused element sweeps on unstructured 2D and 3D elements, for sm_90a.
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
// MaterialEllipticOperator, d = s = D in {2, 3}, on an element of m geometry
// and n solution nodes: tet4 (m, n) = (4, 4), tet10 (4, 10), tet20 (4, 20),
// hex8 (8, 8), hex20 (8, 20), hex27 (8, 27); quad4 (4, 4), quad8 (4, 8),
// quad9 (4, 9), tri3 (3, 3), tri6 (3, 6); q quadrature points, given at run
// time; Lame parameters mu, lam either one value for all elements or one an
// element): for every element e and point q,
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
// One body, sweep_kernel<BANDED, TANGENT, D, M, N, MAT>, serves all four
// launchers, the eleven elements and the three materials (132
// instantiations).  Blocks are one warp; L lanes share an element, a tile is
// 32 / L elements:
//   * hex8 (L = 8, the path the matrix-free solve at 10M dofs runs): lane l
//     takes quadrature points l, l + 8, ..., computing gp[8][3] and its 24
//     partial outputs, and the 8 lanes reduce them by a fixed reduce-scatter
//     of __shfl_xor_sync (xor 4, 2, 1; 21 shuffles), after which lane l holds
//     node l's 3 sums.  80 registers under the launch bound of 24 blocks an
//     SM (18 blocks, 112 registers, for the strided sweeps, which spill at 80);
//   * the others (L = 4 for tet4, tet10 and every 2D element, 8 for tet20,
//     hex20, hex27): an n x D partial output a lane (60 floats at hex20, 81 at
//     hex27) would spill, so each element's work is split twice.  Lanes take
//     its points (l, l + L, ...), and each writes its point's T (D x D floats,
//     rows of kNS) to shared memory, with no gp: both gradients come from the
//     reference gradient H (D^2 sums over the n nodes).  Then lanes take its
//     nodes (a = l, l + L, ...) and each sums its nodes' D outputs over all q
//     points in point order, reading each point's T once: no lane holds n x D
//     sums and no shuffle reduce is needed.  A table row is read as one
//     float4 (3D) or float2 (2D) per node ([q][geo_dphi Dm | dphi n x kNS |
//     w], rows an odd number of float4 apart: lanes at different points read
//     distinct bank groups; lanes at different nodes consecutive vectors); u
//     and v are staged [n][kNS].  Launch bounds of 12 blocks an SM (168
//     registers: the 3D Neo-Hookean tangents spill at 128); shared memory
//     holds the 20- and 27-node elements to 8-15 blocks anyway (tables and T
//     grow with q: 22.7 KB a block at hex20).
//   Both: a block works on tiles, staging X and u (and v), and each element's
//   mu and lam, in shared memory with cp.async; the tables sit there re-laid
//   per point; persistent blocks (as many as fit on the card) walk the tiles
//   with a two-stage pipeline: the next tile's copies, and the node indices
//   of the one after, are in flight while the current tile computes.  The
//   Lame parameters: a banded launch given one pair by value uses it as
//   kernel operands (LameValues); otherwise (a per-element array, element
//   stride 1, a device value, stride 0, and every strided launch) each
//   element's pair is read from device memory once, staged with its tile,
//   and read from shared memory at each use (Lame).  The kernel holds both
//   bodies and picks one per launch: staged reads cost hex8 ~5% and tet10's
//   tangent ~7% against operands, and held in registers across a point the
//   pair pushes hex8 past its 80;
//   * banded mode (fenris_banded_sweep): u and v are read straight from the
//     node vectors through the plan's row -> node table, so the gather's rows
//     never go to device memory; padding elements' rows are zeros.  hex8:
//     lane l copies node l of its element, and padding elements read nothing
//     (their u and v are zero-filled, as the banded gather gives them); the
//     others: consecutive threads copy consecutive words of the tile's
//     (element, node, component) run, D threads a node (a copy instruction
//     touches about a third of the lines lanes copying whole nodes would),
//     and padding rows read node 0, whose values nothing uses.  X is the padded
//     element-minor geometry [Dm][E_pad], read as contiguous runs of each
//     row a tile; per-element parameters are padded the same way (a padding
//     element reads its filler's).  The output, element-major rows
//     [E_pad][n][D], is a tile's one contiguous run, written from shared
//     memory with float4 stores;
//   * strided mode (fenris_em_sweep): element-minor views with any strides
//     (32-bit offsets) in and out, the same body;
//   * no atomics: every sum is taken in one fixed order, so two launches are
//     bitwise equal, and an array of one repeated parameter value gives the
//     launch with that value bitwise.  hex8 differs from the plain version
//     only in the order of its sums, the others also in taking the gradients
//     through H and the contraction through T: f32 roundoff either way.
// What bounds it on the H100: f32 operations for the hex elements (hex8:
// about 7.5k (tangent) or 5.4k (vector) an element; hex20 about 1,600 a point
// at 27 points), bytes for the tets and the 2D elements (tet10: X 48, node
// indices 40 and rows out 120 bytes an element, u and v once a node; the
// copies gather 240 bytes an element of u and v from L2).  Register pressure
// is the design risk: read `-Xptxas -v` in the library's log,
// _build/libfenris_kernels_<hash>.log, for registers and spills.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler
// -fPIC, once per element (-DFENRIS_EM_ELEMENT=0..10, all started together;
// part 0 also holds the launchers), then linked into the shared library (see
// fenris_tpu_torch/ops/_build.py).  Without FENRIS_EM_ELEMENT the one
// translation unit instantiates every element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

struct Strides32 {  // [node][comp][element] strides, in floats; every offset < 2^31
  int x[3], u[3], v[3], o[3];
};

// One Lame parameter of a launch: element e reads p[e * stride] (stride 1: one
// value an element; 0: one value for all), or value when p is NULL.
struct Param {
  const float* p;
  int stride;
  float value;
};

namespace {

enum : int { kNeoHookean = 0, kStVK = 1, kLinear = 2 };  // the launchers' material codes

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// x (a multiple of 4) made an odd number of float4: rows this far apart fall
// in distinct groups of 4 banks for 8 lanes
__host__ __device__ constexpr int odd4(int x) { return (x / 4) % 2 ? x : x + 4; }

// Where the material reads mu and lam.  Lame: an element's values where the
// staging left them in shared memory, twice ([mu, lam, mu, lam]): the stress
// or kinematics read the first copy and the tangent the second, so the
// compiler cannot merge the loads into one register held across the point.
// LameValues: a launch's one pair, passed by value (kernel parameters, read
// as operands: no register; hex8 runs at its 80).
struct Lame {
  const float* p;
  __device__ __forceinline__ float mu() const { return p[0]; }
  __device__ __forceinline__ float lam() const { return p[1]; }
  __device__ __forceinline__ Lame again() const { return {p + 2}; }
};
struct LameValues {
  float m, l;
  __device__ __forceinline__ float mu() const { return m; }
  __device__ __forceinline__ float lam() const { return l; }
  __device__ __forceinline__ LameValues again() const { return *this; }
};

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

// F = I + G^T, F^-T and alpha = -mu + lam log J (log J log1p-stable; gamma =
// det F - 1 expanded symbolically, as log_det_F in solid/__init__.py).
template <int D, class P>
__device__ __forceinline__ float kinematics(const float G[D][D], P p, float F[D][D], float FinvT[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) F[i][j] = G[j][i] + (i == j ? 1.0f : 0.0f);
  float gamma;
  if constexpr (D == 3) {
    const float a = G[0][0], b = G[1][0], c = G[2][0];
    const float d = G[0][1], e = G[1][1], f = G[2][1];
    const float g = G[0][2], h = G[1][2], i = G[2][2];
    gamma = (a + e + i) + (a * e - b * d + a * i - c * g + e * i - f * h) +
            (a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g));
  } else {
    const float a = G[0][0], b = G[1][0], d = G[0][1], e = G[1][1];
    gamma = a + e + a * e - b * d;
  }
  const float logJ = gamma > -1.0f ? log1pf(gamma) : -INFINITY;
  float adj[D][D];  // adjugate of F; F^-T[i][j] = adj[j][i] / det F
  if constexpr (D == 3) {
    adj[0][0] = F[1][1] * F[2][2] - F[1][2] * F[2][1];
    adj[0][1] = F[0][2] * F[2][1] - F[0][1] * F[2][2];
    adj[0][2] = F[0][1] * F[1][2] - F[0][2] * F[1][1];
    adj[1][0] = F[1][2] * F[2][0] - F[1][0] * F[2][2];
    adj[1][1] = F[0][0] * F[2][2] - F[0][2] * F[2][0];
    adj[1][2] = F[0][2] * F[1][0] - F[0][0] * F[1][2];
    adj[2][0] = F[1][0] * F[2][1] - F[1][1] * F[2][0];
    adj[2][1] = F[0][1] * F[2][0] - F[0][0] * F[2][1];
    adj[2][2] = F[0][0] * F[1][1] - F[0][1] * F[1][0];
  } else {
    adj[0][0] = F[1][1];
    adj[0][1] = -F[0][1];
    adj[1][0] = -F[1][0];
    adj[1][1] = F[0][0];
  }
  float detF = F[0][0] * adj[0][0];
#pragma unroll
  for (int k = 1; k < D; ++k) detF += F[0][k] * adj[k][0];
  const float rdet = 1.0f / detF;
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int k = 0; k < D; ++k) FinvT[r][k] = adj[k][r] * rdet;
  return -p.mu() + p.lam() * logJ;
}

// dP = mu dF + lam tr(F^-1 dF) F^-T - alpha F^-T dF^T F^-T, dF = dG^T
template <int D, class P>
__device__ __forceinline__ void tangent_stress(const float FinvT[D][D], const float dG[D][D], P p,
                                               float alpha, float S[D][D]) {
  // tr(F^-1 dF) = sum_ij F^-T[j][i] dF[j][i]
  float dlogJ = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dlogJ += FinvT[i][j] * dG[j][i];
  // M = F^-T dF^T, M[i][l] = sum_k F^-T[i][k] dF[l][k] = sum_k F^-T[i][k] dG[k][l]
  float M[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int l = 0; l < D; ++l) {
      float acc = FinvT[i][0] * dG[0][l];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += FinvT[i][k] * dG[k][l];
      M[i][l] = acc;
    }
  const float mu = p.mu(), ldlogJ = p.lam() * dlogJ;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = M[i][0] * FinvT[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += M[i][k] * FinvT[k][j];
      S[i][j] = mu * dG[j][i] + ldlogJ * FinvT[i][j] + alpha * -acc;
    }
}

// A material at one point: at(G) takes the displacement gradient G[d][c]
// (F = I + G^T), then stress() gives P[i][j] and tangent(dG) gives dP along
// dF = dG^T.  kTangentReadsU: whether the tangent depends on u.
template <int D, int MAT>
struct Material;

template <int D>
struct Material<D, kNeoHookean> {
  static constexpr bool kTangentReadsU = true;
  float F[D][D], FinvT[D][D], alpha;
  template <class P>
  __device__ __forceinline__ void at(const float G[D][D], P p) { alpha = kinematics<D>(G, p, F, FinvT); }
  template <class P>
  __device__ __forceinline__ void stress(P p, float S[D][D]) const {
    const float mu = p.mu();
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) S[i][j] = alpha * FinvT[i][j] + mu * F[i][j];
  }
  template <class P>
  __device__ __forceinline__ void tangent(const float dG[D][D], P p, float dP[D][D]) const {
    tangent_stress<D>(FinvT, dG, p, alpha, dP);
  }
};

template <int D>
struct Material<D, kStVK> {
  static constexpr bool kTangentReadsU = true;
  float F[D][D], S[D][D];  // F and the second Piola-Kirchhoff stress S
  template <class P>
  __device__ __forceinline__ void at(const float G[D][D], P p) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) F[i][j] = G[j][i] + (i == j ? 1.0f : 0.0f);
    float E[D][D];  // (F^T F - I) / 2
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = F[0][i] * F[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) acc += F[k][i] * F[k][j];
        E[i][j] = 0.5f * (acc - (i == j ? 1.0f : 0.0f));
      }
    float trE = E[0][0];
#pragma unroll
    for (int k = 1; k < D; ++k) trE += E[k][k];
    const float ltr = p.lam() * trE, mu2 = 2.0f * p.mu();
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) S[i][j] = mu2 * E[i][j] + (i == j ? ltr : 0.0f);
  }
  template <class P>
  __device__ __forceinline__ void stress(P, float Pk[D][D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = F[i][0] * S[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) acc += F[i][k] * S[k][j];
        Pk[i][j] = acc;
      }
  }
  template <class P>
  __device__ __forceinline__ void tangent(const float dG[D][D], P p, float dP[D][D]) const {
    // A = F^T dF, dS = mu (A + A^T) + lam tr(A) I, dP = dF S + F dS
    float A[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = F[0][i] * dG[j][0];
#pragma unroll
        for (int k = 1; k < D; ++k) acc += F[k][i] * dG[j][k];
        A[i][j] = acc;
      }
    float trA = A[0][0];
#pragma unroll
    for (int k = 1; k < D; ++k) trA += A[k][k];
    const float ltr = p.lam() * trA, mu = p.mu();
    float dS[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) dS[i][j] = mu * (A[i][j] + A[j][i]) + (i == j ? ltr : 0.0f);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = dG[0][i] * S[0][j];
#pragma unroll
        for (int k = 1; k < D; ++k) acc += dG[k][i] * S[k][j];
#pragma unroll
        for (int k = 0; k < D; ++k) acc += F[i][k] * dS[k][j];
        dP[i][j] = acc;
      }
  }
};

template <int D>
struct Material<D, kLinear> {
  static constexpr bool kTangentReadsU = false;
  float G[D][D];
  // P = mu (G + G^T) + lam tr(G) I
  template <class P>
  static __device__ __forceinline__ void linear(const float G[D][D], P p, float S[D][D]) {
    float tr = G[0][0];
#pragma unroll
    for (int k = 1; k < D; ++k) tr += G[k][k];
    const float ltr = p.lam() * tr, mu = p.mu();
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) S[i][j] = mu * (G[i][j] + G[j][i]) + (i == j ? ltr : 0.0f);
  }
  template <class P>
  __device__ __forceinline__ void at(const float Gu[D][D], P) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) G[i][j] = Gu[i][j];
  }
  template <class P>
  __device__ __forceinline__ void stress(P p, float S[D][D]) const { linear(G, p, S); }
  template <class P>
  __device__ __forceinline__ void tangent(const float dG[D][D], P p, float dP[D][D]) const {
    linear(dG, p, dP);
  }
};

// -- layouts -----------------------------------------------------------------------

// The tiling of a D-dimensional element of M geometry and N solution nodes.
// hex8 keeps one quadrature point a lane and the reduce-scatter
// (kNodeLanes); the others split an element's points, then its nodes, over
// its lanes.
template <int D, int M, int N>
struct Layout {
  static constexpr bool kNodeLanes = D == 3 && M == 8 && N == 8;
  static constexpr int kLanes = (D == 2 || N == 4 || N == 10) ? 4 : 8;  // lanes an element
  static constexpr int kThreads = 32;                                    // one warp a block
  static constexpr int kElems = kThreads / kLanes;                       // elements a tile
  // banded: the node words a thread stages a tile (hex8: its element's node l; the others: items
  // t, t + 32, ... of the tile's (element, node, component) words)
  static constexpr int kStaged = kNodeLanes ? 1 : (kElems * N * D + kThreads - 1) / kThreads;
  // floats a node in the staged u, v and the table's dphi: one float4 (3D) or float2 (2D) read
  static constexpr int kNS = kNodeLanes ? 3 : (D == 3 ? 4 : 2);
  static constexpr int kTq = D * kNS;  // floats of a point's T (rows of kNS)
  // an element's staged floats: X [M][D] (relative to node 0 after staging), u [N][kNS] at kU, v at
  // kV, then mu, lam, mu, lam (params(), Lame)
  static constexpr int kU = round4(D * M);
  static constexpr int kV = kU + round4(kNS * N);
  template <bool TANGENT>
  __host__ __device__ static constexpr int params() {
    return TANGENT ? kV + round4(kNS * N) : kV;
  }
  // a table row: geo_dphi [M][D], dphi [N][kNS] at kD, w at kW
  static constexpr int kD = round4(D * M);
  static constexpr int kW = kD + kNS * N;
  static constexpr int kTab = odd4(round4(kW + 1));
  static constexpr int kOut = D * N;  // an element's output floats
  static constexpr int kOutFloats = round4(kElems * kOut);
  template <bool TANGENT>
  __host__ __device__ static constexpr int elem() {  // shared floats an element in a staging buffer, a multiple of 4
    return round4(params<TANGENT>() + 4);
  }
  static_assert(kElems * kOut % 4 == 0, "a tile's output run must start 16-byte aligned");
  static_assert(kU % 4 == 0 && kV % 4 == 0 && kD % 4 == 0, "float4 reads need 16-byte offsets");
};

// Launch bounds' blocks an SM: hex8 24 (80 registers, no spills) for the
// banded sweeps, 18 (112) for the strided ones (the StVK tangent spills at 96,
// all at 80); the other
// elements 12 (168: the 3D Neo-Hookean tangents spill at 128), which shared
// memory holds to 8-15 blocks at 20 and 27 nodes anyway.
template <bool BANDED, int D, int M, int N>
__host__ __device__ constexpr int sweep_min_blocks() {
  return Layout<D, M, N>::kNodeLanes ? (BANDED ? 24 : 18) : 12;
}

// Shared memory, each part 16-byte aligned: out [kElems][kOut], two element
// buffers [2][kElems][elem], T [kElems][q][kTq] (not for hex8), tables [q][kTab].
template <bool TANGENT, int D, int M, int N>
__host__ __device__ constexpr size_t sweep_smem_floats(int q) {
  using Ly = Layout<D, M, N>;
  return (size_t)Ly::kOutFloats + 2 * (size_t)Ly::kElems * Ly::template elem<TANGENT>() +
         (Ly::kNodeLanes ? 0 : (size_t)Ly::kElems * q * Ly::kTq) + (size_t)q * Ly::kTab;
}

// Shared-memory reads of K floats as round4(K) / 4 float4 (p 16-byte aligned;
// the padding floats past K are read and not used).  hex8: each quarter-warp
// reads one element's words (its 8 lanes broadcast) or, for the tables, 8
// points' words at a stride of 52 floats, which fall in 8 distinct groups of 4
// banks: no bank conflicts.
template <int K>
__device__ __forceinline__ void lds(const float* p, float a[round4(K)]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < round4(K) / 4; ++i) {
    const float4 x = p4[i];
    a[4 * i] = x.x;
    a[4 * i + 1] = x.y;
    a[4 * i + 2] = x.z;
    a[4 * i + 3] = x.w;
  }
}

// The D floats of a node row of kNS (4 in 3D, 2 in 2D) as one vector read.
template <int D>
struct Vec {
  float v[D];
  static __device__ __forceinline__ Vec load(const float* p) {
    if constexpr (D == 3) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      return {{x.x, x.y, x.z}};
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      return {{x.x, x.y}};
    }
  }
};

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

// The other elements: J^-1 (J from node-relative X [M][D] and the row's
// geo_dphi [M][D]) and wdet at one point.
template <int D, int M>
__device__ __forceinline__ float inverse_jacobian(const float* gd_row, const float* X_rel, float w,
                                                  float Jinv[D][D]) {
  float gd[round4(D * M)], X[round4(D * M)];
  lds<D * M>(gd_row, gd);
  lds<D * M>(X_rel, X);
  float J[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = gd[D + j] * X[D + i];
#pragma unroll
      for (int b = 2; b < M; ++b) acc += gd[b * D + j] * X[b * D + i];
      J[i][j] = acc;
    }
  float c[D][D], det;  // c: the adjugate of J
  if constexpr (D == 3) {
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
  } else {
    c[0][0] = J[1][1];
    c[0][1] = -J[0][1];
    c[1][0] = -J[1][0];
    c[1][1] = J[0][0];
    det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  }
  const float r = 1.0f / det;
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int i = 0; i < D; ++i) Jinv[k][i] = c[k][i] * r;
  return w * fabsf(det);
}

// G[d][c] = sum_k J^-1[k][d] H[k][c], H[k][c] = sum_a dphi[a][k] U[a][c]
// (dphi and U as [N][kNS], one vector read a node).  The node loop is
// unrolled by 4 past 10 nodes: fully unrolled, ptxas hoists its loads and the
// 20- and 27-node Neo-Hookean tangents spill even at 168 registers (and
// unrolled partly, even by its trip count, tet10's spills at 128).
template <int D, int N>
__device__ __forceinline__ void ref_gradient(const float* dphi, const float* U, const float Jinv[D][D],
                                             float G[D][D]) {
  constexpr int kNS = D == 3 ? 4 : 2;  // Layout's kNS off hex8
  float H[D][D];
  {
    const Vec<D> d = Vec<D>::load(dphi), f = Vec<D>::load(U);
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) H[k][c] = d.v[k] * f.v[c];
  }
  auto add = [&](int a) {
    const Vec<D> d = Vec<D>::load(dphi + a * kNS), f = Vec<D>::load(U + a * kNS);
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) H[k][c] += d.v[k] * f.v[c];
  };
  if constexpr (N > 10) {
#pragma unroll 4
    for (int a = 1; a < N; ++a) add(a);
  } else {
#pragma unroll
    for (int a = 1; a < N; ++a) add(a);
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float acc = Jinv[0][d] * H[0][c];
#pragma unroll
      for (int k = 1; k < D; ++k) acc += Jinv[k][d] * H[k][c];
      G[d][c] = acc;
    }
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

// Element e's value of a launch parameter into shared memory at dst.
__device__ __forceinline__ void stage_param(float* dst, const Param& p, int e, bool ok) {
  if (p.p != nullptr) {
    cp_async4(dst, p.p + (int64_t)(ok ? e : 0) * p.stride, ok);
  } else {
    *dst = p.value;
  }
}

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

template <int D, int M, int N>
__device__ __forceinline__ LaneNodes<Layout<D, M, N>::kStaged> lane_nodes(
    int tile, int ntiles, int E, int t, int g, int l, const int32_t* __restrict__ nodes,
    const int32_t* __restrict__ block_rows, int elements_per_block) {
  using Ly = Layout<D, M, N>;
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
      const int i = t + j * Ly::kThreads, row = tile * Ly::kElems * N + i / D;
      if (i < Ly::kElems * N * D && row < E * N) r.node[j] = __ldg(nodes + row);
    }
  }
  return r;
}

// Start the cp.asyncs of one tile's X and u (and v), and (STAGED) each
// element's mu and lam, into buf.  X (and, strided, the fields) as (component row,
// element) pairs, element fastest: coalesced on element-minor arrays.
// Banded, hex8: lane l copies node l of element g, and padding elements are
// zero-filled without a read (the tangent computes their zero rows); the
// others: thread t copies words t, t + 32, ... of the tile's (element, node,
// component) words, so consecutive threads copy one node's D words, and
// padding rows read node 0 (their elements' arithmetic is skipped).  Elements
// past E are zero-filled without a read.  READ_U: whether u is staged (not
// for the linear tangent).
template <bool BANDED, bool TANGENT, bool READ_U, bool STAGED, int D, int M, int N>
__device__ __forceinline__ void stage_tile(float* buf, int tile, int E, const float* __restrict__ X,
                                           const float* __restrict__ u, const float* __restrict__ v,
                                           const Strides32& st, const Param& mu, const Param& lam,
                                           const LaneNodes<Layout<D, M, N>::kStaged>& ln, int t, int g, int l) {
  using Ly = Layout<D, M, N>;
  constexpr int kElem = Ly::template elem<TANGENT>(), kE = Ly::kElems, kT = Ly::kThreads;
  const int e0 = tile * kE;
  for (int i = t; i < D * M * kE; i += kT) {
    const int row = i / kE, el = i - row * kE;
    const bool ok = e0 + el < E;
    const int e = ok ? e0 + el : 0;
    float* dst = buf + el * kElem + row;
    if (BANDED) {
      cp_async4(dst, X + row * E + e, ok);  // X contiguous [DM][E]
    } else {
      const int m = row / D, c = row - m * D;
      cp_async4(dst, X + m * st.x[0] + c * st.x[1] + e * st.x[2], ok);
    }
  }
  if (STAGED && t < kE) {
    float* dst = buf + t * kElem + Ly::template params<TANGENT>();
    const bool ok = e0 + t < E;
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      stage_param(dst + k, mu, e0 + t, ok);
      stage_param(dst + k + 1, lam, e0 + t, ok);
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
      if (i < kE * N * D) {
        const int el = i / (D * N), w = i - el * D * N, a = w / D, c = w - a * D;
        const bool ok = e0 + el < E;
        const int64_t src = (int64_t)ln.node[j] * D + c;
        float* dst = buf + el * kElem + a * Ly::kNS + c;
        if (READ_U) cp_async4(dst + Ly::kU, u + src, ok);
        if (TANGENT) cp_async4(dst + Ly::kV, v + src, ok);
      }
    }
  } else {
    for (int i = t; i < D * N * kE; i += kT) {
      const int row = i / kE, el = i - row * kE;
      const bool ok = e0 + el < E;
      const int e = ok ? e0 + el : 0;
      const int a = row / D, c = row - a * D;
      float* dst = buf + el * kElem + a * Ly::kNS + c;
      if (READ_U) cp_async4(dst + Ly::kU, u + a * st.u[0] + c * st.u[1] + e * st.u[2], ok);
      if (TANGENT) cp_async4(dst + Ly::kV, v + a * st.v[0] + c * st.v[1] + e * st.v[2], ok);
    }
  }
}

// hex8: the tile's element g, lane l taking points l, l + 8, ...; node l's
// outputs to o[l * 3 + c].
template <bool TANGENT, int MAT, class P>
__device__ __forceinline__ void hex8_element(const float* el, const float* s_tab, int q, int l, bool work,
                                             P p, float* o) {
  using Ly = Layout<3, 8, 8>;
  constexpr bool kReadU = !TANGENT || Material<3, MAT>::kTangentReadsU;
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
      Material<3, MAT> mat;
      if (kReadU) {
        lds<24>(el + Ly::kU, A);  // u
        gradient(gp, A, G);
        mat.at(G, p);
      }
      if (TANGENT) {
        lds<24>(el + Ly::kV, A);  // v
        gradient(gp, A, G);
        mat.tangent(G, p.again(), S);
      } else {  // the weight after the sum: the sum cancels to O(strain) at small strains
        mat.stress(p, S);
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
// sT [q][kTq]), then its nodes (outputs to o[a * D + c]).
template <bool TANGENT, int D, int M, int N, int MAT, class P>
__device__ __forceinline__ void split_element(const float* el, const float* s_tab, float* sT, int q, int l,
                                              bool work, P p, float* o) {
  using Ly = Layout<D, M, N>;
  constexpr int L = Ly::kLanes, kNS = Ly::kNS, kTq = Ly::kTq;
  constexpr bool kReadU = !TANGENT || Material<D, MAT>::kTangentReadsU;
  if (work) {
#pragma unroll 1
    for (int iq = l; iq < q; iq += L) {
      const float* tq = s_tab + iq * Ly::kTab;
      float Jinv[D][D], G[D][D], S[D][D];
      const float wdet = inverse_jacobian<D, M>(tq, el, tq[Ly::kW], Jinv);
      Material<D, MAT> mat;
      if (kReadU) {
        ref_gradient<D, N>(tq + Ly::kD, el + Ly::kU, Jinv, G);
        mat.at(G, p);
      }
      if (TANGENT) {
        ref_gradient<D, N>(tq + Ly::kD, el + Ly::kV, Jinv, G);
        mat.tangent(G, p.again(), S);
      } else {
        mat.stress(p, S);
      }
      // T[k][c] = wdet sum_d J^-1[k][d] P[c][d], a row of kNS floats a k (one float4 a row in 3D, the
      // two rows as one float4 in 2D)
      float t[kTq];
#pragma unroll
      for (int k = 0; k < D; ++k)
#pragma unroll
        for (int c = 0; c < kNS; ++c) {
          float acc = 0.0f;
          if (c < D) {
            acc = Jinv[k][0] * S[c][0];
#pragma unroll
            for (int d = 1; d < D; ++d) acc += Jinv[k][d] * S[c][d];
            acc *= wdet;
          }
          t[k * kNS + c] = acc;
        }
      float4* T4 = reinterpret_cast<float4*>(sT + iq * kTq);
#pragma unroll
      for (int i = 0; i < kTq / 4; ++i) T4[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
    }
  }
  __syncwarp();  // the element's T, written by its L lanes, is read by all of them
  // lane l's nodes a = l + j L: each point's T is read once for all of them
  constexpr int K = (N + L - 1) / L;
  float acc[K][D] = {};
  if (work) {
    const float* dl = s_tab + Ly::kD + kNS * l;
#pragma unroll 1
    for (int iq = 0; iq < q; ++iq) {
      float t[kTq];
      lds<kTq>(sT + iq * kTq, t);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (l + j * L < N) {
          const Vec<D> d = Vec<D>::load(dl + iq * Ly::kTab + kNS * j * L);
#pragma unroll
          for (int c = 0; c < D; ++c) {
            float s = d.v[0] * t[c];
#pragma unroll
            for (int k = 1; k < D; ++k) s += d.v[k] * t[k * kNS + c];
            acc[j][c] += s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int a = l + j * L;
    if (a < N) {
#pragma unroll
      for (int c = 0; c < D; ++c) o[a * D + c] = acc[j][c];
    }
  }
}

// The kernel's body (sweep_kernel): persistent blocks walk tiles of kElems
// elements (tile, tile + gridDim.x, ...); the cp.asyncs of the next tile and
// the node indices of the one after run while the current tile computes.
// STAGED: each element's mu and lam come staged with its tile, else the
// launch's one pair is used by value.
template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT, bool STAGED>
__device__ __forceinline__ void sweep_tiles(const float* __restrict__ X, const float* __restrict__ u,
                                            const float* __restrict__ v, const int32_t* __restrict__ nodes,
                                            const int32_t* __restrict__ block_rows, int elements_per_block,
                                            float* __restrict__ out, const Strides32& st, int E,
                                            const float* __restrict__ tables, int q, const Param& mu,
                                            const Param& lam) {
  using Ly = Layout<D, M, N>;
  constexpr int kElem = Ly::template elem<TANGENT>(), kE = Ly::kElems, kT = Ly::kThreads, L = Ly::kLanes;
  constexpr bool kReadU = !TANGENT || Material<D, MAT>::kTangentReadsU;
  extern __shared__ __align__(16) float smem[];
  float* s_out = smem;
  float* s_buf = s_out + Ly::kOutFloats;
  float* s_T = s_buf + 2 * kE * kElem;
  float* s_tab = s_T + (Ly::kNodeLanes ? 0 : kE * q * Ly::kTq);
  const int t = threadIdx.x, g = t / L, l = t % L;
  const int ntiles = (E + kE - 1) / kE, step = gridDim.x;
  int tile = blockIdx.x;

  // real: element g of the tile being staged is not padding (always, strided); padding
  // elements get zero rows without their arithmetic
  LaneNodes<Ly::kStaged> ln = {};
  ln.offset = 0;
  ln.valid_rows = 1;
  if (BANDED) ln = lane_nodes<D, M, N>(tile, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
  stage_tile<BANDED, TANGENT, kReadU, STAGED, D, M, N>(s_buf, tile, E, X, u, v, st, mu, lam, ln, t, g, l);
  bool real = ln.real();
  cp_async_commit();
  if (BANDED) ln = lane_nodes<D, M, N>(tile + step, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
  // tables [q][geo_dphi DM | 0 ... | dphi N x kNS | w | 0 ...] from geo_dphi [q][M][D], dphi [q][N][D], w [q]
  for (int i = t; i < q * Ly::kTab; i += kT) {
    const int iq = i / Ly::kTab, j = i - iq * Ly::kTab;
    float x = 0.0f;
    if (j < D * M) {
      x = __ldg(tables + iq * D * M + j);
    } else if (j >= Ly::kD && j < Ly::kW) {
      const int a = (j - Ly::kD) / Ly::kNS, k = j - Ly::kD - a * Ly::kNS;
      if (k < D) x = __ldg(tables + q * D * M + (iq * N + a) * D + k);
    } else if (j == Ly::kW) {
      x = __ldg(tables + q * D * (M + N) + iq);
    }
    s_tab[i] = x;
  }

  for (int b = 0; tile < ntiles; tile += step, b ^= 1) {
    const int next = tile + step;
    if (next < ntiles)
      stage_tile<BANDED, TANGENT, kReadU, STAGED, D, M, N>(s_buf + (b ^ 1) * kE * kElem, next, E, X, u, v, st,
                                                           mu, lam, ln, t, g, l);
    const bool real_next = ln.real();
    cp_async_commit();
    if (BANDED) ln = lane_nodes<D, M, N>(next + step, ntiles, E, t, g, l, nodes, block_rows, elements_per_block);
    cp_async_wait_prior();  // this thread's copies of the current tile have landed
    __syncthreads();
    const int e0 = tile * kE, nel = min(kE, E - e0);
    float* el = s_buf + b * kE * kElem + g * kElem;
    std::conditional_t<STAGED, Lame, LameValues> p;
    if constexpr (STAGED) {
      p = {el + Ly::template params<TANGENT>()};
    } else {
      p = {mu.value, lam.value};
    }
    // coordinates relative to node 0 (node 0 itself is not read)
    for (int i = l; i < M; i += L) {
      if (i > 0) {
#pragma unroll
        for (int c = 0; c < D; ++c) el[i * D + c] -= el[c];
      }
    }
    __syncwarp();
    if constexpr (Ly::kNodeLanes) {
      hex8_element<TANGENT, MAT>(el, s_tab, q, l, g < nel && (TANGENT || real), p, s_out + g * Ly::kOut);
    } else {
      split_element<TANGENT, D, M, N, MAT>(el, s_tab, s_T + g * q * Ly::kTq, q, l, g < nel && real, p,
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
          const int a = row / D, c = row - a * D;
          out[a * st.o[0] + c * st.o[1] + (e0 + el_i) * st.o[2]] = s_out[el_i * Ly::kOut + row];
        }
      }
    }
    real = real_next;
  }
}

// BANDED: u (and v) are node vectors [N_nodes][D] read through nodes (the
// padded row -> node table, N rows an element) and block_rows /
// elements_per_block (the element's owner block and its valid rows); X is
// contiguous [M][D][E]; out is element-major [E][N][D].  Otherwise X, u, v and
// out are element-minor views with the strides st.  TANGENT: the Hessian
// actions (reads v); otherwise the internal forces.  mu, lam: one value or
// one an element (Param).  A banded launch whose pair comes by value runs the
// tiles with it as operands (LameValues), the others stage each element's
// pair with its tile (Lame; a value by value is stored there): the strided
// sweeps, off the main path, keep one body (a second doubles the build).
template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT>
__global__ void __launch_bounds__(Layout<D, M, N>::kThreads, sweep_min_blocks<BANDED, D, M, N>())
    sweep_kernel(const float* __restrict__ X, const float* __restrict__ u,
                 const float* __restrict__ v, const int32_t* __restrict__ nodes,
                 const int32_t* __restrict__ block_rows, int elements_per_block,
                 float* __restrict__ out, const Strides32 st, int E,
                 const float* __restrict__ tables, int q, const Param mu, const Param lam) {
  if (BANDED && mu.p == nullptr && lam.p == nullptr) {
    sweep_tiles<BANDED, TANGENT, D, M, N, MAT, false>(X, u, v, nodes, block_rows, elements_per_block, out, st, E,
                                                      tables, q, mu, lam);
  } else {
    sweep_tiles<BANDED, TANGENT, D, M, N, MAT, true>(X, u, v, nodes, block_rows, elements_per_block, out, st, E,
                                                     tables, q, mu, lam);
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
  Param mu, lam;
  cudaStream_t stream;
};

namespace {

// One persistent block per resident slot: min(tiles, blocks an SM x SMs).
template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT>
int launch_sweep(const SweepArgs& a) {
  using Ly = Layout<D, M, N>;
  auto kernel = sweep_kernel<BANDED, TANGENT, D, M, N, MAT>;
  const size_t smem = sweep_smem_floats<TANGENT, D, M, N>(a.q) * sizeof(float);
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

template <int D, int M, int N, int MAT>
int launch_mode(const SweepArgs& a, bool banded) {
  const bool tangent = a.v != nullptr;
  if (banded) return tangent ? launch_sweep<true, true, D, M, N, MAT>(a) : launch_sweep<true, false, D, M, N, MAT>(a);
  return tangent ? launch_sweep<false, true, D, M, N, MAT>(a) : launch_sweep<false, false, D, M, N, MAT>(a);
}

// The 12 host strides (X, u, v, out) as Strides32 for views X [m][d][E] and
// u, v, out [n][d][E]; false if a stride is negative or a view's last offset
// reaches 2^31.
bool strides32(const long long* strides, long long d, long long m, long long n, long long E, Strides32* st) {
  int* dst[4] = {st->x, st->u, st->v, st->o};
  for (int a = 0; a < 4; ++a) {
    const long long extent[3] = {a == 0 ? m : n, d, E};
    long long last = 0;
    for (int k = 0; k < 3; ++k) {
      if (strides[3 * a + k] < 0) return false;
      last += (extent[k] - 1) * strides[3 * a + k];
    }
    if (last >= (1LL << 31)) return false;
    for (int k = 0; k < 3; ++k) dst[a][k] = (int)strides[3 * a + k];
  }
  return true;
}

}  // namespace

// One element's launches (every material and mode), defined in the
// translation unit of its FENRIS_EM_ELEMENT.
template <int D, int M, int N>
int launch_element(const SweepArgs& a, bool banded, int material) {
  switch (material) {
    case kNeoHookean:
      return launch_mode<D, M, N, kNeoHookean>(a, banded);
    case kStVK:
      return launch_mode<D, M, N, kStVK>(a, banded);
    case kLinear:
      return launch_mode<D, M, N, kLinear>(a, banded);
  }
  return (int)cudaErrorInvalidValue;
}

// FENRIS_EM_ELEMENT k instantiates element k (the order of launch() below) and declares the others
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 0
template int launch_element<3, 4, 4>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 4, 4>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 1
template int launch_element<3, 4, 10>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 4, 10>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 2
template int launch_element<3, 4, 20>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 4, 20>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 3
template int launch_element<3, 8, 8>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 8, 8>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 4
template int launch_element<3, 8, 20>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 8, 20>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 5
template int launch_element<3, 8, 27>(const SweepArgs&, bool, int);
#else
extern template int launch_element<3, 8, 27>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 6
template int launch_element<2, 4, 4>(const SweepArgs&, bool, int);
#else
extern template int launch_element<2, 4, 4>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 7
template int launch_element<2, 4, 8>(const SweepArgs&, bool, int);
#else
extern template int launch_element<2, 4, 8>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 8
template int launch_element<2, 4, 9>(const SweepArgs&, bool, int);
#else
extern template int launch_element<2, 4, 9>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 9
template int launch_element<2, 3, 3>(const SweepArgs&, bool, int);
#else
extern template int launch_element<2, 3, 3>(const SweepArgs&, bool, int);
#endif
#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 10
template int launch_element<2, 3, 6>(const SweepArgs&, bool, int);
#else
extern template int launch_element<2, 3, 6>(const SweepArgs&, bool, int);
#endif

#if !defined(FENRIS_EM_ELEMENT) || FENRIS_EM_ELEMENT == 0

namespace {

// The element's launches by (d, m, n): tet4, tet10, tet20, hex8, hex20, hex27; quad4, quad8, quad9,
// tri3, tri6.
int launch(const SweepArgs& a, bool banded, int d, int m, int n, int material) {
  if (d == 3 && m == 4 && n == 4) return launch_element<3, 4, 4>(a, banded, material);
  if (d == 3 && m == 4 && n == 10) return launch_element<3, 4, 10>(a, banded, material);
  if (d == 3 && m == 4 && n == 20) return launch_element<3, 4, 20>(a, banded, material);
  if (d == 3 && m == 8 && n == 8) return launch_element<3, 8, 8>(a, banded, material);
  if (d == 3 && m == 8 && n == 20) return launch_element<3, 8, 20>(a, banded, material);
  if (d == 3 && m == 8 && n == 27) return launch_element<3, 8, 27>(a, banded, material);
  if (d == 2 && m == 4 && n == 4) return launch_element<2, 4, 4>(a, banded, material);
  if (d == 2 && m == 4 && n == 8) return launch_element<2, 4, 8>(a, banded, material);
  if (d == 2 && m == 4 && n == 9) return launch_element<2, 4, 9>(a, banded, material);
  if (d == 2 && m == 3 && n == 3) return launch_element<2, 3, 3>(a, banded, material);
  if (d == 2 && m == 3 && n == 6) return launch_element<2, 3, 6>(a, banded, material);
  return (int)cudaErrorInvalidValue;
}

// mu, lam from the launchers' (pointer, element stride, value) triples; false
// if a pointer's stride is not 0 or 1.
bool lame_params(const void* mu_p, int mu_stride, float mu, const void* lam_p, int lam_stride, float lam,
                 SweepArgs* a) {
  a->mu = {(const float*)mu_p, mu_stride, mu};
  a->lam = {(const float*)lam_p, lam_stride, lam};
  return (mu_p == nullptr || mu_stride == 0 || mu_stride == 1) &&
         (lam_p == nullptr || lam_stride == 0 || lam_stride == 1);
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  Each returns
// cudaGetLastError() after its launch (0 = success), or
// cudaErrorInvalidValue without launching when E * d n >= 2^31, a strided
// view's offsets reach 2^31, a parameter's stride is not 0 or 1, or (d, m, n)
// or the material is not one the kernels take.  v == NULL selects the vector
// sweep (internal forces), otherwise the tangent sweep (Hessian actions of
// v).  d, m, n: the element's dimension (= the solution's components),
// geometry and solution nodes (tet4 3, 4, 4; tet10 3, 4, 10; tet20 3, 4, 20;
// hex8 3, 8, 8; hex20 3, 8, 20; hex27 3, 8, 27; quad4 2, 4, 4; quad8 2, 4, 8;
// quad9 2, 4, 9; tri3 2, 3, 3; tri6 2, 3, 6); material: 0 Neo-Hookean, 1
// StVK, 2 linear elasticity (whose tangent sweep does not read u).  tables:
// a device f32 array [q * d (m + n) + q]: geo_dphi [q][m][d], dphi [q][n][d],
// weights [q].  mu and lam: each a device f32 array read at element e * stride
// (stride 1: [E] values, one an element; stride 0: one value), or, with a
// NULL pointer, the value passed.
//
// fenris_em_sweep: X f32 [m, d, E], u, v and out f32 [n, d, E], all device
// arrays with the element-minor strides given in the host array strides[12]
// (X, u, v, out; each node, component, element; v's are not read when v is
// NULL).
extern "C" int fenris_em_sweep(const void* X, const void* u, const void* v, void* out,
                               const long long* strides, long long E, const void* tables, int q, int d, int m,
                               int n, int material, const void* mu_p, int mu_stride, float mu, const void* lam_p,
                               int lam_stride, float lam, void* stream) {
  if (E == 0) return 0;
  SweepArgs a = {(const float*)X, (const float*)u, (const float*)v, nullptr, nullptr, 1, (float*)out, {},
                 (int)E, (const float*)tables, q, {}, {}, (cudaStream_t)stream};
  if (E * d * n >= (1LL << 31) || !strides32(strides, d, m, n, E, &a.st) ||
      !lame_params(mu_p, mu_stride, mu, lam_p, lam_stride, lam, &a))
    return (int)cudaErrorInvalidValue;
  return launch(a, false, d, m, n, material);
}

// fenris_banded_sweep: the vector or tangent sweep fused with the banded
// gather.  X f32 [m, d, E] contiguous (the padded geometry, E = E_pad); u, v
// f32 [N, d] contiguous node vectors; nodes int32 [E * n] (the plan's
// nodes_padded); block_rows int32 [E / elements_per_block] (valid rows per
// owner block); out f32 [E, n, d] contiguous, 16-byte aligned; per-element
// parameters [E] in the padded element order.
extern "C" int fenris_banded_sweep(const void* X, const void* u, const void* v, const void* nodes,
                                   const void* block_rows, void* out, long long E, int elements_per_block,
                                   const void* tables, int q, int d, int m, int n, int material, const void* mu_p,
                                   int mu_stride, float mu, const void* lam_p, int lam_stride, float lam,
                                   void* stream) {
  if (E == 0) return 0;
  SweepArgs a = {(const float*)X, (const float*)u, (const float*)v, (const int32_t*)nodes,
                 (const int32_t*)block_rows, elements_per_block, (float*)out, {}, (int)E,
                 (const float*)tables, q, {}, {}, (cudaStream_t)stream};
  if (E * d * n >= (1LL << 31) || !lame_params(mu_p, mu_stride, mu, lam_p, lam_stride, lam, &a))
    return (int)cudaErrorInvalidValue;
  return launch(a, true, d, m, n, material);
}

#endif
