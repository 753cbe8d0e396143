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
// Two kernels serve the four launchers, the eleven elements and the three
// materials (132 instantiations): hex8's sweep_kernel<BANDED, TANGENT, 3, 8,
// 8, MAT> and the general element_kernel<BANDED, TANGENT, D, M, N, MAT> of the
// other ten.  Both: a block works on tiles of elements, staging X and u (and
// v), and each element's mu and lam, in shared memory with cp.async; the
// tables sit there re-laid per point; persistent blocks (as many as fit on the
// card) walk the tiles with a two-stage pipeline: the next tile's copies, and
// the node indices of the one after, are in flight while the current tile
// computes.
//   * hex8 (the path the matrix-free solve at 10M dofs runs): one-warp blocks,
//     8 lanes an element; lane l takes quadrature points l, l + 8, ...,
//     computing gp[8][3] and its 24 partial outputs, and the 8 lanes reduce
//     them by a fixed reduce-scatter of __shfl_xor_sync (xor 4, 2, 1; 21
//     shuffles), after which lane l holds node l's 3 sums.  80 registers
//     under the launch bound of 24 blocks an SM (18 blocks, 112 registers,
//     for the strided sweeps, which spill at 80).  Bound by f32 operations.
//   * the general layout (General, kTiling): lanes an element set by the
//     element's canonical rule and node count, blocks of 2-4 warps, a tile of
//     32-64 elements.  One lane an element (tet4, tri3, tri6 and the quads,
//     whose rules have 1-9 points): the lane runs its element's points one
//     after another and adds each point's N x D outputs to its element's sums
//     in registers (SumElement): no idle lanes at 1-point rules, no T in
//     shared memory, and the table rows it reads are the same for the whole
//     warp (broadcasts).  More lanes an element (tet10: 2 at 4 points; tet20,
//     hex20, hex27: 4 at 14 and 27): rounds of L points, each lane one
//     point's T into shared memory, then lanes take the element's nodes and
//     add the round's points (SplitElement): no lane holds N x D sums, which
//     would spill at 20 and 27 nodes.  A point's two gradients (u's and v's)
//     come from one pass over the nodes, each node's table row read once.
//     The staging: X as 16-byte copies of its element-minor rows; u and v word
//     by word, consecutive lanes on consecutive words of a tile's (element,
//     node) runs (the node indices passed between lanes by __shfl_sync: one
//     index register a node), or one 8-byte copy a node in 2D; the tile's
//     output rows overwrite its stage, then leave as float4 runs.
//     What bounds it on the H100 (tools/em_sweep_ab.py's ablations, PERF.md):
//     the tets and the 2D elements by the memory path (the gather of u and v
//     through L1, X, the rows out: at T4-MG the staging alone takes ~70% of
//     the tet4 tangent's time, at M10 ~55% of tet10's), hex20 and hex27 by f32
//     arithmetic issue (staging ~20%).  Launch bounds: the resident blocks
//     shared memory holds at the canonical rule, at most the most at which
//     ptxas spills nothing (kTiling).
//     Tensor cores do not pay here: the two table contractions of the 3D
//     elements (H = dphi^T u, the node sums dphi T) as mma.sync m16n8k8 TF32
//     products with 3xTF32 splits, 8 elements a warp, ran slower than this
//     layout at hex20 and hex27 on the H100 (166-226 registers, 2 blocks an
//     SM; PERF.md), so no element takes them.
// The Lame parameters: a banded launch given one pair by value uses it as
// kernel operands (LameValues); otherwise (a per-element array, element
// stride 1, a device value, stride 0, and every strided launch) each
// element's pair is read from device memory once, staged with its tile, and
// read from shared memory at each use (Lame, LameRows).  The kernels hold both
// bodies and pick one per launch: staged reads cost hex8 ~5% against
// operands, and held in registers across a point the pair pushes hex8 past
// its 80.
//   * banded mode (fenris_banded_sweep): u and v are read straight from the
//     node vectors through the plan's row -> node table, so the gather's rows
//     never go to device memory; padding elements' rows are zeros (hex8:
//     padding elements read nothing and compute zero rows; the others read
//     node 0, whose values nothing uses, and skip their arithmetic).  X is the
//     padded element-minor geometry [Dm][E_pad]; per-element parameters are
//     padded the same way (a padding element reads its filler's).  The
//     output, element-major rows [E_pad][n][D], is a tile's one contiguous run;
//   * strided mode (fenris_em_sweep): element-minor views with any strides
//     (32-bit offsets) in and out, the same bodies;
//   * no atomics: every sum is taken in one fixed order, so two launches are
//     bitwise equal, and an array of one repeated parameter value gives the
//     launch with that value bitwise.  hex8 differs from the plain version
//     only in the order of its sums, the others also in taking the gradients
//     through H and the contraction through T: f32 roundoff either way.
// Register pressure is the design risk: read `-Xptxas -v` in the library's
// log, _build/libfenris_kernels_<hash>.log, for registers and spills.
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

// hex8's tiling (kNodeLanes; the other elements take General): one warp a
// block, 8 lanes an element, lane l taking quadrature points l, l + 8, ...
// and ending with node l's sums (reduce_scatter8).
template <int D, int M, int N>
struct Layout {
  static constexpr bool kNodeLanes = D == 3 && M == 8 && N == 8;
  static constexpr int kLanes = 8;                 // lanes an element
  static constexpr int kThreads = 32;              // one warp a block
  static constexpr int kElems = kThreads / kLanes;  // elements a tile
  static constexpr int kNS = 3;                    // floats a node in the staged u and v
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

// hex8's launch bounds' blocks an SM: 24 (80 registers, no spills) for the
// banded sweeps, 18 (112) for the strided ones (the StVK tangent spills at 96,
// all at 80).
template <bool BANDED, int D, int M, int N>
__host__ __device__ constexpr int sweep_min_blocks() {
  return BANDED ? 24 : 18;
}

// hex8's shared memory, each part 16-byte aligned: out [kElems][kOut], two
// element buffers [2][kElems][elem], tables [q][kTab].
template <bool TANGENT, int D, int M, int N>
__host__ __device__ constexpr size_t sweep_smem_floats(int q) {
  using Ly = Layout<D, M, N>;
  return (size_t)Ly::kOutFloats + 2 * (size_t)Ly::kElems * Ly::template elem<TANGENT>() + (size_t)q * Ly::kTab;
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

// The other elements: J^-1 (J from node-relative X [M][D], word r at
// X_rel[r * XS], and the row's geo_dphi [M][D]) and wdet at one point.
template <int D, int M, int XS>
__device__ __forceinline__ float inverse_jacobian(const float* gd_row, const float* X_rel, float w,
                                                  float Jinv[D][D]) {
  float gd[round4(D * M)], X[D * M];
  lds<D * M>(gd_row, gd);
#pragma unroll
  for (int r = D; r < D * M; ++r) X[r] = X_rel[r * XS];
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

// The tangent's two gradients in one pass over the nodes, each node's dphi
// read once: G from U and dG from V, as ref_gradient computes each.
template <int D, int N>
__device__ __forceinline__ void ref_gradients(const float* dphi, const float* U, const float* V,
                                              const float Jinv[D][D], float G[D][D], float dG[D][D]) {
  constexpr int kNS = D == 3 ? 4 : 2;
  float H[D][D], Hv[D][D];
  {
    const Vec<D> d = Vec<D>::load(dphi), f = Vec<D>::load(U), g = Vec<D>::load(V);
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        H[k][c] = d.v[k] * f.v[c];
        Hv[k][c] = d.v[k] * g.v[c];
      }
  }
  auto add = [&](int a) {
    const Vec<D> d = Vec<D>::load(dphi + a * kNS), f = Vec<D>::load(U + a * kNS), g = Vec<D>::load(V + a * kNS);
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        H[k][c] += d.v[k] * f.v[c];
        Hv[k][c] += d.v[k] * g.v[c];
      }
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
      float acc = Jinv[0][d] * H[0][c], dacc = Jinv[0][d] * Hv[0][c];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        acc += Jinv[k][d] * H[k][c];
        dacc += Jinv[k][d] * Hv[k][c];
      }
      G[d][c] = acc;
      dG[d][c] = dacc;
    }
}

// Asynchronous 4-byte copy global -> shared (cp.async, sm_80+); when valid
// is false nothing is read and a zero is written.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// 8- and 16-byte copies (dst and src aligned to their width; 16 bytes bypass L1)
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Element e's value of a launch parameter into shared memory at dst.
__device__ __forceinline__ void stage_param(float* dst, const Param& p, int e, bool ok) {
  if (p.p != nullptr) {
    cp_async4(dst, p.p + (int64_t)(ok ? e : 0) * p.stride, ok);
  } else {
    *dst = p.value;
  }
}

// hex8, banded mode: the node index of lane l's node in its element g, loaded
// a tile before the staging that needs it, and whether g is real (not
// padding, not past E): iff offset < valid_rows (its row offset in its owner
// block against block_rows[k]); the loads are in flight together.
struct LaneNode {
  int node;
  int offset, valid_rows;
  __device__ bool real() const { return offset < valid_rows; }
};

__device__ __forceinline__ LaneNode lane_node(int tile, int ntiles, int E, int g, int l,
                                              const int32_t* __restrict__ nodes,
                                              const int32_t* __restrict__ block_rows, int elements_per_block) {
  using Ly = Layout<3, 8, 8>;
  LaneNode r = {0, 1, 0};
  if (tile >= ntiles) return r;
  const int e = tile * Ly::kElems + g;
  if (e < E) {
    const int k = e / elements_per_block;
    r.offset = (e - k * elements_per_block) * 8;
    r.valid_rows = __ldg(block_rows + k);
    r.node = __ldg(nodes + e * 8 + l);
  }
  return r;
}

// hex8: start the cp.asyncs of one tile's X and u (and v), and (STAGED) each
// element's mu and lam, into buf.  X (and, strided, the fields) as (component
// row, element) pairs, element fastest: coalesced on element-minor arrays.
// Banded: lane l copies node l of element g, and padding elements are
// zero-filled without a read (the tangent computes their zero rows).
// Elements past E are zero-filled without a read.  READ_U: whether u is
// staged (not for the linear tangent).
template <bool BANDED, bool TANGENT, bool READ_U, bool STAGED>
__device__ __forceinline__ void stage_tile(float* buf, int tile, int E, const float* __restrict__ X,
                                           const float* __restrict__ u, const float* __restrict__ v,
                                           const Strides32& st, const Param& mu, const Param& lam, const LaneNode& ln,
                                           int t, int g, int l) {
  using Ly = Layout<3, 8, 8>;
  constexpr int D = 3, M = 8, N = 8;
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
  if (BANDED) {
    const bool ok = ln.real();
    const int64_t n3 = (int64_t)ln.node * 3;  // node 0 on padding rows: in range, and not read
    float* dst = buf + g * kElem + l * Ly::kNS;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (READ_U) cp_async4(dst + Ly::kU + c, u + n3 + c, ok);
      if (TANGENT) cp_async4(dst + Ly::kV + c, v + n3 + c, ok);
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

// hex8's body (sweep_kernel): persistent blocks walk tiles of kElems
// elements (tile, tile + gridDim.x, ...); the cp.asyncs of the next tile and
// the node indices of the one after run while the current tile computes.
// STAGED: each element's mu and lam come staged with its tile, else the
// launch's one pair is used by value.
template <bool BANDED, bool TANGENT, int MAT, bool STAGED>
__device__ __forceinline__ void sweep_tiles(const float* __restrict__ X, const float* __restrict__ u,
                                            const float* __restrict__ v, const int32_t* __restrict__ nodes,
                                            const int32_t* __restrict__ block_rows, int elements_per_block,
                                            float* __restrict__ out, const Strides32& st, int E,
                                            const float* __restrict__ tables, int q, const Param& mu,
                                            const Param& lam) {
  constexpr int D = 3, M = 8, N = 8;
  using Ly = Layout<D, M, N>;
  constexpr int kElem = Ly::template elem<TANGENT>(), kE = Ly::kElems, kT = Ly::kThreads, L = Ly::kLanes;
  constexpr bool kReadU = !TANGENT || Material<D, MAT>::kTangentReadsU;
  extern __shared__ __align__(16) float smem[];
  float* s_out = smem;
  float* s_buf = s_out + Ly::kOutFloats;
  float* s_tab = s_buf + 2 * kE * kElem;
  const int t = threadIdx.x, g = t / L, l = t % L;
  const int ntiles = (E + kE - 1) / kE, step = gridDim.x;
  int tile = blockIdx.x;

  // real: element g of the tile being staged is not padding (always, strided); padding
  // elements get zero rows without their arithmetic
  LaneNode ln = {0, 0, 1};
  if (BANDED) ln = lane_node(tile, ntiles, E, g, l, nodes, block_rows, elements_per_block);
  stage_tile<BANDED, TANGENT, kReadU, STAGED>(s_buf, tile, E, X, u, v, st, mu, lam, ln, t, g, l);
  bool real = ln.real();
  cp_async_commit();
  if (BANDED) ln = lane_node(tile + step, ntiles, E, g, l, nodes, block_rows, elements_per_block);
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
      stage_tile<BANDED, TANGENT, kReadU, STAGED>(s_buf + (b ^ 1) * kE * kElem, next, E, X, u, v, st, mu, lam, ln,
                                                  t, g, l);
    const bool real_next = ln.real();
    cp_async_commit();
    if (BANDED) ln = lane_node(next + step, ntiles, E, g, l, nodes, block_rows, elements_per_block);
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
    hex8_element<TANGENT, MAT>(el, s_tab, q, l, g < nel && (TANGENT || real), p, s_out + g * Ly::kOut);
    __syncthreads();

    if (BANDED) {  // the tile's rows are one contiguous run of nel * kOut floats
      const int nf = nel * Ly::kOut, n4 = nf / 4;
      const float4* src = reinterpret_cast<const float4*>(s_out);
      float4* dst = reinterpret_cast<float4*>(out + (int64_t)e0 * Ly::kOut);
      for (int i = t; i < n4; i += kT) dst[i] = src[i];
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
  static_assert(Layout<D, M, N>::kNodeLanes, "hex8's kernel");
  if (BANDED && mu.p == nullptr && lam.p == nullptr) {
    sweep_tiles<BANDED, TANGENT, MAT, false>(X, u, v, nodes, block_rows, elements_per_block, out, st, E, tables, q,
                                             mu, lam);
  } else {
    sweep_tiles<BANDED, TANGENT, MAT, true>(X, u, v, nodes, block_rows, elements_per_block, out, st, E, tables, q,
                                            mu, lam);
  }
}

// -- the general layout: every element but hex8 ------------------------------------

// By element, in the FENRIS_EM_ELEMENT order (hex8's row is not read: it has
// its own layout): lanes an element (one: SumElement; more: SplitElement),
// warps a block, the points of its canonical stiffness rule, the most
// resident blocks an SM the launch bound may ask for in the tangent and in the
// vector sweeps (General::kMinBlocks: what shared memory holds at those
// points, at most this: the bound caps a thread's registers at 64K over the
// threads of that many blocks, and these are the most at which ptxas spills
// nothing).  Lanes and warps are the fastest of the variants
// tools/em_sweep_ab.py timed on an H100 (PERF.md).  The points column is
// quadrature.canonical_stiffness's count (tests/test_torch_em.py holds the two
// equal); a launch at another rule runs, at the residency its shared memory
// allows.
constexpr int kTiling[11][5] = {
    {1, 2, 1, 4, 8},    // tet4
    {2, 4, 4, 3, 3},    // tet10
    {4, 4, 14, 3, 3},   // tet20
    {8, 1, 8, 24, 24},  // hex8
    {4, 4, 27, 3, 3},   // hex20
    {4, 4, 27, 3, 4},   // hex27
    {1, 2, 4, 10, 12},  // quad4
    {1, 2, 9, 6, 8},    // quad8
    {1, 2, 9, 6, 8},    // quad9
    {1, 2, 1, 10, 12},  // tri3
    {1, 2, 3, 8, 8},    // tri6
};

__host__ __device__ constexpr int element_id(int d, int m, int n) {
  return d == 3 ? (m == 4 ? (n == 4 ? 0 : n == 10 ? 1 : 2) : (n == 8 ? 3 : n == 20 ? 4 : 5))
                : (m == 4 ? (n == 4 ? 6 : n == 8 ? 7 : 8) : (n == 3 ? 9 : 10));
}

// x (a multiple of w) made an odd number of w-float vectors: records this far
// apart fall in distinct banks for lanes reading one vector each
__host__ __device__ constexpr int odd_units(int x, int w) { return (x / w) % 2 ? x : x + w; }

// The tables of an element, one row a point: geo_dphi [M][D], dphi [N][kNS]
// at kD (one float4 (3D) or float2 (2D) a node), w at kW; rows kTab floats
// (an odd number of float4) apart: lanes at different points read distinct
// bank groups.
template <int D, int M, int N>
struct Tables {
  static constexpr int kNS = D == 3 ? 4 : 2;
  static constexpr int kD = round4(D * M), kW = kD + kNS * N, kTab = odd4(round4(kW + 1));
};

// The general layout of a D-dimensional element of M geometry and N solution
// nodes: kLanes lanes an element, a tile of kElems elements a block.  A stage
// (one tile's inputs) holds X as rows [D M][kElems] (element fastest: 16-byte
// copies from the contiguous banded X, and lanes of consecutive elements read
// consecutive words), the parameter rows [4][kElems] (mu, lam, mu, lam) at kP,
// then each element's fields at kR, kRec floats apart: u [N][kNS] (READ_U)
// and v [N][kNS] at kV (TANGENT).  The tile's output rows [kElems][N D]
// overwrite its stage once it is read.  kSplit: point T through shared memory
// (kTSlots floats an element: two rounds of kLanes points), else no T in
// shared memory.
template <bool TANGENT, bool READ_U, int D, int M, int N>
struct General : Tables<D, M, N> {
  using Tb = Tables<D, M, N>;
  static constexpr bool kTangent = TANGENT, kReadU = READ_U;
  static constexpr int kLanes = kTiling[element_id(D, M, N)][0];
  static constexpr int kThreads = 32 * kTiling[element_id(D, M, N)][1];
  static constexpr int kElems = kThreads / kLanes;
  static constexpr bool kSplit = kLanes > 1;
  static constexpr int kTq = D * Tb::kNS;  // a point's T [D][kNS]
  static constexpr int kOut = D * N;
  static constexpr int kV = READ_U ? N * Tb::kNS : 0;
  static constexpr int kRec = odd_units(kV + (TANGENT ? N * Tb::kNS : 0), Tb::kNS);
  static constexpr int kP = D * M * kElems, kR = kP + 4 * kElems;
  static constexpr int kStage = round4(kR + kElems * kRec);
  static constexpr int kTSlots = kSplit ? odd_units(2 * kLanes * kTq, 4) : 0;
  // node indices a thread stages (banded): items t, t + kThreads, ... of the tile's (element, node) pairs
  static constexpr int kNodeItems = (kElems * N + kThreads - 1) / kThreads;
  __host__ __device__ static constexpr size_t smem_floats(int q) {
    return 2 * (size_t)kStage + (size_t)kElems * kTSlots + (size_t)q * Tb::kTab;
  }
  // an SM's 228 KB of shared memory, 1 KB of it reserved a block
  static constexpr int kFit = (int)(233472 / (smem_floats(kTiling[element_id(D, M, N)][2]) * sizeof(float) + 1024));
  static constexpr int kCap = kTiling[element_id(D, M, N)][TANGENT ? 3 : 4];
  static constexpr int kMinBlocks = kFit < kCap ? kFit : kCap;
  static_assert(kElems % 4 == 0 && kElems * kLanes == kThreads, "a tile's X rows are 16-byte runs");
  static_assert(kElems * kOut <= kStage, "a tile's rows take its stage");
};

template <bool TANGENT, int D, int M, int N, int MAT>
using GeneralOf = General<TANGENT, !TANGENT || Material<D, MAT>::kTangentReadsU, D, M, N>;

// An element's staged mu and lam (Lame's two copies), rows S floats apart.
template <int S>
struct LameRows {
  const float* p;
  __device__ __forceinline__ float mu() const { return p[0]; }
  __device__ __forceinline__ float lam() const { return p[S]; }
  __device__ __forceinline__ LameRows again() const { return {p + 2 * S}; }
};

// Banded mode: the node indices a thread stages in a tile (kNodeItems),
// loaded a tile before the staging that needs them, and whether the thread's
// element is real (LaneNode).
template <int K>
struct TileNodes {
  int node[K];
  int offset, valid_rows;
  __device__ bool real() const { return offset < valid_rows; }
};

template <class G, int N>
__device__ __forceinline__ TileNodes<G::kNodeItems> tile_nodes(int tile, int ntiles, int E, int t, int g,
                                                               const int32_t* __restrict__ nodes,
                                                               const int32_t* __restrict__ block_rows,
                                                               int elements_per_block) {
  TileNodes<G::kNodeItems> r;
  r.offset = 1;
  r.valid_rows = 0;
#pragma unroll
  for (int j = 0; j < G::kNodeItems; ++j) r.node[j] = 0;
  if (tile >= ntiles) return r;
  const int e = tile * G::kElems + g;
  if (e < E) {
    const int k = e / elements_per_block;
    r.offset = (e - k * elements_per_block) * N;
    r.valid_rows = __ldg(block_rows + k);
  }
#pragma unroll
  for (int j = 0; j < G::kNodeItems; ++j) {  // the tile's rows are one contiguous run of the row -> node table
    const int i = t + j * G::kThreads, row = tile * G::kElems * N + i;
    if (i < G::kElems * N && row < E * N) r.node[j] = __ldg(nodes + row);
  }
  return r;
}

// Start the cp.asyncs of one tile's X, fields and (STAGED) parameters into the
// stage buf.  X: wide (banded, E % 4 == 0, X 16-byte aligned) as 16-byte runs
// of 4 elements of a row, else word by word (element fastest).  Banded
// fields: thread t holds the node of the tile's (element, node) pairs t, t +
// kThreads, ... (tile_nodes).  3D: a warp copies its 32 pairs' 3-word runs
// word by word, consecutive lanes on consecutive words (an instruction
// touches the lines of about 11 nodes; one lane a node, it would touch 32
// nodes' lines 3 times); 2D: a lane a node, one 8-byte copy when wide (u and
// v 8-byte aligned; copied word by word, the 2D sweeps spilled); padding rows read node
// 0, whose values nothing uses.  Strided fields: (node component, element) pairs, element
// fastest.  Elements past E are zero-filled without a read.
template <bool BANDED, bool STAGED, class G, int D, int M, int N>
__device__ __forceinline__ void stage_general(float* buf, int tile, int E, const float* __restrict__ X,
                                              const float* __restrict__ u, const float* __restrict__ v,
                                              const Strides32& st, const Param& mu, const Param& lam,
                                              const TileNodes<G::kNodeItems>& tn, int t, bool wide) {
  constexpr int kE = G::kElems, kT = G::kThreads, kNS = G::kNS;
  const int e0 = tile * kE;
  if (BANDED && wide) {
    constexpr int kRuns = kE / 4;
    for (int i = t; i < D * M * kRuns; i += kT) {
      const int row = i / kRuns, el = 4 * (i - row * kRuns);
      const bool ok = e0 + el < E;  // E % 4 == 0: a run is all in or all out
      cp_async16(buf + row * kE + el, X + (int64_t)row * E + (ok ? e0 + el : 0), ok);
    }
  } else {
    for (int i = t; i < D * M * kE; i += kT) {
      const int row = i / kE, el = i - row * kE;
      const bool ok = e0 + el < E;
      const int e = ok ? e0 + el : 0, m = row / D, c = row - m * D;
      cp_async4(buf + row * kE + el,
                BANDED ? X + (int64_t)row * E + e : X + m * st.x[0] + c * st.x[1] + e * st.x[2], ok);
    }
  }
  if (STAGED && t < kE) {
    float* dst = buf + G::kP + t;
    const bool ok = e0 + t < E;
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      stage_param(dst + k * kE, mu, e0 + t, ok);
      stage_param(dst + (k + 1) * kE, lam, e0 + t, ok);
    }
  }
  float* rec = buf + G::kR;
  if (BANDED) {
    const int lane = t & 31, warp0 = t - lane;
#pragma unroll
    for (int j = 0; j < G::kNodeItems; ++j) {
      const int i0 = j * kT + warp0;  // the warp's 32 pairs i0, ..., i0 + 31, one a lane (tn.node[j])
      if (D == 2) {  // a lane a node
        const int i = i0 + lane;
        if (i < kE * N) {
          const int el = i / N, a = i - el * N;
          const bool ok = e0 + el < E;
          const int64_t src = (int64_t)tn.node[j] * D;
          float* dst = rec + el * G::kRec + a * kNS;
          if (wide) {
            if (G::kReadU) cp_async8(dst, u + src, ok);
            if (G::kTangent) cp_async8(dst + G::kV, v + src, ok);
          } else {
#pragma unroll
            for (int c = 0; c < D; ++c) {
              if (G::kReadU) cp_async4(dst + c, u + src + c, ok);
              if (G::kTangent) cp_async4(dst + G::kV + c, v + src + c, ok);
            }
          }
        }
      } else {  // word by word, consecutive lanes on consecutive words of the pairs' D-word runs
#pragma unroll
        for (int w = 0; w < D; ++w) {
          const int word = w * 32 + lane, slot = word / D, c = word - slot * D;
          const int node = __shfl_sync(0xffffffffu, tn.node[j], slot);
          const int i = i0 + slot;
          if (i < kE * N) {
            const int el = i / N, a = i - el * N;
            const bool ok = e0 + el < E;
            const int64_t src = (int64_t)node * D + c;
            float* dst = rec + el * G::kRec + a * kNS + c;
            if (G::kReadU) cp_async4(dst, u + src, ok);
            if (G::kTangent) cp_async4(dst + G::kV, v + src, ok);
          }
        }
      }
    }
  } else {
    for (int i = t; i < D * N * kE; i += kT) {
      const int row = i / kE, el = i - row * kE;
      const bool ok = e0 + el < E;
      const int e = ok ? e0 + el : 0, a = row / D, c = row - a * D;
      float* dst = rec + el * G::kRec + a * kNS + c;
      if (G::kReadU) cp_async4(dst, u + a * st.u[0] + c * st.u[1] + e * st.u[2], ok);
      if (G::kTangent) cp_async4(dst + G::kV, v + a * st.v[0] + c * st.v[1] + e * st.v[2], ok);
    }
  }
}

// T[k][c] = wdet sum_d J^-1[k][d] P[c][d] at the point of table row tq, in
// rows of kNS floats (the padding floats zero): P the stress of u, or its
// tangent along v.  X_rel: the element's node-relative X, words XS apart; U,
// V: its fields [N][kNS].  FUSED: the tangent's two gradients in one pass
// over the nodes (ref_gradients: 7% off hex20's tangent; one lane an element
// holds its N x D sums beside them and ptxas spills, so SumElement passes
// false).
template <bool TANGENT, int D, int M, int N, int MAT, int XS, bool FUSED, class P>
__device__ __forceinline__ void point_T(const float* tq, const float* X_rel, const float* U, const float* V, P p,
                                        float t[]) {
  using Tb = Tables<D, M, N>;
  constexpr int kNS = Tb::kNS;
  constexpr bool kReadU = !TANGENT || Material<D, MAT>::kTangentReadsU;
  float Jinv[D][D], G[D][D], S[D][D];
  const float wdet = inverse_jacobian<D, M, XS>(tq, X_rel, tq[Tb::kW], Jinv);
  Material<D, MAT> mat;
  if (TANGENT && kReadU && FUSED) {
    float dG[D][D];
    ref_gradients<D, N>(tq + Tb::kD, U, V, Jinv, G, dG);
    mat.at(G, p);
    mat.tangent(dG, p.again(), S);
  } else if (TANGENT && kReadU) {
    ref_gradient<D, N>(tq + Tb::kD, U, Jinv, G);
    mat.at(G, p);
    ref_gradient<D, N>(tq + Tb::kD, V, Jinv, G);
    mat.tangent(G, p.again(), S);
  } else if (TANGENT) {
    ref_gradient<D, N>(tq + Tb::kD, V, Jinv, G);
    mat.tangent(G, p.again(), S);
  } else {  // the weight after the sum: the sum cancels to O(strain) at small strains
    ref_gradient<D, N>(tq + Tb::kD, U, Jinv, G);
    mat.at(G, p);
    mat.stress(p, S);
  }
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
}

// One lane an element: the lane takes its element's points one by one and
// adds each point's N x D outputs (sum_k dphi[q][a][k] T[k][c]) to its
// element's sums in registers; no T goes through shared memory.
template <bool TANGENT, int D, int M, int N, int MAT, int XS>
struct SumElement {
  using Tb = Tables<D, M, N>;
  float acc[N * D];
  template <class P>
  __device__ __forceinline__ void compute(const float* X_rel, const float* U, const float* V, const float* s_tab,
                                          int q, bool work, P p) {
    constexpr int kNS = Tb::kNS;
#pragma unroll
    for (int j = 0; j < N * D; ++j) acc[j] = 0.0f;
    if (!work) return;
#pragma unroll 1
    for (int iq = 0; iq < q; ++iq) {
      const float* tq = s_tab + iq * Tb::kTab;
      float t[D * kNS];
      point_T<TANGENT, D, M, N, MAT, XS, false>(tq, X_rel, U, V, p, t);
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const Vec<D> d = Vec<D>::load(tq + Tb::kD + a * kNS);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float s = d.v[0] * t[c];
#pragma unroll
          for (int k = 1; k < D; ++k) s += d.v[k] * t[k * kNS + c];
          acc[a * D + c] += s;
        }
      }
    }
  }
  __device__ __forceinline__ void write(float* o) const {
#pragma unroll
    for (int j = 0; j < N * D; ++j) o[j] = acc[j];
  }
};

// More lanes an element: rounds of L points; in each the element's L lanes compute one
// point's T each into shared memory (sT: two rounds' slots, so one
// __syncwarp a round), then take its nodes (a = l, l + L, ...) and add the
// round's points to their D sums, reading each point's T once: no lane holds
// N x D sums and no shuffle reduce is needed.
template <bool TANGENT, int D, int M, int N, int MAT, int L, int XS>
struct SplitElement {
  using Tb = Tables<D, M, N>;
  static constexpr int K = (N + L - 1) / L, kTq = D * Tb::kNS;
  float acc[K][D];
  int l;
  template <class P>
  __device__ __forceinline__ void compute(const float* X_rel, const float* U, const float* V, const float* s_tab,
                                          float* sT, int q, int lane, bool work, P p) {
    constexpr int kNS = Tb::kNS;
    l = lane;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[j][c] = 0.0f;
    const int rounds = (q + L - 1) / L;
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      float* Tr = sT + (r & 1) * L * kTq;
      const int iq = r * L + l;
      if (work && iq < q) {
        float t[kTq];
        point_T<TANGENT, D, M, N, MAT, XS, true>(s_tab + iq * Tb::kTab, X_rel, U, V, p, t);
        float4* T4 = reinterpret_cast<float4*>(Tr + l * kTq);
#pragma unroll
        for (int i = 0; i < kTq / 4; ++i) T4[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
      }
      __syncwarp();  // the round's T, written by the element's L lanes, is read by all of them
      if (work) {
        const int np = min(L, q - r * L);
        const float* dl = s_tab + r * L * Tb::kTab + Tb::kD + kNS * l;
#pragma unroll
        for (int pi = 0; pi < L; ++pi) {
          if (pi < np) {
            float t[kTq];
            lds<kTq>(Tr + pi * kTq, t);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              if (l + j * L < N) {
                const Vec<D> d = Vec<D>::load(dl + pi * Tb::kTab + kNS * j * L);
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
      }
    }
  }
  __device__ __forceinline__ void write(float* o) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int a = l + j * L;
      if (a < N) {
#pragma unroll
        for (int c = 0; c < D; ++c) o[a * D + c] = acc[j][c];
      }
    }
  }
};

// The general body (element_kernel): persistent blocks walk tiles of kElems
// elements; a tile's copies land in one stage while the tile before computes
// from the other, and the node indices of the tile after are loaded with
// them.  Per tile: wait for its copies and barrier; start the next tile's;
// compute; barrier; write the rows into the stage; barrier; copy them out.
template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT, bool STAGED>
__device__ __forceinline__ void general_tiles(const float* __restrict__ X, const float* __restrict__ u,
                                              const float* __restrict__ v, const int32_t* __restrict__ nodes,
                                              const int32_t* __restrict__ block_rows, int elements_per_block,
                                              float* __restrict__ out, const Strides32& st, int E,
                                              const float* __restrict__ tables, int q, const Param& mu,
                                              const Param& lam, bool wide) {
  using G = GeneralOf<TANGENT, D, M, N, MAT>;
  constexpr int kE = G::kElems, kT = G::kThreads, L = G::kLanes;
  extern __shared__ __align__(16) float smem[];
  float* s_buf = smem;
  float* s_T = s_buf + 2 * G::kStage;  // SplitElement's T
  float* s_tab = s_T + kE * G::kTSlots;
  const int t = threadIdx.x, g = t / L, l = t % L;
  const int ntiles = (E + kE - 1) / kE, step = gridDim.x;
  int tile = blockIdx.x;

  // real: the thread's element of the tile being staged is not padding (always, strided);
  // padding elements get zero rows without their arithmetic
  TileNodes<G::kNodeItems> tn = {};
  tn.offset = 0;
  tn.valid_rows = 1;
  if (BANDED) tn = tile_nodes<G, N>(tile, ntiles, E, t, g, nodes, block_rows, elements_per_block);
  stage_general<BANDED, STAGED, G, D, M, N>(s_buf, tile, E, X, u, v, st, mu, lam, tn, t, wide);
  bool real = tn.real();
  cp_async_commit();
  if (BANDED) tn = tile_nodes<G, N>(tile + step, ntiles, E, t, g, nodes, block_rows, elements_per_block);
  // tables [q][geo_dphi DM | 0 ... | dphi N x kNS | w | 0 ...] from geo_dphi [q][M][D], dphi [q][N][D], w [q]
  for (int i = t; i < q * G::kTab; i += kT) {
    const int iq = i / G::kTab, j = i - iq * G::kTab;
    float x = 0.0f;
    if (j < D * M) {
      x = __ldg(tables + iq * D * M + j);
    } else if (j >= G::kD && j < G::kW) {
      const int a = (j - G::kD) / G::kNS, k = j - G::kD - a * G::kNS;
      if (k < D) x = __ldg(tables + q * D * M + (iq * N + a) * D + k);
    } else if (j == G::kW) {
      x = __ldg(tables + q * D * (M + N) + iq);
    }
    s_tab[i] = x;
  }

  for (int b = 0; tile < ntiles; tile += step, b ^= 1) {
    cp_async_wait_all();  // this thread's copies of the tile have landed
    __syncthreads();      // everyone's; and the last tile's rows are out of the other stage
    const int next = tile + step;
    bool real_next = false;
    if (next < ntiles) {
      stage_general<BANDED, STAGED, G, D, M, N>(s_buf + (b ^ 1) * G::kStage, next, E, X, u, v, st, mu, lam, tn,
                                                t, wide);
      real_next = tn.real();
      cp_async_commit();
      if (BANDED) tn = tile_nodes<G, N>(next + step, ntiles, E, t, g, nodes, block_rows, elements_per_block);
    }
    float* buf = s_buf + b * G::kStage;
    const int e0 = tile * kE, nel = min(kE, E - e0);
    // the element's coordinates relative to node 0, in its column (node 0 itself is not read)
    for (int i = 1 + l; i < M; i += L) {
#pragma unroll
      for (int c = 0; c < D; ++c) buf[(i * D + c) * kE + g] -= buf[c * kE + g];
    }
    if (L > 1) __syncwarp();
    std::conditional_t<STAGED, LameRows<kE>, LameValues> p;
    if constexpr (STAGED) {
      p = {buf + G::kP + g};
    } else {
      p = {mu.value, lam.value};
    }
    const bool work = g < nel && real;
    const float* rec = buf + G::kR + g * G::kRec;
    if constexpr (G::kSplit) {
      SplitElement<TANGENT, D, M, N, MAT, L, kE> el;
      el.compute(buf + g, rec, rec + G::kV, s_tab, s_T + g * G::kTSlots, q, l, work, p);
      __syncthreads();  // the stage is read: the tile's rows take it
      el.write(buf + g * G::kOut);
    } else {
      SumElement<TANGENT, D, M, N, MAT, kE> el;
      el.compute(buf + g, rec, rec + G::kV, s_tab, q, work, p);
      __syncthreads();
      el.write(buf + g * G::kOut);
    }
    __syncthreads();

    if (BANDED) {  // the tile's rows are one contiguous run of nel * kOut floats
      const int nf = nel * G::kOut, n4 = nf / 4;
      const float4* src = reinterpret_cast<const float4*>(buf);
      float4* dst = reinterpret_cast<float4*>(out + (int64_t)e0 * G::kOut);
      for (int i = t; i < n4; i += kT) dst[i] = src[i];
      if constexpr (G::kOut % 4 != 0) {
        for (int i = 4 * n4 + t; i < nf; i += kT) out[(int64_t)e0 * G::kOut + i] = buf[i];
      }
    } else {
      for (int i = t; i < G::kOut * kE; i += kT) {
        const int row = i / kE, el_i = i - row * kE;
        if (el_i < nel) {
          const int a = row / D, c = row - a * D;
          out[a * st.o[0] + c * st.o[1] + (e0 + el_i) * st.o[2]] = buf[el_i * G::kOut + row];
        }
      }
    }
    real = real_next;
  }
}

// The general kernel: arguments as sweep_kernel's; wide: X and the node
// vectors take the wide copies (stage_general).
template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT>
__global__ void __launch_bounds__(GeneralOf<TANGENT, D, M, N, MAT>::kThreads,
                                  GeneralOf<TANGENT, D, M, N, MAT>::kMinBlocks)
    element_kernel(const float* __restrict__ X, const float* __restrict__ u, const float* __restrict__ v,
                   const int32_t* __restrict__ nodes, const int32_t* __restrict__ block_rows,
                   int elements_per_block, float* __restrict__ out, const Strides32 st, int E,
                   const float* __restrict__ tables, int q, const Param mu, const Param lam, int wide) {
  if (BANDED && mu.p == nullptr && lam.p == nullptr) {
    general_tiles<BANDED, TANGENT, D, M, N, MAT, false>(X, u, v, nodes, block_rows, elements_per_block, out, st, E,
                                                        tables, q, mu, lam, wide != 0);
  } else {
    general_tiles<BANDED, TANGENT, D, M, N, MAT, true>(X, u, v, nodes, block_rows, elements_per_block, out, st, E,
                                                       tables, q, mu, lam, wide != 0);
  }
}

}  // namespace

// The launch arguments shared by the entry points.  layout: when not NULL,
// nothing is launched and the launch's geometry is written there instead
// (fenris_em_layout).
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
  int* layout;
};

namespace {

// One persistent block per resident slot: min(tiles, blocks an SM x SMs).
// Returns 0 and the grid in *blocks, or the error of raising the kernel's
// shared memory past the default 48 KB (fails past the card's 227 KB); with
// a.layout, writes there lanes an element, elements a tile, threads a block,
// shared bytes a block and resident blocks an SM.
template <class Kernel>
int persistent_grid(const SweepArgs& a, Kernel kernel, int lanes, int elems, int threads, size_t smem,
                    unsigned int* blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (a.layout != nullptr) {
    const int geometry[5] = {lanes, elems, threads, (int)smem, per_sm};
    std::copy(geometry, geometry + 5, a.layout);
  }
  const long long tiles = (a.E + elems - 1) / elems;
  *blocks = (unsigned int)std::max(1LL, std::min(tiles, (long long)std::max(per_sm, 1) * sms));
  return 0;
}

template <bool BANDED, bool TANGENT, int D, int M, int N, int MAT>
int launch_sweep(const SweepArgs& a) {
  unsigned int blocks = 0;
  if constexpr (D == 3 && M == 8 && N == 8) {  // hex8's own layout
    using Ly = Layout<D, M, N>;
    auto kernel = sweep_kernel<BANDED, TANGENT, D, M, N, MAT>;
    const size_t smem = sweep_smem_floats<TANGENT, D, M, N>(a.q) * sizeof(float);
    const int err = persistent_grid(a, kernel, Ly::kLanes, Ly::kElems, Ly::kThreads, smem, &blocks);
    if (err != 0 || a.layout != nullptr) return err;
    kernel<<<blocks, Ly::kThreads, smem, a.stream>>>(a.X, a.u, a.v, a.nodes, a.block_rows, a.elements_per_block,
                                                     a.out, a.st, a.E, a.tables, a.q, a.mu, a.lam);
  } else {
    using G = GeneralOf<TANGENT, D, M, N, MAT>;
    auto kernel = element_kernel<BANDED, TANGENT, D, M, N, MAT>;
    const size_t smem = G::smem_floats(a.q) * sizeof(float);
    const int err = persistent_grid(a, kernel, G::kLanes, G::kElems, G::kThreads, smem, &blocks);
    if (err != 0 || a.layout != nullptr) return err;
    const bool wide = a.E % 4 == 0 && (uintptr_t)a.X % 16 == 0 && (uintptr_t)a.u % 8 == 0 &&
                      (uintptr_t)a.v % 8 == 0;
    kernel<<<blocks, G::kThreads, smem, a.stream>>>(a.X, a.u, a.v, a.nodes, a.block_rows, a.elements_per_block,
                                                    a.out, a.st, a.E, a.tables, a.q, a.mu, a.lam, (int)wide);
  }
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
                 (int)E, (const float*)tables, q, {}, {}, (cudaStream_t)stream, nullptr};
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
                 (const float*)tables, q, {}, {}, (cudaStream_t)stream, nullptr};
  if (E * d * n >= (1LL << 31) || !lame_params(mu_p, mu_stride, mu, lam_p, lam_stride, lam, &a))
    return (int)cudaErrorInvalidValue;
  return launch(a, true, d, m, n, material);
}

// fenris_em_layout: the geometry of the banded (banded != 0) or strided,
// tangent (tangent != 0) or vector sweep of (d, m, n, material) on q points,
// without launching: out[5] = lanes an element, elements a tile, threads a
// block, shared bytes a block and resident blocks an SM on the current
// device.  Returns as the launchers.
extern "C" int fenris_em_layout(int banded, int tangent, int q, int d, int m, int n, int material, int* out) {
  static const float placeholder = 0.0f;  // a non-NULL v selects the tangent sweep
  SweepArgs a = {nullptr, nullptr, tangent ? &placeholder : nullptr, nullptr, nullptr, 1, nullptr, {}, 1,
                 nullptr, q, {}, {}, nullptr, out};
  return launch(a, banded != 0, d, m, n, material);
}

#endif
