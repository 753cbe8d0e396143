// Constant-contraction element stiffness matrices (component-pair layout) for sm_90a.
//
// Replaces the Pallas TPU kernel fenris_tpu/ops/stiffness_kernel.py:
//   * stiffness_pairs_pallas (body _kernel) -> fenris_stiffness_pairs
//
// What is computed (the TPU kernel's function): for operators whose
// contraction tensor D is independent of grad u, of position and of the
// element (Laplace, linear elasticity with scalar parameters), element e's
// matrix in the layout out[i*s + j][a*n + b][e] = A_e((a, i), (b, j)):
//   A_e((a, i), (b, j)) = sum_q w_q |det J_q| G_q[a] . C^{ij} G_q[b]
//                       = C^{ij} : M_ab,   M_ab = sum_q w_q |det J_q| G_q[a] G_q[b]^T,
//   J_q[k][l] = sum_m X[e][m][k] gd[q][m][l],  G_q[a][k] = sum_l dphi[q][a][l] J_q^-1[l][k],
// C^{ij} the d x d contraction scalars of the pair (i, j) (the Ft-pair
// average for symmetric operators).  For symmetric operators only the upper
// pairs are computed; the mirror block (j, i) is written as the node
// transpose of block (i, j), as the TPU kernel does.  J is formed from the
// absolute coordinates in the plain version's order (one FMA chain over the
// nodes), so the kernel rounds J as the plain version does.
//
// What bounds it on the H100: the output, s^2 n^2 floats an element (hex20
// linear elasticity: 14,400 bytes against ~100k flops), except for Laplace
// on the 20- and 27-node elements, whose pair sums outweigh their 1,600 or
// 2,916 bytes.  Both are reached only if the pair sums do not wait on shared
// memory: a node pair's point sum needs two gradient rows a point.
//
// Design (every element; on hex8 it was measured faster than a body of one
// node pair a thread, which it replaced):
//   * One table a block, built once: kTiling gives each element and form its
//     elements a block (32, 16 or 8, one a lane), warps and pair tile.  The
//     block's threads build H_q[a] = sqrt(|w_q det J_q|) G_q[a] L for every
//     point, node and element into shared memory [q][n][d][elements] (L the
//     factor below, the identity in the matrix form), read once from the
//     global tables (L1) and the block's coordinates.  w|det| is folded into
//     the rows (its square root into each), so the table is q n d floats an
//     element: hex20's 27 x 20 x 3 fits 16 elements a block twice an SM,
//     hex27's 16 elements once.  The tets and triangles (affine: J is the
//     same at every point) form J and J^-1 L once an element.
//   * Any other rule takes its own instantiation (ANY; the canonical launches
//     keep the code above): a table that does not fit one block (hex20 past
//     29 points in the matrix form, hex27 past 44) in balanced chunks of
//     points, each chunk's table built once, every tile summing it, a thread
//     adding its sums of a later chunk to the entries it stored for the
//     earlier ones (the same thread, the same entries: no atomics, a fixed
//     order); points of negative weight, which the tables list last
//     (ops/stiffness_pairs.py orders them so), subtracted by negating the
//     sums before and after them (exact).
//   * Register-tiled node pairs: the nodes fall in groups of T (kTiling's
//     tile), and a thread sums one T x T tile of node pairs, a group of a
//     nodes against a group of b nodes, upper tiles only: a point's 2 T rows
//     feed T^2 pair products (a diagonal tile loads T rows and sums its
//     T (T + 1) / 2 upper pairs).  A warp's lanes are its elements; with 16
//     (8) elements a block the two (four) lane groups of a warp take every
//     second (fourth) point of the same tile and add their sums by
//     __shfl_xor_sync after the points (the point stride is an odd multiple
//     of the lane group, so the groups read distinct banks).
//   * The scalar form for one contraction pair (Laplace): C = L L^T by
//     Cholesky on the host when C is symmetric positive definite, so
//     A_ab = sum_q H_q[a] . H_q[b], d FMAs a pair and point from one table
//     (t_a = w|det| C G_a against G_b with half the table).  Otherwise (and for
//     s >= 2) the matrix form: M_ab = sum_q H_q[a] H_q[b]^T (d^2 FMAs), then
//     C^p : M_ab and C^p : M_ab^T for every computed pair p, the C^p kernel
//     parameters (constant-bank operands of the FMAs).  Where every C^p is
//     zero but where an isotropic tensor can hold a value (iso_term: linear
//     elasticity, 15 of the 54 terms of 3D's six upper pairs) the launcher
//     takes the isotropic instantiation, which sums those terms alone, in
//     the general chain's order: the zeros it skips add exact zeros there,
//     so the bits are the same, and a node pair's 108 contraction FMAs
//     become 21.
//   * tet20's scalar form (a scalar row with T = 0) needs no table of points:
//     J is the same at every point of a simplex, so sums_kernel contracts
//     the rule's reference sums, summed once on the host, with |det J| J^-1 C
//     J^-T, 6 FMAs a node pair where the points take 42.  On tet4 and tet10
//     the table of points was measured faster (PERF.md).
//   * Stores: the lanes of a lane group hold one output row's consecutive
//     elements: every store (and mirror store) is one whole run of 128, 64 or
//     32 bytes (32-byte sectors at the 32-aligned ld), streamed (st.global.cs:
//     only a later chunk of points re-reads an entry, from the thread that
//     stored it).  With several lane groups each takes
//     every second (fourth) pair of the tile.
//   * Determinism: no atomics, a fixed summation order (points in order within
//     a lane group, the groups' sums added by one butterfly, identical in
//     every lane); each pair is summed once and written to (a, b), (b, a) and
//     their mirrors, so mirror blocks are exact node transposes and two
//     launches are bitwise equal.  No tensor cores (TF32 would lose the f32
//     accuracy the JAX package pins).
// A ragged last element tile repeats its first element and drops its stores.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC
//             (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // per block on sm_90
constexpr int kMaxPairs = 9;         // contraction pairs (s <= 3)

// d, m (geometry nodes), n (nodes) by element, in ops/em_sweep's order
constexpr int kShape[11][3] = {
    {3, 4, 4}, {3, 4, 10}, {3, 4, 20}, {3, 8, 8}, {3, 8, 20}, {3, 8, 27},
    {2, 4, 4}, {2, 4, 8},  {2, 4, 9},  {2, 3, 3}, {2, 3, 6},
};

// By element, for the matrix form (s >= 2, or a contraction that is not
// symmetric positive definite) and the scalar form (one contraction pair, C
// s.p.d.: Laplace): {elements a block (32, 16 or 8: a lane group), warps a
// block, the tile side T (T x T node pairs a thread), the most resident
// blocks an SM the launch bound asks for}.  Elements a block set what shared
// memory holds (the table is q n d floats an element); T sets the registers
// (T^2 d^2 sums in the matrix form): with 3D's 81 sums a thread the bound
// asks for one block of at most 12 warps, so that ptxas may give a thread
// more than 128 registers (at 14-16 warps it held them to 128 and spilled);
// warps split the tiles evenly where they can.  T = 0 in a scalar row (a
// simplex) takes the reference-sums form (sums_kernel) instead of a table of
// points.  Chosen by tools/stiffness_ab.py's variants on an H100 (PERF.md);
// ops/stiffness_pairs.py mirrors the table (tests/test_torch_stiffness_elements.py
// holds the two equal).
constexpr int kTiling[11][2][4] = {
    {{32, 3, 2, 8}, {32, 1, 4, 16}},   // tet4
    {{32, 15, 2, 1}, {32, 3, 5, 8}},   // tet10
    {{32, 12, 3, 1}, {32, 8, 0, 8}},   // tet20
    {{32, 10, 2, 3}, {32, 3, 4, 7}},   // hex8
    {{32, 12, 3, 1}, {16, 10, 5, 2}},  // hex20
    {{16, 12, 3, 1}, {8, 5, 7, 3}},    // hex27
    {{32, 1, 4, 16}, {32, 1, 4, 16}},  // quad4
    {{32, 5, 2, 6}, {32, 3, 4, 8}},    // quad8
    {{32, 3, 3, 8}, {32, 3, 3, 8}},    // quad9
    {{32, 1, 3, 16}, {32, 1, 3, 16}},  // tri3
    {{32, 3, 3, 8}, {32, 1, 6, 16}},   // tri6
};

constexpr int element_id(int d, int m, int n) {
  for (int el = 0; el < 11; ++el)
    if (kShape[el][0] == d && kShape[el][1] == m && kShape[el][2] == n) return el;
  return -1;
}

struct PairConsts {
  float c[kMaxPairs][3][3];  // contraction scalars of computed pair p (d x d used)
  float L[3][3];             // H = sqrt(w|det|) G L: C = L L^T (scalar form), else the identity
  int P;                     // computed pairs
  int row[kMaxPairs];        // output block i*s + j of pair p
  int mirror[kMaxPairs];     // block j*s + i written as its node transpose, or -1
};

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

// J at point qq of the lane-major coordinates xs[(mm*D + k)*et + e], in the plain version's order;
// returns det, with JL = J^-1 L.
template <int D, int M>
__device__ __forceinline__ float jacobian(const float* xs, const float* gd, const float (&L)[3][3], int qq,
                                          int et, int e, float (&JL)[D][D]) {
  float J[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) J[a][b] = 0.0f;
#pragma unroll
  for (int mm = 0; mm < M; ++mm) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float x = xs[(mm * D + a) * et + e];
#pragma unroll
      for (int b = 0; b < D; ++b) J[a][b] = fmaf(__ldg(gd + (qq * M + mm) * D + b), x, J[a][b]);
    }
  }
  float Jinv[D][D];
  const float det = inv_det<D>(J, Jinv);
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) acc = fmaf(Jinv[a][l], L[l][b], acc);
      JL[a][b] = acc;
    }
  return det;
}

// -- the kernel -------------------------------------------------------------------------

template <int EL, bool SCALAR>
struct Tile {
  static constexpr int D = kShape[EL][0], M = kShape[EL][1], N = kShape[EL][2];
  static constexpr int kElems = kTiling[EL][SCALAR][0];  // elements a block: a lane group
  static constexpr int kWarps = kTiling[EL][SCALAR][1];
  static constexpr int T = kTiling[EL][SCALAR][2];
  static constexpr int kMinBlocks = kTiling[EL][SCALAR][3];
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSplit = 32 / kElems;  // lane groups a warp: every kSplit-th point each
  static constexpr int kGroups = T ? (N + T - 1) / T : 0;
  static constexpr int kTiles = kGroups * (kGroups + 1) / 2;
  static constexpr int kAcc = SCALAR ? 1 : D * D;  // sums a node pair
  static constexpr bool kAffine = M == D + 1;      // simplex: J the same at every point
  static constexpr int kRow = (N * D) | 1;        // a point's floats a lane: odd (see kPoint)
  static constexpr int kPoint = kRow * kElems;    // point stride, an odd multiple of the lane group
  static constexpr int kPairs = N * (N + 1) / 2, kSym = D * (D + 1) / 2;  // upper node pairs, upper entries of d x d
  static_assert(T >= 0 && 32 % kElems == 0 && kElems >= 8, "a tile of node pairs and a lane group of 8-32");
  static_assert(T > 0 || (SCALAR && kAffine && kElems == 32), "the reference-sums form: a simplex's scalar row");
};

// Shared floats a block at q points: the table [q][kPoint], the coordinates [m*d][elements], and for the
// affine elements J^-1 L and |det| [d*d + 1][elements]; the reference-sums form (T = 0): the sums
// [pairs][d (d + 1) / 2], the coordinates, K [d (d + 1) / 2][elements] and the pairs' nodes [pairs] (ints).
template <int EL, bool SCALAR>
__host__ __device__ constexpr size_t tile_smem_floats(int q) {
  using S = Tile<EL, SCALAR>;
  if (S::T == 0) return (size_t)S::kPairs * (S::kSym + 1) + (size_t)(S::M * S::D + S::kSym) * S::kElems;
  return (size_t)q * S::kPoint + (size_t)S::M * S::D * S::kElems + (S::kAffine ? (S::D * S::D + 1) * S::kElems : 0);
}

// The u-th upper pair (i, j), i <= j, of n items in row-major order (j >= n past the last).
__host__ __device__ constexpr int upper_pair(int u, int n, bool second) {
  int i = 0, r = u;
  while (i < n - 1 && r >= n - i) r -= n - i++;
  return second ? i + r : i;
}

// Whether entry (c, l) of C^p may be non-zero for an isotropic contraction, C^p the p-th upper pair (i, j) of
// d components: C^{ij}_{cl} = lambda d_ic d_jl + mu (d_il d_jc + d_ij d_cl) (linear elasticity).
__host__ __device__ constexpr bool iso_term(int p, int c, int l, int d) {
  const int i = upper_pair(p, d, false), j = upper_pair(p, d, true);
  return j < d && ((c == i && l == j) || (c == j && l == i) || (i == j && c == l));
}

// Entry p's value v, plus, after a rule's first chunk of points (add), what the earlier chunks stored at p (the
// thread that stores an entry stored it for each of them).
template <bool ANY>
__device__ __forceinline__ float total(const float* p, float v, bool add) {
  if constexpr (ANY) return add ? __ldcg(p) + v : v;
  return v;
}

template <int T, int A>
__device__ __forceinline__ void negate(float (&acc)[T][T][A]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int kk = 0; kk < A; ++kk) acc[i][j][kk] = -acc[i][j][kk];
}

// The entries of node pair (a, b) of an isotropic contraction (iso_term; s = d, symmetric): for the p-th upper
// pair (i, j) of d components, C^p : M and C^p : M^T from its non-zero terms alone, in the general chain's
// order (the zero terms add exact zeros there: the same bits), then pair p + 1.  A diagonal pair's terms
// are M's diagonal, so C^p : M^T = C^p : M.  Block i*d + j and its mirror j*d + i are constants here.
template <int D, int N, int p>
__device__ __forceinline__ void iso_stores(const PairConsts& k, const float* v, int a, int b, float* out, int64_t nn,
                                           int64_t ld) {
  if constexpr (p < D * (D + 1) / 2) {
    constexpr int i = upper_pair(p, D, false), j = upper_pair(p, D, true);
    static_assert(iso_term(p, i, j, D), "the pair's own term");
    float ab, ba;
    if constexpr (i == j) {
      ab = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) ab = fmaf(k.c[p][c][c], v[c * D + c], ab);
      ba = ab;
    } else {
      ab = fmaf(k.c[p][j][i], v[j * D + i], fmaf(k.c[p][i][j], v[i * D + j], 0.0f));
      ba = fmaf(k.c[p][j][i], v[i * D + j], fmaf(k.c[p][i][j], v[j * D + i], 0.0f));
    }
    float* blk = out + (i * D + j) * nn * ld;
    __stcs(blk + (int64_t)(a * N + b) * ld, ab);
    if (a != b) __stcs(blk + (int64_t)(b * N + a) * ld, ba);
    if constexpr (i != j) {
      float* mir = out + (j * D + i) * nn * ld;
      __stcs(mir + (int64_t)(b * N + a) * ld, ab);
      if (a != b) __stcs(mir + (int64_t)(a * N + b) * ld, ba);
    }
    iso_stores<D, N, p + 1>(k, v, a, b, out, nn, ld);
  }
}

// the u-th node pair of a tile: all T^2 row-major, or the T (T + 1) / 2 upper ones of a diagonal tile
template <int T, bool DIAG>
__host__ __device__ constexpr int tile_pair(int u, bool second) {
  return DIAG ? upper_pair(u, T, second) : (second ? u % T : u / T);
}

// One tile (ga, gb) of node-pair sums over this lane group's points of the table (q of them), added across the
// lane groups, then its entries stored.  ANY (a rule taken in chunks or with negative weights): the table's
// points [qp, q) have negative weights, and add says an earlier chunk stored the entries.
template <int EL, bool SCALAR, bool ISO, bool DIAG, bool ANY>
__device__ __forceinline__ void tile_pairs(const float* hs, int q, int qp, int ga, int gb, int e, int h, bool active,
                                           bool add, float* __restrict__ out, const PairConsts& k, int64_t ld) {
  using S = Tile<EL, SCALAR>;
  constexpr int D = S::D, N = S::N, T = S::T, A = S::kAcc, ET = S::kElems;
  float acc[T][T][A];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int kk = 0; kk < A; ++kk) acc[i][j][kk] = 0.0f;
  int oa[T], ob[T];  // lane offsets of the tile's rows in a point's table (rows past n read row n - 1)
#pragma unroll
  for (int i = 0; i < T; ++i) {
    oa[i] = min(ga * T + i, N - 1) * D * ET + e;
    ob[i] = min(gb * T + i, N - 1) * D * ET + e;
  }
  // this lane group's points, every kSplit-th, in order; ANY: [0, qp) add their products, then [qp, q) subtract
  // theirs (the sums negated before and after them)
  const float* hq = hs + (size_t)h * S::kPoint;
  int qq = h;
#pragma unroll 1
  for (int end = ANY ? qp : q;; end = q) {
#pragma unroll 1
    for (; qq < end; qq += S::kSplit, hq += S::kSplit * S::kPoint) {
      float ha[T][D], hb[T][D];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int c = 0; c < D; ++c) ha[i][c] = hq[oa[i] + c * ET];
      if constexpr (DIAG) {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int c = 0; c < D; ++c) hb[i][c] = ha[i][c];
      } else {
#pragma unroll
        for (int j = 0; j < T; ++j)
#pragma unroll
          for (int c = 0; c < D; ++c) hb[j][c] = hq[ob[j] + c * ET];
      }
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = DIAG ? i : 0; j < T; ++j) {
          if constexpr (SCALAR) {
#pragma unroll
            for (int c = 0; c < D; ++c) acc[i][j][0] = fmaf(ha[i][c], hb[j][c], acc[i][j][0]);
          } else {
#pragma unroll
            for (int c = 0; c < D; ++c)
#pragma unroll
              for (int l = 0; l < D; ++l) acc[i][j][c * D + l] = fmaf(ha[i][c], hb[j][l], acc[i][j][c * D + l]);
          }
        }
    }
    if (!ANY || end == q) break;
    negate<T, A>(acc);
  }
  if constexpr (ANY) {
    if (qp < q) negate<T, A>(acc);
  }
  // the lane groups' sums, added by one butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o >= ET; o >>= 1)
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = DIAG ? i : 0; j < T; ++j)
#pragma unroll
        for (int kk = 0; kk < A; ++kk) acc[i][j][kk] += __shfl_xor_sync(0xffffffffu, acc[i][j][kk], o);
  if (!active) return;

  // the tile's pairs, kSplit at a time: lane group h stores pair r * kSplit + h
  constexpr int U = DIAG ? T * (T + 1) / 2 : T * T;
  const int64_t nn = (int64_t)N * N;
#pragma unroll
  for (int r = 0; r < (U + S::kSplit - 1) / S::kSplit; ++r) {
    float v[A];
    int i = 0, j = 0;
    bool have = false;
#pragma unroll
    for (int g = 0; g < S::kSplit; ++g) {
      const int u = r * S::kSplit + g;
      if (u < U && h == g) {
        i = tile_pair<T, DIAG>(u, false);
        j = tile_pair<T, DIAG>(u, true);
        have = true;
#pragma unroll
        for (int kk = 0; kk < A; ++kk) v[kk] = acc[tile_pair<T, DIAG>(u, false)][tile_pair<T, DIAG>(u, true)][kk];
      }
    }
    const int a = ga * T + i, b = gb * T + j;
    if (!have || a >= N || b >= N) continue;
    if constexpr (SCALAR) {
      const float t = total<ANY>(out + (int64_t)(a * N + b) * ld, v[0], add);
      __stcs(out + (int64_t)(a * N + b) * ld, t);
      if (a != b) __stcs(out + (int64_t)(b * N + a) * ld, t);
    } else if constexpr (ISO) {
      iso_stores<D, N, 0>(k, v, a, b, out, nn, ld);
    } else {
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p >= k.P) break;
        float ab = 0.0f, ba = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c)
#pragma unroll
          for (int l = 0; l < D; ++l) {
            ab = fmaf(k.c[p][c][l], v[c * D + l], ab);
            ba = fmaf(k.c[p][c][l], v[l * D + c], ba);
          }
        float* blk = out + k.row[p] * nn * ld;
        ab = total<ANY>(blk + (int64_t)(a * N + b) * ld, ab, add);
        if (a != b) ba = total<ANY>(blk + (int64_t)(b * N + a) * ld, ba, add);
        __stcs(blk + (int64_t)(a * N + b) * ld, ab);
        if (a != b) __stcs(blk + (int64_t)(b * N + a) * ld, ba);
        if (k.mirror[p] < 0) continue;
        float* mir = out + k.mirror[p] * nn * ld;
        __stcs(mir + (int64_t)(b * N + a) * ld, ab);
        if (a != b) __stcs(mir + (int64_t)(a * N + b) * ld, ba);
      }
    }
  }
}

// The table of points [q0, q0 + nq): one (element, point) an item, H_q[a] = sqrt(|w_q det J_q|) dphi_q[a] J_q^-1 L.
template <int EL, bool SCALAR>
__device__ __forceinline__ void build_table(float* hs, const float* xs, const float* jl, const float* gd,
                                            const float* dphi, const float* w, const PairConsts& k, int q0, int nq) {
  using S = Tile<EL, SCALAR>;
  constexpr int D = S::D, M = S::M, N = S::N, ET = S::kElems;
  for (int it = threadIdx.x; it < nq * ET; it += S::kThreads) {
    const int e = it % ET, qq = it / ET;
    float B[D][D], wd;
    if constexpr (S::kAffine) {
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) B[a][b] = jl[(a * D + b) * ET + e];
      wd = __ldg(w + q0 + qq) * jl[D * D * ET + e];
    } else {
      wd = __ldg(w + q0 + qq) * fabsf(jacobian<D, M>(xs, gd, k.L, q0 + qq, ET, e, B));
    }
    const float r = sqrtf(fabsf(wd));
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) B[a][b] *= r;
    float* hp = hs + (size_t)qq * S::kPoint + e;
    const float* dp = dphi + (q0 + qq) * N * D;
#pragma unroll 4
    for (int a = 0; a < N; ++a) {
      float g[D];
#pragma unroll
      for (int l = 0; l < D; ++l) g[l] = __ldg(dp + a * D + l);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(g[l], B[l][c], acc);
        hp[(a * D + c) * ET] = acc;
      }
    }
  }
}

// Every node-pair tile over a table of q points: warp w takes tiles w, w + kWarps, ...
template <int EL, bool SCALAR, bool ISO, bool ANY>
__device__ __forceinline__ void sum_tiles(const float* hs, int q, int qp, int e, int h, bool active, bool add,
                                          float* __restrict__ o, const PairConsts& k, int64_t ld) {
  using S = Tile<EL, SCALAR>;
  for (int t = threadIdx.x >> 5; t < S::kTiles; t += S::kWarps) {
    int ga = 0, r = t;
    while (r >= S::kGroups - ga) r -= S::kGroups - ga++;
    const int gb = ga + r;
    if (ga == gb) {
      tile_pairs<EL, SCALAR, ISO, true, ANY>(hs, q, qp, ga, gb, e, h, active, add, o, k, ld);
    } else if constexpr (S::kGroups > 1) {
      tile_pairs<EL, SCALAR, ISO, false, ANY>(hs, q, qp, ga, gb, e, h, active, add, o, k, ld);
    }
  }
}

// ANY: a rule whose table is taken in chunks of qc points, or with negative weights (the points from qp on);
// otherwise the whole table at once (qc = qp = q).  A register bound only for the canonical launches: ANY
// asks for one block an SM, so that its stores' reads never spill.
template <int EL, bool SCALAR, bool ISO, bool ANY>
__global__ void __launch_bounds__(Tile<EL, SCALAR>::kThreads, ANY ? 1 : Tile<EL, SCALAR>::kMinBlocks)
    pairs_kernel(const float* __restrict__ X, const float* __restrict__ tables, float* __restrict__ out,
                 const __grid_constant__ PairConsts k, int64_t E, int64_t ld, int q, int qc, int qp) {
  using S = Tile<EL, SCALAR>;
  constexpr int D = S::D, M = S::M, ET = S::kElems, MD = M * D;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                              // [qc][kPoint]: H rows [n][d][ET] a point
  float* xs = hs + (size_t)qc * S::kPoint;       // [m*d][ET]
  float* jl = xs + MD * ET;                      // affine: [d*d + 1][ET], J^-1 L and |det|
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t e0 = (int64_t)blockIdx.x * ET;
  // coalesced copy of the block's [ET, m*d] coordinates, transposed to [m*d][ET]; a ragged last block
  // repeats its first element
  for (int i = tid; i < ET * MD; i += S::kThreads) {
    const int el = i / MD, c = i - el * MD;
    xs[c * ET + el] = X[(e0 + el < E) ? e0 * MD + i : e0 * MD + c];
  }
  __syncthreads();
  const float* gd = tables;
  const float* dphi = tables + q * MD;
  const float* w = dphi + q * S::N * D;
  if constexpr (S::kAffine) {
    if (tid < ET) {  // J at the first point: the same at every point of a simplex
      float JL[D][D];
      const float det = jacobian<D, M>(xs, gd, k.L, 0, ET, tid, JL);
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) jl[(a * D + b) * ET + tid] = JL[a][b];
      jl[D * D * ET + tid] = fabsf(det);
    }
    __syncthreads();
  }
  const int e = lane % ET, h = lane / ET;  // lane = (lane group h, element e)
  const bool active = e0 + e < E;
  float* o = out + e0 + e;
  if constexpr (ANY) {
    for (int q0 = 0; q0 < q; q0 += qc) {
      const int nq = min(qc, q - q0);
      if (q0 > 0) __syncthreads();  // every tile has summed the last chunk
      build_table<EL, SCALAR>(hs, xs, jl, gd, dphi, w, k, q0, nq);
      __syncthreads();
      sum_tiles<EL, SCALAR, ISO, ANY>(hs, nq, min(max(qp - q0, 0), nq), e, h, active, q0 > 0, o, k, ld);
    }
  } else {
    build_table<EL, SCALAR>(hs, xs, jl, gd, dphi, w, k, 0, q);
    __syncthreads();
    sum_tiles<EL, SCALAR, ISO, ANY>(hs, q, q, e, h, active, false, o, k, ld);
  }
}

// The reference-sums form (a scalar row's T = 0, a simplex): J is the same at every point, so
//   A_e(a, b) = sum_q w_q |det J| G_q[a] . C G_q[b] = K : R_ab,  K = |det J| (J^-1 L)(J^-1 L)^T = |det J| J^-1 C J^-T,
//   R_ab = sum_q w_q dphi_q[a] dphi_q[b]^T,
// K symmetric: sum_l K_ll R_ab[l][l] + sum_{l < l'} K_ll' (R_ab[l][l'] + R_ab[l'][l]).  The tables carry those
// d (d + 1) / 2 sums of each upper node pair after w ([pairs][d (d + 1) / 2], summed in float64 by
// ops/stiffness_pairs.py), so a pair costs d (d + 1) / 2 FMAs whatever the rule (tet20: 6 where the table of
// points takes 14 x 3), signs and all.  The first warp forms K once an element; warp w then takes pairs w,
// w + kWarps, ..., its lanes 32 elements, and stores (a, b) and (b, a) (the same value: the block is exactly
// symmetric) as whole 128-byte runs.
template <int EL>
__global__ void __launch_bounds__(Tile<EL, true>::kThreads, Tile<EL, true>::kMinBlocks)
    sums_kernel(const float* __restrict__ X, const float* __restrict__ tables, float* __restrict__ out,
                const __grid_constant__ PairConsts k, int64_t E, int64_t ld, int q) {
  using S = Tile<EL, true>;
  constexpr int D = S::D, M = S::M, N = S::N, ET = S::kElems, MD = M * D, U = S::kSym, P = S::kPairs;
  extern __shared__ __align__(16) float smem[];
  float* ss = smem;                              // [P][U]: the reference sums
  float* xs = ss + P * U;                        // [m*d][ET]
  float* ks = xs + MD * ET;                      // [U][ET]: K's upper entries
  int* nodes = (int*)(ks + U * ET);              // [P]: a * N + b
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t e0 = (int64_t)blockIdx.x * ET;
  const float* sums = tables + q * (M + N) * D + q;
  for (int i = tid; i < P * U; i += S::kThreads) ss[i] = __ldg(sums + i);
  for (int p = tid; p < P; p += S::kThreads) nodes[p] = upper_pair(p, N, false) * N + upper_pair(p, N, true);
  for (int i = tid; i < ET * MD; i += S::kThreads) {
    const int el = i / MD, c = i - el * MD;
    xs[c * ET + el] = X[(e0 + el < E) ? e0 * MD + i : e0 * MD + c];
  }
  __syncthreads();
  if (tid < ET) {
    float JL[D][D];
    const float det = fabsf(jacobian<D, M>(xs, tables, k.L, 0, ET, tid, JL));
    int u = 0;
#pragma unroll
    for (int l = 0; l < D; ++l)
#pragma unroll
      for (int l2 = l; l2 < D; ++l2, ++u) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) acc = fmaf(JL[l][c], JL[l2][c], acc);
        ks[u * ET + tid] = det * acc;
      }
  }
  __syncthreads();
  float kk[U];
#pragma unroll
  for (int u = 0; u < U; ++u) kk[u] = ks[u * ET + lane];
  if (e0 + lane >= E) return;
  float* o = out + e0 + lane;
  for (int p = tid >> 5; p < P; p += S::kWarps) {
    const int ab = nodes[p], a = ab / N, b = ab - a * N;
    float v = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) v = fmaf(kk[u], ss[p * U + u], v);
    __stcs(o + (int64_t)(a * N + b) * ld, v);
    if (a != b) __stcs(o + (int64_t)(b * N + a) * ld, v);
  }
}

// -- launchers ------------------------------------------------------------------------------

// Raise the kernel's dynamic shared memory limit to bytes on the current device, once a kernel and device
// (the most set so far is kept).
template <auto Kernel>
int set_smem(size_t bytes) {
  static size_t set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes <= 48 * 1024 || (dev < 64 && bytes <= set[dev])) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) set[dev] = bytes;
  return (int)err;
}

// Shared bytes a block of element EL's launch in this form at q points.
template <int EL>
constexpr size_t form_smem(bool scalar, int q) {
  return (scalar ? tile_smem_floats<EL, true>(q) : tile_smem_floats<EL, false>(q)) * sizeof(float);
}

size_t smem_bytes(int el, bool scalar, int q) {
  switch (el) {
#define FENRIS_SMEM(EL) \
  case EL: return form_smem<EL>(scalar, q);
    FENRIS_SMEM(0) FENRIS_SMEM(1) FENRIS_SMEM(2) FENRIS_SMEM(3) FENRIS_SMEM(4) FENRIS_SMEM(5)
    FENRIS_SMEM(6) FENRIS_SMEM(7) FENRIS_SMEM(8) FENRIS_SMEM(9) FENRIS_SMEM(10)
#undef FENRIS_SMEM
    default: return 0;
  }
}

// Points a chunk: q when the whole table fits a block, else the fewest balanced chunks that fit; 0 when not
// even one point fits.
int chunk_points(int el, bool scalar, int q) {
  if (smem_bytes(el, scalar, q) <= kMaxSmem) return q;
  const size_t fixed = smem_bytes(el, scalar, 0), point = smem_bytes(el, scalar, 1) - fixed;
  if (fixed + point > kMaxSmem) return 0;
  const int most = (int)((kMaxSmem - fixed) / point), chunks = (q + most - 1) / most;
  return (q + chunks - 1) / chunks;
}

template <int EL, bool SCALAR, bool ISO, bool ANY>
int launch_tiles(const float* X, const float* tables, const PairConsts& k, float* out, int64_t E, int64_t ld,
                 int q, int qc, int qp, size_t bytes, cudaStream_t st) {
  using S = Tile<EL, SCALAR>;
  const int err = set_smem<pairs_kernel<EL, SCALAR, ISO, ANY>>(bytes);
  if (err) return err;
  const unsigned int blocks = (unsigned int)((E + S::kElems - 1) / S::kElems);
  pairs_kernel<EL, SCALAR, ISO, ANY><<<blocks, S::kThreads, bytes, st>>>(X, tables, out, k, E, ld, q, qc, qp);
  return (int)cudaGetLastError();
}

// The canonical launches (the whole table in a block, no negative weight) take the scalar form, the isotropic
// terms or the matrix form; any other rule the scalar or the matrix form (whose isotropic terms give the same
// bits) with its chunks and signs.
template <int EL>
int launch_element(bool scalar, bool iso, const float* X, const float* tables, const PairConsts& k, float* out, int64_t E,
                   int64_t ld, int q, int qc, int qp, size_t bytes, cudaStream_t st) {
  if constexpr (Tile<EL, true>::T == 0) {  // the scalar row is the reference-sums form
    if (scalar) {
      using S = Tile<EL, true>;
      const int err = set_smem<sums_kernel<EL>>(bytes);
      if (err) return err;
      sums_kernel<EL><<<(unsigned int)((E + 31) / 32), S::kThreads, bytes, st>>>(X, tables, out, k, E, ld, q);
      return (int)cudaGetLastError();
    }
  }
  if (qc < q || qp < q) {
    if constexpr (Tile<EL, true>::T > 0) {
      if (scalar) return launch_tiles<EL, true, false, true>(X, tables, k, out, E, ld, q, qc, qp, bytes, st);
    }
    return launch_tiles<EL, false, false, true>(X, tables, k, out, E, ld, q, qc, qp, bytes, st);
  }
  if constexpr (Tile<EL, true>::T > 0) {
    if (scalar) return launch_tiles<EL, true, false, false>(X, tables, k, out, E, ld, q, q, q, bytes, st);
  }
  if (iso) return launch_tiles<EL, false, true, false>(X, tables, k, out, E, ld, q, q, q, bytes, st);
  return launch_tiles<EL, false, false, false>(X, tables, k, out, E, ld, q, q, q, bytes, st);
}

// C = L L^T (Cholesky, in double) when C is symmetric positive definite: the scalar form's factor.
bool cholesky(const float* C, int d, float (&L)[3][3]) {
  double l[3][3] = {};
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j)
      if (C[i * d + j] != C[j * d + i]) return false;
  for (int j = 0; j < d; ++j) {
    double s = C[j * d + j];
    for (int kk = 0; kk < j; ++kk) s -= l[j][kk] * l[j][kk];
    if (!(s > 0.0)) return false;
    l[j][j] = sqrt(s);
    for (int i = j + 1; i < d; ++i) {
      double t = C[i * d + j];
      for (int kk = 0; kk < j; ++kk) t -= l[i][kk] * l[j][kk];
      l[i][j] = t / l[j][j];
    }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) L[i][j] = (float)l[i][j];
  return true;
}

// Whether cf's P pairs are an isotropic contraction's (the d (d + 1) / 2 upper pairs of s = d components, each
// zero off iso_term).
bool isotropic(const float* c, int d, int s, int sym, int P) {
  bool iso = sym && s == d;
  for (int p = 0; iso && p < P; ++p)
    for (int a = 0; a < d; ++a)
      for (int b = 0; b < d; ++b) iso &= iso_term(p, a, b, d) || c[(p * d + a) * d + b] == 0.0f;
  return iso;
}

}  // namespace

// X: f32 [E, m, d] element coordinates; tables: f32 device buffer
// [gd (q*m*d) | dphi (q*n*d) | w (q)], the points of negative weight last,
// and for the reference-sums form the sums (sums_kernel) after them;
// cf: host f32 [P*d*d + 1], the contraction scalars [P, d, d] of the P
// computed pairs (i <= j for symmetric operators, every (i, j) otherwise,
// row-major), then the number of points of negative weight; out:
// f32 [s*s, n*n, ld], its first E columns written (ld >= E).  Device arrays
// contiguous.  Returns cudaGetLastError() after the launch (0 = success); an
// element outside kShape or a pair count outside {1, 3, 4, 6, 9} returns
// cudaErrorInvalidValue without launching.
extern "C" int fenris_stiffness_pairs(const void* X, const void* tables, const void* cf, void* out,
                                      long long E, long long ld, int m, int n, int q, int d, int s,
                                      int sym, void* stream) {
  const int el = element_id(d, m, n);
  const int P = sym ? s * (s + 1) / 2 : s * s;
  if (el < 0 || !(P == 1 || P == 3 || P == 4 || P == 6 || P == 9) || q <= 0) return (int)cudaErrorInvalidValue;
  const float* c = (const float*)cf;
  PairConsts k = {};
  for (int i = 0; i < 3; ++i) k.L[i][i] = 1.0f;
  const bool scalar = P == 1 && cholesky(c, d, k.L);
  const int qc = chunk_points(el, scalar, q), neg = (int)c[P * d * d];
  if (qc == 0 || neg < 0 || neg > q) return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  if (ld < E) return (int)cudaErrorInvalidValue;
  k.P = P;
  int p = 0;
  for (int i = 0; i < s; ++i)
    for (int j = sym ? i : 0; j < s; ++j, ++p) {
      for (int a = 0; a < d; ++a)
        for (int b = 0; b < d; ++b) k.c[p][a][b] = c[(p * d + a) * d + b];
      k.row[p] = i * s + j;
      k.mirror[p] = (sym && i != j) ? j * s + i : -1;
    }
  const bool iso = isotropic(c, d, s, sym, P);
  const float* x = (const float*)X;
  const float* t = (const float*)tables;
  float* o = (float*)out;
  const size_t bytes = smem_bytes(el, scalar, qc);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (el) {
#define FENRIS_LAUNCH(EL) \
  case EL: return launch_element<EL>(scalar, iso, x, t, k, o, (int64_t)E, (int64_t)ld, q, qc, q - neg, bytes, st);
    FENRIS_LAUNCH(0) FENRIS_LAUNCH(1) FENRIS_LAUNCH(2) FENRIS_LAUNCH(3) FENRIS_LAUNCH(4) FENRIS_LAUNCH(5)
    FENRIS_LAUNCH(6) FENRIS_LAUNCH(7) FENRIS_LAUNCH(8) FENRIS_LAUNCH(9) FENRIS_LAUNCH(10)
#undef FENRIS_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}
