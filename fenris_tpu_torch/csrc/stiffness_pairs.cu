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
// What bounds it on the H100: the output.  Per hex8 element of linear
// elasticity 2,304 bytes are written against ~13k flops in this form, so
// the 2.2 GB of a 1M-element call take ~0.7 ms at 3.35 TB/s and a fifth of
// that at the f32 peak.  The TPU kernel (and this file's first version)
// multiplied by a [d*d*q, n*n] reference projector, four times these
// operations, read from shared memory at one word per FMA.
//
// Design: 32 elements a block, one a lane; 9 warps.
//   * Geometry once: warp w takes quadrature point q = w (and w + 9, ...):
//     J, J^-1, w|det| and the n physical gradient rows G_q[b] of its lane's
//     element, stored as float4 (G, w|det|) in shared memory [q][n][32]
//     (neighbouring lanes on neighbouring float4: no bank conflicts).
//   * Node pairs: warp w then takes the node pairs a <= b numbered w, w + 9,
//     ... (hex8: 36, four a warp).  Per pair the d x d matrix M_ab sums
//     over the points in registers (two float4 reads and d*d FMAs a point);
//     then every computed pair's entries A_p[a][b] = C^p : M_ab and
//     A_p[b][a] = C^p : M_ab^T, the C^p kernel parameters (the constant bank,
//     operands of the FMAs).  Contracting with C after the point sum, and
//     M_ba = M_ab^T, leave ~n^2/2 (q d^2 + ...) FMAs an element where the
//     per-point product G C G^T needs P n^2 q d; no accumulator arrays:
//     40 registers, no spills, five blocks (45 warps) an SM.
//   * Stores: the 32 lanes of a warp hold one output row's 32 consecutive
//     elements: every store (and mirror store) is one coalesced 128-byte
//     run, streamed (st.global.cs: nothing re-reads the output).  The rows
//     are ld >= E floats apart, ld a multiple of 32 (the wrapper pads E), so
//     each run fills whole 128-byte lines: with rows E floats apart and E
//     odd, runs straddle lines and the same stores ran at a third of the
//     card's write rate.
//   * Determinism: no atomics, a fixed summation order; two launches are
//     bitwise equal.  No tensor cores (TF32 would lose the f32 accuracy the
//     JAX package pins).
// Generic in (m, n, q, s) and d in {2, 3}: points and node pairs loop over
// the warps, a ragged last element tile repeats its first element and
// drops its stores; the pair counts instantiated are 1, 3, 4, 6 and 9
// (s <= 3).
//
// Elements whose gradient table does not fit a block (hex20 and hex27: 27
// points, 20 or 27 nodes, 276 or 373 KB) take the points in chunks: the
// warps build the table of qc points at a time in the same shared array,
// and each thread keeps the M of K node pairs in registers across the
// chunks (K = kChunkTasks, a template parameter: K = 1 is the one-chunk
// form above, the table built once).  The K pairs of a round are w, w + 9,
// ..., w + 9 (K - 1) after the round's base; a round rebuilds the table
// once per chunk, so the table is built ceil(n (n + 1) / 2 / (9 K)) times:
// 6 at hex20, 11 at hex27, against the one build of a table that fits.  The
// points are summed in the same order as in one chunk.  32 lanes stay one
// element each, so every store is still a whole 128-byte line (16 lanes
// would fit the whole hex20 table but halve each store run).  The chunk
// is sized for two blocks an SM (kChunkSmem).  The tets (affine geometry)
// run the one-chunk form: their J is the same at every point and is
// formed per point all the same (q = 1, 4, 14).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC
//             (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // elements a block, one a lane
constexpr int kWarps = 9;   // hex8: 36 node pairs a <= b, 4 a warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kMinBlocks = 5;  // blocks an SM holds: at most 45 registers a thread
constexpr int kChunkTasks = 4;  // node pairs a thread keeps in registers when the points come in chunks
constexpr int kChunkMinBlocks = 2;  // chunked form: at most 96 registers a thread (6 pairs spilled)
constexpr size_t kMaxSmem = 232448;  // per block on sm_90
constexpr size_t kChunkSmem = 115712;  // two blocks an SM: (233,472 - 2 x 1,024 reserved) / 2

template <int D, int P>
struct PairConsts {
  float c[P][D][D];  // contraction scalars of upper pair p
  int row[P];        // output block i*s + j of pair p
  int mirror[P];     // block j*s + i written as its node transpose, or -1
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

// Shared floats: gradients [qc][n][32] float4 (qc points of a chunk),
// coordinates [m*d][32], tables gd [q][m][d] | dphi [q][n][d] | w [q].
__host__ __device__ __forceinline__ size_t smem_floats(int m, int n, int q, int qc, int d) {
  return (size_t)qc * n * kLanes * 4 + (size_t)m * d * kLanes + (size_t)q * (m + n) * d + q;
}

// Points a chunk: q when the whole table fits a block, else the fewest chunks of at most
// kChunkSmem bytes, balanced (d = 3 only); 0 when not even one point fits.
__host__ __device__ __forceinline__ int chunk_points(int m, int n, int q, int d) {
  if (smem_floats(m, n, q, q, d) * sizeof(float) <= kMaxSmem) return q;
  if (d != 3) return 0;
  const size_t fixed = smem_floats(m, n, q, 0, d) * sizeof(float);
  const size_t per_point = (size_t)n * kLanes * 4 * sizeof(float);
  if (fixed + per_point > kChunkSmem) return 0;
  const int qmax = (int)((kChunkSmem - fixed) / per_point);
  const int chunks = (q + qmax - 1) / qmax;
  return (q + chunks - 1) / chunks;
}

// Geometry of points q0 .. q0 + nq - 1 into gs[qq - q0][n][32]: one point a warp, one element a
// lane; J from the absolute coordinates, J^-1 and w|det| by cofactors, then the n gradient rows.
template <int D>
__device__ __forceinline__ void build_gradients(float4* gs, const float* xs, const float* gd,
                                                const float* dphi, const float* w, int m, int n,
                                                int q0, int nq, int warp, int lane) {
  for (int qq = q0 + warp; qq < q0 + nq; qq += kWarps) {
    float J[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) J[a][b] = 0.0f;
    for (int mm = 0; mm < m; ++mm) {
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const float x = xs[(mm * D + a) * kLanes + lane];
#pragma unroll
        for (int b = 0; b < D; ++b) J[a][b] = fmaf(gd[(qq * m + mm) * D + b], x, J[a][b]);
      }
    }
    float Jinv[D][D];
    const float wdet = w[qq] * fabsf(inv_det<D>(J, Jinv));
    for (int b = 0; b < n; ++b) {
      const float* dp = dphi + (qq * n + b) * D;
      float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(dp[l], Jinv[l][c], acc);
        g[c] = acc;
      }
      gs[((qq - q0) * n + b) * kLanes + lane] = make_float4(g[0], g[1], g[2], wdet);
    }
  }
}

template <int D, int P, int K>
__global__ void __launch_bounds__(kThreads, K == 1 ? kMinBlocks : kChunkMinBlocks)
    stiffness_pairs_kernel(const float* __restrict__ X, const float* __restrict__ tables,
                           float* __restrict__ out, const PairConsts<D, P> k, int64_t E,
                           int64_t ld, int m, int n, int q, int qc) {
  extern __shared__ __align__(16) float smem[];
  float4* gs = reinterpret_cast<float4*>(smem);  // [qc][n][32]: (G row, w|det|)
  float* xs = smem + (size_t)qc * n * kLanes * 4;  // [m*D][32]
  float* ts = xs + m * D * kLanes;
  const int md = m * D;
  const int ntab = q * (m + n) * D + q;
  const int tid = threadIdx.x, lane = tid & (kLanes - 1), warp = tid / kLanes;
  const int64_t e0 = (int64_t)blockIdx.x * kLanes;
  for (int i = tid; i < ntab; i += kThreads) ts[i] = tables[i];
  // coalesced copy of the block's [32, m*d] coordinates, transposed to
  // [m*d][32]; a ragged last block repeats its first element
  for (int i = tid; i < kLanes * md; i += kThreads) {
    const int el = i / md, c = i - el * md;
    xs[c * kLanes + el] = X[(e0 + el < E) ? e0 * md + i : e0 * md + c];
  }
  __syncthreads();

  const float* gd = ts;
  const float* dphi = ts + q * m * D;
  const float* w = dphi + q * n * D;
  // K = 1: the whole table, built once; else the first chunk (the pair loop builds the others)
  build_gradients<D>(gs, xs, gd, dphi, w, m, n, 0, qc, warp, lane);
  __syncthreads();
  const int64_t e = e0 + lane;
  const bool active = e < E;
  if constexpr (K == 1) {
    if (!active) return;  // no barrier follows in the one-chunk form
  }
  const int64_t nn = (int64_t)n * n;
  const int tasks = n * (n + 1) / 2;
  const int chunks = K == 1 ? 1 : (q + qc - 1) / qc;
  for (int base = 0; base < tasks; base += kWarps * K) {
    // this round's node pairs a <= b of this warp: t = base + warp + 9 kk
    int pa[K], pb[K];
    float M[K][D][D];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      int a = 0, r = base + warp + kWarps * kk;
      if (r < tasks)
        while (r >= n - a) r -= n - a++;
      pa[kk] = a;
      pb[kk] = a + r;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) M[kk][i][j] = 0.0f;
    }
    for (int c = 0; c < chunks; ++c) {
      const int q0 = c * qc, nq = K == 1 ? q : min(qc, q - q0);
      if (chunks > 1 && (base > 0 || c > 0)) {
        __syncthreads();  // the previous chunk's readers are done
        build_gradients<D>(gs, xs, gd, dphi, w, m, n, q0, nq, warp, lane);
        __syncthreads();
      }
      // M_ab += sum over the chunk's points of w|det| G_q[a] G_q[b]^T, points in order
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (base + warp + kWarps * kk >= tasks) continue;
        const int a = pa[kk], b = pb[kk];
        for (int qq = 0; qq < nq; ++qq) {
          const float4* gq = gs + (size_t)qq * n * kLanes + lane;
          const float4 ga = gq[a * kLanes], gb = gq[b * kLanes];
          const float wa[3] = {ga.x * ga.w, ga.y * ga.w, ga.z * ga.w};
          const float g[3] = {gb.x, gb.y, gb.z};
#pragma unroll
          for (int i = 0; i < D; ++i)
#pragma unroll
            for (int j = 0; j < D; ++j) M[kk][i][j] = fmaf(wa[i], g[j], M[kk][i][j]);
        }
      }
    }
    if (!active) continue;  // the chunked form keeps every thread for the barriers
    // every pair's block entries A_p[a][b] = C^p : M and A_p[b][a] = C^p : M^T, with their mirrors
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      if (base + warp + kWarps * kk >= tasks) continue;
      const int a = pa[kk], b = pb[kk];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float ab = 0.0f, ba = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) {
            ab = fmaf(k.c[p][i][j], M[kk][i][j], ab);
            ba = fmaf(k.c[p][i][j], M[kk][j][i], ba);
          }
        float* blk = out + k.row[p] * nn * ld + e;
        __stcs(blk + (int64_t)(a * n + b) * ld, ab);
        if (a != b) __stcs(blk + (int64_t)(b * n + a) * ld, ba);
        if (k.mirror[p] < 0) continue;
        float* mir = out + k.mirror[p] * nn * ld + e;
        __stcs(mir + (int64_t)(b * n + a) * ld, ab);
        if (a != b) __stcs(mir + (int64_t)(a * n + b) * ld, ba);
      }
    }
  }
}

template <int D, int P, int K>
int launch(const float* X, const float* tables, const float* cf, float* out, int64_t E,
           int64_t ld, int m, int n, int q, int qc, int s, int sym, cudaStream_t stream) {
  PairConsts<D, P> k;
  int p = 0;
  for (int i = 0; i < s; ++i)
    for (int j = sym ? i : 0; j < s; ++j, ++p) {
      for (int a = 0; a < D; ++a)
        for (int b = 0; b < D; ++b) k.c[p][a][b] = cf[(p * D + a) * D + b];
      k.row[p] = i * s + j;
      k.mirror[p] = (sym && i != j) ? j * s + i : -1;
    }
  const size_t bytes = smem_floats(m, n, q, qc, D) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stiffness_pairs_kernel<D, P, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)((E + kLanes - 1) / kLanes);
  stiffness_pairs_kernel<D, P, K><<<blocks, kThreads, bytes, stream>>>(X, tables, out, k, E, ld, m,
                                                                       n, q, qc);
  return (int)cudaGetLastError();
}

// one chunk: K = 1; points in chunks (d = 3 only): K = kChunkTasks
template <int D, int P>
int launch_chunks(const float* X, const float* tables, const float* cf, float* out, int64_t E,
                  int64_t ld, int m, int n, int q, int qc, int s, int sym, cudaStream_t st) {
  if (qc == q) return launch<D, P, 1>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
  if constexpr (D == 3)
    return launch<D, P, kChunkTasks>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_pairs(int P, const float* X, const float* tables, const float* cf, float* out,
                 int64_t E, int64_t ld, int m, int n, int q, int qc, int s, int sym,
                 cudaStream_t st) {
  switch (P) {
    case 1: return launch_chunks<D, 1>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
    case 3: return launch_chunks<D, 3>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
    case 4: return launch_chunks<D, 4>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
    case 6: return launch_chunks<D, 6>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
    case 9: return launch_chunks<D, 9>(X, tables, cf, out, E, ld, m, n, q, qc, s, sym, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// X: f32 [E, m, d] element coordinates; tables: f32 device buffer
// [gd (q*m*d) | dphi (q*n*d) | w (q)]; cf: host f32 [P, d, d], the
// contraction scalars of the P computed pairs (i <= j for symmetric
// operators, every (i, j) otherwise, row-major); out: f32 [s*s, n*n, ld],
// its first E columns written (ld >= E).  Device arrays contiguous.
// Returns cudaGetLastError() after the launch (0 = success); d outside
// {2, 3}, a pair count outside {1, 3, 4, 6, 9} or a table of which not
// even one point's chunk fits a block (chunk_points) returns
// cudaErrorInvalidValue without launching.
extern "C" int fenris_stiffness_pairs(const void* X, const void* tables, const void* cf, void* out,
                                      long long E, long long ld, int m, int n, int q, int d, int s,
                                      int sym, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int qc = chunk_points(m, n, q, d);
  if (qc <= 0) return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  if (ld < E) return (int)cudaErrorInvalidValue;
  const int P = sym ? s * (s + 1) / 2 : s * s;
  const float* x = (const float*)X;
  const float* t = (const float*)tables;
  const float* c = (const float*)cf;
  float* o = (float*)out;
  switch (d) {
    case 2: return launch_pairs<2>(P, x, t, c, o, (int64_t)E, (int64_t)ld, m, n, q, qc, s, sym, st);
    case 3: return launch_pairs<3>(P, x, t, c, o, (int64_t)E, (int64_t)ld, m, n, q, qc, s, sym, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
