// Fused Neo-Hookean element sweeps on unstructured hex8 elements, for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/ops/em_sweep.py:
//   * em_vector_sweep         (body _vector_kernel)         -> fenris_em_sweep, v == NULL
//   * em_vector_tangent_sweep (body _vector_tangent_kernel) -> fenris_banded_tangent_sweep
//                                                              (fused with the banded gather),
//                                                              fenris_em_sweep, v != NULL
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
// Vector sweep.  One thread per element: its 24 node coordinates, 24 dofs
// and 24 outputs stay in registers through the q loop; the basis tables sit
// in shared memory, read as broadcasts.  Inputs and output are element-minor
// views [node][comp][E] with arbitrary strides.
//
// Tangent sweep.  The one-thread-per-element form needed 168 registers (3
// blocks of 128 threads an SM) and ran latency-bound.  Here 8 lanes share
// an element, lane l taking quadrature points l, l + 8, ...:
//   * a block of one warp works on tiles of 4 elements, staging their
//     X, u and v in shared memory (76 floats an element); the tables sit
//     there re-laid per point ([q][52]); a lane reads both as float4, 24
//     values in 6 loads, with no bank conflicts (see lds24);
//   * launch bounds of 24 one-warp blocks an SM: 80 registers, no spills
//     (ptxas), 24 resident warps (the kernel it replaced: 168 registers,
//     20 bytes spilled, 12 warps); blocks of 64 to 256 threads with the
//     same 24 warps ran slower on the card (PERF.md);
//   * persistent blocks (as many as fit on the card) walk the tiles with a
//     two-stage pipeline: the next tile's cp.async copies, and the node
//     indices of the one after, are in flight while the current tile
//     computes, so a block does not wait out the dependent index -> u, v
//     loads between tiles; the tables are staged once per block;
//   * banded mode (fenris_banded_tangent_sweep): u and v are read straight
//     from the node vectors through the plan's row -> node table, lane l
//     copying node l of its element; padding elements get u = v = 0, as the
//     banded gather gives them, so the gather's rows never go to device
//     memory.  X is the padded element-minor geometry [24][E_pad], read as
//     16 contiguous bytes of each of its 24 rows a tile.  The
//     output, element-major rows [E_pad][8][3], is a tile's one contiguous
//     run, written from shared memory with float4 stores;
//   * strided mode (fenris_em_sweep with v): element-minor views with any
//     strides (32-bit offsets) in and out, the same body;
//   * the 24 partial outputs of an element are reduced over its 8 lanes by
//     a fixed reduce-scatter of __shfl_xor_sync (xor 4, 2, 1; 21 shuffles),
//     after which lane l holds node l's 3 sums: no atomics, each sum taken
//     in one fixed order, so two launches are bitwise equal.  Only the order
//     of the sum over q differs from the plain version.
// What bounds it on the H100: about 7.5k f32 operations per element against
// 4 B x (24 X + 8 indices + 24 out) plus u and v from L2: operations.
// Register pressure is the design risk: read `-Xptxas -v` in the library's
// log, _build/libfenris_kernels_<hash>.log, for registers and spills.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// G[d][c] = sum_a gp[a][d] U[a][c], U given as [a][c]
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

// out[a][c] += wdet sum_d gp[a][d] S[c][d]
__device__ __forceinline__ void contract(const float gp[8][3], const float S[3][3], float wdet,
                                         float out[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[a][c] += wdet * (gp[a][0] * S[c][0] + gp[a][1] * S[c][1] + gp[a][2] * S[c][2]);
}

__global__ void __launch_bounds__(kThreads)
    em_vector_kernel(const float* __restrict__ X, const float* __restrict__ u,
                     float* __restrict__ out, const Strides st, int64_t E,
                     const float* __restrict__ tables, int q, float mu, float lam) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < q * kTab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= E) return;
  float Xe[8][3], U[8][3], f[8][3];
  load_nodes(X, st.x, e, Xe);
#pragma unroll
  for (int m = 1; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 3; ++i) Xe[m][i] -= Xe[0][i];
  load_nodes(u, st.u, e, U);
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) f[a][c] = 0.0f;
#pragma unroll 1
  for (int iq = 0; iq < q; ++iq) {
    float gp[8][3];
    const float wdet = geometry(tab + iq * 24, tab + q * 24 + iq * 24, tab[q * 48 + iq], &Xe[0][0], gp);
    float G[3][3], F[3][3], FinvT[3][3], S[3][3];
    gradient(gp, &U[0][0], G);
    const float alpha = kinematics(G, mu, lam, F, FinvT);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) S[i][j] = alpha * FinvT[i][j] + mu * F[i][j];
    contract(gp, S, wdet, f);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[a * st.o[0] + c * st.o[1] + e * st.o[2]] = f[a][c];
}

// -- the tangent sweep: 8 lanes an element --------------------------------------

constexpr int kLanes = 8;                             // lanes per element
constexpr int kTanThreads = 32;
constexpr int kTanElems = kTanThreads / kLanes;       // elements per block
constexpr int kElem = 3 * 24 + 4;                     // shared floats per element: X, u, v, pad
constexpr int kTabS = 2 * 8 * 3 + 4;                  // shared floats per point: geo_dphi, dphi, w, pad
constexpr int kTanMinBlocks = 24;                     // blocks an SM: caps registers at 80

struct Strides32 {  // [node][comp][element] strides, in floats; every offset < 2^31
  int x[3], u[3], v[3], o[3];
};

// Shared-memory reads of 24 floats as 6 float4 (p 16-byte aligned).  Each
// quarter-warp reads one element's words (its 8 lanes broadcast) or, for the
// tables, 8 points' words at a stride of 52 floats, which fall in 8 distinct
// groups of 4 banks: no bank conflicts.
__device__ __forceinline__ void lds24(const float* p, float a[24]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
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

// Shared memory, each part 16-byte aligned: out [kTanElems][24], two
// element buffers [2][kTanElems][kElem] (X, u, v as [node][comp]), tables
// [q][kTabS] (geo_dphi [8][3], dphi [8][3], w).
__host__ __device__ constexpr size_t tangent_smem_floats(int q) {
  return (size_t)kTanElems * 24 + 2 * (size_t)kTanElems * kElem + (size_t)q * kTabS;
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

// Banded mode: a lane's node in a tile, loaded a tile before the staging
// that needs it.  The element is valid iff offset < valid_rows (its row
// offset in its owner block against block_rows[k]); both loads are issued
// without waiting on each other.
struct LaneNode {
  int node, offset, valid_rows;
};

__device__ __forceinline__ LaneNode lane_node(int tile, int ntiles, int E, int g, int l,
                                              const int32_t* __restrict__ nodes,
                                              const int32_t* __restrict__ block_rows,
                                              int elements_per_block) {
  LaneNode r = {0, 1, 0};
  const int e = tile * kTanElems + g;
  if (tile < ntiles && e < E) {
    const int k = e / elements_per_block;
    r.offset = (e - k * elements_per_block) * kLanes;
    r.valid_rows = __ldg(block_rows + k);
    r.node = __ldg(nodes + e * kLanes + l);
  }
  return r;
}

// Issue the cp.asyncs of one tile's X, u and v into buf.  X (and, strided,
// u and v) as (component row, element) pairs, element fastest: coalesced on
// element-minor arrays; banded, lane l copies node l of element g.
// Elements past E and padding elements are zero-filled without a read.
template <bool BANDED>
__device__ __forceinline__ void stage_tile(float* buf, int tile, int E, const float* __restrict__ X,
                                           const float* __restrict__ u,
                                           const float* __restrict__ v, const Strides32& st,
                                           const LaneNode& ln, int t, int g, int l) {
  const int e0 = tile * kTanElems;
  for (int i = t; i < 24 * kTanElems; i += kTanThreads) {
    const int row = i / kTanElems, el = i - row * kTanElems;
    const bool ok = e0 + el < E;
    const int e = ok ? e0 + el : 0;
    float* dst = buf + el * kElem + row;
    if (BANDED) {
      cp_async4(dst, X + row * E + e, ok);  // X contiguous [24][E]
    } else {
      const int m = row / 3, c = row - m * 3;
      cp_async4(dst, X + m * st.x[0] + c * st.x[1] + e * st.x[2], ok);
      cp_async4(dst + 24, u + m * st.u[0] + c * st.u[1] + e * st.u[2], ok);
      cp_async4(dst + 48, v + m * st.v[0] + c * st.v[1] + e * st.v[2], ok);
    }
  }
  if (BANDED) {
    const bool ok = ln.offset < ln.valid_rows;
    const int64_t n3 = (int64_t)ln.node * 3;  // node 0 on padding rows: in range, and not read
    float* dst = buf + g * kElem + l * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cp_async4(dst + 24 + c, u + n3 + c, ok);
      cp_async4(dst + 48 + c, v + n3 + c, ok);
    }
  }
}

// BANDED: u, v are node vectors [N][3] read through nodes (the padded row ->
// node table, 8 rows an element) and block_rows / elements_per_block (the
// element's owner block and its valid rows); X is contiguous [8][3][E]; out
// is element-major [E][8][3].  Otherwise X, u, v and out are element-minor
// views with the strides st.  Persistent blocks walk tiles of kTanElems
// elements (tile, tile + gridDim.x, ...); the cp.asyncs of the next tile and
// the node indices of the one after run while the current tile computes.
template <bool BANDED>
__global__ void __launch_bounds__(kTanThreads, kTanMinBlocks)
    tangent_kernel(const float* __restrict__ X, const float* __restrict__ u,
                   const float* __restrict__ v, const int32_t* __restrict__ nodes,
                   const int32_t* __restrict__ block_rows, int elements_per_block,
                   float* __restrict__ out, const Strides32 st, int E,
                   const float* __restrict__ tables, int q, float mu, float lam) {
  extern __shared__ __align__(16) float smem[];
  float* s_out = smem;
  float* s_buf = s_out + kTanElems * 24;
  float* s_tab = s_buf + 2 * kTanElems * kElem;
  const int t = threadIdx.x, g = t / kLanes, l = t % kLanes;
  const int ntiles = (E + kTanElems - 1) / kTanElems, step = gridDim.x;
  int tile = blockIdx.x;

  LaneNode ln = {0, 1, 0};
  if (BANDED) ln = lane_node(tile, ntiles, E, g, l, nodes, block_rows, elements_per_block);
  stage_tile<BANDED>(s_buf, tile, E, X, u, v, st, ln, t, g, l);
  cp_async_commit();
  if (BANDED) ln = lane_node(tile + step, ntiles, E, g, l, nodes, block_rows, elements_per_block);
  for (int i = t; i < q * kTabS; i += kTanThreads) {
    const int iq = i / kTabS, j = i - iq * kTabS;
    s_tab[i] = j < 24   ? __ldg(tables + iq * 24 + j)
               : j < 48 ? __ldg(tables + q * 24 + iq * 24 + j - 24)
               : j == 48 ? __ldg(tables + q * 48 + iq)
                         : 0.0f;
  }

  for (int b = 0; tile < ntiles; tile += step, b ^= 1) {
    const int next = tile + step;
    if (next < ntiles)
      stage_tile<BANDED>(s_buf + (b ^ 1) * kTanElems * kElem, next, E, X, u, v, st, ln, t, g, l);
    cp_async_commit();
    if (BANDED) ln = lane_node(next + step, ntiles, E, g, l, nodes, block_rows, elements_per_block);
    cp_async_wait_prior();  // this thread's copies of the current tile have landed
    __syncthreads();
    const int e0 = tile * kTanElems, nel = min(kTanElems, E - e0);
    float* el = s_buf + b * kTanElems * kElem + g * kElem;
    if (l > 0) {  // coordinates relative to node 0 (lane 0 leaves node 0, which is not read)
#pragma unroll
      for (int c = 0; c < 3; ++c) el[l * 3 + c] -= el[c];
    }
    __syncwarp();

    // rounds of 8 quadrature points, one a lane; each round's 24 partial
    // outputs are reduced over the lanes at once, so only node l's 3 sums
    // stay live from round to round
    float acc[3] = {0.0f, 0.0f, 0.0f};
    const int rounds = (q + kLanes - 1) / kLanes;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int iq = round * kLanes + l;
      float f[8][3];
      if (g < nel && iq < q) {
        const float* tq = s_tab + iq * kTabS;
        float gd[24], dp[24], A[24], gp[8][3];
        lds24(tq, gd);
        lds24(tq + 24, dp);
        lds24(el, A);  // X relative to node 0
        const float wdet = geometry(gd, dp, tq[48], A, gp);
        float G[3][3], F[3][3], FinvT[3][3], dG[3][3], S[3][3];
        lds24(el + 24, A);  // u
        gradient(gp, A, G);
        const float alpha = kinematics(G, mu, lam, F, FinvT);
        lds24(el + 48, A);  // v
        gradient(gp, A, dG);
        tangent_stress(FinvT, dG, mu, lam, alpha, S);
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
    for (int c = 0; c < 3; ++c) s_out[g * 24 + l * 3 + c] = acc[c];  // node l of element g
    __syncthreads();

    if (BANDED) {  // the tile's rows are one contiguous run of nel * 24 floats
      const float4* src = reinterpret_cast<const float4*>(s_out);
      float4* dst = reinterpret_cast<float4*>(out + (int64_t)e0 * 24);
      for (int i = t; i < nel * 6; i += kTanThreads) dst[i] = src[i];
    } else {
      for (int i = t; i < 24 * kTanElems; i += kTanThreads) {
        const int row = i / kTanElems, el_i = i - row * kTanElems;
        if (el_i < nel) {
          const int m = row / 3, c = row - m * 3;
          out[m * st.o[0] + c * st.o[1] + (e0 + el_i) * st.o[2]] = s_out[el_i * 24 + row];
        }
      }
    }
  }
}

// One persistent block per resident slot: min(tiles, blocks an SM x SMs).
template <bool BANDED>
unsigned int persistent_blocks(long long E, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tangent_kernel<BANDED>, kTanThreads, smem);
  const long long tiles = (E + kTanElems - 1) / kTanElems;
  return (unsigned int)std::max(1LL, std::min(tiles, (long long)std::max(per_sm, 1) * sms));
}

// The 12 host strides (X, u, v, out) as Strides32 for views [8][3][E];
// false if a stride is negative or a view's last offset reaches 2^31.
bool strides32(const long long* strides, long long E, Strides32* st) {
  const long long extent[3] = {8, 3, E};
  int* dst[4] = {st->x, st->u, st->v, st->o};
  for (int a = 0; a < 4; ++a) {
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

int launch_tangent(bool banded, const float* X, const float* u, const float* v,
                   const int32_t* nodes, const int32_t* block_rows, int elements_per_block,
                   float* out, const Strides32& st, long long E, const float* tables, int q,
                   float mu, float lam, cudaStream_t stream) {
  if (E == 0) return 0;
  if (E * 24 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = tangent_smem_floats(q) * sizeof(float);
  if (banded) {
    tangent_kernel<true><<<persistent_blocks<true>(E, smem), kTanThreads, smem, stream>>>(
        X, u, v, nodes, block_rows, elements_per_block, out, st, (int)E, tables, q, mu, lam);
  } else {
    tangent_kernel<false><<<persistent_blocks<false>(E, smem), kTanThreads, smem, stream>>>(
        X, u, v, nullptr, nullptr, 1, out, st, (int)E, tables, q, mu, lam);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  Each returns
// cudaGetLastError() after its launch (0 = success); the tangent sweeps
// return cudaErrorInvalidValue without launching when E * 24 >= 2^31 or a
// strided view's offsets reach 2^31.
// tables: a device f32 array [q * 49]: geo_dphi [q][8][3], dphi [q][8][3],
// weights [q].
//
// fenris_em_sweep: X f32 [8, 3, E], u, v (NULL for the vector sweep) and out
// f32 [8, 3, E], all device arrays with the element-minor strides given in
// the host array strides[12] (X, u, v, out; each node, component, element).
extern "C" int fenris_em_sweep(const void* X, const void* u, const void* v, void* out,
                               const long long* strides, long long E, const void* tables, int q,
                               float mu, float lam, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (E == 0) return 0;
  if (v != nullptr) {
    Strides32 st32;
    if (!strides32(strides, E, &st32)) return (int)cudaErrorInvalidValue;
    return launch_tangent(false, (const float*)X, (const float*)u, (const float*)v, nullptr,
                          nullptr, 1, (float*)out, st32, E, (const float*)tables, q, mu, lam, s);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.u[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const unsigned int blocks = (unsigned int)((E + kThreads - 1) / kThreads);
  const size_t smem = (size_t)q * kTab * sizeof(float);
  em_vector_kernel<<<blocks, kThreads, smem, s>>>((const float*)X, (const float*)u, (float*)out,
                                                  st, E, (const float*)tables, q, mu, lam);
  return (int)cudaGetLastError();
}

// fenris_banded_tangent_sweep: the tangent sweep fused with the banded
// gather.  X f32 [8, 3, E] contiguous (the padded geometry, E = E_pad);
// u, v f32 [N, 3] contiguous node vectors; nodes int32 [E * 8] (the plan's
// nodes_padded); block_rows int32 [E / elements_per_block] (valid rows per
// owner block); out f32 [E, 8, 3] contiguous, 16-byte aligned.
extern "C" int fenris_banded_tangent_sweep(const void* X, const void* u, const void* v,
                                           const void* nodes, const void* block_rows, void* out,
                                           long long E, int elements_per_block, const void* tables,
                                           int q, float mu, float lam, void* stream) {
  if (E * 24 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Strides32 st = {};
  st.x[0] = (int)(3 * E);
  st.x[1] = (int)E;
  st.x[2] = 1;
  return launch_tangent(true, (const float*)X, (const float*)u, (const float*)v,
                        (const int32_t*)nodes, (const int32_t*)block_rows, elements_per_block,
                        (float*)out, st, E, (const float*)tables, q, mu, lam,
                        (cudaStream_t)stream);
}
