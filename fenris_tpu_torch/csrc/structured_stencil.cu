// Neo-Hookean residual and Hessian action on a uniform hex8 grid, for sm_90a.
//
// Replaces the Pallas TPU kernels of fenris_tpu/ops/structured_stencil.py:
//   * neo_hookean_residual_pallas (body _kernel, _nh_force_plane)  -> fenris_nh_residual
//   * neo_hookean_hvp_pallas      (body _kernel_hvp, _nh_hvp_plane) -> fenris_nh_hvp
//
// What is computed (identical to the TPU kernels): for every cell, the 8
// corner values of u (and of the direction v) give the displacement
// gradient G at the 8 Gauss points through the constant basis-gradient
// table gp[q][n][d]; F = I + G^T; det F = 1 + gamma with gamma from the
// symbolic expansion; log J = log1p(max(gamma, -0.999999));
// alpha = -mu + lam log J; P = alpha cof(F) / det + mu F (residual) or its
// closed-form tangent dP[dF] (Hessian action).  The stress is contracted
// with gp, weighted with w_q det(J_ref) and summed into the 8 cell nodes.
//
// Both run one kernel body, nh_march<HVP>.  What bounds them on the H100:
// the f32 ALUs.  Their own traffic is the fields and out once each (12 B a
// node each: 25.9 MB for the residual, 38.9 MB for the Hessian action at
// 128x128x64 cells, 0.008 / 0.012 ms at 3.35 TB/s) against ~1.3k / ~2.6k
// operations a cell in the tensor-product form below (0.021 / 0.040 ms at
// 67 TFLOP/s).  A cell's 96 B of contributions written to device memory and
// read back by a second launch would cost 201 MB of traffic, more than the
// 50 MB of L2; the Pallas kernels keep them in a VMEM accumulator while
// they march z-planes, and this kernel does the same on chip:
//   * one launch, no scratch: a block owns 32x10 nodes of a z-slab of 13
//     node layers and computes the 33x11 cells that touch them (one cell of
//     overlap with each neighbour, recomputed: 1.13x the cells); it marches
//     the slab's cell layers (plus the layer below), each thread computes
//     one cell into shared memory, and after a barrier each owning thread
//     sums its node's <= 8 cells in the fixed corner order (0,0,0),
//     (1,0,0), (1,1,0), (0,1,0), (0,0,1), (1,0,1), (1,1,1), (0,1,1) -- this
//     layer's corners 0-3, then the previous layer's 4-7, the order of the
//     plain version's 8 shifted slice-adds -- and writes the node once.  No
//     float atomics: two launches are bitwise equal (the JAX kernels are,
//     and CG relies on it).
//   * staged reads: the node planes of the fields a block needs (34x12
//     nodes; u, and v for the Hessian action) are copied into a ring of
//     three shared-memory planes with cp.async, one plane ahead of the
//     layer being computed.
//   * occupancy: a Hessian-action thread holds both fields' gradient tables
//     and the adjoint table (108 floats), so a block takes an SM (up to 168
//     registers, no spills); its 12 warps keep all four schedulers equally
//     busy between the two barriers of a layer, and 5 slabs x 13 x 4 tiles
//     of the 128x128x64 grid make two full waves on 132 SMs.  A residual
//     thread holds one field's table and the adjoint table (72 floats), and
//     its block 84,576 bytes of shared memory, so two blocks share an SM
//     (at most 80 registers, no spills with the weight folded into the
//     stress' two scalar factors): the 260 blocks run as one wave, and one
//     block's barriers overlap the other's arithmetic (one block an SM ran
//     1.15x slower; PERF.md).
//   * tensor-product arithmetic: on a uniform grid gp[q][n][a] factors into
//     a difference along a times 1-D factors along the other two axes at
//     the two Gauss points, so the gradient at all 8 points is 4 edge
//     differences a derivative and component, interpolated twice (36
//     values a field instead of 8 x 9 dense 8-term sums), and the stress
//     goes back through the adjoint of the same factors.  The wrappers
//     derive the factors from gp and refuse a gp that does not factor.
// The TPU's (8, 128) tile padding and its redundant shared plane are TPU
// structure and are not carried over.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// corner n of a cell -> node offset (di, dj, dk), the hex8 node order
__device__ __forceinline__ int corner_di(int n) { return ((n + 1) >> 1) & 1; }
__device__ __forceinline__ int corner_dj(int n) { return (n >> 1) & 1; }
__device__ __forceinline__ int corner_dk(int n) { return n >> 2; }

// det F = 1 + gamma, with gamma from du/dX = G^T (log1p-stable), and the
// cofactor matrix of F = I + G^T.
__device__ __forceinline__ float kinematics(const float G[3][3], float F[3][3],
                                            float cof[3][3], float* det) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = G[j][i] + (i == j ? 1.0f : 0.0f);
  const float a = G[0][0], b = G[1][0], c = G[2][0];
  const float d = G[0][1], e = G[1][1], f = G[2][1];
  const float g = G[0][2], h = G[1][2], i = G[2][2];
  const float gamma = (a + e + i) + (a * e - b * d + a * i - c * g + e * i - f * h) +
                      (a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g));
  *det = 1.0f + gamma;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int r1 = (r + 1) % 3, r2 = (r + 2) % 3, k1 = (k + 1) % 3, k2 = (k + 2) % 3;
      cof[r][k] = F[r1][k1] * F[r2][k2] - F[r1][k2] * F[r2][k1];
    }
  }
  return log1pf(fmaxf(gamma, -0.999999f));
}

// -- the z-march -----------------------------------------------------------------------

constexpr int kTileX = 32;                       // nodes a block owns along x
constexpr int kTileY = 10;                       // ... along y
constexpr int kCellsX = kTileX + 1;              // cells a block computes along x: one left of its nodes
constexpr int kCellsY = kTileY + 1;
constexpr int kCells = kCellsX * kCellsY;        // 363 cells a layer, one a thread
constexpr int kMarchWarps = 12;                  // 3 on each of an SM's 4 schedulers
constexpr int kMarchThreads = 32 * kMarchWarps;
constexpr int kSlab = 13;                        // cell layers a block marches: 5 slabs of 64 layers
constexpr int kNodesX = kCellsX + 1;             // staged nodes a row: 34
constexpr int kNodesY = kCellsY + 1;             // staged rows: 12, one a warp
constexpr int kPlane = kNodesX * kNodesY;        // floats of one component of one staged node plane
constexpr int kRing = 3;                         // staged node planes: two in use, one in flight
constexpr int kCellStride = 364;                 // floats between the contribution rows of one layer
constexpr int kContribFloats = 24 * kCellStride; // a cell layer's 8 x 3 contributions
constexpr int kResidualMinBlocks = 2;            // residual blocks an SM: at most 80 registers a thread
static_assert(kMarchThreads >= kCells && kCellStride >= kCells, "one thread and one slot a cell");
static_assert(kNodesY == kMarchWarps && kNodesX <= 64, "staging: warp w copies row w, two floats a lane");

// The march's layout for the residual (one field staged) or the Hessian
// action (u and v): floats of one staged node plane, dynamic shared memory
// (residual 84,576 bytes, Hessian action 99,264) and the launch bounds'
// blocks an SM (residual 2, Hessian action 1).
template <bool HVP>
struct March {
  static constexpr int kFields = HVP ? 2 : 1;
  static constexpr int kPlaneFloats = kFields * 3 * kPlane;
  static constexpr int kSmemBytes = (kRing * kPlaneFloats + 2 * kContribFloats) * 4;
  static constexpr int kMinBlocks = HVP ? 1 : kResidualMinBlocks;
};

// The tensor-product factors of the uniform hex8 gradient table: for the
// derivative along axis a, gp[q][n][a] = +-1 (node side along a)
// x t1[a][q_b1][n_b1] x t2[a][q_b2][n_b2] with b1 = (a+1)%3, b2 = (a+2)%3,
// t2 carrying the derivative scale (1/h); w[qz][qy][qx] = w_q det(J_ref).
struct StencilFactors {
  float t1[3][2][2];
  float t2[3][2][2];
  float w[2][2][2];
  float mu;
  float lam;
};
constexpr int kFactorFloats = 32;  // t1, t2, w

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Stages node plane z of the fields (rows y0-1 .. y0+10, columns x0-1 ..
// x0+32, where inside the grid) into its ring slot, [field][s][row][column]:
// warp w copies row w of the field components, lane l columns l and l + 32.
// off0/off1: this thread's two nodes' offsets in a node plane, -1 outside
// the grid or the window.
template <bool HVP>
__device__ __forceinline__ void stage_plane(float* ring, const float* __restrict__ u,
                                            const float* __restrict__ v, int64_t comp,
                                            int64_t plane, int off0, int off1, int z, int nz) {
  if (z < 0 || z >= nz) return;
  float* dst = ring + (z % kRing) * March<HVP>::kPlaneFloats + (threadIdx.x >> 5) * kNodesX + (threadIdx.x & 31);
  const int64_t zoff = z * plane;
#pragma unroll
  for (int fs = 0; fs < 3 * March<HVP>::kFields; ++fs) {  // fs = field * 3 + s
    const float* src = (fs < 3 ? u : v) + (fs % 3) * comp + zoff;
    if (off0 >= 0) cp_async4(dst + fs * kPlane, src + off0);
    if (off1 >= 0) cp_async4(dst + fs * kPlane + 32, src + off1);
  }
}

// Gradient table of one field at the 8 Gauss points of a cell, from its
// corners c[dk][dj][di][s]: Gt[a][p1][p2][s] is d/dx_a of component s at
// every point with q_b1 = p1, q_b2 = p2 (it does not depend on q_a): the 4
// edge differences along a, interpolated along b1, then along b2.
__device__ __forceinline__ void gradient_table(const StencilFactors& t, const float c[2][2][2][3],
                                               float Gt[3][2][2][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float e[2][2];
#pragma unroll
      for (int m1 = 0; m1 < 2; ++m1) {
#pragma unroll
        for (int m2 = 0; m2 < 2; ++m2) {
          int o[3];
          o[(a + 1) % 3] = m1;
          o[(a + 2) % 3] = m2;
          o[a] = 1;
          const float hi = c[o[2]][o[1]][o[0]][s];
          o[a] = 0;
          e[m1][m2] = hi - c[o[2]][o[1]][o[0]][s];
        }
      }
#pragma unroll
      for (int p1 = 0; p1 < 2; ++p1) {
        const float r0 = t.t1[a][p1][0] * e[0][0] + t.t1[a][p1][1] * e[1][0];
        const float r1 = t.t1[a][p1][0] * e[0][1] + t.t1[a][p1][1] * e[1][1];
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2) Gt[a][p1][p2][s] = t.t2[a][p2][0] * r0 + t.t2[a][p2][1] * r1;
      }
    }
  }
}

// The adjoint of gradient_table: the weighted stresses summed per point
// pair, At[a][p1][p2][s], back along b2, then b1, then the edge difference,
// into the cell's 8x3 contributions f[n][s] (hex8 node order).
__device__ __forceinline__ void adjoint_table(const StencilFactors& t, const float At[3][2][2][3],
                                              float f[8][3]) {
  float fc[2][2][2][3];
#pragma unroll
  for (int dk = 0; dk < 2; ++dk)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int s = 0; s < 3; ++s) fc[dk][dj][di][s] = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float r[2][2];  // [p1][m2]
#pragma unroll
      for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
        for (int m2 = 0; m2 < 2; ++m2)
          r[p1][m2] = t.t2[a][0][m2] * At[a][p1][0][s] + t.t2[a][1][m2] * At[a][p1][1][s];
#pragma unroll
      for (int m1 = 0; m1 < 2; ++m1) {
#pragma unroll
        for (int m2 = 0; m2 < 2; ++m2) {
          const float e = t.t1[a][0][m1] * r[0][m2] + t.t1[a][1][m1] * r[1][m2];
          int o[3];
          o[(a + 1) % 3] = m1;
          o[(a + 2) % 3] = m2;
          o[a] = 1;
          fc[o[2]][o[1]][o[0]][s] += e;
          o[a] = 0;
          fc[o[2]][o[1]][o[0]][s] -= e;
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int s = 0; s < 3; ++s) f[n][s] = fc[corner_dk(n)][corner_dj(n)][corner_di(n)][s];
}

__device__ __forceinline__ void load_cell(const float* lo, const float* hi, int off,
                                          float c[2][2][2][3]) {
#pragma unroll
  for (int dk = 0; dk < 2; ++dk)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int s = 0; s < 3; ++s)
          c[dk][dj][di][s] = (dk ? hi : lo)[s * kPlane + off + dj * kNodesX + di];
}

// One cell's 8x3 contributions f[n][s] (hex8 node order): the residual's
// internal forces or (HVP) the Hessian action.  lo/hi: the staged planes
// below and above the cell; off: its (0,0,0) node.
template <bool HVP>
__device__ __forceinline__ void march_cell(const StencilFactors& t, const float* lo, const float* hi,
                                           int off, float f[8][3]) {
  float Gu[3][2][2][3], Gv[3][2][2][3], At[3][2][2][3];
  {
    float c[2][2][2][3];
    load_cell(lo, hi, off, c);
    gradient_table(t, c, Gu);
    if (HVP) {
      load_cell(lo + 3 * kPlane, hi + 3 * kPlane, off, c);
      gradient_table(t, c, Gv);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2)
#pragma unroll
        for (int s = 0; s < 3; ++s) At[a][p1][p2][s] = 0.0f;
#pragma unroll
  for (int qz = 0; qz < 2; ++qz) {
#pragma unroll
    for (int qy = 0; qy < 2; ++qy) {
#pragma unroll
      for (int qx = 0; qx < 2; ++qx) {
        const int qa[3] = {qx, qy, qz};
        float G[3][3], F[3][3], cof[3][3], det;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int s = 0; s < 3; ++s) G[a][s] = Gu[a][qa[(a + 1) % 3]][qa[(a + 2) % 3]][s];
        const float logJ = kinematics(G, F, cof, &det);
        const float alpha = -t.mu + t.lam * logJ;
        const float inv_det = __frcp_rn(det);  // == 1.0f / det, without the division routine
        const float w = t.w[qz][qy][qx];
        if (HVP) {
          float dF[3][3];
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) dF[i][j] = Gv[j][qa[(j + 1) % 3]][qa[(j + 2) % 3]][i];
          float ddet = 0.0f;
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) ddet += cof[i][j] * dF[i][j];
          // dP = mu dF + (dalpha cof + alpha dcof) / det - beta cof = mu dF + ca cof + cb dcof
          const float ca = (t.lam - alpha) * (ddet * inv_det) * inv_det, cb = alpha * inv_det;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int i1 = (i + 1) % 3, i2 = (i + 2) % 3, j1 = (j + 1) % 3, j2 = (j + 2) % 3;
              const float dcof = dF[i1][j1] * F[i2][j2] + F[i1][j1] * dF[i2][j2] -
                                 dF[i1][j2] * F[i2][j1] - F[i1][j2] * dF[i2][j1];
              const float dP = t.mu * dF[i][j] + ca * cof[i][j] + cb * dcof;
              // dP[s = i][d = j] into the adjoint table of the derivative along j
              At[j][qa[(j + 1) % 3]][qa[(j + 2) % 3]][i] += w * dP;
            }
          }
        } else {
          // w P = (w alpha / det) cof + (w mu) F: P = alpha F^-T + mu F, F^-T = cof / det
          const float wa = w * alpha * inv_det, wm = w * t.mu;
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) At[j][qa[(j + 1) % 3]][qa[(j + 2) % 3]][i] += wa * cof[i][j] + wm * F[i][j];
        }
      }
    }
  }
  adjoint_table(t, At, f);
}

// Block (bx, by, bz) owns the nodes x0 <= x < xend, y0 <= y < yend,
// z0 <= z < zend (x0 = kTileX bx, y0 = kTileY by, z0 = kSlab bz; the end is
// the grid's last node where the next tile would hold only that node).  It
// marches the cell layers L = z0-1 .. zend-1: each thread computes one of the
// cells touching its nodes into shared memory, then each owning thread sums
// its node's <= 8 cells in the fixed corner order (layer L's corners 0-3,
// then layer L-1's corners 4-7) and writes node layer L once.  v is read
// only by the Hessian action.
template <bool HVP>
__global__ void __launch_bounds__(kMarchThreads, March<HVP>::kMinBlocks)
    nh_march(const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ out,
             int nz, int ny, int nx, const StencilFactors t) {
  constexpr int kPlaneFloats = March<HVP>::kPlaneFloats;
  extern __shared__ float smem[];
  float* ring = smem;
  float* contrib = smem + kRing * kPlaneFloats;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY, z0 = blockIdx.z * kSlab;
  const int ncx = nx - 1, ncy = ny - 1, ncz = nz - 1;
  const int xend = x0 + kTileX >= ncx ? nx : x0 + kTileX;
  const int yend = y0 + kTileY >= ncy ? ny : y0 + kTileY;
  const int zend = z0 + kSlab >= ncz ? nz : z0 + kSlab;
  const int tid = threadIdx.x;
  const int lx = tid % kCellsX, ly = tid / kCellsX;
  // this thread's cell (x0-1+lx, y0-1+ly) and its owned node (x0+lx, y0+ly)
  const bool cell_xy = tid < kCells && x0 - 1 + lx >= 0 && x0 - 1 + lx < ncx &&
                       y0 - 1 + ly >= 0 && y0 - 1 + ly < ncy;
  const int gx = x0 + lx, gy = y0 + ly;
  const bool owner = tid < kCells && gx < xend && gy < yend;
  const int64_t plane = (int64_t)ny * nx, comp = plane * nz;
  // the staged nodes this thread copies: row y0-1+warp, columns x0-1+lane and x0+31+lane
  const int sy = y0 - 1 + (tid >> 5), sx = x0 - 1 + (tid & 31);
  const bool row_in = sy >= 0 && sy < ny;
  const int off0 = row_in && sx >= 0 && sx < nx ? sy * nx + sx : -1;
  const int off1 = row_in && (tid & 31) + 32 < kNodesX && sx + 32 < nx ? sy * nx + sx + 32 : -1;

  stage_plane<HVP>(ring, u, v, comp, plane, off0, off1, z0 - 1, nz);
  cp_async_commit();
  stage_plane<HVP>(ring, u, v, comp, plane, off0, off1, z0, nz);
  cp_async_commit();
  for (int L = z0 - 1; L < zend; ++L) {
    if (L + 2 <= zend) stage_plane<HVP>(ring, u, v, comp, plane, off0, off1, L + 2, nz);
    cp_async_commit();
    cp_async_wait_one();  // planes L and L+1 have landed (this thread's copies) ...
    __syncthreads();      // ... everyone's; and layer L-2's contributions are no longer read
    float* cur = contrib + ((L + 2) & 1) * kContribFloats;
    if (cell_xy && L >= 0 && L < ncz) {
      float f[8][3];
      march_cell<HVP>(t, ring + (L % kRing) * kPlaneFloats, ring + ((L + 1) % kRing) * kPlaneFloats,
                      ly * kNodesX + lx, f);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int s = 0; s < 3; ++s) cur[(n * 3 + s) * kCellStride + tid] = f[n][s];
    }
    __syncthreads();
    if (owner && L >= z0) {
      const float* prev = contrib + ((L + 1) & 1) * kContribFloats;
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int di = corner_di(n), dj = corner_dj(n), dk = corner_dk(n);
        const int cx = gx - di, cy = gy - dj, cz = L - dk;
        if (cx < 0 || cx >= ncx || cy < 0 || cy >= ncy || cz < 0 || cz >= ncz) continue;
        const float* src = (dk ? prev : cur) + (ly + 1 - dj) * kCellsX + (lx + 1 - di);
#pragma unroll
        for (int s = 0; s < 3; ++s) acc[s] += src[(n * 3 + s) * kCellStride];
      }
      const int64_t node = ((int64_t)L * ny + gy) * nx + gx;
#pragma unroll
      for (int s = 0; s < 3; ++s) out[s * comp + node] = acc[s];
    }
  }
}

template <bool HVP>
int launch_march(const float* u, const float* v, float* out, int nz, int ny, int nx,
                 const void* factors, float mu, float lam, cudaStream_t stream) {
  StencilFactors t;
  memcpy(&t, factors, kFactorFloats * sizeof(float));
  t.mu = mu;
  t.lam = lam;
  constexpr int smem = March<HVP>::kSmemBytes;
  const int err = (int)cudaFuncSetAttribute(nh_march<HVP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const dim3 grid((nx - 1 + kTileX - 1) / kTileX, (ny - 1 + kTileY - 1) / kTileY,
                  (nz - 1 + kSlab - 1) / kSlab);
  nh_march<HVP><<<grid, kMarchThreads, smem, stream>>>(u, v, out, nz, ny, nx, t);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  Grids are
// contiguous f32 [3, nz, ny, nx]; factors are host f32 [32]
// (StencilFactors: t1, t2, w).  Each returns cudaGetLastError() after its
// one launch (0 = success).

extern "C" int fenris_nh_residual(const void* u, void* out, int nz, int ny, int nx,
                                  const void* factors, float mu, float lam, void* stream) {
  return launch_march<false>((const float*)u, nullptr, (float*)out, nz, ny, nx, factors, mu, lam,
                             (cudaStream_t)stream);
}

extern "C" int fenris_nh_hvp(const void* u, const void* v, void* out, int nz, int ny, int nx,
                             const void* factors, float mu, float lam, void* stream) {
  return launch_march<true>((const float*)u, (const float*)v, (float*)out, nz, ny, nx, factors, mu,
                            lam, (cudaStream_t)stream);
}

extern "C" const char* fenris_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
