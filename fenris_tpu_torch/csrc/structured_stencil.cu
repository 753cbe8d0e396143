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
// Residual (nh_residual_cells + gather_nodes).  Two passes, no float
// atomics, so every result is bitwise reproducible from run to run (the JAX
// kernels are, and CG relies on it):
//   1. one thread per cell computes its 8x3 element vector in registers with
//      the dense gp table and writes it to scratch[n][s][cell] (layout
//      [8, 3, ncz, ncy, ncx], x-minor, so neighbouring threads write
//      neighbouring addresses);
//   2. one thread per node sums its <= 8 adjacent cell-corner contributions
//      in the fixed corner order (0,0,0), (1,0,0), (1,1,0), (0,1,0),
//      (0,0,1), (1,0,1), (1,1,1), (0,1,1) -- the order of the plain
//      version's 8 shifted slice-adds.
//
// Hessian action (nh_hvp_march).  What bounds it on the H100: the f32 ALUs.
// Its own traffic is u, v and out once each (12 B a node each, 38.9 MB at
// 128x128x64 cells: 0.012 ms at 3.35 TB/s) against ~2.6k operations a cell
// in the tensor-product form below (0.041 ms at 67 TFLOP/s).  A cell's 96 B
// of contributions written to device memory and read back by a second
// launch would cost 201 MB of traffic, more than the 50 MB of L2; the Pallas
// kernel keeps them in a VMEM accumulator while it marches z-planes, and
// this kernel does the same on chip:
//   * one launch, no scratch: a block owns 32x10 nodes of a z-slab of 13
//     node layers and computes the 33x11 cells that touch them (one cell of
//     overlap with each neighbour, recomputed: 1.13x the cells); it marches
//     the slab's cell layers (plus the layer below), each thread computes
//     one cell into shared memory, and after a barrier each owning thread
//     sums its node's <= 8 cells in the fixed corner order above (this
//     layer's corners 0-3, then the previous layer's 4-7) and writes the
//     node once.  Two launches are bitwise equal.
//   * staged reads: the node planes of u and v a block needs (34x12 nodes)
//     are copied into a ring of three shared-memory planes with cp.async,
//     one plane ahead of the layer being computed.
//   * occupancy: a thread holds both fields' gradient tables and the adjoint
//     table (108 floats), so a block takes an SM (up to 168 registers, no
//     spills); its 12 warps keep all four schedulers equally busy between
//     the two barriers of a layer, and 5 slabs x 13 x 4 tiles of the
//     128x128x64 grid make two full waves on 132 SMs.
//   * tensor-product arithmetic: on a uniform grid gp[q][n][a] factors into
//     a difference along a times 1-D factors along the other two axes at
//     the two Gauss points, so the gradient at all 8 points is 4 edge
//     differences a derivative and component, interpolated twice (36
//     values a field instead of 8 x 9 dense 8-term sums), and the stress
//     goes back through the adjoint of the same factors.  The wrapper
//     derives the factors from gp and refuses a gp that does not factor.
// The TPU's (8, 128) tile padding and its redundant shared plane are TPU
// structure and are not carried over.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see fenris_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Tables {
  float gp[8][8][3];  // physical basis gradients [q][n][d]
  float wdet[8];      // quadrature weight x det(J_ref)
  float mu;
  float lam;
};

// corner n of a cell -> node offset (di, dj, dk), the hex8 node order
__device__ __forceinline__ int corner_di(int n) { return ((n + 1) >> 1) & 1; }
__device__ __forceinline__ int corner_dj(int n) { return (n >> 1) & 1; }
__device__ __forceinline__ int corner_dk(int n) { return n >> 2; }

constexpr int kThreads = 256;

// Loads the 8x3 corner values of cell `base` (its (0,0,0) node offset).
__device__ __forceinline__ void load_corners(const float* __restrict__ g, int64_t base,
                                             int64_t plane, int nx, int64_t comp,
                                             float U[8][3]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int64_t off = base + corner_dk(n) * plane + corner_dj(n) * nx + corner_di(n);
#pragma unroll
    for (int s = 0; s < 3; ++s) U[n][s] = __ldg(g + s * comp + off);
  }
}

// G[d][s] = sum_n gp[q][n][d] U[n][s]
__device__ __forceinline__ void gradient(const Tables& t, int q, const float U[8][3],
                                         float G[3][3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float acc = t.gp[q][0][d] * U[0][s];
#pragma unroll
      for (int n = 1; n < 8; ++n) acc += t.gp[q][n][d] * U[n][s];
      G[d][s] = acc;
    }
  }
}

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

// f[n][s] += w * sum_d gp[q][n][d] P[s][d]
__device__ __forceinline__ void contract(const Tables& t, int q, const float P[3][3],
                                         float f[8][3]) {
  const float w = t.wdet[q];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float acc =
          t.gp[q][n][0] * P[s][0] + t.gp[q][n][1] * P[s][1] + t.gp[q][n][2] * P[s][2];
      f[n][s] += w * acc;
    }
  }
}

__device__ __forceinline__ void store_cell(float* __restrict__ scratch, int64_t cell,
                                           int64_t ncell, const float f[8][3]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int s = 0; s < 3; ++s) scratch[(n * 3 + s) * ncell + cell] = f[n][s];
}

struct CellIndex {
  int64_t cell, base;
};

__device__ __forceinline__ bool cell_index(int nz, int ny, int nx, CellIndex* ci) {
  const int64_t ncx = nx - 1, ncy = ny - 1, ncz = nz - 1;
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= ncx * ncy * ncz) return false;
  const int64_t i = c % ncx, rest = c / ncx;
  const int64_t j = rest % ncy, k = rest / ncy;
  ci->cell = c;
  ci->base = (k * ny + j) * nx + i;
  return true;
}

__global__ void __launch_bounds__(kThreads)
    nh_residual_cells(const float* __restrict__ u, float* __restrict__ scratch, int nz,
                      int ny, int nx, const Tables t) {
  CellIndex ci;
  if (!cell_index(nz, ny, nx, &ci)) return;
  const int64_t plane = (int64_t)ny * nx, comp = plane * nz;
  const int64_t ncell = (int64_t)(nx - 1) * (ny - 1) * (nz - 1);
  float U[8][3];
  load_corners(u, ci.base, plane, nx, comp, U);
  float f[8][3];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int s = 0; s < 3; ++s) f[n][s] = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float G[3][3], F[3][3], cof[3][3], det;
    gradient(t, q, U, G);
    const float logJ = kinematics(G, F, cof, &det);
    const float alpha = -t.mu + t.lam * logJ;
    const float inv_det = 1.0f / det;
    float P[3][3];  // P = alpha F^{-T} + mu F, F^{-T} = cof / det
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = alpha * cof[i][j] * inv_det + t.mu * F[i][j];
    contract(t, q, P, f);
  }
  store_cell(scratch, ci.cell, ncell, f);
}

// -- the Hessian action: one fused z-marching pass ---------------------------------

constexpr int kTileX = 32;                       // nodes a block owns along x
constexpr int kTileY = 10;                       // ... along y
constexpr int kCellsX = kTileX + 1;              // cells a block computes along x: one left of its nodes
constexpr int kCellsY = kTileY + 1;
constexpr int kCells = kCellsX * kCellsY;        // 363 cells a layer, one a thread
constexpr int kHvpWarps = 12;                    // 3 on each of an SM's 4 schedulers
constexpr int kHvpThreads = 32 * kHvpWarps;      // one block an SM: up to 168 registers a thread
constexpr int kSlab = 13;                        // cell layers a block marches: 5 slabs of 64 layers
constexpr int kNodesX = kCellsX + 1;             // staged nodes a row: 34
constexpr int kNodesY = kCellsY + 1;             // staged rows: 12, one a warp
constexpr int kPlane = kNodesX * kNodesY;        // floats of one component of one staged node plane
constexpr int kPlaneFloats = 2 * 3 * kPlane;     // u and v, 3 components
constexpr int kRing = 3;                         // staged node planes: two in use, one in flight
constexpr int kCellStride = 364;                 // floats between the contribution rows of one layer
constexpr int kContribFloats = 24 * kCellStride; // a cell layer's 8 x 3 contributions
constexpr int kHvpSmemBytes = (kRing * kPlaneFloats + 2 * kContribFloats) * 4;  // 99,264
static_assert(kHvpThreads >= kCells && kCellStride >= kCells, "one thread and one slot a cell");
static_assert(kNodesY == kHvpWarps && kNodesX <= 64, "staging: warp w copies row w, two floats a lane");

// The tensor-product factors of the uniform hex8 gradient table: for the
// derivative along axis a, gp[q][n][a] = +-1 (node side along a)
// x t1[a][q_b1][n_b1] x t2[a][q_b2][n_b2] with b1 = (a+1)%3, b2 = (a+2)%3,
// t2 carrying the derivative scale (1/h); w[qz][qy][qx] = w_q det(J_ref).
struct HvpFactors {
  float t1[3][2][2];
  float t2[3][2][2];
  float w[2][2][2];
  float mu;
  float lam;
};
constexpr int kHvpFactorFloats = 32;  // t1, t2, w

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Stages node plane z of u and v (rows y0-1 .. y0+10, columns x0-1 .. x0+32,
// where inside the grid) into its ring slot, [field][s][row][column]: warp w
// copies row w of the 6 field components, lane l columns l and l + 32.
// off0/off1: this thread's two nodes' offsets in a node plane, -1 outside
// the grid or the window.
__device__ __forceinline__ void stage_plane(float* ring, const float* __restrict__ u,
                                            const float* __restrict__ v, int64_t comp,
                                            int64_t plane, int off0, int off1, int z, int nz) {
  if (z < 0 || z >= nz) return;
  float* dst = ring + (z % kRing) * kPlaneFloats + (threadIdx.x >> 5) * kNodesX + (threadIdx.x & 31);
  const int64_t zoff = z * plane;
#pragma unroll
  for (int fs = 0; fs < 6; ++fs) {  // fs = field * 3 + s
    const float* src = (fs < 3 ? u : v) + (fs % 3) * comp + zoff;
    if (off0 >= 0) cp_async4(dst + fs * kPlane, src + off0);
    if (off1 >= 0) cp_async4(dst + fs * kPlane + 32, src + off1);
  }
}

// Gradient table of one field at the 8 Gauss points of a cell, from its
// corners c[dk][dj][di][s]: Gt[a][p1][p2][s] is d/dx_a of component s at
// every point with q_b1 = p1, q_b2 = p2 (it does not depend on q_a): the 4
// edge differences along a, interpolated along b1, then along b2.
__device__ __forceinline__ void gradient_table(const HvpFactors& t, const float c[2][2][2][3],
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

// One cell's 8x3 Hessian-action contributions f[n][s] (hex8 node order).
// lo/hi: the staged planes below and above the cell; off: its (0,0,0) node.
__device__ __forceinline__ void hvp_cell(const HvpFactors& t, const float* lo, const float* hi,
                                         int off, float f[8][3]) {
  float Gu[3][2][2][3], Gv[3][2][2][3], At[3][2][2][3];
  {
    float c[2][2][2][3];
    load_cell(lo, hi, off, c);
    gradient_table(t, c, Gu);
    load_cell(lo + 3 * kPlane, hi + 3 * kPlane, off, c);
    gradient_table(t, c, Gv);
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
        float G[3][3], dG[3][3], F[3][3], cof[3][3], det;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            G[a][s] = Gu[a][qa[(a + 1) % 3]][qa[(a + 2) % 3]][s];
            dG[a][s] = Gv[a][qa[(a + 1) % 3]][qa[(a + 2) % 3]][s];
          }
        const float logJ = kinematics(G, F, cof, &det);
        const float alpha = -t.mu + t.lam * logJ;
        const float inv_det = __frcp_rn(det);  // == 1.0f / det, without the division routine
        float dF[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) dF[i][j] = dG[j][i];
        float ddet = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) ddet += cof[i][j] * dF[i][j];
        // dP = mu dF + (dalpha cof + alpha dcof) / det - beta cof = mu dF + ca cof + cb dcof
        const float ca = (t.lam - alpha) * (ddet * inv_det) * inv_det, cb = alpha * inv_det;
        const float w = t.w[qz][qy][qx];
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
      }
    }
  }
  // the adjoint of gradient_table: along b2, then b1, then the edge difference
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

// Block (bx, by, bz) owns the nodes x0 <= x < xend, y0 <= y < yend,
// z0 <= z < zend (x0 = kTileX bx, y0 = kTileY by, z0 = kSlab bz; the end is
// the grid's last node where the next tile would hold only that node).  It
// marches the cell layers L = z0-1 .. zend-1: each thread computes one of the
// cells touching its nodes into shared memory, then each owning thread sums
// its node's <= 8 cells in the fixed corner order (layer L's corners 0-3,
// then layer L-1's corners 4-7) and writes node layer L once.
__global__ void __launch_bounds__(kHvpThreads, 1)
    nh_hvp_march(const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ out,
                 int nz, int ny, int nx, const HvpFactors t) {
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

  stage_plane(ring, u, v, comp, plane, off0, off1, z0 - 1, nz);
  cp_async_commit();
  stage_plane(ring, u, v, comp, plane, off0, off1, z0, nz);
  cp_async_commit();
  for (int L = z0 - 1; L < zend; ++L) {
    if (L + 2 <= zend) stage_plane(ring, u, v, comp, plane, off0, off1, L + 2, nz);
    cp_async_commit();
    cp_async_wait_one();  // planes L and L+1 have landed (this thread's copies) ...
    __syncthreads();      // ... everyone's; and layer L-2's contributions are no longer read
    float* cur = contrib + ((L + 2) & 1) * kContribFloats;
    if (cell_xy && L >= 0 && L < ncz) {
      float f[8][3];
      hvp_cell(t, ring + (L % kRing) * kPlaneFloats, ring + ((L + 1) % kRing) * kPlaneFloats,
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

// Pass 2: out[s][node] = sum over the node's adjacent cells, corner order fixed.
__global__ void __launch_bounds__(kThreads)
    gather_nodes(const float* __restrict__ scratch, float* __restrict__ out, int nz, int ny,
                 int nx) {
  const int64_t plane = (int64_t)ny * nx, comp = plane * nz;
  const int64_t node = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (node >= comp) return;
  const int64_t i = node % nx, rest = node / nx;
  const int64_t j = rest % ny, k = rest / ny;
  const int64_t ncx = nx - 1, ncy = ny - 1, ncz = nz - 1;
  const int64_t ncell = ncx * ncy * ncz;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int64_t ci = i - corner_di(n), cj = j - corner_dj(n), ck = k - corner_dk(n);
    if (ci < 0 || cj < 0 || ck < 0 || ci >= ncx || cj >= ncy || ck >= ncz) continue;
    const int64_t cell = (ck * ncy + cj) * ncx + ci;
#pragma unroll
    for (int s = 0; s < 3; ++s) acc[s] += __ldg(scratch + (n * 3 + s) * ncell + cell);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) out[s * comp + node] = acc[s];
}

Tables make_tables(const float* gp, const float* wdet, float mu, float lam) {
  Tables t;
  memcpy(t.gp, gp, sizeof(t.gp));
  memcpy(t.wdet, wdet, sizeof(t.wdet));
  t.mu = mu;
  t.lam = lam;
  return t;
}

unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

int gather(const float* scratch, float* out, int nz, int ny, int nx, cudaStream_t stream) {
  const int64_t nodes = (int64_t)nz * ny * nx;
  gather_nodes<<<blocks_for(nodes), kThreads, 0, stream>>>(scratch, out, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers with a plain C interface (loaded with ctypes).  Grids are
// contiguous f32 [3, nz, ny, nx]; the residual's scratch is f32
// [8, 3, nz-1, ny-1, nx-1], its gp host f32 [8, 8, 3] and wdet host f32 [8];
// the Hessian action's factors are host f32 [32] (HvpFactors: t1, t2, w).
// Each returns cudaGetLastError() after its launches (0 = success).

extern "C" int fenris_nh_residual(const void* u, void* scratch, void* out, int nz, int ny,
                                  int nx, const void* gp, const void* wdet, float mu,
                                  float lam, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Tables t = make_tables((const float*)gp, (const float*)wdet, mu, lam);
  const int64_t cells = (int64_t)(nz - 1) * (ny - 1) * (nx - 1);
  nh_residual_cells<<<blocks_for(cells), kThreads, 0, s>>>((const float*)u, (float*)scratch,
                                                           nz, ny, nx, t);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return gather((const float*)scratch, (float*)out, nz, ny, nx, s);
}

extern "C" int fenris_nh_hvp(const void* u, const void* v, void* out, int nz, int ny, int nx,
                             const void* factors, float mu, float lam, void* stream) {
  HvpFactors t;
  memcpy(&t, factors, kHvpFactorFloats * sizeof(float));
  t.mu = mu;
  t.lam = lam;
  int err = (int)cudaFuncSetAttribute(nh_hvp_march, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kHvpSmemBytes);
  if (err != 0) return err;
  const dim3 grid((nx - 1 + kTileX - 1) / kTileX, (ny - 1 + kTileY - 1) / kTileY,
                  (nz - 1 + kSlab - 1) / kSlab);
  nh_hvp_march<<<grid, kHvpThreads, kHvpSmemBytes, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (float*)out, nz, ny, nx, t);
  return (int)cudaGetLastError();
}

extern "C" const char* fenris_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
