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
// Design.  Two passes, no float atomics, so every result is bitwise
// reproducible from run to run (the JAX kernels are, and CG relies on it):
//   1. one thread per cell computes its 8x3 element vector in registers and
//      writes it to scratch[n][s][cell] (layout [8, 3, ncz, ncy, ncx],
//      x-minor, so neighbouring threads write neighbouring addresses);
//   2. one thread per node sums its <= 8 adjacent cell-corner contributions
//      in the fixed corner order (0,0,0), (1,0,0), (1,1,0), (0,1,0),
//      (0,0,1), (1,0,1), (1,1,1), (0,1,1) -- the order of the plain
//      version's 8 shifted slice-adds.
// What bounds it on the H100: about 1.7k (residual) and 2.5k (Hessian
// action) f32 operations per cell against ~200 bytes per cell of device
// memory traffic (u/v corner reads mostly hit L1/L2; the scratch write and
// read of 96 B/cell dominate), i.e. roughly balanced between the f32 ALUs
// and HBM bandwidth.  The TPU's z-slab DMA windows, the redundant shared
// plane and the (8, 128) tile padding are TPU structure and are not
// carried over; a fused shared-memory tile that avoids the scratch round
// trip is later work.
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

__global__ void __launch_bounds__(kThreads)
    nh_hvp_cells(const float* __restrict__ u, const float* __restrict__ v,
                 float* __restrict__ scratch, int nz, int ny, int nx, const Tables t) {
  CellIndex ci;
  if (!cell_index(nz, ny, nx, &ci)) return;
  const int64_t plane = (int64_t)ny * nx, comp = plane * nz;
  const int64_t ncell = (int64_t)(nx - 1) * (ny - 1) * (nz - 1);
  float U[8][3], V[8][3];
  load_corners(u, ci.base, plane, nx, comp, U);
  load_corners(v, ci.base, plane, nx, comp, V);
  float f[8][3];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int s = 0; s < 3; ++s) f[n][s] = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float G[3][3], dG[3][3], F[3][3], cof[3][3], det;
    gradient(t, q, U, G);
    gradient(t, q, V, dG);
    const float logJ = kinematics(G, F, cof, &det);
    const float alpha = -t.mu + t.lam * logJ;
    const float inv_det = 1.0f / det;
    float dF[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) dF[i][j] = dG[j][i];
    // ddet = cof : dF
    float ddet = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) ddet += cof[i][j] * dF[i][j];
    const float dalpha = t.lam * (ddet * inv_det);
    const float beta = alpha * (ddet * inv_det) * inv_det;  // alpha ddet / det^2
    // dP = mu dF + (dalpha cof + alpha dcof) / det - beta cof, dcof bilinear in (F, dF)
    float dP[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3, j1 = (j + 1) % 3, j2 = (j + 2) % 3;
        const float dcof = dF[i1][j1] * F[i2][j2] + F[i1][j1] * dF[i2][j2] -
                           dF[i1][j2] * F[i2][j1] - F[i1][j2] * dF[i2][j1];
        dP[i][j] = t.mu * dF[i][j] + (dalpha * cof[i][j] + alpha * dcof) * inv_det -
                   beta * cof[i][j];
      }
    }
    contract(t, q, dP, f);
  }
  store_cell(scratch, ci.cell, ncell, f);
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
// contiguous f32 [3, nz, ny, nx]; scratch is f32 [8, 3, nz-1, ny-1, nx-1];
// gp is host f32 [8, 8, 3] and wdet host f32 [8].  Each returns
// cudaGetLastError() after its launches (0 = success).

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

extern "C" int fenris_nh_hvp(const void* u, const void* v, void* scratch, void* out, int nz,
                             int ny, int nx, const void* gp, const void* wdet, float mu,
                             float lam, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Tables t = make_tables((const float*)gp, (const float*)wdet, mu, lam);
  const int64_t cells = (int64_t)(nz - 1) * (ny - 1) * (nx - 1);
  nh_hvp_cells<<<blocks_for(cells), kThreads, 0, s>>>((const float*)u, (const float*)v,
                                                      (float*)scratch, nz, ny, nx, t);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return gather((const float*)scratch, (float*)out, nz, ny, nx, s);
}

extern "C" const char* fenris_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
