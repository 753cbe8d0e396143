#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fenris_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every kernel from ``fenris_tpu_torch/csrc`` (one nvcc per source,
all started together), runs the card tests (``tests/test_torch_cuda.py``,
JAX-free, in a pytest subprocess without ``tests/conftest.py``; every test
must pass and none skip), checks the banded gather and scatter at s = 1, 2, 3
on a fan of 6,644 triangles around one node (bitwise against their plain
versions) and drives the port's paths at full size:

* the structured Neo-Hookean Newton–Krylov solve (BASELINE config 5:
  128 x 128 x 64 = 1,048,576 hex8 cells, 3.25M dofs) through the stencil
  kernels (one z-marching body, ``nh_march``): each kernel against its
  plain version at the full size and four ragged shapes down to one cell,
  each also for one launch that allocates only its output, times,
  ``solve(preconditioner="mg")`` at the full size
  (||F|| / ||F0|| <= 1e-1, the pure-f32 floor) and ``solve_mixed`` at 32^3
  (relative ||F|| <= 1e-10);
* path A, the assembled block-DIA Neo-Hookean solve of
  tools/solve_assembled.py, uncut: res 149 = 3,307,949 hex8 cells,
  10,125,000 dofs, ``solve_mixed(assembled=True)`` with the band-sweep
  kernel in every CG iteration; plan time, assembly time and CG iterations
  per Newton step; an independent f64 model's relative residual <= 1e-10;
  the band sweep against its plain version on the full operator and on
  ragged ones; bitwise-repeatable bands and residuals;
* entry B, ``assemble_element_elliptic_matrices_pairs(kernel="auto")``
  (the JAX package's ``pallas="auto"``) on 970,299 hex8 cells (res 99),
  through the element-stiffness kernel, which is also held against its
  plain version for linear elasticity, Laplace and a ragged element count,
  and, with the plain version, against an f64 evaluation of the same f32
  coordinates;
* entry B20/B10, the same entry point on BASELINE's headline elements
  (bench.py:137-270) at full width: hex20 on the 64^3 box (262,144 cells,
  1,085,825 nodes) and tet10 on the BCC res-40 box (768,000 cells,
  1,043,441 nodes), linear elasticity and Laplace; the kernel (hex20 with
  its points in chunks) against its plain version, timed in turns beside
  its bound with M elements/s, and again at bench.py's own sizes (hex20
  28^3, tet10 BCC 18);
* a CG-count diagnostic at res 80: the first Newton step's CG iterations
  on seven operators (assembled f32 with the band-sweep kernel and with
  the plain band matvec, the fused matrix-free kernel and its plain
  version, assembled in f64, f64 element matrices in f32 bands, and the
  f32 assembly with node-relative J); and the f64 banded model (plain
  gather and scatter on the card) against the unbanded one;
* path C, the matrix-free banded Neo-Hookean solve: C1 holds the banded
  gather and scatter, the fused banded tangent sweep (the CG operator:
  gather and tangent in one kernel), the fused banded vector sweep (the
  residual: gather and internal forces in one kernel; padding rows zero)
  and the two element-minor sweeps against their plain versions at the
  res-149 padded layout (3,354,624 padded elements) and on a res-7 box and
  an RCM-reordered res-11 box, the gather also bitwise against
  ``u[cells[perm]]``, and times each fused sweep in turns against the
  route it replaced (gathers, then the element-minor sweep); C2 runs
  ``HyperelasticModel(banded=True, fused_kernels=True).solve_mixed()`` on
  path A's problem (10,125,000 dofs) with Jacobi from
  ``hessian_diagonal``, checked by the independent f64 residual (<= 1e-10)
  and against path A's solution, with a fused sweep in every CG iteration
  and at most two gathers a Newton step; C3 RCM-reorders bench.py's unstructured
  box (res 63, 786,432 dofs), runs the f32 ``solve()`` on the fused model
  (||F|| / ||F0|| <= 1e-1), checks that one residual launches the fused
  vector sweep and no gather, times that sweep against the route it
  replaced at this layout, and holds one Hessian action of the unfused
  banded model (``torch.func.jvp`` through the gather/scatter pair) against
  the fused one (rel <= 5e-4), then times that ``jvp`` against
  ``torch.func.linearize`` once and its linear map per application, costed
  at the solve's CG iterations a Newton step;
* Poisson on hex8 (``fem.solve_poisson_assembled`` and
  ``solve_poisson_matrix_free``): the reference's MMS gate at its full
  resolutions 1-32, f64 on both routes within 1% of
  tests/reference_values/poisson3d_mms_hex8_summary.json, and f32 (the band
  sweep, or the banded gather and scatter at s = 1) with its deviations
  printed; the same gate on tet4, tet10, tet20, hex20 and hex27 at the
  reference's resolutions (tests/test_convergence.py:95-138), f64 on the
  assembled route with sparse deltas in the block-ELL remainder (min_fill
  0.05), within 1% of each summary; then P149, the MMS problem in f32 on path A's mesh (3,375,000
  dofs at s = 1) on both routes, with set-up, solve and error times, the
  true relative residual by a plain f64 operator (<= 10x the CG tolerance)
  and the two routes' difference, and the s = 1 band sweep, gather and
  scatter at those shapes against their plain versions, timed beside their
  bounds and library calls (their records join the kernel line); and
  P40-tet10, the MMS problem in f32 on B10's mesh after the RCM (1,043,441
  dofs at s = 1), assembled with the band-sweep kernel in every CG
  iteration: set-up, D, fill and the remainder's share, CG iterations, ms
  per iteration and the true f64 relative residual (<= 10x the CG
  tolerance), the band sweep at that shape against its plain version;
* the element sweeps on every 3D element and material: the strided sweeps
  of tet4, tet10, tet20, hex8, hex20 and hex27 with the Neo-Hookean, StVK
  and linear-elastic materials on a ragged res-3 box against their plain
  versions; M10 and M20, on B10's tet10 and B20's hex20 meshes after the RCM
  on the card, the s = 3 gather and scatter at n = 10 and 20 nodes a row
  and, for each material, the fused banded tangent and vector sweeps
  against their plain versions (padding rows zero), timed in turns with
  them beside their bounds; S10, ``HyperelasticModel(banded=True,
  fused_kernels=True).solve_mixed()`` (Neo-Hookean, tools/solve_assembled.py's
  problem) on the tet10 mesh (3,130,323 dofs) to the independent f64
  residual <= 1e-10, with the tangent sweep in every CG iteration and no
  plain tangent sweep; on the hex20 mesh (3,257,475 dofs) the same
  ``solve_mixed``, then S20, the f32 ``solve()`` capped at 2 Newton steps;
  and one f32 Newton step of the StVK and linear-elastic models on each
  mesh (their records' launches);
* the 2D slice: B2, the stiffness kernel at d = 2 through
  ``assemble_element_elliptic_matrices_pairs(kernel="auto")`` on the unit
  square (quad4 and tri3 at res 1024, quad8, quad9 and tri6 at res 512;
  Laplace and 2D linear elasticity) against its plain version, timed in
  turns beside its bound with M elements/s; MMS2D, the reference's four
  2D gates (tests/test_convergence.py:28-78) at resolutions 1-32 on the
  CSR route (``fem.solve_poisson``, the JAX package's route) and the two
  others, f64 within 1%, f32 deviations printed; P2D, the 2D MMS problem
  in f32 on quad9 and tri6 at res 512 (1,050,625 dofs, RCM on the card)
  on the three routes with set-up, CG iterations, ms per iteration and
  the true f64 residual, then the CSR product's GB/s (bitwise
  repeatable) and the s = 1 band sweep, gather and scatter at those
  shapes (their records join the kernel line);
* the element sweeps at d = 2 and with per-element Lame parameters: the
  strided sweeps of the five 2D elements on ragged squares beside the 3D
  ones; M2D, on B2's meshes after the RCM, the s = 2 gather and scatter
  (against ``index_select`` and ``index_add_``) and each material's fused
  sweeps against their plain versions, timed, with one capped f32 Newton
  step of each material for their launches; S2D, ``solve_mixed`` of
  tools/solve_assembled.py's problem in 2D (x = 0 clamped, gravity
  (0, -4)) on quad9 and tri6 at res 128 to an independent f64 residual
  <= 1e-10, the tangent sweep in every CG iteration (and two Newton steps
  at res 512, where the f32 inner solves stall, logged); ME, the fused sweeps
  with two-material per-element parameters at C1's hex8 layout and on
  tet10 against their plain versions, an array of one repeated value
  bitwise equal to the scalar launch, timed beside it; PE10,
  ``solve_mixed`` on S10's tet10 mesh with those parameters, checked by an
  independent f64 model holding them in the mesh's element order;
* C2-MG: path C2's problem on 18^3 cells refined three times (9,145,875
  dofs, RCM-reordered on the card in under 20 s) under
  ``GeometricMGPreconditioner(banded=True)``, ``solve_mixed`` to the
  independent f64 residual <= 1e-10, with CG iterations beside C2's Jacobi
  counts, the V-cycle's share of a CG iteration and a profile of one
  V-cycle.

Every kernel check is ``max |kernel - plain| / max |plain| <= 1e-5`` (f32
roundoff: FMA contraction and summation order) with two launches bitwise
equal.  Each path runs with every launch counter set to 0 just before it
and read just after, and fails if its kernels were not launched.  Every
phase raises on failure.  Each kernel's record carries its time, its
plain version's, one PyTorch library call's where one computes the same
function (else null), all timed eagerly (CUDA events around back-to-back
calls), and its bound: the larger of its bytes over 3.35 TB/s and its f32
operations over 67 TFLOP/s (H100 SXM peaks), from this run's inputs.  The
gather's and scatter's records also carry ``card_ms`` and
``library_card_ms``: the calls captured in a CUDA graph, cycling through
copies of the inputs that hold 3x the L2 between two uses of one copy.  ``ptxas`` lines (registers, shared memory, spills) of the
stencil, gather (s = 1, 2, 3, any s), scatter (s = 1, 2, any s) and
stiffness kernels and all 132 element-sweep instantiations
(11 elements x 3 materials x 4 modes) are printed, and a spill in any of
them, or a missing instantiation, fails the run.  The card's
``nvidia-smi`` name and power limit are printed on a line of their own;
the second-to-last line of standard
output is the per-kernel JSON record, the last line the device record.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MU, LAM = 384.614, 576.923  # the flagship's (and tools/solve_assembled.py's) Lamé parameters
KERNEL_RTOL = 1e-5  # f32 roundoff: FMA contraction and summation order

# structured path
FULL = (128, 128, 64)
# ragged: a tile, a slab and the last node on each axis of the Hessian-action kernel (32 x 10 nodes,
# 13 layers a block), and a one-cell grid
RAGGED = [(5, 4, 11), (15, 7, 5), (33, 9, 17), (1, 1, 1)]
# path A: tools/solve_assembled.py as it stands
RES_A = 149
CHUNK_A = 65536
BODY_A = (0.0, 0.0, -4.0)
# entry B: the element-stiffness kernel at 970,299 hex8 cells
RES_B = 99
RAGGED_B = 11  # 1,331 cells: not a multiple of the kernel's 32-element block
# path C: the matrix-free banded solve on path A's problem, kernel checks
# also on a res-7 box and an RCM-reordered res-11 box (two owner blocks of
# 1,024 nodes each), C3 at bench.py's unstructured size
RAGGED_C = [(7, False), (11, True)]
RES_C3 = 63
# entry B20/B10: the stiffness kernel on BASELINE's headline elements at 1M+ nodes (s = 3: 3.3M and
# 3.1M dofs), and at bench.py's own sizes (hex20 28^3 = 21,952 cells, tet10 BCC 18 = 69,984 tets)
RES_B20 = 64  # convert_mesh(create_unit_box_uniform_hex_mesh_3d(64), "hex20"): 262,144 cells
RES_B10 = 40  # convert_mesh(create_unit_box_uniform_tet_mesh_3d(40), "tet10"): 768,000 cells
RES_BENCH = {"hex20": 28, "tet10": 18}
RES_DIAG = 80  # the CG-count diagnostic: 512,000 cells, 1,594,323 dofs
# Poisson on hex8: the reference's MMS resolutions (tests/test_convergence.py:85-90), and P149, the
# scalar problem on path A's mesh (3,375,000 dofs at s = 1).  f32 CG tolerances: an f32 solution's
# true relative residual cannot fall below about eps / (30 h^2) on this problem (the f32 rounding of u
# through A): ~1e-5 at res 32, ~2e-4 at res 149
MMS_RESOLUTIONS = (1, 2, 4, 8, 16, 32)
F32_TOL_MMS = 1e-5
RES_P = 149
F32_TOL_P = 1e-4
# the gate on the other elements (tests/test_convergence.py:95-138): resolutions, rule and error rule;
# deltas populating under 5% of the rows go to the block-ELL remainder (block_dia.py:219's figure for
# irregular meshes: every delta a band would take up to 185k bands on tet20 at res 12)
MMS_ELEMENTS = {
    "hex20": ((1, 2, 4, 8, 16), ("hexahedron_gauss", 4), ("hexahedron_gauss", 6)),
    "hex27": ((1, 2, 4, 8, 16), ("hexahedron_gauss", 4), ("hexahedron_gauss", 6)),
    "tet4": ((1, 2, 4, 8, 16), ("tetrahedron", 0), ("tetrahedron", 6)),
    "tet10": ((1, 2, 4, 8, 12), ("tetrahedron", 2), ("tetrahedron", 6)),
    "tet20": ((1, 2, 4, 6, 8, 12), ("tetrahedron", 4), ("tetrahedron", 6)),
}
MMS_MIN_FILL = 0.05
# the 2D slice.  B2: the stiffness kernel at d = 2 on the unit square, every mesh at 1,050,625 nodes but
# quad8's (788,481: no centre nodes); the reference's 2D gates (tests/test_convergence.py:28-78): rule and
# error rule by element; P2D: the 2D MMS problem at 1,050,625 dofs, f32.  Its CG tolerance comes from the
# f32 rounding of the nodal solution through A (P149's floor, measured in the run: eps / (30 h^2) ~ 1e-3 at
# h = 1/512 for quad4; quad9's and tri6's nodes lie h/2 apart and their floor is 4-6x that, ~5e-3)
B2_MESHES = {"quad4": 1024, "quad8": 512, "quad9": 512, "tri3": 1024, "tri6": 512}
MMS_2D = {
    "quad4": (("quadrilateral_gauss", 2), ("quadrilateral_gauss", 6)),
    "quad9": (("quadrilateral_gauss", 2), ("quadrilateral_gauss", 6)),
    "tri3": (("triangle", 0), ("triangle", 6)),
    "tri6": (("triangle", 2), ("triangle", 6)),
}
P2D_MESHES = {"quad9": (512, *MMS_2D["quad9"]), "tri6": (512, *MMS_2D["tri6"])}
F32_TOL_P2D = 1e-2
# the element sweeps at d = 2 and with per-element Lame parameters.  M2D: the fused sweeps on B2's meshes after
# the RCM (P2D's for quad9 and tri6).  S2D: tools/solve_assembled.py's problem in 2D (Neo-Hookean, x = 0
# clamped, gravity BODY_2D) on quad9 and tri6, solve_mixed to 1e-10, at res RES_S2D (132,098 dofs): the f32
# inner solves contract ~kappa eps_f32 a Newton step, and kappa grows as res^2 in 2D; at res 512 (2,101,250
# dofs) a step cuts the residual by ~0.3% (s2d_stall logs it) and at res 256 tri6 stalled at 1.2e-10, while
# at res 128 both meshes converge in 5 steps.  Its Jacobi CG takes ~11 x res iterations a Newton step.  PE10: S10's mesh and load
# with two materials PE10_CONTRAST apart (the element's centroid at x > 0.5), each value varied by up to 10%
# (seed 13).  Both raise the CG cap past the default 2,000 to SLICE_CG_MAX_ITER.
BODY_2D = (0.0, -4.0)
RES_S2D = 128
PE10_CONTRAST = 10.0
SLICE_CG_MAX_ITER = 20000
# C2-MG: path C2's problem on 18^3 cells refined three times (144^3 = 2,985,984 hex8, 9,145,875 dofs)
RES_MG_COARSE = 18
MG_LEVELS = 3
CARD_TESTS_TIMEOUT_S = 300

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 operations/s
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20  # the H100's L2 cache
F32_OPS_PER_S = 67e12
# f32 operations of the element sweeps per element, counted at the fewest the arithmetic allows (a
# multiply and an add are two, a division, reciprocal, comparison or log1p one), for d = s in {2, 3}: per
# point, geometry J from node-relative coordinates d^2 (2m - 3) + J^-1 and det (STIFFNESS_INV_OPS) + weight 1;
# then the fewer of two forms of the gradients and the contraction: with the basis gradients gp
# (n d (2d - 1)), each field's gradient (d^2 sums of n products, d^2 (2n - 1)), the stress scaled by the
# weight d^2 and the contraction 2 n d^2 (n d sums of d products and the sum over points); or with each
# field's reference gradient (d^2 (2n - 1)) turned physical by J^-1 (d^2 (2d - 1)), T = w|det| J^-1 P^T
# (2 d^3) and the contraction 2 n d^2; then the material (EM_MATERIAL_OPS).  Once an element, the
# node-relative coordinates d (m - 1).  The fields: u for the vector sweep, u and v for the tangent, v alone
# for the linear tangent.  The structured stencils: stencil_ops.
EM_MATERIAL_OPS = {
    # Neo-Hookean kinematics (F, gamma, log1p, adjugate, det, F^-T, alpha): 3D 78, 2D 19 (F 2, gamma 5,
    # log1p 2, det 3, its reciprocal 1, F^-T 4, alpha 2); then the stress P 27 / 12 or the tangent 153 / 52
    # (tr(F^-1 dF) 17 / 7, F^-T dF^T 45 / 12, dF^-T 45 / 12, dP 46 / 21)
    ("NeoHookeanMaterial", False): {3: 78 + 27, 2: 19 + 12},
    ("NeoHookeanMaterial", True): {3: 78 + 153, 2: 19 + 52},
    # StVK: F 3 / 2, E = (F^T F - I) / 2 39 / 14, lam tr E 3 / 2, S 9 / 5; then P = F S 45 / 12, or
    # F^T dF 45 / 12, lam tr 3 / 2, dS 15 / 8, dP = dF S + F dS 99 / 28
    ("StVKMaterial", False): {3: 54 + 45, 2: 23 + 12},
    ("StVKMaterial", True): {3: 54 + 162, 2: 23 + 50},
    # linear: lam tr G 3 / 2, P = mu (G + G^T) + lam tr I 15 / 8, of G or of grad v
    ("LinearElasticMaterial", False): {3: 18, 2: 10},
    ("LinearElasticMaterial", True): {3: 18, 2: 10},
}


def em_sweep_ops(m, n, q, material, tangent, d=3):
    """f32 operations of one element's vector (``tangent=False``) or tangent sweep: d-dimensional elements of
    ``m`` geometry and ``n`` solution nodes, ``q`` points, ``material`` the material's class name
    (EM_MATERIAL_OPS)."""
    fields = 1 if not tangent or material == "LinearElasticMaterial" else 2
    grad, out = d * d * (2 * n - 1), 2 * n * d * d
    gp_form = n * d * (2 * d - 1) + fields * grad + d * d + out
    reference_form = fields * (grad + d * d * (2 * d - 1)) + 2 * d**3 + out
    point = (d * d * (2 * m - 3) + STIFFNESS_INV_OPS[d] + 1 + min(gp_form, reference_form)
             + EM_MATERIAL_OPS[material, tangent][d])
    return d * (m - 1) + q * point


def em_sweep_cost(plan, tab, op, tangent, per_element=False):
    """``(bytes, f32 operations)`` of a fused banded sweep: the valid elements' X (d m floats) and node
    indices, the per-block row counts, u (not for the linear tangent) and v once, every row written once, and
    with ``per_element`` the valid elements' mu and lam (8 bytes an element); the arithmetic of the valid
    elements only (a padding element's rows are zeros)."""
    q, m, d = tab.geo_dphi.shape
    n, material = tab.dphi.shape[1], type(op.material).__name__
    fields = int(tangent) + int(not tangent or material != "LinearElasticMaterial")
    nbytes = (d * m * plan.num_elements + plan.node_rows.numel() + plan.block_rows.numel()
              + fields * plan.num_nodes * d + plan.padded_elements * plan.n * d
              + (2 * plan.num_elements if per_element else 0)) * 4
    return nbytes, em_sweep_ops(m, n, q, material, tangent, d) * plan.num_elements


def stencil_ops(cells, hvp):
    """f32 operations of the structured residual (``hvp=False``) or Hessian action on ``cells`` hex8
    cells of a uniform grid, the fewer of two forms.  Per cell and point, in both: kinematics (F, gamma,
    log1p, adjugate, det) 62, alpha 2, 1/det 1, then the weighted stress w P 30 (the weight folded into
    its two scalar factors, w alpha / det 2 and w mu 1, then 9 entries of a product and a multiply-add)
    or its tangent w dP 155 (dP 152 and the weight folded into its three scalar factors mu, ca, cb 3).
    Dense form, per point: the gradient from the constant table, 135 a field (9 sums of 8 products), and
    the contraction 144 (24 sums of 3 products 120, the sum over points 24).  Tensor-product form (what
    the stencil kernels do), per cell: the gradient at all 8 points 252 a field (for each derivative and
    component 4 edge differences, then two 1-D interpolations of 4 values at 3 operations each: 28), and
    the contraction 300 (the sums of point pairs into the 36-entry adjoint table 36, its two adjoint
    interpolations 216, the signed sums of 3 edge values into the 24 node values 48)."""
    fields, stress = (2, 155) if hvp else (1, 30)
    point = 62 + 2 + 1 + stress
    dense = 8 * (fields * 135 + point + 144)
    tensor_product = fields * 252 + 8 * point + 300
    return cells * min(dense, tensor_product)


def stiffness_ops(E, m, n, q, s, sym, d):
    """f32 operations of the element-stiffness function for d-dimensional elements (m geometry nodes),
    the fewest its arithmetic allows.  Per element and point: J from node-relative coordinates
    d^2 (2m - 3), J^-1 and det (STIFFNESS_INV_OPS), the weight 1, the gradients G = dphi J^-1
    n d (2d - 1), G scaled by w|det| n d; per element the node-relative coordinates (m - 1) d.  Then the
    fewer of two forms of the block entries needed (all n^2 of an off-diagonal pair, the n (n + 1) / 2
    upper ones of a symmetric operator's diagonal pair): per point t = (w|det| G) C^ij, P n d (2d - 1),
    and t . G summed over points and d, 2 q d - 1 an entry; or, as the kernel does,
    M_ab = sum_q w|det| G_a G_b^T once per node pair a <= b, d^2 (2q - 1), and C^ij : M, 2 d^2 - 1 an
    entry."""
    pairs = s * (s + 1) // 2 if sym else s * s
    entries = (s * (s - 1) // 2 * n * n + s * n * (n + 1) // 2) if sym else s * s * n * n
    geometry = q * (d * d * (2 * m - 3) + STIFFNESS_INV_OPS[d] + 1 + n * d * (2 * d - 1) + n * d) + (m - 1) * d
    per_point = q * pairs * n * d * (2 * d - 1) + entries * (2 * q * d - 1)
    node_pairs = n * (n + 1) // 2 * d * d * (2 * q - 1) + entries * (2 * d * d - 1)
    return E * (geometry + min(per_point, node_pairs))


# J^-1 and det by cofactors: 3D 9 cofactors (27), det 5, its reciprocal 1, 9 products; 2D det 3, its
# reciprocal 1, 4 products (the negations fold into them)
STIFFNESS_INV_OPS = {2: 8, 3: 42}


SOURCES = {
    "structured_stencil": "fenris_tpu_torch/csrc/structured_stencil.cu",
    "dia_sweep": "fenris_tpu_torch/csrc/dia_sweep.cu",
    "stiffness_pairs": "fenris_tpu_torch/csrc/stiffness_pairs.cu",
    "banded": "fenris_tpu_torch/csrc/banded.cu",
    "em_sweep": "fenris_tpu_torch/csrc/em_sweep.cu",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(run_k, run_p, reps=20, names=("kernel", "plain"), plain_reps=None):
    """Kernel and plain times in turns (plain, kernel, kernel, plain); the lower of each pair.
    ``plain_reps``: fewer repeats (one warm-up) for a plain version that takes a large part of a second."""
    run_plain = (lambda: event_ms(run_p, reps)) if plain_reps is None else (lambda: event_ms(run_p, plain_reps, 1))
    p1, k1, k2, p2 = (run_plain(), event_ms(run_k, reps), event_ms(run_k, reps), run_plain())
    return min(k1, k2), min(p1, p2), f"{names[0]} {k1:.4f}/{k2:.4f} ms, {names[1]} {p1:.4f}/{p2:.4f} ms"


def compare(name, shape_txt, got, again, ref):
    """Kernel against plain: returns max |k - p|; raises past the limit or on a differing repeat."""
    import torch

    torch.cuda.synchronize()
    abs_err = float((got.double() - ref.double()).abs().max())
    rel = abs_err / float(ref.double().abs().max())
    same = bool(torch.equal(got, again))
    log(f"compare {name} {shape_txt}: max_abs_err={abs_err:.6e} rel={rel:.6e} "
        f"(limit {KERNEL_RTOL:g}) repeat_bitwise_equal={same}")
    check(bool(torch.isfinite(got).all()), f"{name} {shape_txt}: non-finite output")
    check(rel <= KERNEL_RTOL, f"{name} {shape_txt}: kernel vs plain rel {rel:.3e} > {KERNEL_RTOL:g}")
    check(same, f"{name} {shape_txt}: two launches on one input differ")
    return abs_err


def set_bound(k, nbytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or f32 operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    k["bound_ms"], k["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} ({nbytes / 1e9:.3f} GB, {ops / 1e9:.3f} GFLOP)"


def timed(fn, times):
    """``fn`` that appends its synchronised wall time to ``times``."""
    import torch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    return run


# mangled-name fragment -> label of the kernels ptxas_report reads (the stiffness kernels and the element
# sweeps, 4 modes of each of ops/em_sweep's ELEMENTS and MATERIALS, by pattern)
PTXAS_LABELS = {"nh_marchILb1E": "neo_hookean_hvp (nh_march<true>)",
                "nh_marchILb0E": "neo_hookean_residual (nh_march<false>)",
                **{f"banded_{k}_kernelILi{s}E": f"banded_{k} ({'any s' if s == 0 else f's = {s}'})"
                   for k, top in (("gather", 3), ("scatter", 2)) for s in range(top + 1)}}


def ptxas_report(build_log):
    """Registers, shared memory and spill bytes of the stencil, gather, sweep and stiffness kernels,
    from the loaded library's ``-Xptxas -v`` log; returns ``{label: ptxas text}``."""
    from fenris_tpu_torch.ops.em_sweep import ELEMENTS, MATERIALS

    if not build_log.is_file():
        log(f"ptxas: {build_log.name} not found (library built without a log); registers not reported")
        return {}
    label, found = None, {}
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = next((v for k, v in PTXAS_LABELS.items() if k in m.group(1)), None)
            st = re.search(r"stiffness_pairs_kernelILi(\d)ELi(\d)ELi(\d)E", m.group(1))
            if st:
                label = f"stiffness_pairs (d = {st.group(1)}, {st.group(2)} pairs, {st.group(3)} a thread)"
            em = re.search(r"sweep_kernelILb(\d)ELb(\d)ELi(\d)ELi(\d+)ELi(\d+)ELi(\d)E", m.group(1))
            if em:
                banded, tangent, dd, mm, nn, mat = (int(x) for x in em.groups())
                label = (f"em_sweep ({'banded' if banded else 'strided'} {'tangent' if tangent else 'vector'}, "
                         f"{ELEMENTS[dd, mm, nn]}, {list(MATERIALS)[mat]})")
        elif label and "spill stores" in line:
            found[label] = line.strip()
        elif label and "Used" in line and "registers" in line:
            found[label] = f"{line.split('info    :')[-1].strip()}; {found.get(label, '')}"
            label = None
    for name, txt in found.items():
        log(f"ptxas {name}: {txt}")
    return found


def reset_counts(kernels):
    for k in kernels.values():
        k["fn"].launches = 0


def free_memory():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def card_tests():
    """``tests/test_torch_cuda.py`` in a pytest subprocess, JAX-free and without ``tests/conftest.py``;
    fails unless it exits 0 with tests passed and none skipped or failed."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--noconftest",
           "-o", "markers=cuda: needs a card", "tests/test_torch_cuda.py"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=CARD_TESTS_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else "(no output)"
    log(f"card tests (tests/test_torch_cuda.py): {summary} [exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.3f} s]")
    if proc.returncode != 0:
        log("\n".join(lines[-40:] + proc.stderr.strip().splitlines()[-20:]))
    check(proc.returncode == 0, f"card tests exited {proc.returncode}")
    passed = re.search(r"(\d+) passed", summary)
    check(passed is not None and int(passed.group(1)) > 0, "card tests: no test passed")
    check(not re.search(r"skipped|failed|error", summary), f"card tests: {summary}")


# -- structured path ------------------------------------------------------------


def flagship_model(cells, dtype, device, **kwargs):
    """The flagship model (fields of __graft_entry__._structured_model)."""
    import numpy as np

    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial
    from fenris_tpu_torch.structured import StructuredHyperelasticModel

    ncx, ncy, ncz = cells
    mask = np.zeros((ncz + 1) * (ncy + 1) * (ncx + 1) * 3, dtype=bool)
    mask[: (ncy + 1) * (ncx + 1) * 3] = True  # clamp the z = 0 node plane
    return StructuredHyperelasticModel(
        cells=cells,
        spacing=1.0 / max(cells),
        material=NeoHookeanMaterial(),
        params=LameParameters(mu=MU, lam=LAM),
        dirichlet_mask=mask,
        body_force=np.array([0.0, 0.0, -9.81]),
        dtype=dtype,
        device=device,
        **kwargs,
    )


def kernel_inputs(cells, device, seed=0):
    """u with displacement gradients ~1e-2 (u = 0.02 h U(-1, 1)) and v ~ N(0, 1)."""
    import torch

    h = 1.0 / max(cells)
    shape = (3, cells[2] + 1, cells[1] + 1, cells[0] + 1)
    g = torch.Generator(device=device).manual_seed(seed)
    u = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * (0.02 * h)
    v = torch.randn(shape, generator=g, device=device)
    return h, u, v


def structured_phases(kernels, dev, smi):
    import torch

    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    stencil = {n: k for n, k in kernels.items() if k["path"] == "structured"}
    # kernel against plain, on the card
    for cells in [FULL] + RAGGED:
        h, u, v = kernel_inputs(cells, dev)
        gp, w = ss.gp_table(h)
        for name, k in stencil.items():
            args = (u, v)[: k["nargs"]]
            got = k["fn"](*args, gp, w, MU, LAM)
            again = k["fn"](*args, gp, w, MU, LAM)
            err = compare(name, f"cells={cells}", got, again, k["plain"](*args, gp, w, MU, LAM))
            if cells == FULL:
                k["max_abs_err"] = err
            if cells == FULL:
                # one launch, no scratch: the call allocates its output and nothing else
                del got, again
                free_memory()
                torch.cuda.reset_peak_memory_stats()
                m0, n0 = torch.cuda.memory_allocated(), k["fn"].launches
                got = k["fn"](*args, gp, w, MU, LAM)
                torch.cuda.synchronize()
                extra, out_bytes = torch.cuda.max_memory_allocated() - m0, -(-got.numel() * 4 // 512) * 512
                log(f"{name} cells={cells}: one call allocates {extra} bytes of device memory (its output "
                    f"{out_bytes}) in {k['fn'].launches - n0} launch")
                check(extra <= out_bytes, f"{name}: the call allocates more than its output")
                again = got
        del u, v, got, again

    # times at full size
    h, u, v = kernel_inputs(FULL, dev, seed=1)
    gp, w = ss.gp_table(h)
    for name, k in stencil.items():
        args = (u, v)[: k["nargs"]]
        k["ms"], k["plain_ms"], txt = in_turns(
            lambda: k["fn"](*args, gp, w, MU, LAM), lambda: k["plain"](*args, gp, w, MU, LAM)
        )
        # inputs read and the output written once; no PyTorch call computes the stencils
        bound_txt = set_bound(k, (k["nargs"] + 1) * u.numel() * 4,
                              stencil_ops(FULL[0] * FULL[1] * FULL[2], hvp=k["nargs"] == 2))
        k["library_ms"] = None
        log(f"time {name} cells={FULL}: {txt}; {bound_txt} ({smi})")
    del u, v
    torch.cuda.synchronize()

    # the structured main path at full size
    model = flagship_model(FULL, torch.float32, dev)
    history = []

    def record(k, fn, cg):
        history.append(fn)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    log(f"solve(mg) cells={FULL} dofs={model.num_dofs} f32:")
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve(
        preconditioner="mg", tolerance=1e-6, max_newton_iterations=4,
        cg_rel_tolerance=1e-5, cg_max_iter=200, callback=record,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in stencil.values():
        k["launches"] = k["fn"].launches
    ratio = res.residual_norm / history[0]
    plain_model = flagship_model(FULL, torch.float32, dev, kernel=False)
    plain_ratio = float(torch.linalg.vector_norm(plain_model.residual(res.x))) / history[0]
    log(f"solve(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={ratio:.6e} plain-path |F|/|F0|={plain_ratio:.6e} "
        f"launches={{{', '.join(f'{n}: {k['launches']}' for n, k in stencil.items())}}} ({smi})")
    check(tuple(res.x.shape) == (model.num_dofs,), "solve: wrong result shape")
    check(bool(torch.isfinite(res.x).all()), "solve: non-finite displacement")
    check(all(b <= a for a, b in zip(history, history[1:])), f"solve: |F| not monotone: {history}")
    check(ratio <= 1e-1, f"solve: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(plain_ratio <= 1e-1, f"solve: plain-path |F|/|F0| = {plain_ratio:.3e} > 1e-1")
    for name, k in stencil.items():
        check(k["launches"] > 0, f"solve: kernel {name} was not launched on the structured path")
    del model, plain_model, res

    # mixed precision at 32^3
    cells = (32, 32, 32)
    model = flagship_model(cells, torch.float32, dev)
    history = []
    log(f"solve_mixed(mg) cells={cells} dofs={model.num_dofs}:")
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, preconditioner="mg", callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = res.residual_norm / history[0]
    log(f"solve_mixed(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={rel:.6e} ({smi})")
    check(res.status == NEWTON_CONVERGED, f"solve_mixed: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "solve_mixed: non-finite displacement")
    check(rel <= 1e-10, f"solve_mixed: |F|/|F0| = {rel:.3e} > 1e-10")
    del model, res
    free_memory()


# -- path A: the assembled block-DIA solve -----------------------------------------


def assembled_model(res, dtype, device, chunk_size, **kwargs):
    """tools/solve_assembled.py's model: unit box, z = 0 clamped, body force (0, 0, -4); ``params``
    (scalar by default) and ``mesh``, ``material`` may be given."""
    import numpy as np

    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    mesh = kwargs.pop("mesh", None) or create_unit_box_uniform_hex_mesh_3d(res)
    return HyperelasticModel(
        mesh=mesh,
        material=kwargs.pop("material", None) or NeoHookeanMaterial(),
        params=kwargs.pop("params", None) or LameParameters(mu=MU, lam=LAM),
        dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < 1e-12),
        body_force=np.array(BODY_A),
        dtype=dtype,
        device=device,
        chunk_size=chunk_size,
        **kwargs,
    )


def displacement(model, seed):
    """u = 0.01 h U(-1, 1) on the free dofs (h the cell size)."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(seed)
    h = 1.0 / round(model.mesh.num_cells ** (1.0 / model.mesh.dim))
    u = (torch.rand(model.space.num_dofs, generator=g, device=model.device, dtype=model.dtype) * 2 - 1) * (0.01 * h)
    return torch.where(model.free_mask, u, 0.0)


def sweep_compare(m, shape_txt, dev, seed=0):
    """The band sweep (and the full operator) against the plain versions on one operator."""
    import torch

    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.sparse.block_dia import block_dia_matvec_cm
    from fenris_tpu_torch.sparse.dia_kernel import block_dia_operator

    g = torch.Generator(device=dev).manual_seed(seed)
    x2 = torch.randn((m.solution_dim, m.num_nodes), generator=g, device=dev)
    err = compare("dia_sweep", shape_txt, ds.dia_sweep(m.bands, m.offsets, x2),
                  ds.dia_sweep(m.bands, m.offsets, x2), ds.dia_sweep_plain(m.bands, m.offsets, x2))
    if m.remainder is not None:
        op = block_dia_operator(m, layout="component", kernel=True)
        compare("dia_sweep+remainder operator", shape_txt, op(x2), op(x2), block_dia_matvec_cm(m, x2))
    return err, x2


def csr_library_ms(m, x2, ref, smi):
    """Time of cuSPARSE's CSR product (``torch.sparse_csr_tensor @ x``) on the same operator.

    The yardstick only: the port never calls it.  Every band entry becomes a
    CSR entry (D*s per row, zero where the shifted column leaves [0, N)).
    """
    import torch

    D, s, N = len(m.offsets), m.solution_dim, m.num_nodes
    dev = x2.device
    cols_n = torch.arange(N, device=dev)[None, :] + torch.tensor(m.offsets, device=dev)[:, None]  # [D, N]
    inside = (cols_n >= 0) & (cols_n < N)
    vals = (m.bands.reshape(D, s, s, N) * inside[:, None, None, :]).permute(1, 3, 0, 2).reshape(-1)  # (i, n, d, j)
    cols = torch.arange(s, device=dev)[None, None, :] * N + cols_n.clamp(0, N - 1).T[:, :, None]  # [N, D, s]
    cols = cols[None].expand(s, N, D, s).reshape(-1)
    crow = torch.arange(s * N + 1, device=dev) * (D * s)
    A = torch.sparse_csr_tensor(crow, cols, vals, size=(s * N, s * N))
    del vals, cols, cols_n, inside
    x = x2.reshape(-1, 1)
    y = (A @ x).reshape(s, N)
    torch.cuda.synchronize()
    rel = float((y.double() - ref.double()).abs().max() / ref.double().abs().max())
    ms = min(event_ms(lambda: A @ x, reps=10), event_ms(lambda: A @ x, reps=10))
    log(f"library dia_sweep: cuSPARSE CSR product, nnz {A.values().numel()}: {ms:.4f} ms, rel vs kernel {rel:.3e} ({smi})")
    del A, y, ref
    free_memory()
    return ms


def path_a_setup(dev, smi):
    import torch

    t0 = time.perf_counter()
    model = assembled_model(RES_A, torch.float32, dev, CHUNK_A)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = model.block_dia_plan()
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    expand = model.block_dia_expand_plan()
    torch.cuda.synchronize()
    t_expand = time.perf_counter() - t0
    log(f"path A model res={RES_A}: {model.mesh.num_cells} hex8, {model.space.num_dofs} dofs, "
        f"chunk {model.chunk_size}; model set-up {t_model:.3f} s; assembly plan {t_plan:.3f} s "
        f"(D={plan.num_diagonals}, rem_k={plan.rem_k}, fill={plan.fill:.4f}); expand plan {t_expand:.3f} s "
        f"(classes={expand.num_classes}, coverage={expand.coverage}) ({smi})")
    check(plan.num_diagonals == 27 and plan.rem_k == 0, "path A: the box operator must be exact 27-diagonal DIA")
    check(expand is not None and expand.slow_idx is None, "path A: the box must be one slot class")
    return model, t_plan + t_expand


def band_sweep_phases(k, model, dev, smi):
    """Kernel vs plain on the full res-149 operator and ragged ones; determinism of assembly and residual."""
    import torch

    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.sparse.block_dia import assemble_block_dia, band_expand_plan, block_dia_assembly_plan

    u = displacement(model, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = model.assemble_hessian_block_dia(u)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    log(f"assembly at res {RES_A}: {t_asm:.3f} s, bands {tuple(m.bands.shape)} "
        f"({m.bands.numel() * 4 / 1e9:.3f} GB f32)")
    k["max_abs_err"], x2 = sweep_compare(m, f"res={RES_A} N={m.num_nodes} s=3 D={m.num_diagonals}", dev)
    k["ms"], k["plain_ms"], txt = in_turns(
        lambda: ds.dia_sweep(m.bands, m.offsets, x2), lambda: ds.dia_sweep_plain(m.bands, m.offsets, x2)
    )
    gbps = m.bands.numel() * 4 / (k["ms"] * 1e-3) / 1e9
    bound_txt = set_bound(k, (m.bands.numel() + 2 * x2.numel()) * 4, 2 * m.bands.numel())
    log(f"time dia_sweep res={RES_A}: {txt}; bands streamed at {gbps:.1f} GB/s; {bound_txt} ({smi})")
    k["library_ms"] = csr_library_ms(m, x2, ds.dia_sweep(m.bands, m.offsets, x2), smi)

    # determinism: bands and residuals bitwise repeatable
    again = model.assemble_hessian_block_dia(u)
    same_bands = bool(torch.equal(m.bands, again.bands))
    del again
    r1, r2 = model.residual(u), model.residual(u)
    model64 = assembled_model(RES_A, torch.float64, dev, 32768, mesh=model.mesh)
    u64 = u.double()
    r3, r4 = model64.residual(u64), model64.residual(u64)
    same_res = bool(torch.equal(r1, r2)) and bool(torch.equal(r3, r4))
    log(f"determinism at res {RES_A}: bands bitwise equal={same_bands}, "
        f"f32 and f64 residuals bitwise equal={same_res}")
    check(same_bands, "two band assemblies on one u differ")
    check(same_res, "two residuals on one u differ")
    del m, r1, r2, r3, r4, model64, u64, x2
    free_memory()

    # ragged operators: N not a multiple of the block, s = 1, a remainder
    small = assembled_model(6, torch.float32, dev, None)
    sweep_compare(small.assemble_hessian_block_dia(displacement(small, 4)), "res=6 N=343 s=3", dev, 1)
    sweep_compare(small.assemble_hessian_block_dia(displacement(small, 5), max_diagonals=20),
                  "res=6 N=343 s=3 max_diagonals=20 (remainder)", dev, 2)
    mesh = create_unit_box_uniform_hex_mesh_3d(8)
    lap = assembled_model(8, torch.float32, dev, None, mesh=mesh)
    plan1 = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, 1, device=dev)
    A_el = assemble_element_elliptic_matrices(lap.space.X_geo, None, LaplaceOperator(), None, lap.tab)
    m1 = assemble_block_dia(plan1, A_el, expand=band_expand_plan(mesh.cells, plan1, device=dev))
    sweep_compare(m1, "res=8 N=729 s=1 (Laplace)", dev, 3)


def path_a_solve(kernels, model, plan_s, dev, smi):
    """Path A's solve and its independent f64 check; returns the f64 solution."""
    import torch

    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    asm_times, inner_times = [], []
    # instance attributes shadow the methods for this solve only
    model.assemble_hessian_block_dia = timed(model.assemble_hessian_block_dia, asm_times)
    model._assembled_cg = timed(model._assembled_cg, inner_times)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        asm_txt = "" if cg is None else f" assembly={asm_times[-1]:.3f} s"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}{asm_txt}")

    log(f"path A: solve_mixed(assembled=True) res={RES_A} dofs={model.space.num_dofs}:")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30,
                            assembled=True, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels["dia_sweep"]["fn"].launches
    kernels["dia_sweep"]["launches"] = launches
    del model.assemble_hessian_block_dia, model._assembled_cg
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_asm, t_inner = sum(asm_times), sum(inner_times)
    log(f"path A: status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} "
        f"assembly_s={[round(t, 3) for t in asm_times]} wall={wall:.3f} s (plan {plan_s:.3f} s before it) "
        f"|F|/|F0|={res.residual_norm / history[0]:.6e} dia_sweep launches={launches} "
        f"peak memory {peak:.2f} GB ({smi})")
    log(f"path A breakdown: assembly {t_asm:.3f} s, CG {t_inner - t_asm:.3f} s "
        f"({(t_inner - t_asm) / max(sum(cg_iters), 1) * 1e3:.3f} ms per iteration), "
        f"f64 residuals and Newton {wall - t_inner:.3f} s of {wall:.3f} s wall")
    check(res.status == NEWTON_CONVERGED, f"path A: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "path A: non-finite displacement")
    check(launches > 0, "path A: the band-sweep kernel was not launched")
    check(launches >= sum(cg_iters), f"path A: {launches} band sweeps for {sum(cg_iters)} CG iterations")

    # independent f64 check: a fresh model from the same fields (tools/solve_assembled.py:85-102)
    x64 = res.x.detach().double()
    del res
    free_memory()
    t0 = time.perf_counter()
    fresh = assembled_model(RES_A, torch.float64, dev, 8192, mesh=model.mesh)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    uz_min = float(x64.reshape(-1, 3)[:, 2].min())
    log(f"path A independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}, "
        f"tip uz min {uz_min:.6e}; {time.perf_counter() - t0:.3f} s)")
    check(true_r / r0 <= 1e-10, f"path A: independent relative residual {true_r / r0:.3e} > 1e-10")
    del fresh
    free_memory()
    return x64


def f64_banded_check(kernels, dev):
    """An f64 banded model on the card (plain gather and scatter) against the unbanded f64 model;
    an f32 banded residual launches the gather and scatter kernels."""
    import torch

    plain = assembled_model(6, torch.float64, dev, None)
    banded = assembled_model(6, torch.float64, dev, None, mesh=plain.mesh, banded=True)
    u = displacement(plain, seed=31)
    reset_counts(kernels)
    rel_r = float((banded.residual(u) - plain.residual(u)).abs().max() / plain.residual(u).abs().max())
    rel_d = float((banded.hessian_diagonal(u) - plain.hessian_diagonal(u)).abs().max()
                  / plain.hessian_diagonal(u).abs().max())
    f64_launches = kernels["banded_gather"]["fn"].launches + kernels["banded_scatter"]["fn"].launches
    banded32 = assembled_model(6, torch.float32, dev, None, mesh=plain.mesh, banded=True)
    banded32.residual(u.float())
    torch.cuda.synchronize()
    g32, s32 = kernels["banded_gather"]["fn"].launches, kernels["banded_scatter"]["fn"].launches
    log(f"f64 banded model res=6 on the card: residual rel {rel_r:.3e}, Jacobi diagonal rel {rel_d:.3e} against "
        f"the unbanded f64 model (limit 1e-12), kernel launches {f64_launches}; f32 banded residual: "
        f"banded_gather launches={g32}, banded_scatter launches={s32}")
    check(rel_r <= 1e-12 and rel_d <= 1e-12, "f64 banded model differs from the unbanded one")
    check(f64_launches == 0, "the f64 banded model launched an f32 kernel")
    check(g32 > 0 and s32 > 0, "the f32 banded residual did not launch the gather and scatter kernels")


def cg_count_diagnostic(dev, smi):
    """The first Newton step's CG iterations on path A's problem at res 80 (u = 0, the f32 residual as
    right-hand side, Jacobi, relative tolerance 1e-4) seven ways: assembled with the band-sweep
    kernel and with the plain band matvec; the fused matrix-free operator (C2) with its kernel; (a)
    assembled in f64 (f64 bands, the plain band matvec, CG in f64); (b) element matrices computed in
    f64 and cast to f32 before the f32 band assembly, with the band-sweep kernel; (c) the f32 assembly
    with the element tangent's J taken relative to each element's first node (as ``local_em`` and the
    em kernels take it), with the band-sweep kernel; (d) the fused operator's plain version
    (``banded_tangent_sweep_plain``) in f32."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.elasticity as el
    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.sparse.cg import conjugate_gradient

    model = assembled_model(RES_DIAG, torch.float32, dev, CHUNK_A)
    u0 = torch.zeros(model.space.num_dofs, device=dev)
    f = model.residual(u0)
    pairs = el.assemble_element_elliptic_matrices_pairs
    counts = {}

    def assembled_cg(name, m, kernel):
        hvp2, inv_diag2 = m.assembled_hessian_operator(u0.to(m.dtype), layout="component", kernel=kernel)
        rhs = f.to(m.dtype).reshape(-1, 3).T.contiguous()
        cg = conjugate_gradient(hvp2, rhs, preconditioner=lambda v: inv_diag2 * v,
                                rel_tolerance=1e-4, max_iter=2000, check_definiteness=False)
        counts[name] = (cg.num_iterations, cg.status)

    assembled_cg("band-sweep kernel", model, True)
    assembled_cg("plain band matvec", model, False)
    fused = assembled_model(RES_DIAG, torch.float32, dev, None, mesh=model.mesh, banded=True, fused_kernels=True)
    cg = fused._matrix_free_cg(u0, f, None, 1e-4, 2000)
    counts["fused matrix-free kernel"] = (cg.num_iterations, cg.status)
    model64 = assembled_model(RES_DIAG, torch.float64, dev, CHUNK_A, mesh=model.mesh)
    assembled_cg("(a) assembled f64, plain band matvec", model64, False)
    del model64
    free_memory()
    f64_elements = lambda X, u_el, *a: pairs(X.double(), u_el.double(), *a).float()  # noqa: E731
    with mock.patch.object(el, "assemble_element_elliptic_matrices_pairs", f64_elements):
        assembled_cg("(b) f64 element matrices in f32 bands, band-sweep kernel", model, True)
    node_relative = lambda X, u_el, *a: pairs(X - X[:, :1], u_el, *a)  # noqa: E731
    with mock.patch.object(el, "assemble_element_elliptic_matrices_pairs", node_relative):
        assembled_cg("(c) f32 assembly, node-relative J, band-sweep kernel", model, True)
    plain_sweep = lambda plan, X, u, v, op, params, tab, tables: es.banded_tangent_sweep_plain(  # noqa: E731
        plan, X, u, v, op, params, tab)
    with mock.patch.object(es, "banded_tangent_sweep", plain_sweep):
        cg = fused._matrix_free_cg(u0, f, None, 1e-4, 2000)
    counts["(d) fused plain version f32"] = (cg.num_iterations, cg.status)
    for name, (it, st) in counts.items():
        log(f"CG-count diagnostic res={RES_DIAG} dofs={model.space.num_dofs}, first Newton step: {name}: "
            f"{it} iterations (status {st}) ({smi})")
    del model, fused
    free_memory()


# -- path C: the matrix-free banded solve -------------------------------------------------


def banded_kernel_checks(kernels, model, shape_txt, dev, seed, smi=None):
    """The banded-path kernels against their plain versions on one fused model's layout.

    With ``smi`` also times them (kernel, plain, library call) and sets
    their bounds, from these inputs, and times each fused sweep against the
    route it replaced (gathers, then the element-minor sweep on the gathered
    rows).
    """
    import torch

    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.assembly.local_em import (
        assemble_element_elliptic_tangent_vectors_em,
        assemble_element_elliptic_vectors_em,
    )

    plan, X, tables = model._plan, model._X_band, model._em_tables
    op, params, tab = model.operator, model.params, model.tab
    N, n, pe = plan.num_nodes, plan.n, plan.padded_elements
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((N, 3), generator=g, device=dev)
    valid = plan.valid_rows > 0
    # padding rows nonzero, as on the main path (the sweep of the repeated
    # element): kernel and plain version must both drop them
    f_el = torch.randn((pe, n, 3), generator=g, device=dev)
    u = displacement(model, seed).reshape(N, 3)
    v = torch.randn((N, 3), generator=g, device=dev)
    u_em = bd.banded_gather(plan, u).permute(1, 2, 0)  # element-major rows, as the gather writes them
    v_em = bd.banded_gather(plan, v).permute(1, 2, 0)
    errs = {}

    # gather: bitwise equal to the plain version and to u[cells[perm]] on valid rows
    got, again, ref = bd.banded_gather(plan, w), bd.banded_gather(plan, w), bd.banded_gather_plain(plan, w)
    errs["banded_gather"] = compare("banded_gather", shape_txt, got, again, ref)
    cells_perm = torch.as_tensor(model.mesh.cells[plan.perm].reshape(-1), dtype=torch.int64, device=dev)
    exact = bool(torch.equal(got, ref)) and bool(torch.equal(got.reshape(-1, 3)[valid], w[cells_perm]))
    log(f"banded_gather {shape_txt}: bitwise equal to the plain version and to u[cells[perm]]: {exact}")
    check(exact, f"banded_gather {shape_txt}: not bitwise equal to u[cells[perm]]")
    del got, again, ref, cells_perm
    got, again, ref = bd.banded_scatter(plan, f_el), bd.banded_scatter(plan, f_el), bd.banded_scatter_plain(plan, f_el)
    errs["banded_scatter"] = compare("banded_scatter", shape_txt, got, again, ref)
    log(f"banded_scatter {shape_txt}: bitwise equal to the plain version (same row order): {bool(torch.equal(got, ref))}")
    del got, again, ref
    # the fused tangent sweep (the main path's CG operator) on the node vectors
    fused = lambda: es.banded_tangent_sweep(plan, X, u, v, op, params, tab, tables)  # noqa: E731
    errs["em_vector_tangent_sweep"] = compare(
        "banded_tangent_sweep", shape_txt, fused(), fused(), es.banded_tangent_sweep_plain(plan, X, u, v, op, params, tab))
    # the fused vector sweep (the main path's residual); padding elements get zero rows
    fused_vec = lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables)  # noqa: E731
    got = fused_vec()
    compare("banded_vector_sweep", shape_txt, got, fused_vec(), es.banded_vector_sweep_plain(plan, X, u, op, params, tab))
    padding = ~valid.reshape(pe, n)[:, 0]
    zero_pad = not bool(got[padding].any())
    log(f"banded_vector_sweep {shape_txt}: {int(padding.sum())} padding elements, their rows zero: {zero_pad}")
    check(zero_pad, f"banded_vector_sweep {shape_txt}: a padding element's row is not zero")
    del got
    # the element-minor sweeps on element-major rows; on the small shapes contiguous element-minor arrays too
    layouts = [("element-major rows", u_em, v_em)]
    if smi is None:
        layouts.append(("element-minor", u_em.contiguous(), v_em.contiguous()))
    for layout, ue, ve in layouts:
        txt = f"{shape_txt} {layout}"
        compare("em_vector_sweep", txt, es.em_vector_sweep(X, ue, op, params, tab, tables),
                es.em_vector_sweep(X, ue, op, params, tab, tables),
                assemble_element_elliptic_vectors_em(X, ue, op, params, tab))
        compare("em_vector_tangent_sweep", txt, es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables),
                es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables),
                assemble_element_elliptic_tangent_vectors_em(X, ue, ve, op, params, tab))
    free_memory()
    if smi is None:
        return
    for name, err in errs.items():
        kernels[name]["max_abs_err"] = err
    runs = gather_scatter_runs(plan, w, f_el, dev, ("banded_gather", "banded_scatter"))
    runs["em_vector_tangent_sweep"] = (fused, lambda: es.banded_tangent_sweep_plain(plan, X, u, v, op, params, tab),
                                       None, *em_sweep_cost(plan, tab, op, True), 5)
    time_records(kernels, runs, shape_txt, smi)

    # the fused sweep against the route it replaced, in turns: two gathers, then the element-minor
    # tangent sweep on the gathered element-major rows
    def old_route():
        ue, ve = (bd.banded_gather(plan, a).permute(1, 2, 0) for a in (u, v))
        return es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables)

    fused_ms, old_ms, txt = in_turns(fused, old_route, reps=10, names=("fused", "old route"))
    strided_ms = min(event_ms(lambda: es.em_vector_tangent_sweep(X, u_em, v_em, op, params, tab, tables), 10)
                     for _ in range(2))
    log(f"time banded_tangent_sweep {shape_txt}: {txt} (fused faster: {fused_ms < old_ms}); the element-minor "
        f"tangent sweep alone on element-major rows {strided_ms:.4f} ms ({smi})")
    free_memory()
    vector_sweep_turns(model, u, shape_txt, smi)


def banded_star_check(dev, m=6644):
    """The gather and scatter at s = 1, 2, 3 on a closed fan of ``m`` tri3: the centre node has ``m`` rows,
    which one scatter thread walks in hundreds of batches with one running sum.  Both kernels bitwise equal
    to their plain versions and to their own repeats."""
    import numpy as np
    import torch

    import fenris_tpu_torch.ops.banded as bd

    rim = np.arange(1, m + 1)
    cells = np.stack([np.zeros(m, np.int64), rim, np.roll(rim, -1)], axis=1)
    for s in (1, 2, 3):
        plan = bd.make_banded_plan(cells, m + 1, s=s, r_nodes=1024, device=dev)
        centre = int(plan.row_ptr[1] - plan.row_ptr[0])
        check(centre == m, f"banded star: the centre has {centre} rows, not {m}")
        g = torch.Generator(device=dev).manual_seed(41 + s)
        u = torch.randn((m + 1, s), generator=g, device=dev)
        f_el = torch.randn((plan.padded_elements, plan.n, s), generator=g, device=dev)
        txt = f"star m={m} s={s}"
        for fn, plain, arg in ((bd.banded_gather, bd.banded_gather_plain, u),
                               (bd.banded_scatter, bd.banded_scatter_plain, f_el)):
            got, ref = fn(plan, arg), plain(plan, arg)
            compare(fn.__name__, txt, got, fn(plan, arg), ref)
            check(bool(torch.equal(got, ref)), f"{fn.__name__} {txt}: not bitwise equal to the plain version")
        log(f"banded {txt}: gather and scatter bitwise equal to their plain versions and repeats")


def gather_scatter_runs(plan, w, f_el, dev, names):
    """:func:`time_records` runs of the banded gather of node vectors ``w [N, s]`` and the banded scatter of
    rows ``f_el [E_pad, n, s]`` under the record names ``names``, with ``index_select`` and ``index_add_``
    as their library calls.  Bytes the functions need: the gather reads w, the valid rows' node indices and
    the per-block row counts and writes every row (padding rows are zeros); the scatter reads the valid rows
    and its CSR map and writes the nodes.  Each run also carries, for :func:`card_ms`, the kernel's and the
    library call's calls on :func:`l2_copies` copies of their inputs."""
    import dataclasses

    import torch

    import fenris_tpu_torch.ops.banded as bd

    N, s, nv = w.shape[0], w.shape[1], plan.node_rows.numel()  # nv: the valid rows
    idx = plan.nodes_padded.long()
    valid = plan.valid_rows > 0
    # index_add_'s padding rows go to 4096 spare rows past the N nodes (spread, so its atomics do not
    # pile onto one address)
    idx_spare = torch.where(valid, idx, torch.arange(idx.numel(), device=dev) % 4096 + N)
    gather_bytes = (plan.padded_elements * plan.n * s + nv + plan.block_rows.numel() + N * s) * 4
    scatter_bytes = (nv * s + plan.row_ptr.numel() + nv + N * s) * 4
    sets = [(plan, w, f_el, idx, idx_spare)]
    for _ in range(l2_copies(min(gather_bytes, scatter_bytes)) - 1):
        p = dataclasses.replace(plan, **{k: getattr(plan, k).clone() for k in
                                         ("nodes_padded", "block_rows", "row_ptr", "node_rows")})
        sets.append((p, w.clone(), f_el.clone(), idx.clone(), idx_spare.clone()))
    return {
        names[0]: (lambda: bd.banded_gather(plan, w), lambda: bd.banded_gather_plain(plan, w),
                   lambda: torch.index_select(w, 0, idx), gather_bytes, 0, 20,
                   ([lambda p=p, a=a: bd.banded_gather(p, a) for p, a, _, _, _ in sets],
                    [lambda a=a, i=i: torch.index_select(a, 0, i) for _, a, _, i, _ in sets])),
        names[1]: (lambda: bd.banded_scatter(plan, f_el), lambda: bd.banded_scatter_plain(plan, f_el),
                   lambda: torch.zeros((N + 4096, s), device=dev).index_add_(0, idx_spare, f_el.reshape(-1, s)),
                   scatter_bytes, nv * s, 20,
                   ([lambda p=p, a=a: bd.banded_scatter(p, a) for p, _, a, _, _ in sets],
                    [lambda a=a, i=i: torch.zeros((N + 4096, s), device=dev).index_add_(0, i, a.reshape(-1, s))
                     for _, _, a, _, i in sets])),
    }


def l2_copies(nbytes, most=20):
    """Copies of a call's inputs to cycle through so that 3x the card's 50 MB L2 passes between two uses of
    one copy: a call then finds little of its data in L2, as a call between other kernels does."""
    return min(most, max(1, -(-3 * L2_BYTES // int(nbytes))))


def card_ms(calls, reps=20):
    """The card's time per call: ``reps`` calls, cycling through ``calls`` (each on its own copy of the
    inputs), captured in one CUDA graph and replayed after warm-up calls on a side stream; each call's output
    lives until ``len(calls)`` later calls were made, so no two calls in that span write one buffer.  The
    host's time to make the calls is not in it."""
    import collections

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, kept = torch.cuda.CUDAGraph(), collections.deque(maxlen=len(calls))
    with torch.cuda.graph(graph):
        for i in range(reps):
            kept.append(calls[i % len(calls)]())
    ms = event_ms(graph.replay, 1, 1) / reps
    del graph, kept
    return ms


def time_records(kernels, runs, shape_txt, smi):
    """``runs``: ``{record name: (kernel, plain, library call or None, bytes, f32 operations, repeats[,
    (kernel calls, library calls)])}``.  Times each kernel in turns with its plain version (two repeats of a
    plain version that runs at 5 repeats or fewer: it takes a large part of a second) and its library call,
    all eagerly (``ms``, ``plain_ms``, ``library_ms``), sets its bound, and writes them into its record.
    Where a run carries calls on copies of its inputs, the kernel and the library call are also timed on the
    card alone (``card_ms``, ``library_card_ms``: :func:`card_ms`, the lower of two)."""
    for name, (run_k, run_p, run_lib, nbytes, ops, reps, *cold) in runs.items():
        k = kernels[name]
        k["ms"], k["plain_ms"], txt = in_turns(run_k, run_p, reps=reps, plain_reps=None if reps > 5 else 2)
        k["library_ms"] = None
        if run_lib is not None:
            k["library_ms"] = min(event_ms(run_lib, reps), event_ms(run_lib, reps))
            txt += f", library {k['library_ms']:.4f} ms (kernel faster: {k['ms'] < k['library_ms']})"
        bound_txt = set_bound(k, nbytes, ops)
        if cold:
            calls, lib_calls = cold[0]
            k["card_ms"] = min(card_ms(calls, reps), card_ms(calls, reps))
            k["library_card_ms"] = min(card_ms(lib_calls, reps), card_ms(lib_calls, reps))
            txt += (f"; on the card ({len(calls)} input copies cycled): kernel {k['card_ms']:.4f} ms "
                    f"({k['bound_ms'] / k['card_ms'] * 100:.1f}% of the bound), library {k['library_card_ms']:.4f}"
                    f" ms (kernel faster: {k['card_ms'] < k['library_card_ms']})")
        log(f"time {name} {shape_txt}: {txt}; {bound_txt}, {k['bound_ms'] / k['ms'] * 100:.1f}% of it eagerly "
            f"({smi})")


def vector_sweep_turns(model, u, shape_txt, smi, record=None):
    """The fused vector sweep (one kernel) in turns against the route it replaced on ``model``'s layout:
    the banded gather, then the element-minor vector sweep on the gathered element-major rows.  With
    ``record`` (the kernel's record) also its error, its time against its plain version's, and its bound."""
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es

    plan, X, tables = model._plan, model._X_band, model._em_tables
    op, params, tab = model.operator, model.params, model.tab

    def old_route():
        return es.em_vector_sweep(X, bd.banded_gather(plan, u).permute(1, 2, 0), op, params, tab, tables)

    fused = lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables)  # noqa: E731
    plain = lambda: es.banded_vector_sweep_plain(plan, X, u, op, params, tab)  # noqa: E731
    fused_ms, old_ms, txt = in_turns(fused, old_route, reps=10, names=("fused", "old route"))
    bound = {} if record is None else record
    bound_txt = set_bound(bound, *em_sweep_cost(plan, tab, op, False))
    log(f"time banded_vector_sweep {shape_txt}: {txt} (fused faster: {fused_ms < old_ms}); {bound_txt}, "
        f"{bound['bound_ms'] / fused_ms * 100:.1f}% of it ({smi})")
    if record is not None:
        got, ref = fused(), plain()
        record["max_abs_err"] = compare("banded_vector_sweep", shape_txt, got, fused(), ref)
        # both f32 versions against an f64 evaluation: the stress cancels to O(strain) at small strains
        ref64 = es.banded_vector_sweep_plain(plan, X.double(), u.double(), op, params, tab)
        scale = float(ref64.abs().max())
        log(f"banded_vector_sweep {shape_txt} against f64 on the same f32 inputs: kernel "
            f"{float((got.double() - ref64).abs().max()) / scale:.3e}, plain "
            f"{float((ref.double() - ref64).abs().max()) / scale:.3e}")
        del got, ref, ref64
        record["ms"], record["plain_ms"], txt = in_turns(fused, plain, reps=5)
        record["library_ms"] = None  # no PyTorch call computes the element forces
        log(f"time em_vector_sweep {shape_txt}: {txt}; {bound_txt} ({smi})")
    free_memory()


def path_c_kernels(kernels, model, dev, smi):
    """C1: the kernels at the res-149 layout (timed), then on the ragged boxes."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    plan = model._plan
    banded_kernel_checks(kernels, model, f"res={RES_A} E_pad={plan.padded_elements} blocks={plan.k_blocks}", dev, 11,
                         smi)
    for res, rcm in RAGGED_C:
        mesh = create_unit_box_uniform_hex_mesh_3d(res)
        if rcm:
            mesh, _ = reorder_mesh(mesh, device=dev)
        small = assembled_model(res, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True,
                                banded_r_nodes=1024)
        p = small._plan
        banded_kernel_checks(kernels, small, f"res={res}{' rcm' if rcm else ''} E={small.mesh.num_cells} "
                             f"E_pad={p.padded_elements} blocks={p.k_blocks}", dev, 12 + res)


def path_c_solve(kernels, model, plan_s, x_a, dev, smi):
    """C2: solve_mixed on the fused banded model at res 149; the independent f64 check."""
    import torch

    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    inner_times, diag_times = [], []
    # instance attributes shadow the methods for this solve only
    model._matrix_free_cg = timed(model._matrix_free_cg, inner_times)
    model.hessian_diagonal = timed(model.hessian_diagonal, diag_times)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else (f" cg_iters={cg.num_iterations} cg_status={cg.status} "
                                        f"diag={diag_times[-1]:.3f} s inner={inner_times[-1]:.3f} s")
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    path = ("banded_gather", "banded_scatter", "em_vector_tangent_sweep")
    log(f"path C2: solve_mixed(banded=True, fused_kernels=True) res={RES_A} dofs={model.space.num_dofs}:")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels[name]["fn"].launches for name in path}
    for name in path:
        kernels[name]["launches"] = launches[name]
    del model._matrix_free_cg, model.hessian_diagonal
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_inner, t_diag, iters = sum(inner_times), sum(diag_times), max(sum(cg_iters), 1)
    log(f"path C2: status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} wall={wall:.3f} s "
        f"(plan {plan_s:.3f} s before it) |F|/|F0|={res.residual_norm / history[0]:.6e} launches={launches} "
        f"banded_vector_sweep launches={kernels['em_vector_sweep']['fn'].launches} peak memory {peak:.2f} GB ({smi})")
    log(f"path C2 breakdown: Jacobi diagonals {t_diag:.3f} s, CG {t_inner - t_diag:.3f} s "
        f"({(t_inner - t_diag) / iters * 1e3:.3f} ms per iteration), "
        f"f64 residuals and Newton {wall - t_inner:.3f} s of {wall:.3f} s wall")
    check(res.status == NEWTON_CONVERGED, f"path C2: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "path C2: non-finite displacement")
    for name in path:
        check(launches[name] > 0, f"path C2: kernel {name} was not launched")
    check(launches["em_vector_tangent_sweep"] >= sum(cg_iters),
          f"path C2: {launches['em_vector_tangent_sweep']} tangent sweeps for {sum(cg_iters)} CG iterations")
    # the fused operator reads u and v itself: the gather runs for the Jacobi diagonal only
    check(launches["banded_gather"] <= 2 * len(cg_iters),
          f"path C2: {launches['banded_gather']} gathers for {len(cg_iters)} Newton steps (limit 2 a step)")

    x64 = res.x.detach().double()
    del res
    free_memory()
    t0 = time.perf_counter()
    fresh = assembled_model(RES_A, torch.float64, dev, 8192, mesh=model.mesh)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    diff = float(torch.linalg.vector_norm(x64 - x_a) / torch.linalg.vector_norm(x_a))
    log(f"path C2 independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}); "
        f"relative difference from path A's solution {diff:.6e}; {time.perf_counter() - t0:.3f} s")
    check(true_r / r0 <= 1e-10, f"path C2: independent relative residual {true_r / r0:.3e} > 1e-10")
    del fresh, x64
    free_memory()
    return cg_iters


def path_c3(kernels, dev, smi):
    """C3: the f32 solve() on the RCM-reordered res-63 box; the unfused Hessian action."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    t0 = time.perf_counter()
    mesh, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(RES_C3), device=dev)
    t_reorder = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = assembled_model(RES_C3, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    plan = model._plan
    log(f"path C3 res={RES_C3}: {mesh.num_cells} hex8, {model.space.num_dofs} dofs; RCM {t_reorder:.3f} s "
        f"(on the card, one breadth-first level a step); "
        f"model with banded plan {t_model:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
        f"window {plan.wa} x 128 nodes)")
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve(max_newton_iterations=4, cg_rel_tolerance=1e-4, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k9 = kernels["em_vector_sweep"]
    k9["launches"] = k9["fn"].launches
    ratio = res.residual_norm / history[0]
    log(f"path C3 solve(): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={ratio:.6e} banded_vector_sweep launches={k9['launches']} ({smi})")
    check(tuple(res.x.shape) == (model.space.num_dofs,) and bool(torch.isfinite(res.x).all()),
          "path C3: wrong or non-finite displacement")
    check(ratio <= 1e-1, f"path C3: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(k9["launches"] > 0, "path C3: the vector-sweep kernel was not launched")

    # one residual: the fused vector sweep reads u itself, so no gather runs
    reset_counts(kernels)
    model.residual(res.x)
    torch.cuda.synchronize()
    counts = {n: kernels[n]["fn"].launches for n in ("banded_gather", "em_vector_sweep", "banded_scatter")}
    log(f"path C3 one residual: launches banded_gather={counts['banded_gather']}, "
        f"banded_vector_sweep={counts['em_vector_sweep']}, banded_scatter={counts['banded_scatter']}")
    check(counts == {"banded_gather": 0, "em_vector_sweep": 1, "banded_scatter": 1},
          f"path C3: one residual launched {counts} (expected no gather, one sweep, one scatter)")
    vector_sweep_turns(model, res.x.reshape(-1, 3), f"res={RES_C3} rcm E={mesh.num_cells} "
                       f"E_pad={plan.padded_elements} blocks={plan.k_blocks}", smi, record=k9)

    # the unfused banded route: torch.func.jvp through the gather/scatter pair
    unfused = assembled_model(RES_C3, torch.float32, dev, None, mesh=mesh, banded=True)
    g = torch.Generator(device=dev).manual_seed(21)
    v = torch.randn(model.space.num_dofs, generator=g, device=dev)
    hv_fused = model.hessian_vector_product(res.x, v)
    before = kernels["banded_gather"]["fn"].launches
    hv_jvp = unfused.hessian_vector_product(res.x, v)
    torch.cuda.synchronize()
    rel = float((hv_jvp - hv_fused).abs().max() / hv_fused.abs().max())
    gathers = kernels["banded_gather"]["fn"].launches - before
    log(f"path C3 unfused Hessian action (torch.func.jvp, {gathers} gather launches) vs fused: rel {rel:.6e} "
        f"(limit 5e-4)")
    check(gathers > 0, "path C3: the unfused Hessian action did not go through the gather kernel")
    check(rel <= 5e-4, f"path C3: unfused vs fused Hessian action rel {rel:.3e} > 5e-4")
    unfused_operator_choice(unfused, res.x, v, hv_jvp, cg_iters, smi)
    del model, unfused, res
    free_memory()


def unfused_operator_choice(model, u, v, hv_jvp, cg_iters, smi):
    """The unfused CG operator: ``jvp`` per application (what ``hessian_operator`` does) against
    ``torch.func.linearize`` once per Newton step and its linear map per application (what the
    JAX package does), costed at C3's CG iterations a step."""
    import torch

    free = model.free_mask
    t_jvp = event_ms(lambda: model.hessian_vector_product(u, v), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lin = torch.func.linearize(model.internal_forces, u)
    torch.cuda.synchronize()
    t_trace = (time.perf_counter() - t0) * 1e3
    apply_lin = lambda: torch.where(free, lin(torch.where(free, v, 0.0)), v)  # noqa: E731
    rel = float((apply_lin() - hv_jvp).abs().max() / hv_jvp.abs().max())
    t_lin = event_ms(apply_lin, reps=5)
    check(rel <= KERNEL_RTOL, f"path C3: linearized vs jvp Hessian action rel {rel:.3e} > {KERNEL_RTOL:g}")
    k = sum(cg_iters) / max(len(cg_iters), 1)
    even = t_trace / (t_jvp - t_lin) if t_jvp > t_lin else float("inf")
    log(f"path C3 unfused operator res={RES_C3}: jvp {t_jvp:.4f} ms an application; linearize {t_trace:.3f} ms "
        f"once, then {t_lin:.4f} ms an application (rel {rel:.6e} from jvp); at {k:.1f} CG iterations a Newton "
        f"step: jvp {k * t_jvp:.3f} ms, linearize {t_trace + k * t_lin:.3f} ms; break-even {even:.1f} "
        f"iterations ({smi})")
    del lin
    free_memory()


# -- Poisson on hex8 and the unstructured multigrid ------------------------------------------


def element_box(name, res):
    """The unit box of ``name`` cells: hex8 or BCC tet4 boxes, converted (convert_mesh) for the others."""
    from fenris_tpu_torch.mesh.convert import convert_mesh
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d, create_unit_box_uniform_tet_mesh_3d

    base = (create_unit_box_uniform_tet_mesh_3d if name.startswith("tet") else create_unit_box_uniform_hex_mesh_3d)(res)
    return base if name in ("tet4", "hex8") else convert_mesh(base, name)


def element_rule(spec):
    """A rule from ``(function name in quadrature or quadrature.total_order, argument)``."""
    from fenris_tpu_torch import quadrature

    fn, arg = spec
    return getattr(quadrature.total_order if fn in ("tetrahedron", "triangle") else quadrature, fn)(arg)


def mms_problem():
    """The MMS problem of tests/mms_common.py:32-54 in torch: source, exact solution and its gradient
    (pointwise, run under vmap), and the Dirichlet nodes (||x - 0.5||_inf > 0.4999)."""
    import numpy as np
    import torch

    def u_exact(x):
        return torch.sin(np.pi * x[0]) * torch.sin(np.pi * x[1]) * torch.sin(np.pi * x[2])

    def u_exact_grad(x):
        sn, cs = torch.sin(np.pi * x), torch.cos(np.pi * x)
        return np.pi * torch.stack([cs[0] * sn[1] * sn[2], sn[0] * cs[1] * sn[2], sn[0] * sn[1] * cs[2]])

    def source(x, p):
        return 3.0 * np.pi**2 * u_exact(x)

    def dirichlet(mesh):
        return np.flatnonzero(np.abs(mesh.points - 0.5).max(axis=1) > 0.4999)

    return source, u_exact, u_exact_grad, dirichlet


def poisson_solvers():
    from fenris_tpu_torch import fem

    return {"assembled": fem.solve_poisson_assembled, "matrix_free": fem.solve_poisson_matrix_free}


def poisson_mms_gate(dev, smi):
    """The reference's acceptance gate (tests/test_convergence.py:85-90) at its full hex8 resolutions on
    the card: f64 on both routes within 1% of tests/reference_values/poisson3d_mms_hex8_summary.json
    (resolutions to 1e-12); f32 on both routes (the band sweep, or the banded gather and scatter at
    s = 1) at CG tolerance F32_TOL_MMS, deviations printed."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.quadrature import hexahedron_gauss

    ref = json.loads((ROOT / "tests/reference_values/poisson3d_mms_hex8_summary.json").read_text())
    source, u_exact, u_exact_grad, dirichlet = mms_problem()
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, F32_TOL_MMS)):
        for route, solve in poisson_solvers().items():
            t0 = time.perf_counter()
            diam, dev_l2, dev_h1, iters = [], [], [], []
            for i, res in enumerate(MMS_RESOLUTIONS):
                mesh = create_unit_box_uniform_hex_mesh_3d(res)
                r = solve(mesh, hexahedron_gauss(2), hexahedron_gauss(6), source, u_exact, u_exact_grad,
                          dirichlet(mesh), rel_tolerance=tol, dtype=dtype, device=dev)
                diam.append(float(mesh.diameters().max()))
                dev_l2.append(abs(r.l2_error - ref["L2_errors"][i]) / ref["L2_errors"][i])
                dev_h1.append(abs(r.h1_seminorm_error - ref["H1_seminorm_errors"][i]) / ref["H1_seminorm_errors"][i])
                iters.append(r.cg_iterations)
            torch.cuda.synchronize()
            res_dev = max(abs(a - b) / b for a, b in zip(diam, ref["resolutions"]))
            log(f"Poisson MMS hex8 {route} {str(dtype).removeprefix('torch.')} (CG rel {tol:g}) at resolutions "
                f"{list(MMS_RESOLUTIONS)}: L2 deviation from the reference {[f'{d:.3e}' for d in dev_l2]}, "
                f"H1 {[f'{d:.3e}' for d in dev_h1]}, diameters rel {res_dev:.1e}, CG iterations {iters}; "
                f"{time.perf_counter() - t0:.3f} s ({smi})")
            check(res_dev <= 1e-12, f"Poisson MMS {route}: resolutions differ from the reference")
            if dtype == torch.float64:
                check(max(dev_l2 + dev_h1) <= 0.01, f"Poisson MMS {route} f64: an error is off the reference by "
                      f"more than 1%: L2 {dev_l2}, H1 {dev_h1}")
    free_memory()
    poisson_mms_elements(dev, smi)


def poisson_mms_elements(dev, smi):
    """The gate on tet4, tet10, tet20, hex20 and hex27 (tests/test_convergence.py:95-138) at the
    reference's resolutions on the card: f64, assembled route (block-DIA bands plus the block-ELL
    remainder of deltas under MMS_MIN_FILL), within 1% of tests/reference_values/
    poisson3d_mms_<element>_summary.json, resolutions to 1e-12."""
    import torch

    from fenris_tpu_torch.fem import solve_poisson_assembled

    source, u_exact, u_exact_grad, dirichlet = mms_problem()
    for name, (resolutions, rule, err_rule) in MMS_ELEMENTS.items():
        ref = json.loads((ROOT / f"tests/reference_values/poisson3d_mms_{name}_summary.json").read_text())
        t0 = time.perf_counter()
        diam, dev_l2, dev_h1, iters = [], [], [], []
        for i, res in enumerate(resolutions):
            mesh = element_box(name, res)
            r = solve_poisson_assembled(mesh, element_rule(rule), element_rule(err_rule), source, u_exact, u_exact_grad,
                                        dirichlet(mesh), min_fill=MMS_MIN_FILL, dtype=torch.float64, device=dev)
            diam.append(float(mesh.diameters().max()))
            dev_l2.append(abs(r.l2_error - ref["L2_errors"][i]) / ref["L2_errors"][i])
            dev_h1.append(abs(r.h1_seminorm_error - ref["H1_seminorm_errors"][i]) / ref["H1_seminorm_errors"][i])
            iters.append(r.cg_iterations)
        torch.cuda.synchronize()
        res_dev = max(abs(a - b) / b for a, b in zip(diam, ref["resolutions"]))
        log(f"Poisson MMS {name} assembled float64 at resolutions {list(resolutions)} ({mesh.num_vertices} dofs at "
            f"the last): L2 deviation from the reference {[f'{d:.3e}' for d in dev_l2]}, H1 "
            f"{[f'{d:.3e}' for d in dev_h1]}, diameters rel {res_dev:.1e}, CG iterations {iters}; "
            f"{time.perf_counter() - t0:.3f} s ({smi})")
        check(len(diam) == len(ref["resolutions"]) and res_dev <= 1e-12,
              f"Poisson MMS {name}: resolutions differ from the reference")
        check(max(dev_l2 + dev_h1) <= 0.01, f"Poisson MMS {name} f64: an error is off the reference by more than "
              f"1%: L2 {dev_l2}, H1 {dev_h1}")
    free_memory()


def poisson_f64_operator(mesh, dirichlet_nodes, dev, rule=None, min_fill=0.0, source=None):
    """The f64 Laplace operator (plain band matvec and remainder, Dirichlet dofs masked) and right-hand
    side of the MMS problem on ``mesh`` by ``rule`` (default hexahedron_gauss(2)) with ``source``
    (default the 3D one of mms_problem): the independent check of an f32 Poisson solution."""
    import torch

    from fenris_tpu_torch.assembly.global_ import assemble_vector
    from fenris_tpu_torch.assembly.local import (
        assemble_element_elliptic_matrices,
        assemble_element_source_vectors,
        tabulate,
    )
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import hexahedron_gauss
    from fenris_tpu_torch.sparse.block_dia import assemble_block_dia, block_dia_assembly_plan, block_dia_matvec

    source = mms_problem()[0] if source is None else source
    space = FemSpace.create(mesh, 1, torch.float64, dev)
    tab = tabulate(mesh.element, hexahedron_gauss(2) if rule is None else rule)
    plan = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, 1, min_fill=min_fill, device=dev)
    A = assemble_block_dia(plan, assemble_element_elliptic_matrices(space.X_geo, None, LaplaceOperator(), None, tab,
                                                                    chunk=65536), num_chunks=4)
    free = torch.ones(mesh.num_vertices, dtype=torch.bool, device=dev)
    free[torch.as_tensor(dirichlet_nodes, device=dev)] = False
    b = assemble_vector(assemble_element_source_vectors(space.X_geo, source, None, 1, tab), space.dofs,
                        space.num_dofs)
    b = torch.where(free, b, 0.0)

    def residual(u):
        u = u.double()
        return b - torch.where(free, block_dia_matvec(A, torch.where(free, u, 0.0)), u)

    return residual, b


def scalar_kernel_checks(kernels, bands, offsets, plan, dev, smi, cell="P149"):
    """The s = 1 kernels at a Poisson cell's shapes (P149's, or P2D's): band sweep on the Laplace bands,
    banded gather and scatter on the matrix-free route's layout; each against its plain version (bitwise
    repeats), timed against its bound and a library call, into the records named after ``cell``."""
    import torch

    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.sparse.block_dia import BlockDiaMatrix

    g = torch.Generator(device=dev).manual_seed(41)
    N = bands.shape[1]
    x2 = torch.randn((1, N), generator=g, device=dev)
    k = kernels[f"dia_sweep (s=1, {cell})"]
    txt = f"{cell} s=1 N={N} D={len(offsets)}"
    k["max_abs_err"] = compare("dia_sweep", txt, ds.dia_sweep(bands, offsets, x2), ds.dia_sweep(bands, offsets, x2),
                               ds.dia_sweep_plain(bands, offsets, x2))
    k["ms"], k["plain_ms"], ttxt = in_turns(lambda: ds.dia_sweep(bands, offsets, x2),
                                            lambda: ds.dia_sweep_plain(bands, offsets, x2))
    bound_txt = set_bound(k, (bands.numel() + 2 * x2.numel()) * 4, 2 * bands.numel())
    m = BlockDiaMatrix(offsets=offsets, bands=bands, num_nodes=N, solution_dim=1, remainder=None)
    k["library_ms"] = csr_library_ms(m, x2, ds.dia_sweep(bands, offsets, x2), smi)
    log(f"time dia_sweep {txt}: {ttxt}, library {k['library_ms']:.4f} ms; {bound_txt} ({smi})")

    pe, n = plan.padded_elements, plan.n
    txt = f"{cell} s=1 n={n} E_pad={pe} blocks={plan.k_blocks}"
    w = torch.randn((N, 1), generator=g, device=dev)
    f_el = torch.randn((pe, n, 1), generator=g, device=dev)
    got, ref = bd.banded_gather(plan, w), bd.banded_gather_plain(plan, w)
    kg = kernels[f"banded_gather (s=1, {cell})"]
    kg["max_abs_err"] = compare("banded_gather", txt, got, bd.banded_gather(plan, w), ref)
    check(bool(torch.equal(got, ref)), f"banded_gather {txt}: not bitwise equal to the plain version")
    got, ref = bd.banded_scatter(plan, f_el), bd.banded_scatter_plain(plan, f_el)
    ks = kernels[f"banded_scatter (s=1, {cell})"]
    ks["max_abs_err"] = compare("banded_scatter", txt, got, bd.banded_scatter(plan, f_el), ref)
    log(f"banded gather and scatter {txt}: bitwise equal to the plain versions: "
        f"{bool(torch.equal(got, ref))}")
    del got, ref
    time_records(kernels, gather_scatter_runs(plan, w, f_el, dev, (f"banded_gather (s=1, {cell})",
                                                                  f"banded_scatter (s=1, {cell})")), txt, smi)


def poisson_p149(kernels, dev, smi):
    """P149: f32 Poisson with the MMS source on create_unit_box_uniform_hex_mesh_3d(149) (3,307,949 hex8
    cells, 3,375,000 dofs at s = 1), both routes at CG tolerance F32_TOL_P; set-up, solve and error
    times, CG iterations, launches, the true f64 relative residual (limit 10x the CG tolerance) and the
    two routes' difference; then the s = 1 kernels at these shapes."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.fem as fem_mod
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.sparse.cg as cg_mod
    import fenris_tpu_torch.sparse.dia_kernel as dk
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.quadrature import hexahedron_gauss

    source, u_exact, u_exact_grad, dirichlet = mms_problem()
    mesh = create_unit_box_uniform_hex_mesh_3d(RES_P)
    nd = dirichlet(mesh)
    route_kernels = {"assembled": ("dia_sweep (s=1, P149)",),
                     "matrix_free": ("banded_gather (s=1, P149)", "banded_scatter (s=1, P149)")}
    captured, solutions = {}, {}

    def capture(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            captured[name] = args[0] if name == "matrix" else out
            return out
        return run

    for route, solve in poisson_solvers().items():
        cg_times, err_times = [], []
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(cg_mod, "conjugate_gradient", timed(cg_mod.conjugate_gradient, cg_times)), \
                mock.patch.object(fem_mod, "_errors", timed(fem_mod._errors, err_times)), \
                mock.patch.object(dk, "block_dia_operator", capture("matrix", dk.block_dia_operator)), \
                mock.patch.object(bd, "make_banded_plan", capture("plan", bd.make_banded_plan)):
            r = solve(mesh, hexahedron_gauss(2), hexahedron_gauss(6), source, u_exact, u_exact_grad, nd,
                      rel_tolerance=F32_TOL_P, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in route_kernels[route]:
            kernels[name]["launches"] = kernels[name]["fn"].launches
        launches = {name: kernels[name]["launches"] for name in route_kernels[route]}
        peak = torch.cuda.max_memory_allocated() / 1e9
        t_cg, t_err = sum(cg_times), sum(err_times)
        log(f"P149 {route}: {mesh.num_cells} hex8, {mesh.num_vertices} dofs, f32, CG rel {F32_TOL_P:g}: "
            f"set-up (plans, assembly, right-hand side, Jacobi) {wall - t_cg - t_err:.3f} s, solve {t_cg:.3f} s "
            f"({r.cg_iterations} CG iterations, {t_cg / max(r.cg_iterations, 1) * 1e3:.3f} ms per iteration), "
            f"errors {t_err:.3f} s, wall {wall:.3f} s; L2 error {r.l2_error:.6e}, H1 {r.h1_seminorm_error:.6e}; launches {launches}; peak memory {peak:.2f} GB ({smi})")
        check(bool(torch.isfinite(r.u).all()) and tuple(r.u.shape) == (mesh.num_vertices,),
              f"P149 {route}: wrong or non-finite solution")
        for name in route_kernels[route]:
            check(launches[name] > 0, f"P149 {route}: kernel {name} was not launched")
        solutions[route] = r.u
    # the assembled route's matrix and the matrix-free route's plan, reused for the kernel checks
    bands, offsets = captured["matrix"].bands, captured["matrix"].offsets

    t0 = time.perf_counter()
    residual, b = poisson_f64_operator(mesh, nd, dev)
    b_norm = float(torch.linalg.vector_norm(b))
    for route, u in solutions.items():
        rel = float(torch.linalg.vector_norm(residual(u))) / b_norm
        log(f"P149 {route}: true relative residual |b - A u| / |b| by the plain f64 operator {rel:.6e} "
            f"(limit {10 * F32_TOL_P:g})")
        check(rel <= 10 * F32_TOL_P, f"P149 {route}: true relative residual {rel:.3e} > {10 * F32_TOL_P:g}")
    ua, um = (solutions[k].double() for k in ("assembled", "matrix_free"))
    diff = float(torch.linalg.vector_norm(ua - um) / torch.linalg.vector_norm(ua))
    log(f"P149: relative difference between the two routes' solutions {diff:.6e}; f64 check "
        f"{time.perf_counter() - t0:.3f} s")
    del residual, b, solutions, ua, um
    free_memory()
    scalar_kernel_checks(kernels, bands, offsets, captured["plan"], dev, smi)
    del bands, captured
    free_memory()


def poisson_p40_tet10(kernels, b10, dev, smi):
    """P40-tet10: f32 Poisson with the MMS source on B10's mesh ``b10`` (768,000 tet10 cells, 1,043,441
    dofs at s = 1) after the RCM on the card, assembled (min_fill MMS_MIN_FILL) at CG tolerance F32_TOL_P with the
    band-sweep kernel in every CG iteration: RCM, set-up, solve and error times, D, fill and the
    remainder's share, CG iterations, launches, the true f64 relative residual (limit 10x the CG
    tolerance), then the band sweep at this shape against its plain version and cuSPARSE.  Returns the
    mesh after the RCM and the RCM's seconds."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.fem as fem_mod
    import fenris_tpu_torch.ops.dia_sweep as ds
    import fenris_tpu_torch.sparse.block_dia as bdia
    import fenris_tpu_torch.sparse.cg as cg_mod
    import fenris_tpu_torch.sparse.dia_kernel as dk
    from fenris_tpu_torch.mesh.reorder import reorder_mesh
    from fenris_tpu_torch.sparse.block_dia import BlockDiaMatrix

    source, u_exact, u_exact_grad, dirichlet = mms_problem()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, _ = reorder_mesh(b10, device=dev)
    rcm_s = time.perf_counter() - t0
    nd = dirichlet(mesh)
    rule, err_rule = element_rule(("tetrahedron", 2)), element_rule(("tetrahedron", 6))
    captured, cg_times, err_times = {}, [], []

    def capture(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            captured[name] = args[0] if name == "matrix" else out
            return out
        return run

    k = kernels["dia_sweep (s=1, P40-tet10)"]
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(cg_mod, "conjugate_gradient", timed(cg_mod.conjugate_gradient, cg_times)), \
            mock.patch.object(fem_mod, "_errors", timed(fem_mod._errors, err_times)), \
            mock.patch.object(dk, "block_dia_operator", capture("matrix", dk.block_dia_operator)), \
            mock.patch.object(bdia, "block_dia_assembly_plan", capture("plan", bdia.block_dia_assembly_plan)):
        r = fem_mod.solve_poisson_assembled(mesh, rule, err_rule, source, u_exact, u_exact_grad, nd,
                                            rel_tolerance=F32_TOL_P, min_fill=MMS_MIN_FILL, dtype=torch.float32,
                                            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k["launches"] = k["fn"].launches
    plan, A = captured["plan"], captured["matrix"]
    N, D = mesh.num_vertices, plan.num_diagonals
    on_bands = plan.fill * D * N
    in_rem = float((plan.rem_neighbors < N).sum()) if plan.rem_k else 0.0
    t_cg, t_err = sum(cg_times), sum(err_times)
    log(f"P40-tet10: {mesh.num_cells} tet10, {N} dofs, f32, CG rel {F32_TOL_P:g}: RCM {rcm_s:.3f} s; set-up "
        f"(plan, assembly, right-hand side, Jacobi) {wall - t_cg - t_err:.3f} s, solve {t_cg:.3f} s "
        f"({r.cg_iterations} CG iterations, {t_cg / max(r.cg_iterations, 1) * 1e3:.3f} ms per iteration), errors "
        f"{t_err:.3f} s; D = {D} bands, fill {plan.fill:.4f}, remainder width {plan.rem_k}, remainder share of the "
        f"node pairs {in_rem / (in_rem + on_bands):.4f}; L2 error {r.l2_error:.6e}, H1 {r.h1_seminorm_error:.6e}; "
        f"dia_sweep launches {k['launches']}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    check(bool(torch.isfinite(r.u).all()) and tuple(r.u.shape) == (N,), "P40-tet10: wrong or non-finite solution")
    check(k["launches"] > 0, "P40-tet10: the band-sweep kernel was not launched")
    t0 = time.perf_counter()
    residual, b = poisson_f64_operator(mesh, nd, dev, rule=rule, min_fill=MMS_MIN_FILL)
    rel = float(torch.linalg.vector_norm(residual(r.u))) / float(torch.linalg.vector_norm(b))
    log(f"P40-tet10: true relative residual |b - A u| / |b| by the plain f64 operator {rel:.6e} (limit "
        f"{10 * F32_TOL_P:g}); f64 check {time.perf_counter() - t0:.3f} s")
    check(rel <= 10 * F32_TOL_P, f"P40-tet10: true relative residual {rel:.3e} > {10 * F32_TOL_P:g}")
    del residual, b, r
    free_memory()

    bands, offsets = A.bands, A.offsets
    x2 = torch.randn((1, N), generator=torch.Generator(device=dev).manual_seed(43), device=dev)
    txt = f"P40-tet10 s=1 N={N} D={D}"
    k["max_abs_err"] = compare("dia_sweep", txt, ds.dia_sweep(bands, offsets, x2), ds.dia_sweep(bands, offsets, x2),
                               ds.dia_sweep_plain(bands, offsets, x2))
    k["ms"], k["plain_ms"], ttxt = in_turns(lambda: ds.dia_sweep(bands, offsets, x2),
                                            lambda: ds.dia_sweep_plain(bands, offsets, x2))
    bound_txt = set_bound(k, (bands.numel() + 2 * x2.numel()) * 4, 2 * bands.numel())
    m = BlockDiaMatrix(offsets=offsets, bands=bands, num_nodes=N, solution_dim=1, remainder=None)
    k["library_ms"] = csr_library_ms(m, x2, ds.dia_sweep(bands, offsets, x2), smi)
    log(f"time dia_sweep {txt}: {ttxt}, library {k['library_ms']:.4f} ms; {bound_txt} ({smi})")
    del A, bands, captured, plan
    free_memory()
    return mesh, rcm_s


# -- the element sweeps on tet10 and hex20: M10/M20, S10/S20 -----------------------------------------


def sweep_records(name, material):
    """The kernel records of the fused tangent and vector sweeps on element ``name`` and ``material``."""
    return f"em_vector_tangent_sweep ({name}, {material})", f"em_vector_sweep ({name}, {material})"


def ragged_element_sweeps(dev):
    """The strided sweeps of every element and material on a perturbed res-3 box or square (a ragged last
    tile), u ~ 1e-2 of a cell, v ~ N(0, 1), against their plain versions with bitwise repeats."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.assembly.local import tabulate
    from fenris_tpu_torch.assembly.local_em import (
        assemble_element_elliptic_tangent_vectors_em,
        assemble_element_elliptic_vectors_em,
    )
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import LameParameters, MaterialEllipticOperator

    params = LameParameters(mu=MU, lam=LAM)
    for (d, _, _), name in es.ELEMENTS.items():
        mesh = element_box(name, 3) if d == 3 else square_mesh(name, 3)
        X = FemSpace.create(mesh, d, torch.float32, dev).X_geo
        g = torch.Generator(device=dev).manual_seed(51)
        X = (X + (torch.rand(X.shape, generator=g, device=dev) - 0.5) * 0.02).permute(1, 2, 0)
        tab = tabulate(mesh.element, canonical_stiffness(name))
        E, n = X.shape[-1], tab.dphi.shape[1]
        u = (torch.rand((n, d, E), generator=g, device=dev) - 0.5) * (0.02 / 3)
        v = torch.randn((n, d, E), generator=g, device=dev)
        for material, cls in es.MATERIALS.items():
            op = MaterialEllipticOperator(cls(), dim=d)
            txt = f"ragged {name} {material} E={E}"
            compare("em_vector_sweep", txt, es.em_vector_sweep(X, u, op, params, tab),
                    es.em_vector_sweep(X, u, op, params, tab), assemble_element_elliptic_vectors_em(X, u, op, params, tab))
            compare("em_vector_tangent_sweep", txt, es.em_vector_tangent_sweep(X, u, v, op, params, tab),
                    es.em_vector_tangent_sweep(X, u, v, op, params, tab),
                    assemble_element_elliptic_tangent_vectors_em(X, u, v, op, params, tab))
    free_memory()


def element_sweep_checks(kernels, model, cell, dev, smi):
    """M10/M20/M2D on ``model``'s layout: the gather and scatter at its n nodes a row and s = d, and for each
    material the fused tangent and vector sweeps, against their plain versions (rel <= KERNEL_RTOL,
    bitwise repeats, padding rows zero), timed in turns with them beside their bounds."""
    import torch

    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.solid import MaterialEllipticOperator

    plan, X, tables, tab, params = model._plan, model._X_band, model._em_tables, model.tab, model.params
    N, n, pe, name, d = plan.num_nodes, plan.n, plan.padded_elements, model.mesh.element.name, model.mesh.dim
    shape_txt = f"{cell} {name} E={plan.num_elements} E_pad={pe} blocks={plan.k_blocks}"
    g = torch.Generator(device=dev).manual_seed(31)
    w = torch.randn((N, d), generator=g, device=dev)
    f_el = torch.randn((pe, n, d), generator=g, device=dev)
    u = displacement(model, 32).reshape(N, d)
    v = torch.randn((N, d), generator=g, device=dev)
    padding = ~(plan.valid_rows > 0).reshape(pe, n)[:, 0]
    names = (f"banded_gather (s={d}, {name})", f"banded_scatter (s={d}, {name})")
    for rec, fn, plain, arg in zip(names, (bd.banded_gather, bd.banded_scatter),
                                   (bd.banded_gather_plain, bd.banded_scatter_plain), (w, f_el)):
        kernels[rec]["max_abs_err"] = compare(fn.__name__, shape_txt, fn(plan, arg), fn(plan, arg), plain(plan, arg))
    runs = gather_scatter_runs(plan, w, f_el, dev, names)
    for material, cls in es.MATERIALS.items():
        op = MaterialEllipticOperator(cls(), dim=d)
        for rec, fn, plain, args in zip(sweep_records(name, material),
                                        (es.banded_tangent_sweep, es.banded_vector_sweep),
                                        (es.banded_tangent_sweep_plain, es.banded_vector_sweep_plain),
                                        ((plan, X, u, v), (plan, X, u))):
            run = lambda fn=fn, args=args, op=op: fn(*args, op, params, tab, tables)  # noqa: E731
            run_plain = lambda plain=plain, args=args, op=op: plain(*args, op, params, tab)  # noqa: E731
            got = run()
            kernels[rec]["max_abs_err"] = compare(fn.__name__, f"{shape_txt} {material}", got, run(), run_plain())
            check(not bool(got[padding].any()), f"{fn.__name__} {shape_txt} {material}: a padding row is not zero")
            del got
            runs[rec] = (run, run_plain, None, *em_sweep_cost(plan, tab, op, fn is es.banded_tangent_sweep), 5)
    free_memory()
    time_records(kernels, runs, shape_txt, smi)


def operator_floor(model, fresh, x64):
    """What bounds an f32 inner solve: ``|H32 x - H64 x| / |H64 x|`` for the f32 model's and the f64 model
    ``fresh``'s Hessian actions at ``x64`` on ``x64`` itself (a smooth field)."""
    import torch

    hv64 = fresh.hessian_vector_product(x64, x64)
    hv32 = model.hessian_vector_product(x64.float(), x64.float()).double()
    return float(torch.linalg.vector_norm(hv32 - hv64) / torch.linalg.vector_norm(hv64))


def solve_records(name, material, d, main_path):
    """The records an element solve sets the launches of: the tangent and vector sweeps, and on the main
    path (Neo-Hookean) the gather and scatter too."""
    tangent, vector = sweep_records(name, material)
    records = {"tangent": tangent, "vector": vector}
    if main_path:
        records.update(gather=f"banded_gather (s={d}, {name})", scatter=f"banded_scatter (s={d}, {name})")
    return records


def element_solve(kernels, model, records, cell, setup_s, dev, smi, mixed, check_model=None, max_ratio=1e-1,
                  **solve_kwargs):
    """S10/S20/S2D/PE10: the fused model's ``solve_mixed`` to 1e-10, checked by an independent f64 model
    ``check_model(mesh)`` (``mixed``; default tools/solve_assembled.py's), or its f32 ``solve`` with
    ``solve_kwargs`` (``|F| / |F0| <= max_ratio``; None: M2D's capped step, which only counts launches),
    under reset counts: wall and set-up time, Newton steps, CG
    iterations a step, ms a CG iteration, peak memory and the launches of the kernels of ``records``
    (``{role: record}``, roles tangent, vector, gather, scatter; the records get them); no plain tangent sweep
    may run, and the tangent sweep must carry every CG iteration.  ``solve_mixed`` takes its residuals in f64
    on the plain sweeps, so there the vector sweep's launches are those of one f32 ``model.residual``, which
    must launch it once and no gather."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    name = model.mesh.element.name
    solve_roles = {role: rec for role, rec in records.items() if not (mixed and role == "vector")}
    inner_times, diag_times, history, cg_iters, plain_calls = [], [], [], [], []
    # instance attributes shadow the methods for this solve only
    model._matrix_free_cg = timed(model._matrix_free_cg, inner_times)
    model.hessian_diagonal = timed(model.hessian_diagonal, diag_times)
    plain_tangent = es.banded_tangent_sweep_plain

    def counted_plain(*args, **kwargs):
        plain_calls.append(1)
        return plain_tangent(*args, **kwargs)

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(es, "banded_tangent_sweep_plain", counted_plain):
        if mixed:
            res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30, callback=record,
                                    **solve_kwargs)
        else:
            res = model.solve(cg_rel_tolerance=1e-4, callback=record, **solve_kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {role: kernels[rec]["fn"].launches for role, rec in solve_roles.items()}
    for role, rec in solve_roles.items():
        kernels[rec]["launches"] = launches[role]
    del model._matrix_free_cg, model.hessian_diagonal
    t_inner, t_diag, iters = sum(inner_times), sum(diag_times), max(sum(cg_iters), 1)
    ratio = res.residual_norm / history[0]
    log(f"{cell}: {'solve_mixed' if mixed else 'f32 solve'} {name} dofs={model.space.num_dofs}: "
        f"status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} wall={wall:.3f} s (set-up "
        f"{setup_s:.3f} s before it: RCM, model and banded plan) |F|/|F0|={ratio:.6e}; Jacobi diagonals "
        f"{t_diag:.3f} s, CG {t_inner - t_diag:.3f} s ({(t_inner - t_diag) / iters * 1e3:.3f} ms per iteration), "
        f"residuals and Newton {wall - t_inner:.3f} s; launches {launches}; plain tangent sweeps "
        f"{len(plain_calls)}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    check(bool(torch.isfinite(res.x).all()) and tuple(res.x.shape) == (model.space.num_dofs,),
          f"{cell}: wrong or non-finite displacement")
    check(not plain_calls, f"{cell}: the plain tangent sweep ran {len(plain_calls)} times")
    check(launches["tangent"] >= sum(cg_iters) > 0,
          f"{cell}: {launches['tangent']} tangent sweeps for {sum(cg_iters)} CG iterations")
    check(all(c > 0 for c in launches.values()), f"{cell}: a kernel of the path was not launched: {launches}")
    if not mixed:
        check(max_ratio is None or ratio <= max_ratio, f"{cell}: |F|/|F0| = {ratio:.3e} > {max_ratio}")
        return
    check(res.status == NEWTON_CONVERGED, f"{cell}: status {res.status}")
    x64 = res.x.detach().double()
    del res
    reset_counts(kernels)
    model.residual(x64.float())
    torch.cuda.synchronize()
    vector = kernels[records["vector"]]["fn"].launches
    gathers = kernels[records.get("gather", "banded_gather")]["fn"].launches
    kernels[records["vector"]]["launches"] = vector
    log(f"{cell} one f32 residual: banded_vector_sweep launches {vector}, banded_gather {gathers}")
    check(vector == 1 and gathers == 0, f"{cell}: one residual launched {vector} vector sweeps and {gathers} gathers")
    free_memory()
    t0 = time.perf_counter()
    fresh = (check_model or (lambda mesh: assembled_model(None, torch.float64, dev, 8192, mesh=mesh)))(model.mesh)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    log(f"{cell} independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}); "
        f"{time.perf_counter() - t0:.3f} s")
    check(true_r / r0 <= 1e-10, f"{cell}: independent relative residual {true_r / r0:.3e} > 1e-10")
    log(f"{cell} the f32 Hessian action against the f64 one at the solution, on the solution: rel "
        f"{operator_floor(model, fresh, x64):.3e}")
    del fresh, x64
    free_memory()


def element_sweep_phases(kernels, meshes, dev, smi):
    """The strided sweeps on a ragged box of every element, then M10 and S10 (``solve_mixed``) on B10's
    tet10 mesh after the RCM, M20, S20's ``solve_mixed`` and S20 (the f32 ``solve`` capped at 2 Newton steps)
    on B20's hex20 mesh after the RCM: ``meshes`` is ``{"tet10": (mesh, RCM seconds), "hex20": (mesh before
    the RCM, None)}``.  Then, for the StVK and linear records' launches, one f32 Newton step of each of
    those materials on each mesh; after tet10's, PE10 and ME on its mesh (pe10_phase)."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    t0 = time.perf_counter()
    ragged_element_sweeps(dev)
    log(f"ragged boxes and squares, strided sweeps of {len(es.ELEMENTS)} elements x 3 materials: "
        f"{time.perf_counter() - t0:.3f} s")
    for name, cell in (("tet10", "10"), ("hex20", "20")):
        mesh, rcm_s = meshes[name]
        if rcm_s is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh, _ = reorder_mesh(mesh, device=dev)
            rcm_s = time.perf_counter() - t0
        for material, cls in es.MATERIALS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = assembled_model(None, torch.float32, dev, None, mesh=mesh, material=cls(), banded=True,
                                    fused_kernels=True)
            torch.cuda.synchronize()
            model_s, plan = time.perf_counter() - t0, model._plan
            log(f"{name} {material} model: {mesh.num_cells} cells, {model.space.num_dofs} dofs; RCM {rcm_s:.3f} s "
                f"(card), model with banded plan {model_s:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
                f"window {plan.wa} x 128 nodes)")
            main_path, setup_s = material == "neo_hookean", rcm_s + model_s
            records = solve_records(name, material, 3, main_path)
            if main_path:  # S10 is the solve_mixed; S20 the capped f32 solve, after its solve_mixed
                element_sweep_checks(kernels, model, f"M{cell}", dev, smi)
                element_solve(kernels, model, records, f"S{cell}" if name == "tet10" else f"S{cell}-mixed", setup_s,
                              dev, smi, mixed=True)
            if not (main_path and name == "tet10"):
                element_solve(kernels, model, records, f"S{cell}" if main_path else f"S{cell}-{material}", setup_s,
                              dev, smi, mixed=False, max_newton_iterations=2 if main_path else 1)
            del model
            free_memory()
        if name == "tet10":  # PE10 and ME on the same mesh
            pe10_phase(kernels, mesh, rcm_s, dev, smi)


def two_material_params(mesh, seed=13):
    """PE10's per-element Lame parameters in ``mesh``'s element order: (MU, LAM) x PE10_CONTRAST where the
    element's centroid lies at x > 0.5, else x 1, each times a factor in [0.9, 1.1] from a seeded numpy
    generator (a kernel that read one element's value for all would not pass)."""
    import numpy as np

    from fenris_tpu_torch.solid import LameParameters

    g = np.random.default_rng(seed)
    stiff = np.where(mesh.points[mesh.cells].mean(1)[:, 0] > 0.5, PE10_CONTRAST, 1.0)
    return LameParameters(MU * stiff * g.uniform(0.9, 1.1, mesh.num_cells),
                          LAM * stiff * g.uniform(0.9, 1.1, mesh.num_cells))


def per_element_sweep_checks(kernels, model, params, cell, names, dev, smi):
    """ME on ``model``'s layout: the fused tangent and vector sweeps with per-element ``params`` (in the mesh's
    element order, padded here as the model pads them) against their plain versions (rel <= KERNEL_RTOL,
    bitwise repeats, padding rows zero); an ``[E]`` array of one repeated value bitwise against the scalar
    launch; each timed in turns with its plain version beside its bound (8 bytes an element more), and
    against the scalar launch.  ``names``: the tangent's and the vector sweep's records."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.solid import LameParameters

    plan, X, tables, tab, op = model._plan, model._X_band, model._em_tables, model.tab, model.operator
    d, pe = model.mesh.dim, plan.padded_elements
    index = torch.as_tensor(plan.element_index, device=dev)
    padded = LameParameters(*(torch.as_tensor(x, dtype=torch.float32, device=dev)[index] for x in params))
    repeated = LameParameters(torch.full((pe,), MU, device=dev), torch.full((pe,), LAM, device=dev))
    scalar = LameParameters(MU, LAM)
    shape_txt = f"{cell} {model.mesh.element.name} [E] E={plan.num_elements} E_pad={pe} blocks={plan.k_blocks}"
    g = torch.Generator(device=dev).manual_seed(33)
    u = displacement(model, 34).reshape(-1, d)
    v = torch.randn(u.shape, generator=g, device=dev)
    padding = ~(plan.valid_rows > 0).reshape(pe, plan.n)[:, 0]
    runs = {}
    for rec, fn, plain, args in zip(names, (es.banded_tangent_sweep, es.banded_vector_sweep),
                                    (es.banded_tangent_sweep_plain, es.banded_vector_sweep_plain),
                                    ((plan, X, u, v), (plan, X, u))):
        run = lambda fn=fn, args=args, p=padded: fn(*args, op, p, tab, tables)  # noqa: E731
        got = run()
        kernels[rec]["max_abs_err"] = compare(fn.__name__, shape_txt, got, run(), plain(*args, op, padded, tab))
        check(not bool(got[padding].any()), f"{fn.__name__} {shape_txt}: a padding row is not zero")
        same = bool(torch.equal(fn(*args, op, repeated, tab, tables), fn(*args, op, scalar, tab, tables)))
        log(f"{fn.__name__} {shape_txt}: an [E] array of one repeated value bitwise equal to the scalar launch: "
            f"{same}")
        check(same, f"{fn.__name__} {shape_txt}: a repeated-value [E] launch differs from the scalar launch")
        e_ms, s_ms, txt = in_turns(run, lambda fn=fn, args=args: fn(*args, op, scalar, tab, tables), reps=10,
                                   names=("[E]", "scalar"))
        log(f"time {fn.__name__} {shape_txt}: {txt} ([E] / scalar {e_ms / s_ms:.4f}) ({smi})")
        del got
        runs[rec] = (run, lambda plain=plain, args=args: plain(*args, op, padded, tab), None,
                     *em_sweep_cost(plan, tab, op, fn is es.banded_tangent_sweep, per_element=True), 5)
    free_memory()
    time_records(kernels, runs, shape_txt, smi)


def pe10_phase(kernels, mesh, rcm_s, dev, smi):
    """PE10 on S10's tet10 mesh (after the RCM) and load with two materials (two_material_params): ME's
    checks of the fused sweeps with per-element parameters on its layout, then ``solve_mixed`` to 1e-10 by an
    independent f64 unbanded model holding the parameters in the mesh's own element order (which also checks
    the permutation and padding of the parameters), with the tangent sweep in every CG iteration."""
    import torch

    t0 = time.perf_counter()
    params = two_material_params(mesh)
    torch.cuda.synchronize()
    model = assembled_model(None, torch.float32, dev, None, mesh=mesh, params=params, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    setup_s = rcm_s + time.perf_counter() - t0
    names = ("em_vector_tangent_sweep (tet10, neo_hookean, [E])", "em_vector_sweep (tet10, neo_hookean, [E])")
    per_element_sweep_checks(kernels, model, params, "ME", names, dev, smi)
    element_solve(kernels, model, {"tangent": names[0], "vector": names[1]}, "PE10", setup_s, dev, smi, mixed=True,
                  check_model=lambda m: assembled_model(None, torch.float64, dev, 8192, mesh=m, params=params),
                  cg_max_iter=SLICE_CG_MAX_ITER)
    del model
    free_memory()


def me_hex8_phase(kernels, model, dev, smi):
    """ME on C1's res-149 hex8 layout (``model``, path C's): the fused sweeps with two-material per-element
    parameters (per_element_sweep_checks); then, for their launches, one f32 Newton step of a fused model
    with those parameters on C3's RCM-reordered res-63 box under reset counts (a second res-149 model would
    cost its ~9 s of set-up)."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    names = ("em_vector_tangent_sweep (hex8, [E])", "em_vector_sweep (hex8, [E])")
    per_element_sweep_checks(kernels, model, two_material_params(model.mesh), "ME", names, dev, smi)
    mesh, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(RES_C3), device=dev)
    t0 = time.perf_counter()
    small = assembled_model(None, torch.float32, dev, None, mesh=mesh, params=two_material_params(mesh), banded=True,
                            fused_kernels=True)
    torch.cuda.synchronize()
    element_solve(kernels, small, {"tangent": names[0], "vector": names[1]}, f"ME res={RES_C3}",
                  time.perf_counter() - t0, dev, smi, mixed=False, max_newton_iterations=1)
    del small
    free_memory()


def model_2d(mesh, dtype, device, chunk_size=None, **kwargs):
    """S2D's model: tools/solve_assembled.py's problem in 2D (Neo-Hookean unless ``material`` is given, the
    nodes at x = 0 clamped, body force BODY_2D)."""
    import numpy as np

    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    return HyperelasticModel(mesh=mesh, material=kwargs.pop("material", None) or NeoHookeanMaterial(),
                             params=LameParameters(mu=MU, lam=LAM), dirichlet_nodes=np.flatnonzero(mesh.points[:, 0] < 1e-12),
                             body_force=np.array(BODY_2D), dtype=dtype, device=device, chunk_size=chunk_size, **kwargs)


def element_2d_phases(kernels, p2d_meshes, dev, smi):
    """M2D on B2's meshes (``p2d_meshes``: P2D's quad9 and tri6 after the RCM, with its seconds) after the RCM
    on the card: the s = 2 gather and scatter and each material's fused sweeps against their plain versions,
    timed (element_sweep_checks), and, for their launches, one f32 Newton step of each material's fused
    model (two for Neo-Hookean, each CG capped at 200 iterations: these steps count launches); then S2D and
    its diagnostic at res 512 (s2d_stall)."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    for name, res in B2_MESHES.items():
        if name in p2d_meshes:
            mesh, rcm_s = p2d_meshes[name]
        else:
            mesh = square_mesh(name, res)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh, _ = reorder_mesh(mesh, device=dev)
            rcm_s = time.perf_counter() - t0
        for material, cls in es.MATERIALS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = model_2d(mesh, torch.float32, dev, material=cls(), banded=True, fused_kernels=True)
            torch.cuda.synchronize()
            model_s, plan = time.perf_counter() - t0, model._plan
            log(f"M2D {name} {material} model: {mesh.num_cells} cells, {model.space.num_dofs} dofs; RCM {rcm_s:.3f} s "
                f"(card), model with banded plan {model_s:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
                f"window {plan.wa} x 128 nodes)")
            main_path = material == "neo_hookean"
            if main_path:
                element_sweep_checks(kernels, model, "M2D", dev, smi)
            element_solve(kernels, model, solve_records(name, material, 2, main_path), f"M2D-{name}-{material}",
                          rcm_s + model_s, dev, smi, mixed=False, max_ratio=None,
                          max_newton_iterations=2 if main_path else 1, cg_max_iter=200)
            del model
            free_memory()
    s2d_phase(kernels, dev, smi)
    s2d_stall(p2d_meshes["quad9"][0] if "quad9" in p2d_meshes else None, dev, smi)


def s2d_stall(mesh, dev, smi, steps=2):
    """Why S2D runs at res 128: two Newton steps of its ``solve_mixed`` at res 512 (P2D's quad9 mesh after the
    RCM, 2,101,250 dofs), each step's contraction of the f64 residual logged (an f32 inner solve contracts it
    by ~kappa eps_f32, kappa growing as res^2), then the f32 Hessian action against the f64 one on the last
    iterate (a smooth field).  A diagnostic: nothing is required to converge."""
    import torch

    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    if mesh is None:
        mesh, _ = reorder_mesh(square_mesh("quad9", 512), device=dev)
    model = model_2d(mesh, torch.float32, dev, banded=True, fused_kernels=True)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, max_newton_iterations=steps, cg_max_iter=SLICE_CG_MAX_ITER,
                            callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x64 = res.x.detach().double()
    fresh = model_2d(mesh, torch.float64, dev, 8192)
    floor = operator_floor(model, fresh, x64)
    ratios = [f"{b / a:.4f}" for a, b in zip(history, history[1:])]
    log(f"S2D at res 512 (quad9, {model.space.num_dofs} dofs): {steps} Newton steps of solve_mixed, CG iterations "
        f"{cg_iters}, |F| {[f'{h:.4e}' for h in history]}, contraction a step {ratios}, wall {wall:.3f} s; the f32 "
        f"Hessian action against the f64 one on the last iterate: rel {floor:.3e} ({smi})")
    del model, fresh, x64
    free_memory()


def s2d_phase(kernels, dev, smi, res=RES_S2D):
    """S2D: ``solve_mixed`` of the 2D problem (model_2d) on quad9 and tri6 at ``res`` after the RCM on the
    card, to 1e-10 by an independent f64 unbanded model, with the tangent sweep in every CG iteration and no
    plain tangent sweep (element_solve; launches are logged and checked, M2D's records keep theirs)."""
    import torch

    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    for name in ("quad9", "tri6"):
        t0 = time.perf_counter()
        mesh, _ = reorder_mesh(square_mesh(name, res), device=dev)
        model = model_2d(mesh, torch.float32, dev, banded=True, fused_kernels=True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        records = solve_records(name, "neo_hookean", 2, True)
        saved = {rec: kernels[rec].get("launches") for rec in records.values()}
        element_solve(kernels, model, records, f"S2D {name} res={res}", setup_s, dev, smi, mixed=True,
                      check_model=lambda m: model_2d(m, torch.float64, dev, 8192), cg_max_iter=SLICE_CG_MAX_ITER)
        for rec, launches in saved.items():
            kernels[rec]["launches"] = launches
        del model
        free_memory()


def vcycle_profile(mg, model, wall_s, dev, smi):
    """One V-cycle under torch.profiler: kernels launched and device-busy time against the solve's mean
    V-cycle wall (the launch-bound share is the idle rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    r = torch.randn(model.space.num_dofs, generator=torch.Generator(device=dev).manual_seed(51), device=dev)
    r = torch.where(model.free_mask, r, 0.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mg(r)
        torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            busy_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
            launches += e.count
    check(busy_us > 0 and launches > 0, "C2-MG V-cycle profile: torch.profiler recorded no device time")
    per_level = []
    for lvl in range(len(mg.levels_data)):
        v = torch.zeros(model.space.num_dofs if lvl == 0 else mg.levels_data[lvl]["free"].numel(), device=dev)
        per_level.append(event_ms(lambda: mg._apply(lvl, v), reps=3, warmup=1))
    log(f"C2-MG V-cycle profile: {launches} device operations, device busy {busy_us / 1e3:.3f} ms of the "
        f"solve's mean V-cycle wall {wall_s * 1e3:.3f} ms ({busy_us / 1e3 / (wall_s * 1e3) * 100:.1f}% busy); "
        f"one level operator application, finest to coarsest: {[f'{t:.3f}' for t in per_level]} ms ({smi})")


def path_c2_mg(kernels, c2_cg_iters, dev, smi):
    """C2-MG: path C2's problem on 18^3 refined three times (2,985,984 hex8 cells, 9,145,875 dofs),
    RCM-reordered on the card, solve_mixed with the banded geometric multigrid; CG iterations beside C2's
    Jacobi counts, the operator and V-cycle shares of a CG iteration, and the independent f64 residual."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.mesh.refinement as refinement
    import fenris_tpu_torch.mesh.reorder as reorder
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.multigrid import GeometricMGPreconditioner, rcm_refined_hierarchy
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    coarse = create_unit_box_uniform_hex_mesh_3d(RES_MG_COARSE)
    t_refine, t_rcm = [], []
    torch.cuda.synchronize()
    with mock.patch.object(refinement, "refine_uniformly_repeat", timed(refinement.refine_uniformly_repeat, t_refine)), \
            mock.patch.object(reorder, "reorder_mesh", timed(reorder.reorder_mesh, t_rcm)):
        fine, perm = rcm_refined_hierarchy(coarse, MG_LEVELS, device=dev)
    t0 = time.perf_counter()
    model = assembled_model(0, torch.float32, dev, None, mesh=fine, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = GeometricMGPreconditioner(model, coarse, MG_LEVELS, fine_permutation=perm, banded=True)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    levels = [(L["num_vertices"], L["model"].mesh.num_cells) for L in mg.levels_data]
    log(f"C2-MG: coarse res {RES_MG_COARSE} refined {MG_LEVELS} times: {fine.num_cells} hex8, "
        f"{model.space.num_dofs} dofs; refinement {t_refine[0]:.3f} s, RCM of the finest mesh on the card "
        f"{t_rcm[0]:.3f} s (limit 20 s), fused model {t_model:.3f} s, MG set-up (refinement again, intermediate "
        f"RCMs, level models, Jacobi diagonals) {t_mg:.3f} s; levels (nodes, cells) {levels} ({smi})")
    check(t_rcm[0] < 20.0, f"C2-MG: RCM of the 144^3 mesh took {t_rcm[0]:.1f} s (limit 20 s)")

    inner_times, vcycle_times = [], []
    model._matrix_free_cg = timed(model._matrix_free_cg, inner_times)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status} inner={inner_times[-1]:.3f} s"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    path = ("banded_gather", "banded_scatter", "em_vector_tangent_sweep")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30,
                            preconditioner=timed(mg, vcycle_times), callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels[name]["fn"].launches for name in path}
    del model._matrix_free_cg
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_inner, t_vc, iters = sum(inner_times), sum(vcycle_times), max(sum(cg_iters), 1)
    log(f"C2-MG: status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} (C2 with Jacobi on "
        f"10,125,000 dofs in this run: {c2_cg_iters}) wall={wall:.3f} s |F|/|F0|={res.residual_norm / history[0]:.6e} "
        f"launches={launches} peak memory {peak:.2f} GB ({smi})")
    log(f"C2-MG breakdown: CG {t_inner:.3f} s, {t_inner / iters * 1e3:.3f} ms per iteration: V-cycles "
        f"{t_vc:.3f} s ({t_vc / iters * 1e3:.3f} ms each), the fused operator and vector updates "
        f"{(t_inner - t_vc) / iters * 1e3:.3f} ms; f64 residuals and Newton {wall - t_inner:.3f} s of {wall:.3f} s")
    check(res.status == NEWTON_CONVERGED, f"C2-MG: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "C2-MG: non-finite displacement")
    for name in path:
        check(launches[name] > 0, f"C2-MG: kernel {name} was not launched")
    check(launches["em_vector_tangent_sweep"] >= sum(cg_iters),
          f"C2-MG: {launches['em_vector_tangent_sweep']} tangent sweeps for {sum(cg_iters)} CG iterations")

    vcycle_profile(mg, model, t_vc / max(len(vcycle_times), 1), dev, smi)

    x64 = res.x.detach().double()
    del res, mg
    free_memory()
    t0 = time.perf_counter()
    fresh = assembled_model(0, torch.float64, dev, 8192, mesh=fine)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    log(f"C2-MG independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}); "
        f"{time.perf_counter() - t0:.3f} s")
    check(true_r / r0 <= 1e-10, f"C2-MG: independent relative residual {true_r / r0:.3e} > 1e-10")
    del fresh, x64, model
    free_memory()


# -- entry B: element stiffness ----------------------------------------------------------


def stiffness_accuracy(sp, X, op, params, tab, got, ref):
    """The kernel, its plain version and the plain version on node-relative coordinates (J formed
    from X - X[:, :1], which is J exactly, with fewer rounding errors) against an f64 evaluation of
    the same f32 coordinates: max |x - f64| / max |f64|."""
    import torch

    ref64 = sp.stiffness_pairs_plain(X.double(), op, params, tab)
    scale = float(ref64.abs().max())
    rel = lambda a: float((a.double() - ref64).abs().max()) / scale  # noqa: E731
    k_rel, p_rel = rel(got), rel(ref)
    rel_x = sp.stiffness_pairs_plain(X - X[:, :1], op, params, tab)
    r_rel, r_vs_p = rel(rel_x), float((rel_x.double() - ref.double()).abs().max()) / float(ref.double().abs().max())
    del ref64, rel_x
    torch.cuda.synchronize()
    log(f"stiffness_pairs linear res={RES_B} against f64 on the same f32 coordinates: kernel {k_rel:.3e}, plain "
        f"{p_rel:.3e}, plain on node-relative coordinates {r_rel:.3e} (that one against the plain version "
        f"{r_vs_p:.3e}; the kernel forms J as the plain version does)")


def stiffness_launch(sp, X, op, params, tab):
    """``run(ld)``: one launch of the stiffness kernel straight through the library (not counted as a
    launch) with its tables built once, into output rows ``ld`` floats apart; and the wrapper's row
    stride.  Its time is the kernel's without the wrapper's host work."""
    import numpy as np
    import torch

    from fenris_tpu_torch.ops._build import load_library

    tables, C, meta = sp._constants(op, params, tab)
    tables_d = torch.as_tensor(tables, dtype=torch.float32, device=X.device)
    cf = np.ascontiguousarray(C, dtype=np.float32)
    E, lib = X.shape[0], load_library()
    padded = -(-E // 32) * 32
    out = torch.empty(meta["s"] ** 2 * meta["n"] ** 2 * padded, device=X.device)

    def run(ld):
        code = lib.fenris_stiffness_pairs(X.data_ptr(), tables_d.data_ptr(), cf.ctypes.data, out.data_ptr(), E, ld,
                                          meta["m"], meta["n"], meta["q"], meta["d"], meta["s"], meta["sym"],
                                          torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"stiffness_pairs: CUDA error {code}")

    return run, padded


def stiffness_row_padding(sp, X, op, params, tab, smi):
    """The kernel with its output rows E floats apart (E odd at res 99: each warp's 128-byte store run
    straddles two lines) against rows a multiple of 32 floats apart, as the wrapper lays them out; in
    turns, one launch each, straight through the library (not counted as launches)."""
    run, padded = stiffness_launch(sp, X, op, params, tab)
    E = X.shape[0]
    _, _, txt = in_turns(lambda: run(padded), lambda: run(E), reps=10,
                         names=(f"rows {padded} floats apart", f"rows {E} floats apart"))
    log(f"stiffness_pairs linear res={RES_B} output row stride: {txt} ({smi})")


def stiffness_phases(kernels, dev, smi):
    import numpy as np
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.mesh import Mesh
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.reference_elements import HEX8
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    k = kernels["stiffness_pairs"]
    tab = tabulate(HEX8, canonical_stiffness("hex8"))
    cases = {
        "linear": (MaterialEllipticOperator(LinearElasticMaterial(), dim=3), LameParameters(mu=MU, lam=LAM)),
        "laplace": (LaplaceOperator(), None),
    }
    ragged = create_unit_box_uniform_hex_mesh_3d(RAGGED_B)
    pts = ragged.points + np.random.default_rng(0).uniform(-0.2, 0.2, ragged.points.shape) / RAGGED_B
    Xr = FemSpace.create(Mesh(pts, ragged.cells, HEX8), 3, torch.float32, dev).X_geo
    for name, (op, params) in cases.items():
        compare("stiffness_pairs", f"{name} E={Xr.shape[0]} (perturbed)", sp.stiffness_pairs(Xr, op, params, tab),
                sp.stiffness_pairs(Xr, op, params, tab), sp.stiffness_pairs_plain(Xr, op, params, tab))
    X = FemSpace.create(create_unit_box_uniform_hex_mesh_3d(RES_B), 3, torch.float32, dev).X_geo
    E = X.shape[0]
    q, m = tab.num_points, X.shape[1]
    for name, (op, params) in cases.items():
        got = sp.stiffness_pairs(X, op, params, tab)
        again = sp.stiffness_pairs(X, op, params, tab)
        ref = sp.stiffness_pairs_plain(X, op, params, tab)
        err = compare("stiffness_pairs", f"{name} res={RES_B} E={E} out {got.numel() * 4 / 1e9:.3f} GB", got, again, ref)
        del again
        if name == "linear":
            stiffness_accuracy(sp, X, op, params, tab, got, ref)
        del got, ref
        free_memory()
        ms, plain_ms, txt = in_turns(
            lambda: sp.stiffness_pairs(X, op, params, tab), lambda: sp.stiffness_pairs_plain(X, op, params, tab), reps=5,
            plain_reps=2,
        )
        # X read and the pairs written once; the fewest operations (stiffness_ops)
        s = op.solution_dim
        rec = {}
        bound_txt = set_bound(rec, (X.numel() + s * s * 64 * E) * 4, stiffness_ops(E, m, 8, q, s, op.symmetric, 3))
        log(f"time stiffness_pairs {name} res={RES_B}: {txt}; {E / (ms * 1e-3) / 1e6:.1f} M elements/s; "
            f"{bound_txt}, {rec['bound_ms'] / ms * 100:.1f}% of it ({smi})")
        if name == "linear":
            k.update(rec, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
            stiffness_row_padding(sp, X, op, params, tab, smi)
        free_memory()
    log(f"stiffness_pairs shared memory a block: {sp._smem_bytes(m, 8, q, 3)} bytes (hex8)")

    # entry B: the public element-stiffness entry point with kernel="auto"
    op, params = cases["linear"]
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k["launches"] = k["fn"].launches
    log(f"entry B: assemble_element_elliptic_matrices_pairs(kernel='auto') res={RES_B}: {tuple(A.shape)} in "
        f"{wall * 1e3:.3f} ms, stiffness_pairs launches={k['launches']} ({smi})")
    check(tuple(A.shape) == (9, 64, E) and bool(torch.isfinite(A).all()), "entry B: wrong or non-finite output")
    check(k["launches"] > 0, "entry B: the stiffness kernel was not launched")
    del A, X
    free_memory()


def stiffness_element_phases(kernels, dev, smi):
    """Entry B20/B10: the stiffness kernel on hex20 (points in chunks) and tet10 at full width, linear
    elasticity and Laplace: against its plain version (rel <= KERNEL_RTOL, bitwise repeats), timed in
    turns with it, bound and M elements/s; the public entry point with kernel="auto" under reset counts;
    then the kernel and its plain version at bench.py's own sizes.  Returns B20's and B10's meshes by element
    name (P40-tet10 and the element-sweep phases reuse them)."""
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    cases = {
        "linear": (MaterialEllipticOperator(LinearElasticMaterial(), dim=3), LameParameters(mu=MU, lam=LAM)),
        "laplace": (LaplaceOperator(), None),
    }
    meshes = {}
    for name, res, cell, key in (("hex20", RES_B20, "B20", "stiffness_pairs (hex20, B20)"),
                                 ("tet10", RES_B10, "B10", "stiffness_pairs (tet10, B10)")):
        t0 = time.perf_counter()
        mesh = meshes[cell] = element_box(name, res)
        mesh_s = time.perf_counter() - t0
        tab = tabulate(mesh.element, canonical_stiffness(name))
        q, m, _ = tab.geo_dphi.shape
        n = tab.dphi.shape[1]
        k = kernels[key]
        X = FemSpace.create(mesh, 3, torch.float32, dev).X_geo
        E = X.shape[0]
        log(f"entry {cell}: {name} res {res}: {E} cells, {mesh.num_vertices} nodes, mesh {mesh_s:.3f} s; kernel "
            f"points a chunk {sp._chunk_points(m, n, q, 3)} of {q}, shared memory a block {sp._smem_bytes(m, n, q, 3)} "
            f"bytes")
        for kind, (op, params) in cases.items():
            s = op.solution_dim
            got = sp.stiffness_pairs(X, op, params, tab)
            again = sp.stiffness_pairs(X, op, params, tab)
            ref = sp.stiffness_pairs_plain(X, op, params, tab)
            err = compare("stiffness_pairs", f"{name} {kind} {cell} E={E} out {got.numel() * 4 / 1e9:.3f} GB", got,
                          again, ref)
            del got, again, ref
            free_memory()
            ms, plain_ms, txt = in_turns(lambda: sp.stiffness_pairs(X, op, params, tab),
                                         lambda: sp.stiffness_pairs_plain(X, op, params, tab), reps=5, plain_reps=2)
            rec = {}
            bound_txt = set_bound(rec, (X.numel() + s * s * n * n * E) * 4, stiffness_ops(E, m, n, q, s, op.symmetric, 3))
            log(f"time stiffness_pairs {name} {kind} {cell}: {txt}; {E / (ms * 1e-3) / 1e6:.2f} M elements/s; "
                f"{bound_txt}, {rec['bound_ms'] / ms * 100:.1f}% of it ({smi})")
            if kind == "linear":
                k.update(rec, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
            free_memory()

        op, params = cases["linear"]
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k["launches"] = k["fn"].launches
        log(f"entry {cell}: assemble_element_elliptic_matrices_pairs(kernel='auto') {name}: {tuple(A.shape)} in "
            f"{wall * 1e3:.3f} ms, stiffness_pairs launches={k['launches']} ({smi})")
        check(tuple(A.shape) == (9, n * n, E) and bool(torch.isfinite(A).all()), f"entry {cell}: wrong or non-finite output")
        check(k["launches"] > 0, f"entry {cell}: the stiffness kernel was not launched")
        del A, X
        free_memory()

        # bench.py's own size of this element
        mesh = element_box(name, RES_BENCH[name])
        Xb = FemSpace.create(mesh, 3, torch.float32, dev).X_geo
        Eb = Xb.shape[0]
        compare("stiffness_pairs", f"{name} linear bench size E={Eb}", sp.stiffness_pairs(Xb, op, params, tab),
                sp.stiffness_pairs(Xb, op, params, tab), sp.stiffness_pairs_plain(Xb, op, params, tab))
        ms, _, txt = in_turns(lambda: sp.stiffness_pairs(Xb, op, params, tab),
                              lambda: sp.stiffness_pairs_plain(Xb, op, params, tab), reps=10, plain_reps=3)
        rec = {}
        bound_txt = set_bound(rec, (Xb.numel() + 9 * n * n * Eb) * 4, stiffness_ops(Eb, m, n, q, 3, True, 3))
        log(f"time stiffness_pairs {name} linear bench size ({Eb} cells): {txt}; {Eb / (ms * 1e-3) / 1e6:.2f} M "
            f"elements/s; {bound_txt}, {rec['bound_ms'] / ms * 100:.1f}% of it ({smi})")
        del Xb
        free_memory()
    return {"hex20": meshes["B20"], "tet10": meshes["B10"]}


# -- the 2D slice: B2, MMS2D, P2D ----------------------------------------------------------------


def square_mesh(name, res):
    """The unit square of ``name`` cells: quad4 or tri3 (each quad split in two), converted
    (convert_mesh) for quad8, quad9 and tri6."""
    from fenris_tpu_torch.mesh.convert import convert_mesh
    from fenris_tpu_torch.mesh.procedural import (
        create_unit_square_uniform_quad_mesh_2d,
        create_unit_square_uniform_tri_mesh_2d,
    )

    base = (create_unit_square_uniform_tri_mesh_2d if name.startswith("tri") else
            create_unit_square_uniform_quad_mesh_2d)(res)
    return base if name in ("tri3", "quad4") else convert_mesh(base, name)


def mms_problem_2d():
    """The 2D MMS problem of tests/mms_common.py:17-30 in torch: source, exact solution, its gradient."""
    import numpy as np
    import torch

    def u_exact(x):
        return torch.sin(np.pi * x[0]) * torch.sin(np.pi * x[1])

    def u_exact_grad(x):
        return np.pi * torch.stack([torch.cos(np.pi * x[0]) * torch.sin(np.pi * x[1]),
                                    torch.sin(np.pi * x[0]) * torch.cos(np.pi * x[1])])

    def source(x, p):
        return 2.0 * np.pi**2 * u_exact(x)

    return source, u_exact, u_exact_grad


def poisson_routes():
    """The three Poisson routes by name: the CSR route (the JAX package's ``solve_poisson``) and the two others."""
    from fenris_tpu_torch import fem

    return {"csr": fem.solve_poisson, **poisson_solvers()}


def stiffness_2d_phases(kernels, found, dev, smi):
    """B2: the stiffness kernel at d = 2 on the unit square at full width (B2_MESHES), Laplace (s = 1)
    and 2D linear elasticity (s = 2): ptxas lines of the d = 2 instantiations (a spill fails the run),
    each element's table in one chunk, kernel against plain (rel <= KERNEL_RTOL, bitwise repeats), times in
    turns beside the bound with M elements/s, and the public entry point with kernel="auto" under reset
    counts (its launches go to the record)."""
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    d2 = {n: t for n, t in found.items() if n.startswith("stiffness_pairs (d = 2,")}
    for name, txt in d2.items():
        log(f"B2 ptxas {name}: {txt}")
    check(any(", 1 pairs," in n for n in d2) and any(", 3 pairs," in n for n in d2),
          f"B2: ptxas reports no d = 2 instantiation for 1 or 3 pairs: {list(d2)}")
    check(all("0 bytes spill stores, 0 bytes spill loads" in t for t in d2.values()), f"B2: spills in {d2}")
    cases = {
        "linear": (MaterialEllipticOperator(LinearElasticMaterial(), dim=2), LameParameters(mu=MU, lam=LAM)),
        "laplace": (LaplaceOperator(), None),
    }
    for name, res in B2_MESHES.items():
        t0 = time.perf_counter()
        mesh = square_mesh(name, res)
        mesh_s = time.perf_counter() - t0
        tab = tabulate(mesh.element, canonical_stiffness(name))
        q, m, _ = tab.geo_dphi.shape
        n = tab.dphi.shape[1]
        X = FemSpace.create(mesh, 1, torch.float32, dev).X_geo
        E = X.shape[0]
        qc = sp._chunk_points(m, n, q, 2)
        log(f"entry B2: {name} res {res}: {E} cells, {mesh.num_vertices} nodes, mesh {mesh_s:.3f} s; {q} points, "
            f"points a chunk {qc}, shared memory a block {sp._smem_bytes(m, n, q, 2)} bytes")
        check(qc == q, f"B2 {name}: the gradient table must fit one block (points a chunk {qc} of {q})")
        for kind, (op, params) in cases.items():
            s = op.solution_dim
            k = kernels[f"stiffness_pairs ({name} {kind}, B2)"]
            got = sp.stiffness_pairs(X, op, params, tab)
            again = sp.stiffness_pairs(X, op, params, tab)
            ref = sp.stiffness_pairs_plain(X, op, params, tab)
            k["max_abs_err"] = compare("stiffness_pairs", f"{name} {kind} B2 E={E} out {got.numel() * 4 / 1e9:.3f} GB",
                                       got, again, ref)
            del got, again, ref
            free_memory()
            k["ms"], k["plain_ms"], txt = in_turns(lambda: sp.stiffness_pairs(X, op, params, tab),
                                                   lambda: sp.stiffness_pairs_plain(X, op, params, tab), reps=5,
                                                   plain_reps=2)
            k["library_ms"] = None
            run, padded = stiffness_launch(sp, X, op, params, tab)
            alone = min(event_ms(lambda: run(padded), reps=10), event_ms(lambda: run(padded), reps=10))
            bound_txt = set_bound(k, (X.numel() + s * s * n * n * E) * 4, stiffness_ops(E, m, n, q, s, op.symmetric, 2))
            log(f"time stiffness_pairs {name} {kind} B2: {txt}; {E / (k['ms'] * 1e-3) / 1e6:.1f} M elements/s; "
                f"{bound_txt}, {k['bound_ms'] / k['ms'] * 100:.1f}% of it; the launch alone (tables built once, "
                f"straight through the library) {alone:.4f} ms, {k['bound_ms'] / alone * 100:.1f}% of the bound ({smi})")
            del run
            free_memory()
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k["launches"] = k["fn"].launches
            log(f"entry B2: assemble_element_elliptic_matrices_pairs(kernel='auto') {name} {kind}: {tuple(A.shape)} "
                f"in {wall * 1e3:.3f} ms, stiffness_pairs launches={k['launches']} ({smi})")
            check(tuple(A.shape) == (s * s, n * n, E) and bool(torch.isfinite(A).all()),
                  f"entry B2 {name} {kind}: wrong or non-finite output")
            check(k["launches"] > 0, f"entry B2 {name} {kind}: the stiffness kernel was not launched")
            del A
            free_memory()
        del X
        free_memory()


def poisson2d_mms_gate(dev, smi):
    """MMS2D: the reference's 2D gates (tests/test_convergence.py:28-78) at their full resolutions 1-32
    on the card, on the three routes: f64 within 1% of tests/reference_values/
    poisson2d_mms_<element>_summary.json (resolutions to 1e-12); f32 at CG tolerance F32_TOL_MMS with its
    deviations printed.  The assembled route takes min_fill MMS_MIN_FILL (the converted meshes' sparse
    deltas go to the block-ELL remainder)."""
    import torch

    source, u_exact, u_exact_grad = mms_problem_2d()
    dirichlet = mms_problem()[3]
    for name, (rule, err_rule) in MMS_2D.items():
        ref = json.loads((ROOT / f"tests/reference_values/poisson2d_mms_{name}_summary.json").read_text())
        meshes = [square_mesh(name, res) for res in MMS_RESOLUTIONS]
        for dtype, tol in ((torch.float64, 1e-9), (torch.float32, F32_TOL_MMS)):
            for route, solve in poisson_routes().items():
                kw = dict(min_fill=MMS_MIN_FILL) if route == "assembled" else {}
                t0 = time.perf_counter()
                diam, dev_l2, dev_h1, iters = [], [], [], []
                for i, mesh in enumerate(meshes):
                    r = solve(mesh, element_rule(rule), element_rule(err_rule), source, u_exact, u_exact_grad,
                              dirichlet(mesh), rel_tolerance=tol, dtype=dtype, device=dev, **kw)
                    diam.append(float(mesh.diameters().max()))
                    dev_l2.append(abs(r.l2_error - ref["L2_errors"][i]) / ref["L2_errors"][i])
                    dev_h1.append(abs(r.h1_seminorm_error - ref["H1_seminorm_errors"][i]) / ref["H1_seminorm_errors"][i])
                    iters.append(r.cg_iterations)
                torch.cuda.synchronize()
                res_dev = max(abs(a - b) / b for a, b in zip(diam, ref["resolutions"]))
                log(f"Poisson MMS {name} {route} {str(dtype).removeprefix('torch.')} (CG rel {tol:g}) at resolutions "
                    f"{list(MMS_RESOLUTIONS)} ({meshes[-1].num_vertices} dofs at the last): L2 deviation from the "
                    f"reference {[f'{d:.3e}' for d in dev_l2]}, H1 {[f'{d:.3e}' for d in dev_h1]}, diameters rel "
                    f"{res_dev:.1e}, CG iterations {iters}; {time.perf_counter() - t0:.3f} s ({smi})")
                check(len(diam) == len(ref["resolutions"]) and res_dev <= 1e-12,
                      f"Poisson MMS {name} {route}: resolutions differ from the reference")
                if dtype == torch.float64:
                    check(max(dev_l2 + dev_h1) <= 0.01, f"Poisson MMS {name} {route} f64: an error is off the "
                          f"reference by more than 1%: L2 {dev_l2}, H1 {dev_h1}")
    free_memory()


def csr_spmv_record(A, dev, smi, cell):
    """The CSR product of the CSR route's matrix ``A`` (f32, on the card): ten products bitwise equal to
    the first, its time and GB/s (values and column indices of every stored entry, the row pointers, x
    and y once each, over its time).  Logged, not a kernel record: the JAX package has no TPU kernel
    for it."""
    import torch

    x = torch.randn(A.shape[1], generator=torch.Generator(device=dev).manual_seed(47), device=dev)
    y = A @ x
    same = all(bool(torch.equal(y, A @ x)) for _ in range(10))
    sp = A.sparse
    nbytes = (A.nnz * (A.values.element_size() + sp.col_indices().element_size())
              + sp.crow_indices().numel() * sp.crow_indices().element_size() + (A.shape[0] + A.shape[1]) * 4)
    ms = min(event_ms(lambda: A @ x, reps=20), event_ms(lambda: A @ x, reps=20))
    log(f"{cell} CSR product (torch.sparse_csr_tensor, cuSPARSE): {A.shape[0]} rows, nnz {A.nnz}, "
        f"{str(sp.col_indices().dtype).removeprefix('torch.')} indices; ten products bitwise equal to the first: "
        f"{same}; {ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s ({nbytes / 1e9:.4f} GB; bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s, {nbytes / HBM_BYTES_PER_S * 1e3 / ms * 100:.1f}% of "
        f"it) ({smi})")
    check(same, f"{cell}: two CSR products on one input differ")
    check(bool(torch.isfinite(y).all()), f"{cell}: non-finite CSR product")


def poisson_p2d(kernels, dev, smi):
    """P2D: the 2D MMS problem in f32 on quad9 and tri6 at res 512 (1,050,625 dofs), RCM-reordered on the
    card, on the three routes at CG tolerance F32_TOL_P2D.  First the plain f64 operator and two f32 floors
    of the true relative residual |b - A u| / |b|: the rounding of the exact solution's nodal values to f32
    through A (P149's floor; F32_TOL_P2D must not be below it), and, after each route's solve, the rounding
    of that route's own f32 operator (its CG operator against the f64 one on those f32 values, free dofs).
    Per route: set-up (the CSR pattern built on the card and the CSR assembly, or the plans), solve and
    error times, CG iterations and ms per iteration, launches, and the true f64 relative residual, limit
    10x the larger of the CG tolerance and the route's operator floor; the routes' differences; then the
    CSR product's GB/s and the s = 1 band sweep, gather and scatter at these shapes (their records join
    the kernel line).  Returns the meshes after the RCM with its seconds."""
    from unittest import mock

    import numpy as np
    import torch

    import fenris_tpu_torch.assembly.global_ as G
    import fenris_tpu_torch.fem as fem_mod
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.sparse.block_dia as bdia
    import fenris_tpu_torch.sparse.cg as cg_mod
    import fenris_tpu_torch.sparse.dia_kernel as dk
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    source, u_exact, u_exact_grad = mms_problem_2d()
    dirichlet = mms_problem()[3]
    meshes = {}  # kept for M2D: {name: (mesh after the RCM, RCM seconds)}
    for name, (res, rule, err_rule) in P2D_MESHES.items():
        cell = f"P2D {name}"
        route_kernels = {"csr": (), "assembled": (f"dia_sweep (s=1, {cell})",),
                         "matrix_free": (f"banded_gather (s=1, {cell})", f"banded_scatter (s=1, {cell})")}
        t0 = time.perf_counter()
        mesh = square_mesh(name, res)
        mesh_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh, _ = reorder_mesh(mesh, device=dev)
        rcm_s = time.perf_counter() - t0
        nd = dirichlet(mesh)
        t0 = time.perf_counter()
        residual, b = poisson_f64_operator(mesh, nd, dev, rule=element_rule(rule), min_fill=MMS_MIN_FILL,
                                           source=source)
        b_norm = float(torch.linalg.vector_norm(b))
        free = torch.ones(mesh.num_vertices, dtype=torch.bool, device=dev)
        free[torch.as_tensor(nd, device=dev)] = False
        x = torch.as_tensor(mesh.points, device=dev)
        u_nodal = torch.sin(np.pi * x[:, 0]) * torch.sin(np.pi * x[:, 1])
        u32 = u_nodal.float()
        floor_u = float(torch.linalg.vector_norm(residual(u32) - residual(u_nodal))) / b_norm
        log(f"{cell}: {mesh.num_cells} cells, {mesh.num_vertices} dofs; mesh {mesh_s:.3f} s, RCM on the card "
            f"{rcm_s:.3f} s; f64 operator {time.perf_counter() - t0:.3f} s; f32 floor of |b - A u| / |b| from the "
            f"rounding of the exact nodal values {floor_u:.3e} (eps / (30 h^2) = {2.0**-23 / 30 * res**2:.3e}); CG "
            f"tolerance {F32_TOL_P2D:g}")
        check(F32_TOL_P2D >= floor_u, f"{cell}: CG tolerance {F32_TOL_P2D:g} below the f32 floor {floor_u:.3e}")
        captured, solutions = {}, {}

        def capture(key, fn):
            def run(*args, **kwargs):
                out = fn(*args, **kwargs)
                captured[key] = args[0] if key in ("matrix", "operator") else out
                return out
            return run

        for route, solve in poisson_routes().items():
            cg_times, err_times, pattern_times, csr_times = [], [], [], []
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw = dict(min_fill=MMS_MIN_FILL) if route == "assembled" else {}
            with mock.patch.object(cg_mod, "conjugate_gradient",
                                   timed(capture("operator", cg_mod.conjugate_gradient), cg_times)), \
                    mock.patch.object(fem_mod, "_errors", timed(fem_mod._errors, err_times)), \
                    mock.patch.object(G, "csr_pattern", timed(G.csr_pattern, pattern_times)), \
                    mock.patch.object(G, "assemble_csr", timed(G.assemble_csr, csr_times)), \
                    mock.patch.object(fem_mod, "assemble_poisson_system",
                                      capture("csr", fem_mod.assemble_poisson_system)), \
                    mock.patch.object(dk, "block_dia_operator", capture("matrix", dk.block_dia_operator)), \
                    mock.patch.object(bdia, "block_dia_assembly_plan", capture("dia_plan", bdia.block_dia_assembly_plan)), \
                    mock.patch.object(bd, "make_banded_plan", capture("plan", bd.make_banded_plan)):
                r = solve(mesh, element_rule(rule), element_rule(err_rule), source, u_exact, u_exact_grad, nd,
                          rel_tolerance=F32_TOL_P2D, dtype=torch.float32, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for key in route_kernels[route]:
                kernels[key]["launches"] = kernels[key]["fn"].launches
            launches = {key: kernels[key]["launches"] for key in route_kernels[route]}
            t_cg, t_err = sum(cg_times), sum(err_times)
            extra = ""
            if route == "csr":
                A = captured["csr"][0]
                extra = (f"; CSR pattern on the card {sum(pattern_times):.3f} s (nnz {A.nnz}), CSR assembly "
                         f"{sum(csr_times):.3f} s")
            elif route == "assembled":
                plan = captured["dia_plan"]
                extra = f"; D = {plan.num_diagonals} bands, fill {plan.fill:.4f}, remainder width {plan.rem_k}"
            log(f"{cell} {route}: f32, CG rel {F32_TOL_P2D:g}: set-up {wall - t_cg - t_err:.3f} s{extra}; solve "
                f"{t_cg:.3f} s ({r.cg_iterations} CG iterations, {t_cg / max(r.cg_iterations, 1) * 1e3:.3f} ms per "
                f"iteration), errors {t_err:.3f} s, wall {wall:.3f} s; L2 error {r.l2_error:.6e}, H1 "
                f"{r.h1_seminorm_error:.6e}; launches {launches}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
            check(bool(torch.isfinite(r.u).all()) and tuple(r.u.shape) == (mesh.num_vertices,),
                  f"{cell} {route}: wrong or non-finite solution")
            for key in route_kernels[route]:
                check(launches[key] > 0, f"{cell} {route}: kernel {key} was not launched")
            # the route's own operator against the f64 one on the same f32 values (b - residual(u) = A u there)
            op_diff = torch.where(free, captured.pop("operator")(u32).double() - (b - residual(u32)), 0.0)
            floor_op = float(torch.linalg.vector_norm(op_diff)) / b_norm
            rel = float(torch.linalg.vector_norm(residual(r.u))) / b_norm
            limit = 10 * max(F32_TOL_P2D, floor_op)
            log(f"{cell} {route}: true relative residual |b - A u| / |b| by the plain f64 operator {rel:.6e}; the "
                f"route's f32 operator floor |(A_f32 - A) u| / |b| {floor_op:.3e}; limit {limit:.3e}")
            check(rel <= limit, f"{cell} {route}: true relative residual {rel:.3e} > {limit:.3e}")
            solutions[route] = r.u
            del r, op_diff
        ref = solutions["csr"].double()
        diffs = {route: float(torch.linalg.vector_norm(u.double() - ref) / torch.linalg.vector_norm(ref))
                 for route, u in solutions.items() if route != "csr"}
        log(f"{cell}: relative difference of each route's solution from the CSR route's {diffs}")
        del residual, b, solutions, ref
        free_memory()
        csr_spmv_record(captured["csr"][0], dev, smi, cell)
        matrix = captured["matrix"]
        scalar_kernel_checks(kernels, matrix.bands, matrix.offsets, captured["plan"], dev, smi, cell=cell)
        del captured, matrix
        free_memory()
        meshes[name] = (mesh, rcm_s)
    return meshes


def main() -> int:
    if not (ROOT / "fenris_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenris_tpu_torch/ not found next to this script; run it in a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.dia_sweep as ds
    import fenris_tpu_torch.ops.em_sweep as es
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.ops._build import build_log, load_library
    from fenris_tpu_torch.ops.banded import make_banded_plan

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- card and build ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    load_library()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a, {len(SOURCES)} sources in parallel)")
    found = ptxas_report(build_log())
    for prefix in ("stiffness_pairs", "em_sweep", *PTXAS_LABELS.values()):
        entries = {n: t for n, t in found.items() if n.startswith(prefix)}
        check(len(entries) > 0 and all("0 bytes spill stores, 0 bytes spill loads" in t for t in entries.values()),
              f"{prefix}: ptxas reports spills or no entry: {entries}")
    em_entries, em_all = sum(n.startswith("em_sweep") for n in found), len(es.ELEMENTS) * len(es.MATERIALS) * 4
    check(em_entries == em_all, f"em_sweep: ptxas reports {em_entries} of {em_all} instantiations")
    t0 = time.perf_counter()
    card_tests()
    log(f"phase card tests: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    banded_star_check(dev)
    log(f"phase banded star: {time.perf_counter() - t0:.3f} s")

    kernels = {
        "neo_hookean_residual": dict(
            fn=ss.neo_hookean_residual, plain=ss.neo_hookean_residual_plain, nargs=1, path="structured",
            source=SOURCES["structured_stencil"], replaces="fenris_tpu/ops/structured_stencil.py:421",
        ),
        "neo_hookean_hvp": dict(
            fn=ss.neo_hookean_hvp, plain=ss.neo_hookean_hvp_plain, nargs=2, path="structured",
            source=SOURCES["structured_stencil"], replaces="fenris_tpu/ops/structured_stencil.py:319",
        ),
        "dia_sweep": dict(
            fn=ds.dia_sweep, path="A", source=SOURCES["dia_sweep"],
            replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
        ),
        "stiffness_pairs": dict(
            fn=sp.stiffness_pairs, path="B", source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162",
        ),
        # BASELINE's headline elements: hex20 (points in chunks) and tet10, linear elasticity
        "stiffness_pairs (hex20, B20)": dict(
            fn=sp.stiffness_pairs, path="B20", source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162",
        ),
        "stiffness_pairs (tet10, B10)": dict(
            fn=sp.stiffness_pairs, path="B10", source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162",
        ),
        "banded_gather": dict(
            fn=bd.banded_gather, path="C", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        ),
        "banded_scatter": dict(
            fn=bd.banded_scatter, path="C", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        ),
        # the tangent sweep as the main path launches it: fused with the banded gather
        "em_vector_tangent_sweep": dict(
            fn=es.banded_tangent_sweep, path="C", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:251",
        ),
        # the vector sweep as the main path launches it: fused with the banded gather
        "em_vector_sweep": dict(
            fn=es.banded_vector_sweep, path="C", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:233",
        ),
        # the scalar Poisson path P149 runs rows 4-7 at s = 1: their records at those shapes
        "dia_sweep (s=1, P149)": dict(
            fn=ds.dia_sweep, path="P149", source=SOURCES["dia_sweep"],
            replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
        ),
        "banded_gather (s=1, P149)": dict(
            fn=bd.banded_gather, path="P149", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        ),
        "banded_scatter (s=1, P149)": dict(
            fn=bd.banded_scatter, path="P149", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        ),
        # the tet10 Poisson solve P40-tet10: the band sweep at s = 1 with its own diagonal count
        "dia_sweep (s=1, P40-tet10)": dict(
            fn=ds.dia_sweep, path="P40", source=SOURCES["dia_sweep"],
            replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
        ),
    }
    # M10/M20 and S10/S20: the gather and scatter at n = 10 and 20 (s = 3), the fused sweeps of each material
    for name in ("tet10", "hex20"):
        kernels[f"banded_gather (s=3, {name})"] = dict(
            fn=bd.banded_gather, path=name, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        )
        kernels[f"banded_scatter (s=3, {name})"] = dict(
            fn=bd.banded_scatter, path=name, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        )
        for material in es.MATERIALS:
            tangent, vector = sweep_records(name, material)
            kernels[tangent] = dict(fn=es.banded_tangent_sweep, path=name, source=SOURCES["em_sweep"],
                                    replaces="fenris_tpu/ops/em_sweep.py:251")
            kernels[vector] = dict(fn=es.banded_vector_sweep, path=name, source=SOURCES["em_sweep"],
                                   replaces="fenris_tpu/ops/em_sweep.py:233")
    # M2D: the fused sweeps of each 2D element and material, the gather and scatter at s = 2
    for (d, _, _), name in es.ELEMENTS.items():
        if d != 2:
            continue
        kernels[f"banded_gather (s=2, {name})"] = dict(
            fn=bd.banded_gather, path=f"M2D {name}", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        )
        kernels[f"banded_scatter (s=2, {name})"] = dict(
            fn=bd.banded_scatter, path=f"M2D {name}", source=SOURCES["banded"],
            replaces="fenris_tpu/ops/banded.py:346",
        )
        for material in es.MATERIALS:
            tangent, vector = sweep_records(name, material)
            kernels[tangent] = dict(fn=es.banded_tangent_sweep, path=f"M2D {name}", source=SOURCES["em_sweep"],
                                    replaces="fenris_tpu/ops/em_sweep.py:251")
            kernels[vector] = dict(fn=es.banded_vector_sweep, path=f"M2D {name}", source=SOURCES["em_sweep"],
                                   replaces="fenris_tpu/ops/em_sweep.py:233")
    # ME: the fused sweeps with per-element Lame parameters on hex8 (C1's layout) and tet10 (PE10's)
    for name in ("hex8", "tet10, neo_hookean"):
        kernels[f"em_vector_tangent_sweep ({name}, [E])"] = dict(
            fn=es.banded_tangent_sweep, path=f"ME {name[:5]}", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:251")
        kernels[f"em_vector_sweep ({name}, [E])"] = dict(
            fn=es.banded_vector_sweep, path=f"ME {name[:5]}", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:233")
    # B2: the stiffness kernel at d = 2, each element and operator
    for name in B2_MESHES:
        for kind in ("linear", "laplace"):
            kernels[f"stiffness_pairs ({name} {kind}, B2)"] = dict(
                fn=sp.stiffness_pairs, path="B2", source=SOURCES["stiffness_pairs"],
                replaces="fenris_tpu/ops/stiffness_kernel.py:162",
            )
    # P2D: rows 4-7 at s = 1 on the 2D meshes (n = 9 and 6 nodes a row)
    for name in P2D_MESHES:
        cell = f"P2D {name}"
        kernels[f"dia_sweep (s=1, {cell})"] = dict(
            fn=ds.dia_sweep, path=cell, source=SOURCES["dia_sweep"],
            replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
        )
        kernels[f"banded_gather (s=1, {cell})"] = dict(
            fn=bd.banded_gather, path=cell, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        )
        kernels[f"banded_scatter (s=1, {cell})"] = dict(
            fn=bd.banded_scatter, path=cell, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        )
    phases = [
        ("structured path", lambda: structured_phases(kernels, dev, smi)),
        ("entry B", lambda: stiffness_phases(kernels, dev, smi)),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    element_meshes = stiffness_element_phases(kernels, dev, smi)  # kept for P40-tet10 and M10/M20, S10/S20
    log(f"phase entry B20/B10: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    stiffness_2d_phases(kernels, found, dev, smi)
    log(f"phase entry B2: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    model, plan_s = path_a_setup(dev, smi)
    band_sweep_phases(kernels["dia_sweep"], model, dev, smi)
    log(f"phase band sweep and determinism: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    x_a = path_a_solve(kernels, model, plan_s, dev, smi)
    log(f"phase path A: {time.perf_counter() - t0:.3f} s")
    del model
    free_memory()
    t0 = time.perf_counter()
    cg_count_diagnostic(dev, smi)
    f64_banded_check(kernels, dev)
    log(f"phase CG-count diagnostic and f64 banded check: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    model = assembled_model(RES_A, torch.float32, dev, None, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan = model._plan
    t0 = time.perf_counter()
    make_banded_plan(model.mesh.cells, plan.num_nodes, 3, r_nodes=model.banded_r_nodes, device=dev)
    torch.cuda.synchronize()
    log(f"path C model res={RES_A}: set-up {plan_s:.3f} s; the banded plan alone, built again, "
        f"{time.perf_counter() - t0:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
        f"rows/block={plan.rows}, window {plan.wa} x 128 nodes, chunk {model.chunk_size})")
    t0 = time.perf_counter()
    path_c_kernels(kernels, model, dev, smi)
    log(f"phase path C1: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    me_hex8_phase(kernels, model, dev, smi)
    log(f"phase ME hex8: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    c2_cg_iters = path_c_solve(kernels, model, plan_s, x_a, dev, smi)
    log(f"phase path C2: {time.perf_counter() - t0:.3f} s")
    del model, x_a
    free_memory()
    t0 = time.perf_counter()
    path_c3(kernels, dev, smi)
    log(f"phase path C3: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    poisson_mms_gate(dev, smi)
    log(f"phase Poisson MMS gate: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    poisson2d_mms_gate(dev, smi)
    log(f"phase MMS2D: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    poisson_p149(kernels, dev, smi)
    log(f"phase P149: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    p2d_meshes = poisson_p2d(kernels, dev, smi)
    log(f"phase P2D: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    element_2d_phases(kernels, p2d_meshes, dev, smi)
    log(f"phase M2D, S2D: {time.perf_counter() - t0:.3f} s")
    del p2d_meshes
    t0 = time.perf_counter()
    element_meshes["tet10"] = poisson_p40_tet10(kernels, element_meshes["tet10"], dev, smi)
    log(f"phase P40-tet10: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    element_sweep_phases(kernels, {**element_meshes, "hex20": (element_meshes["hex20"], None)}, dev, smi)
    log(f"phase M10/M20, S10/S20, PE10 and ME tet10: {time.perf_counter() - t0:.3f} s")
    del element_meshes
    t0 = time.perf_counter()
    path_c2_mg(kernels, c2_cg_iters, dev, smi)
    log(f"phase C2-MG: {time.perf_counter() - t0:.3f} s")
    log(f"total: {time.perf_counter() - t_start:.3f} s ({smi})")

    record_line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": k["source"],
                "replaces": k["replaces"],
                "launches": k["launches"],
                "max_abs_err": k["max_abs_err"],
                "ms": k["ms"],
                "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
                **{key: k[key] for key in ("card_ms", "library_card_ms") if key in k},
            }
            for name, k in kernels.items()
        ]
    }
    print(json.dumps(record_line), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
