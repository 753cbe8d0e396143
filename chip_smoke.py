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
  its table of 16 elements a block) against its plain version, timed in
  turns beside its bound with M elements/s, and again at bench.py's own
  sizes (hex20 28^3, tet10 BCC 18); then row 3's other 3D elements at full
  width, both operators: tet4 on the BCC res-40 box (768,000 cells), tet20
  on the BCC res-32 box (393,216) and hex27 on the 48^3 box (110,592);
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
* mesh topology, surface loads and the tet4 multigrid: TOPO, after
  P40-tet10, the boundary queries on B20's hex20 and B10's tet10 meshes
  (counts, host times, quad8 and tri6 boundary meshes) and in f64 on the
  card a constant traction on the x = 0 faces summing to traction x area
  and the consistent mass matrices' entries summing to rho x s x volume,
  both within 1e-12; MMS-NL, tests/test_mms_nonlinear.py's Neo-Hookean
  MMS on the structured grid at 16^3, 32^3 and 64^3 (823,875 dofs), each
  ``solve_mixed(preconditioner="mg")`` to 1e-10, the last L2 order 2 +-
  0.3, and the Hessian-action kernel at 64^3 in its own record; T4-MG, path C2's problem on the BCC tet4 box at res 8 refined
  three times (3,145,728 tets, 1,610,307 dofs, RCM'd), the tet4 gather,
  scatter and fused sweeps against their plain versions and timed, then
  ``solve_mixed`` under Jacobi and under the banded geometric multigrid,
  each to the independent f64 residual <= 1e-10; CANT,
  examples/hyperelastic_cantilever_torch.py at res 32 with ``--banded``
  (65,536 hex8), Newton converged;
* point location, interpolation, I/O and mixed-element assembly (no kernel
  of their own): ERR, the reference's whole tri3 error-estimation suite
  (tests/reference_values/error_estimation_tri3_summary.json, 56
  samples, fine meshes up to 2,097,152 cells) in f64 through
  ``interpolate_at_points``/``interpolate_gradient_at_points`` on a
  ``GridIndex``, each L2 and H1 error within 1%; LOC, 10^6 seeded interior
  points of B10's tet10 mesh located at distance 0, mapped back within
  1e-12 and a quadratic field reproduced within 1e-10 through
  ``FixedInterpolator`` (its ``interpolate`` timed beside its bytes bound),
  then a 100^3 grid around the Gmsh sphere refined three times (303,616
  tets, about 60% of the points outside) through the grid branch, 4,096 of
  them also through the brute force (distances 1e-12, unique-nearest
  elements equal, values 1e-12); MSH, every Gmsh fixture from ASCII and
  binary files, then that sphere RCM'd under gravity with its cap clamped,
  the fused banded ``solve_mixed`` to the independent f64 residual with
  the tet4 gather, scatter and sweeps timed at its layout, the deformed
  mesh's VTU parsed back exactly, a checkpoint loaded bitwise and the f64
  ``solve`` resumed from it at iteration 0; AGG, mixed quad4/tri3 Poisson
  on 1,050,625 nodes through the quadrature tables and the aggregate CSR
  assembly (two assemblies bitwise equal, nodal error <= 1e-8); and in P2D
  ``block_dia_from_csr`` of the CSR matrices through the band sweep;
* C2-MG: path C2's problem on 18^3 cells refined twice (1,167,051 dofs;
  three times, 9,145,875 dofs, until the slice above pushed the run past
  600 s), RCM-reordered on the card in under 20 s, under
  ``GeometricMGPreconditioner(banded=True)``, ``solve_mixed`` to the
  independent f64 residual <= 1e-10, with CG iterations beside C2's Jacobi
  counts, the V-cycle's share of a CG iteration and a profile of one
  V-cycle;
* geometry, helpers and the sharded classes (no kernel of their own):
  GEO, the procedural sphere (8 x 8 tangent clips of a cube) against
  4π/3 and its triangulation's volume, welded, refined to 1,081,344 tets,
  RCM'd, the fused banded ``solve_mixed`` under gravity with its cap
  clamped (rows 6-8 under reset counts) to the independent f64 residual;
  UTIL, ``rotation_svd``, ``polar_decomposition``, ``apd`` and
  ``extremal_eigenvalues`` in f64 and f32 on GEO's 4,325,376 deformation
  gradients (RᵀR = I, det R = +1, F = RS with S symmetric, apd against the
  SVD rotation), timed, and ``profiling.trace`` around one Hessian action;
  PAR, two ranks spawned once on cuda:0 over gloo, every sharded class of
  ``parallel/`` against the single-process model: ``ShardedBandedElasticity``
  on path A's RCM'd mesh (residual and Hessian action through rows 6-9 on
  each rank's plan) and its Newton solve on C3's mesh, ``ShardedElasticity``
  on C3's mesh, the two structured classes on the flagship grid and a halo
  Newton solve at 32^3, ``ShardedBlockDia`` on P149's bands (the product
  through row 4 on each rank's window) and its CG; operator applications in
  f32 within 1e-5, solves in f64; launches, ms per application and the
  collectives' share per rank (gloo stages CUDA tensors through the host).

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
copies of the inputs that hold 3x the L2 between two uses of one copy; each
s = 3 scatter record (C2, tet10, hex20, T4-MG, MSH) and GEO's plan are held
bitwise to the plain version and log the walk the plan took, the row-count
inflation of its warps in node order and in sorted windows, and that walk's
registers.  ``ptxas`` lines (registers, shared memory, spills) of the
stencil, gather (s = 1, 2, 3, any s), scatter (s = 1, 2, any s, and s = 3's
three walks) and stiffness kernels (each element's three forms: matrix, its isotropic terms
and scalar, with each form's launch layout, and any rule's matrix and scalar forms; tet20's scalar form is
its reference sums) and all 132 element-sweep
instantiations (11 elements x 3 materials x 4 modes) are printed, and a
spill in any of them, or a missing instantiation, fails the run.  The card's
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
# row 3's other 3D elements (T4: B10's mesh before conversion; T20: 5.7 GB of linear output; H27:
# tools/em_sweep_ab.py's M27 mesh): cell -> (element, resolution)
STIFFNESS_3D_CELLS = {"T4": ("tet4", 40), "T20": ("tet20", 32), "H27": ("hex27", 48)}
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
# C2-MG: path C2's problem on 18^3 cells refined twice (72^3 = 373,248 hex8, 1,167,051 dofs); refined three
# times (144^3, 9,145,875 dofs) it took ~150 s, and the run with the topology, MMS-NL, T4-MG and CANT phases
# went past 600 s (628 s), so it runs one level less
RES_MG_COARSE = 18
MG_LEVELS = 2
# the slice of mesh topology, surface loads, tet4 refinement and the nonlinear MMS.  TOPO: boundary queries on
# B20's hex20 and B10's tet10 meshes, a constant traction on their x = 0 side and their consistent mass in f64
# (density RHO_TOPO); MMS-NL: tests/test_mms_nonlinear.py's Neo-Hookean MMS (sine bubble) on the structured
# grid at MMS_NL_CELLS; T4-MG: path C2's problem on the BCC tet4 box at res RES_T4_COARSE refined
# T4_LEVELS times (3,145,728 tets) under the banded geometric multigrid and under Jacobi; CANT:
# examples/hyperelastic_cantilever_torch.py at res RES_CANT (65,536 hex8) with --banded
TRACTION_TOPO = (0.5, -1.25, 3.0)
RHO_TOPO = 2.5
MMS_NL_CELLS = (16, 32, 64)
RES_T4_COARSE = 8
T4_LEVELS = 3
RES_CANT = 32
# point location, I/O and mixed-element assembly.  ERR: the reference's tri3 error-estimation suite, every
# sample, with the triangle rule of strength ERR_RULE (tests/test_error_estimation.py); LOC: 10^6 points in B10's
# tet10 mesh and a LOC_GRID^3 grid around the refined sphere, the brute force on LOC_SUBSET of them; MSH: the Gmsh
# fixtures, and the sphere refined MSH_LEVELS times (303,616 tets) under gravity with the cap z < MSH_CAP_Z
# clamped; AGG: mixed_square(AGG_RES), 1,572,864 cells on 1,050,625 nodes, Jacobi CG to AGG_CG_TOL
ERR_SUMMARY = "tests/reference_values/error_estimation_tri3_summary.json"
ERR_RULE = 20
LOC_POINTS = 1_000_000
LOC_GRID = 100
LOC_SUBSET = 4096
MSH_LEVELS = 3
MSH_CAP_Z = -0.45
AGG_RES = 512
# the nodal error after Jacobi CG to 1e-10 grows about as the resolution (on the CPU, f64: 3.3e-10, 2.1e-9,
# 5.0e-9, 9.4e-9 at AGG_RES 16, 64, 128, 256) and passes 1e-8 at 512 (2.28e-8 on the card), so AGG solves to 1e-12
AGG_CG_TOL = 1e-12
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
    entry.  On a simplex at s = 1 also the reference sums (J once; K = |det| J^-1 C J^-T, d^2 (2d - 1) and
    u (2d - 1) + u for its u = d (d + 1) / 2 upper entries; K against the rule's sums, 2u - 1 an entry), as
    the kernel does on tet20."""
    pairs = s * (s + 1) // 2 if sym else s * s
    entries = (s * (s - 1) // 2 * n * n + s * n * (n + 1) // 2) if sym else s * s * n * n
    geometry = q * (d * d * (2 * m - 3) + STIFFNESS_INV_OPS[d] + 1 + n * d * (2 * d - 1) + n * d) + (m - 1) * d
    per_point = q * pairs * n * d * (2 * d - 1) + entries * (2 * q * d - 1)
    node_pairs = n * (n + 1) // 2 * d * d * (2 * q - 1) + entries * (2 * d * d - 1)
    best = geometry + min(per_point, node_pairs)
    if m == d + 1 and s == 1:
        u = d * (d + 1) // 2
        simplex = (m - 1) * d + d * d * (2 * m - 3) + STIFFNESS_INV_OPS[d] + d * d * (2 * d - 1) + 2 * d * u
        best = min(best, simplex + entries * (2 * u - 1))
    return E * best


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
                   for k, top in (("gather", 3), ("scatter", 2)) for s in range(top + 1)},
                "banded_scatter_kernelILi3ELb1E": "banded_scatter (s = 3, rows walk)",
                "banded_scatter3_kernelILi1E": "banded_scatter (s = 3, 1 lane a node)",
                "banded_scatter3_kernelILi4E": "banded_scatter (s = 3, 4 lanes a node)"}
PTXAS = {}  # ptxas_report's {label: ptxas text} of the loaded library, kept for the phases' logs


def stiffness_label(mangled):
    """The label of a stiffness kernel's mangled name (``pairs_kernel<element, scalar, isotropic, any rule>``:
    "stiffness_pairs (hex20, scalar form)", "stiffness_pairs (hex20, scalar form, any rule)";
    ``sums_kernel<element>``: "stiffness_pairs (tet20, sums form)"), or None."""
    import fenris_tpu_torch.ops.stiffness_pairs as sp

    tiled = re.search(r"12pairs_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", mangled)
    if tiled:
        form = "scalar" if tiled[2] == "1" else "isotropic matrix" if tiled[3] == "1" else "matrix"
        rule = ", any rule" if tiled[4] == "1" else ""
        return f"stiffness_pairs ({list(sp._TILING)[int(tiled[1])]}, {form} form{rule})"
    sums = re.search(r"11sums_kernelILi(\d+)E", mangled)
    if sums:
        return f"stiffness_pairs ({list(sp._TILING)[int(sums[1])]}, sums form)"
    return None


def stiffness_layout_report(found):
    """Each element's two stiffness launches (``ops/stiffness_pairs._TILING``) with the registers and spills of
    their instantiations (``found``, ptxas_report's: the canonical rule's three forms and any rule's two, or
    where a scalar row's tile side is 0 the matrix forms and the reference-sums form); fails unless every
    instantiation the table asks for was built, and on a layout that fits no block."""
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.quadrature import canonical_stiffness

    expect = 0
    for name, ((d, m, n), *forms) in sp._TILING.items():
        scalar = (("sums", "", forms[1]),) if forms[1][2] == 0 else (("scalar", "", forms[1]),
                                                                      ("scalar", ", any rule", forms[1]))
        for form, rule, (elems, warps, tile, bound) in (
                ("matrix", "", forms[0]), ("isotropic matrix", "", forms[0]), ("matrix", ", any rule", forms[0]),
                *scalar):
            label = f"stiffness_pairs ({name}, {form} form{rule})"
            check(label in found, f"{label}: not built")
            expect += 1
            txt = found[label]
            smem = sp._smem_bytes(m, n, canonical_stiffness(name).num_points, d, form in ("scalar", "sums"))
            blocks = min(sp._SM_SMEM // (smem + 1024), 2048 // (32 * warps), 32)
            log(f"layout {label}: {elems} elements a block, {warps} warps, tile {tile} x {tile}, launch bound "
                f"{1 if rule else bound} blocks an SM, {smem} shared bytes at the canonical rule, {blocks} blocks an SM by shared "
                f"memory and threads; {txt}")
            check(blocks >= 1, f"{label}: no block fits an SM")
    built = sum(k.startswith("stiffness_pairs (") for k in found)
    check(built == expect, f"stiffness_pairs: ptxas reports {built} instantiations, the table asks for {expect}")


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
            st = stiffness_label(m.group(1))
            if st:
                label = st
            em = re.search(r"(?:sweep|element)_kernelILb(\d)ELb(\d)ELi(\d)ELi(\d+)ELi(\d+)ELi(\d)E", m.group(1))
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


def em_layout_report(found):
    """For each element's sweeps at its canonical rule (banded and strided, tangent and vector, each material):
    lanes an element, elements a tile, warps a block, registers and spill bytes (``found``, ptxas_report's)
    and resident blocks an SM (``ops/em_sweep.launch_layout``); fails on a layout that fits no block."""
    from fenris_tpu_torch.assembly.local import tabulate
    from fenris_tpu_torch.reference_elements import element
    from fenris_tpu_torch.ops import em_sweep as es
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import MaterialEllipticOperator

    for (d, _, _), name in es.ELEMENTS.items():
        tab = tabulate(element(name), canonical_stiffness(name))
        for material, cls in es.MATERIALS.items():
            op = MaterialEllipticOperator(cls(), dim=d)
            for banded in (True, False):
                for tangent in (True, False):
                    lay = es.launch_layout(op, tab, tangent, banded)
                    label = (f"em_sweep ({'banded' if banded else 'strided'} {'tangent' if tangent else 'vector'}, "
                             f"{name}, {material})")
                    txt = found.get(label, "")
                    regs = re.search(r"Used (\d+) registers", txt)
                    spill = re.search(r"(\d+) bytes spill stores", txt)
                    log(f"layout {label}: q={tab.num_points}, {lay['lanes']} lanes an element, {lay['elements']} "
                        f"elements a tile, {lay['threads'] // 32} warps a block, "
                        f"{regs.group(1) if regs else '?'} registers, {spill.group(1) if spill else '?'} bytes spilled, "
                        f"{lay['shared_bytes']} shared bytes, {lay['blocks_per_sm']} blocks an SM")
                    check(lay["blocks_per_sm"] >= 1, f"{label}: no block fits an SM")


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
    exact = bool(torch.equal(got, ref))
    log(f"banded_scatter {shape_txt}: bitwise equal to the plain version (same row order): {exact}")
    check(exact, f"banded_scatter {shape_txt}: not bitwise equal to the plain version")
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
    if s == 3:
        scatter_walk_log(plan, names[1])
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


def scatter_walk_log(plan, record):
    """Log the walk the s = 3 scatter takes on ``plan`` (record ``record``): the rows walk or one or four lanes
    a node, the row-count inflation of warps of 32 nodes in node order (what the walk reads) and with each
    window sorted by row count (``ops/banded.walk_inflation``), rows a node, and the walk's registers and
    spills from the build log."""
    import torch

    import fenris_tpu_torch.ops.banded as bd

    counts = torch.diff(plan.row_ptr.long())
    before, after = (bd.walk_inflation(counts, sorted_windows) for sorted_windows in (False, True))
    label = PTXAS_LABELS["banded_scatter_kernelILi3ELb1E" if plan.walk == bd.WALK_ROWS
                         else f"banded_scatter3_kernelILi{plan.walk}E"]
    log(f"scatter walk {record}: {label[len('banded_scatter (s = 3, '):-1]}, {plan.num_nodes} nodes; row-count "
        f"inflation {before:.3f} in node order, {after:.3f} in windows of {bd.SCATTER_WINDOW} sorted; rows a node "
        f"{int(counts.min())}-{int(counts.max())}, mean {float(counts.double().mean()):.2f}; ptxas: "
        f"{PTXAS.get(label, 'not in the log')}")


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


def element_sweep_checks(kernels, model, cell, dev, smi, materials=None, key=None):
    """M10/M20/M2D/T4-MG/MSH on ``model``'s layout: the gather and scatter at its n nodes a row and s = d, and
    for each material (of ``materials``, default all) the fused tangent and vector sweeps, against their plain
    versions (rel <= KERNEL_RTOL, bitwise repeats, padding rows zero), timed in turns with them beside their
    bounds, into the records of ``key`` (default: the element's name)."""
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
    key = key or name
    names = (f"banded_gather (s={d}, {key})", f"banded_scatter (s={d}, {key})")
    for rec, fn, plain, arg in zip(names, (bd.banded_gather, bd.banded_scatter),
                                   (bd.banded_gather_plain, bd.banded_scatter_plain), (w, f_el)):
        got, ref = fn(plan, arg), plain(plan, arg)
        kernels[rec]["max_abs_err"] = compare(fn.__name__, shape_txt, got, fn(plan, arg), ref)
        check(bool(torch.equal(got, ref)), f"{fn.__name__} {shape_txt}: not bitwise equal to the plain version")
        del got, ref
    runs = gather_scatter_runs(plan, w, f_el, dev, names)
    for material, cls in es.MATERIALS.items():
        if materials is not None and material not in materials:
            continue
        op = MaterialEllipticOperator(cls(), dim=d)
        for rec, fn, plain, args in zip(sweep_records(key, material),
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
    under reset counts (``solve_mixed`` returns its f64 solution): wall and set-up time, Newton steps, CG
    iterations a step, ms a CG iteration, peak memory and the launches of the kernels of ``records``
    (``{role: record}``, roles tangent, vector, gather, scatter; the records get them); no plain tangent sweep
    may run, and the tangent sweep must carry every CG iteration.  ``solve_mixed`` takes its residuals in f64
    on the plain sweeps, so it launches no vector sweep and its record gets 0; one f32 ``model.residual`` after
    it must launch the vector sweep once and no gather (logged, not recorded)."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    name = model.mesh.element.name
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
    launches = {role: kernels[rec]["fn"].launches for role, rec in records.items()}
    for role, rec in records.items():
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
    path = {role: c for role, c in launches.items() if not (mixed and role == "vector")}
    check(all(c > 0 for c in path.values()), f"{cell}: a kernel of the path was not launched: {path}")
    check(not mixed or launches["vector"] == 0, f"{cell}: solve_mixed launched {launches['vector']} vector sweeps")
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
    del fresh
    free_memory()
    return x64


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
    """C2-MG: path C2's problem on 18^3 refined MG_LEVELS times (twice: 373,248 hex8 cells, 1,167,051 dofs),
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
    check(t_rcm[0] < 20.0, f"C2-MG: RCM of the finest mesh took {t_rcm[0]:.1f} s (limit 20 s)")

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


# -- the topology, surface-load, tet4 multigrid and nonlinear MMS slice ----------------------------------------


def topo_phase(meshes, dev, smi):
    """TOPO: the boundary queries on ``meshes`` (``{name: mesh}``: B20's hex20 and B10's tet10), with counts and
    host times; the boundary vertices against the vertices on the box's surface found from their coordinates;
    their boundary meshes' face elements; then in f64 on the card a constant traction on the x = 0
    side's faces (``assemble_element_surface_source_vectors`` and ``assemble_vector``) summing to traction x
    its area 1, and the entries of the consistent mass matrices (``assemble_element_mass_matrices``, s = 3)
    summing to rho x s x the volume 1, both within 1e-12 relative."""
    import numpy as np
    import torch

    from fenris_tpu_torch.assembly.global_ import assemble_vector, element_dof_indices
    from fenris_tpu_torch.assembly.local import (
        assemble_element_mass_matrices,
        assemble_element_surface_source_vectors,
        tabulate,
    )
    from fenris_tpu_torch.quadrature import canonical_mass

    faces_of = {"hex20": "quad8", "tet10": "tri6"}
    traction = torch.tensor(TRACTION_TOPO, dtype=torch.float64, device=dev)
    for name, mesh in meshes.items():
        out, times = {}, {}
        for query in ("find_boundary_faces", "find_boundary_cells", "find_boundary_vertices", "boundary_mesh"):
            t0 = time.perf_counter()
            out[query] = getattr(mesh, query)()
            times[query] = time.perf_counter() - t0
        faces, cells, verts, bm = out.values()
        log(f"TOPO {name}: {mesh.num_cells} cells, {mesh.num_vertices} vertices: {len(faces)} boundary faces, "
            f"{len(cells)} boundary cells, {len(verts)} boundary vertices; host times "
            + ", ".join(f"{q} {t:.3f} s" for q, t in times.items()))
        check(bm.element.name == faces_of[name], f"TOPO {name}: boundary mesh of {bm.element.name}")
        # independent of the topology: the unit box's vertices with a coordinate at 0 or 1
        on_surface = np.flatnonzero((np.abs(mesh.points - 0.5) > 0.5 - 1e-12).any(axis=1))
        check(np.array_equal(verts, on_surface), f"TOPO {name}: {len(verts)} boundary vertices, {len(on_surface)} "
              "vertices on the box's surface")
        fel = bm.element
        side = bm.cells[(np.abs(mesh.points[bm.cells][:, :, 0]) < 1e-12).all(axis=1)]
        tab = tabulate(fel, canonical_mass(fel.name))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = torch.as_tensor(mesh.points[side[:, : fel.geometry.num_nodes]], dtype=torch.float64, device=dev)
        b_el = assemble_element_surface_source_vectors(X, traction, None, 3, tab)
        dofs = torch.as_tensor(element_dof_indices(side, 3), device=dev)
        b = assemble_vector(b_el, dofs, 3 * mesh.num_vertices)
        total = b.reshape(-1, 3).sum(0)
        torch.cuda.synchronize()
        t_traction = time.perf_counter() - t0
        rel_t = float((total - traction).abs().max() / traction.abs().max())
        geo = mesh.element.geometry.num_nodes
        vtab = tabulate(mesh.element, canonical_mass(mesh.element.name))
        t0 = time.perf_counter()
        mass = torch.zeros((), dtype=torch.float64, device=dev)
        for e0 in range(0, mesh.num_cells, 32768):
            Xc = torch.as_tensor(mesh.points[mesh.cells[e0:e0 + 32768, :geo]], dtype=torch.float64, device=dev)
            mass += assemble_element_mass_matrices(Xc, RHO_TOPO, 3, vtab).sum()
        torch.cuda.synchronize()
        t_mass = time.perf_counter() - t0
        rel_m = abs(float(mass) - RHO_TOPO * 3) / (RHO_TOPO * 3)
        log(f"TOPO {name}: traction {list(TRACTION_TOPO)} on {len(side)} {fel.name} faces of x = 0: sum "
            f"{total.tolist()} (rel {rel_t:.3e}, {t_traction:.3f} s); mass matrices (rho {RHO_TOPO}, s = 3, "
            f"{tab.num_points}/{vtab.num_points}-point rules): sum {float(mass):.15f} against {RHO_TOPO * 3} (rel "
            f"{rel_m:.3e}, {t_mass:.3f} s) ({smi})")
        check(rel_t <= 1e-12, f"TOPO {name}: traction sum rel {rel_t:.3e} > 1e-12")
        check(rel_m <= 1e-12, f"TOPO {name}: mass sum rel {rel_m:.3e} > 1e-12")
        free_memory()


def mms_nl_phase(kernels, dev, smi):
    """MMS-NL: tests/test_mms_nonlinear.py's Neo-Hookean MMS (the sine bubble, its PARAMS, the whole boundary
    clamped) on the structured grid at MMS_NL_CELLS, each ``solve_mixed(preconditioner="mg")`` to 1e-10
    relative (f64 outer residual, the Hessian-action kernel in every inner CG iteration); the L2 errors (by an
    f64 model) and the order of the last pair 2 +- 0.3; then the Hessian-action kernel at the last grid's shapes
    against its plain version and timed beside its bound, in its own record with the last solve's launches."""
    import math

    import numpy as np
    import torch

    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial
    from fenris_tpu_torch.solid.mms import manufactured_body_force, sine_bubble_displacement
    from fenris_tpu_torch.structured import StructuredHyperelasticModel

    params = LameParameters(mu=MU, lam=LAM)
    u_exact = sine_bubble_displacement()
    force = manufactured_body_force(NeoHookeanMaterial(), params, u_exact)
    errors = []
    for c in MMS_NL_CELLS:
        m = np.zeros((c + 1,) * 3, dtype=bool)
        m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1] = (True,) * 6
        kw = dict(cells=(c, c, c), spacing=1.0 / c, material=NeoHookeanMaterial(), params=params,
                  dirichlet_mask=np.repeat(m.reshape(-1), 3), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = StructuredHyperelasticModel(body_force=force, dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        history, cg_iters = [], []

        def record(k, fn, cg):
            history.append(fn)
            if cg is not None:
                cg_iters.append(cg.num_iterations)

        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.solve_mixed(tolerance=1e-10, preconditioner="mg", callback=record)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hvp = kernels["neo_hookean_hvp"]["fn"].launches
        ratio = res.residual_norm / history[0]
        err = StructuredHyperelasticModel(dtype=torch.float64, **kw).l2_error(res.x, u_exact)
        errors.append(err)
        order = math.log2(errors[-2] / err) if len(errors) > 1 else float("nan")
        log(f"MMS-NL c={c} ({c ** 3} cells, {model.num_dofs} dofs): status={res.status} newton_iters={res.iterations} "
            f"cg_iters={cg_iters} |F|/|F0|={ratio:.6e} L2 error {err:.6e} order {order:.4f}; set-up {setup:.3f} s, "
            f"solve_mixed {wall:.3f} s; neo_hookean_hvp launches {hvp} ({smi})")
        check(res.status == NEWTON_CONVERGED and ratio <= 1e-10, f"MMS-NL c={c}: status {res.status}, rel {ratio:.3e}")
        check(hvp >= sum(cg_iters) > 0, f"MMS-NL c={c}: {hvp} Hessian-action launches for {sum(cg_iters)} CG iterations")
        check(bool(torch.isfinite(res.x).all()), f"MMS-NL c={c}: non-finite displacement")
        del model, res
        free_memory()
    order = math.log2(errors[-2] / errors[-1])
    log(f"MMS-NL L2 errors {[f'{e:.6e}' for e in errors]}, orders "
        f"{[f'{math.log2(a / b):.4f}' for a, b in zip(errors, errors[1:])]} (expected 2 +- 0.3)")
    check(abs(order - 2.0) <= 0.3, f"MMS-NL: last L2 order {order:.3f} not 2 +- 0.3")

    # the Hessian-action kernel at the last grid's shapes: its own record, with the last solve's launches
    k = kernels["neo_hookean_hvp (MMS-NL)"]
    k["launches"] = hvp
    cells = (MMS_NL_CELLS[-1],) * 3
    h, u, v = kernel_inputs(cells, dev, seed=2)
    gp, w = ss.gp_table(h)
    k["max_abs_err"] = compare("neo_hookean_hvp (MMS-NL)", f"cells={cells}", k["fn"](u, v, gp, w, MU, LAM),
                               k["fn"](u, v, gp, w, MU, LAM), k["plain"](u, v, gp, w, MU, LAM))
    k["ms"], k["plain_ms"], txt = in_turns(lambda: k["fn"](u, v, gp, w, MU, LAM),
                                           lambda: k["plain"](u, v, gp, w, MU, LAM))
    bound_txt = set_bound(k, 3 * u.numel() * 4, stencil_ops(cells[0] * cells[1] * cells[2], hvp=True))
    k["library_ms"] = None
    log(f"time neo_hookean_hvp (MMS-NL) cells={cells}: {txt}; {bound_txt}; launches in the last solve {hvp} ({smi})")
    del u, v
    free_memory()


def t4_mg_phase(kernels, dev, smi):
    """T4-MG: path C2's problem on the BCC tet4 box at res RES_T4_COARSE refined T4_LEVELS times
    (``rcm_refined_hierarchy``, RCM on the card), the fused banded model's ``solve_mixed`` under Jacobi and
    then under ``GeometricMGPreconditioner(banded=True)``, each to the independent f64 residual <= 1e-10
    (element_solve); the tet4 gather, scatter and both fused sweeps against their plain versions, timed
    beside their bounds and library calls (element_sweep_checks).  The records' launches are the MG solve's."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.mesh.refinement as refinement
    import fenris_tpu_torch.mesh.reorder as reorder
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_tet_mesh_3d
    from fenris_tpu_torch.multigrid import GeometricMGPreconditioner, rcm_refined_hierarchy

    coarse = create_unit_box_uniform_tet_mesh_3d(RES_T4_COARSE)
    t_refine, t_rcm = [], []
    torch.cuda.synchronize()
    with mock.patch.object(refinement, "refine_uniformly_repeat", timed(refinement.refine_uniformly_repeat, t_refine)), \
            mock.patch.object(reorder, "reorder_mesh", timed(reorder.reorder_mesh, t_rcm)):
        fine, perm = rcm_refined_hierarchy(coarse, T4_LEVELS, device=dev)
    t0 = time.perf_counter()
    model = assembled_model(0, torch.float32, dev, None, mesh=fine, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = GeometricMGPreconditioner(model, coarse, T4_LEVELS, fine_permutation=perm, banded=True)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    levels = [(L["num_vertices"], L["model"].mesh.num_cells) for L in mg.levels_data]
    setup = t_refine[0] + t_rcm[0] + t_model
    log(f"T4-MG: BCC tet4 res {RES_T4_COARSE} ({coarse.num_cells} tets) refined {T4_LEVELS} times: {fine.num_cells} "
        f"tet4, {model.space.num_dofs} dofs; refinement {t_refine[0]:.3f} s, RCM on the card {t_rcm[0]:.3f} s, "
        f"fused model {t_model:.3f} s, MG set-up {t_mg:.3f} s; levels (nodes, cells) {levels} ({smi})")
    element_sweep_checks(kernels, model, "T4-MG", dev, smi, materials=("neo_hookean",))
    records = solve_records("tet4", "neo_hookean", 3, True)
    element_solve(kernels, model, records, "T4-MG Jacobi", setup, dev, smi, mixed=True, cg_max_iter=SLICE_CG_MAX_ITER)
    element_solve(kernels, model, records, "T4-MG MG", setup + t_mg, dev, smi, mixed=True, preconditioner=mg)
    del model, mg
    free_memory()


def cantilever_phase(kernels, dev, smi):
    """CANT: ``examples/hyperelastic_cantilever_torch.main(RES_CANT, banded=True)`` on the card (f32, RCM and
    the fused kernels; ``solve_mixed`` to 1e-4 of the initial residual within the example's Newton cap):
    Newton must converge (status 0) with the fused tangent sweep in every CG iteration; the Newton steps, CG
    iterations and the tip deflection.  ``solve_mixed``'s residuals are f64 on the plain sweeps, so the vector
    sweep is not on this path."""
    import numpy as np
    import torch

    from unittest import mock

    sys.path.insert(0, str(ROOT / "examples"))
    import hyperelastic_cantilever_torch as example

    from fenris_tpu_torch.elasticity import HyperelasticModel

    path = ("banded_gather", "banded_scatter", "em_vector_tangent_sweep", "em_vector_sweep")
    history = []
    solve = HyperelasticModel.solve_mixed

    def traced(self, *args, **kwargs):
        kwargs["callback"] = lambda k, fn, cg: history.append((fn, None if cg is None else cg.num_iterations))
        return solve(self, *args, **kwargs)

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(HyperelasticModel, "solve_mixed", traced):
        res, u, tip = example.main(RES_CANT, banded=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels[name]["fn"].launches for name in path}
    cg = [c for _, c in history if c is not None]
    log(f"CANT res {RES_CANT}: status {res.status}, {res.iterations} Newton steps (cap {example.MAX_NEWTON_ITERATIONS}), |F| "
        f"{history[0][0]:.6e} -> {history[-1][0]:.6e}, CG iterations {sum(cg)} (a step: min {min(cg, default=0)}, "
        f"max {max(cg, default=0)}), tip deflection {u[tip].tolist()}, wall {wall:.3f} s (mesh, RCM, model and "
        f"solve); launches {launches} ({smi})")
    log("CANT |F| a Newton step: " + " ".join(f"{fn:.3e}" for fn, _ in history))
    check(res.status == 0, f"CANT: Newton status {res.status}")
    check(bool(np.isfinite(u).all()) and u[tip, 2] < 0.0, f"CANT: tip deflection {u[tip].tolist()}")
    # solve_mixed's residuals are f64 on the plain sweeps: its kernels are the tangent sweep and the scatter
    check(launches["em_vector_tangent_sweep"] >= sum(cg) > 0 and launches["banded_scatter"] > 0,
          f"CANT: the tangent sweep and the scatter were not launched for every CG iteration: {launches}")
    free_memory()


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
    cf = sp.host_constants(C, meta)
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
        rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
        kernels["stiffness_pairs" if name == "linear" else "stiffness_pairs (hex8 laplace, B)"].update(rec)
        if name == "linear":
            stiffness_row_padding(sp, X, op, params, tab, smi)
        free_memory()
        log(f"stiffness_pairs {name} launch (hex8): {sp.launch_layout(op, params, tab)}")

    # entry B: the public element-stiffness entry point with kernel="auto", each operator
    for name, (op, params) in cases.items():
        rec = kernels["stiffness_pairs" if name == "linear" else "stiffness_pairs (hex8 laplace, B)"]
        s = op.solution_dim
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec["launches"] = rec["fn"].launches
        log(f"entry B: assemble_element_elliptic_matrices_pairs(kernel='auto') {name} res={RES_B}: {tuple(A.shape)} "
            f"in {wall * 1e3:.3f} ms, stiffness_pairs launches={rec['launches']} ({smi})")
        check(tuple(A.shape) == (s * s, 64, E) and bool(torch.isfinite(A).all()),
              f"entry B {name}: wrong or non-finite output")
        check(rec["launches"] > 0, f"entry B {name}: the stiffness kernel was not launched")
        del A
        free_memory()
    del X
    free_memory()


def stiffness_record(cell, name, kind):
    """The kernel line's record of the stiffness kernel on a 3D cell: B20's and B10's linear records keep
    their names."""
    return f"stiffness_pairs ({name}, {cell})" if kind == "linear" else f"stiffness_pairs ({name} {kind}, {cell})"


def stiffness_element_phases(kernels, dev, smi):
    """Entry B20/B10: the stiffness kernel on hex20 and tet10 at full width, linear elasticity and Laplace:
    against its plain version (rel <= KERNEL_RTOL, bitwise repeats), timed in turns with it, bound and M
    elements/s, each operator's record; the public entry point with kernel="auto" under reset counts, each
    operator (its launches go to the record); then the kernel and its plain version at bench.py's own sizes.
    Then T4, T20 and H27 (STIFFNESS_3D_CELLS) the same, without a bench size.  Returns B20's and B10's meshes
    by element name (P40-tet10 and the element-sweep phases reuse them)."""
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
    cells = {"B20": ("hex20", RES_B20), "B10": ("tet10", RES_B10), **STIFFNESS_3D_CELLS}
    for cell, (name, res) in cells.items():
        t0 = time.perf_counter()
        mesh = element_box(name, res)
        if cell in ("B20", "B10"):
            meshes[cell] = mesh
        mesh_s = time.perf_counter() - t0
        tab = tabulate(mesh.element, canonical_stiffness(name))
        q, m, _ = tab.geo_dphi.shape
        n = tab.dphi.shape[1]
        X = FemSpace.create(mesh, 3, torch.float32, dev).X_geo
        E = X.shape[0]
        log(f"entry {cell}: {name} res {res}: {E} cells, {mesh.num_vertices} nodes, mesh {mesh_s:.3f} s; launches "
            + "; ".join(f"{kind} {sp.launch_layout(op, params, tab)}" for kind, (op, params) in cases.items()))
        del mesh
        for kind, (op, params) in cases.items():
            k = kernels[stiffness_record(cell, name, kind)]
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
            bound_txt = set_bound(k, (X.numel() + s * s * n * n * E) * 4, stiffness_ops(E, m, n, q, s, op.symmetric, 3))
            k.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
            log(f"time stiffness_pairs {name} {kind} {cell}: {txt}; {E / (ms * 1e-3) / 1e6:.2f} M elements/s; "
                f"{bound_txt}, {k['bound_ms'] / ms * 100:.1f}% of it ({smi})")
            free_memory()

            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k["launches"] = k["fn"].launches
            log(f"entry {cell}: assemble_element_elliptic_matrices_pairs(kernel='auto') {name} {kind}: "
                f"{tuple(A.shape)} in {wall * 1e3:.3f} ms, stiffness_pairs launches={k['launches']} ({smi})")
            check(tuple(A.shape) == (s * s, n * n, E) and bool(torch.isfinite(A).all()),
                  f"entry {cell} {kind}: wrong or non-finite output")
            check(k["launches"] > 0, f"entry {cell} {kind}: the stiffness kernel was not launched")
            del A
            free_memory()
        del X
        free_memory()
        if name not in RES_BENCH:
            continue

        # bench.py's own size of this element
        op, params = cases["linear"]
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
    and 2D linear elasticity (s = 2): ptxas lines of the d = 2 instantiations (five forms an element; a spill
    fails the run), each element's launch layout, kernel against plain (rel <= KERNEL_RTOL, bitwise repeats),
    times in turns beside the bound with M elements/s, and the public entry point with kernel="auto" under
    reset counts (its launches go to the record)."""
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    d2 = {n: t for n, t in found.items() if n.split(" (")[-1].split(",")[0] in B2_MESHES}
    for name, txt in d2.items():
        log(f"B2 ptxas {name}: {txt}")
    check(len(d2) == 5 * len(B2_MESHES), f"B2: ptxas reports {len(d2)} of the 2D elements' 25 instantiations: {list(d2)}")
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
        log(f"entry B2: {name} res {res}: {E} cells, {mesh.num_vertices} nodes, mesh {mesh_s:.3f} s; {q} points, "
            f"launches " + "; ".join(f"{kind} {sp.launch_layout(op, params, tab)}" for kind, (op, params) in cases.items()))
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
        p2d_block_dia_from_csr(kernels, captured["csr"][0], mesh, cell, dev, smi)
        matrix = captured["matrix"]
        scalar_kernel_checks(kernels, matrix.bands, matrix.offsets, captured["plan"], dev, smi, cell=cell)
        del captured, matrix
        free_memory()
        meshes[name] = (mesh, rcm_s)
    return meshes


# -- point location, interpolation, I/O and mixed-element assembly -------------------------------------------


def err_phase(dev, smi):
    """ERR: the reference's tri3 error-estimation suite, all samples of ERR_SUMMARY, f64 on the card, as
    tests/test_error_estimation.py runs them with FENRIS_TPU_FULL_CONVERGENCE=1: the L2 and H1-seminorm errors
    of the nodal interpolant of sin(pi x) sin(pi y) on the coarse tri3 squares (rule total_order.triangle(
    ERR_RULE)) against the function itself and against its interpolant on the fine squares, evaluated at the
    coarse quadrature points through ``interpolate_at_points`` and ``interpolate_gradient_at_points`` on the
    fine mesh's ``GridIndex``; each within 1% of the committed value.  Per fine mesh: the index's host build
    seconds, its K and grid, the location and interpolation time, points a second, re-runs and peak memory."""
    import json

    import numpy as np
    import torch

    import fenris_tpu_torch.space as S
    from fenris_tpu_torch import quadrature
    from fenris_tpu_torch.assembly.local import tabulate
    from fenris_tpu_torch.error import estimate_H1_seminorm_error_batched, estimate_L2_error_batched
    from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_tri_mesh_2d as tri_square

    samples = json.load(open(ROOT / ERR_SUMMARY))["samples"]

    def u_fn(p):
        return torch.sin(np.pi * p[:, 0]) * torch.sin(np.pi * p[:, 1])

    def grad_fn(p):
        return np.pi * torch.stack([torch.cos(np.pi * p[:, 0]) * torch.sin(np.pi * p[:, 1]),
                                    torch.sin(np.pi * p[:, 0]) * torch.cos(np.pi * p[:, 1])], -1)

    coarse = {}
    for r in sorted({s["coarse_res"] for s in samples}):
        mesh = tri_square(r)
        X = torch.as_tensor(mesh.cell_points(), device=dev)
        u = u_fn(torch.as_tensor(mesh.points, device=dev))
        coarse[r] = (X, u[torch.as_tensor(mesh.cells, dtype=torch.int64, device=dev)][:, :, None],
                     tabulate(mesh.element, quadrature.total_order.triangle(ERR_RULE)))
    worst = []

    def estimate(s, u_ref, g_ref):
        X, u_el, tab = coarse[s["coarse_res"]]
        l2 = float(estimate_L2_error_batched(X, u_el, u_ref, tab))
        h1 = float(estimate_H1_seminorm_error_batched(X, u_el, g_ref, tab))
        rel = (abs(l2 - s["L2_error"]) / s["L2_error"], abs(h1 - s["H1_semi_error"]) / s["H1_semi_error"])
        worst.append((max(rel), s["coarse_res"], s["fine_res"]))
        check(max(rel) <= 0.01, f"ERR coarse {s['coarse_res']} fine {s['fine_res']}: L2 {l2:.9e} (ref "
              f"{s['L2_error']:.9e}), H1 {h1:.9e} (ref {s['H1_semi_error']:.9e}): rel {rel[0]:.3e}, {rel[1]:.3e} > 1%")
        return rel

    t0 = time.perf_counter()
    for s in samples:
        if s["fine_res"] == 0:
            estimate(s, lambda p: u_fn(p)[:, None], lambda p: grad_fn(p)[:, :, None])
    log(f"ERR analytic: {sum(s['fine_res'] == 0 for s in samples)} samples, {time.perf_counter() - t0:.3f} s")
    for fine in sorted({s["fine_res"] for s in samples} - {0}):
        t0 = time.perf_counter()
        fm = tri_square(fine)
        mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx = S.GridIndex.build(fm)
        build_s = time.perf_counter() - t0
        fu = u_fn(torch.as_tensor(fm.points, device=dev))
        loc_s, npts = [], [0]

        def located(fn, p):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(fm, fu, p, index=idx)[0]
            torch.cuda.synchronize()
            loc_s.append(time.perf_counter() - t)
            npts[0] += p.shape[0]
            return out

        S.location_counts.update(charted=0, reruns=0)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rels = [estimate(s, lambda p: located(S.interpolate_at_points, p),
                         lambda p: located(S.interpolate_gradient_at_points, p))
                for s in samples if s["fine_res"] == fine]
        wall = time.perf_counter() - t0
        log(f"ERR fine {fine}: {fm.num_cells} tri3, {fm.num_vertices} nodes (mesh {mesh_s:.3f} s); GridIndex.build "
            f"{build_s:.3f} s on the host (K {idx.table.shape[1]}, grid {idx.dims.tolist()}); {len(rels)} samples, "
            f"{npts[0]} points located and interpolated in {len(loc_s)} calls: {sum(loc_s) * 1e3:.3f} ms "
            f"({npts[0] / sum(loc_s):.4e} points/s), re-runs {S.location_counts['reruns']}, charted "
            f"{S.location_counts['charted']}; worst rel error {max(max(r) for r in rels):.3e}; wall {wall:.3f} s; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
        del idx, fm, fu
    check(len(worst) == len(samples), f"ERR: {len(worst)} of {len(samples)} samples ran")
    log(f"ERR: {len(worst)} of {len(samples)} samples within 1%; worst {max(worst)[0]:.3e} (coarse {max(worst)[1]}, "
        f"fine {max(worst)[2]})")
    free_memory()


def refined_sphere():
    """The Gmsh sphere (tests/assets/meshes/sphere_tet4_593.msh) refined MSH_LEVELS times, with the seconds."""
    from fenris_tpu_torch.io import load_msh
    from fenris_tpu_torch.mesh.refinement import refine_uniformly_repeat

    t0 = time.perf_counter()
    mesh = refine_uniformly_repeat(load_msh(ROOT / "tests/assets/meshes/sphere_tet4_593.msh"), MSH_LEVELS)
    return mesh, time.perf_counter() - t0


def loc_grid_points(sphere, dev):
    """LOC (b)'s points: a LOC_GRID^3 grid over the sphere's bounding box enlarged by 10%, f64 on ``dev``."""
    import numpy as np
    import torch

    lo, hi = sphere.points.min(0), sphere.points.max(0)
    c, half = (lo + hi) / 2, (hi - lo) / 2 * 1.1
    axis = np.linspace(-1.0, 1.0, LOC_GRID)
    return torch.as_tensor(np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3) * half + c,
                           device=dev)


def loc_phase(sphere, dev, smi):
    """LOC: location and interpolation at 10^6 points.  (a) B10's mesh (tet10 BCC res 40): 10^6 seeded
    (element, xi) pairs, every barycentric coordinate >= 0.01, mapped forward; each must be found at distance 0,
    map back within 1e-12 of the box size, and a quadratic field (tet10's degree) must come back within 1e-10
    relative in values and gradients through ``FixedInterpolator``, whose ``interpolate`` on a 3-component
    field is timed beside its bytes bound.  (b) The refined sphere: a LOC_GRID^3 grid over its bounding box
    enlarged by 10% (about half the points outside), the grid branch; on a seeded subset of LOC_SUBSET points
    the brute-force branch must agree: distances within 1e-12, equal elements where the nearest is unique by
    more than 1e-9, interpolated values within 1e-12 relative."""
    import numpy as np
    import torch

    import fenris_tpu_torch.space as S

    def locate(mesh, pts, **kw):
        S.location_counts.update(charted=0, reruns=0)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = S.find_closest_element(mesh, pts, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(S.location_counts), torch.cuda.max_memory_allocated() / 1e9

    # (a)
    mesh = element_box("tet10", RES_B10)
    g = np.random.default_rng(61)
    Q = LOC_POINTS
    ei = torch.as_tensor(g.integers(0, mesh.num_cells, Q), device=dev)
    bary = torch.as_tensor(0.01 + 0.96 * g.dirichlet(np.ones(4), Q), device=dev)  # every coordinate >= 0.01
    X4 = torch.as_tensor(mesh.points, device=dev)[torch.as_tensor(mesh.cells[:, :4], dtype=torch.int64, device=dev)[ei]]
    x = (bary[:, :, None] * X4).sum(1)
    del X4
    t0 = time.perf_counter()
    idx = S.GridIndex.build(mesh)
    build_s = time.perf_counter() - t0
    res, loc_s, counts, peak = locate(mesh, x, index=idx)
    found = res.domain_distance
    Xf = torch.as_tensor(mesh.points, device=dev)[torch.as_tensor(mesh.cells[:, :4], dtype=torch.int64,
                                                                   device=dev)[res.element_indices]]
    back = float((mesh.element.geometry.phi(res.reference_coords)[:, None, :] @ Xf)[:, 0].sub(x).abs().max())
    del Xf
    log(f"LOC (a) B10 tet10 res {RES_B10}: {mesh.num_cells} cells, {mesh.num_vertices} nodes, {Q} points; "
        f"GridIndex.build {build_s:.3f} s on the host (K {idx.table.shape[1]}, grid {idx.dims.tolist()}); location "
        f"{loc_s * 1e3:.3f} ms ({Q / loc_s:.4e} points/s), re-runs {counts['reruns']}, charted {counts['charted']}, "
        f"peak memory {peak:.2f} GB; found at distance 0: {int((found == 0).sum())} of {Q}; max |T(xi) - x| "
        f"{back:.3e} (box size 1); same element as drawn: {int((res.element_indices == ei).sum())} ({smi})")
    check(bool((found == 0).all()), f"LOC (a): {int((found != 0).sum())} points not found at distance 0")
    check(bool((res.element_indices == ei).all()),
          f"LOC (a): {int((res.element_indices != ei).sum())} points found in another element than drawn")
    check(back <= 1e-12, f"LOC (a): a located point maps back {back:.3e} away")
    a = torch.tensor([0.3, -0.7, 0.5], dtype=torch.float64, device=dev)

    def quad_field(p):
        return 1.0 + p @ a + p[:, 0] * p[:, 2] + p[:, 1] ** 2

    def quad_grad(p):
        return a + torch.stack([p[:, 2], 2 * p[:, 1], p[:, 0]], -1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fixed = S.FixedInterpolator.from_space_and_points(mesh, x, with_gradients=True, index=idx)
    torch.cuda.synchronize()
    build_fixed = time.perf_counter() - t0
    u = quad_field(torch.as_tensor(mesh.points, device=dev))
    ref_v, ref_g = quad_field(x), quad_grad(x)
    rel_v = float((fixed.interpolate(u)[:, 0] - ref_v).abs().max() / ref_v.abs().max())
    rel_g = float((fixed.interpolate_gradient(u)[:, :, 0] - ref_g).abs().max() / ref_g.abs().max())
    u3 = torch.randn(mesh.num_vertices * 3, generator=torch.Generator(device=dev).manual_seed(62), device=dev,
                     dtype=torch.float64)
    ms = min(event_ms(lambda: fixed.interpolate(u3, 3), 10), event_ms(lambda: fixed.interpolate(u3, 3), 10))
    n = fixed.nodes.shape[1]
    nbytes = Q * n * (fixed.nodes.element_size() + fixed.phi.element_size()) + u3.numel() * 8 + Q * 3 * 8
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"LOC (a) FixedInterpolator: built in {build_fixed:.3f} s (location and basis); the quadratic field "
        f"rel error values {rel_v:.3e}, gradients {rel_g:.3e}; interpolate of a 3-component field at {Q} points: "
        f"{ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s), bytes bound {bound:.4f} ms ({nbytes / 1e9:.4f} GB: "
        f"nodes, basis values, the field and the output once each), {bound / ms * 100:.1f}% of it ({smi})")
    check(rel_v <= 1e-10 and rel_g <= 1e-10, f"LOC (a): quadratic field rel errors {rel_v:.3e}, {rel_g:.3e} > 1e-10")
    del mesh, idx, res, fixed, x, u, u3, ref_v, ref_g
    free_memory()

    # (b)
    P = loc_grid_points(sphere, dev)
    t0 = time.perf_counter()
    idx = S.GridIndex.build(sphere)
    build_s = time.perf_counter() - t0
    grid, grid_s, counts, peak = locate(sphere, P, index=idx)
    outside = int((grid.domain_distance > 0).sum())
    log(f"LOC (b) sphere: {sphere.num_cells} tets, {P.shape[0]} grid points, {outside} outside; GridIndex.build "
        f"{build_s:.3f} s (K {idx.table.shape[1]}, grid {idx.dims.tolist()}); grid branch {grid_s:.3f} s "
        f"({P.shape[0] / grid_s:.4e} points/s), charted {counts['charted']}, re-runs {counts['reruns']}, peak "
        f"memory {peak:.2f} GB ({smi})")
    check(bool(torch.isfinite(grid.domain_distance).all()), "LOC (b): a non-finite distance")
    sub = torch.as_tensor(np.sort(np.random.default_rng(63).choice(P.shape[0], LOC_SUBSET, replace=False)),
                          device=dev)
    brute, brute_s, bcounts, _ = locate(sphere, P[sub])
    g_sub = [t[sub] for t in grid]
    d_err = float((g_sub[2] - brute.domain_distance).abs().max())
    # the nearest is unique where the second best among the 32 nearest boxes, or the 33rd box's distance (a
    # lower bound of every other element's), exceeds the best by 1e-9
    a_ = S._mesh_arrays(sphere, dev, torch.float64)
    cand, box_d, _ = S._brute_candidates(a_, P[sub], 33)
    Xc = a_["X"][cand[:, :32].reshape(-1)]
    d_all = S.closest_point_in_element(sphere.element, Xc, P[sub].repeat_interleave(32, 0))[2].reshape(-1, 32)
    d_sorted = d_all.sort(1).values
    unique = torch.minimum(d_sorted[:, 1], box_d[:, 32]) - d_sorted[:, 0] > 1e-9
    same = bool((g_sub[0] == brute.element_indices)[unique].all())
    u = torch.randn(sphere.num_vertices, generator=torch.Generator(device=dev).manual_seed(64), device=dev,
                    dtype=torch.float64)
    cells = torch.as_tensor(sphere.cells, dtype=torch.int64, device=dev)

    def values(ei_, xi_):
        return (sphere.element.phi(xi_) * u[cells[ei_]]).sum(1)

    vb = values(brute.element_indices, brute.reference_coords)
    v_err = float((values(g_sub[0], g_sub[1]) - vb).abs().max() / vb.abs().max())
    log(f"LOC (b) grid against brute force on {LOC_SUBSET} points ({int((brute.domain_distance > 0).sum())} outside): "
        f"brute force {brute_s:.3f} s (re-runs {bcounts['reruns']}); max distance difference {d_err:.3e}; "
        f"{int(unique.sum())} with a unique nearest element, the same element on all of them: {same}; values rel "
        f"{v_err:.3e} ({smi})")
    check(d_err <= 1e-12, f"LOC (b): distances differ by {d_err:.3e}")
    check(same, "LOC (b): another element where the nearest is unique")
    check(v_err <= 1e-12, f"LOC (b): interpolated values differ by rel {v_err:.3e}")
    del idx, grid, brute, P, a_, cand, Xc, d_all
    free_memory()


def msh_phase(kernels, sphere, refine_s, dev, smi):
    """MSH: every Gmsh fixture (tests/assets/meshes, tests/test_io.py's cell counts) from its ASCII file and
    from binary rewrites in both byte orders (tests/msh_fixtures.py), the same points and cells each time;
    then the refined sphere, RCM-reordered on the card, Neo-Hookean under gravity BODY_A with the cap z <
    MSH_CAP_Z clamped: the fused banded model's f32 ``solve_mixed`` to 1e-10 checked by an independent f64
    residual (element_solve) after the gather, scatter and fused sweeps were checked and timed at this layout;
    the deformed mesh's VTU parsed back with xml.etree (counts, connectivity, the displacement exactly); a
    checkpoint saved and loaded bitwise; and the f64 model's ``solve`` resumed from the loaded state with
    tolerance 1e-10 ||F(0)|| converged at iteration 0."""
    import tempfile
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.io import FiniteElementMeshDataSetBuilder, load_checkpoint, load_msh, load_msh_from_bytes
    from fenris_tpu_torch.io import save_checkpoint
    from fenris_tpu_torch.mesh.reorder import reorder_mesh
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    sys.path.insert(0, str(ROOT / "tests"))
    from msh_fixtures import FIXTURES, MESH_DIR, msh_to_binary

    t0 = time.perf_counter()
    for fname, eltype, ncells in FIXTURES:
        ascii_mesh = load_msh(MESH_DIR / fname)
        check(ascii_mesh.element.name == eltype and ascii_mesh.num_cells == ncells,
              f"MSH {fname}: {ascii_mesh.element.name} x {ascii_mesh.num_cells}, expected {eltype} x {ncells}")
        text = (MESH_DIR / fname).read_text()
        for order in ("<", ">"):
            m = load_msh_from_bytes(msh_to_binary(text, order))
            check(np.array_equal(m.points, ascii_mesh.points) and np.array_equal(m.cells, ascii_mesh.cells),
                  f"MSH {fname}: the binary ({order}) file gives other points or cells")
    log(f"MSH: {len(FIXTURES)} fixtures loaded, ASCII and binary in both byte orders, {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, _ = reorder_mesh(sphere, device=dev)
    rcm_s = time.perf_counter() - t0
    clamped = np.flatnonzero(mesh.points[:, 2] < MSH_CAP_Z)

    def model_of(mesh_, dtype, **kw):
        return HyperelasticModel(mesh=mesh_, material=NeoHookeanMaterial(), params=LameParameters(mu=MU, lam=LAM),
                                 dirichlet_nodes=clamped, body_force=np.array(BODY_A), dtype=dtype, device=dev, **kw)

    t0 = time.perf_counter()
    model = model_of(mesh, torch.float32, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    log(f"MSH sphere: {mesh.num_cells} tet4, {mesh.num_vertices} nodes, {model.space.num_dofs} dofs, {len(clamped)} "
        f"nodes clamped (z < {MSH_CAP_Z}); refinement {refine_s:.3f} s, RCM on the card {rcm_s:.3f} s, fused model "
        f"{model_s:.3f} s ({smi})")
    element_sweep_checks(kernels, model, "MSH", dev, smi, materials=("neo_hookean",), key="tet4 sphere")
    check_model = lambda mesh_: model_of(mesh_, torch.float64, chunk_size=8192)  # noqa: E731
    x64 = element_solve(kernels, model, solve_records("tet4 sphere", "neo_hookean", 3, True), "MSH",
                        refine_s + rcm_s + model_s, dev, smi, mixed=True, check_model=check_model)
    del model
    free_memory()
    u = x64.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        deformed = mesh.transform_points(lambda p: p + u.reshape(-1, 3))
        t0 = time.perf_counter()
        (FiniteElementMeshDataSetBuilder.from_mesh(deformed).with_title("Neo-Hookean sphere")
         .with_point_vector_attributes("displacement", u).try_export(Path(tmp) / "sphere.vtu"))
        write_s = time.perf_counter() - t0
        nbytes = (Path(tmp) / "sphere.vtu").stat().st_size
        t0 = time.perf_counter()
        piece = ET.parse(Path(tmp) / "sphere.vtu").getroot().find(".//Piece")
        conn = np.array(piece.find(".//Cells/DataArray[@Name='connectivity']").text.split(), dtype=np.int64)
        disp = np.array(piece.find(".//PointData/DataArray[@Name='displacement']").text.split(), dtype=np.float64)
        pts = np.array(piece.find(".//Points/DataArray").text.split(), dtype=np.float64).reshape(-1, 3)
        parse_s = time.perf_counter() - t0
        ok_vtu = (int(piece.get("NumberOfPoints")) == mesh.num_vertices and int(piece.get("NumberOfCells")) ==
                  mesh.num_cells and np.array_equal(conn.reshape(mesh.cells.shape), mesh.cells) and
                  np.array_equal(disp, u) and np.array_equal(pts, deformed.points))
        log(f"MSH VTU: {nbytes / 1e6:.3f} MB written in {write_s:.3f} s, parsed back in {parse_s:.3f} s; counts, "
            f"connectivity, points and displacement (.17g) exact: {ok_vtu}")
        check(ok_vtu, "MSH: the VTU file does not give back the mesh and its displacement")
        t0 = time.perf_counter()
        save_checkpoint(Path(tmp) / "sphere.npz", mesh=mesh, u=x64, newton_iterations=np.asarray(0))
        loaded_mesh, state = load_checkpoint(Path(tmp) / "sphere.npz")
        ckpt_s = time.perf_counter() - t0
    ok_ckpt = (np.array_equal(loaded_mesh.points, mesh.points) and np.array_equal(loaded_mesh.cells, mesh.cells)
               and loaded_mesh.element is mesh.element and np.array_equal(state["u"], u) and state["u"].dtype == u.dtype)
    log(f"MSH checkpoint: saved and loaded in {ckpt_s:.3f} s; mesh and state bitwise equal: {ok_ckpt}")
    check(ok_ckpt, "MSH: the loaded checkpoint differs")
    fresh = check_model(loaded_mesh)
    f0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    t0 = time.perf_counter()
    res = fresh.solve(u0=torch.as_tensor(state["u"], device=dev), tolerance=1e-10 * f0)
    torch.cuda.synchronize()
    log(f"MSH resume: the f64 model's solve from the loaded state, tolerance 1e-10 ||F(0)|| = {1e-10 * f0:.6e}: status "
        f"{res.status}, {res.iterations} iterations, |F| {float(res.residual_norm):.6e}, {time.perf_counter() - t0:.3f} s")
    check(res.status == NEWTON_CONVERGED and res.iterations == 0,
          f"MSH: the resumed solve reports status {res.status} after {res.iterations} iterations")
    del fresh, res, x64
    free_memory()


def mixed_square(nq):
    """The unit square as quad4 on [0, 0.5] x [0, 1] (nq x 2nq cells) and tri3 split from quads on [0.5, 1] x
    [0, 1], the nodes merged by their coordinates (tests/test_aggregate.py:19-36): ``(points, quad cells, tri
    cells)``."""
    import numpy as np

    from fenris_tpu_torch.mesh.procedural import create_rectangular_uniform_quad_mesh_2d

    quads = create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, nq, (0.0, 1.0))
    tris = create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, nq, (0.5, 1.0)).split_into_triangles()
    uniq, inverse = np.unique(np.round(np.concatenate([quads.points, tris.points]), 12), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    return uniq, inverse[quads.cells.astype(np.int64)], inverse[tris.cells.astype(np.int64) + quads.num_vertices]


def agg_phase(dev, smi):
    """AGG: mixed-element Poisson at about 1M nodes (mixed_square(AGG_RES)): Laplace element matrices through
    one UniformQuadratureTable per block, and on the quad block also through a GeneralQuadratureTable of two
    groups (Gauss 2 and Gauss 3, both exact on these affine cells; within 1e-12 relative); the aggregate
    pattern on the card and two assemblies (bitwise equal); interior row sums <= 1e-12 max|A|; f64 Jacobi CG on
    the CSR product for u = 1 + x + 2y with its boundary values (both elements reproduce it) to AGG_CG_TOL,
    the max nodal error <= 1e-8; pattern, assembly and solve seconds and the product's GB/s."""
    import numpy as np
    import torch

    from fenris_tpu_torch import quadrature
    from fenris_tpu_torch.assembly.aggregate import aggregate_csr_pattern, assemble_aggregate_csr
    from fenris_tpu_torch.assembly.global_ import apply_homogeneous_dirichlet_bc_csr
    from fenris_tpu_torch.assembly.quadrature_table import GeneralQuadratureTable, UniformQuadratureTable
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.reference_elements import QUAD4, TRI3
    from fenris_tpu_torch.sparse.cg import CG_CONVERGED, conjugate_gradient
    from fenris_tpu_torch.sparse.csr import from_pattern

    t0 = time.perf_counter()
    pts, qcells, tcells = mixed_square(AGG_RES)
    mesh_s = time.perf_counter() - t0
    N = len(pts)
    op = LaplaceOperator()
    times = {}

    def sync_time(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t
        return out

    Xq = torch.as_tensor(pts[qcells], device=dev)
    Xt = torch.as_tensor(pts[tcells], device=dev)
    Aq = sync_time("quad matrices", lambda: UniformQuadratureTable.from_rule(QUAD4, quadrature.quadrilateral_gauss(2))
                   .assemble_elliptic_matrices(Xq, None, op))
    At = sync_time("tri matrices", lambda: UniformQuadratureTable.from_rule(TRI3, quadrature.total_order.triangle(2))
                   .assemble_elliptic_matrices(Xt, None, op))
    ids = np.arange(len(qcells)) % 2
    general = GeneralQuadratureTable.from_rules(QUAD4, [quadrature.quadrilateral_gauss(2),
                                                        quadrature.quadrilateral_gauss(3)], ids)
    Ag = sync_time("general quad matrices", lambda: general.assemble_elliptic_matrices(Xq, None, op))
    rel_tables = float((Ag - Aq).abs().max() / Aq.abs().max())
    del Ag, Xq, Xt
    agg = sync_time("pattern", lambda: aggregate_csr_pattern([qcells, tcells], N, 1, device=dev))
    sync_time("scatter layers", lambda: agg.block_plans)
    values = sync_time("assembly", lambda: assemble_aggregate_csr([Aq, At], agg))
    again = assemble_aggregate_csr([Aq, At], agg)
    same = bool(torch.equal(values, again))
    del again
    p = agg.pattern
    amax = float(values.abs().max())
    sums = torch.zeros(N, dtype=values.dtype, device=dev).index_add_(0, p.rows_of_nnz.long(), values)
    interior = torch.as_tensor((pts[:, 0] > 1e-9) & (pts[:, 0] < 1 - 1e-9) & (pts[:, 1] > 1e-9) & (pts[:, 1] < 1 - 1e-9),
                               device=dev)
    row_sum = float(sums[interior].abs().max())
    x = torch.as_tensor(pts, device=dev)
    exact = 1.0 + x[:, 0] + 2.0 * x[:, 1]
    boundary = np.flatnonzero(~interior.cpu().numpy())
    g = torch.where(interior, 0.0, exact)
    A = from_pattern(p, values)
    rhs = torch.where(interior, -(A @ g), 0.0)
    Ah = from_pattern(p, apply_homogeneous_dirichlet_bc_csr(values, p, boundary))
    inv_diag = 1.0 / Ah.diagonal()
    cg = sync_time("solve", lambda: conjugate_gradient(Ah, rhs, preconditioner=lambda v: inv_diag * v,
                                                       rel_tolerance=AGG_CG_TOL, max_iter=100000))
    err = float((g + cg.x - exact).abs().max())
    y = Ah @ rhs
    sp = Ah.sparse
    nbytes = (Ah.nnz * (Ah.values.element_size() + sp.col_indices().element_size())
              + sp.crow_indices().numel() * sp.crow_indices().element_size() + 2 * N * 8)
    ms = min(event_ms(lambda: Ah @ rhs, reps=20), event_ms(lambda: Ah @ rhs, reps=20))
    log(f"AGG: mixed square res {AGG_RES}: {len(qcells)} quad4 + {len(tcells)} tri3 = {len(qcells) + len(tcells)} cells "
        f"on {N} nodes (mesh and node merge {mesh_s:.3f} s on the host), nnz {p.nnz}; general table (Gauss 2 and 3 "
        f"groups) against the uniform one on the quads: rel {rel_tables:.3e}; two assemblies bitwise equal: {same}; "
        f"interior row sums max {row_sum:.3e} (max|A| {amax:.6e}); Jacobi CG to {AGG_CG_TOL:g}: status "
        f"{cg.status}, {cg.num_iterations} iterations, max nodal error {err:.3e}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; CSR product {ms:.4f} ms, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s ({nbytes / 1e9:.4f} GB) ({smi})")
    check(bool(torch.isfinite(y).all()), "AGG: non-finite CSR product")
    check(rel_tables <= 1e-12, f"AGG: the two tables' matrices differ by rel {rel_tables:.3e}")
    check(same, "AGG: two assemblies differ")
    check(row_sum <= 1e-12 * amax, f"AGG: interior row sum {row_sum:.3e} > 1e-12 max|A|")
    check(cg.status == CG_CONVERGED, f"AGG: CG status {cg.status}")
    check(err <= 1e-8, f"AGG: max nodal error {err:.3e} > 1e-8")
    del values, sums, A, Ah, cg, Aq, At, agg
    free_memory()


def p2d_block_dia_from_csr(kernels, A, mesh, cell, dev, smi):
    """P2D's CSR matrix ``A`` (f32) through ``block_dia_from_csr`` (bands for the node deltas on at least
    MMS_MIN_FILL of the rows, the rest in the block-ELL remainder) and the band sweep kernel: the operator
    against the CSR product (rel <= KERNEL_RTOL), the sweep against its plain version, timed beside its bound
    and cuSPARSE, into the record ``dia_sweep (s=1, {cell}, from CSR)``."""
    import torch

    import fenris_tpu_torch.assembly.global_ as G
    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.sparse.block_dia import block_dia_from_csr
    from fenris_tpu_torch.sparse.dia_kernel import block_dia_operator

    pattern = G.csr_pattern(mesh.cells, mesh.num_vertices, 1, device=dev)
    check(torch.equal(pattern.col_indices, A.col_indices) and torch.equal(pattern.row_ptr, A.row_ptr),
          f"{cell}: the CSR route's matrix has another pattern")
    N = mesh.num_vertices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = block_dia_from_csr(pattern, A.values, min_count=int(MMS_MIN_FILL * N))
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(71), device=dev)
    k = kernels[f"dia_sweep (s=1, {cell}, from CSR)"]
    ds.dia_sweep.launches = 0
    y = block_dia_operator(m, kernel=True)(x)
    k["launches"] = ds.dia_sweep.launches
    ref = A @ x
    rel = float((y.double() - ref.double()).abs().max() / ref.double().abs().max())
    rem = m.remainder
    log(f"{cell} block_dia_from_csr: {len(m.offsets)} bands, remainder width "
        f"{0 if rem is None else rem.neighbors.shape[0]}, {conv_s:.3f} s; band sweep kernel plus remainder against "
        f"the CSR product: rel {rel:.3e} (limit {KERNEL_RTOL:g}); sweep launches {k['launches']}")
    check(rel <= KERNEL_RTOL and k["launches"] == 1, f"{cell}: block_dia_from_csr through the band sweep: rel {rel:.3e}")
    x2 = x.reshape(1, N)
    txt = f"{cell} from CSR s=1 N={N} D={len(m.offsets)}"
    k["max_abs_err"] = compare("dia_sweep", txt, ds.dia_sweep(m.bands, m.offsets, x2), ds.dia_sweep(m.bands, m.offsets, x2),
                               ds.dia_sweep_plain(m.bands, m.offsets, x2))
    k["ms"], k["plain_ms"], ttxt = in_turns(lambda: ds.dia_sweep(m.bands, m.offsets, x2),
                                            lambda: ds.dia_sweep_plain(m.bands, m.offsets, x2))
    bound_txt = set_bound(k, (m.bands.numel() + 2 * N) * 4, 2 * m.bands.numel())
    k["library_ms"] = csr_library_ms(m._replace(remainder=None), x2, ds.dia_sweep(m.bands, m.offsets, x2), smi)
    log(f"time dia_sweep {txt}: {ttxt}, library {k['library_ms']:.4f} ms; {bound_txt} ({smi})")
    del m, pattern
    free_memory()


# -- geometry, helpers and profiling, the sharded classes -----------------------------------------------
# GEO: the procedural sphere (procedural.rs:405) of GEO_SWEEPS x GEO_SWEEPS tangent clips, triangulated,
# welded, refined until it has GEO_MIN_TETS tets (four levels: 1,081,344), RCM'd, Neo-Hookean under gravity
# BODY_A with the cap z < GEO_CAP_Z clamped (MSH's cap on the Gmsh sphere of radius 0.5, scaled to radius 1).
# UTIL: the helpers of utils.py on GEO's deformation gradients at the points of the degree-UTIL_RULE
# tetrahedron rule (4 a tet: 4,325,376 matrices; the tet4 stiffness rule has one).  PAR: PAR_WORLD ranks on
# cuda:0 over gloo against the single-process models, max |diff| / max |ref| <= PAR_RTOL: operator
# applications in f32, the halo Newton solve and the block-DIA CG in f64 (two f32 Krylov solves can differ
# by up to about eps_f32 x kappa), the banded Newton solve in f32 on its kernels, PAR_B_NEWTON steps from
# zero on both sides (its ranks sum each node's rows in the single plan's order but at the ranks' seam)
GEO_SWEEPS = 8
GEO_MIN_TETS = 1_000_000
GEO_CAP_Z = -0.9
UTIL_RULE = 2
PAR_WORLD = 2
PAR_RTOL = 1e-5
PAR_REPS = 5
PAR_TIMEOUT_S = 400
RES_PAR_H = 32  # the halo class's Newton solve
PAR_NEWTON_TOL = 1e-6  # relative to ||F(0)||
PAR_B_NEWTON = 2  # Newton steps of the f32 banded solve


def weld(mesh, tol):
    """``mesh`` with vertices closer than ``tol`` merged into the first of them and the cells that lose their
    volume (below 1e-12 of the largest) dropped; returns it, the merged vertices and the dropped cells."""
    import numpy as np

    pts, rep = mesh.points, np.arange(mesh.num_vertices)
    for i in range(mesh.num_vertices):
        if rep[i] == i:
            close = np.flatnonzero(np.linalg.norm(pts[i + 1 :] - pts[i], axis=1) <= tol) + i + 1
            rep[close[rep[close] == close]] = i
    cells = rep[mesh.cells]
    v = pts[cells]
    vol = np.abs(np.linalg.det(v[:, 1:] - v[:, :1]))
    keep = np.flatnonzero(vol > 1e-12 * vol.max())
    welded = type(mesh)(pts, cells, mesh.element).keep_cells(keep)
    return welded, int((rep != np.arange(mesh.num_vertices)).sum()), mesh.num_cells - len(keep)


def geo_phase(kernels, dev, smi):
    """GEO: the sphere's PolyMesh volume against 4π/3 and its triangulation's, the triangulation welded (the
    clips leave coincident vertices where a plane passes through a vertex or an edge, so some fan tets have no
    volume), the refinement to GEO_MIN_TETS tets, the RCM and the fused banded model's ``solve_mixed``
    (element_solve: rows 6-8 under reset counts, the independent f64 residual <= 1e-10).  Returns (mesh, f64
    solution, the f32 model)."""
    import math

    import numpy as np
    import torch

    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.mesh.procedural import create_simple_stupid_sphere
    from fenris_tpu_torch.mesh.refinement import refine_uniformly
    from fenris_tpu_torch.mesh.reorder import reorder_mesh
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    t0 = time.perf_counter()
    pm = create_simple_stupid_sphere([0.0, 0.0, 0.0], 1.0, GEO_SWEEPS)
    volume = pm.volume()
    tets = pm.triangulate()
    host_s = time.perf_counter() - t0
    v = tets.points[tets.cells]
    tet_volume = float((np.abs(np.linalg.det(v[:, 1:] - v[:, :1])) / 6.0).sum())
    ball = 4.0 / 3.0 * math.pi
    log(f"GEO sphere ({GEO_SWEEPS} x {GEO_SWEEPS} clips): {len(pm.faces)} faces, {pm.num_cells} cell, volume "
        f"{volume:.15f} = {volume / ball:.6f} x 4π/3, its {tets.num_cells}-tet triangulation {tet_volume:.15f} "
        f"(rel {abs(tet_volume - volume) / volume:.3e}); host geometry {host_s:.3f} s")
    check(0.8 * ball < volume < 1.5 * ball, f"GEO: sphere volume {volume / ball:.4f} x 4π/3 outside (0.8, 1.5)")
    check(abs(tet_volume - volume) <= 1e-12 * volume, "GEO: the triangulation's volume differs from the PolyMesh's")
    t0 = time.perf_counter()
    mesh, merged, dropped = weld(tets, 1e-12)
    v = mesh.points[mesh.cells]
    welded_volume = float((np.abs(np.linalg.det(v[:, 1:] - v[:, :1])) / 6.0).sum())
    log(f"GEO weld: {merged} coincident vertices merged, {dropped} tets without volume dropped, {mesh.num_cells} "
        f"tets on {mesh.num_vertices} vertices, volume {welded_volume:.15f}; {time.perf_counter() - t0:.3f} s")
    check(abs(welded_volume - volume) <= 1e-12 * volume, "GEO: welding changed the volume")
    levels = 0
    while mesh.num_cells < GEO_MIN_TETS:
        mesh, levels = refine_uniformly(mesh), levels + 1
    refine_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, _ = reorder_mesh(mesh, device=dev)
    clamped = np.flatnonzero(mesh.points[:, 2] < GEO_CAP_Z)

    def model_of(mesh_, dtype, **kw):
        return HyperelasticModel(mesh=mesh_, material=NeoHookeanMaterial(), params=LameParameters(mu=MU, lam=LAM),
                                 dirichlet_nodes=clamped, body_force=np.array(BODY_A), dtype=dtype, device=dev, **kw)

    model = model_of(mesh, torch.float32, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"GEO mesh: {levels} refinements to {mesh.num_cells} tet4, {mesh.num_vertices} nodes, {model.space.num_dofs} "
        f"dofs, {len(clamped)} nodes clamped (z < {GEO_CAP_Z}); refinement {refine_s:.3f} s, RCM and fused model "
        f"{setup_s:.3f} s ({smi})")
    # the scatter's walk on GEO's plan, held bitwise to the plain version (before the solve resets the counts)
    import fenris_tpu_torch.ops.banded as bd

    plan = model._plan
    scatter_walk_log(plan, "banded_scatter (GEO)")
    f_el = torch.randn((plan.padded_elements, plan.n, 3), generator=torch.Generator(device=dev).manual_seed(20),
                       device=dev)
    got, again, ref = bd.banded_scatter(plan, f_el), bd.banded_scatter(plan, f_el), bd.banded_scatter_plain(plan, f_el)
    exact = bool(torch.equal(got, ref) and torch.equal(again, ref))
    log(f"banded_scatter (GEO): two launches bitwise equal to the plain version: {exact}")
    check(exact, "banded_scatter (GEO): not bitwise equal to the plain version")
    del got, again, ref, f_el
    sources = {"tangent": "em_vector_tangent_sweep", "vector": "em_vector_sweep", "gather": "banded_gather",
               "scatter": "banded_scatter"}
    view = {f"{role} (GEO)": {"fn": kernels[name]["fn"]} for role, name in sources.items()}
    x64 = element_solve(view, model, {role: f"{role} (GEO)" for role in sources}, "GEO", host_s + refine_s + setup_s,
                        dev, smi, mixed=True, check_model=lambda mesh_: model_of(mesh_, torch.float64, chunk_size=8192))
    log(f"GEO launches of the solve: {({name: rec['launches'] for name, rec in view.items()})}")
    return mesh, x64, model


def deformation_gradients(mesh, x64, rule, dev):
    """F = I + grad u ``[E * q, 3, 3]`` (f64) at the points of ``rule`` in every cell of a tet4 mesh."""
    import torch

    from fenris_tpu_torch.assembly.local import tabulate

    tab = tabulate(mesh.element, rule)
    dphi = torch.as_tensor(tab.dphi, device=dev)  # [q, n, 3]
    cells = torch.as_tensor(mesh.cells, device=dev).long()
    X = torch.as_tensor(mesh.points, device=dev)[cells]  # [E, n, 3]
    U = x64.reshape(-1, 3)[cells]
    J = torch.einsum("eni,qnj->eqij", X, dphi)
    G = torch.einsum("eni,qnj,eqjk->eqik", U, dphi, torch.linalg.inv(J))
    return (G + torch.eye(3, dtype=G.dtype, device=dev)).reshape(-1, 3, 3)


def util_phase(geo, dev, smi):
    """UTIL: rotation_svd, polar_decomposition, apd and extremal_eigenvalues in f64 and f32 on GEO's
    deformation gradients, timed; RᵀR = I, det R = +1, F = RS with S symmetric, U and V proper rotations,
    apd's rotation against the SVD's; then profiling.trace around one Hessian action of GEO's model."""
    import tempfile

    import torch

    import fenris_tpu_torch.utils as tu
    from fenris_tpu_torch import profiling
    from fenris_tpu_torch.quadrature.total_order import tetrahedron

    mesh, x64, model = geo
    F64 = deformation_gradients(mesh, x64, tetrahedron(UTIL_RULE), dev)
    limits = {torch.float64: {"rotation": 1e-12, "apd": 1e-6}, torch.float32: {"rotation": 1e-5, "apd": 1e-4}}
    log(f"UTIL: {F64.shape[0]} deformation gradients of GEO ({mesh.num_cells} tets x {F64.shape[0] // mesh.num_cells} "
        f"points), max |F - I| {float((F64 - torch.eye(3, dtype=F64.dtype, device=dev)).abs().max()):.4e}")
    for dtype in (torch.float64, torch.float32):
        F = F64.to(dtype)
        C = F.transpose(1, 2) @ F
        calls = {"rotation_svd": lambda: tu.rotation_svd(F), "polar_decomposition": lambda: tu.polar_decomposition(F),
                 "apd": lambda: tu.apd(F), "extremal_eigenvalues": lambda: tu.extremal_eigenvalues(C)}
        # each helper once for the checks (its warm-up), then once timed (a call takes 0.1-1.5 s)
        outs = {name: fn() for name, fn in calls.items()}
        ms = {name: event_ms(fn, reps=1, warmup=0) for name, fn in calls.items()}
        U, s, V = (t.double() for t in outs["rotation_svd"])
        R, S = (t.double() for t in outs["polar_decomposition"])
        Ra = outs["apd"].double()
        lo, hi = (t.double() for t in outs["extremal_eigenvalues"])
        eye = torch.eye(3, dtype=torch.float64, device=dev)
        Fd = F.double()
        top = lambda t: float(t.abs().max())  # noqa: E731
        errs = {
            "|RᵀR - I|": top(R.transpose(1, 2) @ R - eye),
            "|det R - 1|": top(torch.linalg.det(R) - 1.0),
            "|det U - 1|, |det V - 1|": max(top(torch.linalg.det(U) - 1.0), top(torch.linalg.det(V) - 1.0)),
            "|RS - F| / |F|": top(R @ S - Fd) / top(Fd),
            "|S - Sᵀ| / |S|": top(S - S.transpose(1, 2)) / top(S),
            "|U diag(s) Vᵀ - F| / |F|": top(U @ (s[:, :, None] * V.transpose(1, 2)) - Fd) / top(Fd),
        }
        apd_err = float((Ra - R).abs().max())
        log(f"UTIL {str(dtype)[6:]}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
            f", |apd - R_svd| {apd_err:.3e}; eigenvalues of FᵀF in [{float(lo.min()):.6f}, {float(hi.max()):.6f}]; "
            "ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" ({smi})")
        lim = limits[dtype]
        check(all(v <= lim["rotation"] for v in errs.values()), f"UTIL {dtype}: a rotation check failed: {errs}")
        check(apd_err <= lim["apd"], f"UTIL {dtype}: apd against the SVD rotation {apd_err:.3e} > {lim['apd']}")
        check(bool((lo > 0).all()) and bool((lo <= hi).all()), f"UTIL {dtype}: FᵀF not positive definite")
        del U, s, V, R, S, Ra, F, C, outs
        free_memory()
    u = x64.float()
    v = torch.randn(u.shape, generator=torch.Generator(device=dev).manual_seed(61), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp) as prof:
            model.hessian_vector_product(u, v)
            torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        files = list(Path(tmp).glob("*.pt.trace.json"))
        nbytes = sum(f.stat().st_size for f in files)
        kernels_in_file = [e for f in files for e in json.loads(f.read_text()).get("traceEvents", [])
                           if e.get("cat") == "kernel"]
    busy_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    log(f"UTIL profiling.trace around one Hessian action of GEO's model: {len(files)} trace file(s), {nbytes} bytes, "
        f"{len(kernels_in_file)} kernels in it ({sum(e.get('dur', 0) for e in kernels_in_file) / 1e3:.3f} ms), "
        f"device busy by key_averages {busy_us / 1e3:.3f} ms, {trace_s:.3f} s with the export ({smi})")
    check(len(files) == 1 and nbytes > 0, "UTIL: profiling.trace wrote no trace file")
    check(len(kernels_in_file) > 0 and busy_us > 0, "UTIL: profiling.trace recorded no device time")
    del F64
    free_memory()


# -- PAR: the sharded classes, PAR_WORLD ranks on cuda:0 ----------------------------------------------


def par_problems(dev):
    """The PAR problems' builders, alike in the parent and in each rank: ``{part: builder}``."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    mesh149, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(RES_A), device=dev)
    mesh63, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(RES_C3), device=dev)
    return {
        "B": lambda: assembled_model(None, torch.float32, dev, None, mesh=mesh149, banded=True, fused_kernels=True),
        "B-solve": lambda: assembled_model(None, torch.float32, dev, None, mesh=mesh63, banded=True,
                                           fused_kernels=True),
        "E": lambda: assembled_model(None, torch.float32, dev, None, mesh=mesh63),
        "S": lambda: flagship_model(FULL, torch.float32, dev, kernel=False),
        "H-solve": lambda: flagship_model((RES_PAR_H,) * 3, torch.float64, dev),
        "D": lambda: par_d_matrix(dev),
    }


def par_d_matrix(dev):
    """P149's Laplace bands (f64 and f32), its free nodes and seeded inputs: ``(A64, A32, free, v, b)``."""
    import torch

    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import hexahedron_gauss
    from fenris_tpu_torch.sparse.block_dia import BlockDiaMatrix, assemble_block_dia, block_dia_assembly_plan

    mesh = create_unit_box_uniform_hex_mesh_3d(RES_P)
    space = FemSpace.create(mesh, 1, torch.float64, dev)
    plan = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, 1, device=dev)
    A64 = assemble_block_dia(plan, assemble_element_elliptic_matrices(
        space.X_geo, None, LaplaceOperator(), None, tabulate(mesh.element, hexahedron_gauss(2)), chunk=65536),
        num_chunks=4)
    A32 = BlockDiaMatrix(A64.offsets, A64.bands.float(), A64.num_nodes, 1, None)
    free = torch.ones(mesh.num_vertices, dtype=torch.bool, device=dev)
    free[torch.as_tensor(mms_problem()[3](mesh), device=dev)] = False
    g = torch.Generator(device=dev).manual_seed(71)
    v = torch.randn(mesh.num_vertices, generator=g, device=dev, dtype=torch.float64)
    b = torch.where(free, torch.randn(mesh.num_vertices, generator=g, device=dev, dtype=torch.float64), 0.0)
    return A64, A32, free, v, b


def par_inputs(model, seed):
    """A displacement of 1% of a cell and a direction ~ N(0, 1) in the model's dtype."""
    import torch

    if hasattr(model, "space"):
        u = displacement(model, seed)
    else:
        _, ug, _ = kernel_inputs(model.cells, model.device, seed)
        u = torch.where(model.free_mask, model._ungrid(ug).to(model.dtype) * 0.5, 0.0)
    g = torch.Generator(device=model.device).manual_seed(seed + 1)
    return u, torch.randn(u.shape, generator=g, device=model.device).to(model.dtype)


def par_newton(solve, model):
    """The Newton solve of a PAR part: relative tolerance PAR_NEWTON_TOL and CG to 1e-8 in f64; in f32 (the
    banded model on its kernels) C3's CG tolerance 1e-4 and PAR_B_NEWTON steps, as f32 cannot reach it."""
    import torch

    n = model.space.num_dofs if hasattr(model, "space") else model.num_dofs
    f0 = float(torch.linalg.vector_norm(model.residual(torch.zeros(n, dtype=model.dtype, device=model.device))))
    if model.dtype == torch.float32:
        return solve(tolerance=PAR_NEWTON_TOL * f0, cg_rel_tolerance=1e-4, max_newton_iterations=PAR_B_NEWTON)
    return solve(tolerance=PAR_NEWTON_TOL * f0, cg_rel_tolerance=1e-8)


def par_dia_cg(A, b, free):
    """Jacobi CG to 1e-6 on masked bands (the single-process reference of ShardedBlockDia.cg)."""
    import torch

    from fenris_tpu_torch.sparse.cg import conjugate_gradient
    from fenris_tpu_torch.sparse.dia_kernel import block_dia_operator

    op = block_dia_operator(A)
    inv_diag = 1.0 / torch.where(free, A.bands[A.offsets.index(0)], 1.0)
    return conjugate_gradient(lambda x: torch.where(free, op(torch.where(free, x, 0.0)), x), b,
                              preconditioner=lambda x: inv_diag * x, rel_tolerance=1e-6, max_iter=20000,
                              check_definiteness=False)


def par_launches(kernels):
    """Launches since the last reset, by wrapper (records that share a wrapper count once)."""
    wrappers = {id(r["fn"]): r["fn"] for r in kernels.values()}
    return {fn.__name__: fn.launches for fn in wrappers.values() if fn.launches}


def par_references(dev, out):
    """Every PAR reference on the single-process models, saved to ``out`` (CPU tensors); returns its set-up and
    compute seconds."""
    import torch

    from fenris_tpu_torch.sparse.dia_kernel import block_dia_operator

    t0 = t_lap = time.perf_counter()
    P = par_problems(dev)
    ref, status = {}, []

    def lap(what):
        nonlocal t_lap
        torch.cuda.synchronize()
        log(f"PAR reference {what}: {time.perf_counter() - t_lap:.3f} s")
        t_lap = time.perf_counter()

    lap("meshes (two RCMs)")
    m = P["B"]()
    u, v = par_inputs(m, 81)
    ref["B.residual"], ref["B.hvp"] = m.residual(u).cpu(), m.hessian_vector_product(u, v).cpu()
    del m, u, v
    free_memory()
    lap("B (model and two operators)")
    m = P["B-solve"]()
    res = par_newton(m.solve, m)
    ref["B.solve"], status = res.x.cpu(), status + [res.status]
    del m, res
    lap(f"B solve ({status[-1]})")
    m = P["E"]()
    u, v = par_inputs(m, 82)
    ref.update({"E.residual": m.residual(u).cpu(), "E.hvp": m.hessian_vector_product(u, v).cpu(),
                "E.diag": m.hessian_diagonal(u).cpu(), "E.energy": m.energy(u).reshape(1).cpu()})
    del m
    lap("E")
    m = P["S"]()
    u, v = par_inputs(m, 83)
    ref.update({"S.residual": m.residual(u).cpu(), "S.hvp": m.hessian_vector_product(u, v).cpu(),
                "S.diag": m.hessian_diagonal(u).cpu()})
    ref.update({"H" + key[1:]: t for key, t in list(ref.items()) if key.startswith("S.")})  # the same model
    del m
    lap("S")
    m = P["H-solve"]()
    res = par_newton(m.solve, m)
    ref["H.solve"], status = res.x.cpu(), status + [res.status]
    del m
    lap("H solve")
    A64, A32, free, v, b = P["D"]()
    ref["D.matvec"] = block_dia_operator(A32)(v.float()).cpu()
    res = par_dia_cg(A64, b, free)
    ref["D.cg"], status = res.x.cpu(), status + [res.status]
    del A64, A32
    lap("D (assembly, product, f64 CG)")
    torch.save({"ref": ref, "status": status}, out)
    free_memory()
    return time.perf_counter() - t0


def par_rank(rank, world, store, out_dir):
    """One PAR rank: join the gloo group, build every part's model and its sharded view on cuda:0, run the
    operator applications (each timed over PAR_REPS, with the collectives' share) and solves under reset counts,
    and save the outputs and a summary to ``out_dir/rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from fenris_tpu_torch.ops._build import load_library
    from fenris_tpu_torch.parallel import ShardedElasticity, make_device_mesh
    from fenris_tpu_torch.parallel.banded import ShardedBandedElasticity
    from fenris_tpu_torch.parallel.block_dia import ShardedBlockDia
    from fenris_tpu_torch.parallel.halo import StructuredHaloElasticity
    from fenris_tpu_torch.parallel.structured import StructuredShardedElasticity

    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_device_mesh()
        dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            load_library()  # built by the parent: loaded from its cache
        kernels = kernel_records()
        P = par_problems(dev)
        out, summary = {}, {"setup_s": {}, "failures": []}

        def expect(ok, what):
            """A rank records a failed check for the parent: raising here would leave the other rank waiting
            in a collective."""
            if not ok:
                summary["failures"].append(f"rank {rank}: {what}")

        def apply(part, sharded, ops):
            """Each op once under reset counts (launches), then PAR_REPS times with the collectives timed."""
            for name, fn in ops.items():
                reset_counts(kernels)
                out[f"{part}.{name}"] = fn()
                torch.cuda.synchronize()
                launches = par_launches(kernels)
                comm = sharded._comm
                comm.timed, comm.seconds, calls0 = True, 0.0, comm.calls
                t0 = time.perf_counter()
                for _ in range(PAR_REPS):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                comm.timed = False
                summary[f"{part}.{name}"] = {"ms": wall / PAR_REPS * 1e3, "share": comm.seconds / wall,
                                             "collectives": (comm.calls - calls0) // PAR_REPS,
                                             "launches": launches}

        def timed_setup(part, build):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obj = build()
            torch.cuda.synchronize()
            summary["setup_s"][part] = time.perf_counter() - t0
            return obj

        m = P["B"]()
        sb = timed_setup("B", lambda: ShardedBandedElasticity(m, mesh))
        u, v = par_inputs(m, 81)
        apply("B", sb, {"residual": lambda: sb.residual(u), "hvp": lambda: sb.hessian_vector_product(u, v)})
        for op, need in (("residual", {"banded_vector_sweep", "banded_scatter"}),
                         ("hvp", {"banded_tangent_sweep", "banded_scatter"})):
            got = summary[f"B.{op}"]["launches"]
            expect(need <= set(got), f"PAR-B {op}: launched {got}, needs {sorted(need)}")
        out = {k: t.cpu() for k, t in out.items()}
        del m, sb, u, v
        free_memory()
        m = P["B-solve"]()
        sb = ShardedBandedElasticity(m, mesh)
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = par_newton(sb.solve, m)
        summary["B.solve"] = {"s": time.perf_counter() - t0, "newton": res.iterations, "status": res.status,
                              "collectives": sb._comm.calls, "launches": par_launches(kernels)}
        expect({"banded_tangent_sweep", "banded_vector_sweep", "banded_scatter", "banded_gather"}
               <= set(summary["B.solve"]["launches"]),
               f"PAR-B solve: launched {summary['B.solve']}")
        out["B.solve"] = res.x.cpu()
        del m, sb, res
        m = P["E"]()
        se = timed_setup("E", lambda: ShardedElasticity(m, mesh))
        u, v = par_inputs(m, 82)
        apply("E", se, {"residual": lambda: se.residual(u), "hvp": lambda: se.hessian_vector_product(u, v),
                        "diag": lambda: se.hessian_diagonal(u), "energy": lambda: se.energy(u).reshape(1)})
        del m, se
        m = P["S"]()
        ss = timed_setup("S", lambda: StructuredShardedElasticity(m, mesh))
        u, v = par_inputs(m, 83)
        apply("S", ss, {"residual": lambda: ss.residual(u), "hvp": lambda: ss.hessian_vector_product(u, v),
                        "diag": lambda: ss.hessian_diagonal(u)})
        sh = timed_setup("H", lambda: StructuredHaloElasticity(m, mesh))
        ug, vg = sh.to_grid(u), sh.to_grid(v)
        apply("H", sh, {"residual": lambda: sh.residual(ug), "hvp": lambda: sh.hessian_vector_product(ug, vg),
                        "diag": lambda: sh.hessian_diagonal(ug)})
        for name in ("residual", "hvp", "diag"):
            out[f"H.{name}"] = sh.to_flat(out[f"H.{name}"])
        del m, ss, sh, ug, vg
        m = P["H-solve"]()
        sh = StructuredHaloElasticity(m, mesh)
        t0 = time.perf_counter()
        res = par_newton(sh.solve, m)
        summary["H.solve"] = {"s": time.perf_counter() - t0, "newton": res.iterations, "status": res.status,
                              "collectives": sh._comm.calls}
        out["H.solve"] = sh.to_flat(res.x)
        del m, sh, res
        A64, A32, free, v, b = P["D"]()
        sd = timed_setup("D", lambda: ShardedBlockDia(A32, mesh))
        vb = sd.to_sharded(v.float())
        apply("D", sd, {"matvec": lambda: sd.matvec(vb)})
        out["D.matvec"] = sd.to_flat(out["D.matvec"])
        expect(summary["D.matvec"]["launches"].get("dia_sweep", 0) > 0, "PAR-D: launched no band sweep")
        sd64 = ShardedBlockDia(A64, mesh)
        t0 = time.perf_counter()
        res = sd64.cg(sd64.to_sharded(b), free_blocks=sd64.to_sharded(free), rel_tolerance=1e-6, max_iter=20000,
                      check_definiteness=False)
        summary["D.cg"] = {"s": time.perf_counter() - t0, "cg": res.num_iterations, "status": res.status,
                           "collectives": sd64._comm.calls}
        out["D.cg"] = sd64.to_flat(res.x)
        summary["wall_s"] = time.perf_counter() - t_start
        torch.save({"out": {k: t.cpu() for k, t in out.items()}, "summary": summary}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def par_phase(dev, smi):
    """PAR: the references on the single-process models, then PAR_WORLD ranks on cuda:0 over gloo (one
    spawn for every part), each output held against its reference and the ranks against each other."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ref_s = par_references(dev, Path(tmp) / "ref.pt")
        log(f"PAR references on the single-process models: {ref_s:.3f} s")
        t0 = time.perf_counter()
        ctx = mp.start_processes(par_rank, args=(PAR_WORLD, str(Path(tmp) / "store"), tmp), nprocs=PAR_WORLD,
                                 join=False, start_method="spawn")
        try:
            deadline = time.perf_counter() + PAR_TIMEOUT_S
            while not ctx.join(timeout=5):
                check(time.perf_counter() < deadline, f"PAR: the ranks did not end within {PAR_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        spawn_s = time.perf_counter() - t0
        saved = torch.load(Path(tmp) / "ref.pt")
        ref, ref_status = saved["ref"], saved["status"]
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(PAR_WORLD)]
    summaries = [r["summary"] for r in ranks]
    log(f"PAR: {PAR_WORLD} ranks on one card over gloo (CUDA tensors staged through the host: the times below are "
        f"of that staging, not of scaling): {spawn_s:.3f} s from the spawn to the last rank's end, rank walls "
        f"{[round(s['wall_s'], 3) for s in summaries]} s, set-up {[s['setup_s'] for s in summaries]} ({smi})")
    failures = [f for s in summaries for f in s["failures"]]
    worst = 0.0
    for key in sorted(ref):
        r = ref[key].double()
        got = [rk["out"][key].double() for rk in ranks]
        rel = float((got[0] - r).abs().max() / r.abs().max())
        same = all(torch.equal(ranks[0]["out"][key], rk["out"][key]) for rk in ranks[1:])
        stats = [s.get(key, {}) for s in summaries]
        log(f"PAR-{key}: max |diff| / max |ref| {rel:.3e} (limit {PAR_RTOL:g}); ranks equal {same}; per rank " +
            "; ".join(", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in st.items())
                      for st in stats))
        if not same:
            failures.append(f"PAR-{key}: the ranks hold different replicated results")
        if not (rel <= PAR_RTOL and bool(torch.isfinite(got[0]).all())):
            failures.append(f"PAR-{key}: rel {rel:.3e} > {PAR_RTOL:g}")
        worst = max(worst, rel)
    # the f32 banded solve runs PAR_B_NEWTON steps (status 1, NEWTON_MAX_ITER) as its reference does
    for key, status in (("B.solve", ref_status[0]), ("H.solve", 0), ("D.cg", 0)):
        if not all(s[key]["status"] == status for s in summaries):
            failures.append(f"PAR-{key}: status {[s[key]['status'] for s in summaries]}, expected {status}")
    if not (ref_status[1:] == [0, 0] and ref_status[0] in (0, 1)):
        failures.append(f"PAR: reference solve statuses {ref_status}")
    check(not failures, "; ".join(failures))
    log(f"PAR: every part within {PAR_RTOL:g} of the single-process models (worst {worst:.3e})")


def kernel_records():
    """Every kernel record of the kernel line: its wrapper, path, source and the TPU kernel it replaces; the
    phases fill in launches, errors and times."""
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.dia_sweep as ds
    import fenris_tpu_torch.ops.em_sweep as es
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    import fenris_tpu_torch.ops.structured_stencil as ss

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
        "stiffness_pairs (hex8 laplace, B)": dict(
            fn=sp.stiffness_pairs, path="B", source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162",
        ),
        # BASELINE's headline elements, hex20 and tet10, and row 3's other 3D elements, each operator
        **{stiffness_record(cell, name, kind): dict(
            fn=sp.stiffness_pairs, path=cell, source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162")
           for cell, (name, _) in {"B20": ("hex20", 0), "B10": ("tet10", 0), **STIFFNESS_3D_CELLS}.items()
           for kind in ("linear", "laplace")},
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
    # T4-MG: the gather and scatter at n = 4 (s = 3) and the Neo-Hookean fused sweeps on the refined tet4 box
    kernels["banded_gather (s=3, tet4)"] = dict(
        fn=bd.banded_gather, path="T4-MG", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285")
    kernels["banded_scatter (s=3, tet4)"] = dict(
        fn=bd.banded_scatter, path="T4-MG", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346")
    tangent, vector = sweep_records("tet4", "neo_hookean")
    kernels[tangent] = dict(fn=es.banded_tangent_sweep, path="T4-MG", source=SOURCES["em_sweep"],
                            replaces="fenris_tpu/ops/em_sweep.py:251")
    kernels[vector] = dict(fn=es.banded_vector_sweep, path="T4-MG", source=SOURCES["em_sweep"],
                           replaces="fenris_tpu/ops/em_sweep.py:233")
    # MMS-NL: the Hessian-action kernel on the last MMS grid
    kernels["neo_hookean_hvp (MMS-NL)"] = dict(
        fn=ss.neo_hookean_hvp, plain=ss.neo_hookean_hvp_plain, nargs=2, path="MMS-NL",
        source=SOURCES["structured_stencil"], replaces="fenris_tpu/ops/structured_stencil.py:319",
    )
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
    # P2D: rows 4-7 at s = 1 on the 2D meshes (n = 9 and 6 nodes a row), and row 4 on the bands that
    # block_dia_from_csr makes of the CSR route's matrix
    for name in P2D_MESHES:
        cell = f"P2D {name}"
        for rec in (f"dia_sweep (s=1, {cell})", f"dia_sweep (s=1, {cell}, from CSR)"):
            kernels[rec] = dict(
                fn=ds.dia_sweep, path=cell, source=SOURCES["dia_sweep"],
                replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
            )
        kernels[f"banded_gather (s=1, {cell})"] = dict(
            fn=bd.banded_gather, path=cell, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        )
        kernels[f"banded_scatter (s=1, {cell})"] = dict(
            fn=bd.banded_scatter, path=cell, source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        )
    # MSH: the gather, scatter and fused sweeps on the refined Gmsh sphere (tet4, s = 3)
    kernels["banded_gather (s=3, tet4 sphere)"] = dict(
        fn=bd.banded_gather, path="MSH", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285")
    kernels["banded_scatter (s=3, tet4 sphere)"] = dict(
        fn=bd.banded_scatter, path="MSH", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346")
    tangent, vector = sweep_records("tet4 sphere", "neo_hookean")
    kernels[tangent] = dict(fn=es.banded_tangent_sweep, path="MSH", source=SOURCES["em_sweep"],
                            replaces="fenris_tpu/ops/em_sweep.py:251")
    kernels[vector] = dict(fn=es.banded_vector_sweep, path="MSH", source=SOURCES["em_sweep"],
                           replaces="fenris_tpu/ops/em_sweep.py:233")
    return kernels


def main() -> int:
    if not (ROOT / "fenris_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenris_tpu_torch/ not found next to this script; run it in a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    import fenris_tpu_torch.ops.em_sweep as es
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
    PTXAS.update(found)
    for prefix in ("stiffness_pairs", "em_sweep", *PTXAS_LABELS.values()):
        entries = {n: t for n, t in found.items() if n.startswith(prefix)}
        check(len(entries) > 0 and all("0 bytes spill stores, 0 bytes spill loads" in t for t in entries.values()),
              f"{prefix}: ptxas reports spills or no entry: {entries}")
    em_entries, em_all = sum(n.startswith("em_sweep") for n in found), len(es.ELEMENTS) * len(es.MATERIALS) * 4
    check(em_entries == em_all, f"em_sweep: ptxas reports {em_entries} of {em_all} instantiations")
    em_layout_report(found)
    stiffness_layout_report(found)
    t0 = time.perf_counter()
    card_tests()
    log(f"phase card tests: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    banded_star_check(dev)
    log(f"phase banded star: {time.perf_counter() - t0:.3f} s")

    kernels = kernel_records()
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
    topo_phase({"hex20": element_meshes["hex20"], "tet10": element_meshes["tet10"][0]}, dev, smi)
    log(f"phase TOPO: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    element_sweep_phases(kernels, {**element_meshes, "hex20": (element_meshes["hex20"], None)}, dev, smi)
    log(f"phase M10/M20, S10/S20, PE10 and ME tet10: {time.perf_counter() - t0:.3f} s")
    del element_meshes
    free_memory()
    for name, phase in (("MMS-NL", mms_nl_phase), ("T4-MG", t4_mg_phase), ("CANT", cantilever_phase)):
        t0 = time.perf_counter()
        phase(kernels, dev, smi)
        log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    err_phase(dev, smi)
    log(f"phase ERR: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sphere, refine_s = refined_sphere()
    loc_phase(sphere, dev, smi)
    log(f"phase LOC: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    msh_phase(kernels, sphere, refine_s, dev, smi)
    log(f"phase MSH: {time.perf_counter() - t0:.3f} s")
    del sphere
    t0 = time.perf_counter()
    agg_phase(dev, smi)
    log(f"phase AGG: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    path_c2_mg(kernels, c2_cg_iters, dev, smi)
    log(f"phase C2-MG: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    geo = geo_phase(kernels, dev, smi)
    log(f"phase GEO: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    util_phase(geo, dev, smi)
    del geo
    free_memory()
    log(f"phase UTIL: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    par_phase(dev, smi)
    log(f"phase PAR: {time.perf_counter() - t0:.3f} s")
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
