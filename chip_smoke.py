"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain version, and drive the port's public entry points:
the Burgers flagship (nfe_x=50, nfe_t=256, 64 blocks) on the dense block
path, its solver variants, the banded path and the heterogeneous
interface; the two-stage stochastic QP at the JAX package's
``stochastic_qp_32scenarios_1k`` size; the farmer; the single-NLP examples
through ``ip_solve``; the matrix-free PCG coupling solver; the
condensed least-squares solver of the performance harness at the
reference's default scale; the sharded (multi-rank) solvers over
``torch.distributed``, with the interfaces' ``mesh=`` (each rank evaluates
and assembles its own blocks); the host ``HostBKSolver``; the
reference-name layer ``parapint_tpu_torch.compat``; the bench tools
``parapint_tpu_torch.tools.bench`` and ``bench_all``; and the iteration
counts of five configurations against the JAX package's own spread under
one-ulp perturbations of the initial point (ROADMAP C5, C13/C14).

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. device          — require CUDA; print the card's name and power limit,
                     the torch/CUDA versions and ``nvcc --version``.
2. build           — compile ``parapint_tpu_torch/csrc/*.cu`` (one nvcc per
                     source) and ``csrc/bk_ldl.cpp`` (g++), the four started
                     together, into ``parapint_tpu_torch/_build``.
3. kernels         — every kernel entry (K1 ``ldl_panels_slab_winv``, K2
                     ``ldl_panels_slab``, K3 ``ldl_panels_batched_winv``, K4
                     ``ldl_panels_batched``, K5 ``ldl_panels``, K6
                     ``winv_apply_fused``) vs its plain version on the card at
                     the paths' shapes plus edge cases, and K3/K4 at every
                     width 1..128; time kernel, plain version and (K6) the
                     two-matmul form.
3b. kernel lab     — K7 ``read_reduce`` (the read-only streaming probe) bit
                     for bit equal to its plain version at (64,1024,1024),
                     (3,8,8) and (5,56,56) for 16, 64 and 256 rows per CTA;
                     then, every count zeroed, the kernel lab's ``bw``,
                     ``solve``, ``mxu`` and ``dispatch`` in-process at their
                     default shapes: K7 launches > 0, and the matmul
                     precision policy restored afterwards.
4. dense flagship  — dense block form, float32 KKT, ``SchurComplementSolver``
                     in W form with cyclic-reduction coupling (the JAX
                     package's ``burgers_64blocks_cr``), tol 1e-8, through
                     ``make_fused_ip_solve``: status optimal, the JAX
                     objective, K1 launches == 14 x numerics, K6 launches ==
                     2 x back solves.
4b. results       — after phase 4's solve, every accessor of the JAX
                     package's interfaces (``results``): shapes and counts
                     equal to the JAX package's, the backward and forward
                     duals equal to the masked link duals; then the
                     flagship warm-started from them (primals, coupling,
                     own, link, inequality and bound duals) through the
                     fused driver: optimal at the JAX objective, iterations
                     at or below the cold ones and within 1 of the JAX
                     package's warm count, K1 == 14 x numerics, K6 == 2 x
                     back solves.
5. dense SC        — the same with the dense ``DenseLDLSolver`` coupling:
                     K5 launches == 25 x numerics.
6. bf16 W          — W stored in bf16, adaptive refinement with the
                     auto-gate: optimal at the JAX objective, iterations
                     within 1 of the JAX package's fused count and in the
                     set its ensembles span (``jax_count_set``: the
                     initial point's one-ulp ones and the optimal solves
                     of the panel-output witness; outside the first alone
                     a count flag is printed; ROADMAP C5), bf16 K6
                     launches > 0; each
                     back solve's gate printed (fallback to the f32 W,
                     passes on each W, probe values; ``solve_gates``).
7. LD mode         — the first-iteration KKT through the packed-LDL^T
                     ``SchurComplementSolver(block_size=128)`` on the card
                     and on a CPU copy: inertia equal, solutions close, K2 ==
                     8 and K5 == 25 launches.
8. column          — ``PT_PANEL_ALGO=column`` (restored afterwards): the
                     dense flagship with K3 == 14 x numerics, K1 == 0, and
                     the slab run's iterations and objective bit for bit;
                     the LD-mode first KKT with K4 == 8, K2 == 0 and the slab
                     run's LD bit for bit.  Then, under the default algorithm,
                     one ``SchurComplementSolver(block_size=100)`` W-form
                     numeric of the first KKT: K3 at width 100 (10 x per
                     numeric), inertia equal to a CPU copy's.
8b. fixed order   — ROADMAP C9: the "scatter" topology's three float64 sums
                     at the flagship's size, each twice on the same inputs:
                     bitwise equal.
9. stochastic QP   — 32 scenarios x (n=768, me=192, n_first=64), float32
                     KKT, the hybrid ``SchurComplementSolver`` (float64 pivot
                     sweep, float32 W, adaptive refinement), tol 1e-8: one
                     warm and one timed ``make_fused_ip_solve`` solve and one
                     ``ip_solve``, each optimal with the JAX objective and
                     iterations within 1 of JAX's; the timed solve repeats the
                     warm one bit for bit; K6 == 2 x back solves, K5 ==
                     numerics (the 64-wide Schur complement).
10. farmer         — ``examples/stochastic.main()`` (170/80/250 acres) and the
                     32-scenario farmer family through the fused driver, its
                     timed solve bit for bit equal to the counted one.
11. single NLP     — ``examples/interior_point.main()`` (x = (0, 1)) and
                     ``examples/dynamics.main()`` (the golden p(t)).
12. banded flagship — the banded block form, ``BandedSchurComplementSolver``
                     (the bench flagship): optimal, K1 launches == 22 x numerics.
13. heterogeneous  — the dense flagship as two kinds (block 0 with the
                     initial-condition rows, blocks 1-63 without) through
                     ``HeterogeneousDynamicInterface`` and the fused driver
                     with the dense flagship's solver: optimal at the JAX
                     objective, iterations within 1 of the JAX package's
                     two-kinds count and in its ensemble's set (phase 22),
                     K1 == 14 x numerics, K6 == 2 x back solves, a second
                     solve repeating the first bit for bit.
14. PCG            — bench_all's ``burgers_pcg_coupling_8blocks`` (nfe_x=50,
                     nfe_t=32, 8 blocks, float32 KKT,
                     ``PCGSchurComplementSolver(block_size=128,
                     factor_dtype=float32)``) through the fused driver and
                     ``ip_solve``: optimal at the JAX objective, iterations
                     within 1 (the fused count also in the JAX ensemble's
                     set), K1 == 8 x numerics, K6 == 2 x back solves + CG
                     iterations.  Then the dense flagship's first KKT through
                     PCG and the W-form solver with cyclic reduction: equal
                     block inertia, solutions within 1e-5 x max|x|.
15. condensed      — the harness's csc at the reference's default scale (3
                     blocks, n_q 5000, x120: 605,010 variables per block),
                     warm: status 0, max_err < 1.0 and within 1e-6 relative
                     of the JAX package's, theta within 1e-8 of the JAX
                     package's; launches per numeric and back solve under
                     ``torch.profiler``; fs, ssc and csc at the CPU tests'
                     size with equal max_err (rtol 1e-6).
16. sharded, 1 rank — one NCCL rank in this process: the dense flagship
                     through ``ShardedSchurComplementSolver`` (W form, float32
                     factors, cyclic reduction: ``dryrun_multichip``'s
                     configuration) and the fused driver: optimal at the JAX
                     objective, iterations within 1 of the JAX sharded run's,
                     K1 == 14 x numerics, K6 == 2 x back solves; then the
                     first KKT through the LD mode (the 2-rank reference);
                     then the same through a ``mesh=`` interface, whose
                     range at one rank is every block: its final iterates
                     ``torch.equal`` to the replicated run's; then that
                     interface through phase 4's serial solver (ROADMAP
                     C11: it gathers the rank-local KKT whole): final
                     iterates ``torch.equal`` to phase 4's.
17. sharded, 2 ranks — two spawned ranks sharing the card over gloo (NCCL
                     refuses two ranks on one device), 32 blocks each.  Each
                     case runs twice, with the interface replicated (every
                     rank evaluates every block) and with ``mesh=`` on it
                     (each rank evaluates and assembles its own blocks), the
                     peak memory reset before each, and each rank prints its
                     blocks, its ``eval_ad`` / ``kkt_from_ad`` time, its
                     all-reduces and both peaks (the dense flagship's
                     ``mesh=`` peak must be the lower): the dense flagship as
                     in 16; the banded flagship
                     through ``ShardedBandedSchurComplementSolver`` (K1 == 22
                     x numerics per rank); 63 blocks padded to 64 with the
                     dense coupling (K1 == 8 and K5 == 24 x numerics); the
                     stochastic QP (replicated in the original order; with
                     ``mesh=`` each rank owning the odd or the even scenarios,
                     ``ownership_map``); the flagship as two kinds (K1 == 14
                     x numerics, K6 == 2 x back solves); the first KKT in LD
                     mode of both dense interfaces (K2 == 8, K5 == 25, the
                     solution within 1e-3 x max|x| of the 1-rank run's); PCG
                     with a mesh on bench_all's 8-block row (K1 == 8 x
                     numerics, K6 == 2 x back solves + CG iterations) and the
                     harness's psc; and (C11) the ``mesh=`` dense flagship
                     through phase 4's serial solver, which gathers the KKT
                     whole on each rank: iterations, objective and K1 per
                     rank equal to phase 4's.  Each case is optimal at its JAX
                     objective with iterations within 1, each rank prints its
                     launches and all-reduce time, and the ranks' final
                     iterates are bitwise equal.
18. host BK        — ``HostBKSolver`` (the g++ build) through ``ip_solve`` on
                     the single-NLP example, its model on the card: optimal in
                     phase 11's iterations at its objective; one batched host
                     factor of the 8-block PCG row's first-KKT blocks, its
                     summed inertia equal to the card's W-form blocks'.
19. compat         — the reference-style call site of ``tests/test_compat.py``
                     through ``parapint_tpu_torch.compat`` on the card:
                     optimal at the JAX ``compat`` run's objective.
20. bench          — ``python -m parapint_tpu_torch.tools.bench`` as a child,
                     twice (BENCH_RUNS): each line's ``n_iter`` within 1 of the JAX 6,
                     ``value`` and ``vs_baseline`` > 0, ``backend`` "cuda" and
                     the card's line, the scipy baseline's child without a
                     card; then the median and spread of ``value``.
21. bench_all      — the six rows of ``tools/bench_all.py`` that no phase
                     above runs (4 and 8 blocks with the dense SC, the three
                     256-block rows, nfe_x=200 banded), in this process
                     through the tool's row factory, counted: optimal at the
                     JAX objective and iterations (within 1, and in the JAX
                     ensemble's set where phase 22 has one), the launches
                     per numeric and back solve of ``BENCH_NEW_ROWS``; then
                     the tool on those rows but row 10 (``BENCH_CHILD_ROWS``;
                     row 10's 15-28 s solves stay in the in-process pass)
                     (each a child of its own) as one child: exit 0, every
                     row without an error and at its JAX iterations.  (The
                     tool's other six rows are the configurations of phases
                     4, 9, 10, 12, 14 and 15.)
22. parity         — ROADMAP C5, C13/C14: bench_all rows 2, 5 and 9, the
                     flagship as two kinds and the bf16-W flagship
                     (``burgers_bf16_w``) through ``ip_solve`` (within 1 of
                     the JAX package's ``ip_solve`` count; like every
                     ``ip_solve`` phase, it prints its log table and
                     inertia-correction lines), then the fused solve from the
                     initial point and from 16 (row 9: 8) one-ulp perturbations of
                     it (``ulp_perturbations``, the points of the JAX
                     package's CPU ensemble in tests/test_torch_parity.py):
                     each optimal at the JAX objective, the initial point's
                     digest equal to the CPU's, the unperturbed count within
                     1 of the JAX package's and in its ensemble's set, the
                     ensemble's launches per numeric as in phases 13, 14
                     and 21 (K6 == 2 x back solves + CG iterations); the
                     card's and the JAX package's distributions printed
                     side by side with their sign test point by point
                     (``sign_test``; a lean is printed, not held: reordering
                     the panels' float32 arithmetic leans too,
                     ``panel_order.py``).  On the bf16-W flagship a
                     perturbed point may end with status error: the
                     statuses are printed, the unperturbed solve must be
                     optimal, the ``ip_solve`` count lies in
                     ``jax_count_set`` (in place of within 1 of JAX's),
                     and the share of the others that
                     are not optimal is
                     held to the JAX package's by the one-sided Fisher test
                     (``fisher_greater``, p >= 0.05; ROADMAP C5's rules (c)
                     and (d)), bf16 K6 launched.  ``python3 chip_smoke.py --parity CONFIG``
                     runs only the build and this phase (also for row 10,
                     ``burgers_256blocks_dense_sc``).
23. arguments      — the solver arguments the port restored from the JAX
                     package's API, each at a user's value that changes
                     what the card computes, at full width: (a) the banded
                     flagship with ``tile_block_size=128`` (one K1 launch
                     per Thomas tile, 14 per numeric where the default
                     takes 22; K1's time at (64,128,128) against two
                     launches at (64,64,64)), (b) the banded flagship with
                     ``refine_steps=0``, (c) bench_all's row 11 with
                     ``BlockTridiagSolver(ns=199, block_size=128)`` (its
                     cyclic-reduction tiles as two 128-wide panels, 100 K1
                     launches per numeric where the row takes 112), (d) PCG
                     with ``cg_maxiter`` (ARGS_PCG_CG_MAXITER) on the dense
                     flagship: its first KKT converged in the JAX package's
                     CG count (within 1), block inertia equal to the
                     explicit solver's, the solutions' gap printed beside
                     the JAX package's own (ARGS_PCG_JAX_FIRST_GAP), then
                     its fused solve.
                     Each case optimal at the JAX package's objective (1e-6)
                     and within 1 of its iterations at the same arguments
                     (``ARGS_JAX``), with its wall, K1/K6 launches and the
                     card's line.  ``python3 chip_smoke.py --arguments``
                     runs only the build and this phase.

Every measurement line carries the card's name and power limit; kernel
times are medians of CUDA-event windows (``tools/kernel_lab.py::timed_loop``).
The lines before the last give each bytes-bound kernel's time against K7's
measured read rate, the sharded cases' launches per rank (JSON) and list
each kernel with launches, error, times and bound; the last line of
standard output is the JSON result.
"""

import contextlib
import dataclasses
import json
import logging
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from parapint_tpu_torch.tools.kernel_lab import PEAK_BYTES, bound, card_line, timed_loop

# JAX package's objective for the flagship, banded path on the CPU:
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   spec = burgers.build_spec(nfe_x=50, nfe_t=256, num_time_blocks=64)
#   iface = pt.DynamicSchurComplementInteriorPointInterface(
#       spec, kkt_dtype=jnp.float32, block_form="banded")
#   opts = pt.IPOptions(); opts.tol = 1e-8
#   opts.linalg.solver = pt.BandedSchurComplementSolver(
#       tile_size=128, schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns))
#   status, res = pt.ip_solve_fused(iface, opts)
#   print(status, int(res.iterations), repr(float(iface.evaluate_objective())))
#   EOF
# -> InteriorPointStatus.optimal 6 0.04755768812300182
# The same NLP has the same optimum whatever the linear algebra, so every
# phase holds its objective against this value.  The JAX dense path
# (bench.py with PT_BENCH_BLOCK=dense: the script above with the default
# block form and
#   pt.SchurComplementSolver(block_size=128, explicit_inverse=True,
#       factor_dtype=jnp.float32, refine_steps=0,
#       schur_complement_solver=pt.BlockTridiagSolver())
# ) -> InteriorPointStatus.optimal 7 0.04755768812300328
JAX_OBJECTIVE = 0.04755768812300182
JAX_ITERATIONS = 6
JAX_DENSE_ITERATIONS = 7
# The dense flagship as two kinds (``burgers_two_kinds``) with the dense
# path's solver, and bench_all's row 10 (whose fused solve XLA's CPU
# compile does not finish), in the JAX package on the CPU
# (JAX_PLATFORMS=cpu, from the repository root):
#   import sys; sys.path[:0] = ["tests", "."]
#   import parapint_tpu as pt, test_torch_parity as tp
#   iface, solver = tp.jax_config("two_kinds", FLAGSHIP)
#   opts = tp._options(pt, solver)
#   print(tp.fused_counts(pt, iface, opts, [None]), tp.ip_solve_run(pt, iface, opts)[:3])
#   # -> [(0, 7)] ('optimal', 8, 0.047557688123003886)
#   iface, solver = tp.jax_config("dense_sc", dict(nfe_x=50, nfe_t=512, num_time_blocks=256))
#   print(tp.ip_solve_run(pt, iface, tp._options(pt, solver))[:3])
#   # -> ('optimal', 11, ...)
TWO_KINDS_JAX_ITERATIONS = 7  # the fused solve's; ip_solve's 8
# The dense flagship warm-started from its own solution in the JAX package
# on the CPU (JAX_PLATFORMS=cpu, from the repository root):
#   import numpy as np, jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   shape = dict(nfe_x=50, nfe_t=256, num_time_blocks=64)
#   def opts():
#       o = pt.IPOptions(); o.tol = 1e-8
#       o.linalg.solver = pt.SchurComplementSolver(block_size=128,
#           explicit_inverse=True, factor_dtype=jnp.float32, refine_steps=0,
#           schur_complement_solver=pt.BlockTridiagSolver())
#       return o
#   iface = pt.DynamicSchurComplementInteriorPointInterface(
#       burgers.build_spec(**shape), kkt_dtype=jnp.float32)
#   status, res = pt.ip_solve_fused(iface, opts())
#   print(status, int(res.iterations))                     # -> optimal 7
#   sol = res.state
#   w = burgers.build_spec(**shape)
#   w.x0 = jnp.asarray(sol.primals["blocks"]); w.c0 = np.asarray(sol.primals["coupling"])
#   w.y_eq0 = np.asarray(sol.duals_eq["own"]); w.lam0 = np.asarray(sol.duals_eq["link"])
#   w.y_ineq0 = np.asarray(sol.duals_ineq)
#   w.zl0 = np.asarray(sol.duals_primals_lb["blocks"])
#   w.zu0 = np.asarray(sol.duals_primals_ub["blocks"])
#   wif = pt.DynamicSchurComplementInteriorPointInterface(w, kkt_dtype=jnp.float32)
#   status, res = pt.ip_solve_fused(wif, opts())
#   print(status, int(res.iterations), repr(float(wif.evaluate_objective())))
#   # -> optimal 1 0.04755768812295933
# (the warm point passes the first convergence check: no step is taken)
WARM_JAX_ITERATIONS = 1
# What the JAX package's dense flagship interface returns (``result_shapes``
# of its interface after ``init_state``; JAX_PLATFORMS=cpu):
#   import jax.numpy as jnp, parapint_tpu as pt, chip_smoke
#   from parapint_tpu.examples import burgers
#   iface = pt.DynamicSchurComplementInteriorPointInterface(
#       burgers.build_spec(**chip_smoke.FLAGSHIP), kkt_dtype=jnp.float32)
#   iface._current_state = iface.init_state()
#   shapes = chip_smoke.result_shapes(iface)
#   print({k: v for k, v in shapes.items() if not k.startswith("get_block_primals/")})
#   print({k: getattr(iface, k)() for k in chip_smoke.RESULT_COUNTS})
# -> the two dicts below; every get_block_primals/i is (510,)
FLAGSHIP_JAX_SHAPES = {
    "get_primals/blocks": (64, 510), "get_primals/coupling": (3087,),
    "get_coupling_values": (3087,), "get_slacks": (64, 0), "get_duals_eq/own": (64, 314),
    "get_duals_eq/link": (64, 98), "get_duals_ineq": (64, 0),
    "get_duals_primals_lb/blocks": (64, 510), "get_duals_primals_lb/coupling": (3087,),
    "get_duals_primals_ub/blocks": (64, 510), "get_duals_primals_ub/coupling": (3087,),
    "get_duals_slacks_lb": (64, 0), "get_duals_slacks_ub": (64, 0),
    "get_duals_backward": (64, 49), "get_duals_forward": (64, 49),
    "n_primals": (), "n_eq_constraints": (), "n_ineq_constraints": (),
}
FLAGSHIP_JAX_BLOCK_SHAPE = (510,)
FLAGSHIP_JAX_COUNTS = {"n_primals": 35727, "n_eq_constraints": 20096, "n_ineq_constraints": 0}
OBJ_REL_GAP = 1e-6
FLAGSHIP = dict(nfe_x=50, nfe_t=256, num_time_blocks=64)
TILE_SIZE = 128
TOL = 1e-8
BANDED_PANELS_PER_NUMERIC = 22  # 8 tiles x 2 panels (Thomas) + 6 CR levels
DENSE_K1_PER_NUMERIC = 14  # 8 block panels (1024 = 8 x 128) + 6 CR levels
SC_PANELS_PER_NUMERIC = 25  # dense SC: 3087 -> 3200 = 25 x 128
LD_K2_PER_NUMERIC = 8
W100_K3_PER_NUMERIC = 10  # block_size=100: nk 922 -> 1000 = 10 x 100
W100_K1_PER_NUMERIC = 6  # the CR levels' 56-wide tiles stay on K1

# JAX package's results for the stochastic families on the CPU (the QP at
# bench_all's stochastic_qp_32scenarios_1k size, its farmer family
# stochastic_32), with JAX_PLATFORMS=cpu:
#   import jax.numpy as jnp, parapint_tpu as pt, bench_all
#   from parapint_tpu.utils.timer import HierarchicalTimer
#   def run(iface, solver, fused):
#       opts = pt.IPOptions(); opts.tol = 1e-8; opts.linalg.solver = solver
#       if fused:
#           status, res = pt.ip_solve_fused(iface, opts); n = int(res.iterations)
#       else:
#           timer = HierarchicalTimer(); status = pt.ip_solve(iface, opts, timer=timer)
#           n = timer._root.children["IP solve"].children["convergence check"].count
#       print(status, n, repr(float(iface.evaluate_objective())))
#   hybrid = lambda: pt.SchurComplementSolver(block_size=128, explicit_inverse=True,
#                                             factor_dtype=jnp.float64, apply_dtype=jnp.float32)
#   run(bench_all.stochastic_qp(), hybrid(), True)   # -> optimal 18 61.205618968982115
#   run(bench_all.stochastic_qp(), hybrid(), False)  # -> optimal 18 61.20561896896718
#   # the farmer family with the default tol:
#   #   pt.ip_solve_fused(bench_all.stochastic_32(), opts) with
#   #   pt.SchurComplementSolver(block_size=64, explicit_inverse=True)
#   #   -> optimal 63 -109642.32191097125
# ``ip_solve`` iterations are counted as its convergence checks.
QP = dict(n_scenarios=32, n=768, me=192, n_first=64)
QP_JAX_OBJECTIVE = 61.205618968982115
QP_JAX_ITERATIONS = 18
QP_JAX_IP_ITERATIONS = 18
FARMER32_JAX_OBJECTIVE = -109642.32191097125
FARMER32_JAX_ITERATIONS = 63
FARMER_ACRES = (170.0, 80.0, 250.0)  # reference golden, tests/test_examples.py
FARMER_ATOL = 1e-4
# reference golden p(t), tests/test_examples.py:10-21
DYNAMICS_GOLDEN_P = (1.6046242850486279, 2.0, 1.4792062911745605, 0.5082444341496647,
                     -0.009859487375413882, 0.40043954978583834, 1.3619861771562247,
                     1.99059057528143, 1.7102013685364827)

# JAX package's results for bench_all's burgers_pcg_coupling_8blocks and
# the harness's csc at the reference's default scale, on the CPU with
# JAX_PLATFORMS=cpu:
#   import time, numpy as np, jax, jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   from parapint_tpu.utils.timer import HierarchicalTimer
#   def run(fused):
#       iface = pt.DynamicSchurComplementInteriorPointInterface(
#           burgers.build_spec(nfe_x=50, nfe_t=32, num_time_blocks=8), kkt_dtype=jnp.float32)
#       opts = pt.IPOptions(); opts.tol = 1e-8
#       opts.linalg.solver = pt.PCGSchurComplementSolver(block_size=128,
#                                                         factor_dtype=jnp.float32)
#       if fused:
#           status, res = pt.ip_solve_fused(iface, opts); n = int(res.iterations)
#       else:
#           timer = HierarchicalTimer(); status = pt.ip_solve(iface, opts, timer=timer)
#           n = timer._root.children["IP solve"].children["convergence check"].count
#       print(status, n, repr(float(iface.evaluate_objective())))
#   run(True)   # -> InteriorPointStatus.optimal 7 0.047561186977622474
#   run(False)  # -> InteriorPointStatus.optimal 6 0.047561186977352635
#   from parapint_tpu.examples.performance.schur_complement import SyntheticModel
#   from parapint_tpu.linalg import CondensedLSQKKT, CondensedLSQSolver
#   m = SyntheticModel(n_blocks=3, n_q_per_block=5000, n_y_multiplier=120, n_theta=10)
#   solver = CondensedLSQSolver(tile_size=128)
#   kkt = CondensedLSQKKT(A_bands=jnp.asarray(m.A_bands), q_c=jnp.zeros((10, 10)),
#                         n_t=10, n_blocks=3)
#   fact = jax.jit(solver.numeric)(kkt)
#   x = jax.jit(lambda f, r: solver.solve(f, r, kkt=kkt))(fact, m.build_rhs())
#   print(int(solver.status(fact)), repr(m.check_result(x.blocks)),
#         repr(np.asarray(x.coupling).tolist()))
#   # -> 0 0.1295882542007245 CSC_JAX_THETA
PCG_SHAPE = dict(nfe_x=50, nfe_t=32, num_time_blocks=8)
PCG_JAX_OBJECTIVE, PCG_JAX_ITERATIONS = 0.047561186977622474, 7
PCG_JAX_IP_OBJECTIVE, PCG_JAX_IP_ITERATIONS = 0.047561186977352635, 6
PCG_K1_PER_NUMERIC = 8  # the block panels only: 1024 = 8 x 128, no cyclic reduction
# CG iterations of PCG (float32 factors) on the first KKT of the dense
# flagship's per-block shape (nfe_x=50, 4 time steps per block) cut to N
# blocks, JAX package and port on the CPU (JAX_PLATFORMS=cpu, from the
# repository root):
#   import sys, jax, numpy as np, jax.numpy as jnp, torch, parapint_tpu as pt
#   import parapint_tpu_torch as ptt
#   sys.path.insert(0, "tests"); from test_torch_pcg_schur import jax_cg_iterations
#   from parapint_tpu.examples import burgers
#   from parapint_tpu_torch.convert import block_kkt_from_numpy, block_rhs_from_numpy
#   for N in (8, 16, 32):
#       iface = pt.DynamicSchurComplementInteriorPointInterface(
#           burgers.build_spec(nfe_x=50, nfe_t=4 * N, num_time_blocks=N), kkt_dtype=jnp.float32)
#       data = iface.eval_kkt_data(iface.init_state(), pt.IPOptions().init_barrier_parameter)
#       kkt, rhs = iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)
#       js = pt.PCGSchurComplementSolver(block_size=128, factor_dtype=jnp.float32)
#       jf = js.numeric(kkt); _, jst = js.solve_with_status(jf, rhs)
#       as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
#       ts = ptt.PCGSchurComplementSolver(block_size=128, factor_dtype=torch.float32)
#       _, tst = ts.solve_with_status(ts.numeric(block_kkt_from_numpy(as_np(kkt), "cpu")),
#                                     block_rhs_from_numpy(as_np(rhs), "cpu"))
#       print(N, int(jst), jax_cg_iterations(js, jf, rhs), int(tst), ts.cg_iterations)
#   # -> 8 0 109 0 [109] / 16 0 128 0 [128] / 32 0 176 0 [176]
PCG_DEPTH_JAX_CG = {8: 109, 16: 128, 32: 176}
PCG_DEPTH_BLOCKS = 32
# PCG against the explicit solver on the flagship's first KKT, both with
# float32 factors: tests/test_torch_pcg_schur.py's float32 bound
PCG_SOLUTION_RTOL = 1e-5
# Phase 23: the JAX package's counts and objectives at the restored
# arguments' user values, on the CPU (JAX_PLATFORMS=cpu, from the repository
# root; each case in a process of its own, 75-208 s each):
#   import jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   def fused(iface, solver):
#       o = pt.IPOptions(); o.tol = 1e-8; o.linalg.solver = solver
#       status, res = pt.ip_solve_fused(iface, o)
#       print(status.name, int(res.iterations), repr(float(iface.evaluate_objective())))
#   def banded(nfe_x):
#       return pt.DynamicSchurComplementInteriorPointInterface(
#           burgers.build_spec(nfe_x=nfe_x, nfe_t=256, num_time_blocks=64),
#           kkt_dtype=jnp.float32, block_form="banded")
#   iface = banded(50)   # (a), and in another process (b)
#   fused(iface, pt.BandedSchurComplementSolver(tile_size=128, tile_block_size=128,
#       schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)))
#   # -> optimal 6 0.04755768812301196
#   fused(iface, pt.BandedSchurComplementSolver(tile_size=128, refine_steps=0,
#       schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)))
#   # -> optimal 6 0.04755768812300182
#   iface = banded(200)  # (c): bench_all.py's row 11 with these coupling arguments
#   fused(iface, pt.BandedSchurComplementSolver(factor_dtype=jnp.float32,
#       schur_complement_solver=pt.BlockTridiagSolver(ns=199, block_size=128)))
#   # -> optimal 7 0.04724632409564691
# (d), the dense flagship through PCG: first the CG iterations of every
# back solve of the JAX package's ``ip_solve`` under a budget no solve
# reaches (3000), each counted by tests/test_torch_pcg_schur.py's
# ``jax_cg_iterations`` (the while_loop body and stopping rule as a host
# loop); then, in another process, the fused solve at ARGS_PCG_CG_MAXITER,
# over twice the largest count:
#   import sys; sys.path.insert(0, "tests")
#   from test_torch_pcg_schur import jax_cg_iterations
#   def dense():
#       return pt.DynamicSchurComplementInteriorPointInterface(
#           burgers.build_spec(nfe_x=50, nfe_t=256, num_time_blocks=64), kkt_dtype=jnp.float32)
#   class Counting(pt.PCGSchurComplementSolver):
#       counts = []
#       def solve_with_status(self, fact, rhs):
#           self.counts.append(jax_cg_iterations(self, fact, rhs))
#           return super().solve_with_status(fact, rhs)
#   o = pt.IPOptions(); o.tol = 1e-8
#   o.linalg.solver = s = Counting(block_size=128, factor_dtype=jnp.float32, cg_maxiter=3000)
#   print(pt.ip_solve(dense(), o).name, s.counts)
#   # -> optimal [273, 283, 252, 211, 163, 82, 5]
#   fused(dense(), pt.PCGSchurComplementSolver(block_size=128, factor_dtype=jnp.float32,
#                                              cg_maxiter=600))
#   # -> optimal 8 0.047557688123010144
# and the JAX package's PCG against its explicit solver on the first KKT
# (``_pcg_against_sc``'s pair), the gap relative to max|x|:
#   iface = dense()
#   data = iface.eval_kkt_data(iface.init_state(), pt.IPOptions().init_barrier_parameter)
#   kkt, rhs = iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)
#   flat = lambda b: np.concatenate([np.asarray(b.blocks).ravel(), np.asarray(b.coupling)])
#   js = pt.PCGSchurComplementSolver(block_size=128, factor_dtype=jnp.float32, cg_maxiter=600)
#   jx, _ = js.solve_with_status(js.numeric(kkt), rhs)
#   se = pt.SchurComplementSolver(block_size=128, explicit_inverse=True,
#       factor_dtype=jnp.float32, schur_complement_solver=pt.BlockTridiagSolver())
#   sx, _ = se.solve_with_status(se.numeric(kkt), rhs)
#   print(np.abs(flat(jx) - flat(sx)).max() / np.abs(flat(sx)).max())
#   # -> 7.994e-05
# This gap is over PCG_SOLUTION_RTOL: at 64 blocks the JAX package's own
# float32 CG misses phase 15's 32-block bar, so phase 23 holds the first
# KKT to the JAX package's status, CG count (within 1) and block inertia
# and prints the two gaps side by side.
ARGS_PCG_JAX_FIRST_GAP = 7.994e-05
# case -> (JAX iterations, JAX objective)
ARGS_JAX = {
    "tile_block_size": (6, 0.04755768812301196),
    "refine_steps": (6, 0.04755768812300182),
    "row11_cr128": (7, 0.04724632409564691),
    "pcg_cg_maxiter": (8, 0.047557688123010144),
}
ARGS_PCG_JAX_CG = (273, 283, 252, 211, 163, 82, 5)  # per back solve of the JAX ip_solve
ARGS_PCG_CG_MAXITER = 600
ARGS_TILE_K1_PER_NUMERIC = 14  # 8 tiles x 1 panel of 128 + 6 CR levels
# 44 tiles x 2 panels of 64 (84 -> 128) + 6 levels x 2 panels of 128 (199 -> 256)
ARGS_ROW11_K1_PER_NUMERIC = 100
CSC_REF = dict(n_blocks=3, n_q_per_block=5000, n_y_multiplier=120)  # 605,010 variables per block
CSC_JAX_MAX_ERR = 0.1295882542007245
CSC_JAX_THETA = (5.394658970325689, 0.45759233755419837, 7.001338872474145, 7.929935842062897,
                 6.432769848180054, 6.209609093964085, 3.423217873414951, 3.7381404883838423,
                 5.099829275933965, 5.701876365885636)
CSC_THETA_RTOL = 1e-8
CSC_SMALL = dict(n_blocks=4, n_q_per_block=32, n_y_multiplier=2, n_theta=5)  # tests/test_examples.py

# JAX package's sharded runs on a 2-device CPU mesh (JAX_PLATFORMS=cpu), from
# the repository root:
#   import numpy as np, jax
#   jax.config.update("jax_num_cpu_devices", 2)
#   import jax.numpy as jnp, parapint_tpu as pt, bench_all
#   from jax.sharding import Mesh
#   from parapint_tpu.examples import burgers
#   mesh = Mesh(np.array(jax.devices()[:2]), ("blocks",))
#   def run(iface, solver):
#       opts = pt.IPOptions(); opts.tol = 1e-8; opts.linalg.solver = solver
#       status, res = pt.ip_solve_fused(iface, opts)
#       print(status, int(res.iterations), repr(float(iface.evaluate_objective())))
#   def burgers_iface(nfe_t, n, **kw):
#       return pt.DynamicSchurComplementInteriorPointInterface(
#           burgers.build_spec(nfe_x=50, nfe_t=nfe_t, num_time_blocks=n), mesh=mesh,
#           kkt_dtype=jnp.float32, **kw)
#   iface = burgers_iface(256, 64, block_form="banded")
#   run(iface, pt.ShardedBandedSchurComplementSolver(mesh, "blocks", tile_size=128,
#       schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)))
#   # -> optimal 6 0.04755768812300182
#   run(burgers_iface(256, 64), pt.ShardedSchurComplementSolver(mesh, "blocks",
#       block_size=128, explicit_inverse=True, factor_dtype=jnp.float32,
#       schur_complement_solver=pt.BlockTridiagSolver()))
#   # -> optimal 7 0.047557688123004524
#   run(burgers_iface(252, 63), pt.ShardedSchurComplementSolver(mesh, "blocks",
#       block_size=128, explicit_inverse=True, factor_dtype=jnp.float32))
#   # -> optimal 9 0.04755730345919465 (63 blocks: another NLP)
#   run(pt.StochasticSchurComplementInteriorPointInterface(bench_all.stochastic_qp().spec,
#       mesh=mesh, kkt_dtype=jnp.float32, ownership_map=[i % 2 for i in range(32)]),
#       pt.ShardedSchurComplementSolver(mesh, "blocks", block_size=128,
#       explicit_inverse=True, factor_dtype=jnp.float64, apply_dtype=jnp.float32))
#   # -> optimal 18 61.2056189690012
#   run(pt.DynamicSchurComplementInteriorPointInterface(burgers.build_spec(
#       nfe_x=50, nfe_t=32, num_time_blocks=8), mesh=mesh, kkt_dtype=jnp.float32),
#       pt.PCGSchurComplementSolver(mesh, "blocks", block_size=128,
#       factor_dtype=jnp.float32))
#   # -> optimal 7 0.047561186977622474
SHARDED_DENSE_JAX_ITERATIONS = 7
SHARDED_BANDED_JAX_ITERATIONS = 6
ODD = dict(nfe_x=50, nfe_t=252, num_time_blocks=63)
ODD_JAX_OBJECTIVE, ODD_JAX_ITERATIONS = 0.04755730345919465, 9
QP_OWN_JAX_OBJECTIVE, QP_OWN_JAX_ITERATIONS = 61.2056189690012, 18
PCG_MESH_JAX_OBJECTIVE, PCG_MESH_JAX_ITERATIONS = 0.047561186977622474, 7
BLOCK_PANELS_PER_NUMERIC = 8  # dense blocks: 1024 = 8 x 128, without cyclic reduction
SHARDED_WORLD = 2
SHARDED_TIMEOUT = 600  # seconds for the two ranks to run every case
# tests/test_compat.py's reference-style call site through the JAX
# package's compat layer on the CPU (JAX_PLATFORMS=cpu):
#   import jax.numpy as jnp, numpy as np, parapint_tpu as pt, parapint_tpu.compat as parapint
#   model = pt.NLPModel(objective=lambda v: v[0] ** 2 + v[1] ** 2,
#       eq_constraints=lambda v: jnp.array([v[1] - jnp.exp(v[0])]), x0=jnp.array([0.5, 0.5]))
#   iface = parapint.interfaces.InteriorPointInterface(model)
#   opts = parapint.algorithms.IPOptions()
#   opts.linalg.solver = parapint.linalg.ScipyInterface(compute_inertia=True)
#   print(parapint.algorithms.ip_solve(interface=iface, options=opts))
#   x = np.asarray(iface.get_primals()); print(repr(float(x[0] ** 2 + x[1] ** 2)))
#   # -> InteriorPointStatus.optimal 0.6080367853394799
COMPAT_JAX_OBJECTIVE = 0.6080367853394799
# JAX package's results for bench_all's rows that no phase above runs, on
# the CPU (JAX_PLATFORMS=cpu, from the repository root), each row's
# interface and solver as bench_all.py builds them:
#   import jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   fast = dict(block_size=128, explicit_inverse=True, factor_dtype=jnp.float32, refine_steps=0)
#   def burgers_if(nfe_x, nfe_t, n, **kw):
#       return pt.DynamicSchurComplementInteriorPointInterface(burgers.build_spec(
#           nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=n), kkt_dtype=jnp.float32, **kw)
#   def run(iface, solver):
#       opts = pt.IPOptions(); opts.tol = 1e-8; opts.linalg.solver = solver
#       status, res = pt.ip_solve_fused(iface, opts)
#       print(status, int(res.iterations), repr(float(iface.evaluate_objective())))
#   run(burgers_if(50, 16, 4), pt.SchurComplementSolver(**fast))
#   # -> optimal 6 0.047884242255387344
#   run(burgers_if(50, 32, 8), pt.SchurComplementSolver(**fast))
#   # -> optimal 6 0.047561186977296575
#   iface = burgers_if(50, 512, 256, block_form="banded")
#   run(iface, pt.BandedSchurComplementSolver(tile_size=128,
#       schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)))
#   # -> optimal 7 0.047570960140467966
#   run(burgers_if(50, 512, 256), pt.SchurComplementSolver(
#       schur_complement_solver=pt.BlockTridiagSolver(), **fast))
#   # -> optimal 10 0.047570960140498296
#   run(burgers_if(50, 512, 256), pt.SchurComplementSolver(**fast))
#   # -> no result: XLA's CPU compile of the fused solve ran 28 minutes and
#   #    aborted ("LLVM ERROR: Unable to allocate section memory"); the row
#   #    is held to its ip_solve's count (TWO_KINDS_JAX_ITERATIONS' snippet)
#   run(burgers_if(200, 256, 64, block_form="banded"), pt.BandedSchurComplementSolver(
#       schur_complement_solver=pt.BlockTridiagSolver(), factor_dtype=jnp.float32))
#   # -> optimal 8 0.04724632409564694
BURGERS256_JAX_OBJECTIVE = 0.047570960140498296  # one NLP for the three 256-block rows
# row -> (JAX objective, JAX iterations, kernel launches per numeric, K6
# launches per back solve).  Dense
# blocks: K1 on ceil(nk / 128) panels of 128, the coupling on K1 per
# cyclic-reduction level (tiles of ns padded to a multiple of 8) or on K5
# per 128 columns of the dense SC; banded blocks: K1 on two 64-wide panels
# per tile of the Thomas sweep, no K6.
BENCH_NEW_ROWS = {
    # nk 922 -> 8 x 128; ncv 147 -> 2 x 128
    "burgers_serial_4blocks": (0.047884242255387344, 6, dict(K1=8, K5=2), 2),
    # ncv 343 -> 3 x 128
    "burgers_ssc_8blocks": (0.047561186977296575, 6, dict(K1=8, K5=3), 2),
    # nk 612 -> 5 x 128, 8 levels at (E, 56, 56), E = 128 ... 1
    "burgers_256blocks_cr": (BURGERS256_JAX_OBJECTIVE, 10, dict(K1=13), 2),
    # 5 tiles x 2 panels + 8 levels
    "burgers_256blocks_banded_cr": (BURGERS256_JAX_OBJECTIVE, 7, dict(K1=18), 0),
    # ncv 12,495 -> 98 x 128; the JAX count is its ip_solve's (above)
    "burgers_256blocks_dense_sc": (BURGERS256_JAX_OBJECTIVE, 11, dict(K1=5, K5=98), 2),
    # p 84: 44 tiles (3622 -> 3696 = 44 x 84), each 84 -> 128 as two
    # 64-wide panels, + 6 levels x 4 panels (ns 199 -> 256 = 4 x 64, the
    # cyclic reduction's panel width)
    "burgers_banded_nfex200_64blocks": (0.04724632409564694, 8, dict(K1=112), 0),
}
# The panel-output witness of the bf16-W flagship in the JAX package on the
# CPU (ROADMAP C5): its block panel factorization's LD and W outputs moved
# by -1, 0 or +1 ulp at random, 32 seeds, the bf16-W solver and the f32-W
# control (``_dense_solver("cr")``) through the fused driver, from the
# repository root:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parity.py burgers_bf16_w --witness 32
# label -> (status, iterations) per seed; ``bf16_rounding.py`` holds the
# card's share of solves not optimal to it by the one-sided Fisher test.
BF16_WITNESS_JAX = {
    "bf16 W": [
        ("optimal", 10), ("error", 2), ("error", 2), ("optimal", 9), ("optimal", 11),
        ("optimal", 9), ("optimal", 9), ("optimal", 9), ("optimal", 9), ("optimal", 10),
        ("optimal", 10), ("error", 2), ("optimal", 10), ("optimal", 10), ("optimal", 11),
        ("optimal", 11), ("optimal", 13), ("optimal", 9), ("optimal", 10), ("error", 2),
        ("optimal", 10), ("optimal", 11), ("optimal", 12), ("optimal", 9), ("optimal", 9),
        ("optimal", 9), ("optimal", 9), ("optimal", 10), ("optimal", 12), ("error", 2),
        ("optimal", 9), ("optimal", 11),
    ],
    "f32 W": [
        ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8),
        ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8),
        ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8),
        ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 8),
        ("optimal", 8), ("optimal", 8), ("optimal", 8), ("optimal", 9), ("optimal", 8),
        ("optimal", 8), ("optimal", 7), ("optimal", 8), ("optimal", 8), ("optimal", 8),
        ("optimal", 8), ("optimal", 8),
    ],
}
# The JAX package's iteration counts on the CPU from the initial point and
# from one-ulp perturbations of it (ROADMAP C13/C14), each configuration at
# its full size, from the repository root:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parity.py CONFIG
# prints one JSON line: "jax_fused" and "jax_ip", (status, iterations) of
# the JAX package's fused solve and ``ip_solve`` from the initial point
# and then from each of ``ulp_perturbations(init primals, n)`` (n the
# first entry below; ``run_options`` there says which drivers run the
# ensemble), the same for the port on the CPU ("port_fused", "port_ip"),
# the initial point's digest ("init_digest", ``primal_digest``), the
# teacher-forced comparison ("first_fail", "first_fault") and the faults
# by its rule ("verdict"; PERF.md §6).
# config -> (perturbations, JAX objective, JAX fused counts with the
# unperturbed first, JAX ``ip_solve`` counts likewise, initial point digest
# [, the counts of the JAX package's other ensembles over rounding, which
# ``jax_count_set`` adds to the fused ones])
PARITY = {
    "burgers_ssc_8blocks": (
        16, BENCH_NEW_ROWS["burgers_ssc_8blocks"][0],
        [6, 6, 7, 7, 7, 7, 6, 6, 7, 6, 6, 6, 6, 7, 7, 6, 7],
        [6, 6, 6, 7, 6, 7, 6, 6, 7, 7, 6, 6, 6, 6, 6, 6, 6], "2b23a96446735b55"),
    "burgers_pcg_coupling_8blocks": (
        16, PCG_JAX_OBJECTIVE,
        [7, 7, 6, 6, 7, 7, 7, 7, 7, 6, 6, 6, 7, 6, 6, 7, 7],
        [6, 7, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 6, 6, 6], "2b23a96446735b55"),
    "burgers_two_kinds": (
        16, JAX_OBJECTIVE, [7, 7, 7, 7, 8, 7, 8, 7, 8, 7, 7, 7, 8, 7, 8, 8, 8], [8],
        "f6ee4fea2d558767"),
    "burgers_256blocks_cr": (
        8, BURGERS256_JAX_OBJECTIVE, [10, 9, 11, 10, 10, 10, 10, 10, 10], [10], "95ceeab9c693cd8d"),
    # the JAX ensemble from its ip_solve (XLA does not compile its fused solve)
    "burgers_256blocks_dense_sc": (
        8, BURGERS256_JAX_OBJECTIVE, [11, 10, 10, 10, 10, 10, 10, 10, 10],
        [11, 10, 10, 10, 10, 10, 10, 10, 10], "95ceeab9c693cd8d"),
    # the bf16-W flagship (ROADMAP C5); its counts from the command above,
    # every JAX solve optimal; its other ensembles: the ip_solve one and the
    # optimal solves of the panel-output witness (BF16_WITNESS_JAX)
    "burgers_bf16_w": (
        16, JAX_OBJECTIVE, [11, 11, 11, 11, 10, 11, 10, 11, 11, 10, 11, 10, 10, 10, 10, 10, 9],
        [10, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 10, 9, 9, 10, 10, 10], "f6ee4fea2d558767",
        [10, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 10, 9, 9, 10, 10, 10]
        + [n for st, n in BF16_WITNESS_JAX["bf16 W"] if st == "optimal"]),
}
# configurations whose one-ulp points may end with another status than
# optimal -> the JAX package's fused solves of the ensemble that did
# (ROADMAP C5's rule (c) holds the card's share to it)
PARITY_NOT_OPTIMAL = {"burgers_bf16_w": 0}
# phase 22's configurations: row 10 (15-20 s per solve) only on request
PARITY_CARD = tuple(name for name in PARITY if name != "burgers_256blocks_dense_sc")
BENCH_RUNS = 2  # runs of the bench tool, for the spread of its value
# the rows of phase 21's bench_all child: all of BENCH_NEW_ROWS but row 10,
# whose solves (15-28 s each, four per row in the tool) phase 21 already
# runs in process; cut to keep the script in its time
BENCH_CHILD_ROWS = tuple(name for name in BENCH_NEW_ROWS if name != "burgers_256blocks_dense_sc")
BENCH_TIMEOUT = 300  # seconds for one run of the bench tool
BENCH_ROW_TIMEOUT = 240  # bench_all's --timeout per row
BENCH_ALL_TIMEOUT = 900  # seconds for the whole bench_all child
CSC_MAX_ERR_RTOL = 1e-6

# Panel kernels: kernel and plain version run the same float32 operations in
# the same order per entry (each product rounded before its subtraction, no
# fused multiply-add, IEEE division), so the lower triangle of LD and W must
# be bitwise equal; inertia then is too.  A kernel that reorders or fuses
# that arithmetic must change this check together with it (ROADMAP C5).
# K6: kernel and plain version sum n products twice in float32 in different
# orders.  Rounding errors of such sums grow as a random walk, so each entry
# of either result lies within about sqrt(n) eps_f32 of the exact value,
# relative to the same computation on absolute values (|ref|); the two are
# held to K6_TOL of that unit per entry.  On the CPU, float32 against float64
# at this script's K6 shapes reached at most 0.15 unit, while an f32 W read
# as bf16 reaches 46 to 1354 units (and the check below shows it fails).
F32_EPS = float(np.finfo(np.float32).eps)
K6_TOL = 2.0
# LD mode: card and CPU solve the same float32-factored system and refine it
# in float64 to the adaptive probe's 1e-5 relative residual; the two
# solutions may differ by that residual times the system's conditioning.
LD_SOLUTION_RTOL = 1e-3

SMI = ""
# the host-side launch calls that ``torch.profiler`` records, one per kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


# the perturbation ensembles (ROADMAP C13/C14): ENSEMBLE_SIZE one-ulp
# perturbations of the initial primal point from np.random.default_rng(
# ENSEMBLE_SEED), the same points as tests/test_torch_parity.py's on the CPU
ENSEMBLE_SEED = 0
ENSEMBLE_SIZE = 16
LEAN_P = 0.05


def ulp_perturbations(primals, n, seed=ENSEMBLE_SEED):
    """``n`` copies of an interface's initial primal point ``primals`` (its
    ``init_state().primals`` as a dict of numpy float64 arrays), each
    nonzero entry of ``primals["blocks"]`` moved one ulp up or down at
    random (zeros and the coupling stay): the same seed gives the same
    points on every host."""
    rng = np.random.default_rng(seed)
    x = primals["blocks"]
    out = []
    for _ in range(n):
        up = rng.random(x.shape) < 0.5
        moved = np.where(up, np.nextafter(x, np.inf), np.nextafter(x, -np.inf))
        out.append(dict(primals, blocks=np.where(x != 0, moved, x)))
    return out


def sign_test(ref, other):
    """(up, down, p) of the paired values ``other`` against ``ref`` (one
    pair per point, e.g. two packages' iteration counts from the same
    initial points): the pairs where ``other`` is larger and smaller, and
    the exact two-sided sign test's p-value on those (ties dropped).  A
    lean is p < LEAN_P."""
    up = sum(b > a for a, b in zip(ref, other, strict=True))
    down = sum(b < a for a, b in zip(ref, other))
    n, k = up + down, min(up, down)
    p = min(1.0, 2 * sum(math.comb(n, i) for i in range(k + 1)) / 2**n) if n else 1.0
    return up, down, p


def fisher_greater(bad, n, ref_bad, ref_n):
    """The exact one-sided Fisher test that ``bad`` of ``n`` runs failing
    is a larger share than ``ref_bad`` of ``ref_n``: P(X >= bad) for X
    hypergeometric (``bad + ref_bad`` failures among ``n + ref_n`` runs,
    ``n`` of them drawn).  A fault of rule (c) (ROADMAP C5) is p < LEAN_P."""
    total, fails = n + ref_n, bad + ref_bad
    hits = sum(math.comb(fails, x) * math.comb(total - fails, n - x)
               for x in range(bad, min(fails, n) + 1))
    return hits / math.comb(total, n)


@contextlib.contextmanager
def gate_probes(solver):
    """Record the adaptive refinement's probes of ``solver`` (a
    ``SchurComplementSolver``) while the block runs, as a list of
    (gate fallbacks so far, sqrt(rn2 / thresh), refine again): the probe's
    residual norm over its threshold norm, and its decision (the value
    exceeds 1 or is not finite).  Wraps ``linalg/schur.py::_refine_residual``,
    which every probe calls; the solver keeps no count of its own."""
    from parapint_tpu_torch.linalg import schur

    residual = schur._refine_residual
    probes = []

    def recorded(*args, **kw):
        rn2, thresh = residual(*args, **kw)
        need = bool((~torch.isfinite(rn2) | (rn2 > thresh)).item())
        probes.append((solver.n_gate_fallbacks, float(torch.sqrt(rn2 / thresh)), need))
        return rn2, thresh

    schur._refine_residual = recorded
    try:
        yield probes
    finally:
        schur._refine_residual = residual


@contextlib.contextmanager
def solve_gates(solver):
    """The gate of each ``solve_with_status`` call of ``solver`` while the
    block runs (``gate_of`` of its ``gate_probes``), as a list."""
    gates = []
    with gate_probes(solver) as probes:
        solve = solver.solve_with_status

        def delimited(fact, rhs):
            n, fallbacks = len(probes), solver.n_gate_fallbacks
            out = solve(fact, rhs)
            gates.append(gate_of(probes[n:], fallbacks))
            return out

        solver.solve_with_status = delimited
        try:
            yield gates
        finally:
            del solver.solve_with_status


def gate_of(probes, fallbacks0=0):
    """A solve's gate from its ``gate_probes`` (those of one
    ``solve_with_status`` call, ``fallbacks0`` the solver's fallbacks
    before it): {"fallback": 0 or 1, "passes": [passes on the stored W,
    then on the full W after a fallback], "probes": the (value, decision)
    pairs of each}; None for a solve that probed nothing."""
    if not probes:
        return None
    phases = [[(v, need) for f, v, need in probes if f == fallbacks0],
              [(v, need) for f, v, need in probes if f > fallbacks0]]
    phases = [ph for ph in phases if ph]
    return dict(fallback=len(phases) - 1, passes=[len(ph) - 1 for ph in phases], probes=phases)


def primal_digest(primals):
    """The first 16 hex digits of the SHA-256 of ``primals["blocks"]``'s
    float64 bytes: the ensembles' points are the same on two hosts when
    their initial points have the same digest."""
    import hashlib

    data = np.ascontiguousarray(primals["blocks"], dtype=np.float64).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def say(*parts):
    print(*parts, f"[{SMI}]")


def panel_bound(B, b, with_w):
    """LDL^T of B panels: read A, write LD (and W); b^3/3 multiply-adds for
    the factor, b^3/6 more for W."""
    return bound((3 if with_w else 2) * B * b * b * 4, B * b**3 * (1.0 if with_w else 2.0 / 3.0))


def winv_bound(B, n, nk, itemsize):
    """Read W, d, s, b once, write x; two GEMVs (4 n^2 flops) per block."""
    return bound(B * n * n * itemsize + B * n * 4 + 3 * B * nk * 4, 4.0 * B * n * n)


def phase_device():
    global SMI
    SMI = card_line(torch.device("cuda"))
    print(SMI)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from parapint_tpu_torch.ops.cuda_build import nvcc

    out = subprocess.run([nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(out.stdout.strip().splitlines()[-1])


def phase_build():
    from parapint_tpu_torch.linalg import host_bk
    from parapint_tpu_torch.ops import cuda_build, ldl_panel, read_reduce, winv_apply

    t0 = time.perf_counter()
    paths = cuda_build.build_all([ldl_panel.SOURCE, winv_apply.SOURCE, read_reduce.SOURCE,
                                  host_bk.SOURCE])
    for module in (ldl_panel, winv_apply, read_reduce):
        module._load()
    host_bk._lib()
    print(f"build: {sorted(p.name for p in paths.values())} (nvcc x3, g++ x1, started together) "
          f"in {time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.build_logs.items():
        print(f"--- {name}\n{log.strip()}")


def _inertia(LD):
    d = torch.diagonal(LD, dim1=1, dim2=2)
    return ((d > 0).sum().item(), (d < 0).sum().item(), (d == 0).sum().item())


def _check_panel(name, shape, out_k, out_p):
    """Kernel vs plain panel outputs ((LD,) or (LD, W)): the lower triangle
    of LD and all of W bitwise equal; returns the max error (0)."""
    errs = []
    for i, (k, p) in enumerate(zip(out_k, out_p)):
        kk, pp = (torch.tril(k), torch.tril(p)) if i == 0 else (k, p)
        e = (kk - pp).abs().max().item()
        if not torch.equal(kk, pp):
            raise AssertionError(f"{name} disagrees at {shape}: max|d| {e}, tolerance 0")
        errs.append(e)
    if _inertia(out_k[0]) != _inertia(out_p[0]):
        raise AssertionError(f"{name}: inertia differs at {shape}")
    if torch.triu(out_k[0], 1).abs().max().item() != 0.0:
        raise AssertionError(f"{name} wrote the strict upper triangle")
    say(f"{name} {shape}: max|d| {[f'{e:.3e}' for e in errs]} inertia {_inertia(out_k[0])} "
        f"(tolerance 0: bitwise equal)")
    return max(errs)


def _winv_inputs(B, n, nk, seed, zero_pivot=False):
    rng = np.random.default_rng(seed)
    W = np.tril(rng.standard_normal((B, n, n)) / np.sqrt(n), -1) + np.eye(n)
    d = rng.choice([-1.0, 1.0], (B, n)) * rng.uniform(0.1, 10.0, (B, n))
    if zero_pivot:
        d[:, n // 3] = 0.0
    s = rng.uniform(0.5, 2.0, (B, nk))
    b = rng.standard_normal((B, nk))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    return t(W), t(d), t(s), t(b)


def phase_kernels():
    from parapint_tpu_torch.ops.ldl_panel import (
        ldl_panels,
        ldl_panels_batched,
        ldl_panels_batched_plain,
        ldl_panels_batched_winv,
        ldl_panels_batched_winv_plain,
        ldl_panels_plain,
        ldl_panels_slab,
        ldl_panels_slab_plain,
        ldl_panels_slab_winv,
        ldl_panels_slab_winv_plain,
        random_panels,
    )
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused, winv_apply_plain

    cuda = lambda a: torch.as_tensor(a, device="cuda")
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0}
    entries = {
        "K1": (ldl_panels_slab_winv, ldl_panels_slab_winv_plain),
        "K2": (lambda A: (ldl_panels_slab(A),), lambda A: (ldl_panels_slab_plain(A),)),
        "K3": (ldl_panels_batched_winv, ldl_panels_batched_winv_plain),
        "K4": (lambda A: (ldl_panels_batched(A),), lambda A: (ldl_panels_batched_plain(A),)),
        "K5": (lambda A: (ldl_panels(A),), lambda A: (ldl_panels_plain(A),)),
    }
    # K3/K4: the column phase's widths (128, and 56 for the CR tiles), the
    # odd widths a block_size that is not a multiple of 8 gives (50, 100,
    # 127) and the degenerate 1-wide panel
    batched = [((64, 128, 128), {}), ((32, 56, 56), {}), ((32, 50, 50), {}), ((64, 100, 100), {}),
               ((16, 127, 127), {}), ((3, 1, 1), {}), ((32, 50, 50), {"garbage_upper": True}),
               ((64, 100, 100), {"zero_pivot": True}), ((16, 127, 127), {"garbage_upper": True}),
               ((3, 1, 1), {"zero_pivot": True})]
    cases = {
        "K1": [((64, 64, 64), {}), ((64, 128, 128), {}), ((32, 56, 56), {}), ((1, 56, 56), {}),
               ((3, 8, 8), {}), ((64, 64, 64), {"garbage_upper": True}),
               ((32, 56, 56), {"zero_pivot": True})],
        "K2": [((64, 128, 128), {}), ((32, 56, 56), {}), ((3, 8, 8), {}),
               ((64, 128, 128), {"garbage_upper": True}), ((32, 56, 56), {"zero_pivot": True})],
        "K3": batched,
        "K4": batched,
        "K5": [((1, 128, 128), {}), ((1, 13, 13), {}), ((4, 15, 15), {}),
               ((1, 128, 128), {"garbage_upper": True}), ((4, 15, 15), {"zero_pivot": True})],
    }
    for key, shapes in cases.items():
        kern, plain = entries[key]
        for i, (shape, kw) in enumerate(shapes):
            A = cuda(random_panels(*shape[:2], seed=i, **kw))
            out_k = kern(A)
            torch.cuda.synchronize()
            err[key] = max(err[key], _check_panel(f"{key} {kw or ''}", shape, out_k, plain(A)))
    # every width 1..128 through both instantiations: the first and the last
    # 8-column slab of the kernel at every raggedness, bitwise
    for b in range(1, 129):
        A = cuda(random_panels(3, b, seed=b, zero_pivot=b % 3 == 0))
        LD3, W3 = ldl_panels_batched_winv(A)
        LD4 = ldl_panels_batched(A)
        torch.cuda.synchronize()
        LDp, Wp = ldl_panels_batched_winv_plain(A)
        if not (torch.equal(LD3, LDp) and torch.equal(W3, Wp) and torch.equal(LD4, LDp)):
            raise AssertionError(f"width sweep: K3/K4 differ from the plain sweep at (3, {b}, {b})")
    say("width sweep b = 1..128 at B = 3: K3 (with W) and K4 (no W) bitwise equal to the plain sweep")

    # the dense flagship's shape, the stochastic QP's (32 scenarios, nk = n =
    # 1024, no padding) and edge cases
    winv_cases = [((64, 1024, 922), False), ((32, 1024, 1024), False), ((13, 256, 200), False),
                  ((7, 64, 64), True), ((3, 24, 20), True)]
    for (B, n, nk), zp in winv_cases:
        W, d, s, b = _winv_inputs(B, n, nk, seed=n, zero_pivot=zp)
        for Wt in (W, W.to(torch.bfloat16)):
            x_k = winv_apply_fused(Wt, d, s, b)
            x_p = winv_apply_plain(Wt, d, s, b)
            unit = np.sqrt(n) * F32_EPS * winv_apply_plain(Wt.abs(), d.abs(), s.abs(), b.abs())
            e = (x_k - x_p).abs().max().item()
            ratio = ((x_k - x_p).abs() / unit).max().item()
            if not ratio <= K6_TOL:
                raise AssertionError(f"K6 disagrees at {(B, n, nk)} {Wt.dtype}: "
                                     f"{ratio} units > {K6_TOL}")
            power = ""
            if Wt.dtype == torch.float32:
                # the tolerance must reject an f32 W read as bf16
                x_bf = winv_apply_plain(Wt.to(torch.bfloat16), d, s, b)
                bf_ratio = ((x_bf - x_p).abs() / unit).max().item()
                if not bf_ratio > K6_TOL:
                    raise AssertionError(f"K6 tolerance passes a bf16 read of W at {(B, n, nk)}")
                power = f"; this W read as bf16: {bf_ratio:.1f} units"
            err["K6"] = max(err["K6"], e)
            say(f"K6 {(B, n, nk)} W {Wt.dtype} zero_pivot={zp}: max|d| {e:.3e}, max "
                f"|d|/unit {ratio:.4f} (tol {K6_TOL} units per entry, unit sqrt(n) eps_f32 |ref| "
                f"on |W|,|d|,|s|,|b|{power})")

    # times at the dense path's shapes (median of 7 CUDA-event windows)
    timing = {}

    def time_panel(key, shape):
        kern, plain = entries[key]
        A = cuda(random_panels(*shape[:2], seed=100))
        ms = timed_loop(lambda: kern(A), 20)
        plain_ms = timed_loop(lambda: plain(A), 2, trials=3)
        bd, by = panel_bound(shape[0], shape[1], key in ("K1", "K3"))
        say(f"time {key} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bd:.5f} ms ({by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by, library_ms=None, shape=shape)

    timing["K1"] = time_panel("K1", (64, 128, 128))
    for shape in [(64, 64, 64)] + [(e, 56, 56) for e in (32, 16, 8, 4, 2, 1)]:
        time_panel("K1", shape)
    timing["K2"] = time_panel("K2", (64, 128, 128))
    timing["K3"] = time_panel("K3", (64, 128, 128))
    time_panel("K3", (64, 100, 100))
    timing["K4"] = time_panel("K4", (64, 128, 128))
    timing["K5"] = time_panel("K5", (1, 128, 128))

    def time_winv(key, B, n, nk, bf16=False):
        W, d, s, b = _winv_inputs(B, n, nk, seed=7)
        Wt = W.to(torch.bfloat16) if bf16 else W
        Wf = Wt.float()
        v = torch.nn.functional.pad(b * s, (0, n - nk))[:, :, None]
        dsafe = torch.where(d.abs() > 0, d, torch.ones_like(d))[:, :, None]
        ms = timed_loop(lambda: winv_apply_fused(Wt, d, s, b), 20)
        plain_ms = timed_loop(lambda: winv_apply_plain(Wt, d, s, b), 5)
        # the library yardstick: the same function as two torch.matmul calls
        # on an f32 W (the port never calls it)
        lib_ms = timed_loop(lambda: Wf.transpose(1, 2) @ ((Wf @ v) / dsafe), 20)
        bd, by = winv_bound(B, n, nk, Wt.element_size())
        say(f"time {key} {(B, n, nk)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (two calls) {lib_ms:.4f} ms, bound {bd:.5f} ms ({by}), "
            f"{B * n * n * Wt.element_size() / (ms * 1e-3) / 1e9:.1f} GB/s of W")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by,
                    library_ms=lib_ms, library="two torch.matmul calls", shape=(B, n, nk))

    timing["K6"] = time_winv("K6", 64, 1024, 922)
    timing["K6 bf16"] = time_winv("K6 bf16", 64, 1024, 922, bf16=True)
    timing["K6 QP"] = time_winv("K6 QP", 32, 1024, 1024)
    return err, timing


def _panel_entries():
    from parapint_tpu_torch.ops import ldl_panel

    return dict(K1=ldl_panel.ldl_panels_slab_winv, K2=ldl_panel.ldl_panels_slab,
                K3=ldl_panel.ldl_panels_batched_winv, K4=ldl_panel.ldl_panels_batched,
                K5=ldl_panel.ldl_panels)


def _reset_counts():
    from parapint_tpu_torch.ops.read_reduce import read_reduce
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused

    for fn in (*_panel_entries().values(), winv_apply_fused, read_reduce):
        fn.launches = 0
    winv_apply_fused.launches_bf16 = 0


def _counts():
    from parapint_tpu_torch.ops.read_reduce import read_reduce
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused

    counts = {k: fn.launches for k, fn in _panel_entries().items()}
    counts.update(K6=winv_apply_fused.launches, K6_bf16=winv_apply_fused.launches_bf16,
                  K7=read_reduce.launches)
    return counts


def phase_kernel_lab():
    """K7 against its plain version, then the kernel lab's measurement path
    (``bw``, ``solve``, ``mxu``, ``dispatch`` at their default shapes) with
    every count zeroed just before it and read just after.  Returns (K7
    launches, K7's timing row, K7's best measured read rate in bytes/s)."""
    from parapint_tpu_torch.ops.read_reduce import ROWS_PER_CTA, read_reduce, read_reduce_plain
    from parapint_tpu_torch.tools import kernel_lab

    rng = np.random.default_rng(7)
    for B, n in ((64, 1024), (3, 8), (5, 56)):
        W = torch.as_tensor(rng.standard_normal((B, n, n), dtype=np.float32), device="cuda")
        for rows in kernel_lab.BW_ROWS:
            out_k = read_reduce(W, rows)
            torch.cuda.synchronize()
            out_p = read_reduce_plain(W, rows)
            e = (out_k - out_p).abs().max().item()
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"K7 disagrees at {(B, n, n)} rows_per_cta={rows}: max|d| {e}")
            say(f"K7 {(B, n, n)} rows_per_cta={rows}: max|d| {e:.3e} (tolerance 0: bitwise equal)")
        if B == 64:
            plain_ms = timed_loop(lambda: read_reduce_plain(W), 3, trials=3)
    del W

    _reset_counts()
    torch.cuda.synchronize()
    lab = {cmd: getattr(kernel_lab, f"cmd_{cmd}")(kernel_lab.parse_args([cmd]))
           for cmd in ("bw", "solve", "mxu", "dispatch")}
    torch.cuda.synchronize()
    c = _counts()
    say(f"kernel lab: launches {c}")
    if not c["K7"] > 0:
        raise AssertionError("kernel lab: no K7 launch")
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("kernel lab: mxu left the matmul precision changed")
    bw = lab["bw"]
    B, n, _ = bw["shape"]
    bd, by = bound(B * n * n * 4 + B * n * 4, B * n * n)
    timing = dict(ms=bw["rows"][ROWS_PER_CTA]["ms"], plain_ms=plain_ms, bound_ms=bd, bound_by=by,
                  library_ms=bw["library_ms"], library="torch.sum(W, dim=1, keepdim=True)",
                  shape=bw["shape"])
    say(f"time K7 {bw['shape']} rows_per_cta={ROWS_PER_CTA}: kernel {timing['ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {timing['library_ms']:.4f} ms, bound {bd:.5f} ms ({by})")
    rate = max(r["gbps"] for r in bw["rows"].values()) * 1e9
    return c["K7"], timing, rate


def _dense_solver(coupling="cr", w_store=None, refine=0):
    import parapint_tpu_torch as ptt

    return ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
        refine_steps=refine, w_store_dtype=w_store,
        schur_complement_solver=ptt.BlockTridiagSolver() if coupling == "cr" else None,
    )


def _dense_iface(device="cuda"):
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    spec = burgers.build_spec(**FLAGSHIP, device=device)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=torch.float32)
    print(f"dense interface {FLAGSHIP}: nk {iface.nk} ns {iface.ns} ncv {iface.ncv} "
          f"setup {time.perf_counter() - t0:.2f} s")
    return iface


def burgers_two_kinds(spec, kkt_dtype=None, mesh=None):
    """The Burgers family of ``spec`` (a uniform ``DynamicModelSpec``) as a
    ``HeterogeneousDynamicInterface`` of two kinds: kind 0 (block 0) keeps
    every equality row, kind 1 (the other blocks) lacks the
    initial-condition rows that the uniform spec masks out there.  ``mesh``
    as for the interface."""
    import parapint_tpu_torch as ptt

    dev = spec.device
    keep = torch.as_tensor(np.nonzero(spec.eq_mask[1])[0], device=dev)
    t0 = spec.params["t0"]
    kw = dict(objective=spec.objective, n_x=spec.n_x, xl=spec.xl[0], xu=spec.xu[0],
              start_state_idx=spec.start_state_idx, end_state_idx=spec.end_state_idx,
              example_params={"t0": t0[0]})
    kinds = [
        ptt.KindSpec(eq_constraints=spec.eq_constraints, **kw),
        ptt.KindSpec(eq_constraints=lambda x, p: spec.eq_constraints(x, p)[keep], **kw),
    ]
    N = spec.num_blocks
    return ptt.HeterogeneousDynamicInterface(
        kinds, [0] + [1] * (N - 1), [{"t0": t0[b]} for b in range(N)],
        [spec.x0[b].cpu().numpy() for b in range(N)], mesh=mesh, kkt_dtype=kkt_dtype, device=dev,
    )


RESULT_ACCESSORS = (
    "get_primals", "get_coupling_values", "get_slacks", "get_duals_eq", "get_duals_ineq",
    "get_duals_primals_lb", "get_duals_primals_ub", "get_duals_slacks_lb", "get_duals_slacks_ub",
    "get_duals_backward", "get_duals_forward", "get_first_stage_values",
    "get_duals_nonanticipativity",
)
RESULT_COUNTS = ("n_primals", "n_eq_constraints", "n_ineq_constraints")


def results(iface) -> dict:
    """What a user reads from a structured interface of either package (the
    port's or the JAX package's) about its current state, under the JAX
    package's names: every accessor of ``RESULT_ACCESSORS`` that the
    interface's kind has (a dict result flattened to "name/key"),
    ``get_block_primals(i)`` of every block and the counts."""
    out = {}
    for name in RESULT_ACCESSORS:
        if hasattr(iface, name):
            v = getattr(iface, name)()
            out.update({f"{name}/{k}": a for k, a in v.items()} if isinstance(v, dict) else {name: v})
    for i in range(iface.N):
        out[f"get_block_primals/{i}"] = iface.get_block_primals(i)
    out.update({name: getattr(iface, name)() for name in RESULT_COUNTS})
    return out


def warm_fields(iface) -> dict:
    """The warm-start fields of a spec (``x0``, ``c0``, ``y_eq0``, ``lam0``,
    ``y_ineq0``, ``zl0``, ``zu0``) from a solved dynamic interface's
    accessors, either package's (tests/test_warmstart_ownership.py)."""
    duals = iface.get_duals_eq()
    return dict(x0=iface.get_primals()["blocks"], c0=iface.get_coupling_values(),
                y_eq0=duals["own"], lam0=duals["link"], y_ineq0=iface.get_duals_ineq(),
                zl0=iface.get_duals_primals_lb()["blocks"],
                zu0=iface.get_duals_primals_ub()["blocks"])


def result_shapes(iface) -> dict:
    """{name: shape} of :func:`results` (a count's shape is ())."""
    return {k: tuple(getattr(v, "shape", ())) for k, v in results(iface).items()}


def _objective_gap(iface, result, label, ref=JAX_OBJECTIVE):
    import parapint_tpu_torch as ptt

    if result.status != ptt.InteriorPointStatus.optimal.value:
        raise AssertionError(f"{label}: status {result.status} after {result.iterations} iterations")
    for v in result.state.primals.values():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite primals")
    iface._current_state = result.state
    obj = float(iface.evaluate_objective())
    gap = abs(obj - ref) / max(1.0, abs(ref))
    if gap > OBJ_REL_GAP:
        raise AssertionError(f"{label}: objective {obj!r}, gap {gap} to JAX {ref!r} > {OBJ_REL_GAP}")
    return obj, gap


def _reset_solver(solver):
    for attr in ("n_numeric", "n_solves"):
        if hasattr(solver, attr):
            setattr(solver, attr, 0)
    if hasattr(solver, "cg_iterations"):
        solver.cg_iterations = []


def _solver_counts(solver, counts):
    """The solver's numerics, back solves and (PCG) CG iterations per back
    solve, added to ``counts``."""
    counts["numerics"] = solver.n_numeric
    counts["solves"] = getattr(solver, "n_solves", None)
    if hasattr(solver, "cg_iterations"):
        counts["cg"] = list(solver.cg_iterations)


def _counted_solve(iface, solver, label, timed=0, ref=JAX_OBJECTIVE, tol=TOL, repeat=False):
    """One counted solve through ``make_fused_ip_solve`` (every count zeroed
    just before, read just after), then ``timed`` timed solves; returns
    (result, counts) with the counted solve's iterations and objective in
    the counts and whether the timed solves repeated its objective bit for
    bit, which ``repeat`` requires."""
    import parapint_tpu_torch as ptt

    opts = ptt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    state0 = iface.init_state()
    _reset_counts()
    _reset_solver(solver)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = solve(state0)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    _solver_counts(solver, counts)
    obj, gap = _objective_gap(iface, result, label, ref)
    counts["iterations"], counts["objective"] = result.iterations, obj
    walls, repeats = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = solve(state0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        repeats.append(_objective_gap(iface, result, label, ref)[0] == obj)
    counts["repeats_bitwise"] = all(repeats)
    say(f"{label}: status optimal, iterations {counts['iterations']}, objective {obj!r} "
        f"(JAX {ref!r}, rel gap {gap:.3e}), primal_inf {float(result.primal_inf):.3e}, "
        f"untimed counted solve {first:.3f} s, launches {counts}")
    if walls:
        wall = min(walls)
        say(f"{label}: wall per solve {wall:.4f} s (min of {[round(w, 4) for w in walls]}), "
            f"iter/s {(result.iterations - 1) / wall:.3f} ((n_iter-1)/wall); timed solves "
            f"repeat the objective bit for bit: {counts['repeats_bitwise']}")
    if repeat and not (walls and counts["repeats_bitwise"]):
        raise AssertionError(f"{label}: a solve from the same state did not repeat bit for bit")
    counts["counted_wall_s"], counts["wall_s"] = first, min(walls, default=None)
    return result, counts


def phase_dense(iface):
    result, c = _counted_solve(iface, _dense_solver("cr"), "dense flagship", timed=3)
    print(f"dense flagship: iterations {result.iterations} (JAX dense path {JAX_DENSE_ITERATIONS})")
    if not (c["K1"] > 0 and c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"K1: {c['K1']} launches for {c['numerics']} numerics")
    if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"]):
        raise AssertionError(f"K6: {c['K6']} launches for {c['solves']} back solves")
    return c


def phase_results(iface, cold):
    """Phase 4b: what a user reads after phase 4's cold solve, then a warm
    start from it.  Every accessor's shape equal to the JAX package's
    (``FLAGSHIP_JAX_SHAPES``), the counts equal to its counts, n_primals ==
    N n + ncv, the backward and forward duals equal to the link duals times
    their masks; then a spec warm from the accessors (primals, coupling,
    own and link duals, inequality and bound duals) solved through the
    fused driver: optimal at the JAX objective, iterations at or below the
    cold ones and within 1 of the JAX package's warm count, K1 == 14 x
    numerics, K6 == 2 x back solves.  Returns (the warm solve's counts,
    the cold final primals on the CPU)."""
    import parapint_tpu_torch as ptt

    N, ns = iface.N, iface.ns
    want = dict(FLAGSHIP_JAX_SHAPES, **{f"get_block_primals/{i}": FLAGSHIP_JAX_BLOCK_SHAPE
                                        for i in range(N)})
    shapes = result_shapes(iface)
    if shapes != want:
        bad = {k: (shapes.get(k), want.get(k)) for k in set(shapes) | set(want)
               if shapes.get(k) != want.get(k)}
        raise AssertionError(f"results: shapes (port, JAX) differ: {bad}")
    counts = {k: getattr(iface, k)() for k in RESULT_COUNTS}
    if counts != FLAGSHIP_JAX_COUNTS or counts["n_primals"] != N * iface.n + iface.ncv:
        raise AssertionError(f"results: counts {counts}, JAX {FLAGSHIP_JAX_COUNTS}")
    link, mask = iface.get_duals_eq()["link"], iface.link_mask
    if not (torch.equal(iface.get_duals_backward(), link[:, :ns] * mask[:, :ns])
            and torch.equal(iface.get_duals_forward(), link[:, ns:] * mask[:, ns:])):
        raise AssertionError("results: backward/forward duals are not the masked link duals")
    say(f"results of the dense flagship: {len(shapes)} accessor values, every shape equal to the "
        f"JAX package's; {counts}")
    cold_x = {k: v.cpu() for k, v in iface.get_primals().items()}

    t0 = time.perf_counter()
    fields = warm_fields(iface)
    warm = ptt.DynamicSchurComplementInteriorPointInterface(
        dataclasses.replace(iface.spec, **fields), kkt_dtype=torch.float32)
    state0 = warm.init_state()
    if not (torch.equal(state0.primals["coupling"], fields["c0"])
            and torch.equal(state0.duals_eq["own"], fields["y_eq0"])):
        raise AssertionError("warm start: the warm values did not enter init_state")
    setup = time.perf_counter() - t0
    _, c = _counted_solve(warm, _dense_solver("cr"), "warm-started dense flagship", timed=1)
    say(f"warm-started dense flagship: {c['iterations']} iterations (cold {cold['iterations']}, "
        f"JAX warm {WARM_JAX_ITERATIONS}), warm spec and interface {setup:.3f} s, numerics "
        f"{c['numerics']}, back solves {c['solves']}, K1 {c['K1']}, K6 {c['K6']}")
    if not (c["iterations"] <= cold["iterations"]
            and abs(c["iterations"] - WARM_JAX_ITERATIONS) <= 1):
        raise AssertionError(f"warm start: {c['iterations']} iterations, cold {cold['iterations']}, "
                             f"JAX warm {WARM_JAX_ITERATIONS}")
    _check("warm start", c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"]
           and c["K6"] == 2 * c["solves"], c)
    return c, cold_x


def phase_dense_sc(iface):
    _, c = _counted_solve(iface, _dense_solver("dense"), "dense SC")
    if not (c["K5"] > 0 and c["K5"] == SC_PANELS_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"K5: {c['K5']} launches for {c['numerics']} numerics")
    return c


def _bf16_solver():
    return _dense_solver("cr", w_store=torch.bfloat16, refine=None)


def phase_bf16(iface):
    """The dense flagship with W stored in bf16 (ROADMAP C5): optimal at
    the JAX objective, iterations within 1 of the JAX package's fused count
    and in its ensemble's set (``_hold_count``), bf16 K6 launched; each
    back solve's gate printed (fallback to the f32 W, refinement passes on
    each W, the probe values)."""
    solver = _bf16_solver()
    with solve_gates(solver) as gates:
        _, c = _counted_solve(iface, solver, "bf16 W")
    name = "burgers_bf16_w"
    print(f"bf16 W: auto-gate fell back to the f32 W in {solver.n_gate_fallbacks} of "
          f"{len(gates)} solve(s); per solve (fallback, passes per W, probe values): " + "; ".join(
              f"{g['fallback']} {g['passes']} " + str([[float(f"{v:.3g}") for v, _ in ph]
                                                       for ph in g["probes"]]) for g in gates))
    _hold_count("bf16 W", c["iterations"], PARITY[name][2][0], name)
    if not c["K6_bf16"] > 0:
        raise AssertionError("bf16 W: no bf16 K6 launch")
    return c


def _to_cpu(obj):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu()
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def _first_kkt(iface):
    """The flagship's first-iteration KKT and rhs (initial state, initial
    barrier)."""
    import parapint_tpu_torch as ptt

    state0 = iface.init_state()
    mu0 = torch.tensor(ptt.IPOptions().init_barrier_parameter, dtype=torch.float64, device=iface.device)
    data = iface.kkt_from_ad(state0, iface.eval_ad(state0), mu0)
    return iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)


def phase_ld(iface):
    import parapint_tpu_torch as ptt

    kkt, rhs = _first_kkt(iface)
    solver = ptt.SchurComplementSolver(block_size=128)
    _reset_counts()
    fact = solver.numeric(kkt)
    x, status = solver.solve_with_status(fact, rhs)
    torch.cuda.synchronize()
    c = _counts()
    cpu = ptt.SchurComplementSolver(block_size=128)
    fact_p = cpu.numeric(_to_cpu(kkt))
    x_p, status_p = cpu.solve_with_status(fact_p, _to_cpu(rhs))
    inert_k = tuple(int(v) for v in fact.inertia.cpu())
    inert_p = tuple(int(v) for v in fact_p.inertia)
    dx = max((x.blocks.cpu() - x_p.blocks).abs().max().item(),
             (x.coupling.cpu() - x_p.coupling).abs().max().item())
    scale = max(x_p.blocks.abs().max().item(), x_p.coupling.abs().max().item())
    say(f"LD mode first KKT: inertia card {inert_k} cpu {inert_p}, status {int(status)}/{int(status_p)}, "
        f"max|dx| {dx:.3e} (max|x| {scale:.3e}, tol {LD_SOLUTION_RTOL} x max|x|), launches {c}")
    if inert_k != inert_p:
        raise AssertionError("LD mode: inertia differs between card and CPU")
    if dx > LD_SOLUTION_RTOL * scale:
        raise AssertionError(f"LD mode: solutions differ by {dx}")
    if c["K2"] != LD_K2_PER_NUMERIC or c["K5"] != SC_PANELS_PER_NUMERIC:
        raise AssertionError(f"LD mode: K2 {c['K2']} K5 {c['K5']} launches for one numeric")
    return c, fact.block_LD


def phase_column(iface, slab, slab_LD):
    """``PT_PANEL_ALGO=column`` sends every float32 panel to the
    column-by-column entries: K3 and K4 run the same kernel instantiations as
    K1 and K2, so the dense flagship and the LD-mode factor must repeat the
    slab runs bit for bit.  Then a block_size of 100 sends the block panels
    to K3 under the default algorithm."""
    import parapint_tpu_torch as ptt

    before = os.environ.get("PT_PANEL_ALGO")
    os.environ["PT_PANEL_ALGO"] = "column"
    try:
        _, c = _counted_solve(iface, _dense_solver("cr"), "column dense flagship")
        print(f"column dense flagship: iterations {c['iterations']} objective {c['objective']!r} "
              f"(slab run: {slab['iterations']} {slab['objective']!r})")
        if not (c["K3"] > 0 and c["K3"] == DENSE_K1_PER_NUMERIC * c["numerics"] and c["K1"] == 0):
            raise AssertionError(f"column: K3 {c['K3']} K1 {c['K1']} launches for {c['numerics']} numerics")
        if (c["iterations"], c["objective"]) != (slab["iterations"], slab["objective"]):
            raise AssertionError("column: the dense flagship differs from the slab run")
        kkt, rhs = _first_kkt(iface)
        _reset_counts()
        fact = ptt.SchurComplementSolver(block_size=128).numeric(kkt)
        torch.cuda.synchronize()
        c_ld = _counts()
        same = torch.equal(fact.block_LD, slab_LD)
        say(f"column LD mode first KKT: launches {c_ld}, LD equal to the slab run's bit for bit: {same}")
        if c_ld["K4"] != LD_K2_PER_NUMERIC or c_ld["K2"] != 0 or not same:
            raise AssertionError(f"column LD mode: K4 {c_ld['K4']} K2 {c_ld['K2']} equal {same}")
        del fact
    finally:
        if before is None:
            os.environ.pop("PT_PANEL_ALGO")
        else:
            os.environ["PT_PANEL_ALGO"] = before

    def w100():
        return ptt.SchurComplementSolver(
            block_size=100, explicit_inverse=True, factor_dtype=torch.float32,
            schur_complement_solver=ptt.BlockTridiagSolver(),
        )

    _reset_counts()
    fact = w100().numeric(kkt)
    torch.cuda.synchronize()
    c100 = _counts()
    fact_p = w100().numeric(_to_cpu(kkt))
    inert_k = tuple(int(v) for v in fact.inertia.cpu())
    inert_p = tuple(int(v) for v in fact_p.inertia)
    status = (int(fact.status), int(fact_p.status))
    say(f"block_size=100 W-form numeric of the first KKT: inertia card {inert_k} cpu {inert_p}, "
        f"status {status}, launches {c100}")
    if c100["K3"] != W100_K3_PER_NUMERIC or c100["K1"] != W100_K1_PER_NUMERIC:
        raise AssertionError(f"block_size=100: K3 {c100['K3']} K1 {c100['K1']} launches")
    if inert_k != inert_p or status != (0, 0):
        raise AssertionError("block_size=100: inertia or status differs between card and CPU")
    return c, c_ld


def phase_fixed_order(iface, device="cuda"):
    """ROADMAP C9: the "scatter" topology's three float64 sums (the SC
    assembly ``_scatter_sc``, the border apply ``_border_apply_local`` and
    the interface's ``_scatter_link_duals_to_coupling``) at the dense
    flagship's size (N 64, L 98, nc 3087), on its chain row map (every
    group hit by two blocks, dump rows) and on a seeded random map: each
    called twice on the same CUDA inputs must repeat bit for bit.  The
    atomic scatter-add they replaced is run beside them for the record."""
    from parapint_tpu_torch.linalg.schur import _border_apply_local, _scatter_sc

    rng = np.random.default_rng(9)
    N, L, nc, nk = iface.N, iface.n_link, iface.ncv, iface.nk
    t = lambda a: torch.as_tensor(a, device=device)
    S = t(rng.standard_normal((N, L, L)))
    border = t(rng.standard_normal((N, L, nk)))
    v = t(rng.standard_normal((N, nk)))
    maps = {"chain map": iface.row_idx, "random map": t(rng.integers(0, nc + 1, size=(N, L)))}
    for name, row_idx in maps.items():
        r = row_idx.long()
        atomic = []
        for _ in range(2):
            out = torch.zeros((nc + 1, nc + 1), dtype=S.dtype, device=device)
            out.index_put_((r[:, :, None].expand(N, L, L), r[:, None, :].expand(N, L, L)), S,
                           accumulate=True)
            atomic.append(out[:nc, :nc])
        for label, fn in (("_scatter_sc", lambda: _scatter_sc(S, row_idx, nc)),
                          ("_border_apply_local", lambda: _border_apply_local(border, row_idx, v, nc))):
            a, b = fn(), fn()
            say(f"C9 {label} {name} {tuple(a.shape)}: repeats bit for bit {torch.equal(a, b)}"
                + (f"; the atomic scatter-add repeats: {torch.equal(*atomic)}, "
                   f"max|fixed - atomic| {(a - atomic[0]).abs().max().item():.3e}"
                   if label == "_scatter_sc" else ""))
            if not torch.equal(a, b):
                raise AssertionError(f"C9: {label} on the {name} did not repeat")
    duals = {"link": t(rng.standard_normal((N, L)))}
    before = iface.sc_assembly
    iface.sc_assembly = "scatter"
    try:
        a = iface._scatter_link_duals_to_coupling(duals)
        b = iface._scatter_link_duals_to_coupling(duals)
    finally:
        iface.sc_assembly = before
    say(f"C9 _scatter_link_duals_to_coupling {tuple(a.shape)}: repeats bit for bit {torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError("C9: _scatter_link_duals_to_coupling did not repeat")


def phase_banded():
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    spec = burgers.build_spec(**FLAGSHIP)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form="banded"
    )
    solver = ptt.BandedSchurComplementSolver(
        tile_size=TILE_SIZE, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)
    )
    print(f"banded interface {FLAGSHIP}: nk {iface.nk} p {iface.banded_plan.p} "
          f"setup {time.perf_counter() - t0:.2f} s")
    result, c = _counted_solve(iface, solver, "banded flagship", timed=1)
    print(f"banded flagship: iterations {result.iterations} (JAX {JAX_ITERATIONS})")
    if not (c["K1"] > 0 and c["K1"] == BANDED_PANELS_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"banded: {c['K1']} K1 launches for {c['numerics']} numerics")
    return c, iface


def _timer_lines(timer, depth=3):
    """The timer's phases down to ``depth`` levels, as one line."""
    out = []

    def walk(node, prefix, level):
        for name, child in node.children.items():
            out.append(f"{prefix}{name} {child.total:.3f} s (n={child.count})")
            if level < depth:
                walk(child, prefix + name + "/", level + 1)

    walk(timer._root, "", 1)
    return "; ".join(out)


@contextlib.contextmanager
def captured_log(name):
    """The messages of logger ``name`` (at DEBUG) while the block runs."""
    logger = logging.getLogger(name)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler, level = Keep(logging.DEBUG), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _counted_ip_solve(iface, solver, label, ref, ref_iters, tol=TOL, ref_set=None):
    """One ``ip_solve`` with every count zeroed just before and read just
    after, its log table and inertia-correction lines printed after it
    (each prefixed with ``label``): optimal, the JAX objective and
    iterations within 1 of ``ref_iters`` (``ip_solve`` iterations are its
    convergence checks), or, given ``ref_set``, in that set."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.utils.timer import HierarchicalTimer

    opts = ptt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    timer = HierarchicalTimer()
    _reset_counts()
    _reset_solver(solver)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_log("parapint_tpu_torch.algorithms.interior_point") as lines:
        status = ptt.ip_solve(iface, opts, timer=timer)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in lines:
        print(f"{label} | {line}")
    c = _counts()
    _solver_counts(solver, c)
    n_iter = timer._root.children["IP solve"].children["convergence check"].count
    obj = float(iface.evaluate_objective())
    gap = abs(obj - ref) / max(1.0, abs(ref))
    c["iterations"], c["objective"] = n_iter, obj
    say(f"{label}: status {status.name}, iterations {n_iter} (JAX {ref_iters}), "
        f"objective {obj!r} (JAX {ref!r}, rel gap {gap:.3e}), wall {wall:.4f} s, launches {c}")
    say(f"{label} phases: {_timer_lines(timer)}")
    if status != ptt.InteriorPointStatus.optimal or gap > OBJ_REL_GAP:
        raise AssertionError(f"{label}: {status.name}, gap {gap}")
    if (abs(n_iter - ref_iters) > 1) if ref_set is None else (n_iter not in ref_set):
        raise AssertionError(f"{label}: {n_iter} iterations, JAX {ref_iters} "
                             f"(its ensembles' set {ref_set})")
    return c


def phase_stochastic_qp(device="cuda", shape=QP, ref=QP_JAX_OBJECTIVE,
                        ref_iters=(QP_JAX_ITERATIONS, QP_JAX_IP_ITERATIONS)):
    """The two-stage stochastic QP through both drivers.  The float32 KKT
    with a float64 factor makes ``check_precision_compat`` warn, as it does
    in the JAX package for the same configuration."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    def solver():
        return ptt.SchurComplementSolver(
            block_size=128, explicit_inverse=True, factor_dtype=torch.float64,
            apply_dtype=torch.float32,
        )

    def kernels_ok(c, label):
        panels = {k: c[k] for k in ("K1", "K2", "K3", "K4")}
        if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"] and c["K5"] == c["numerics"] > 0
                and not any(panels.values())):
            raise AssertionError(f"{label}: launches {c}")

    t0 = time.perf_counter()
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**shape, device=device), kkt_dtype=torch.float32
    )
    print(f"stochastic QP {shape}: nk {iface.nk} ncv {iface.ncv} blocks {iface.N} "
          f"setup {time.perf_counter() - t0:.2f} s")
    result, c = _counted_solve(iface, solver(), "stochastic QP fused", timed=1, ref=ref, repeat=True)
    print(f"stochastic QP fused: iterations {c['iterations']} (JAX {ref_iters[0]}); "
          f"K5 {c['K5']} for {c['numerics']} numerics, K6 {c['K6']} for {c['solves']} back solves")
    kernels_ok(c, "stochastic QP fused")
    if abs(c["iterations"] - ref_iters[0]) > 1:
        raise AssertionError(f"stochastic QP fused: {c['iterations']} iterations, JAX {ref_iters[0]}")

    c_ip = _counted_ip_solve(iface, solver(), "stochastic QP ip_solve", ref, ref_iters[1])
    print(f"stochastic QP ip_solve: K5 {c_ip['K5']} for {c_ip['numerics']} numerics, "
          f"K6 {c_ip['K6']} for {c_ip['solves']} back solves")
    kernels_ok(c_ip, "stochastic QP ip_solve")
    return c, c_ip


def phase_farmer(device="cuda", family_ref=(FARMER32_JAX_OBJECTIVE, FARMER32_JAX_ITERATIONS),
                 n_scenarios=32):
    """The farmer through ``examples/stochastic.main`` (``ip_solve``) and the
    farmer family through the fused driver."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    _reset_counts()
    t0 = time.perf_counter()
    acre = stochastic.main(device=device).get_first_stage_values().cpu().numpy()
    wall = time.perf_counter() - t0
    err = float(np.abs(acre - np.asarray(FARMER_ACRES)).max())
    say(f"farmer (examples/stochastic.main): acreage {acre.tolist()}, max|d| to "
        f"{FARMER_ACRES} {err:.3e} (tol {FARMER_ATOL}), wall {wall:.3f} s, launches {_counts()}")
    if not err <= FARMER_ATOL:
        raise AssertionError(f"farmer: acreage {acre.tolist()}")
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.farmer_family(num_scenarios=n_scenarios, device=device)
    )
    solver = ptt.SchurComplementSolver(block_size=64, explicit_inverse=True)
    _, c = _counted_solve(iface, solver, "farmer family", timed=1, ref=family_ref[0],
                          tol=ptt.IPOptions().tol, repeat=True)
    if abs(c["iterations"] - family_ref[1]) > 1:
        raise AssertionError(f"farmer family: {c['iterations']} iterations, JAX {family_ref[1]}")
    return c


def _single_nlp(device, linear_solver=None):
    """``examples/interior_point.main`` through ``ip_solve``: (x, iterations,
    objective, wall)."""
    from parapint_tpu_torch.examples import interior_point
    from parapint_tpu_torch.utils.timer import HierarchicalTimer

    timer = HierarchicalTimer()
    t0 = time.perf_counter()
    x = interior_point.main(linear_solver, device=device, timer=timer).get_primals().cpu().numpy()
    wall = time.perf_counter() - t0
    n_iter = timer._root.children["IP solve"].children["convergence check"].count
    return x, n_iter, float(x[0] ** 2 + x[1] ** 2), wall


def phase_single(device="cuda"):
    """The single-NLP examples through ``ip_solve``; returns the
    interior_point example's (iterations, objective)."""
    from parapint_tpu_torch.examples import dynamics

    x, n_iter, obj, wall = _single_nlp(device)
    err = float(np.abs(x - np.array([0.0, 1.0])).max())
    say(f"interior_point example: x {x.tolist()}, max|d| to (0, 1) {err:.3e} (tol 1e-7), "
        f"iterations {n_iter}, objective {obj!r}, wall {wall:.3f} s")
    if not err <= 1e-7:
        raise AssertionError(f"interior_point example: x {x.tolist()}")
    t0 = time.perf_counter()
    _, _, p = dynamics.main(device=device)
    wall = time.perf_counter() - t0
    err = float(np.abs(p[: len(DYNAMICS_GOLDEN_P)] - np.asarray(DYNAMICS_GOLDEN_P)).max())
    say(f"dynamics example: p(t)[:9] max|d| to the golden values {err:.3e} (tol 1e-6), "
        f"wall {wall:.3f} s")
    if not err <= 1e-6:
        raise AssertionError(f"dynamics example: p(t) {p.tolist()}")
    return n_iter, obj


def phase_heterogeneous():
    """The dense flagship as two kinds (``burgers_two_kinds``) through
    ``make_fused_ip_solve`` with the dense flagship's solver: optimal at
    the JAX objective, iterations within 1 of the JAX two-kinds count and
    in its ensemble's set, K1 == 14 x numerics, K6 == 2 x back solves, and
    a second solve from the same state repeats the first bit for bit."""
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    iface = burgers_two_kinds(burgers.build_spec(**FLAGSHIP), kkt_dtype=torch.float32)
    print(f"heterogeneous interface {FLAGSHIP}, two kinds (eq rows {iface.eq_mask[0].sum().item()} "
          f"and {iface.eq_mask[1].sum().item()} of {iface.me}): nk {iface.nk} ncv {iface.ncv} "
          f"setup {time.perf_counter() - t0:.2f} s")
    result, c = _counted_solve(iface, _dense_solver("cr"), "heterogeneous flagship", timed=1,
                               repeat=True)
    print(f"heterogeneous flagship: iterations {c['iterations']} (JAX two kinds "
          f"{TWO_KINDS_JAX_ITERATIONS}); K1 {c['K1']} for {c['numerics']} numerics, K6 {c['K6']} for "
          f"{c['solves']} back solves [{SMI}]")
    _hold_count("heterogeneous flagship", c["iterations"], TWO_KINDS_JAX_ITERATIONS, "burgers_two_kinds")
    if not (c["K1"] > 0 and c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"heterogeneous: K1 {c['K1']} launches for {c['numerics']} numerics")
    if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"]):
        raise AssertionError(f"heterogeneous: K6 {c['K6']} launches for {c['solves']} back solves")
    return c


def _pcg_solver(**kw):
    import parapint_tpu_torch as ptt

    return ptt.PCGSchurComplementSolver(block_size=128, factor_dtype=torch.float32, **kw)


def _pcg_kernels_ok(c, label):
    """K1 on the block panels only (no cyclic reduction), K6 twice per back
    solve plus once per CG iteration."""
    print(f"{label}: K1 {c['K1']} for {c['numerics']} numerics, K6 {c['K6']} for {c['solves']} "
          f"back solves and {sum(c['cg'])} CG iterations (per back solve {c['cg']}) [{SMI}]")
    if not (c["K1"] > 0 and c["K1"] == PCG_K1_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"{label}: K1 {c['K1']} launches for {c['numerics']} numerics")
    if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"] + sum(c["cg"])):
        raise AssertionError(f"{label}: K6 {c['K6']} launches for {c['solves']} back solves")


def phase_pcg():
    """bench_all's ``burgers_pcg_coupling_8blocks`` through both drivers."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**PCG_SHAPE), kkt_dtype=torch.float32
    )
    print(f"PCG interface {PCG_SHAPE}: nk {iface.nk} ns {iface.ns} ncv {iface.ncv} "
          f"setup {time.perf_counter() - t0:.2f} s")
    _, c = _counted_solve(iface, _pcg_solver(), "PCG 8 blocks fused", timed=1, ref=PCG_JAX_OBJECTIVE)
    _hold_count("PCG fused", c["iterations"], PCG_JAX_ITERATIONS, "burgers_pcg_coupling_8blocks")
    _pcg_kernels_ok(c, "PCG 8 blocks fused")
    c_ip = _counted_ip_solve(iface, _pcg_solver(), "PCG 8 blocks ip_solve", PCG_JAX_IP_OBJECTIVE,
                             PCG_JAX_IP_ITERATIONS)
    _pcg_kernels_ok(c_ip, "PCG 8 blocks ip_solve")
    return c, c_ip


def _pcg_against_sc(iface, label, **pcg_kw):
    """The first KKT of ``iface`` through PCG (``_pcg_solver(**pcg_kw)``)
    and through the W-form ``SchurComplementSolver`` with cyclic reduction
    (adaptive refinement), both with float32 factors: block inertia equal,
    the explicit solve successful; returns (PCG status, CG iterations,
    max|dx|, max|x|, the PCG solver's ``cg_maxiter``)."""
    import parapint_tpu_torch as ptt

    kkt, rhs = _first_kkt(iface)
    pcg = _pcg_solver(**pcg_kw)
    _reset_counts()
    t0 = time.perf_counter()
    fact = pcg.numeric(kkt)
    x, status = pcg.solve_with_status(fact, rhs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    sc = ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
        schur_complement_solver=ptt.BlockTridiagSolver(),
    )
    sfact = sc.numeric(kkt)
    sx, sstatus = sc.solve_with_status(sfact, rhs)
    nc = kkt.q.shape[0]
    as_t = lambda v: tuple(int(a) for a in v)
    pcg_blk = as_t(fact.inertia.cpu() - torch.tensor([nc, 0, 0], dtype=torch.int32))
    sc_part = as_t(sc.sc_solver.inertia(sfact.sc_fact))
    sc_blk = tuple(a - b for a, b in zip(as_t(sfact.inertia.cpu()), sc_part))
    flat = lambda b: torch.cat([b.blocks.reshape(-1), b.coupling])
    dx = (flat(x) - flat(sx)).abs().max().item()
    scale = flat(sx).abs().max().item()
    say(f"{label} (ncv {nc}): status PCG {int(status)} explicit {int(sstatus)}, block inertia PCG "
        f"{pcg_blk} explicit {sc_blk} (its SC {sc_part}), CG iterations {pcg.cg_iterations}, "
        f"max|dx| {dx:.3e} (max|x| {scale:.3e}, tol {PCG_SOLUTION_RTOL} x max|x|), PCG numeric + "
        f"solve {wall:.4f} s, launches {c}")
    if pcg_blk != sc_blk or int(sstatus) != 0:
        raise AssertionError(f"{label}: block inertia or the explicit solve's status differs")
    return int(status), pcg.cg_iterations[0], dx, scale, pcg.cg_maxiter


def phase_pcg_first_kkt(flagship_iface):
    """PCG on the first KKT of the dense flagship's per-block shape, cut to
    32 blocks (converged, the solutions within PCG_SOLUTION_RTOL x max|x|),
    and of the dense flagship itself, where the reference's CG budget runs
    out: its CG iterations grow with the block count (PCG_DEPTH_JAX_CG, the
    same in both packages), so it must either converge as at 32 blocks or
    stop with status error after exactly the solver's ``cg_maxiter``
    iterations (200 by default; phase 23 gives it a budget that suffices)."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    n = PCG_DEPTH_BLOCKS
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(nfe_x=50, nfe_t=4 * n, num_time_blocks=n), kkt_dtype=torch.float32
    )
    label = f"PCG first KKT, {n} blocks"
    status, cg, dx, scale, _ = _pcg_against_sc(iface, label)
    print(f"{label}: CG iterations {cg} (JAX {PCG_DEPTH_JAX_CG[n]} on the CPU) [{SMI}]")
    if status != 0 or not dx <= PCG_SOLUTION_RTOL * scale:
        raise AssertionError(f"{label}: status {status}, solutions differ by {dx}")
    label = "PCG first KKT, dense flagship"
    status, cg, dx, scale, cg_maxiter = _pcg_against_sc(flagship_iface, label)
    converged = status == 0 and dx <= PCG_SOLUTION_RTOL * scale
    budget = status == int(ptt.LinearSolverStatus.error) and cg == cg_maxiter
    print(f"{label}: {'converged' if converged else f'CG budget of {cg_maxiter} spent'} [{SMI}]")
    if not (converged or budget):
        raise AssertionError(f"{label}: status {status} after {cg} CG iterations, max|dx| {dx}")


def _args_case(iface, solver, key, label, per_numeric):
    """One counted fused solve of a phase 23 case: optimal at the JAX
    objective of ``ARGS_JAX[key]``, within 1 of its iterations, K1 launched
    ``per_numeric`` times per numeric; its counts."""
    iters, obj = ARGS_JAX[key]
    _, c = _counted_solve(iface, solver, label, ref=obj)
    _hold_count(label, c["iterations"], iters, key)
    say(f"{label}: iterations {c['iterations']} (JAX {iters} at the same arguments), wall "
        f"{c['counted_wall_s']:.3f} s, K1 {c['K1']} for {c['numerics']} numerics "
        f"({c['K1'] / max(1, c['numerics']):g} per numeric), K6 {c['K6']}")
    if not (c["K1"] > 0 and c["K1"] == per_numeric * c["numerics"]):
        raise AssertionError(f"{label}: K1 {c['K1']} launches for {c['numerics']} numerics, "
                             f"expected {per_numeric} per numeric")
    return c


def phase_arguments(banded_iface=None, dense_iface=None):
    """Phase 23: the restored solver arguments at user values on the card
    (module docstring); the interfaces of the banded and the dense flagship
    are built here unless given.  Returns each case's counts."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv, random_panels
    from parapint_tpu_torch.tools.bench import build_problem

    t_phase = time.perf_counter()
    out = {}
    if banded_iface is None:
        banded_iface = build_problem(FLAGSHIP["nfe_x"], FLAGSHIP["nfe_t"],
                                     FLAGSHIP["num_time_blocks"], block_form="banded")
    cr = lambda: ptt.BlockTridiagSolver(ns=banded_iface.ns)

    # (a) one K1 launch per Thomas tile
    solver = ptt.BandedSchurComplementSolver(tile_size=TILE_SIZE, tile_block_size=128,
                                             schur_complement_solver=cr())
    out["tile_block_size"] = c = _args_case(
        banded_iface, solver, "tile_block_size", "args (a) banded flagship, tile_block_size=128",
        ARGS_TILE_K1_PER_NUMERIC)
    tiles = -(-banded_iface.nk // TILE_SIZE)
    A128 = torch.as_tensor(random_panels(64, 128, seed=23), device="cuda")
    A64 = torch.as_tensor(random_panels(64, 64, seed=23), device="cuda")
    ms128 = timed_loop(lambda: ldl_panels_slab_winv(A128), 20)
    ms64 = timed_loop(lambda: ldl_panels_slab_winv(A64), 20)
    c["K1_ms_128"], c["K1_ms_64"] = ms128, ms64
    say(f"args (a): {tiles} Thomas tiles per numeric, one K1 launch each (the default's two); "
        f"K1 at (64, 128, 128) {ms128:.4f} ms per launch against 2 x {ms64:.4f} = "
        f"{2 * ms64:.4f} ms for two launches at (64, 64, 64), so {tiles * ms128:.4f} against "
        f"{tiles * 2 * ms64:.4f} ms of Thomas-sweep K1 per numeric")

    # (b) the fixed-pass branch
    solver = ptt.BandedSchurComplementSolver(tile_size=TILE_SIZE, refine_steps=0,
                                             schur_complement_solver=cr())
    out["refine_steps"] = _args_case(banded_iface, solver, "refine_steps",
                                     "args (b) banded flagship, refine_steps=0",
                                     BANDED_PANELS_PER_NUMERIC)
    del banded_iface
    torch.cuda.empty_cache()

    # (c) bench_all's row 11 with 128-wide cyclic-reduction panels
    t0 = time.perf_counter()
    iface = build_problem(200, 256, 64, block_form="banded")
    print(f"args (c) interface nfe_x=200: nk {iface.nk} ns {iface.ns} p {iface.banded_plan.p} "
          f"setup {time.perf_counter() - t0:.2f} s")
    solver = ptt.BandedSchurComplementSolver(
        factor_dtype=torch.float32,
        schur_complement_solver=ptt.BlockTridiagSolver(ns=199, block_size=128))
    out["row11_cr128"] = _args_case(iface, solver, "row11_cr128",
                                    "args (c) row 11, BlockTridiagSolver(ns=199, block_size=128)",
                                    ARGS_ROW11_K1_PER_NUMERIC)
    del iface
    torch.cuda.empty_cache()

    # (d) PCG with a CG budget over twice the JAX package's largest count
    if dense_iface is None:
        dense_iface = _dense_iface()
    M = ARGS_PCG_CG_MAXITER
    label = f"args (d) PCG first KKT, dense flagship, cg_maxiter={M}"
    status, cg, dx, scale, cg_maxiter = _pcg_against_sc(dense_iface, label, cg_maxiter=M)
    say(f"{label}: converged in {cg} CG iterations (JAX {ARGS_PCG_JAX_CG[0]}), budget "
        f"{cg_maxiter}; gap to the explicit solver {dx / scale:.3e} x max|x| (the JAX package's "
        f"own on this KKT {ARGS_PCG_JAX_FIRST_GAP:.3e}; PCG_SOLUTION_RTOL {PCG_SOLUTION_RTOL:g} "
        f"is phase 15's 32-block bar, which both miss here)")
    if cg_maxiter != M or status != 0 or abs(cg - ARGS_PCG_JAX_CG[0]) > 1:
        raise AssertionError(f"{label}: status {status} after {cg} CG iterations, max|dx| {dx}")
    out["pcg_first_kkt"] = dict(cg=cg, max_dx=dx, max_x=scale, jax_gap=ARGS_PCG_JAX_FIRST_GAP)
    solver = _pcg_solver(cg_maxiter=M)
    out["pcg_cg_maxiter"] = c = _args_case(
        dense_iface, solver, "pcg_cg_maxiter", f"args (d) dense flagship, PCG cg_maxiter={M}",
        PCG_K1_PER_NUMERIC)
    if not c["K6"] == 2 * c["solves"] + sum(c["cg"]):
        raise AssertionError(f"args (d): K6 {c['K6']} launches for {c['solves']} back solves")
    say(f"args (d): CG iterations per back solve {c['cg']} (largest {max(c['cg'])} of {M}; "
        f"the JAX ip_solve's {list(ARGS_PCG_JAX_CG)})")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 23 (arguments): every case held in {out['seconds']:.1f} s")
    return out


def _launches(fn):
    """(result, kernel launches, summed kernel device ms) of one call under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = sum(e.self_device_time_total for e in ka
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, sum(e.count for e in ka if e.key in LAUNCH_CALLS), dev


def phase_condensed(device="cuda"):
    """The harness's csc at the reference's default scale (warm numeric and
    back solve), its launches per numeric, then fs, ssc and csc at the
    small size of the CPU tests."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples.performance import schur_complement as perf

    t0 = time.perf_counter()
    r = perf.run(method="csc", **CSC_REF, warm=True, device=device)
    wall = time.perf_counter() - t0
    theta_err = float(np.abs(r.theta - np.asarray(CSC_JAX_THETA)).max() / np.abs(CSC_JAX_THETA).max())
    say(f"csc {CSC_REF}: status {r.status}, max_err {r.max_err!r} (JAX {CSC_JAX_MAX_ERR!r}; < 1.0), "
        f"theta rel err to JAX {theta_err:.3e} (tol {CSC_THETA_RTOL}), warm numeric "
        f"{r.numeric_time:.4f} s, warm back solve {r.back_solve_time:.4f} s, symbolic "
        f"{r.symbolic_time:.4f} s, run wall {wall:.2f} s")
    max_err_rel = abs(r.max_err - CSC_JAX_MAX_ERR) / CSC_JAX_MAX_ERR
    if (r.status != 0 or not r.max_err < 1.0 or not theta_err <= CSC_THETA_RTOL
            or not max_err_rel <= CSC_MAX_ERR_RTOL):
        raise AssertionError(f"csc: status {r.status}, max_err {r.max_err} (rel err {max_err_rel}), "
                             f"theta error {theta_err}")

    m = perf.SyntheticModel(n_blocks=CSC_REF["n_blocks"], n_q_per_block=CSC_REF["n_q_per_block"],
                            n_y_multiplier=CSC_REF["n_y_multiplier"])
    kkt = ptt.CondensedLSQKKT(
        A_bands=torch.as_tensor(m.A_bands, device=device),
        q_c=torch.zeros((m.n_theta, m.n_theta), dtype=torch.float64, device=device),
        n_t=m.n_theta, n_blocks=m.n_blocks,
    )
    solver = ptt.CondensedLSQSolver(tile_size=128)
    rhs = m.build_rhs(device)
    _reset_counts()
    fact, n_num, dev_num = _launches(lambda: solver.numeric(kkt))
    _, n_sol, dev_sol = _launches(lambda: solver.solve(fact, rhs, kkt=kkt))
    c = _counts()
    say(f"csc launches: numeric {n_num} (kernel device time {dev_num:.2f} ms), back solve {n_sol} "
        f"({dev_sol:.2f} ms); nk {m.nk}, G tiles {fact.g_fact.m}, CR levels {len(fact.g_fact.tinv)}, "
        f"panel-kernel counts {c}")

    small = {}
    for method in ("fs", "ssc", "csc"):
        small[method] = perf.run(method=method, **CSC_SMALL, verbose=False, device=device)
    errs = {k: v.max_err for k, v in small.items()}
    say(f"harness at {CSC_SMALL}: max_err {errs}, status {[v.status for v in small.values()]}")
    for k, v in small.items():
        if v.status != 0 or not np.isclose(v.max_err, errs["fs"], rtol=1e-6):
            raise AssertionError(f"harness {k}: status {v.status}, max_err {v.max_err} vs fs {errs['fs']}")
    return dict(numeric_launches=n_num, solve_launches=n_sol)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _AllReduceClock:
    """Counts and times every ``torch.distributed.all_reduce`` while active:
    the card is synchronised before and after each call, so the time is the
    collective's own (for gloo: the copies to and from host memory and the
    exchange)."""

    def __init__(self):
        self.calls, self.seconds, self.bytes = 0, 0.0, 0

    @contextlib.contextmanager
    def active(self):
        import torch.distributed as dist

        orig = dist.all_reduce

        def timed(t, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(t, *args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
            return out

        dist.all_reduce = timed
        try:
            yield self
        finally:
            dist.all_reduce = orig


@contextlib.contextmanager
def _ad_clock(iface, seconds):
    """Times the interface's ``eval_ad`` and ``kkt_from_ad`` while active,
    each call between two synchronisations: ``seconds[name]`` collects
    [calls, seconds]."""
    for name in ("eval_ad", "kkt_from_ad"):
        fn = getattr(iface, name)
        seconds[name] = [0, 0.0]

        def timed(*args, _fn=fn, _acc=seconds[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()
            _acc[0] += 1
            _acc[1] += time.perf_counter() - t0
            return out

        setattr(iface, name, timed)
    try:
        yield seconds
    finally:
        for name in ("eval_ad", "kkt_from_ad"):
            delattr(iface, name)


def _sharded_solve(iface, solver, label, ref, ref_iters, timed=1, tol=TOL):
    """One counted solve (``_counted_solve``: counts zeroed before, read
    after), ``timed`` timed ones, then one more under the all-reduce clock
    and the AD clock.  Returns (final primals on the CPU, counts with the
    walls, the all-reduce time and the ``eval_ad`` / ``kkt_from_ad`` time
    and the blocks the rank evaluates)."""
    import parapint_tpu_torch as ptt

    result, c = _counted_solve(iface, solver, label, timed=timed, ref=ref, tol=tol)
    if abs(c["iterations"] - ref_iters) > 1:
        raise AssertionError(f"{label}: {c['iterations']} iterations, JAX {ref_iters}")
    opts = ptt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    clock = _AllReduceClock()
    with clock.active(), _ad_clock(iface, {}) as ad:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ptt.make_fused_ip_solve(iface, opts)(iface.init_state())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lo, hi = iface.block_range
    c.update(clocked_wall_s=wall, all_reduces=clock.calls, all_reduce_s=clock.seconds,
             all_reduce_bytes=clock.bytes, local_blocks=hi - lo, ncv=iface.ncv,
             **{f"{k}_calls": v[0] for k, v in ad.items()},
             **{f"{k}_ms": v[1] * 1e3 for k, v in ad.items()})
    say(f"{label}: blocks {lo}..{hi - 1} of {iface.N} evaluated here; solve with every "
        f"all-reduce and AD call synchronised and timed {wall:.4f} s, of it {clock.calls} "
        f"all-reduces {clock.seconds:.4f} s ({clock.bytes} bytes), eval_ad "
        f"{c['eval_ad_ms']:.2f} ms ({c['eval_ad_calls']} calls), kkt_from_ad "
        f"{c['kkt_from_ad_ms']:.2f} ms ({c['kkt_from_ad_calls']} calls)")
    state = result.state.primals
    return {k: v.cpu() for k, v in state.items()}, c


def _sharded_dense_solver(mesh, coupling="cr"):
    import parapint_tpu_torch as ptt

    return ptt.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
        schur_complement_solver=ptt.BlockTridiagSolver() if coupling == "cr" else None,
    )


def _check(label, ok, c):
    if not ok:
        raise AssertionError(f"{label}: launches {c}")


def _sharded_ld(mesh, iface):
    """The first KKT through the sharded LD mode (numeric and solve only):
    (solution on the CPU, counts)."""
    import parapint_tpu_torch as ptt

    kkt, rhs = _first_kkt(iface)
    solver = ptt.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=128, explicit_inverse=False, factor_dtype=torch.float32
    )
    _reset_counts()
    fact = solver.numeric(kkt)
    x, status = solver.solve_with_status(fact, rhs)
    torch.cuda.synchronize()
    c = _counts()
    if int(status) != 0:
        raise AssertionError(f"sharded LD mode: status {int(status)}")
    return {"blocks": x.blocks.cpu(), "coupling": x.coupling.cpu()}, c


def _dense_iface_on(mesh):
    """The dense flagship's interface, with ``mesh=`` when one is given."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    return ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**FLAGSHIP), mesh=mesh, kkt_dtype=torch.float32)


def _serial_on_mesh(iface, cold, cold_x, label, timed=0):
    """ROADMAP C11: the ``mesh=`` dense flagship ``iface`` through phase
    4's serial solver, which gathers the rank-local KKT whole on every rank
    and factors all 64 blocks: optimal at the JAX objective, iterations,
    objective and K1 launches (per rank) equal to phase 4's, K6 == 2 x back
    solves.
    Returns (final primals on the CPU, counts with the largest difference
    to phase 4's final primals and whether they are bitwise equal)."""
    x, c = _sharded_solve(iface, _dense_solver("cr"), label, JAX_OBJECTIVE, JAX_DENSE_ITERATIONS,
                          timed=timed)
    c["max_dx_to_serial"] = max((x[k] - cold_x[k]).abs().max().item() for k in x)
    c["bitwise_serial"] = all(torch.equal(x[k], cold_x[k]) for k in x)
    say(f"{label}: iterations {c['iterations']} (replicated serial run {cold['iterations']}), "
        f"objective {c['objective']!r} ({cold['objective']!r}), K1 {c['K1']} ({cold['K1']}), "
        f"max |x - x_serial| {c['max_dx_to_serial']:.3e}, bitwise {c['bitwise_serial']}, "
        f"counted solve {c['counted_wall_s']:.3f} s")
    _check(label, c["iterations"] == cold["iterations"] and c["objective"] == cold["objective"]
           and c["K1"] == cold["K1"] and c["K6"] == 2 * c["solves"] > 0, c)
    return x, c


def phase_sharded_one_rank(outdir, cold, cold_x):
    """Phase 16: one NCCL rank in this process, the dense flagship through
    the sharded solver with the interface replicated and then with
    ``mesh=`` on it (at one rank its range is every block, so the iterates
    must be equal), then the ``mesh=`` interface through phase 4's serial
    solver (C11; at one rank bitwise equal to phase 4's run).  Writes the
    LD-mode solution for the 2-rank phase to ``outdir``; returns the
    cases' counts."""
    from parapint_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = distributed.global_mesh("blocks")
        iface = _dense_iface()
        x, c = _sharded_solve(iface, _sharded_dense_solver(mesh), "sharded dense flagship, 1 NCCL rank",
                              JAX_OBJECTIVE, SHARDED_DENSE_JAX_ITERATIONS)
        _check("sharded dense, 1 rank", c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"] > 0
               and c["K6"] == 2 * c["solves"] > 0, c)
        x_ld, c_ld = _sharded_ld(mesh, iface)
        say(f"sharded LD mode first KKT, 1 NCCL rank: launches {c_ld}")
        _check("sharded LD mode, 1 rank", c_ld["K2"] == LD_K2_PER_NUMERIC
               and c_ld["K5"] == SC_PANELS_PER_NUMERIC, c_ld)
        torch.save(x_ld, os.path.join(outdir, "ld_one_rank.pt"))
        del iface
        iface = _dense_iface_on(mesh)
        x_m, c_m = _sharded_solve(iface, _sharded_dense_solver(mesh),
                                  "sharded dense flagship, mesh= interface, 1 NCCL rank",
                                  JAX_OBJECTIVE, SHARDED_DENSE_JAX_ITERATIONS)
        same = all(torch.equal(x_m[k], x[k]) for k in x)
        say(f"sharded dense flagship, 1 NCCL rank: mesh= iterates equal to the replicated run's: {same}")
        _check("sharded dense, mesh=, 1 rank", same and c_m["iterations"] == c["iterations"]
               and c_m["K1"] == DENSE_K1_PER_NUMERIC * c_m["numerics"] > 0
               and c_m["K6"] == 2 * c_m["solves"] > 0, c_m)
        _, c_s = _serial_on_mesh(iface, cold, cold_x,
                                 "serial solver, mesh= dense flagship, 1 NCCL rank")
        _check("serial solver, mesh=, 1 rank", c_s["bitwise_serial"], c_s)
    finally:
        distributed.shutdown()
    return {"dense": c, "dense_mesh": c_m, "serial_mesh": c_s}


def _replicated_and_mesh(mesh, label, build, make_solver, ref, ref_iters, ok, timed=1,
                         after=None):
    """A case of phase 17 twice: with the interface replicated (every rank
    evaluates every block; the sharded solver takes its blocks) and with
    ``mesh=`` on it (each rank evaluates and assembles its own), the peak of
    ``torch.cuda.max_memory_allocated`` reset before each.  Both meet the
    JAX reference and ``ok(counts)``; ``after(iface, counts)`` runs on each
    interface after its solves (outside the peak).  Returns {mode:
    (primals, counts)}."""
    out = {}
    for mode, m in (("replicated", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        iface = build(m)
        x, c = _sharded_solve(iface, make_solver(iface), f"{label}, {mode}", ref, ref_iters,
                              timed=timed)
        c["peak_bytes"] = torch.cuda.max_memory_allocated()
        _check(f"{label}, {mode}", ok(c), c)
        if after is not None:
            after(iface, x, c)
        out[mode] = (x, c)
        del iface
    rep, msh = out["replicated"][1], out["mesh"][1]
    say(f"{label}: local blocks {msh['local_blocks']} (replicated {rep['local_blocks']}); peak memory "
        f"replicated {rep['peak_bytes'] / 2**20:.1f} MiB, mesh= {msh['peak_bytes'] / 2**20:.1f} MiB; "
        f"eval_ad {rep['eval_ad_ms']:.2f} -> {msh['eval_ad_ms']:.2f} ms, kkt_from_ad "
        f"{rep['kkt_from_ad_ms']:.2f} -> {msh['kkt_from_ad_ms']:.2f} ms per solve")
    return out


def _sharded_rank(rank, world, port, smi, outdir):
    """Phase 17, one rank: every case in turn, its results saved to
    ``outdir/rank{rank}.pt`` (phase 4's counts and final primals read
    from ``outdir/serial.pt``)."""
    global SMI
    SMI = f"rank {rank}/{world}, {smi}"
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers, stochastic
    from parapint_tpu_torch.examples.performance import schur_complement as perf
    from parapint_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = distributed.global_mesh("blocks")
    iterates, counts = {}, {}

    def keep(key, runs):
        for mode, (x, c) in runs.items():
            k = key if mode == "replicated" else f"{key}/mesh"
            iterates[k], counts[k] = x, c

    ld_ref = torch.load(os.path.join(outdir, "ld_one_rank.pt"))
    cold, cold_x = torch.load(os.path.join(outdir, "serial.pt"))

    def ld_mode(iface, _, c_solve):
        x, c = _sharded_ld(mesh, iface)
        dx = max((x[k] - ld_ref[k]).abs().max().item() for k in x)
        scale = max(ld_ref[k].abs().max().item() for k in ld_ref)
        c.update(max_dx_to_one_rank=dx, max_x=scale)
        key = "ld" if iface.mesh is None else "ld/mesh"
        iterates[key], counts[key] = x, c
        say(f"sharded LD mode first KKT ({key}): max|dx| to the 1-rank run {dx:.3e} (max|x| "
            f"{scale:.3e}, tol {LD_SOLUTION_RTOL} x max|x|), launches {c}")
        _check("sharded LD mode", c["K2"] == LD_K2_PER_NUMERIC and c["K5"] == SC_PANELS_PER_NUMERIC
               and dx <= LD_SOLUTION_RTOL * scale, c)

    dense_ok = lambda c: (c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"] > 0
                          and c["K6"] == 2 * c["solves"] > 0)
    runs = _replicated_and_mesh(
        mesh, "sharded dense flagship", _dense_iface_on, lambda _: _sharded_dense_solver(mesh),
        JAX_OBJECTIVE, SHARDED_DENSE_JAX_ITERATIONS, dense_ok, after=ld_mode)
    keep("dense", runs)
    if not runs["mesh"][1]["peak_bytes"] < runs["replicated"][1]["peak_bytes"]:
        raise AssertionError("dense flagship: the mesh= peak memory is not below the replicated one's")
    torch.cuda.empty_cache()

    keep("banded", _replicated_and_mesh(
        mesh, "sharded banded flagship",
        lambda m: ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**FLAGSHIP), mesh=m, kkt_dtype=torch.float32, block_form="banded"),
        lambda iface: ptt.ShardedBandedSchurComplementSolver(
            mesh, tile_size=TILE_SIZE, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)),
        JAX_OBJECTIVE, SHARDED_BANDED_JAX_ITERATIONS,
        lambda c: c["K1"] == BANDED_PANELS_PER_NUMERIC * c["numerics"] > 0))
    torch.cuda.empty_cache()

    keep("odd", _replicated_and_mesh(
        mesh, f"sharded dense {ODD['num_time_blocks']} blocks (padded)",
        lambda m: ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**ODD), mesh=m, kkt_dtype=torch.float32),
        lambda _: _sharded_dense_solver(mesh, "dense"), ODD_JAX_OBJECTIVE, ODD_JAX_ITERATIONS,
        lambda c: (c["K1"] == BLOCK_PANELS_PER_NUMERIC * c["numerics"] > 0
                   and c["K5"] == -(-c["ncv"] // 128) * c["numerics"]
                   and c["K6"] == 2 * c["solves"]),
        timed=0))
    torch.cuda.empty_cache()

    # the QP: replicated in the original order, with mesh= each rank owning
    # the odd or the even scenarios (ownership_map)
    own = [i % world for i in range(QP["n_scenarios"])]
    qp_runs = _replicated_and_mesh(
        mesh, "sharded stochastic QP",
        lambda m: ptt.StochasticSchurComplementInteriorPointInterface(
            stochastic.qp_spec(**QP), mesh=m, kkt_dtype=torch.float32,
            ownership_map=None if m is None else own),
        lambda _: ptt.ShardedSchurComplementSolver(
            mesh, "blocks", block_size=128, explicit_inverse=True, factor_dtype=torch.float64,
            apply_dtype=torch.float32),
        QP_OWN_JAX_OBJECTIVE, QP_OWN_JAX_ITERATIONS,
        lambda c: (c["K6"] == 2 * c["solves"] > 0 and c["K5"] == c["numerics"] > 0
                   and not any(c[k] for k in ("K1", "K2", "K3", "K4"))),
        timed=0,
        after=lambda iface, x, c: x.update(blocks_original_order=iface.get_primals()["blocks"].cpu()))
    keep("qp", qp_runs)
    torch.cuda.empty_cache()

    keep("heterogeneous", _replicated_and_mesh(
        mesh, "sharded heterogeneous flagship (two kinds)",
        lambda m: burgers_two_kinds(burgers.build_spec(**FLAGSHIP), kkt_dtype=torch.float32, mesh=m),
        lambda _: _sharded_dense_solver(mesh), JAX_OBJECTIVE, TWO_KINDS_JAX_ITERATIONS, dense_ok))
    torch.cuda.empty_cache()

    def pcg_ok(c):
        _pcg_kernels_ok(c, "PCG with a mesh, 8 blocks")
        return True

    # C11: the mesh= dense flagship through the serial solver
    iface = _dense_iface_on(mesh)
    iterates["serial/mesh"], counts["serial/mesh"] = _serial_on_mesh(
        iface, cold, cold_x, "serial solver, mesh= dense flagship")
    del iface
    torch.cuda.empty_cache()

    keep("pcg", _replicated_and_mesh(
        mesh, "PCG with a mesh, 8 blocks",
        lambda m: ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**PCG_SHAPE), mesh=m, kkt_dtype=torch.float32),
        lambda _: ptt.PCGSchurComplementSolver(mesh, "blocks", block_size=128,
                                               factor_dtype=torch.float32),
        PCG_MESH_JAX_OBJECTIVE, PCG_MESH_JAX_ITERATIONS, pcg_ok))

    psc = perf.run(method="psc", **CSC_SMALL, verbose=False)
    ssc = perf.run(method="ssc", **CSC_SMALL, verbose=False)
    say(f"harness psc at {CSC_SMALL} on {world} ranks: status {psc.status}, max_err {psc.max_err!r} "
        f"(ssc {ssc.max_err!r})")
    if psc.status != 0 or not np.isclose(psc.max_err, ssc.max_err, rtol=1e-6):
        raise AssertionError(f"psc: status {psc.status}, max_err {psc.max_err} vs ssc {ssc.max_err}")
    iterates["psc"] = {"theta": torch.as_tensor(psc.theta)}

    torch.save({"iterates": iterates, "counts": counts}, os.path.join(outdir, f"rank{rank}.pt"))
    distributed.shutdown()


def phase_host_bk(single):
    """Phase 18: ``HostBKSolver`` (the g++ build of ``csrc/bk_ldl.cpp``)
    through ``ip_solve`` on the single-NLP example, its model on the card:
    optimal at phase 11's iterations and objective.  Then one batched host
    factor of the first-KKT blocks of bench_all's 8-block PCG row, whose
    summed inertia must equal the card's block factorization's (K1)."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers
    from parapint_tpu_torch.linalg.schur import _factor_blocks_winv

    x, n_iter, obj, wall = _single_nlp("cuda", ptt.HostBKSolver())
    say(f"HostBKSolver ip_solve, single NLP on the card: x {x.tolist()}, iterations {n_iter} "
        f"(DenseLDLSolver {single[0]}), objective {obj!r} (DenseLDLSolver {single[1]!r}), "
        f"wall {wall:.3f} s")
    if n_iter != single[0] or abs(obj - single[1]) > OBJ_REL_GAP * max(1.0, abs(single[1])):
        raise AssertionError(f"HostBKSolver ip_solve: {n_iter} iterations, objective {obj}")
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**PCG_SHAPE), kkt_dtype=torch.float32)
    kkt, _ = _first_kkt(iface)
    solver = ptt.HostBKSolver()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = solver.numeric(kkt.diag)
    host_s = time.perf_counter() - t0
    host = tuple(int(v) for v in solver.inertia(fact))
    *_, inertia, status = _factor_blocks_winv(kkt.diag, kkt.mask, 128, 0.0, torch.float32)
    card = tuple(int(v) for v in inertia.cpu())
    say(f"HostBKSolver batched factor of {tuple(kkt.diag.shape)} first-KKT blocks ({kkt.diag.dtype} "
        f"read as float64): {host_s:.3f} s on the host (OpenMP, {os.cpu_count()} cores), status "
        f"{int(solver.status(fact))}, summed inertia {host} (card W-form blocks {card}, status "
        f"{int(status)})")
    if host != card or int(solver.status(fact)) != 0:
        raise AssertionError(f"HostBKSolver: inertia {host} vs the card's {card}")
    return dict(iterations=n_iter, objective=obj, factor_s=host_s, inertia=host)


def phase_compat():
    """Phase 19: the reference-style call site through
    ``parapint_tpu_torch.compat`` on the card (``tests/test_compat.py``):
    optimal at the JAX ``compat`` run's objective."""
    import parapint_tpu_torch as ptt
    import parapint_tpu_torch.compat as parapint

    model = ptt.NLPModel(
        objective=lambda v: v[0] ** 2 + v[1] ** 2,
        eq_constraints=lambda v: torch.stack([v[1] - torch.exp(v[0])]),
        x0=[0.5, 0.5],
    )
    interface = parapint.interfaces.InteriorPointInterface(model)
    options = parapint.algorithms.IPOptions()
    options.linalg.solver = parapint.linalg.ScipyInterface(compute_inertia=True)
    status = parapint.algorithms.ip_solve(interface=interface, options=options)
    x = interface.get_primals().cpu().numpy()
    obj = float(x[0] ** 2 + x[1] ** 2)
    gap = abs(obj - COMPAT_JAX_OBJECTIVE) / max(1.0, abs(COMPAT_JAX_OBJECTIVE))
    say(f"compat call site on the card: {status.name}, objective {obj!r} (JAX compat "
        f"{COMPAT_JAX_OBJECTIVE!r}, rel gap {gap:.3e})")
    if status != parapint.algorithms.InteriorPointStatus.optimal or gap > OBJ_REL_GAP:
        raise AssertionError(f"compat: {status.name}, objective {obj}")


def phase_sharded_two_ranks(outdir, cold, cold_x):
    """Phase 17: spawn the ranks (the kernels are built already, so they
    only load them), wait for both within SHARDED_TIMEOUT, and require their
    final iterates to be bitwise equal.  Returns each rank's counts."""
    import torch.multiprocessing as mp

    torch.save((cold, cold_x), os.path.join(outdir, "serial.pt"))
    t0 = time.perf_counter()
    ctx = mp.start_processes(_sharded_rank, args=(SHARDED_WORLD, _free_port(), SMI, outdir),
                             nprocs=SHARDED_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"sharded ranks still running after {SHARDED_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt")) for r in range(SHARDED_WORLD)]
    for case, state in ranks[0]["iterates"].items():
        for key, v in state.items():
            for r in range(1, SHARDED_WORLD):
                if not torch.equal(v, ranks[r]["iterates"][case][key]):
                    raise AssertionError(f"sharded {case}: rank {r}'s {key} differs from rank 0's")
    print(f"sharded, {SHARDED_WORLD} ranks: every case passed on every rank, final iterates bitwise "
          f"equal across the ranks; spawn to exit {wall:.1f} s [{SMI}]")
    return [r["counts"] for r in ranks]


def _run_tool(args, timeout):
    """``python -m <args>`` from the repository root in a new process group,
    killed with its children when it ends or runs out of time; returns
    (exit code, standard output lines, standard error)."""
    proc = subprocess.Popen([sys.executable, "-m", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    return proc.returncode, out.strip().splitlines(), err


def phase_bench():
    """``python -m parapint_tpu_torch.tools.bench`` as a child, BENCH_RUNS
    times: each run's flagship line at the JAX iterations, on the card, its
    baseline from a child that saw no card; then the median and spread of
    the value."""
    values, lines = [], []
    for run in range(BENCH_RUNS):
        t0 = time.perf_counter()
        rc, out, err = _run_tool(["parapint_tpu_torch.tools.bench"], BENCH_TIMEOUT)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"bench run {run}: exit {rc}\n{err[-3000:]}")
        line = json.loads(out[-1])
        d = line["detail"]
        print(f"bench run {run} ({wall:.1f} s): {out[-1]}")
        if abs(d["n_iter"] - JAX_ITERATIONS) > 1:
            raise AssertionError(f"bench: {d['n_iter']} iterations, JAX {JAX_ITERATIONS}")
        if not (line["value"] > 0 and line["vs_baseline"] > 0):
            raise AssertionError(f"bench: value {line['value']}, vs_baseline {line['vs_baseline']}")
        if d["backend"] != "cuda" or d["device"] != SMI or out[0] != SMI:
            raise AssertionError(f"bench: backend {d['backend']}, device {d['device']!r}")
        if d["baseline_saw_cuda"]:
            raise AssertionError("bench: the baseline child saw CUDA")
        values.append(line["value"])
        lines.append(line)
    med = float(np.median(values))
    spread = max(values) - min(values)
    say(f"bench value over {BENCH_RUNS} runs, iter/s: {values}; median {med}, spread (max-min) "
        f"{spread} ({spread / med * 100:.2f}% of the median)")
    return dict(values=values, median=med, spread=spread, first=lines[0])


def phase_bench_rows():
    """bench_all's six rows that no phase above runs, in this process
    through the tool's row factory (every count zeroed before the counted
    solve): optimal at the JAX objective and iterations, the launches per
    numeric and per back solve of BENCH_NEW_ROWS; then the tool on
    BENCH_CHILD_ROWS (each row in its own child) as one child: every row
    without an error and at its JAX iterations."""
    from parapint_tpu_torch.tools import bench_all

    rows = {}
    for name, (obj, iters, per_numeric, k6_per_solve) in BENCH_NEW_ROWS.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        iface, solver = bench_all.make_row(name)
        plan = getattr(iface, "banded_plan", None)
        print(f"{name}: nk {iface.nk} ns {iface.ns} ncv {iface.ncv}"
              f"{f' p {plan.p}' if plan is not None else ''} setup {time.perf_counter() - t0:.2f} s")
        _, c = _counted_solve(iface, solver, name, ref=obj)
        c["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        say(f"{name}: iterations {c['iterations']} (JAX {iters}), peak device memory "
            f"{c['peak_mib']:.1f} MiB")
        _hold_count(name, c["iterations"], iters, name)
        _check_panel_launches(name, c, per_numeric)
        if c["K6"] != k6_per_solve * (c["solves"] or 0):  # the banded solver counts no solves
            raise AssertionError(f"{name}: K6 {c['K6']} launches for {c['solves']} back solves")
        rows[name] = c
        del iface, solver
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc, out, err = _run_tool(["parapint_tpu_torch.tools.bench_all", "--timeout",
                              str(BENCH_ROW_TIMEOUT), *BENCH_CHILD_ROWS], BENCH_ALL_TIMEOUT)
    print("\n".join(out))
    say(f"bench_all: exit {rc} in {time.perf_counter() - t0:.1f} s")
    records = {r["config"]: r for r in map(json.loads, out[2:])}
    if rc != 0 or sorted(records) != sorted(BENCH_CHILD_ROWS):
        raise AssertionError(f"bench_all: exit {rc}, rows {list(records)}\n{err[-3000:]}")
    for name, r in records.items():
        if "error" in r or r["device"] != SMI:
            raise AssertionError(f"bench_all {name}: {r}")
        _hold_count(f"bench_all {name}", r["n_iter"], BENCH_NEW_ROWS[name][1], name)
    return rows, records


def _check_panel_launches(label, c, per_numeric):
    """K1-K5 launched ``per_numeric[k]`` times (0 where absent) per numeric."""
    for k in ("K1", "K2", "K3", "K4", "K5"):
        if c[k] != per_numeric.get(k, 0) * c["numerics"]:
            raise AssertionError(f"{label}: {k} {c[k]} launches for {c['numerics']} numerics, "
                                 f"expected {per_numeric.get(k, 0)} per numeric")


def jax_count_set(config):
    """The iterations the JAX package takes on a configuration of
    ``PARITY`` over its ensembles: the fused one of the initial point's
    one-ulp perturbations and any the entry names after its digest (the
    bf16-W flagship's: ROADMAP C5)."""
    entry = PARITY[config]
    return sorted(set(entry[2]).union(*entry[5:]))


def _hold_count(label, n_iter, ref, config):
    """A fused solve's iterations: within 1 of the JAX package's ``ref``
    and, where ``PARITY`` has ``config``, in ``jax_count_set``.  A count
    outside the initial point's fused ensemble alone is printed as a count
    flag (ROADMAP C5), not held."""
    if abs(n_iter - ref) > 1:
        raise AssertionError(f"{label}: {n_iter} iterations, JAX {ref}")
    if config not in PARITY:
        return
    if n_iter not in jax_count_set(config):
        raise AssertionError(f"{label}: {n_iter} iterations, outside the JAX ensembles' counts "
                             f"{jax_count_set(config)}")
    if n_iter not in PARITY[config][2]:
        say(f"{label}: count flag: {n_iter} iterations, outside the JAX initial-point "
            f"ensemble's set {sorted(set(PARITY[config][2]))} (in its other ensembles')")


def _parity_config(name, device="cuda"):
    """(interface, solver) of a configuration of ``PARITY`` on ``device``."""
    if name == "burgers_bf16_w":
        return _dense_iface(device), _bf16_solver()
    if name == "burgers_two_kinds":
        from parapint_tpu_torch.examples import burgers

        return (burgers_two_kinds(burgers.build_spec(**FLAGSHIP, device=device),
                                  kkt_dtype=torch.float32), _dense_solver("cr"))
    from parapint_tpu_torch.tools import bench_all

    return bench_all.make_row(name, device)


def _parity_launches(name):
    """Panel-kernel launches per numeric of a configuration of ``PARITY``."""
    if name in ("burgers_two_kinds", "burgers_bf16_w"):
        return dict(K1=DENSE_K1_PER_NUMERIC)
    if name == "burgers_pcg_coupling_8blocks":
        return dict(K1=PCG_K1_PER_NUMERIC)
    return BENCH_NEW_ROWS[name][2]


def _ensemble(iface, solver, label, n, ref, tol=TOL, statuses=None):
    """The fused solve from the initial iterate and from its ``n`` one-ulp
    perturbations (``ulp_perturbations``), each optimal at the JAX
    objective ``ref``: (iterations per point, the unperturbed first; a
    digest of the initial primal point's bytes).  With a list
    ``statuses``, a perturbed point may end with another status, which is
    appended there (each point's status name, the unperturbed first, which
    must be optimal)."""
    import parapint_tpu_torch as ptt

    opts = ptt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    s0 = iface.init_state()
    primals = {k: v.cpu().numpy() for k, v in s0.primals.items()}
    digest = primal_digest(primals)
    counts = []
    for p in [None, *ulp_perturbations(primals, n)]:
        state = s0 if p is None else dataclasses.replace(s0, primals={
            k: torch.as_tensor(v, dtype=torch.float64, device=iface.device) for k, v in p.items()})
        result = solve(state)
        status = ptt.InteriorPointStatus(int(result.status)).name
        if statuses is not None:
            statuses.append(status)
        if statuses is None or status == "optimal" or not counts:
            _objective_gap(iface, result, f"{label} point {len(counts)}", ref)
        counts.append(result.iterations)
    return counts, digest


def _distribution(counts):
    return {n: counts.count(n) for n in sorted(set(counts))}


def phase_parity(names=None):
    """ROADMAP C13/C14 on the card, for each configuration of ``PARITY``
    (default ``PARITY_CARD``): ``_counted_ip_solve`` (its log table printed,
    within 1 of the JAX package's ``ip_solve`` count), then
    the fused solve from the initial point and its one-ulp perturbations
    (the points of the JAX package's CPU ensemble: the initial point's
    digest must match), every count zeroed before them and read after:
    every solve optimal at the JAX objective, the unperturbed count within
    1 of the JAX package's and in the JAX ensemble's set of counts, the
    panel launches per numeric of the configuration and K6 == 2 x back
    solves + CG iterations; the two distributions printed side by side
    with their sign test."""
    out = {}
    for name in PARITY_CARD if names is None else names:
        n, ref, jax_counts, jax_ip, digest_cpu, *_ = PARITY[name]
        t0 = time.perf_counter()
        iface, solver = _parity_config(name)
        gated = name in PARITY_NOT_OPTIMAL
        # an entry that names further ensembles (the bf16-W flagship's:
        # ROADMAP C5) holds its ip_solve to their set instead of within 1
        n_ip = _counted_ip_solve(iface, solver, f"{name} ip_solve", ref, jax_ip[0],
                                 ref_set=jax_count_set(name) if len(PARITY[name]) > 5
                                 else None)["iterations"]
        _reset_counts()
        _reset_solver(solver)
        statuses = [] if gated else None
        counts, digest = _ensemble(iface, solver, name, n, ref, statuses=statuses)
        c = _counts()
        _solver_counts(solver, c)
        _check_panel_launches(f"{name} ensemble", c, _parity_launches(name))
        if not c["K6"] == 2 * c["solves"] + sum(c.get("cg", [])) > 0:
            raise AssertionError(f"{name} ensemble: K6 {c['K6']} launches for {c['solves']} back solves")
        if gated:
            # ROADMAP C5's rules (c)-(d): the unperturbed solve optimal
            # (``_ensemble``), the share of the others not optimal no higher
            # than the JAX package's by the one-sided Fisher test
            bad = sum(st != "optimal" for st in statuses)
            p_share = fisher_greater(bad, len(statuses), PARITY_NOT_OPTIMAL[name], len(jax_counts))
            say(f"{name}: statuses {statuses}; not optimal {bad} of {len(statuses)} (JAX CPU "
                f"{PARITY_NOT_OPTIMAL[name]} of {len(jax_counts)}), one-sided Fisher p {p_share:.4f}; "
                f"gate fallbacks {solver.n_gate_fallbacks}, bf16 K6 launches {c['K6_bf16']}")
            if p_share < LEAN_P:
                raise AssertionError(f"{name}: {bad} of {len(statuses)} solves not optimal, JAX "
                                     f"{PARITY_NOT_OPTIMAL[name]} (Fisher p {p_share:.4f}; ROADMAP C5 (c))")
            if not c["K6_bf16"] > 0:
                raise AssertionError(f"{name} ensemble: no bf16 K6 launch")
        jax_set = jax_count_set(name)
        up, down, p = sign_test(jax_counts, counts)
        say(f"{name}: ip_solve {n_ip} iterations (JAX {jax_ip[0]}); fused from the initial point {counts[0]} "
            f"(JAX {jax_counts[0]}, JAX ensemble's set {jax_set}); over {n} one-ulp "
            f"perturbations (seed {ENSEMBLE_SEED}) card {_distribution(counts[1:])}, JAX CPU "
            f"{_distribution(jax_counts[1:])}; against JAX point by point {up} above, {down} below, "
            f"sign test p {p:.4f} (a lean below {LEAN_P}: ROADMAP C13/C14); initial point digest "
            f"{digest} (CPU {digest_cpu}); ensemble launches {c}; {time.perf_counter() - t0:.1f} s")
        if digest != digest_cpu:
            raise AssertionError(f"{name}: the initial point differs from the CPU's")
        _hold_count(name, counts[0], jax_counts[0], name)
        out[name] = dict(ip_solve=n_ip, fused=counts, jax_fused=jax_counts, sign_test=[up, down, p],
                         launches=c, statuses=statuses)
        del iface, solver
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one CUDA card")
    ap.add_argument("--parity", nargs="+", metavar="CONFIG", choices=sorted(PARITY),
                    help="run only the build and phase 22 for these configurations")
    ap.add_argument("--arguments", action="store_true",
                    help="run only the build and phase 23")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    # every child interpreter (the spawned ranks, the bench tools and their
    # rows) imports torch anew; where no bytecode cache is kept
    # (PYTHONDONTWRITEBYTECODE, or a read-only site-packages), each would
    # compile torch's sources again, so the children share one cache in the
    # checkout's (gitignored) build directory
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.setdefault("PYTHONPYCACHEPREFIX", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "parapint_tpu_torch", "_build", "pycache"))
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(label):
        now = time.perf_counter()
        print(f"chip_smoke: {label} done at {now - t_start:.1f} s (+{now - laps[-1]:.1f} s)")
        laps.append(now)

    phase_device()
    phase_build()
    lap("build")
    if args.parity or args.arguments:
        if args.parity:
            print(json.dumps({"parity": phase_parity(args.parity)}))
            lap("parity")
        if args.arguments:
            print(json.dumps({"arguments": phase_arguments()}))
            lap("arguments")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return
    err, timing = phase_kernels()
    k7_launches, timing["K7"], k7_rate = phase_kernel_lab()
    err["K7"] = 0.0
    lap("kernels and kernel lab")
    iface = _dense_iface()
    dense = phase_dense(iface)
    warm, cold_x = phase_results(iface, dense)
    dense_sc = phase_dense_sc(iface)
    phase_bf16(iface)
    ld, ld_LD = phase_ld(iface)
    column, column_ld = phase_column(iface, dense, ld_LD)
    phase_fixed_order(iface)
    lap("dense flagship phases 4-8b")
    del iface, ld_LD
    torch.cuda.empty_cache()
    phase_stochastic_qp()
    lap("stochastic QP")
    torch.cuda.empty_cache()
    phase_farmer()
    single = phase_single()
    banded, banded_iface = phase_banded()
    lap("farmer, single NLP, banded")
    phase_heterogeneous()
    lap("heterogeneous")
    torch.cuda.empty_cache()
    phase_pcg()
    dense_iface = _dense_iface()
    phase_pcg_first_kkt(dense_iface)
    lap("PCG")
    arguments = phase_arguments(banded_iface, dense_iface)
    lap("arguments (phase 23)")
    del banded_iface, dense_iface
    torch.cuda.empty_cache()
    phase_condensed()
    lap("condensed")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as outdir:
        sharded_one = phase_sharded_one_rank(outdir, dense, cold_x)
        torch.cuda.empty_cache()
        sharded_two = phase_sharded_two_ranks(outdir, dense, cold_x)
        lap("sharded")
    host_bk = phase_host_bk(single)
    phase_compat()
    lap("host BK, compat")
    torch.cuda.empty_cache()
    bench = phase_bench()
    lap("bench")
    bench_rows, bench_all_records = phase_bench_rows()
    lap("bench_all")
    parity = phase_parity()
    lap("parity")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    src = "parapint_tpu_torch/csrc/ldl_panel_winv.cu"
    rows = [
        ("K1", "ldl_panels_slab_winv", src, "parapint_tpu/ops/pallas_ldl.py:408", dense["K1"]),
        ("K2", "ldl_panels_slab", src, "parapint_tpu/ops/pallas_ldl.py:364", ld["K2"]),
        ("K3", "ldl_panels_batched_winv", src, "parapint_tpu/ops/pallas_ldl.py:495", column["K3"]),
        ("K4", "ldl_panels_batched", src, "parapint_tpu/ops/pallas_ldl.py:554", column_ld["K4"]),
        ("K5", "ldl_panels", src, "parapint_tpu/ops/pallas_ldl.py:583", dense_sc["K5"]),
        ("K6", "winv_apply_fused", "parapint_tpu_torch/csrc/winv_apply.cu",
         "parapint_tpu/ops/winv_apply.py:138", dense["K6"]),
        ("K7", "read_reduce", "parapint_tpu_torch/csrc/read_reduce.cu",
         "tools/kernel_lab.py:276", k7_launches),
    ]
    # each bytes-bound kernel's time against the bytes it moves at K7's
    # measured read rate, beside the spec bound (3.35 TB/s)
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K6 bf16", "K6 QP", "K7"):
        t = timing[key]
        if t["bound_by"] == "bytes":
            at_k7 = t["bound_ms"] * PEAK_BYTES / k7_rate
            say(f"{key} {tuple(t['shape'])}: {t['ms']:.4f} ms; at K7's read rate "
                f"{k7_rate / 1e9:.1f} GB/s the bytes take {at_k7:.5f} ms "
                f"({at_k7 / t['ms'] * 100:.1f}% of its time), at 3.35 TB/s {t['bound_ms']:.5f} ms "
                f"({t['bound_ms'] / t['ms'] * 100:.1f}%)")
    kernels = []
    for key, name, source, replaces, launches in rows:
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t.get("library"),
            "shape": list(t["shape"]),
        })
    print(f"banded flagship K1 launches {banded['K1']} for {banded['numerics']} numerics [{SMI}]")
    # the sharded cases' counts, walls and all-reduce times per rank
    print(json.dumps({"sharded": {"one_rank_nccl": sharded_one,
                                  f"{SHARDED_WORLD}_ranks_gloo": sharded_two},
                      "host_bk": host_bk, "warm_start": warm}))
    # the bench tool's runs and the bench_all rows: counts in process, then
    # the tool's lines
    print(json.dumps({"bench": bench, "bench_all_rows": bench_rows,
                      "bench_all": bench_all_records}))
    # phase 22: the port's counts against the JAX package's ensembles
    print(json.dumps({"parity": parity}))
    # phase 23: the restored arguments' cases
    print(json.dumps({"arguments": arguments}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
