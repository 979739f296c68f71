"""Sharded solvers of the PyTorch port on gloo CPU ranks vs the JAX package's
sharded solvers on a mesh of as many virtual CPU devices.

For each world size P in (2, 4) one launch starts P rank processes (this
file run as a script: it imports torch, numpy and the port, never jax);
both launches start together, once the JAX first KKTs are written.  Each
rank joins a gloo process group, runs every case below in turn and writes
its results to ``rank{r}.npz``; while they run, the pytest process
computes the JAX references once, on 2 devices, for both world sizes (a
sharded answer does not depend on the device count beyond rounding), in
a few threads side by side.  The parametrised tests then compare.  The
inputs that are not regenerated from a seed (the Burgers KKTs) are built
by the JAX package and handed to the ranks in ``inputs.npz``.

Cases and their references (tolerances are the JAX package's own tests'):
- the random systems of ``tests/test_schur.py`` through
  ``ShardedSchurComplementSolver(block_size=8)``: solution within 1e-12 of
  the JAX sharded solver's, inertia exact;
- its LD mode with adaptive refinement: error to the planted solution below
  1e-8 (the JAX test's oracle);
- the chain helpers with ``group_offset`` (in this process, no ranks):
  against the JAX package's, 1e-12;
- the first KKT of Burgers nfe_x=8 at 8 blocks (divisible) and 11 blocks
  (padded on 2 and 4 ranks) through the dense and the banded sharded
  solvers: solution within 1e-11 of the JAX sharded solver's, inertia and
  status equal;
- fused solves of the same two NLPs through both sharded solvers: the JAX
  status, iterations within 1 and objective within 1e-6 relative of ONE
  JAX sharded fused solve per NLP on 2 devices (8 blocks: the banded
  flagship configuration; 11 blocks: ``dryrun_multichip``'s non-divisible
  configuration, padded to 12);
- the stochastic QP at the CPU tests' size with a non-trivial
  ``ownership_map`` (ranks in reverse or alternating order) through the
  hybrid sharded solver: against the JAX sharded fused solve with
  ownership on 2 devices (status, iterations within 1, objective 1e-6,
  per-scenario primals in ORIGINAL order 1e-6), the accessors' order, and
  the map's validation;
- the harness's psc on 3 blocks, whose default mesh leaves a rank out
  (that rank returns None; the others match the serial ssc's max_err to
  1e-10);
- the harness's psc at the CPU tests' size: max_err within 1e-10 relative
  of the JAX psc solver's (``ShardedSchurComplementSolver(block_size=128)``
  on the harness's KKT); ``PCGSchurComplementSolver`` with a mesh on the 8-block
  KKT and ``CondensedLSQSolver`` with a mesh on 5 blocks (padded): 1e-9
  relative of the JAX package's with a mesh;
- the interfaces with mesh= (each rank evaluates the model and assembles
  the KKT for its own blocks only): the four Burgers cases through the
  fused driver, against the JAX references above and the same rank's
  replicated-iterate run (MESH_ATOL); ``ip_solve`` and PCG with a mesh
  against their replicated-iterate runs; the flagship as two kinds and the
  QP with its ownership map against the port's serial solves
  (SERIAL_RTOL); each rank's model calls counted on its own blocks;
- C11: the same interface with mesh= handed each serial solver (dense,
  banded, PCG without a mesh), which gathers the rank-local KKT whole on
  every rank: the gathered first KKT equal to the replicated interface's,
  the solve against the JAX package's mesh= interface with the same solver
  (status, iterations within 1, objective 1e-6; once, on 2 devices) and
  the replicated interface's run (equal iterations, MESH_ATOL); one numeric
  and one solve of the float64 mesh= KKT through the serial and the
  sharded solver (inertia equal, solutions within 1e-11);
- the QP's accessors under its ownership map from one seeded state,
  bitwise equal to the JAX package's interface on P devices;
- the restored solver arguments (``zero_tol``, ``refine_trigger``,
  ``refine_max_passes``; banded ``refine_steps``, ``tile_block_size``)
  through the sharded solvers against their serial twins (inertia and
  status equal, passes equal, solutions 1e-11), and the examples' ``main``
  with mesh= (Burgers against its replicated run, MESH_ATOL; dynamics and
  the farmer on a 3-rank ``block_mesh(devices=...)`` at their golden
  values);
- every array a rank wrote, but the per-rank ones, is bitwise equal on all
  ranks.

    python -m pytest tests/test_torch_sharded.py -q
"""

import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
LAUNCH_TIMEOUT = 400  # seconds for the ranks of both launches to finish every case
RANDOM_SYSTEMS = ((8, 12, 5), (16, 8, 3))
NLPS = {8: dict(nfe_x=8, nfe_t=16, num_time_blocks=8), 11: dict(nfe_x=8, nfe_t=22, num_time_blocks=11)}
# solver-level and fused cases: (block form, NLP)
CASES = {"dense8": ("dense", 8), "banded8": ("banded", 8), "dense11": ("dense", 11),
         "banded11": ("banded", 11)}
QP_SMALL = dict(n_scenarios=4, n=48, me=12, n_first=8)
OWNERSHIP = {2: [1, 0, 1, 0], 4: [3, 2, 1, 0]}
HARNESS = dict(n_blocks=4, n_q_per_block=32, n_y_multiplier=2, n_theta=5)
# 3 blocks: psc's default mesh is then a sub-mesh (1 of 2 ranks, 3 of 4)
PSC_SUBMESH = dict(HARNESS, n_blocks=3)
CONDENSED = dict(n_blocks=5, n_q_per_block=32, n_y_multiplier=2, n_theta=5)
TOL = 1e-8
OBJ_REL_GAP = 1e-6
# an interface with mesh= against the same rank's replicated-iterate run
# (the JAX package's sharded-vs-serial test, tests/test_dynamic.py:137-147)
MESH_ATOL = 1e-10
# against the port's serial solver (another factorization order)
SERIAL_RTOL = 1e-6
# the serial solvers handed a mesh= interface's rank-local KKT (ROADMAP C11)
SERIAL_SOLVERS = ("dense", "banded", "pcg")
# burgers.main's size with mesh= (tests/test_torch_interior_point.py holds
# its serial run to the JAX package's)
EXAMPLE_BURGERS = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
# the examples' golden values (tests/test_examples.py): dynamics p(t) within
# 1e-6, the farmer's acreage within 1e-4
DYNAMICS_GOLDEN_P = (1.6046242850486279, 2.0, 1.4792062911745605, 0.5082444341496647,
                     -0.009859487375413882, 0.40043954978583834, 1.3619861771562247,
                     1.99059057528143, 1.7102013685364827)
FARMER_ACRES = (170.0, 80.0, 250.0)


def make_system(N=4, nk=12, nc=5, seed=0):
    """tests/test_schur.py's random block-bordered system (SPD blocks)."""
    rng = np.random.default_rng(seed)
    diag = np.zeros((N, nk, nk))
    border = np.zeros((N, nc, nk))
    for i in range(N):
        A = rng.standard_normal((nk, nk))
        diag[i] = A @ A.T + nk * np.eye(nk)
        border[i] = rng.standard_normal((nc, nk)) * (rng.random((nc, nk)) < 0.4)
    q = rng.standard_normal((nc, nc))
    q = q @ q.T + nc * np.eye(nc)
    return diag, border, q


def dense_assemble(diag, border, q):
    N, nk, _ = diag.shape
    nc = q.shape[0]
    M = np.zeros((N * nk + nc, N * nk + nc))
    for i in range(N):
        M[i * nk : (i + 1) * nk, i * nk : (i + 1) * nk] = diag[i]
        M[N * nk :, i * nk : (i + 1) * nk] = border[i]
        M[i * nk : (i + 1) * nk, N * nk :] = border[i].T
    M[N * nk :, N * nk :] = q
    return M


def planted_rhs(diag, border, q, seed):
    """(M, x_true, rhs blocks, rhs coupling) with rhs = M x_true."""
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(seed).standard_normal(M.shape[0])
    rhs = M @ x_true
    n = diag.shape[0] * diag.shape[1]
    return M, x_true, rhs[:n].reshape(diag.shape[:2]), rhs[n:]


def burgers_solver(pkg, mesh, case, ns, f32=None):
    """The sharded solver of ``case`` from either package (same names and
    keywords); ``f32`` (that package's float32) selects the fused solves'
    float32 factors, None the solver-level float64 configuration."""
    form, nlp = CASES[case]
    if form == "banded":
        cr = pkg.BlockTridiagSolver(ns=ns) if nlp == 8 else None
        return pkg.ShardedBandedSchurComplementSolver(mesh, schur_complement_solver=cr)
    if nlp == 8:
        return pkg.ShardedSchurComplementSolver(
            mesh, "blocks", block_size=128, explicit_inverse=True, factor_dtype=f32,
            schur_complement_solver=pkg.BlockTridiagSolver(),
        )
    if f32 is None:
        return pkg.ShardedSchurComplementSolver(mesh, "blocks")
    # dryrun_multichip's non-divisible configuration
    return pkg.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=32, explicit_inverse=True, factor_dtype=f32
    )


def seeded_state(iface, seed) -> dict:
    """An iterate of standard normal draws in ``iface``'s shapes (either
    package's structured interface) as the JAX package's ``IPState``
    pytree of numpy arrays: the same state for both packages
    (``convert.ipstate_from_numpy``)."""
    rng = np.random.default_rng(seed)
    N, n, me, mi, L, nc = iface.N, iface.n, iface.me, iface.mi, iface.n_link, iface.ncv
    d = lambda *shape: rng.standard_normal(shape)
    return dict(
        primals={"blocks": d(N, n), "coupling": d(nc)}, slacks=d(N, mi),
        duals_eq={"own": d(N, me), "link": d(N, L)}, duals_ineq=d(N, mi),
        duals_primals_lb={"blocks": d(N, n), "coupling": d(nc)},
        duals_primals_ub={"blocks": d(N, n), "coupling": d(nc)},
        duals_slacks_lb=d(N, mi), duals_slacks_ub=d(N, mi),
    )


def serial_solver(pkg, name, ns, f32):
    """A serial solver of either package for the 8-block Burgers NLP: the
    dense flagship's, the banded flagship's or PCG without a mesh."""
    if name == "banded":
        return pkg.BandedSchurComplementSolver(schur_complement_solver=pkg.BlockTridiagSolver(ns=ns))
    if name == "pcg":
        return pkg.PCGSchurComplementSolver(block_size=128, factor_dtype=f32)
    return pkg.SchurComplementSolver(block_size=128, explicit_inverse=True, factor_dtype=f32,
                                     schur_complement_solver=pkg.BlockTridiagSolver())


def serial_iface(ptt, burgers, name, mesh=None):
    """The port's 8-block Burgers interface (float32 KKT) in the block form
    of serial solver ``name``, with ``mesh=`` when one is given."""
    return ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**NLPS[8], device="cpu"), mesh=mesh, kkt_dtype=torch.float32,
        block_form="banded" if name == "banded" else "dense")


def kkt_fields(kkt) -> dict:
    """A whole Local/BandedLocalBlockKKT's block tensors as numpy (the
    dtypes kept), its assembly and whether it is rank-local."""
    names = ("sym_bands", "perm", "iperm") if hasattr(kkt, "sym_bands") else ("diag",)
    out = {f: getattr(kkt, f).numpy() for f in names + ("border_loc", "row_idx", "q", "mask")}
    out["assembly"] = np.array(kkt.assembly)
    out["rank_local"] = np.array(kkt.global_blocks is not None)
    return out


def _count_blocks(iface) -> set:
    """The block counts of every batched model call the interface makes
    from now on (its model functions wrapped)."""
    import dataclasses

    seen = set()
    fns = iface._view.fns

    class Counting:
        def __getattr__(self, name):
            fn = getattr(fns, name)

            def call(x, *args):
                seen.add(x.shape[0])
                return fn(x, *args)

            return call

    iface._view = dataclasses.replace(iface._view, fns=Counting())
    return seen


# -- rank side: torch, numpy and the port only -------------------------------


def _rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers, dynamics, stochastic
    from parapint_tpu_torch.examples.performance import schur_complement as perf
    from parapint_tpu_torch.convert import ipstate_from_numpy
    from parapint_tpu_torch.linalg.banded_schur import BandedLocalBlockKKT
    from parapint_tpu_torch.linalg.schur import BlockKKT, BlockRhs, LocalBlockKKT, gather_kkt
    from parapint_tpu_torch.parallel import distributed
    from parapint_tpu_torch.parallel.mesh import block_mesh

    import chip_smoke
    from parapint_tpu_torch.utils.timer import HierarchicalTimer

    workdir = Path(workdir)
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu")
    mesh = distributed.global_mesh("blocks")
    inputs = dict(np.load(workdir / "inputs.npz"))
    t = torch.as_tensor
    out = {}

    def mesh_solve(key, iface, solver, driver="fused"):
        """Solve; keep status, iterations, objective and the final primals,
        and (an interface with a mesh) the block counts of its model calls
        and its block range, per rank."""
        seen = _count_blocks(iface) if iface.mesh is not None else None
        opts = ptt.IPOptions()
        opts.tol = TOL
        opts.linalg.solver = solver
        if driver == "fused":
            status, res = ptt.ip_solve_fused(iface, opts)
            iters = res.iterations
        else:
            timer = HierarchicalTimer()
            status = ptt.ip_solve(iface, opts, timer=timer)
            iters = timer._root.children["IP solve"].children["convergence check"].count
        primals = iface.get_state().primals
        out[key + "/result"] = np.array([status.value, iters, float(iface.evaluate_objective())])
        out[key + "/x"], out[key + "/c"] = primals["blocks"].numpy(), primals["coupling"].numpy()
        if seen is not None:
            out[f"rank/{key}/blocks"] = np.array(sorted(seen))
            out[f"rank/{key}/range"] = np.array(iface.block_range)

    def keep(key, x: BlockRhs, fact=None, solver=None, status=None):
        out[key + "/xb"], out[key + "/xc"] = x.blocks.numpy(), x.coupling.numpy()
        if fact is not None:
            out[key + "/inertia"] = np.array([int(v) for v in solver.inertia(fact)])
        if status is not None:
            out[key + "/status"] = np.array(int(status))

    for N, nk, nc in RANDOM_SYSTEMS:
        diag, border, q = make_system(N, nk, nc, seed=9)
        _, _, rb, rc = planted_rhs(diag, border, q, seed=3)
        solver = ptt.ShardedSchurComplementSolver(mesh, "blocks", block_size=8)
        fact = solver.numeric(BlockKKT.make(t(diag), t(border), t(q)))
        keep(f"random{N}", solver.solve(fact, BlockRhs(t(rb), t(rc))), fact, solver,
             solver.status(fact))

    diag, border, q = make_system(8, 12, 5, seed=11)
    _, x_true, rb, rc = planted_rhs(diag, border, q, seed=7)
    solver = ptt.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=8, explicit_inverse=False, factor_dtype=torch.float32
    )
    fact = solver.numeric(BlockKKT.make(t(diag), t(border), t(q)))
    x = solver.solve(fact, BlockRhs(t(rb), t(rc)))
    err = np.abs(np.concatenate([x.blocks.numpy().ravel(), x.coupling.numpy()]) - x_true).max()
    out["ld/err"] = np.array(err / np.abs(x_true).max())
    out["ld/kept"] = np.array([fact.diag is not None, fact.q is not None,
                               fact.block_LD is not None, fact.block_W is None])

    for case, (form, nlp) in CASES.items():
        g = lambda name: t(inputs[f"{case}/{name}"])
        if form == "banded":
            kkt = BandedLocalBlockKKT(
                sym_bands=g("sym_bands"), border_loc=g("border_loc"), row_idx=g("row_idx"),
                q=g("q"), mask=g("mask"), perm=g("perm"), iperm=g("iperm"),
                assembly=str(inputs[f"{case}/assembly"]),
            )
        else:
            kkt = LocalBlockKKT(
                diag=g("diag"), border_loc=g("border_loc"), row_idx=g("row_idx"), q=g("q"),
                mask=g("mask"), assembly=str(inputs[f"{case}/assembly"]),
            )
        rhs = BlockRhs(g("rhs_blocks"), g("rhs_coupling"))
        ns = kkt.border_loc.shape[1] // 2
        solver = burgers_solver(ptt, mesh, case, ns)
        fact = solver.numeric(kkt)
        x, status = solver.solve_with_status(fact, rhs)
        keep(f"kkt/{case}", x, fact, solver, status)
        if case == "dense8":
            pcg = ptt.PCGSchurComplementSolver(mesh, "blocks", block_size=128)
            pfact = pcg.numeric(kkt)
            x, status = pcg.solve_with_status(pfact, rhs)
            keep("pcg", x, pfact, pcg, status)

        spec = burgers.build_spec(**NLPS[nlp], device="cpu")
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            spec, kkt_dtype=torch.float32, block_form=form
        )
        opts = ptt.IPOptions()
        opts.tol = TOL
        opts.linalg.solver = burgers_solver(ptt, mesh, case, iface.ns, torch.float32)
        status, res = ptt.ip_solve_fused(iface, opts)
        out[f"fused/{case}/result"] = np.array(
            [status.value, res.iterations, float(iface.evaluate_objective())]
        )
        out[f"fused/{case}/x"] = res.state.primals["blocks"].numpy()
        out[f"fused/{case}/c"] = res.state.primals["coupling"].numpy()

    # the interfaces with mesh=: each rank evaluates the model and assembles
    # the KKT for its own blocks only
    for case, (form, nlp) in CASES.items():
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**NLPS[nlp], device="cpu"), mesh=mesh, kkt_dtype=torch.float32,
            block_form=form,
        )
        mesh_solve(f"mesh/{case}", iface, burgers_solver(ptt, mesh, case, iface.ns, torch.float32))
    for use_mesh in (True, False):
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**NLPS[8], device="cpu"), mesh=mesh if use_mesh else None,
            kkt_dtype=torch.float32,
        )
        key = "mesh/ip_solve" if use_mesh else "ip_solve"
        mesh_solve(key, iface, burgers_solver(ptt, mesh, "dense8", iface.ns, torch.float32),
                   driver="ip_solve")
        pcg = ptt.PCGSchurComplementSolver(mesh, "blocks", block_size=128, factor_dtype=torch.float32)
        mesh_solve("mesh/pcg" if use_mesh else "pcg_fused", iface, pcg)
    # the flagship as two kinds: kind 0 holds block 0, kind 1 the others
    spec = burgers.build_spec(**NLPS[8], device="cpu")
    mesh_solve("mesh/two_kinds", chip_smoke.burgers_two_kinds(spec, torch.float32, mesh=mesh),
               burgers_solver(ptt, mesh, "dense8", spec.num_states, torch.float32))
    mesh_solve("two_kinds_serial", chip_smoke.burgers_two_kinds(spec, torch.float32),
               ptt.SchurComplementSolver(block_size=128, explicit_inverse=True,
                                         factor_dtype=torch.float32,
                                         schur_complement_solver=ptt.BlockTridiagSolver()))

    # C11: the mesh= interface through a serial solver, which gathers the
    # rank-local KKT whole on every rank
    mu = torch.tensor(0.1, dtype=torch.float64)
    for name in SERIAL_SOLVERS:
        iface = serial_iface(ptt, burgers, name, mesh)
        kkt = gather_kkt(iface.assemble_kkt(iface.eval_kkt_data(iface.init_state(), mu), 0.0, 0.0))
        out.update({f"serial/{name}/kkt/{k}": v for k, v in kkt_fields(kkt).items()})
        mesh_solve(f"serial/{name}", iface, serial_solver(ptt, name, iface.ns, torch.float32))
    # one numeric and one solve, the serial against the sharded solver, on
    # the same mesh= KKT (float64; tests/test_banded.py's single step)
    for form in ("dense", "banded"):
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**NLPS[8], device="cpu"), mesh=mesh, block_form=form)
        data = iface.eval_kkt_data(iface.init_state(), mu)
        kkt, rhs = iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)
        pair = ((ptt.BandedSchurComplementSolver(), ptt.ShardedBandedSchurComplementSolver(mesh))
                if form == "banded" else
                (ptt.SchurComplementSolver(), ptt.ShardedSchurComplementSolver(mesh, "blocks")))
        for kind, solver in zip(("serial", "sharded"), pair):
            fact = solver.numeric(kkt)
            x, status = solver.solve_with_status(fact, rhs)
            keep(f"step/{form}/{kind}", x, fact, solver, status)

    # the restored solver arguments at user values through the sharded
    # solvers and their serial twins, on the same KKTs: the planted-pivot
    # random system (zero_tol counts the pivot as zero) and the 8-block
    # banded first KKT (fixed refinement passes, one panel per tile)
    diag, border, q = make_system(8, 12, 5, seed=9)
    diag[0, :2, :], diag[0, :, :2], border[0, :, :2] = 0.0, 0.0, 0.0
    diag[0, :2, :2] = [[1.0, 1.0], [1.0, 1.0 + 1e-12]]
    dense_args = dict(block_size=8, zero_tol=1e-10, explicit_inverse=True,
                      refine_trigger=1e-3, refine_max_passes=2)
    for kind, solver in (("serial", ptt.SchurComplementSolver(**dense_args)),
                         ("sharded", ptt.ShardedSchurComplementSolver(mesh, "blocks", **dense_args))):
        fact = solver.numeric(BlockKKT.make(t(diag), t(border), t(q)))
        out[f"args/dense/{kind}/inertia"] = np.array([int(v) for v in solver.inertia(fact)])
        out[f"args/dense/{kind}/status"] = np.array(int(solver.status(fact)))
        out[f"args/dense/{kind}/kept"] = np.array([
            solver.zero_tol, solver.sc_solver.zero_tol, solver.refine_trigger,
            solver.refine_max_passes])
    g = lambda name: t(inputs[f"banded8/{name}"])
    kkt = BandedLocalBlockKKT(
        sym_bands=g("sym_bands"), border_loc=g("border_loc"), row_idx=g("row_idx"), q=g("q"),
        mask=g("mask"), perm=g("perm"), iperm=g("iperm"), assembly=str(inputs["banded8/assembly"]),
    )
    rhs = BlockRhs(g("rhs_blocks"), g("rhs_coupling"))
    banded_args = dict(refine_steps=2, tile_block_size=128)
    for kind, solver in (("serial", ptt.BandedSchurComplementSolver(**banded_args)),
                         ("sharded", ptt.ShardedBandedSchurComplementSolver(mesh, **banded_args))):
        calls = []
        once = solver._solve_once
        solver._solve_once = lambda *a: calls.append(1) or once(*a)
        fact = solver.numeric(kkt)
        x, status = solver.solve_with_status(fact, rhs)
        keep(f"args/banded/{kind}", x, fact, solver, status)
        out[f"args/banded/{kind}/passes"] = np.array(len(calls) - 1)

    # the examples' main with mesh=: Burgers over the whole mesh, the
    # 3-block dynamics example and the 3-scenario farmer over the mesh of
    # the first three ranks in reverse order (block_mesh's devices=), and
    # Burgers without a mesh (the replicated run the mesh= one equals)
    out["mesh3/ranks"] = np.array(block_mesh(devices=[1, 0]).mesh.tolist())
    mesh3 = block_mesh(devices=list(range(min(world, 3)))[::-1])
    for use in ("mesh", "serial"):
        iface = burgers.main(**EXAMPLE_BURGERS, mesh=mesh if use == "mesh" else None, device="cpu")
        out[f"main/burgers/{use}"] = iface.get_state().primals["blocks"].numpy()
    out["rank/main/dynamics_p"] = out["rank/main/farmer"] = np.zeros(0)  # a rank outside mesh3
    if mesh3.get_coordinate() is not None:
        _, _, p = dynamics.main(mesh=mesh3, device="cpu")
        out["rank/main/dynamics_p"] = p
        out["rank/main/farmer"] = stochastic.main(mesh=mesh3, device="cpu").get_first_stage_values().numpy()

    # the stochastic QP with a non-trivial ownership map
    own = OWNERSHIP[world]
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**QP_SMALL, device="cpu"), mesh=mesh, kkt_dtype=torch.float32,
        ownership_map=own,
    )
    opts = ptt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = ptt.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=128, explicit_inverse=True, factor_dtype=torch.float64,
        apply_dtype=torch.float32,
    )
    seen = _count_blocks(iface)
    status, res = ptt.ip_solve_fused(iface, opts)
    out["rank/qp/blocks"], out["rank/qp/range"] = np.array(sorted(seen)), np.array(iface.block_range)
    out["qp/result"] = np.array([status.value, res.iterations, float(iface.evaluate_objective())])
    n_sc = QP_SMALL["n_scenarios"]
    out["qp/block_primals"] = np.stack([iface.get_block_primals(i).numpy() for i in range(n_sc)])
    out["qp/primals"] = iface.get_primals()["blocks"].numpy()
    out["qp/raw"] = iface._current_state.primals["blocks"].numpy()
    out["qp/block_perm"] = np.asarray(iface.block_perm)
    out["qp/lam"] = iface.get_duals_nonanticipativity().numpy()
    out["qp/raw_lam"] = iface._current_state.duals_eq["link"].numpy()
    out["qp/first_stage"] = iface.get_first_stage_values().numpy()
    # every accessor from one seeded state (in storage order)
    iface._current_state = ipstate_from_numpy(seeded_state(iface, seed=5), "cpu")
    for name, v in chip_smoke.results(iface).items():
        out["acc/" + name] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    out["acc/raw_blocks"] = iface._current_state.primals["blocks"].numpy()
    out["acc/raw_ineq"] = iface._current_state.duals_ineq.numpy()
    out["acc/raw_lb"] = iface._current_state.duals_primals_lb["blocks"].numpy()
    serial = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**QP_SMALL, device="cpu"), kkt_dtype=torch.float32)
    opts.linalg.solver = ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float64, apply_dtype=torch.float32,
    )
    status, res = ptt.ip_solve_fused(serial, opts)
    out["qp_serial/result"] = np.array([status.value, res.iterations, float(serial.evaluate_objective())])
    out["qp_serial/primals"] = serial.get_primals()["blocks"].numpy()
    out["qp_serial/first_stage"] = serial.get_first_stage_values().numpy()
    raised = {}
    for key, bad in (("same number", [0] * n_sc), ("must be in", [world] * n_sc)):
        try:
            ptt.StochasticSchurComplementInteriorPointInterface(
                stochastic.qp_spec(**QP_SMALL, device="cpu"), mesh=mesh, ownership_map=bad
            )
            raised[key] = ""
        except ValueError as e:
            raised[key] = str(e)
    out["qp/validation"] = np.array([key in msg for key, msg in raised.items()])

    r = perf.run(method="psc", **HARNESS, verbose=False, device="cpu")
    out["psc"] = np.array([r.status, r.max_err])
    out["psc/theta"] = r.theta
    # a rank outside psc's sub-mesh takes no part and returns None
    r = perf.run(method="psc", **PSC_SUBMESH, verbose=False, device="cpu")
    ssc = perf.run(method="ssc", **PSC_SUBMESH, verbose=False, device="cpu")
    out["rank/psc_submesh"] = np.array([r is not None, np.nan if r is None else r.max_err,
                                        ssc.max_err])

    m = perf.SyntheticModel(**CONDENSED)
    csc = ptt.CondensedLSQSolver(tile_size=128, mesh=mesh)
    ckkt = ptt.CondensedLSQKKT(
        A_bands=t(m.A_bands), q_c=torch.zeros((m.n_theta, m.n_theta), dtype=torch.float64),
        n_t=m.n_theta, n_blocks=m.n_blocks,
    )
    keep("csc", csc.solve(csc.numeric(ckkt), m.build_rhs("cpu"), kkt=ckkt))

    np.savez(workdir / f"rank{rank}.npz", **out)
    distributed.shutdown()


# -- launches and references ---------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world: int, workdir: Path):
    """The ranks of one world size, each writing its output to
    ``rank{r}.log`` in ``workdir``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    port = _free_port()
    procs = []
    for r in range(world):
        with open(workdir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(r), str(world), str(port),
                 str(workdir)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            ))
    return procs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait(procs, workdir: Path, deadline: float):
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _kill(procs)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{(workdir / f'rank{r}.log').read_text()[-6000:]}"


def _jax_mesh(P):
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    return Mesh(np.array(jax.devices()[:P]), ("blocks",))


# threads that trace, compile and run the JAX references side by side (XLA
# compiles outside the interpreter lock)
JAX_THREADS = 4


def _in_threads(tasks: dict, here: dict = None) -> dict:
    """{key: fn(*args)} for ``tasks`` {key: (fn, *args)}, run in JAX_THREADS
    threads, and for ``here`` (the same form) run in this thread meanwhile
    (torch's forward AD keeps its levels per thread); every result is read,
    so a task's exception is raised here."""
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        futures = {key: pool.submit(*task) for key, task in tasks.items()}
        done = {key: fn(*args) for key, (fn, *args) in (here or {}).items()}
        return {**done, **{key: f.result() for key, f in futures.items()}}


def _jax_first_kkt(case):
    """The first KKT (initial state, barrier 0.1, float64) of ``case`` from
    the JAX package, with its rhs: a rank's solver-level input."""
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers as jburgers

    form, nlp = CASES[case]
    iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**NLPS[nlp]), block_form=form
    )
    data = iface.eval_kkt_data(iface.init_state(), 0.1)
    return iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)


def _jax_first_kkts():
    """{case: (kkt, rhs)} of every CASE."""
    return _in_threads({case: (_jax_first_kkt, case) for case in CASES})


def _jax_fused(mesh, case, f32):
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers as jburgers

    form, nlp = CASES[case]
    iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**NLPS[nlp]), mesh=mesh, kkt_dtype=f32, block_form=form
    )
    opts = pt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = burgers_solver(pt, mesh, case, iface.ns, f32)
    status, res = pt.ip_solve_fused(iface, opts)
    return status.value, int(res.iterations), float(iface.evaluate_objective())


def _jax_serial_on_mesh(mesh, name):
    """The JAX package's mesh= interface on the 8-block NLP through the
    serial solver ``name`` (XLA gathers the sharded KKT for it): (status,
    iterations, objective) of its fused solve."""
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.examples import burgers as jburgers

    iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**NLPS[8]), mesh=mesh, kkt_dtype=jnp.float32,
        block_form="banded" if name == "banded" else "dense")
    opts = pt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = serial_solver(pt, name, iface.ns, jnp.float32)
    status, res = pt.ip_solve_fused(iface, opts)
    return status.value, int(res.iterations), float(iface.evaluate_objective())


def _keeper(refs):
    def keep(key, x, solver=None, fact=None, status=None):
        refs[key + "/xb"], refs[key + "/xc"] = np.asarray(x.blocks), np.asarray(x.coupling)
        if fact is not None:
            refs[key + "/inertia"] = np.array([int(v) for v in solver.inertia(fact)])
        if status is not None:
            refs[key + "/status"] = int(status)

    return keep


def _jax_random(mesh):
    """The JAX sharded solver on the random systems on ``mesh`` (numeric
    and solve under ``jax.jit``, as the JAX package's tests run them).
    ``_jax_shared`` computes them once, on 2 devices, for every world size:
    the answers do not depend on the device count beyond rounding, far
    inside the tests' 1e-12."""
    import jax
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.linalg.schur import BlockKKT as JBlockKKT
    from parapint_tpu.linalg.schur import BlockRhs as JBlockRhs

    refs = {}
    keep = _keeper(refs)
    for N, nk, nc in RANDOM_SYSTEMS:
        diag, border, q = make_system(N, nk, nc, seed=9)
        _, _, rb, rc = planted_rhs(diag, border, q, seed=3)
        solver = pt.ShardedSchurComplementSolver(mesh, "blocks", block_size=8)
        fact = jax.jit(solver.numeric)(
            JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
        )
        x = jax.jit(solver.solve)(fact, JBlockRhs(blocks=jnp.asarray(rb), coupling=jnp.asarray(rc)))
        keep(f"random{N}", x, solver, fact, solver.status(fact))
    return refs


def _jax_qp_ownership(mesh):
    """The JAX sharded fused solve of the QP with ``OWNERSHIP[2]``: ((status,
    iterations, objective), the per-scenario primals in original order)."""
    import jax.numpy as jnp
    import parapint_tpu as pt

    import bench_all

    iface = pt.StochasticSchurComplementInteriorPointInterface(
        bench_all.stochastic_qp(**QP_SMALL).spec, mesh=mesh, kkt_dtype=jnp.float32,
        ownership_map=OWNERSHIP[2]
    )
    opts = pt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = pt.ShardedSchurComplementSolver(
        mesh, "blocks", block_size=128, explicit_inverse=True, factor_dtype=jnp.float64,
        apply_dtype=jnp.float32,
    )
    status, res = pt.ip_solve_fused(iface, opts)
    primals = np.stack(
        [np.asarray(iface.get_block_primals(i)) for i in range(QP_SMALL["n_scenarios"])]
    )
    return (status.value, int(res.iterations), float(iface.evaluate_objective())), primals


def _jax_kkt_solve(mesh, case, kkts):
    """The JAX sharded solver of ``case`` (or PCG with a mesh, on dense8's)
    on its first KKT, numeric and solve under ``jax.jit``."""
    import jax
    import parapint_tpu as pt

    refs = {}
    if case == "pcg":
        kkt, rhs = kkts["dense8"]
        solver = pt.PCGSchurComplementSolver(mesh, "blocks", block_size=128)
    else:
        kkt, rhs = kkts[case]
        solver = burgers_solver(pt, mesh, case, kkt.border_loc.shape[1] // 2)
    fact = jax.jit(solver.numeric)(kkt)
    x, status = jax.jit(solver.solve_with_status)(fact, rhs)
    _keeper(refs)(case if case == "pcg" else f"kkt/{case}", x, solver, fact, status)
    return refs


def _jax_harness(mesh):
    """The harness's psc (its sharded solver on its KKT) and csc with a mesh,
    under jit."""
    import jax
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.examples.performance import schur_complement as jperf
    from parapint_tpu.linalg import CondensedLSQKKT as JCondensedKKT

    refs = {}
    m = jperf.SyntheticModel(**HARNESS)
    psc = pt.ShardedSchurComplementSolver(mesh, "blocks", block_size=128)
    fact = jax.jit(psc.numeric)(m.build_kkt())
    x = jax.jit(psc.solve)(fact, m.build_rhs())
    refs["psc"] = np.array([int(psc.status(fact)), m.check_result(x.blocks)])
    m = jperf.SyntheticModel(**CONDENSED)
    csc = pt.CondensedLSQSolver(tile_size=128, mesh=mesh)
    ckkt = JCondensedKKT(
        A_bands=jnp.asarray(m.A_bands), q_c=jnp.zeros((m.n_theta, m.n_theta)),
        n_t=m.n_theta, n_blocks=m.n_blocks,
    )
    fact = jax.jit(csc.numeric)(ckkt)
    _keeper(refs)("csc", jax.jit(lambda f, r: csc.solve(f, r, kkt=ckkt))(fact, m.build_rhs()))
    return refs


def _port_serial_whole(name):
    """The port's replicated 8-block interface (no mesh) through serial
    solver ``name`` with one torch thread, as each rank runs: the first
    KKT's fields (``kkt_fields``) and the fused solve's result and final
    primals, keyed as the ranks' under ``serial_whole/{name}/``."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    iface = serial_iface(ptt, burgers, name)
    mu = torch.tensor(0.1, dtype=torch.float64)
    kkt = iface.assemble_kkt(iface.eval_kkt_data(iface.init_state(), mu), 0.0, 0.0)
    out = {f"kkt/{k}": v for k, v in kkt_fields(kkt).items()}
    opts = ptt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = serial_solver(ptt, name, iface.ns, torch.float32)
    status, res = ptt.ip_solve_fused(iface, opts)
    out["result"] = np.array([status.value, res.iterations, float(iface.evaluate_objective())])
    out["x"], out["c"] = (res.state.primals[k].numpy() for k in ("blocks", "coupling"))
    return {f"serial_whole/{name}/{k}": v for k, v in out.items()}


def _jax_shared(kkts):
    """The references held against every world size, computed once on a
    2-device mesh (the answers do not depend on the device count beyond
    rounding), in JAX_THREADS threads: the random systems
    (``_jax_random``), the Burgers first KKTs through the sharded dense,
    banded and PCG solvers, psc and csc, and the fused solves (8 and 11
    blocks, the QP with ownership, the mesh= interface with each serial
    solver); and the port's replicated runs with each serial solver
    (``_port_serial_whole``)."""
    import jax.numpy as jnp

    mesh = _jax_mesh(2)
    # the longest first
    tasks = {
        "qp": (_jax_qp_ownership, mesh),
        8: (_jax_fused, mesh, "banded8", jnp.float32),
        11: (_jax_fused, mesh, "dense11", jnp.float32),
        **{f"serial/{name}": (_jax_serial_on_mesh, mesh, name) for name in SERIAL_SOLVERS},
        "random": (_jax_random, mesh),
        "harness": (_jax_harness, mesh),
        **{f"solve/{case}": (_jax_kkt_solve, mesh, case, kkts) for case in (*CASES, "pcg")},
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        done = _in_threads(tasks, {f"serial_whole/{name}": (_port_serial_whole, name)
                                   for name in SERIAL_SOLVERS})
    finally:
        torch.set_num_threads(threads)
    refs = {}
    for key, value in done.items():
        if isinstance(value, dict):
            refs.update(value)
        elif key == "qp":
            refs["qp"], refs["qp/block_primals"] = value
        else:
            refs[key] = value
    return refs


_SHARED = {}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX first KKTs, as JAX arrays and in ``inputs.npz``; then every
    world size's ranks, started together so that they all run beside the
    JAX references (killed at the module's end if still running)."""
    workdir = tmp_path_factory.mktemp("sharded")
    kkts = _jax_first_kkts()
    arrays = {}
    for case, (kkt, rhs) in kkts.items():
        fields = ("sym_bands", "perm", "iperm") if CASES[case][0] == "banded" else ("diag",)
        for name in fields + ("border_loc", "row_idx", "q", "mask"):
            arrays[f"{case}/{name}"] = np.asarray(getattr(kkt, name))
        arrays[f"{case}/assembly"] = np.array(kkt.assembly)
        arrays[f"{case}/rhs_blocks"] = np.asarray(rhs.blocks)
        arrays[f"{case}/rhs_coupling"] = np.asarray(rhs.coupling)
    np.savez(workdir / "inputs.npz", **arrays)
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    launches = {}
    for P in WORLDS:
        rundir = workdir / f"P{P}"
        rundir.mkdir()
        (rundir / "inputs.npz").symlink_to(workdir / "inputs.npz")
        launches[P] = (rundir, _launch(P, rundir))
    try:
        yield kkts, launches, deadline
    finally:
        for _, procs in launches.values():
            _kill(procs)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda P: f"P{P}")
def sharded(request, inputs):
    """(P, per-rank results, the JAX references (twice: the random systems'
    are among the shared ones since they are computed once))."""
    P = request.param
    kkts, launches, deadline = inputs
    rundir, procs = launches[P]
    try:
        if not _SHARED:
            _SHARED.update(_jax_shared(kkts))
    finally:
        _wait(procs, rundir, deadline)
    ranks = [dict(np.load(rundir / f"rank{r}.npz")) for r in range(P)]
    return P, ranks, _SHARED, _SHARED


def _close(a, b, tol, rel=False):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max())) if rel else 1.0
    d = float(np.abs(a - b).max()) / scale
    assert d <= tol, (d, tol)
    return d


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("system", RANDOM_SYSTEMS, ids=lambda s: "-".join(map(str, s)))
def test_random_system_matches_jax(sharded, system):
    P, ranks, refs, _ = sharded
    key = f"random{system[0]}"
    out = ranks[0]
    _close(out[key + "/xb"], refs[key + "/xb"], 1e-12)
    _close(out[key + "/xc"], refs[key + "/xc"], 1e-12)
    np.testing.assert_array_equal(out[key + "/inertia"], refs[key + "/inertia"])
    assert int(out[key + "/status"]) == refs[key + "/status"] == 0


def test_ld_mode_adaptive_refinement(sharded):
    out = sharded[1][0]
    assert out["ld/kept"].all()
    assert float(out["ld/err"]) < 1e-8, float(out["ld/err"])


@pytest.mark.parametrize("helper", ["assemble", "tiles", "border_apply", "border_T_apply"])
def test_chain_helpers_with_group_offset(helper):
    """Each rank's contiguous chunk placed with its offset, summed over the
    chunks: equal to the JAX package's helper on the same chunks and to the
    whole batch (tests/test_sc_assembly.py::test_chain_with_group_offset)."""
    import jax.numpy as jnp
    from parapint_tpu.linalg import schur as jschur

    from parapint_tpu_torch.linalg import schur

    rng = np.random.default_rng(1)
    N, ns, nk = 6, 2, 5
    nc = ns * (N - 1)
    S = rng.standard_normal((N, 2 * ns, 2 * ns))
    S = S + S.transpose(0, 2, 1)
    S[0, :ns, :] = S[0, :, :ns] = 0.0
    S[N - 1, ns:, :] = S[N - 1, :, ns:] = 0.0
    border = rng.standard_normal((N, 2 * ns, nk))
    border[0, :ns] = 0.0
    border[N - 1, ns:] = 0.0
    v = rng.standard_normal((N, nk))
    y = rng.standard_normal(nc)
    row_idx = np.zeros((N, 2 * ns), dtype=np.int64)
    for b in range(N):
        row_idx[b, :ns] = (b - 1) * ns + np.arange(ns) if b else nc
        row_idx[b, ns:] = b * ns + np.arange(ns) if b < N - 1 else nc
    t = torch.as_tensor
    j = jnp.asarray

    def both(lo, hi):
        off = lo
        if helper == "assemble":
            return (schur._assemble_sc(t(S[lo:hi]), t(row_idx[lo:hi]), nc, "chain", off).numpy(),
                    np.asarray(jschur._assemble_sc(j(S[lo:hi]), j(row_idx[lo:hi]), nc, "chain", off)))
        if helper == "tiles":
            return (np.concatenate([a.numpy() for a in schur._chain_tiles(t(S[lo:hi]), nc, off)]),
                    np.concatenate([np.asarray(a) for a in jschur._chain_tiles(j(S[lo:hi]), nc, off)]))
        if helper == "border_apply":
            return (schur._border_apply_chain(t(border[lo:hi]), t(v[lo:hi]), nc, off).numpy(),
                    np.asarray(jschur._border_apply_chain(j(border[lo:hi]), j(v[lo:hi]), nc, off)))
        return (schur._border_T_apply_chain(t(border[lo:hi]), t(y), off).numpy(),
                np.asarray(jschur._border_T_apply_chain(j(border[lo:hi]), j(y), off)))

    whole, _ = both(0, N)
    chunks = [both(lo, lo + 2) for lo in range(0, N, 2)]
    for port, ref in chunks:
        _close(port, ref, 1e-12)
    if helper == "border_T_apply":
        parts = np.concatenate([c[0] for c in chunks])
    else:
        parts = sum(c[0] for c in chunks)
    _close(parts, whole, 1e-12)


@pytest.mark.parametrize("case", CASES)
def test_first_kkt_matches_jax(sharded, case):
    P, ranks, _, refs = sharded
    key = f"kkt/{case}"
    out = ranks[0]
    _close(out[key + "/xb"], refs[key + "/xb"], 1e-11)
    _close(out[key + "/xc"], refs[key + "/xc"], 1e-11)
    np.testing.assert_array_equal(out[key + "/inertia"], refs[key + "/inertia"])
    assert int(out[key + "/status"]) == refs[key + "/status"] == 0


@pytest.mark.parametrize("case", CASES)
def test_fused_solve_matches_jax(sharded, case):
    P, ranks, _, shared = sharded
    status, iters, obj = ranks[0][f"fused/{case}/result"]
    j_status, j_iters, j_obj = shared[CASES[case][1]]
    print(f"{case} on {P} ranks: iterations {int(iters)} (JAX {j_iters}), objective {obj!r} "
          f"(JAX {j_obj!r})")
    assert int(status) == j_status == 0
    assert abs(int(iters) - j_iters) <= 1
    assert abs(obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))


def test_ownership_map_matches_jax(sharded):
    P, ranks, _, shared = sharded
    out = ranks[0]
    status, iters, obj = out["qp/result"]
    j_status, j_iters, j_obj = shared["qp"]
    print(f"QP with ownership {OWNERSHIP[P]} on {P} ranks: iterations {int(iters)} "
          f"(JAX {j_iters}), objective {obj!r} (JAX {j_obj!r})")
    assert int(status) == j_status == 0
    assert abs(int(iters) - j_iters) <= 1
    assert abs(obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    _close(out["qp/block_primals"], shared["qp/block_primals"], 1e-6, rel=True)
    # storage order is by rank; the accessors answer in original order
    perm = np.argsort(OWNERSHIP[P], kind="stable")
    np.testing.assert_array_equal(out["qp/block_perm"], perm)
    np.testing.assert_array_equal(out["qp/primals"], out["qp/block_primals"])
    np.testing.assert_array_equal(out["qp/primals"][perm], out["qp/raw"])
    np.testing.assert_array_equal(out["qp/lam"][perm], out["qp/raw_lam"])


def test_ownership_map_validation(sharded):
    assert sharded[1][0]["qp/validation"].all()


def test_psc_matches_jax(sharded):
    P, ranks, _, refs = sharded
    status, max_err = ranks[0]["psc"]
    j_status, j_max_err = refs["psc"]
    assert int(status) == int(j_status) == 0
    assert abs(max_err - j_max_err) <= 1e-10 * abs(j_max_err), (max_err, j_max_err)


def test_psc_on_a_sub_mesh(sharded):
    """3 blocks: the largest rank count dividing them forms psc's mesh; its
    members agree with the serial method, the other ranks return None."""
    P, ranks = sharded[:2]
    members = max(d for d in range(1, P + 1) if PSC_SUBMESH["n_blocks"] % d == 0)
    for r, out in enumerate(ranks):
        member, max_err, ssc = out["rank/psc_submesh"]
        assert bool(member) == (r < members), (r, members)
        if member:
            assert abs(max_err - ssc) <= 1e-10 * abs(ssc), (max_err, ssc)


@pytest.mark.parametrize("solver", ["pcg", "csc"])
def test_mesh_solver_matches_jax(sharded, solver):
    P, ranks, _, refs = sharded
    out = ranks[0]
    _close(out[solver + "/xb"], refs[solver + "/xb"], 1e-9, rel=True)
    _close(out[solver + "/xc"], refs[solver + "/xc"], 1e-9, rel=True)
    if solver == "pcg":
        np.testing.assert_array_equal(out["pcg/inertia"], refs["pcg/inertia"])
        assert int(out["pcg/status"]) == refs["pcg/status"] == 0


def test_ranks_agree_bit_for_bit(sharded):
    """Every result but the per-rank ones ("rank/...") is bitwise equal on
    all ranks."""
    ranks = sharded[1]
    for r, other in enumerate(ranks[1:], start=1):
        assert other.keys() == ranks[0].keys()
        for key, a in ranks[0].items():
            if not key.startswith("rank/"):
                assert np.array_equal(a, other[key]), f"rank {r} differs at {key}"


def _result(out, key):
    status, iters, obj = out[key + "/result"]
    return int(status), int(iters), float(obj)


def _own_blocks_only(ranks, key, N):
    """Invariant (b): every model call of rank r ran on its own blocks, the
    range of BlockAxis.local_range: ceil(N/P) blocks, fewer on the last."""
    P = len(ranks)
    n_local = -(-N // P)
    for r, out in enumerate(ranks):
        lo, hi = r * n_local, min((r + 1) * n_local, N)
        np.testing.assert_array_equal(out[f"rank/{key}/range"], [lo, hi])
        np.testing.assert_array_equal(out[f"rank/{key}/blocks"], [hi - lo])


@pytest.mark.parametrize("case", CASES)
def test_mesh_interface_matches_jax(sharded, case):
    """An interface with mesh=: the JAX sharded run's status, iterations
    (within 1) and objective (1e-6), the same rank's replicated-iterate run
    within MESH_ATOL at equal iterations, and each rank's
    model evaluated on its own blocks only."""
    P, ranks, _, shared = sharded
    out = ranks[0]
    status, iters, obj = _result(out, f"mesh/{case}")
    j_status, j_iters, j_obj = shared[CASES[case][1]]
    r_status, r_iters, _ = _result(out, f"fused/{case}")
    print(f"mesh= {case} on {P} ranks: iterations {iters} (JAX {j_iters}, replicated {r_iters}), "
          f"objective {obj!r} (JAX {j_obj!r})")
    assert status == j_status == r_status == 0
    assert abs(iters - j_iters) <= 1 and iters == r_iters
    assert abs(obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    _close(out[f"mesh/{case}/x"], out[f"fused/{case}/x"], MESH_ATOL)
    _close(out[f"mesh/{case}/c"], out[f"fused/{case}/c"], MESH_ATOL)
    _own_blocks_only(ranks, f"mesh/{case}", CASES[case][1])


def test_restored_arguments_on_the_sharded_solvers(sharded):
    """The sharded solvers built with the restored arguments carry them, as
    their serial twins do, and compute what the twins compute: on the
    planted-pivot system ``zero_tol=1e-10`` counts one zero pivot (inertia
    and status equal to the serial solver's, which tests/test_torch_schur.py
    holds to the JAX package's); on the 8-block banded first KKT
    ``refine_steps=2`` runs two passes and ``tile_block_size=128`` one panel
    per tile, the solution within 1e-11 of the serial one."""
    out = sharded[1][0]
    for kind in ("serial", "sharded"):
        np.testing.assert_array_equal(out[f"args/dense/{kind}/kept"], [1e-10, 1e-10, 1e-3, 2])
        assert int(out[f"args/banded/{kind}/passes"]) == 2
        assert int(out[f"args/banded/{kind}/status"]) == 0
    np.testing.assert_array_equal(out["args/dense/sharded/inertia"], out["args/dense/serial/inertia"])
    assert out["args/dense/sharded/inertia"][2] == 1
    assert int(out["args/dense/sharded/status"]) == int(out["args/dense/serial/status"]) == 2
    np.testing.assert_array_equal(out["args/banded/sharded/inertia"], out["args/banded/serial/inertia"])
    _close(out["args/banded/sharded/xb"], out["args/banded/serial/xb"], 1e-11)
    _close(out["args/banded/sharded/xc"], out["args/banded/serial/xc"], 1e-11)


def test_examples_main_with_a_mesh(sharded):
    """``burgers.main``, ``dynamics.main`` and the farmer's ``main`` with
    mesh= (their interfaces built with it, their default serial solvers
    gathering the rank-local KKT): Burgers equal to its replicated run
    within MESH_ATOL, dynamics' p(t) and the farmer's acreage at the
    reference's golden values on every rank of the 3-rank mesh (block_mesh's
    ``devices=`` in reverse order, the ranks in the order the JAX
    package's ``block_mesh(devices=...)`` keeps its devices)."""
    import jax

    from parapint_tpu.parallel.mesh import block_mesh as j_block_mesh

    P, ranks, _, _ = sharded
    _jax_mesh(2)
    jm = j_block_mesh(devices=jax.devices()[:2][::-1])
    for out in ranks:
        np.testing.assert_array_equal(out["mesh3/ranks"], [d.id for d in jm.devices.flat])
        _close(out["main/burgers/mesh"], out["main/burgers/serial"], MESH_ATOL)
    for out in ranks[3:]:
        assert out["rank/main/dynamics_p"].size == out["rank/main/farmer"].size == 0
    for out in ranks[:3]:
        np.testing.assert_allclose(out["rank/main/dynamics_p"][:9], DYNAMICS_GOLDEN_P, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["rank/main/farmer"], FARMER_ACRES, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["ip_solve", "pcg", "two_kinds", "qp"])
def test_mesh_interface_other_paths(sharded, case):
    """``ip_solve`` (dense, 8 blocks) and PCG with a mesh on a mesh=
    interface against the same rank's replicated-iterate run; the flagship
    as two kinds (``HeterogeneousDynamicInterface``) and the QP with an
    ownership map against the port's serial solve (original scenario
    order).  Same status and iterations, objective within 1e-6 of the JAX
    reference, the primals within MESH_ATOL (replicated) or SERIAL_RTOL
    (serial), each rank's model on its own blocks only."""
    P, ranks, _, shared = sharded
    out = ranks[0]
    ref_key = {"ip_solve": "ip_solve", "pcg": "pcg_fused", "two_kinds": "two_kinds_serial",
               "qp": "qp_serial"}[case]
    key = "qp" if case == "qp" else f"mesh/{case}"
    status, iters, obj = _result(out, key)
    r_status, r_iters, r_obj = _result(out, ref_key)
    j_obj = shared["qp"][2] if case == "qp" else shared[8][2]
    print(f"mesh= {case} on {P} ranks: iterations {iters} ({ref_key} {r_iters}), objective "
          f"{obj!r} ({ref_key} {r_obj!r}, JAX {j_obj!r})")
    assert status == r_status == 0 and iters == r_iters
    assert abs(obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    if case == "qp":
        _close(out["qp/block_primals"], out["qp_serial/primals"], SERIAL_RTOL, rel=True)
        _close(out["qp/first_stage"], out["qp_serial/first_stage"], SERIAL_RTOL, rel=True)
        _own_blocks_only(ranks, "qp", QP_SMALL["n_scenarios"])
        return
    tol, rel = (SERIAL_RTOL, True) if case == "two_kinds" else (MESH_ATOL, False)
    _close(out[key + "/x"], out[ref_key + "/x"], tol, rel)
    _close(out[key + "/c"], out[ref_key + "/c"], tol, rel)
    _own_blocks_only(ranks, key, NLPS[8]["num_time_blocks"])


@pytest.mark.parametrize("name", SERIAL_SOLVERS)
def test_mesh_interface_with_a_serial_solver(sharded, name):
    """ROADMAP C11: a mesh= interface hands its rank's part of the KKT, and a
    serial solver gathers it whole on every rank.  The gathered first KKT
    equals the replicated interface's (dtypes, assembly and every entry);
    the solve meets the JAX package's mesh= interface with the same serial
    solver (status, iterations within 1, objective 1e-6) and repeats the
    replicated interface's run (status, iterations, primals within
    MESH_ATOL); each rank's model runs on its own blocks only, and the
    ranks agree bitwise (``test_ranks_agree_bit_for_bit``)."""
    P, ranks, _, shared = sharded
    out = ranks[0]
    key, whole = f"serial/{name}", f"serial_whole/{name}"
    status, iters, obj = _result(out, key)
    w_status, w_iters, w_obj = _result(shared, whole)
    j_status, j_iters, j_obj = shared[key]
    fields = [k[len(whole) + 5:] for k in shared if str(k).startswith(whole + "/kkt/")]
    assert sorted(fields) == sorted(k[len(key) + 5:] for k in out if k.startswith(key + "/kkt/"))
    diff = 0.0
    for f in fields:
        a, b = out[f"{key}/kkt/{f}"], shared[f"{whole}/kkt/{f}"]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind in "fi":
            diff = max(diff, float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()))
        else:
            assert a == b, (f, a, b)
    print(f"serial {name} on a mesh= interface, {P} ranks: iterations {iters} (replicated "
          f"{w_iters}, JAX {j_iters}), objective {obj!r} (replicated {w_obj!r}, JAX {j_obj!r}), "
          f"gathered first KKT vs replicated: largest difference {diff}")
    assert diff == 0.0, f"gathered KKT differs from the replicated one by {diff}"
    assert status == w_status == j_status == 0
    assert iters == w_iters and abs(iters - j_iters) <= 1
    assert abs(obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    _close(out[key + "/x"], shared[whole + "/x"], MESH_ATOL)
    _close(out[key + "/c"], shared[whole + "/c"], MESH_ATOL)
    _own_blocks_only(ranks, key, NLPS[8]["num_time_blocks"])


@pytest.mark.parametrize("form", ["dense", "banded"])
def test_serial_and_sharded_step_on_a_mesh_kkt(sharded, form):
    """One numeric and one solve of the same mesh= KKT (float64) through the
    serial and the sharded solver: equal status and inertia, solutions
    within 1e-11 (tests/test_banded.py::test_numeric_solve_parity_with_serial)."""
    out = sharded[1][0]
    s, h = f"step/{form}/serial", f"step/{form}/sharded"
    assert int(out[s + "/status"]) == int(out[h + "/status"]) == 0
    np.testing.assert_array_equal(out[s + "/inertia"], out[h + "/inertia"])
    _close(out[s + "/xb"], out[h + "/xb"], 1e-11)
    _close(out[s + "/xc"], out[h + "/xc"], 1e-11)


def test_ownership_accessors_match_jax(sharded):
    """The QP with ``OWNERSHIP[P]`` on a mesh: one seeded state (in storage
    order) put into the port's interface on each rank and into the JAX
    package's on P devices; every accessor bitwise equal, and the order
    checks of tests/test_warmstart_ownership.py (per-scenario accessors in
    ORIGINAL order, the raw state permuted)."""
    import jax
    import jax.numpy as jnp
    import parapint_tpu as pt
    from parapint_tpu.interfaces.base import IPState

    import bench_all
    import chip_smoke

    from parapint_tpu_torch.interfaces.base import STATE_FIELDS

    P, ranks = sharded[:2]
    out = ranks[0]
    ji = pt.StochasticSchurComplementInteriorPointInterface(
        bench_all.stochastic_qp(**QP_SMALL).spec, mesh=_jax_mesh(P), kkt_dtype=jnp.float32,
        ownership_map=OWNERSHIP[P])
    tree = seeded_state(ji, seed=5)
    ji._current_state = IPState(**{f: jax.tree_util.tree_map(jnp.asarray, tree[f])
                                   for f in STATE_FIELDS})
    ref = chip_smoke.results(ji)
    assert {k[4:] for k in out if k.startswith("acc/get_") or k.startswith("acc/n_")} == set(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(out["acc/" + name], np.asarray(v), err_msg=name)
    perm = np.argsort(OWNERSHIP[P], kind="stable")
    n_sc = QP_SMALL["n_scenarios"]
    prim = out["acc/get_primals/blocks"]
    for ndx in range(n_sc):
        np.testing.assert_array_equal(prim[ndx], out[f"acc/get_block_primals/{ndx}"])
    np.testing.assert_array_equal(out["acc/get_duals_eq/link"],
                                  out["acc/get_duals_nonanticipativity"])
    np.testing.assert_array_equal(prim[perm], out["acc/raw_blocks"])
    np.testing.assert_array_equal(out["acc/get_duals_ineq"][perm], out["acc/raw_ineq"])
    np.testing.assert_array_equal(out["acc/get_duals_primals_lb/blocks"][perm], out["acc/raw_lb"])
    assert out["acc/get_slacks"].shape == (n_sc, 0)
    assert out["acc/get_duals_primals_lb/blocks"].shape == (n_sc, QP_SMALL["n"])


@pytest.mark.cuda
def test_world_size_one_nccl_matches_serial():
    """One NCCL rank on the card: the sharded dense solver through the fused
    driver repeats the serial solver's iterations and objective (1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers
    from parapint_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        results = []
        for sharded in (False, True):
            iface = ptt.DynamicSchurComplementInteriorPointInterface(
                burgers.build_spec(**NLPS[8]), kkt_dtype=torch.float32
            )
            opts = ptt.IPOptions()
            opts.tol = TOL
            kw = dict(block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
                      schur_complement_solver=ptt.BlockTridiagSolver())
            opts.linalg.solver = (
                ptt.ShardedSchurComplementSolver(distributed.global_mesh(), "blocks", **kw)
                if sharded else ptt.SchurComplementSolver(**kw)
            )
            status, res = ptt.ip_solve_fused(iface, opts)
            results.append((status, res.iterations, float(iface.evaluate_objective())))
    finally:
        distributed.shutdown()
    (s0, n0, o0), (s1, n1, o1) = results
    assert s0 == s1 == ptt.InteriorPointStatus.optimal
    assert n0 == n1
    assert abs(o0 - o1) <= 1e-12 * max(1.0, abs(o0))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
