"""Reference-name compatibility layer (counterpart of ``parapint_tpu.compat``).

``import parapint_tpu_torch.compat as parapint`` gives user code the
reference parapint's public names mapped onto this package's classes, so
that solver and algorithm call sites carry over:

    import parapint_tpu_torch.compat as parapint
    options = parapint.algorithms.IPOptions()
    options.linalg.solver = parapint.linalg.ScipyInterface(compute_inertia=True)
    status = parapint.algorithms.ip_solve(interface, options)

Model construction differs (torch functions instead of Pyomo models: see
``DynamicModelSpec``, ``StochasticModelSpec``, ``NLPModel``).  Parallelism
is a ``mesh=`` argument (a ``DeviceMesh`` over ``torch.distributed``
ranks), not a class: the ``MPI*Interface`` names are the interfaces, and
``MPISchurComplementLinearSolver`` is the sharded solver.
"""

import logging
import types
import warnings

import parapint_tpu_torch as _ptt
from parapint_tpu_torch.interfaces.base import BaseInteriorPointInterface as _BaseInterface
from parapint_tpu_torch.linalg import (
    DenseLDLSolver as _DenseLDLSolver,
    DenseLUSolver as _DenseLUSolver,
    SchurComplementSolver as _SchurComplementSolver,
    ShardedSchurComplementSolver as _ShardedSchurComplementSolver,
)


class ScipyInterface(_DenseLUSolver):
    """Reference ``parapint.linalg.ScipyInterface``: LU with optional
    dense-eigenvalue inertia."""

    def __init__(self, compute_inertia: bool = False):
        super().__init__(compute_inertia=compute_inertia)


def _warn_unmapped(name, kind, keys):
    if keys:
        warnings.warn(
            f"{name}: {kind} options {sorted(keys)} have no equivalent on the dense "
            "factorization and are ignored; see DenseLDLSolver for the available knobs",
            stacklevel=3,
        )


class InteriorPointMA27Interface(_DenseLDLSolver):
    """Reference ``parapint.linalg.InteriorPointMA27Interface``: symmetric
    indefinite factorization with inertia.

    - ``cntl_options[1]`` (the pivot threshold u): the unpivoted
      equilibrated factorization has no pivot order to steer; its stability
      comes from equilibration and iterative refinement.  The value is
      recorded (``get_cntl``) and any u > 0 keeps a refinement pass.
    - ``icntl_options`` (workspace and printing controls): recorded, no
      effect (the factorization allocates per call).
    - ``iw_factor`` / ``a_factor`` (memory growth factors): accepted, no
      effect.
    """

    def __init__(self, cntl_options=None, icntl_options=None, iw_factor=None, a_factor=None,
                 **kwargs):
        self._cntl = dict(cntl_options or {})
        self._icntl = dict(icntl_options or {})
        if self._cntl.get(1, 0.0) and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = 1  # keep the stability pass
        _warn_unmapped("InteriorPointMA27Interface", "cntl", set(self._cntl) - {1})
        super().__init__(**kwargs)

    def set_cntl(self, key, value):
        self._cntl[key] = value

    def get_cntl(self, key):
        return self._cntl[key]

    def set_icntl(self, key, value):
        self._icntl[key] = value

    def get_icntl(self, key):
        return self._icntl[key]


class MumpsInterface(_DenseLDLSolver):
    """Reference ``parapint.linalg.MumpsInterface``.

    - ``icntl_options[10]`` (iterative refinement steps) -> ``refine_steps``.
    - ``icntl_options[11]`` (error analysis level) -> one diagnostics row
      per solve (Status, n_null, n_neg, ||A||, ||x||, Max resid, Rel resid),
      the residual computed directly.
    - ``icntl_options[13]`` / ``[24]`` validated as the reference does (must
      be positive / must be 0); ``[14]`` / ``[23]`` (memory) recorded.
    - ``cntl_options[3]`` (null-pivot threshold) -> ``zero_tol``;
      ``cntl_options[1]`` (pivot threshold) recorded, any u > 0 keeps a
      refinement pass.
    """

    def __init__(self, par=1, comm=None, cntl_options=None, icntl_options=None, **kwargs):
        self._cntl = dict(cntl_options or {})
        self._icntl = dict(icntl_options or {})
        for key, value in self._icntl.items():
            self.set_icntl(key, value)
        if 10 in self._icntl and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = max(0, int(self._icntl[10]))
        if 3 in self._cntl and "zero_tol" not in kwargs:
            kwargs["zero_tol"] = float(self._cntl[3])
        if self._cntl.get(1, 0.0) and "refine_steps" not in kwargs:
            kwargs["refine_steps"] = 1
        self.error_level = int(self._icntl.get(11, 0))
        self.log_error = bool(self.error_level)
        _warn_unmapped("MumpsInterface", "cntl", set(self._cntl) - {1, 2, 3})
        _warn_unmapped("MumpsInterface", "icntl", set(self._icntl) - {10, 11, 13, 14, 23, 24})
        super().__init__(**kwargs)
        self.logger = logging.getLogger("algorithms." + type(self).__name__)
        self._last_kkt = None
        if self.log_error:
            self.log_header()

    def set_icntl(self, key, value, _init=False):
        if key == 13 and value <= 0:
            raise ValueError("ICNTL(13) must be positive for the MumpsInterface.")
        if key == 24 and value != 0:
            raise ValueError("ICNTL(24) must be 0 for the MumpsInterface.")
        self._icntl[key] = value

    def get_icntl(self, key):
        return self._icntl[key]

    def set_cntl(self, key, value):
        self._cntl[key] = value

    def get_cntl(self, key):
        return self._cntl[key]

    def log_header(self, include_error=True):
        fields = ["Status", "n_null", "n_neg"]
        if include_error:
            fields += ["||A||", "||x||", "Max resid", "Rel resid"]
        fmt = "{0:<10}{1:<10}{2:<10}" + "".join("{" + str(i) + ":<15}" for i in range(3, len(fields)))
        self.logger.info(fmt.format(*fields))

    def numeric(self, kkt):
        fact = super().numeric(kkt)
        if self.log_error:
            self._last_kkt = kkt
        return fact

    def solve(self, fact, rhs):
        x = super().solve(fact, rhs)
        if self.log_error:
            self.log_info(fact, rhs, x)
        return x

    def log_info(self, fact, rhs, x):
        fields = [int(fact.status), int(fact.inertia[2]), int(fact.inertia[1])]
        fmt = "{0:<10}{1:<10}{2:<10}"
        if self._last_kkt is not None:
            A = self._last_kkt.to(x.dtype)
            r = rhs - A @ x
            norm_a = float(A.abs().max())
            norm_x = float(x.abs().max())
            max_r = float(r.abs().max())
            fields += [norm_a, norm_x, max_r, max_r / max(norm_a * norm_x, 1e-300)]
            fmt += "".join("{" + str(i) + ":<15.3e}" for i in range(3, len(fields)))
        self.logger.info(fmt.format(*fields))


class SchurComplementLinearSolver(_SchurComplementSolver):
    """Reference ``parapint.linalg.SchurComplementLinearSolver``.  The
    reference takes one solver per diagonal block; here one batched
    factorization takes every block, so ``subproblem_solvers`` is accepted
    for the signature and only ``schur_complement_solver`` is used."""

    def __init__(self, subproblem_solvers=None, schur_complement_solver=None, **kwargs):
        super().__init__(schur_complement_solver=schur_complement_solver, **kwargs)


class MPISchurComplementLinearSolver(_ShardedSchurComplementSolver):
    """Reference ``parapint.linalg.MPISchurComplementLinearSolver``.  Takes
    a ``DeviceMesh`` (``parallel.distributed.global_mesh``) instead of the
    implicit ``MPI.COMM_WORLD``."""

    def __init__(self, subproblem_solvers=None, schur_complement_solver=None, mesh=None,
                 axis_name: str = "blocks", **kwargs):
        if mesh is None:
            raise ValueError(
                "MPISchurComplementLinearSolver requires mesh= (the DeviceMesh that takes "
                "the place of the MPI communicator)"
            )
        super().__init__(mesh, axis_name, schur_complement_solver=schur_complement_solver, **kwargs)


# interface aliases: parallelism is a mesh argument, not a class
MPIDynamicSchurComplementInteriorPointInterface = _ptt.DynamicSchurComplementInteriorPointInterface
MPIStochasticSchurComplementInteriorPointInterface = (
    _ptt.StochasticSchurComplementInteriorPointInterface
)

linalg = types.SimpleNamespace(
    LinearSolverInterface=_ptt.LinearSolver,
    LinearSolverResults=_ptt.LinearSolverResults,
    LinearSolverStatus=_ptt.LinearSolverStatus,
    ScipyInterface=ScipyInterface,
    InteriorPointMA27Interface=InteriorPointMA27Interface,
    MumpsInterface=MumpsInterface,
    SchurComplementLinearSolver=SchurComplementLinearSolver,
    MPISchurComplementLinearSolver=MPISchurComplementLinearSolver,
)

interfaces = types.SimpleNamespace(
    BaseInteriorPointInterface=_BaseInterface,
    InteriorPointInterface=_ptt.InteriorPointInterface,
    DynamicSchurComplementInteriorPointInterface=_ptt.DynamicSchurComplementInteriorPointInterface,
    StochasticSchurComplementInteriorPointInterface=_ptt.StochasticSchurComplementInteriorPointInterface,
    MPIDynamicSchurComplementInteriorPointInterface=MPIDynamicSchurComplementInteriorPointInterface,
    MPIStochasticSchurComplementInteriorPointInterface=MPIStochasticSchurComplementInteriorPointInterface,
)

algorithms = types.SimpleNamespace(
    InteriorPointStatus=_ptt.InteriorPointStatus,
    IPOptions=_ptt.IPOptions,
    ip_solve=_ptt.ip_solve,
)
