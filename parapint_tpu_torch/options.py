"""Typed option containers for the interior-point algorithm.

Field names and defaults mirror the reference's Pyomo ``ConfigDict`` options
(``IPOptions`` and sub-configs, parapint/algorithms/interior_point.py:32-171)
so user code ports one-to-one, but are plain mutable dataclasses — no Pyomo.
Same fields and defaults as ``parapint_tpu.options``.
"""

from dataclasses import dataclass, field
from typing import Optional


def _check_positive(name: str, val: float) -> None:
    if not val > 0:
        raise ValueError(f"{name} must be positive, got {val!r}")


def _check_nonnegative(name: str, val: float) -> None:
    if not val >= 0:
        raise ValueError(f"{name} must be non-negative, got {val!r}")


@dataclass
class InertiaCorrectionOptions:
    """Inertia-correction schedule (reference interior_point.py:32-60)."""

    init_coef: float = 1e-8
    factor_increase: float = 10.0
    factor_decrease: float = 1.0 / 3.0
    max_coef: float = 1e9

    def validate(self) -> None:
        _check_positive("inertia_correction.init_coef", self.init_coef)
        _check_positive("inertia_correction.factor_increase", self.factor_increase)
        _check_positive("inertia_correction.factor_decrease", self.factor_decrease)
        _check_positive("inertia_correction.max_coef", self.max_coef)


@dataclass
class LinalgOptions:
    """Linear-algebra options (reference interior_point.py:63-88).

    ``solver`` holds a :class:`parapint_tpu_torch.linalg.LinearSolver`.  The
    reference's memory-reallocation retry (``reallocation_factor``,
    ``max_num_reallocations``) is kept for ``ip_solve``; the port's solvers
    allocate per call and never report ``not_enough_memory``.
    ``max_num_reallocations`` counts factorization attempts, so it must be
    at least 1 (``parapint_tpu`` accepts 0 here and fails at the first
    factorization).
    """

    solver: Optional[object] = None
    reallocation_factor: float = 2.0
    max_num_reallocations: int = 5

    def validate(self) -> None:
        _check_positive("linalg.reallocation_factor", self.reallocation_factor)
        if not self.max_num_reallocations >= 1:
            raise ValueError(
                f"linalg.max_num_reallocations must be at least 1, got {self.max_num_reallocations!r}"
            )


@dataclass
class LineSearchOptions:
    """Line-search options (reference interior_point.py:91-115).

    The reference ships a placeholder line search that is disabled by default
    (its ``line_search`` raises NotImplementedError, interior_point.py:320-334).
    Disabled, the step is the full fraction-to-the-boundary step (alpha=1), as
    in the reference.  Enabled, the fused solve runs an IPOPT-style filter
    line search (beyond-reference, ``algorithms/fused.py``): it tries
    alpha = 1, 1/2, 1/4, ... (``max_iter`` trials) until the trial point's
    (infeasibility, barrier objective) pair is acceptable to the filter and
    to the current iterate; ``step_anyway`` takes the full step when no
    trial is, else the iteration fails.
    """

    max_iter: int = 4
    disable: bool = True
    step_anyway: bool = True

    def validate(self) -> None:
        _check_nonnegative("line_search.max_iter", self.max_iter)


@dataclass
class IPOptions:
    """Options for :func:`parapint_tpu_torch.algorithms.ip_solve` and
    :func:`parapint_tpu_torch.algorithms.ip_solve_fused`.

    Mirrors the reference defaults exactly (interior_point.py:159-171).
    ``report_timing`` and ``unified_step`` are read by ``ip_solve`` only.
    """

    max_iter: int = 1000
    tol: float = 1e-8
    init_barrier_parameter: float = 0.1
    minimum_barrier_parameter: float = 1e-9
    barrier_decrease: float = 10.0
    # "monotone": the reference's Fiacco-McCormick rule
    #   mu <- max(mu_min, min(0.5 mu, mu^1.5)) gated on the mu-convergence
    #   test (reference interior_point.py:520-528).
    # "adaptive": LOQO/Vanderbei-Shanno centrality rule (beyond-reference,
    #   cf. IPOPT's mu_strategy=adaptive):
    #   xi = min_i(w_i)/avg(w_i) over the complementarity products w_i,
    #   sigma = 0.1 min(0.05 (1-xi)/xi, 2)^3, mu = sigma * avg(w_i),
    #   clamped to [minimum_barrier_parameter, init_barrier_parameter].
    #   Typically converges in fewer iterations; falls back to monotone
    #   when the problem has no finite bounds.
    barrier_strategy: str = "monotone"
    report_timing: bool = False
    use_inertia_correction: bool = True
    inertia_correction: InertiaCorrectionOptions = field(default_factory=InertiaCorrectionOptions)
    linalg: LinalgOptions = field(default_factory=LinalgOptions)
    line_search: LineSearchOptions = field(default_factory=LineSearchOptions)
    unified_step: bool = False
    error_scaling: float = 100.0
    bounds_relaxation_factor: float = 1e-8

    def validate(self) -> None:
        _check_nonnegative("max_iter", self.max_iter)
        _check_positive("tol", self.tol)
        _check_positive("init_barrier_parameter", self.init_barrier_parameter)
        _check_positive("minimum_barrier_parameter", self.minimum_barrier_parameter)
        _check_positive("barrier_decrease", self.barrier_decrease)
        if self.barrier_strategy not in ("monotone", "adaptive"):
            raise ValueError(
                "barrier_strategy must be 'monotone' or 'adaptive', "
                f"got {self.barrier_strategy!r}"
            )
        _check_positive("error_scaling", self.error_scaling)
        _check_nonnegative("bounds_relaxation_factor", self.bounds_relaxation_factor)
        self.inertia_correction.validate()
        self.linalg.validate()
        self.line_search.validate()
