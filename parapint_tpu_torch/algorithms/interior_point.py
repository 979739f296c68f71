"""Interior-point status vocabulary and the precision check (the subset of
``parapint_tpu.algorithms.interior_point`` that the fused solve uses)."""

import enum
import warnings


class InteriorPointStatus(enum.Enum):
    optimal = 0
    error = 1


def check_precision_compat(interface, solver) -> None:
    """Warn when a reduced-precision interface feeds a higher-precision
    factorization: ``kkt_dtype`` rounds the KKT at assembly, so a solver
    factoring in a wider ``factor_dtype`` (the hybrid path exists for exact
    pivot signs) computes its pivots from already-rounded data and cannot
    keep its inertia promise.  f32 matrix with f32 factor is unaffected."""
    kd = getattr(interface, "kkt_dtype", None)
    fd = getattr(solver, "factor_dtype", None)
    if kd is None or fd is None:
        return
    if fd.itemsize > kd.itemsize:
        warnings.warn(
            f"interface kkt_dtype={kd} assembles the KKT in reduced precision, "
            f"but the solver factors in {fd}: pivot signs/inertia are computed "
            "from already-rounded data, defeating the hybrid-precision "
            "factorization's guarantee. Use kkt_dtype=None with "
            "factor_dtype=torch.float64 (hybrid), or factor_dtype=torch.float32.",
            stacklevel=3,
        )
