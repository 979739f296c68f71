"""Milliseconds per interior-point iteration in AD and KKT assembly
(``interfaces/structured.py``, ``blocked.py``, ``models/ad.py``): the
synchronised host time of every call of the four methods (phase B) over the
iterations."""

METHODS = ("eval_ad", "convergence_from_ad", "kkt_from_ad", "assemble_kkt")
BRACKETS = tuple(("interface", m) for m in METHODS)


def read(data):
    if not data.span_iterations:
        return None
    return 1e3 * sum(data.span_seconds.get(m, 0.0) for m in METHODS) / data.span_iterations
