"""Milliseconds per call of the Schur solver's ``numeric`` (the block
factorizations, the Schur complement and the coupling solver's factor:
``linalg/banded_schur.py`` or ``linalg/schur.py`` with ``linalg/tridiag.py``),
synchronised, phase B."""

BRACKETS = (("solver", "numeric"),)


def read(data):
    calls = data.span_calls.get("numeric", 0)
    return 1e3 * data.span_seconds["numeric"] / calls if calls else None
