"""Interior-point status vocabulary (the subset of
``parapint_tpu.algorithms.interior_point`` that the fused solve uses)."""

import enum


class InteriorPointStatus(enum.Enum):
    optimal = 0
    error = 1
