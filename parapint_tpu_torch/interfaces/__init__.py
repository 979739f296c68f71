"""Interior-point interfaces: function evaluation + KKT assembly."""

from parapint_tpu_torch.interfaces.base import Bounds, IPState
from parapint_tpu_torch.interfaces.dynamic import (
    DynamicModelSpec,
    DynamicSchurComplementInteriorPointInterface,
)

__all__ = [
    "IPState",
    "Bounds",
    "DynamicModelSpec",
    "DynamicSchurComplementInteriorPointInterface",
]
