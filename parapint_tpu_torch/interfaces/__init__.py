"""Interior-point interfaces: function evaluation + KKT assembly (the
single-NLP interface and the dynamic, heterogeneous dynamic and stochastic
Schur-complement interfaces)."""

from parapint_tpu_torch.interfaces.base import Bounds, IPState
from parapint_tpu_torch.interfaces.dynamic import (
    DynamicModelSpec,
    DynamicSchurComplementInteriorPointInterface,
)
from parapint_tpu_torch.interfaces.heterogeneous import (
    HeterogeneousDynamicInterface,
    KindSpec,
)
from parapint_tpu_torch.interfaces.single import InteriorPointInterface
from parapint_tpu_torch.interfaces.stochastic import (
    StochasticModelSpec,
    StochasticSchurComplementInteriorPointInterface,
)

__all__ = [
    "IPState",
    "Bounds",
    "InteriorPointInterface",
    "DynamicModelSpec",
    "DynamicSchurComplementInteriorPointInterface",
    "StochasticModelSpec",
    "StochasticSchurComplementInteriorPointInterface",
    "KindSpec",
    "HeterogeneousDynamicInterface",
]
