"""The single-NLP model protocol and its AD."""

from parapint_tpu_torch.models.ad import NLPFunctions
from parapint_tpu_torch.models.model import NLPModel

__all__ = ["NLPModel", "NLPFunctions"]
