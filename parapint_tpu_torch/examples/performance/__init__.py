"""Performance harnesses (counterpart of
``parapint_tpu.examples.performance``)."""

from parapint_tpu_torch.examples.performance import schur_complement

__all__ = ["schur_complement"]
