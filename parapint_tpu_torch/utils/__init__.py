"""Utilities: the hierarchical phase timer and solver checkpoints."""

from parapint_tpu_torch.utils.timer import HierarchicalTimer

__all__ = ["HierarchicalTimer"]
