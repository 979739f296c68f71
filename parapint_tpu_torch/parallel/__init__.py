"""Multi-process execution over ``torch.distributed``: process start-up
(:mod:`.distributed`) and the 1-D block mesh with its collectives
(:mod:`.mesh`)."""

from parapint_tpu_torch.parallel.mesh import BlockAxis, block_mesh, largest_divisor_mesh

__all__ = ["BlockAxis", "block_mesh", "largest_divisor_mesh"]
