"""The block mesh and its collectives (counterpart of
``parapint_tpu.parallel.mesh``).

The framework's one parallel axis is the block axis (time blocks or
scenarios).  A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
named ``("blocks",)`` over ranks of the default process group, PyTorch's
own counterpart of ``jax.sharding.Mesh``.  The sharded solvers read the
axis through :class:`BlockAxis`: rank r of P owns the contiguous blocks
[r N/P, (r + 1) N/P) of a block count N padded to a multiple of P, and
``jax.lax.psum`` / ``pmax`` become :func:`all_reduce_sum` /
:func:`all_reduce_max` over the axis's process group.
"""

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def block_mesh(n_devices: Optional[int] = None, axis_name: str = "blocks"):
    """A 1-D mesh over the first ``n_devices`` ranks (default: all) of the
    default process group.  Every rank must call it (a sub-mesh creates a
    process group); a rank outside the mesh gets one whose
    ``get_coordinate()`` is None.  The mesh's device type only labels it:
    collectives run on the default group's backend, and gloo reduces CPU
    and CUDA tensors alike."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n_devices} outside [1, {world}]")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def largest_divisor_mesh(n_blocks: int, axis_name: str = "blocks"):
    """The mesh over the largest number of leading ranks that divides
    ``n_blocks`` (the reference harness's choice of rank count; the sharded
    solvers themselves pad any block count)."""
    n = dist.get_world_size()
    while n > 1 and n_blocks % n != 0:
        n -= 1
    return block_mesh(n, axis_name)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``t`` over the group's ranks, as a new
    tensor (``t`` itself when ``group`` is None: the serial path)."""
    if group is None:
        return t
    out = t.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.pmax`` over the group's ranks (``t`` when ``group`` is None)."""
    if group is None:
        return t
    out = t.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class BlockAxis:
    """One rank's view of a mesh axis: its process group, its index along
    the axis and the axis size."""

    group: object
    index: int
    size: int

    @staticmethod
    def of(mesh, axis_name: str = "blocks") -> "BlockAxis":
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not part of the mesh")
        dim = mesh.mesh_dim_names.index(axis_name)
        return BlockAxis(
            group=mesh.get_group(axis_name),
            index=mesh.get_local_rank(axis_name),
            size=mesh.shape[dim],
        )

    def local_range(self, n_blocks: int):
        """(lo, hi) of this rank's blocks; ``n_blocks`` is a multiple of the
        axis size."""
        n_local = n_blocks // self.size
        return self.index * n_local, (self.index + 1) * n_local

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(t, self.group)

    def local_rows(self, full: torch.Tensor, n_blocks: int) -> torch.Tensor:
        """This rank's rows of ``full`` (N, ...) zero-padded to ``n_blocks``
        rows (a multiple of the axis size)."""
        if full.shape[0] != n_blocks:
            pad = full.new_zeros((n_blocks - full.shape[0], *full.shape[1:]))
            full = torch.cat([full, pad])
        lo, hi = self.local_range(n_blocks)
        return full[lo:hi]

    def gather_blocks(self, local: torch.Tensor, n_blocks: int) -> torch.Tensor:
        """The (n_blocks, ...) tensor of every rank's block rows, replicated:
        each rank fills its own rows of a zero tensor and the ranks sum them,
        which is exact and runs on every backend."""
        lo, hi = self.local_range(n_blocks)
        full = local.new_zeros((n_blocks, *local.shape[1:]))
        full[lo:hi] = local
        return self.sum(full)
