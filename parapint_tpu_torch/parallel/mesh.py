"""The block mesh and its collectives (counterpart of
``parapint_tpu.parallel.mesh``).

The framework's one parallel axis is the block axis (time blocks or
scenarios).  A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
named ``("blocks",)`` over ranks of the default process group, PyTorch's
own counterpart of ``jax.sharding.Mesh``.  The sharded solvers and the
structured interfaces with ``mesh=`` read the axis through
:class:`BlockAxis`: rank r of P owns the contiguous blocks of
:meth:`BlockAxis.local_range`, ceil(N/P) of a block count N padded to a
multiple of P, and ``jax.lax.psum`` / ``pmax`` become
:func:`all_reduce_sum` / :func:`all_reduce_max` over the axis's process
group.
"""

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def block_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "blocks",
    devices: Optional[Sequence[int]] = None,
):
    """A 1-D mesh over the first ``n_devices`` (default: all) of
    ``devices``, the ranks of the default process group in mesh order
    (default: every rank, in rank order).  Every rank must call it (a
    sub-mesh creates a process group); a rank outside the mesh gets one
    whose ``get_coordinate()`` is None.  The mesh's device type only labels
    it: collectives run on the default group's backend, and gloo reduces
    CPU and CUDA tensors alike."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"devices {devices} are not distinct ranks in [0, {world})")
    n = len(ranks) if n_devices is None else n_devices
    if not 1 <= n <= len(ranks):
        raise ValueError(f"n_devices {n_devices} outside [1, {len(ranks)}]")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks[:n], mesh_dim_names=(axis_name,))


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
        """(lo, hi) of this rank's blocks in ``n_blocks`` padded to a multiple
        of the axis size (``pad_block_count``): ceil(N/P) blocks per rank.
        The sharded solvers and an interface with a mesh share this range;
        on the last ranks it may reach past N (their padding)."""
        n_local = -(-n_blocks // self.size)
        return self.index * n_local, (self.index + 1) * n_local

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(t, self.group)

    def local_rows(self, blocks: torch.Tensor, n_blocks: int, rank_local: bool = False) -> torch.Tensor:
        """This rank's rows of a block tensor, zero-padded to its share of
        ``n_blocks`` (a multiple of the axis size): ``blocks`` is the whole
        (N, ...) tensor, or with ``rank_local`` only this rank's rows."""
        lo, hi = self.local_range(n_blocks)
        if not rank_local:
            blocks = blocks[lo:hi]
        if blocks.shape[0] != hi - lo:
            pad = blocks.new_zeros((hi - lo - blocks.shape[0], *blocks.shape[1:]))
            blocks = torch.cat([blocks, pad])
        return blocks

    def gather_rows(self, tensors, n_blocks: int):
        """The (n_blocks, ...) tensors of which this rank holds the rows
        [lo, lo + len) in each of ``tensors``, replicated on every rank, in
        ONE all-reduce: each rank fills its rows of zero tensors and the
        ranks sum them, which is exact (x + 0 = x) and runs on every
        backend.  ``n_blocks`` is the padded count or the true N (a rank's
        rows never pass N then)."""
        lo, _ = self.local_range(n_blocks)
        dt = tensors[0].dtype
        for t in tensors[1:]:
            dt = torch.promote_types(dt, t.dtype)
        flat = []
        for t in tensors:
            full = t.new_zeros((n_blocks, *t.shape[1:]), dtype=dt)
            full[lo : lo + t.shape[0]] = t
            flat.append(full.reshape(-1))
        summed = self.sum(torch.cat(flat))
        out, start = [], 0
        for t in tensors:
            size = n_blocks * math.prod(t.shape[1:])
            out.append(summed[start : start + size].reshape(n_blocks, *t.shape[1:]).to(t.dtype))
            start += size
        return out

    def gather_blocks(self, local: torch.Tensor, n_blocks: int) -> torch.Tensor:
        """The (n_blocks, ...) tensor of every rank's block rows, replicated
        (:meth:`gather_rows` of one tensor)."""
        return self.gather_rows([local], n_blocks)[0]
