"""Multi-process execution (counterpart of ``parapint_tpu.parallel.distributed``).

The JAX package runs one controller per host and lets ``shard_map``
collectives cross process boundaries.  The port runs SPMD ranks instead:
every rank is one process that calls :func:`initialize` (a wrapper of
``torch.distributed.init_process_group``), builds the same interface, and
hands a :func:`global_mesh` to the sharded solvers, whose collectives then
run over the mesh's process group.

Launching (the ``mpirun`` analogue), either with torch's launcher

    python -m torch.distributed.run --nproc_per_node 2 prog.py

and in ``prog.py``::

    from parapint_tpu_torch.parallel import distributed
    distributed.initialize()            # reads RANK, WORLD_SIZE, MASTER_ADDR/PORT
    mesh = distributed.global_mesh("blocks")

or by hand, with each process calling
``distributed.initialize("tcp://localhost:29500", world_size=2, rank=i)``.

The backend follows the device: "nccl" for CUDA, "gloo" for the CPU.  Two
ranks that share one card must pass ``backend="gloo"``: NCCL refuses two
ranks on one device, and gloo reduces CUDA tensors through host memory.

The iterate is whole on every rank (an interface built with ``mesh=``
evaluates only the rank's blocks and gathers what the step reads), so the
JAX package's ``replicated_to_global`` has no counterpart.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from parapint_tpu_torch.parallel.mesh import block_mesh

# a collective that one rank never reaches (a rank that branched
# differently) fails after this long instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    device_type: str = "cuda",
) -> torch.device:
    """Join the process group (call once per process) and return this
    rank's device.

    ``init_method`` (for example ``"tcp://localhost:29500"``), ``world_size``
    and ``rank`` default to torch's launcher environment (``env://`` with
    RANK, WORLD_SIZE).  ``device_type`` "cuda" selects
    ``cuda:{local_rank % device_count}`` as the current device and the
    "nccl" backend, "cpu" selects the CPU and "gloo"; ``backend`` overrides
    the choice.
    """
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    device = local_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=timeout,
    )
    return device


def local_device(device_type: str = "cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (LOCAL_RANK
    from the launcher, else the global rank) or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' for CPU ranks")
    if rank is None:
        rank = process_index()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(axis_name: str = "blocks"):
    """1-D block mesh over every rank of the default process group."""
    return block_mesh(axis_name=axis_name)


def process_index() -> int:
    return dist.get_rank()


def process_count() -> int:
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (the counterpart of ``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
