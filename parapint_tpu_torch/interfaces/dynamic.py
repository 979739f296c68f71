"""Dynamic (time-block decomposition) Schur-complement interior-point
interface (counterpart of ``parapint_tpu.interfaces.dynamic``).

The horizon is split into N uniform time blocks; continuity of the
``num_states`` states across block boundaries goes through coupling
variables c and linear linking rows

    backward (block i > 0):    x_i[start_state_idx] - c_{i-1} = 0
    forward  (block i < N-1):  x_i[end_state_idx]   - c_i     = 0

Both link families' dual rows live in the diagonal blocks, so the Schur
complement has dimension (N-1)*num_states and is block-tridiagonal.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from parapint_tpu_torch.interfaces.blocked import BatchedNLPFunctions
from parapint_tpu_torch.interfaces.structured import StructuredSCInterface
from parapint_tpu_torch.utils.device import require_device

F64 = torch.float64


@dataclasses.dataclass
class DynamicModelSpec:
    """Uniform batched model family for a dynamic optimization problem.

    ``objective(x, p)``, ``eq_constraints(x, p)`` and ``ineq_constraints``
    are torch functions of one block's variables x (n,) and parameters p (a
    dict of tensors); ``params`` holds them with a leading N axis.  ``x0``
    (N, n), bounds, masks and state indices as in the JAX package.  The
    model's tensors and ``x0``/``params`` live on ``device``: the card by
    default (pass ``device="cpu"`` for a CPU run); without CUDA the default
    raises instead of building on the CPU.
    """

    num_blocks: int
    objective: Callable
    eq_constraints: Optional[Callable]
    params: dict
    x0: object
    start_state_idx: object
    end_state_idx: object
    ineq_constraints: Optional[Callable] = None
    xl: Optional[object] = None
    xu: Optional[object] = None
    gl: Optional[object] = None
    gu: Optional[object] = None
    eq_mask: Optional[object] = None
    ineq_mask: Optional[object] = None
    x_mask: Optional[object] = None
    y_eq0: Optional[object] = None  # (N, n_eq) equality duals
    y_ineq0: Optional[object] = None  # (N, n_ineq) inequality duals
    zl0: Optional[object] = None  # (N, n) lower bound duals
    zu0: Optional[object] = None  # (N, n) upper bound duals
    lam0: Optional[object] = None  # (N, 2*num_states) link duals [bwd, fwd]
    c0: Optional[object] = None  # ((N-1)*num_states,) coupling values
    device: object = "cuda"

    def __post_init__(self):
        N = self.num_blocks
        self.device = require_device(self.device)
        dev = self.device
        self.x0 = torch.as_tensor(self.x0, dtype=F64, device=dev)
        if self.x0.dim() != 2 or self.x0.shape[0] != N:
            raise ValueError(f"x0 must be (num_blocks, n), got {tuple(self.x0.shape)}")
        self.params = {k: torch.as_tensor(v, device=dev) for k, v in self.params.items()}
        n = self.x0.shape[1]
        p0 = {k: v[0] for k, v in self.params.items()}
        with torch.no_grad():
            me = 0 if self.eq_constraints is None else int(self.eq_constraints(self.x0[0], p0).shape[0])
            mi = 0 if self.ineq_constraints is None else int(self.ineq_constraints(self.x0[0], p0).shape[0])
        self.n_x, self.n_eq, self.n_ineq = n, me, mi

        def _default(arr, shape, fill):
            if arr is None:
                return np.full(shape, fill)
            a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
            return np.broadcast_to(a.astype(np.float64), shape).copy()

        self.xl = _default(self.xl, (N, n), -np.inf)
        self.xu = _default(self.xu, (N, n), np.inf)
        self.gl = _default(self.gl, (N, mi), -np.inf)
        self.gu = _default(self.gu, (N, mi), np.inf)

        def _mask(m, shape):
            if m is None:
                return np.ones(shape, dtype=bool)
            a = m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
            return np.broadcast_to(a.astype(bool), shape).copy()

        self.eq_mask = _mask(self.eq_mask, (N, me))
        self.ineq_mask = _mask(self.ineq_mask, (N, mi))
        self.x_mask = _mask(self.x_mask, (N, n))

        self.start_state_idx = np.asarray(self.start_state_idx, dtype=np.int64)
        self.end_state_idx = np.asarray(self.end_state_idx, dtype=np.int64)
        if self.start_state_idx.shape != self.end_state_idx.shape:
            raise ValueError("start/end state index lists must have equal length")
        self.num_states = int(self.start_state_idx.shape[0])

        # padding invariant: masked vars/rows are unbounded
        self.xl[~self.x_mask] = -np.inf
        self.xu[~self.x_mask] = np.inf
        self.gl[~self.ineq_mask] = -np.inf
        self.gu[~self.ineq_mask] = np.inf

        def _warm(arr, shape):
            if arr is None:
                return None
            return torch.as_tensor(arr, dtype=F64, device=dev).broadcast_to(shape).clone()

        ns = self.num_states
        self.y_eq0 = _warm(self.y_eq0, (N, me))
        self.y_ineq0 = _warm(self.y_ineq0, (N, mi))
        self.zl0 = _warm(self.zl0, (N, n))
        self.zu0 = _warm(self.zu0, (N, n))
        self.lam0 = _warm(self.lam0, (N, 2 * ns))
        self.c0 = _warm(self.c0, ((N - 1) * ns,))


class DynamicSchurComplementInteriorPointInterface(StructuredSCInterface):
    """Interface for dynamic problems (see module docstring).

    ``device`` defaults to the spec's device and must match it (the model
    functions hold tensors there).  ``block_form`` "dense" (the default)
    assembles dense (N, nk, nk) blocks for ``SchurComplementSolver``;
    "banded" assembles band stores for ``BandedSchurComplementSolver``.
    ``mesh`` / ``axis_name``: a 1-D ``DeviceMesh`` holding this rank; each
    rank then evaluates the model and assembles the KKT for its own blocks
    only, for a sharded solver over the same mesh
    (``ShardedSchurComplementSolver``, ``ShardedBandedSchurComplementSolver``,
    ``PCGSchurComplementSolver(mesh=...)``), or for a serial one, which
    gathers the KKT whole on every rank; see ``structured.py``.
    """

    def __init__(
        self,
        spec: DynamicModelSpec,
        mesh=None,
        axis_name: str = "blocks",
        kkt_dtype=None,
        block_form: str = "dense",
        device=None,
    ):
        device = spec.device if device is None else torch.device(device)
        if device != spec.device:
            raise ValueError(f"spec lives on {spec.device}, interface asked for {device}")
        self.device = device
        self.spec = spec
        N = spec.num_blocks
        n, me, mi, ns = spec.n_x, spec.n_eq, spec.n_ineq, spec.num_states
        self.N, self.n, self.me, self.mi, self.ns = N, n, me, mi, ns
        self.ncv = ns * (N - 1)
        self.n_link = 2 * ns

        self.fns = BatchedNLPFunctions(
            spec.objective, spec.eq_constraints, spec.ineq_constraints, n, me, mi
        )
        self.params = spec.params
        as_b = lambda a: torch.as_tensor(a, dtype=torch.bool, device=device)
        self.eq_mask = as_b(spec.eq_mask)
        self.ineq_mask = as_b(spec.ineq_mask)
        self.x_mask = as_b(spec.x_mask)
        self._xl, self._xu = spec.xl, spec.xu
        self._gl, self._gu = spec.gl, spec.gu
        self.x0 = spec.x0
        self._warm_start = dict(
            y_eq0=spec.y_eq0, y_ineq0=spec.y_ineq0, zl0=spec.zl0,
            zu0=spec.zu0, lam0=spec.lam0, c0=spec.c0,
        )

        # link rows [0, ns) = backward (start states), [ns, 2ns) = forward
        blk = np.arange(N)
        bwd = np.broadcast_to((blk > 0)[:, None], (N, ns))
        fwd = np.broadcast_to((blk < N - 1)[:, None], (N, ns))
        self.link_mask = torch.as_tensor(
            np.concatenate([bwd, fwd], axis=1), dtype=F64, device=device
        )
        self.link_sel = np.concatenate([spec.start_state_idx, spec.end_state_idx])
        # coupling var touched by each link row: backward -> c_{i-1},
        # forward -> c_i; masked rows point at the dump index ncv
        row_idx = np.full((N, 2 * ns), self.ncv, dtype=np.int64)
        for i in range(N):
            if i > 0:
                row_idx[i, :ns] = (i - 1) * ns + np.arange(ns)
            if i < N - 1:
                row_idx[i, ns:] = i * ns + np.arange(ns)
        self.row_idx = torch.as_tensor(row_idx, device=device)
        self.sc_assembly = "chain"
        self._finalize(mesh=mesh, axis_name=axis_name, kkt_dtype=kkt_dtype, block_form=block_form)

    # -- dynamic-specific accessors ----------------------------------------------

    def get_duals_backward(self):
        """Duals of the backward continuity constraints, (N, num_states)
        (zero on block 0, which has none)."""
        return self._current_state.duals_eq["link"][:, : self.ns] * self.link_mask[:, : self.ns]

    def get_duals_forward(self):
        """Duals of the forward continuity constraints, (N, num_states)
        (zero on the last block)."""
        return self._current_state.duals_eq["link"][:, self.ns :] * self.link_mask[:, self.ns :]
