"""Two-stage stochastic Schur-complement interior-point interface
(counterpart of ``parapint_tpu.interfaces.stochastic``).

Each scenario is one block; the coupling variables c are the global
first-stage variables; nonanticipativity is enforced by the linear linking
rows

    x_i[first_stage_idx[j]] - c[j] = 0      for every scenario i

whose dual rows live in the scenario's diagonal KKT block, so the Schur
complement has dimension n_first_stage and is the plain sum of the
scenarios' contributions (``sc_assembly = "shared"``).  The scenarios form
one uniform batched model family (shared torch functions, per-scenario
parameters), evaluated with one vmapped computation.
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
class StochasticModelSpec:
    """Uniform batched model family for a two-stage stochastic program.

    ``objective(x, p)`` (the scenario probability folded in through ``p``,
    as in the reference farmer example), ``eq_constraints(x, p)`` and
    ``ineq_constraints(x, p)`` are torch functions of one scenario's
    variables x (n,) and parameters p (a dict of tensors); ``params`` holds
    them with a leading N axis.  ``x0`` (N, n); ``first_stage_idx`` (L,) the
    scenario-local indices of the first-stage variables, in the same order
    for every scenario.  Bounds, masks and warm starts as in the JAX package.
    The model's tensors live on ``device``: the card by default (pass
    ``device="cpu"`` for a CPU run); without CUDA the default raises.
    """

    num_scenarios: int
    objective: Callable
    params: dict
    x0: object
    first_stage_idx: object
    eq_constraints: Optional[Callable] = None
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
    lam0: Optional[object] = None  # (N, L) nonanticipativity duals
    c0: Optional[object] = None  # (L,) first-stage (coupling) values
    device: object = "cuda"

    def __post_init__(self):
        N = self.num_scenarios
        self.device = require_device(self.device)
        dev = self.device
        self.x0 = torch.as_tensor(self.x0, dtype=F64, device=dev)
        if self.x0.dim() != 2 or self.x0.shape[0] != N:
            raise ValueError(f"x0 must be (num_scenarios, n), got {tuple(self.x0.shape)}")
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

        self.first_stage_idx = np.asarray(self.first_stage_idx, dtype=np.int64)
        self.n_first_stage = int(self.first_stage_idx.shape[0])

        # padding invariant: masked vars/rows are unbounded
        self.xl[~self.x_mask] = -np.inf
        self.xu[~self.x_mask] = np.inf
        self.gl[~self.ineq_mask] = -np.inf
        self.gu[~self.ineq_mask] = np.inf

        def _warm(arr, shape):
            if arr is None:
                return None
            return torch.as_tensor(arr, dtype=F64, device=dev).broadcast_to(shape).clone()

        L = self.n_first_stage
        self.y_eq0 = _warm(self.y_eq0, (N, me))
        self.y_ineq0 = _warm(self.y_ineq0, (N, mi))
        self.zl0 = _warm(self.zl0, (N, n))
        self.zu0 = _warm(self.zu0, (N, n))
        self.lam0 = _warm(self.lam0, (N, L))
        self.c0 = _warm(self.c0, (L,))


class StochasticSchurComplementInteriorPointInterface(StructuredSCInterface):
    """Interface for two-stage stochastic programs (see module docstring).

    ``kkt_dtype`` as for the dynamic interface; the block form is dense.
    ``device`` defaults to the spec's and must match it.

    ``ownership_map``: an optional (N,) array mapping scenario -> rank along
    ``axis_name`` of ``mesh``, for load balancing when scenarios differ in
    cost (the reference's ``ownership_map``).  Every rank must own the same
    number of scenarios.  The scenario axis is then stored in a stable
    permutation that makes each rank's scenarios contiguous, so that the
    sharded solvers' contiguous split hands each rank its own scenarios;
    ``block_perm`` maps storage order to the original scenario index, and
    the per-scenario accessors answer in ORIGINAL scenario order.  With a
    ``mesh`` each rank evaluates the model and assembles the KKT for its own
    (contiguous) scenarios only, for a sharded solver over the same mesh
    (or a serial one, which gathers the KKT whole); the iterate stays whole
    on every rank (see ``structured.py``).
    """

    def __init__(self, spec: StochasticModelSpec, mesh=None, axis_name: str = "blocks",
                 kkt_dtype=None, ownership_map=None, device=None):
        device = spec.device if device is None else torch.device(device)
        if device != spec.device:
            raise ValueError(f"spec lives on {spec.device}, interface asked for {device}")
        self.device = device
        self.spec = spec
        N = spec.num_scenarios
        n, me, mi, L = spec.n_x, spec.n_eq, spec.n_ineq, spec.n_first_stage
        self.N, self.n, self.me, self.mi = N, n, me, mi
        self.ncv = L
        self.n_link = L

        perm = _storage_order(N, ownership_map, mesh, axis_name)
        self.block_perm = perm  # storage order -> original scenario index
        self._inv_perm = np.argsort(perm)
        self._perm_is_identity = bool(np.array_equal(perm, np.arange(N)))
        perm_t = torch.as_tensor(perm, device=device)

        def _p(a):
            """The leading (scenario) axis in storage order."""
            if a is None or self._perm_is_identity:
                return a
            return a[perm_t] if isinstance(a, torch.Tensor) else np.asarray(a)[perm]

        self.fns = BatchedNLPFunctions(
            spec.objective, spec.eq_constraints, spec.ineq_constraints, n, me, mi
        )
        self.params = {k: _p(v) for k, v in spec.params.items()}
        as_b = lambda a: torch.as_tensor(_p(a), dtype=torch.bool, device=device)
        self.eq_mask = as_b(spec.eq_mask)
        self.ineq_mask = as_b(spec.ineq_mask)
        self.x_mask = as_b(spec.x_mask)
        self._xl, self._xu = _p(spec.xl), _p(spec.xu)
        self._gl, self._gu = _p(spec.gl), _p(spec.gu)
        self.x0 = _p(spec.x0)
        self._warm_start = dict(
            y_eq0=_p(spec.y_eq0), y_ineq0=_p(spec.y_ineq0), zl0=_p(spec.zl0),
            zu0=_p(spec.zu0), lam0=_p(spec.lam0), c0=spec.c0,
        )

        # every scenario's link row j selects x[first_stage_idx[j]] and
        # targets coupling variable j
        self.link_sel = spec.first_stage_idx
        self.link_mask = torch.ones((N, L), dtype=F64, device=device)
        self.row_idx = torch.arange(L, device=device).expand(N, L).contiguous()
        self.sc_assembly = "shared"
        self._finalize(mesh=mesh, axis_name=axis_name, kkt_dtype=kkt_dtype)

    # -- per-scenario accessors, in ORIGINAL scenario order ---------------------

    def _deperm(self, a):
        """A leading (scenario-storage) axis back in ORIGINAL order."""
        if self._perm_is_identity:
            return a
        return a[torch.as_tensor(self._inv_perm, device=a.device)]

    def get_block_primals(self, ndx: int):
        """Primals of ORIGINAL scenario ``ndx``."""
        return self._current_state.primals["blocks"][int(self._inv_perm[ndx])]

    def get_primals(self):
        p = self._current_state.primals
        return {"blocks": self._deperm(p["blocks"]), "coupling": p["coupling"]}

    def get_first_stage_values(self):
        """Consensus first-stage variable values (the coupling variables)."""
        return self._current_state.primals["coupling"]

    def get_duals_nonanticipativity(self):
        """(N, L) nonanticipativity duals, in ORIGINAL scenario order."""
        return self._deperm(self._current_state.duals_eq["link"])

    def get_slacks(self):
        return self._deperm(self._current_state.slacks)

    def get_duals_eq(self):
        """{"own": (N, me), "link": (N, L)}, in ORIGINAL scenario order."""
        d = self._current_state.duals_eq
        return {"own": self._deperm(d["own"]), "link": self._deperm(d["link"])}

    def get_duals_ineq(self):
        return self._deperm(self._current_state.duals_ineq)

    def _deperm_bound_duals(self, d):
        return {"blocks": self._deperm(d["blocks"]), "coupling": d["coupling"]}

    def get_duals_primals_lb(self):
        return self._deperm_bound_duals(self._current_state.duals_primals_lb)

    def get_duals_primals_ub(self):
        return self._deperm_bound_duals(self._current_state.duals_primals_ub)

    def get_duals_slacks_lb(self):
        return self._deperm(self._current_state.duals_slacks_lb)

    def get_duals_slacks_ub(self):
        return self._deperm(self._current_state.duals_slacks_ub)


def _storage_order(N: int, ownership_map, mesh, axis_name: str) -> np.ndarray:
    """The scenario storage order: identity without an ownership map, else
    the stable sort of the scenarios by their rank."""
    if ownership_map is None:
        return np.arange(N)
    if mesh is None:
        raise ValueError("ownership_map requires mesh")
    own = np.asarray(ownership_map, dtype=np.int64)
    if own.shape != (N,):
        raise ValueError(f"ownership_map must be ({N},), got {own.shape}")
    n_shards = mesh.shape[mesh.mesh_dim_names.index(axis_name)]
    if own.min() < 0 or own.max() >= n_shards:
        raise ValueError(f"ownership_map entries must be in [0, {n_shards})")
    counts = np.bincount(own, minlength=n_shards)
    if N % n_shards or not np.all(counts == N // n_shards):
        raise ValueError(
            "ownership_map must assign the same number of scenarios "
            f"to every shard (got counts {counts.tolist()})"
        )
    return np.argsort(own, kind="stable")
