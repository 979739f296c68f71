"""Heterogeneous block families: different models for different blocks
(counterpart of ``parapint_tpu.interfaces.heterogeneous``).

The uniform specs cover blocks of one structure (with masks); this module
covers blocks of different models by kind-segmented batching:

- blocks are grouped by "kind" (a shared set of model functions and dims);
- each kind's blocks are evaluated by one ``torch.func.vmap``-ed
  computation over that kind's sub-batch, and the results are written back
  into the global (N, ...) tensors by index assignment (each block once);
- every kind is padded to the common (n, me, mi) with the interface's mask
  machinery, so the KKT solver still sees one uniform batch of blocks.

Dense block form only: the kinds offer no HVP/JVP/VJP probes, so the
banded form is refused.
"""

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from parapint_tpu_torch.interfaces.blocked import BatchedNLPFunctions
from parapint_tpu_torch.interfaces.structured import StructuredSCInterface
from parapint_tpu_torch.utils.device import require_device

F64 = torch.float64


def _as_param(v, device) -> torch.Tensor:
    """A parameter leaf as a tensor on ``device``, keeping its dtype (a
    Python float becomes float64, as numpy reads it)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device)


@dataclasses.dataclass
class KindSpec:
    """One block kind: its model functions, dims, bounds and link indices.

    The functions take this kind's unpadded variable vector (n_x,) and one
    block's parameter dict; ``example_params`` is such a dict, used to infer
    the constraint counts (on the device of its tensors, else the CPU).
    """

    objective: Callable
    n_x: int
    eq_constraints: Optional[Callable] = None
    ineq_constraints: Optional[Callable] = None
    xl: Optional[object] = None  # (n_x,)
    xu: Optional[object] = None
    gl: Optional[object] = None  # (n_ineq,)
    gu: Optional[object] = None
    start_state_idx: Optional[object] = None  # (num_states,)
    end_state_idx: Optional[object] = None
    example_params: Optional[dict] = None

    def __post_init__(self):
        p = self.example_params or {}
        dev = next((v.device for v in p.values() if isinstance(v, torch.Tensor)), "cpu")
        p = {k: _as_param(v, dev) for k, v in p.items()}
        x = torch.zeros(self.n_x, dtype=F64, device=dev)
        with torch.no_grad():
            count = lambda fn: 0 if fn is None else int(fn(x, p).shape[0])
            self.n_eq = count(self.eq_constraints)
            self.n_ineq = count(self.ineq_constraints)

        def bound(v, m, fill):
            return np.full(m, fill) if v is None else np.asarray(v, dtype=np.float64)

        self.xl = bound(self.xl, self.n_x, -np.inf)
        self.xu = bound(self.xu, self.n_x, np.inf)
        self.gl = bound(self.gl, self.n_ineq, -np.inf)
        self.gu = bound(self.gu, self.n_ineq, np.inf)


class MultiKindNLPFunctions:
    """The ``BatchedNLPFunctions`` methods the structured interface calls,
    over a mixed-kind block batch.  The parameters are held per kind
    (stacked over that kind's blocks); the ``params`` argument of each
    method is accepted for the same signature and ignored."""

    def __init__(
        self,
        kinds: List[KindSpec],
        kind_of_block: np.ndarray,
        params_per_block: Sequence[dict],
        n_x: int,
        n_eq: int,
        n_ineq: int,
        device,
    ):
        self.n_x, self.n_eq, self.n_ineq = n_x, n_eq, n_ineq
        self.kinds = kinds
        kind_of_block = np.asarray(kind_of_block)
        self.N = len(kind_of_block)
        self.kind_idx, self.kind_params, self.sub = [], [], []
        for k, kind in enumerate(kinds):
            blocks = np.where(kind_of_block == k)[0]
            if len(blocks) == 0:
                self.kind_idx.append(None)
                self.kind_params.append(None)
            else:
                self.kind_idx.append(torch.as_tensor(blocks, dtype=torch.int64, device=device))
                self.kind_params.append({
                    key: torch.stack([_as_param(params_per_block[b][key], device) for b in blocks])
                    for key in params_per_block[blocks[0]]
                })
            self.sub.append(self._padded(kind, n_x, n_eq, n_ineq))

    @staticmethod
    def _padded(kind: KindSpec, n_x: int, n_eq: int, n_ineq: int) -> BatchedNLPFunctions:
        """The kind as a uniform family at the common widths: it reads the
        first ``kind.n_x`` variables and its constraint rows are padded at
        the end (those rows are masked out)."""
        nx = kind.n_x

        def pad_rows(fn, m, width):
            return lambda x, p: F.pad(fn(x[:nx], p), (0, width - m))

        return BatchedNLPFunctions(
            lambda x, p: kind.objective(x[:nx], p),
            pad_rows(kind.eq_constraints, kind.n_eq, n_eq) if kind.n_eq else None,
            pad_rows(kind.ineq_constraints, kind.n_ineq, n_ineq) if kind.n_ineq else None,
            n_x,
            n_eq if kind.n_eq else 0,
            n_ineq if kind.n_ineq else 0,
        )

    def restrict(self, lo: int, hi: int) -> "MultiKindNLPFunctions":
        """The same functions over the blocks [lo, hi) only (one rank's
        range): each kind keeps its blocks that lie there, re-indexed from
        lo, with their parameters."""
        out = copy.copy(self)
        out.N = hi - lo
        out.kind_idx, out.kind_params = [], []
        for idx, p in zip(self.kind_idx, self.kind_params):
            keep = None if idx is None else ((idx >= lo) & (idx < hi)).nonzero()[:, 0]
            if keep is None or keep.numel() == 0:
                out.kind_idx.append(None)
                out.kind_params.append(None)
            else:
                out.kind_idx.append(idx[keep] - lo)
                out.kind_params.append({k: v[keep] for k, v in p.items()})
        return out

    def _kinds(self):
        """(kind spec, its padded family, block indices, stacked params)
        for every kind with blocks."""
        for kind, sub, idx, p in zip(self.kinds, self.sub, self.kind_idx, self.kind_params):
            if idx is not None:
                yield kind, sub, idx, p

    @staticmethod
    def _rows(a, idx, m):
        """a[idx], or an empty (n, 0) stand-in for a kind without rows."""
        return a[idx] if m else a.new_zeros((len(idx), 0))

    def _segmented(self, shape, op, xs, xm, em=None, im=None, extra=None):
        """Run ``op`` per kind on its blocks; stitch into (N, *shape)."""
        outs = None
        for kind, sub, idx, p in self._kinds():
            if op in ("c_eq", "jac_eq"):
                fn = getattr(sub, op) if kind.n_eq else None
                args = (xs[idx], p, xm[idx], em[idx])
            elif op in ("c_ineq", "jac_ineq"):
                fn = getattr(sub, op) if kind.n_ineq else None
                args = (xs[idx], p, xm[idx], im[idx])
            elif op == "hess_lag":
                yeq, yineq, obj_factor = extra
                fn = sub.hess_lag
                args = (
                    xs[idx], self._rows(yeq, idx, kind.n_eq), self._rows(yineq, idx, kind.n_ineq),
                    obj_factor[idx], p, xm[idx], self._rows(em, idx, kind.n_eq),
                    self._rows(im, idx, kind.n_ineq),
                )
            else:
                fn = getattr(sub, op)
                args = (xs[idx], p, xm[idx])
            res = xs.new_zeros((len(idx), *shape)) if fn is None else fn(*args)
            if outs is None:
                outs = res.new_zeros((self.N, *shape))
            outs[idx] = res.to(outs.dtype)
        return outs

    def f(self, xs, params, xm):
        return self._segmented((), "f", xs, xm)

    def total_objective(self, xs, params, xm):
        return self.f(xs, params, xm).sum()

    def grad_f(self, xs, params, xm):
        return self._segmented((self.n_x,), "grad_f", xs, xm)

    def c_eq(self, xs, params, xm, em):
        return self._segmented((self.n_eq,), "c_eq", xs, xm, em=em)

    def c_ineq(self, xs, params, xm, im):
        return self._segmented((self.n_ineq,), "c_ineq", xs, xm, im=im)

    def jac_eq(self, xs, params, xm, em):
        return self._segmented((self.n_eq, self.n_x), "jac_eq", xs, xm, em=em)

    def jac_ineq(self, xs, params, xm, im):
        return self._segmented((self.n_ineq, self.n_x), "jac_ineq", xs, xm, im=im)

    def hess_lag(self, xs, yeq, yineq, obj_factor, params, xm, em, im):
        return self._segmented(
            (self.n_x, self.n_x), "hess_lag", xs, xm, em, im, extra=(yeq, yineq, obj_factor)
        )

    def jtprod(self, xs, yeq, yineq, params, xm, em, im):
        """J_eq^T yeq + J_ineq^T yineq per kind, by each kind's reverse
        sweep, with the duals and masks at the common widths."""
        outs = xs.new_zeros((self.N, self.n_x))
        for kind, sub, idx, p in self._kinds():
            outs[idx] = sub.jtprod(
                xs[idx], self._rows(yeq, idx, kind.n_eq), self._rows(yineq, idx, kind.n_ineq),
                p, xm[idx], self._rows(em, idx, kind.n_eq), self._rows(im, idx, kind.n_ineq),
            ).to(outs.dtype)
        return outs


class HeterogeneousDynamicInterface(StructuredSCInterface):
    """Dynamic Schur-complement interface with per-block kinds (module
    docstring): the chain link topology of
    ``DynamicSchurComplementInteriorPointInterface`` with each kind's own
    start/end state indices.

    ``kinds``: the kinds, each with start/end state indices of one common
    length; ``kind_of_block`` (N,): each time block's kind;
    ``params_per_block``: N parameter dicts (one structure per kind);
    ``x0_per_block``: N initial primal vectors (kind-sized).  ``kkt_dtype``
    casts the iterate for the KKT matrix data; the kinds' parameters stay in
    their own dtype (values promote inside the kind functions).  The
    tensors live on ``device``: the card by default (pass ``device="cpu"``
    for a CPU run); without CUDA the default raises.  ``mesh`` /
    ``axis_name`` as for the uniform interface: each rank evaluates only
    its own blocks, each kind's pass over that kind's blocks in the rank's
    range.
    """

    def __init__(
        self,
        kinds: List[KindSpec],
        kind_of_block,
        params_per_block,
        x0_per_block,
        mesh=None,
        axis_name: str = "blocks",
        kkt_dtype=None,
        block_form: str = "dense",
        device="cuda",
    ):
        if block_form != "dense":
            raise ValueError(
                f"block_form {block_form!r}: the heterogeneous interface assembles dense "
                "blocks only (its kinds offer no HVP/JVP/VJP probes)"
            )
        self.device = device = require_device(device)
        kind_of_block = np.asarray(kind_of_block)
        N = len(kind_of_block)
        n = max(k.n_x for k in kinds)
        me = max(k.n_eq for k in kinds)
        mi = max(k.n_ineq for k in kinds)
        ns_set = {len(np.asarray(k.start_state_idx)) for k in kinds if k.start_state_idx is not None}
        if len(ns_set) != 1:
            raise ValueError("all kinds must declare start/end_state_idx of the same length")
        ns = ns_set.pop()
        self.N, self.n, self.me, self.mi, self.ns = N, n, me, mi, ns
        self.ncv = ns * (N - 1)
        self.n_link = 2 * ns

        self.fns = MultiKindNLPFunctions(kinds, kind_of_block, params_per_block, n, me, mi, device)
        self.params = {}  # the kinds hold the real parameters

        # per-block masks and bounds from the kind templates
        eq_mask = np.zeros((N, me), dtype=bool)
        ineq_mask = np.zeros((N, mi), dtype=bool)
        x_mask = np.zeros((N, n), dtype=bool)
        xl = np.full((N, n), -np.inf)
        xu = np.full((N, n), np.inf)
        gl = np.full((N, mi), -np.inf)
        gu = np.full((N, mi), np.inf)
        x0 = np.zeros((N, n))
        for b in range(N):
            k = kinds[kind_of_block[b]]
            eq_mask[b, : k.n_eq] = True
            ineq_mask[b, : k.n_ineq] = True
            x_mask[b, : k.n_x] = True
            xl[b, : k.n_x] = k.xl
            xu[b, : k.n_x] = k.xu
            gl[b, : k.n_ineq] = k.gl
            gu[b, : k.n_ineq] = k.gu
            x0[b, : k.n_x] = np.asarray(x0_per_block[b])
        as_b = lambda a: torch.as_tensor(a, dtype=torch.bool, device=device)
        self.eq_mask, self.ineq_mask, self.x_mask = as_b(eq_mask), as_b(ineq_mask), as_b(x_mask)
        self._xl, self._xu, self._gl, self._gu = xl, xu, gl, gu
        self.x0 = torch.as_tensor(x0, dtype=F64, device=device)

        # link rows [0, ns) = backward (start states), [ns, 2ns) = forward
        # (end states), with each block's kind's indices
        blk = np.arange(N)
        bwd = np.broadcast_to((blk > 0)[:, None], (N, ns)).astype(np.float64)
        fwd = np.broadcast_to((blk < N - 1)[:, None], (N, ns)).astype(np.float64)
        link_rows = np.zeros((N, 2 * ns, n))
        for b in range(N):
            k = kinds[kind_of_block[b]]
            link_rows[b, np.arange(ns), np.asarray(k.start_state_idx)] = bwd[b]
            link_rows[b, ns + np.arange(ns), np.asarray(k.end_state_idx)] = fwd[b]
        self.link_rows = torch.as_tensor(link_rows, dtype=F64, device=device)
        self.link_mask = torch.as_tensor(np.concatenate([bwd, fwd], axis=1), dtype=F64, device=device)
        row_idx = np.full((N, 2 * ns), self.ncv, dtype=np.int64)
        for i in range(N):
            if i > 0:
                row_idx[i, :ns] = (i - 1) * ns + np.arange(ns)
            if i < N - 1:
                row_idx[i, ns:] = i * ns + np.arange(ns)
        self.row_idx = torch.as_tensor(row_idx, device=device)
        self.sc_assembly = "chain"
        self._finalize(mesh=mesh, axis_name=axis_name, kkt_dtype=kkt_dtype, block_form=block_form)

    def _own_functions(self, lo: int, hi: int):
        return self.fns.restrict(lo, hi)
