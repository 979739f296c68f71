"""Block-structured Schur-complement interior-point interface (counterpart
of ``parapint_tpu.interfaces.structured``), in dense or banded block form.

N uniform NLP blocks, a vector c of coupling variables, and per-block
linear linking rows ``x_b[sel_j] - c[row_idx[b, j]] = 0`` whose dual rows
live inside the block's KKT block and whose coupling columns form the
block-local border.  Per-block KKT layout: [x(n), s(mi), y_eq(me),
y_ineq(mi), lambda(n_link)] (:func:`blocked.sub_kkt_layout`).  The link
topology (``sc_assembly``) is "chain" for the dynamic interface (block i
couples groups i-1 and i), "shared" for the stochastic one (every block
links the same coupling rows 0..L-1) and "scatter" for any other
``row_idx``; the coupling gather and the scatter of the link duals follow
it.

Dense mode (the default) materializes each block's Hessian of the
Lagrangian and constraint Jacobians and assembles dense (N, nk, nk) blocks
with block-local borders (a ``LocalBlockKKT`` for ``SchurComplementSolver``).
Banded mode assembles each per-block KKT as a symmetric band store under a
host-computed permutation (``banded_symbolic.py``) by probing: 2p+1
HVP/JVP/VJP sweeps per block, no Hessian or Jacobian is materialized.  The
link selectors and the border strips are built once as tensors on the
interface's device.  Working vectors (rhs, residuals, convergence) are
float64; the KKT matrix data (blocks, borders) is in ``kkt_dtype`` when one
is given.

With a ``mesh`` (a 1-D ``DeviceMesh``; ``parallel.mesh``) each rank
evaluates the model and assembles the KKT for its own blocks only, the
range ``BlockAxis.local_range`` gives it (the sharded solvers' range): the
objective terms, gradient, residuals, Jacobians and Hessian (or the banded
probes), the J^T y contraction, the KKT data and the rhs blocks.  The
iterate stays whole and the same on every rank; the vectors that the
convergence check, the merit and the step read (per-block objective,
gradient, J^T y, residuals) are gathered exactly into it, in one
all-reduce per AD sweep and one per merit evaluation, so every rank takes
every branch alike.  The KKT and rhs that reach the solver are the rank's
part (``LocalBlockKKT.global_blocks``, with the mesh axis in ``axis``): a
sharded solver over the same mesh takes them as they are, a serial one
gathers them whole on every rank and solves the whole system there.

The accessors (``get_primals``, ``get_slacks``, ``get_duals_*`` ...) read
the current iterate under the JAX package's names, types and shapes; with a
mesh it is whole on every rank, and so is what they return.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from parapint_tpu_torch.interfaces import ad_graph, base
from parapint_tpu_torch.interfaces.banded_symbolic import banded_plan, block_patterns
from parapint_tpu_torch.interfaces.base import (
    STATE_FIELDS,
    Bounds,
    IPState,
    map_leaf,
)
from parapint_tpu_torch.interfaces.blocked import (
    BlockKKTData,
    assemble_block_diag,
    selector_rows,
    sub_kkt_layout,
)
from parapint_tpu_torch.linalg.banded_schur import BandedLocalBlockKKT
from parapint_tpu_torch.linalg.schur import BlockRhs, LocalBlockKKT
from parapint_tpu_torch.ops.ordered_scatter import scatter_add_rows
from parapint_tpu_torch.parallel.mesh import BlockAxis
from parapint_tpu_torch.utils.profile import host_sync, span, spanned

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class _BlockView:
    """The block-axis data that the model evaluation and the KKT assembly
    read: every block's without a mesh (the interface's own tensors), else
    the rows of the rank's range."""

    fns: object
    params: dict
    params_kkt: dict
    x_mask: torch.Tensor
    eq_mask: torch.Tensor
    ineq_mask: torch.Tensor
    link_rows: torch.Tensor
    link_rows_kkt: torch.Tensor
    link_mask: torch.Tensor
    row_idx: torch.Tensor
    border: torch.Tensor  # dense: the border strips; banded: with permuted columns
    w_mask: Optional[torch.Tensor] = None  # banded regularization masks
    c_mask: Optional[torch.Tensor] = None


class StructuredSCInterface(base.BaseInteriorPointInterface):
    """Shared implementation; see module docstring.

    Subclass responsibilities (before calling ``_finalize``):
      self.device, self.N, self.n, self.me, self.mi, self.n_link, self.ncv
      (and self.ns for the chain topology), self.sc_assembly ("chain",
      "shared" or "scatter", the default),
      self.fns (BatchedNLPFunctions), self.params (dict of tensors)
      self.eq_mask / ineq_mask / x_mask  (bool tensors, (N, dim))
      self.link_sel (n_link,) numpy int, selected x index of each link row
        (or, where the selected index differs per block, self.link_rows
        (N, n_link, n) float64 selector rows on the device and no link_sel)
      self.link_mask (N, n_link) float64, self.row_idx (N, n_link) int64
      self._xl/_xu (N, n), self._gl/_gu (N, mi) raw bounds (numpy)
      self.x0 (N, n) float64 initial primals
    """

    def _finalize(self, mesh=None, axis_name: str = "blocks", kkt_dtype=None,
                  block_form: str = "dense"):
        if block_form not in ("dense", "banded"):
            raise ValueError(f"unknown block_form {block_form!r}")
        self.mesh, self.axis_name = mesh, axis_name
        self.axis = None if mesh is None else BlockAxis.of(mesh, axis_name)
        lo, hi = 0, self.N
        if self.axis is not None:
            lo, hi = self.axis.local_range(self.N)
            hi = min(hi, self.N)
            if hi <= lo:
                raise ValueError(
                    f"{self.N} blocks over {self.axis.size} ranks of {axis_name!r} leave rank "
                    f"{self.axis.index} no block (ceil(N/P) blocks per rank)"
                )
        # the blocks this rank evaluates and assembles (all without a mesh)
        self.block_range = (lo, hi)
        self.block_form = block_form
        if not hasattr(self, "sc_assembly"):
            self.sc_assembly = "scatter"
        # kkt_dtype: the probed KKT matrix data is evaluated in this dtype;
        # everything convergence-critical stays float64
        self.kkt_dtype = kkt_dtype
        if kkt_dtype is not None:
            self._params_kkt = {
                k: v.to(kkt_dtype) if v.is_floating_point() else v
                for k, v in self.params.items()
            }
        else:
            self._params_kkt = self.params
        (
            self.off_x,
            self.off_s,
            self.off_yeq,
            self.off_yineq,
            self.off_lam,
            self.nk,
        ) = sub_kkt_layout(self.n, self.me, self.mi, self.n_link)
        self.obj_factor = 1.0
        self._current_state = None
        self._ad_graphs = ad_graph.ADGraphs(self.device)

        # dense (N, n_link, n) link selectors, built once on the device
        if getattr(self, "link_sel", None) is not None:
            self.link_rows = torch.as_tensor(
                selector_rows(self.link_sel, self.link_mask.cpu().numpy(), self.n),
                dtype=F64,
                device=self.device,
            )

        kd = kkt_dtype or F64
        self._link_rows_kkt = self.link_rows.to(kd)
        if block_form == "banded":
            self._banded_setup()
        else:
            # local border strips: row j holds -link_mask[b, j] at column
            # off_lam + j (KKT-data dtype, as the banded strips)
            L = self.n_link
            border = torch.zeros((self.N, L, self.nk), dtype=kd, device=self.device)
            border[:, torch.arange(L, device=self.device), self.off_lam + torch.arange(L, device=self.device)] = -self.link_mask.to(kd)
            self._border_loc = border

        self.n_eq_real = int(self.eq_mask.sum()) + int(self.link_mask.sum())
        self.n_ineq_real = int(self.ineq_mask.sum())
        self._bounds_relaxation_factor = 0.0
        self._set_bounds()
        banded = block_form == "banded"
        own = self._own
        self._view = _BlockView(
            fns=self.fns if self.axis is None else self._own_functions(lo, hi),
            params={k: own(v) for k, v in self.params.items()},
            params_kkt={k: own(v) for k, v in self._params_kkt.items()},
            x_mask=own(self.x_mask),
            eq_mask=own(self.eq_mask),
            ineq_mask=own(self.ineq_mask),
            link_rows=own(self.link_rows),
            link_rows_kkt=own(self._link_rows_kkt),
            link_mask=own(self.link_mask),
            row_idx=own(self.row_idx),
            border=own(self._border_loc_perm if banded else self._border_loc),
            w_mask=own(self._b_w_mask) if banded else None,
            c_mask=own(self._b_c_mask) if banded else None,
        )

    def _own_functions(self, lo: int, hi: int):
        """The batched model functions over the blocks [lo, hi) (a rank's
        range); the parameters are sliced beside them."""
        return self.fns

    def _own(self, t):
        """This rank's rows of a block-axis tensor (every row without a
        mesh)."""
        if self.axis is None:
            return t
        lo, hi = self.block_range
        return t[lo:hi]

    def _gather(self, *tensors):
        """Block-axis tensors evaluated on this rank's rows, whole and the
        same on every rank (exact; one all-reduce for all of them); without
        a mesh they are whole already."""
        if self.axis is None:
            return tensors
        return self.axis.gather_rows(list(tensors), self.N)

    # -- banded block form ---------------------------------------------------

    def _banded_setup(self):
        """One-time symbolic analysis (ordering, bandwidth, probes)."""
        params_samples = [
            {k: v[i] for k, v in self.params.items()} for i in sorted({0, self.N - 1})
        ]
        Hpat, Jeq_pat, Jineq_pat = block_patterns(
            self.fns, params_samples, self.n, self.me, self.mi, self.device
        )
        link_pat = (self.link_rows.abs().amax(dim=0) > 0).cpu().numpy()
        plan = banded_plan(
            Hpat, Jeq_pat, Jineq_pat, link_pat, self.n, self.me, self.mi, self.n_link
        )
        self.banded_plan = plan
        dev = self.device
        as_i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        kd = self.kkt_dtype or F64
        as_k = lambda a: torch.as_tensor(a, dtype=kd, device=dev)
        self._b_perm = as_i(plan.perm)
        self._b_iperm = as_i(plan.iperm)
        self._b_Vx = as_k(plan.Vx)
        self._b_Vs = as_k(plan.Vs)
        self._b_Vyeq = as_k(plan.Vyeq)
        self._b_Vyineq = as_k(plan.Vyineq)
        self._b_Vlam = as_k(plan.Vlam)
        self._b_col_idx = as_i(plan.col_idx)
        self._b_row_idx = as_i(plan.row_idx)
        self._b_valid = as_k(plan.valid)
        # border strips with permuted columns: local border row j holds
        # -link_mask[b, j] at permuted column iperm[off_lam + j]
        N, L, nk = self.N, self.n_link, self.nk
        pos = as_i(plan.iperm[self.off_lam : self.off_lam + L])
        border = torch.zeros((N, L, nk), dtype=kd, device=dev)
        border[:, torch.arange(L, device=dev), pos] = -self.link_mask.to(kd)
        self._border_loc_perm = border
        # regularization diagonal masks in permuted space (N, nk): w_reg
        # ADDS to real x-variable diagonals, c_reg SETS real constraint
        # diagonals (zero in the probed baseline)
        w_mask = torch.zeros((N, nk), dtype=kd, device=dev)
        w_mask[:, : self.n] = self.x_mask.to(kd)
        c_mask = torch.zeros((N, nk), dtype=kd, device=dev)
        c_mask[:, self.off_yeq : self.off_yeq + self.me] = self.eq_mask.to(kd)
        c_mask[:, self.off_yineq : self.off_yineq + self.mi] = self.ineq_mask.to(kd)
        c_mask[:, self.off_lam :] = self.link_mask.to(kd)
        self._b_w_mask = w_mask[:, self._b_perm]
        self._b_c_mask = c_mask[:, self._b_perm]

    def _banded_bands0(self, x, yeq, yineq, sigma_x, sigma_s):
        """Per-iteration banded KKT assembly by probing: (n, p+1, nk) lower
        bands of the permuted per-block KKTs at w_reg = c_reg = 0, for the
        rank's n blocks (every block without a mesh), whose rows the
        arguments are."""
        v = self._view
        fns = v.fns
        cast, params = self._kkt_cast()
        x, yeq, yineq = cast(x), cast(yeq), cast(yineq)
        dt = x.dtype
        xm = v.x_mask
        em = v.eq_mask.to(dt)
        im = v.ineq_mask.to(dt)
        obf = torch.full((x.shape[0],), self.obj_factor, dtype=dt, device=x.device)
        Vx, Vs, Vyeq = self._b_Vx, self._b_Vs, self._b_Vyeq
        Vyineq, Vlam = self._b_Vyineq, self._b_Vlam
        lrows = v.link_rows_kkt
        sx = cast(sigma_x)
        ss = cast(sigma_s)

        hv = fns.hvp_lag(x, yeq, yineq, obf, params, xm, em, im, Vx)
        jeq_v = fns.jvp_eq(x, params, xm, em, Vx)
        jineq_v = fns.jvp_ineq(x, params, xm, im, Vx)
        jTeq_v = fns.vjp_eq(x, params, xm, em, Vyeq)
        jTineq_v = fns.vjp_ineq(x, params, xm, im, Vyineq)

        out_x = (
            hv
            + torch.where(xm, sx, 1.0)[:, None, :] * Vx[None]
            + jTeq_v
            + jTineq_v
            + torch.einsum("bln,ql->bqn", lrows, Vlam)
        )
        out_s = (
            torch.where(v.ineq_mask, ss, 1.0)[:, None, :] * Vs[None]
            - im[:, None, :] * Vyineq[None]
        )
        out_yeq = jeq_v + torch.where(v.eq_mask, 0.0, -1.0).to(dt)[:, None, :] * Vyeq[None]
        out_yineq = (
            jineq_v
            - im[:, None, :] * Vs[None]
            + torch.where(v.ineq_mask, 0.0, -1.0).to(dt)[:, None, :] * Vyineq[None]
        )
        out_lam = (
            torch.einsum("bln,qn->bql", lrows, Vx)
            + torch.where(v.link_mask > 0, 0.0, -1.0).to(dt)[:, None, :] * Vlam[None]
        )
        Y = torch.cat([out_x, out_s, out_yeq, out_yineq, out_lam], dim=2)
        # permute ROWS (K v is a row-space vector), then extract bands:
        # bands0[b, e, i] = Kp[i+e, i] = Yp[b, i % q, i + e]
        with span("iface.band_extract"):
            Yp = Y[:, :, self._b_perm]
            return Yp[:, self._b_col_idx, self._b_row_idx] * self._b_valid

    # -- accessors -------------------------------------------------------------

    @property
    def border_loc(self) -> torch.Tensor:
        """(N, n_link, nk) local border strips of the dense block form."""
        return self._border_loc

    def n_primals(self) -> int:
        return self.N * self.n + self.ncv

    def n_eq_constraints(self) -> int:
        """Includes the coupling (link) constraints."""
        return self.n_eq_real

    def n_ineq_constraints(self) -> int:
        return self.n_ineq_real

    @property
    def n_duals_eq(self) -> int:
        return self.n_eq_real

    @property
    def n_duals_ineq(self) -> int:
        return self.n_ineq_real

    @property
    def expected_neg_eig(self) -> int:
        """All constraint-family rows, real or padded (padded rows carry a
        decoupled -1 diagonal, one negative eigenvalue each)."""
        return self.N * (self.me + self.mi + self.n_link)

    def get_state(self) -> IPState:
        return self._current_state

    def get_primals(self):
        return self._current_state.primals

    def get_block_primals(self, ndx: int):
        return self._current_state.primals["blocks"][ndx]

    def get_coupling_values(self):
        return self._current_state.primals["coupling"]

    def get_slacks(self):
        return self._current_state.slacks

    def get_duals_eq(self):
        """{"own": (N, me), "link": (N, n_link)}: the blocks' own equality
        duals and their link rows' duals."""
        return self._current_state.duals_eq

    def get_duals_ineq(self):
        return self._current_state.duals_ineq

    def get_duals_primals_lb(self):
        """{"blocks": (N, n), "coupling": (ncv,)}"""
        return self._current_state.duals_primals_lb

    def get_duals_primals_ub(self):
        return self._current_state.duals_primals_ub

    def get_duals_slacks_lb(self):
        return self._current_state.duals_slacks_lb

    def get_duals_slacks_ub(self):
        return self._current_state.duals_slacks_ub

    def evaluate_objective(self):
        """The whole problem's objective (with a mesh: every rank calls it,
        each evaluating its own blocks)."""
        v = self._view
        x = self._own(self._current_state.primals["blocks"])
        (f,) = self._gather(v.fns.f(x, v.params, v.x_mask))
        return f.sum()

    # -- bounds ----------------------------------------------------------------

    def get_bounds_relaxation_factor(self) -> float:
        return self._bounds_relaxation_factor

    def set_bounds_relaxation_factor(self, val: float) -> None:
        self._bounds_relaxation_factor = val
        self._set_bounds()

    def _set_bounds(self) -> None:
        f = self._bounds_relaxation_factor
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        self.bounds = Bounds(
            xl={
                "blocks": base.relax_bounds_lower(t(self._xl), f),
                "coupling": torch.full((self.ncv,), -torch.inf, dtype=F64, device=dev),
            },
            xu={
                "blocks": base.relax_bounds_upper(t(self._xu), f),
                "coupling": torch.full((self.ncv,), torch.inf, dtype=F64, device=dev),
            },
            gl=base.relax_bounds_lower(t(self._gl), f),
            gu=base.relax_bounds_upper(t(self._gu), f),
        )

    # -- initial state ---------------------------------------------------------

    @spanned("iface.init_state")
    def init_state(self) -> IPState:
        b = self.bounds
        base.validate_bounds(b.xl["blocks"], b.xu["blocks"])
        base.validate_bounds(b.gl, b.gu)
        warm = getattr(self, "_warm_start", {}) or {}
        N, n, me, mi, dev = self.N, self.n, self.me, self.mi, self.device
        zeros = lambda *shape: torch.zeros(shape, dtype=F64, device=dev)
        ones = lambda *shape: torch.ones(shape, dtype=F64, device=dev)
        y_eq0, y_ineq0 = warm.get("y_eq0"), warm.get("y_ineq0")
        zl0, zu0 = warm.get("zl0"), warm.get("zu0")
        lam0, c0 = warm.get("lam0"), warm.get("c0")
        xl, xu = b.xl["blocks"], b.xu["blocks"]
        x = base.process_init(self.x0, xl, xu)
        c = zeros(self.ncv) if c0 is None else c0
        v = self._view
        (s0,) = self._gather(v.fns.c_ineq(self._own(self.x0), v.params, v.x_mask, v.ineq_mask))
        s = base.process_init(s0, b.gl, b.gu)
        zl_w = ones(N, n) if zl0 is None else zl0
        zu_w = ones(N, n) if zu0 is None else zu0
        zl = base.process_init_duals_lb(torch.where(torch.isneginf(xl), 0.0, zl_w), xl)
        zu = base.process_init_duals_ub(torch.where(torch.isposinf(xu), 0.0, zu_w), xu)
        # slack duals split from warm ineq duals by sign
        vl_w = zeros(N, mi) if y_ineq0 is None else torch.clamp(y_ineq0, min=0.0)
        vu_w = zeros(N, mi) if y_ineq0 is None else torch.clamp(-y_ineq0, min=0.0)
        vl = base.process_init_duals_lb(vl_w, b.gl)
        vu = base.process_init_duals_ub(vu_w, b.gu)
        return IPState(
            primals={"blocks": x, "coupling": c},
            slacks=s,
            duals_eq={
                "own": zeros(N, me) if y_eq0 is None else y_eq0,
                "link": zeros(N, self.n_link) if lam0 is None else lam0 * self.link_mask,
            },
            duals_ineq=zeros(N, mi) if y_ineq0 is None else y_ineq0,
            duals_primals_lb={"blocks": zl, "coupling": zeros(self.ncv)},
            duals_primals_ub={"blocks": zu, "coupling": zeros(self.ncv)},
            duals_slacks_lb=vl,
            duals_slacks_ub=vu,
        )

    # -- link helpers ------------------------------------------------------------

    @property
    def _chain_links(self) -> bool:
        """Chain topology with the [bwd(ns), fwd(ns)] link layout: the
        coupling gather and scatter are shifted contiguous slices."""
        ns = getattr(self, "ns", 0)
        return (
            self.sc_assembly == "chain"
            and ns > 0
            and self.n_link == 2 * ns
            and self.ncv == (self.N - 1) * ns
        )

    def _gather_coupling(self, c):
        """c values seen by each block's link rows: (N, n_link).  Chain:
        backward rows of block b read group b-1, forward rows group b; any
        other topology reads c[row_idx] (the dump index ncv reads 0)."""
        if self._chain_links:
            z = c.new_zeros((1, self.ns))
            ext = torch.cat([z, c.reshape(-1, self.ns), z], dim=0)
            return torch.cat([ext[: self.N], ext[1 : self.N + 1]], dim=1)
        return torch.cat([c, c.new_zeros(1)])[self.row_idx]

    def _link_duals(self, duals_eq):
        return duals_eq["link"] * self.link_mask

    def _link_resid(self, x, c):
        """(N, n_link) masked link residuals sel(x) - c."""
        lx = (self.link_rows.to(x.dtype) @ x[:, :, None])[..., 0]
        return (lx - self._gather_coupling(c) * self.link_mask) * self.link_mask

    def _scatter_link_duals_to_coupling(self, duals_eq):
        """The link duals summed onto their coupling rows, (ncv,).  Chain:
        group g collects the forward duals of block g and the backward duals
        of block g+1; shared: rows 0..n_link-1 sum over the blocks; scatter
        adds each dual at its row_idx.  Every topology adds in a fixed order
        (an atomic scatter-add on the card adds in any order, so solves would
        not repeat bit for bit)."""
        lam = self._link_duals(duals_eq)
        if self._chain_links:
            ns = self.ns
            return (lam[: self.N - 1, ns:] + lam[1:, :ns]).reshape(self.ncv)
        if self.sc_assembly == "shared":
            return torch.nn.functional.pad(lam.sum(0), (0, self.ncv - self.n_link))
        return scatter_add_rows(self.row_idx, lam, self.ncv)

    def _grad_lag_primals(self, state, grad_f, jtlam, jac_eq=None, jac_ineq=None):
        """grad f + J^T y + link rows^T lam; ``jtlam`` None contracts the
        materialized (whole) Jacobians instead (dense form without kkt_dtype
        or mesh)."""
        if jtlam is None:
            jtlam = (state.duals_eq["own"][:, None, :] @ jac_eq)[:, 0, :] + (
                state.duals_ineq[:, None, :] @ jac_ineq
            )[:, 0, :]
        lam = self._link_duals(state.duals_eq)
        return (
            self.obj_factor * grad_f
            + jtlam
            + (lam[:, None, :] @ self.link_rows.to(lam.dtype))[:, 0, :]
        )

    def _jtprod(self, x, yeq, yineq):
        """Exact J^T-dual product via one VJP sweep (no Jacobians), for the
        rank's blocks, whose rows the arguments are."""
        v = self._view
        return v.fns.jtprod(x, yeq, yineq, v.params, v.x_mask, v.eq_mask, v.ineq_mask)

    def _own_iterate(self, state):
        """(x, y_eq, y_ineq): the rank's rows of the iterate's block parts."""
        return (self._own(state.primals["blocks"]), self._own(state.duals_eq["own"]),
                self._own(state.duals_ineq))

    # -- shared AD evaluation ----------------------------------------------------

    def _kkt_cast(self):
        """(cast to kkt_dtype, the rank's parameters in kkt_dtype)."""
        kd = self.kkt_dtype
        if kd is None:
            return (lambda a: a), self._view.params
        return (lambda a: a.to(kd) if a.is_floating_point() else a), self._view.params_kkt

    def _eval_hess(self, x, yeq, yineq):
        """(n, n_x, n_x) Hessians of the Lagrangian of the rank's n blocks, in
        ``kkt_dtype`` when set: the Hessian enters only the KKT matrix, never
        the float64 rhs or convergence numbers."""
        v = self._view
        cast, params = self._kkt_cast()
        x = cast(x)
        obf = torch.full((x.shape[0],), self.obj_factor, dtype=x.dtype, device=x.device)
        return v.fns.hess_lag(
            x, cast(yeq), cast(yineq), obf, params, v.x_mask, v.eq_mask, v.ineq_mask,
        )

    def _eval_jacs(self, x):
        """Materialized constraint Jacobians of the rank's blocks, in
        ``kkt_dtype`` when set (the float64 dual contraction then comes from
        :meth:`_jtprod`)."""
        v = self._view
        cast, params = self._kkt_cast()
        args = (cast(x), params, v.x_mask)
        return v.fns.jac_eq(*args, v.eq_mask), v.fns.jac_ineq(*args, v.ineq_mask)

    def _graphed(self) -> bool:
        """Whether the per-iteration AD calls replay CUDA graphs
        (``ad_graph.py``): inside a fused solve, on a device with graph
        capture, without a mesh (its gather runs collectives), in the banded
        form (the dense form's stores would hold every block's Hessian)."""
        return (
            ad_graph.in_fused_solve()
            and self.axis is None
            and self.block_form == "banded"
            and self.device.type in ad_graph.CAPTURE
        )

    @spanned("iface.eval_ad")
    def eval_ad(self, state):
        """One AD sweep per iteration: every derivative quantity that both
        the convergence check and the KKT assembly need.  Banded mode
        probes the KKT later (kkt_from_ad) and always needs the exact J^T y;
        dense mode materializes the Hessian and Jacobians, and contracts the
        duals through them unless they are in reduced precision (with a
        mesh the contraction runs here, on the rank's Jacobians).  The
        objective, gradient, residuals and J^T y come out whole; the
        Jacobians and Hessian hold the rank's blocks."""
        args = self._own_iterate(state)
        if self._graphed():
            return self._ad_graphs("eval_ad", self._eval_ad, args, self.obj_factor)
        return self._eval_ad(*args)

    def _eval_ad(self, x, yeq, yineq):
        v = self._view
        args = (x, v.params, v.x_mask)
        f = v.fns.f(*args)
        grad_f = v.fns.grad_f(*args)
        c_eq = v.fns.c_eq(*args, v.eq_mask)
        c_ineq = v.fns.c_ineq(*args, v.ineq_mask)
        out = dict(jac_eq=None, jac_ineq=None, hess=None)
        jtlam = None
        if self.block_form == "banded" or self.kkt_dtype is not None:
            jtlam = self._jtprod(x, yeq, yineq)
        if self.block_form == "dense":
            jac_eq, jac_ineq = self._eval_jacs(x)
            out.update(jac_eq=jac_eq, jac_ineq=jac_ineq)
            if jtlam is None and self.axis is not None:
                jtlam = (yeq[:, None, :] @ jac_eq)[:, 0, :] + (yineq[:, None, :] @ jac_ineq)[:, 0, :]
            out["hess"] = self._eval_hess(x, yeq, yineq)
        f, grad_f, c_eq, c_ineq, jtlam = self._gather(f, grad_f, c_eq, c_ineq, jtlam)
        out.update(obj=f.sum(), grad_f=grad_f, c_eq=c_eq, c_ineq=c_ineq, jtlam=jtlam)
        return out

    @spanned("iface.convergence_from_ad")
    def convergence_from_ad(self, state, ad, barrier, error_scaling):
        args = (state, self.bounds, ad, barrier, error_scaling)
        if self._graphed():
            return self._ad_graphs(
                "convergence_from_ad", self._convergence_from_ad, args, self.obj_factor
            )
        return self._convergence_from_ad(*args)

    def _convergence_from_ad(self, state, bounds, ad, barrier, error_scaling):
        return self._convergence_core(
            state, bounds, ad["obj"], ad["grad_f"], ad["jtlam"],
            ad["c_eq"], ad["c_ineq"], barrier, error_scaling,
            jac_eq=ad["jac_eq"], jac_ineq=ad["jac_ineq"],
        )

    @spanned("iface.kkt_from_ad")
    def kkt_from_ad(self, state, ad, barrier):
        args = (state, self.bounds, ad, barrier)
        if self._graphed():
            return self._ad_graphs("kkt_from_ad", self._kkt_core, args, self.obj_factor)
        return self._kkt_core(*args)

    # -- convergence -------------------------------------------------------------

    def convergence_info(self, state, barrier, error_scaling=100.0):
        """The convergence numbers of ``state`` by their own AD sweep (the
        Python-loop ``ip_solve``'s check; the fused solve shares one sweep
        between check and KKT through :meth:`eval_ad`).  The dual
        contraction is the exact float64 VJP, as in the reference."""
        v = self._view
        x, yeq, yineq = self._own_iterate(state)
        args = (x, v.params, v.x_mask)
        f, grad_f, jtlam, c_eq, c_ineq = self._gather(
            v.fns.f(*args), v.fns.grad_f(*args), self._jtprod(x, yeq, yineq),
            v.fns.c_eq(*args, v.eq_mask), v.fns.c_ineq(*args, v.ineq_mask),
        )
        return self._convergence_core(
            state, self.bounds, f.sum(), grad_f, jtlam, c_eq, c_ineq, barrier, error_scaling,
        )

    def _convergence_core(
        self, state, bounds, obj, grad_f, jtlam, c_eq, c_ineq, barrier, error_scaling,
        jac_eq=None, jac_ineq=None,
    ):
        x = state.primals["blocks"]
        c = state.primals["coupling"]
        ineq_resid = c_ineq - state.slacks
        link_resid = self._link_resid(x, c)
        glp_blocks = (
            self._grad_lag_primals(state, grad_f, jtlam, jac_eq, jac_ineq)
            - state.duals_primals_lb["blocks"]
            + state.duals_primals_ub["blocks"]
        )
        glp_coupling = -self._scatter_link_duals_to_coupling(state.duals_eq)
        grad_lag_slacks = -state.duals_ineq - state.duals_slacks_lb + state.duals_slacks_ub
        flat = lambda d: torch.cat([d["blocks"].reshape(-1), d["coupling"]])
        return base.convergence_metrics(
            objective=obj,
            grad_lag_primals=torch.cat([glp_blocks.reshape(-1), glp_coupling]),
            grad_lag_slacks=grad_lag_slacks.reshape(-1),
            eq_resid=torch.cat([c_eq.reshape(-1), link_resid.reshape(-1)]),
            ineq_resid=ineq_resid.reshape(-1),
            primals=torch.cat([x.reshape(-1), c]),
            primals_lb=flat(bounds.xl),
            primals_ub=flat(bounds.xu),
            duals_primals_lb=flat(state.duals_primals_lb),
            duals_primals_ub=flat(state.duals_primals_ub),
            slacks=state.slacks.reshape(-1),
            ineq_lb=bounds.gl.reshape(-1),
            ineq_ub=bounds.gu.reshape(-1),
            duals_slacks_lb=state.duals_slacks_lb.reshape(-1),
            duals_slacks_ub=state.duals_slacks_ub.reshape(-1),
            duals_eq=torch.cat(
                [state.duals_eq["own"].reshape(-1), self._link_duals(state.duals_eq).reshape(-1)]
            ),
            duals_ineq=state.duals_ineq.reshape(-1),
            n_duals_eq=self.n_eq_real,
            n_duals_ineq=self.n_ineq_real,
            barrier=barrier,
            error_scaling=error_scaling,
        )

    # -- line-search merit ---------------------------------------------------------

    @spanned("iface.merit_components")
    def merit_components(self, state, barrier):
        """(theta, phi) for a filter line search: theta = 1-norm of all
        constraint residuals, phi = barrier objective.  Values only."""
        v = self._view
        x = state.primals["blocks"]
        s = state.slacks
        args = (self._own(x), v.params, v.x_mask)
        f, c_eq, c_ineq = self._gather(
            v.fns.f(*args), v.fns.c_eq(*args, v.eq_mask), v.fns.c_ineq(*args, v.ineq_mask)
        )
        theta = (
            c_eq.abs().sum()
            + (c_ineq - s).abs().sum()
            + self._link_resid(x, state.primals["coupling"]).abs().sum()
        )
        b = self.bounds
        phi = self.obj_factor * f.sum() - barrier * (
            base.log_barrier_sum(x, b.xl["blocks"], b.xu["blocks"])
            + base.log_barrier_sum(s, b.gl, b.gu)
        )
        return theta, phi

    # -- KKT evaluation ------------------------------------------------------------

    def eval_kkt_data(self, state, barrier):
        return self.kkt_from_ad(state, self.eval_ad(state), barrier)

    def _kkt_core(self, state, bounds, ad, barrier):
        """(matrix data, rhs): the (n, p+1, nk) band store (banded) or the
        BlockKKTData of Hessians, Jacobians and barrier diagonals (dense) of
        the rank's n blocks, in ``kkt_dtype``; the rhs is float64, its
        blocks those rows of the rhs built from the whole vectors."""
        x = state.primals["blocks"]
        c = state.primals["coupling"]
        s = state.slacks
        xl, xu = bounds.xl["blocks"], bounds.xu["blocks"]
        with span("iface.barrier_diag"):
            sigma_x = base.barrier_hessian_diag(
                x, xl, xu, state.duals_primals_lb["blocks"], state.duals_primals_ub["blocks"]
            )
            sigma_s = base.barrier_hessian_diag(
                s, bounds.gl, bounds.gu, state.duals_slacks_lb, state.duals_slacks_ub
            )
        own = self._own
        if self.block_form == "banded":
            data = self._banded_bands0(*self._own_iterate(state), own(sigma_x), own(sigma_s))
        else:
            kd = self.kkt_dtype
            mcast = (lambda a: a) if kd is None else (lambda a: a.to(kd))
            data = BlockKKTData(
                hess=mcast(ad["hess"]),
                jac_eq=mcast(ad["jac_eq"]),
                jac_ineq=mcast(ad["jac_ineq"]),
                sigma_x=mcast(own(sigma_x)),
                sigma_s=mcast(own(sigma_s)),
            )
        with span("iface.rhs"):
            c_eq, c_ineq = ad["c_eq"], ad["c_ineq"]
            rhs_x = -(
                self._grad_lag_primals(
                    state, ad["grad_f"], ad["jtlam"], ad["jac_eq"], ad["jac_ineq"]
                )
                + base.barrier_grad_term(x, xl, xu, barrier)
            )
            rhs_s = -(
                -state.duals_ineq + base.barrier_grad_term(s, bounds.gl, bounds.gu, barrier)
            )
            rhs_blocks = torch.cat(
                [rhs_x, rhs_s, -c_eq, -(c_ineq - s), -self._link_resid(x, c)], dim=1
            )
            rhs = BlockRhs(
                blocks=own(rhs_blocks),
                coupling=self._scatter_link_duals_to_coupling(state.duals_eq),
            )
        return data, rhs

    @spanned("iface.assemble_kkt")
    def assemble_kkt(self, data_and_rhs, w_reg, c_reg):
        """KKT with regularization: ``w_reg`` adds to the real x-variable
        diagonals, ``c_reg`` sets the real constraint diagonals to -c_reg,
        and the coupling block is Q = c_reg * I.  A ``LocalBlockKKT``
        (dense) or a ``BandedLocalBlockKKT`` (banded); with a mesh, of the
        rank's blocks (``global_blocks``, ``block_offset`` and ``axis``
        set)."""
        data = data_and_rhs[0]
        v = self._view
        lo, hi = self.block_range
        part = {} if self.axis is None else dict(global_blocks=self.N, block_offset=lo, axis=self.axis)
        if self.block_form == "dense":
            diag = assemble_block_diag(
                data, v.eq_mask, v.ineq_mask, v.x_mask, v.link_rows, v.link_mask, w_reg, c_reg,
            )
            dt = diag.dtype
            with host_sync():  # a copy from pageable host memory
                c_reg = torch.as_tensor(c_reg, dtype=dt, device=diag.device)
            return LocalBlockKKT.make(
                diag=diag,
                border_loc=v.border,
                row_idx=v.row_idx,
                q=c_reg * torch.eye(self.ncv, dtype=dt, device=diag.device),
                assembly=self.sc_assembly,
                **part,
            )
        dt = data.dtype
        with host_sync():  # copies from pageable host memory, one sync each
            w_reg = torch.as_tensor(w_reg, dtype=dt, device=data.device)
        with host_sync():
            c_reg = torch.as_tensor(c_reg, dtype=dt, device=data.device)
        bands = data.clone()
        bands[:, 0, :] += w_reg * v.w_mask.to(dt) - c_reg * v.c_mask.to(dt)
        return BandedLocalBlockKKT(
            sym_bands=bands,
            border_loc=v.border.to(dt),
            row_idx=v.row_idx,
            q=c_reg * torch.eye(self.ncv, dtype=dt, device=data.device),
            mask=torch.ones(hi - lo, dtype=dt, device=data.device),
            perm=self._b_perm,
            iperm=self._b_iperm,
            assembly=self.sc_assembly,
            **part,
        )

    @spanned("iface.kkt_rhs")
    def kkt_rhs(self, data_and_rhs) -> BlockRhs:
        return data_and_rhs[1]

    # -- delta extraction ------------------------------------------------------------

    @spanned("iface.extract_deltas")
    def extract_deltas(self, state, sol: BlockRhs, barrier) -> IPState:
        bounds = self.bounds
        n, me, mi = self.n, self.me, self.mi
        blocks = sol.blocks
        dx = blocks[:, self.off_x : self.off_x + n]
        ds = blocks[:, self.off_s : self.off_s + mi]
        dyeq = blocks[:, self.off_yeq : self.off_yeq + me]
        dyineq = blocks[:, self.off_yineq : self.off_yineq + mi]
        dlam = blocks[:, self.off_lam : self.off_lam + self.n_link] * self.link_mask
        x = state.primals["blocks"]
        dzl = base.delta_duals_lb(
            barrier, state.duals_primals_lb["blocks"], dx, x, bounds.xl["blocks"]
        )
        dzu = base.delta_duals_ub(
            barrier, state.duals_primals_ub["blocks"], dx, x, bounds.xu["blocks"]
        )
        dvl = base.delta_duals_lb(barrier, state.duals_slacks_lb, ds, state.slacks, bounds.gl)
        dvu = base.delta_duals_ub(barrier, state.duals_slacks_ub, ds, state.slacks, bounds.gu)
        zeros_c = torch.zeros(self.ncv, dtype=F64, device=self.device)
        return IPState(
            primals={"blocks": dx, "coupling": sol.coupling},
            slacks=ds,
            duals_eq={"own": dyeq, "link": dlam},
            duals_ineq=dyineq,
            duals_primals_lb={"blocks": dzl, "coupling": zeros_c},
            duals_primals_ub={"blocks": dzu, "coupling": zeros_c},
            duals_slacks_lb=dvl,
            duals_slacks_ub=dvu,
        )

    # -- fraction to the boundary -----------------------------------------------------

    @spanned("iface.fraction_to_the_boundary")
    def fraction_to_the_boundary(self, state, deltas, tau):
        bounds = self.bounds
        fl = lambda t: t.reshape(-1)
        x, dx = fl(state.primals["blocks"]), fl(deltas.primals["blocks"])
        s, ds = fl(state.slacks), fl(deltas.slacks)
        a_p = torch.minimum(
            torch.minimum(
                base.ftb_lb(tau, x, dx, fl(bounds.xl["blocks"])),
                base.ftb_ub(tau, x, dx, fl(bounds.xu["blocks"])),
            ),
            torch.minimum(
                base.ftb_lb(tau, s, ds, fl(bounds.gl)),
                base.ftb_ub(tau, s, ds, fl(bounds.gu)),
            ),
        )
        duals = lambda st: (
            fl(st.duals_primals_lb["blocks"]),
            fl(st.duals_primals_ub["blocks"]),
            fl(st.duals_slacks_lb),
            fl(st.duals_slacks_ub),
        )
        a_d = torch.stack(
            [base.ftb_duals(tau, z, dz) for z, dz in zip(duals(state), duals(deltas))]
        ).min()
        return a_p, a_d

    # -- step update -------------------------------------------------------------------

    @spanned("iface.apply_step")
    def apply_step(self, state, deltas, alpha_primal, alpha_dual, alpha=1.0) -> IPState:
        ap = alpha * alpha_primal
        ad = alpha * alpha_dual
        # primals and slacks step with alpha_primal, every dual family with
        # alpha_dual
        return IPState(
            **{
                f: map_leaf(
                    lambda s, d, a=(ap if f in ("primals", "slacks") else ad): s + a * d,
                    getattr(state, f),
                    getattr(deltas, f),
                )
                for f in STATE_FIELDS
            }
        )
