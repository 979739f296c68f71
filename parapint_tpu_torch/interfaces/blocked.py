"""Masked, batched AD over a uniform family of NLP blocks and the dense
per-block KKT assembly (counterpart of ``parapint_tpu.interfaces.blocked``).

The user provides block functions ``f(x, p)``, ``c_eq(x, p)``,
``c_ineq(x, p)`` written in torch and shared across blocks, plus per-block
parameters ``p`` (a dict of tensors with leading dimension N).  Every
evaluation is ``torch.func.vmap``-ed over the block axis.  Ragged blocks are
handled by row masks (masked rows evaluate to 0, so their Jacobian rows
vanish) and variable masks (masked variables read as 0).

The dense KKT assembly materializes the per-block Hessian of the
Lagrangian (``hess_lag``, forward-over-reverse) and the constraint Jacobians
(``jac_eq``, ``jac_ineq``) and concatenates them into (N, nk, nk) blocks
(:func:`assemble_block_diag`).  The banded KKT assembly never materializes
Hessians or Jacobians: it uses the probe closures ``hvp_lag``, ``jvp_eq``,
``vjp_eq``, ``jvp_ineq`` and ``vjp_ineq``, each batched over blocks AND over
a shared set of probe vectors.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev, jvp, vjp, vmap


@dataclasses.dataclass(frozen=True)
class BlockKKTData:
    """Batched per-block evaluation results (one leading N axis each)."""

    hess: torch.Tensor  # (N, n, n)
    jac_eq: torch.Tensor  # (N, me, n)
    jac_ineq: torch.Tensor  # (N, mi, n)
    sigma_x: torch.Tensor  # (N, n)
    sigma_s: torch.Tensor  # (N, mi)


def _probe(f, nstate: int):
    """Batch ``f(*state, v)`` over blocks (axis 0 of the state args) and over
    probe vectors (axis 0 of v)."""
    inner = vmap(f, in_dims=(None,) * nstate + (0,))
    return vmap(inner, in_dims=(0,) * nstate + (None,))


class BatchedNLPFunctions:
    """Masked, vmapped AD over a uniform family of blocks."""

    def __init__(
        self,
        objective: Callable,  # (x, p) -> scalar
        eq_constraints: Optional[Callable],  # (x, p) -> (me,)
        ineq_constraints: Optional[Callable],  # (x, p) -> (mi,)
        n_x: int,
        n_eq: int,
        n_ineq: int,
    ):
        self.n_x, self.n_eq, self.n_ineq = n_x, n_eq, n_ineq

        def _f(x, p, xm):
            return objective(torch.where(xm, x, 0.0), p)

        def _ceq(x, p, xm, em):
            if n_eq == 0:
                return x.new_zeros(0)
            return em * eq_constraints(torch.where(xm, x, 0.0), p)

        def _cineq(x, p, xm, im):
            if n_ineq == 0:
                return x.new_zeros(0)
            return im * ineq_constraints(torch.where(xm, x, 0.0), p)

        def _lag(x, y_eq, y_ineq, obj_factor, p, xm, em, im):
            val = obj_factor * _f(x, p, xm)
            if n_eq:
                val = val + (y_eq * _ceq(x, p, xm, em)).sum()
            if n_ineq:
                val = val + (y_ineq * _cineq(x, p, xm, im)).sum()
            return val

        self._f, self._ceq, self._cineq, self._lag = _f, _ceq, _cineq, _lag

        self.f = vmap(_f)
        self.grad_f = vmap(grad(_f))
        self.c_eq = vmap(_ceq)
        self.c_ineq = vmap(_cineq)

        # materialized derivatives (dense block form).  Model functions may
        # mix dtypes internally (f64 constants under a float32 KKT): outputs
        # are pinned to x's dtype, so the matrices come out in x's dtype
        def _jac(fn, m):
            if not m:
                return lambda x, p, xm, mk: x.new_zeros((0, n_x))
            # forward mode when the inputs are no more than the outputs
            mode = jacfwd if n_x <= max(m, 1) else jacrev
            return mode(lambda x, p, xm, mk: fn(x, p, xm, mk).to(x.dtype))

        self.jac_eq = vmap(_jac(_ceq, n_eq))
        self.jac_ineq = vmap(_jac(_cineq, n_ineq))

        def _grad_lag(x, y_eq, y_ineq, obj_factor, p, xm, em, im):
            lag = lambda xq: _lag(xq, y_eq, y_ineq, obj_factor, p, xm, em, im).to(xq.dtype)
            return grad(lag)(x).to(x.dtype)

        self.hess_lag = vmap(jacfwd(_grad_lag))

        # model functions may mix dtypes internally (f64 constants under a
        # float32 KKT); every probed closure's output is pinned to x's dtype
        # so primal and tangent dtypes line up
        def _hvp(x, y_eq, y_ineq, obj_factor, p, xm, em, im, v):
            def g(xx):
                lag = lambda xq: _lag(xq, y_eq, y_ineq, obj_factor, p, xm, em, im).to(xq.dtype)
                return grad(lag)(xx).to(xx.dtype)

            return jvp(g, (x,), (v,))[1]

        def _jvp_eq(x, p, xm, em, v):
            if not n_eq:
                return x.new_zeros(0)
            return jvp(lambda xx: _ceq(xx, p, xm, em).to(x.dtype), (x,), (v,))[1]

        def _vjp_eq(x, p, xm, em, w):
            if not n_eq:
                return x.new_zeros(n_x)
            return vjp(lambda xx: _ceq(xx, p, xm, em).to(x.dtype), x)[1](w)[0]

        def _jvp_ineq(x, p, xm, im, v):
            if not n_ineq:
                return x.new_zeros(0)
            return jvp(lambda xx: _cineq(xx, p, xm, im).to(x.dtype), (x,), (v,))[1]

        def _vjp_ineq(x, p, xm, im, w):
            if not n_ineq:
                return x.new_zeros(n_x)
            return vjp(lambda xx: _cineq(xx, p, xm, im).to(x.dtype), x)[1](w)[0]

        self.hvp_lag = _probe(_hvp, 8)
        self.jvp_eq = _probe(_jvp_eq, 4)
        self.vjp_eq = _probe(_vjp_eq, 4)
        self.jvp_ineq = _probe(_jvp_ineq, 4)
        self.vjp_ineq = _probe(_vjp_ineq, 4)

        def _jtprod(x, y_eq, y_ineq, p, xm, em, im):
            """J_eq^T y_eq + J_ineq^T y_ineq via ONE reverse sweep."""

            def val(xx):
                out = xx.new_zeros(())
                if n_eq:
                    out = out + (y_eq * _ceq(xx, p, xm, em)).sum()
                if n_ineq:
                    out = out + (y_ineq * _cineq(xx, p, xm, im)).sum()
                return out

            return grad(val)(x)

        self.jtprod = vmap(_jtprod)


def sub_kkt_layout(n: int, me: int, mi: int, n_link: int):
    """Offsets of the per-block variable families [x, s, y_eq, y_ineq, lam]
    and the block size nk."""
    off_x = 0
    off_s = n
    off_yeq = n + mi
    off_yineq = n + mi + me
    off_lam = n + 2 * mi + me
    nk = off_lam + n_link
    return off_x, off_s, off_yeq, off_yineq, off_lam, nk


def selector_rows(sel_idx: np.ndarray, mask: np.ndarray, n: int) -> np.ndarray:
    """(N, L, n) 0/1 selector matrices: row j of block b has mask[b, j] at
    column sel_idx[j] (the reference's link COO matrices as dense batched
    selectors)."""
    N, L = mask.shape
    rows = np.zeros((N, L, n))
    for j in range(L):
        rows[:, j, sel_idx[j]] = mask[:, j]
    return rows


def assemble_block_diag(
    data: BlockKKTData,
    eq_mask: torch.Tensor,  # (N, me) bool
    ineq_mask: torch.Tensor,  # (N, mi) bool
    x_mask: torch.Tensor,  # (N, n) bool
    link_rows: torch.Tensor,  # (N, n_link, n) selector rows (masked)
    link_mask: torch.Tensor,  # (N, n_link)
    w_reg,
    c_reg,
) -> torch.Tensor:
    """Batched dense diagonal blocks [K_b, B_b^T; B_b, -c_reg I] in the
    layout [x, s, y_eq, y_ineq, lam], as one concatenation of block rows.

    Masked rows/variables get decoupled -1/+1 diagonals.  ``w_reg`` adds to
    the real-variable Hessian diagonal, ``c_reg`` sets the real constraint
    diagonals to -c_reg.  Everything stays in the data's dtype: a float32
    interface hands float32 data beside float64 regularization and link
    rows, and a promotion would rebuild the (N, nk, nk) result in float64.
    """
    N, n = data.sigma_x.shape
    me = data.jac_eq.shape[1]
    mi = data.jac_ineq.shape[1]
    n_link = link_rows.shape[1]
    dt, dev = data.hess.dtype, data.hess.device
    w_reg = torch.as_tensor(w_reg, dtype=dt, device=dev)
    c_reg = torch.as_tensor(c_reg, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    dg = torch.diag_embed
    z = lambda r, c: torch.zeros((N, r, c), dtype=dt, device=dev)
    jeq, jineq = data.jac_eq.to(dt), data.jac_ineq.to(dt)
    hblk = data.hess + dg(torch.where(x_mask, data.sigma_x.to(dt) + w_reg, one))
    s_coupling = -dg(ineq_mask.to(dt))
    row_x = [hblk, z(n, mi), jeq.transpose(1, 2), jineq.transpose(1, 2)]
    row_s = [z(mi, n), dg(torch.where(ineq_mask, data.sigma_s.to(dt), one)), z(mi, me), s_coupling]
    row_yeq = [jeq, z(me, mi), dg(torch.where(eq_mask, -c_reg, -one)), z(me, mi)]
    row_yineq = [jineq, s_coupling, z(mi, me), dg(torch.where(ineq_mask, -c_reg, -one))]
    rows = [row_x, row_s, row_yeq, row_yineq]
    if n_link:
        lr = link_rows.to(dt)
        row_x.append(lr.transpose(1, 2))
        row_s.append(z(mi, n_link))
        row_yeq.append(z(me, n_link))
        row_yineq.append(z(mi, n_link))
        rows.append(
            [lr, z(n_link, mi), z(n_link, me), z(n_link, mi),
             dg(torch.where(link_mask > 0, -c_reg, -one))]
        )
    return torch.cat([torch.cat(r, dim=2) for r in rows], dim=1)
