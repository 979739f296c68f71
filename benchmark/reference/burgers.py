"""Plain reference of the Burgers distributed-control NLP in time blocks:
the model, its exact first and second derivatives, the optimality
certificate that judges an answer, and a Newton solver of the same NLP.

Plain PyTorch, written from the equations (reference parapint
examples/burgers.py:53-287) with hand-derived derivatives; it imports
nothing of the program.  The layout of an answer is the one a
``DynamicSchurComplementInteriorPointInterface`` over the configuration's
model returns: per block the variables [y (nt+1, npts), u (nt+1, npts)]
row-major in (t, x), the equality rows [boundary y(0), y(1), u(0), u(1);
initial y, u (block 0 only); PDE rows (t, x)], and the link duals [backward
(start states), forward (end states)], where block b's backward rows read
coupling group b-1 and its forward rows group b.  The Lagrangian is
f + y'g + lam'(sel(x) - c).
"""

import numpy as np
import torch

# IPOPT's scaling of the dual infeasibility: s_d = max(s_max, mean |dual|) / s_max
S_MAX = 100.0

# the leaves of the program's returned iterate that the certificate judges,
# as (field, key) pairs, in the order of :meth:`BurgersNLP.kkt`'s arguments
ANSWER = (("primals", "blocks"), ("primals", "coupling"), ("duals_eq", "own"), ("duals_eq", "link"))


class BurgersNLP:
    """The NLP of ``config``'s sizes with the tracking profile of ``member``
    (its ``y0``), evaluated in ``dtype`` on ``device``."""

    def __init__(self, config: dict, member: dict, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        N = self.N = config["num_time_blocks"]
        nx = self.nx = config["nfe_x"]
        nt = self.nt = config["nfe_t"] // N
        self.omega, self.visc, self.r = config["omega"], config["v"], config["r"]
        self.dt = (config["end_t"] - config["start_t"]) / config["nfe_t"]
        self.dx = 1.0 / nx
        npts = self.npts = nx + 1
        self.n_y = (nt + 1) * npts
        self.n = 2 * self.n_y
        self.ns = nx - 1
        self.ncv = (N - 1) * self.ns
        t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=self.device)
        self.y0 = t(member["y0"])
        wx = np.full(npts, self.dx)
        wx[0] = wx[-1] = 0.5 * self.dx
        wt = np.full(nt + 1, self.dt)
        wt[0] = wt[-1] = 0.5 * self.dt
        self.w = t(np.outer(wt, wx))  # quadrature weight of each (t, x)

        # equality rows: boundary, initial, PDE
        self.n_bc = 4 * (nt + 1)
        self.n_init = 2 * (nx - 1)
        self.m = self.n_bc + self.n_init + nt * (nx - 1)
        mask = np.ones((N, self.m), dtype=bool)
        mask[1:, self.n_bc : self.n_bc + self.n_init] = False
        self.row_mask = t(mask, torch.bool)

        Y = lambda ti, xi: ti * npts + xi
        U = lambda ti, xi: self.n_y + ti * npts + xi
        ts, xs = np.arange(nt + 1), np.arange(1, nx)
        # linear rows: row -> one column with coefficient 1
        lin_cols = np.concatenate([Y(ts, 0), Y(ts, nx), U(ts, 0), U(ts, nx), Y(0, xs), U(0, xs)])
        self.lin_rows = t(np.arange(lin_cols.size), torch.long)
        self.lin_cols = t(lin_cols, torch.long)
        tp, xp = np.meshgrid(np.arange(1, nt + 1), xs, indexing="ij")
        tp, xp = tp.ravel(), xp.ravel()
        self.pde_rows = t(self.n_bc + self.n_init + np.arange(tp.size), torch.long)
        idx = lambda a: t(a, torch.long)
        self.i_c, self.i_m = idx(Y(tp, xp)), idx(Y(tp - 1, xp))
        self.i_xp, self.i_xm = idx(Y(tp, xp + 1)), idx(Y(tp, xp - 1))
        self.i_ul = idx(U(tp - 1, xp))
        self.start_idx = idx(Y(0, xs))
        self.end_idx = idx(Y(nt, xs))
        self.u0_idx = idx(U(0, xs))

    # -- model -------------------------------------------------------------------

    def initial_primals(self):
        """(x, c): y = y0 at every time, u = 0; c = 0."""
        x = torch.zeros((self.N, self.n), dtype=self.dtype, device=self.device)
        x[:, : self.n_y] = self.y0.repeat(self.nt + 1)
        return x, torch.zeros(self.ncv, dtype=self.dtype, device=self.device)

    def _yu(self, x):
        N, nt1, npts = x.shape[0], self.nt + 1, self.npts
        return x[:, : self.n_y].reshape(N, nt1, npts), x[:, self.n_y :].reshape(N, nt1, npts)

    def objective(self, x):
        """(N,) block objectives."""
        y, u = self._yu(x)
        f = 0.5 * ((self.w * ((y - self.y0) ** 2 + self.omega * u**2)).sum((1, 2)))
        return f + 0.25 * self.dx * self.dt * self.omega * (x[:, self.u0_idx] ** 2).sum(1)

    def grad_objective(self, x):
        y, u = self._yu(x)
        g = torch.cat([(self.w * (y - self.y0)).flatten(1), (self.omega * self.w * u).flatten(1)], 1)
        g[:, self.u0_idx] += 0.5 * self.dx * self.dt * self.omega * x[:, self.u0_idx]
        return g

    def constraints(self, x):
        """(N, m) equality residuals, masked rows 0."""
        g = torch.zeros((x.shape[0], self.m), dtype=x.dtype, device=x.device)
        g[:, self.lin_rows] = x[:, self.lin_cols]
        init_y = slice(self.n_bc, self.n_bc + self.nx - 1)
        g[:, init_y] -= self.y0[1 : self.nx]
        yc, ym, yxp, yxm = (x[:, i] for i in (self.i_c, self.i_m, self.i_xp, self.i_xm))
        g[:, self.pde_rows] = (
            (yc - ym) / self.dt
            - self.visc * (yxp - 2.0 * yc + yxm) / self.dx**2
            + yc * (yxp - yxm) / (2.0 * self.dx)
            - self.r
            - x[:, self.i_ul]
        )
        return g * self.row_mask

    def _pde_partials(self, x):
        """Columns and values of the PDE rows' derivatives: [(cols, (N, k))]."""
        yc, yxp, yxm = x[:, self.i_c], x[:, self.i_xp], x[:, self.i_xm]
        a, h = self.visc / self.dx**2, 0.5 / self.dx
        one = torch.ones_like(yc)
        return [
            (self.i_c, one / self.dt + 2.0 * a + (yxp - yxm) * h),
            (self.i_m, -one / self.dt),
            (self.i_xp, -a + yc * h),
            (self.i_xm, -a - yc * h),
            (self.i_ul, -one),
        ]

    def jt_prod(self, x, y):
        """(N, n) J(x)' y over the unmasked rows."""
        y = y * self.row_mask
        out = torch.zeros_like(x)
        out.index_add_(1, self.lin_cols, y[:, self.lin_rows])
        yp = y[:, self.pde_rows]
        for cols, vals in self._pde_partials(x):
            out.index_add_(1, cols, vals * yp)
        return out

    def jacobian(self, x):
        """(N, m, n) dense J(x), masked rows 0."""
        J = torch.zeros((x.shape[0], self.m, self.n), dtype=x.dtype, device=x.device)
        J[:, self.lin_rows, self.lin_cols] = 1.0
        for cols, vals in self._pde_partials(x):
            J[:, self.pde_rows, cols] += vals
        return J * self.row_mask[:, :, None]

    def lagrangian_hessian(self, x, y):
        """(N, n, n) Hessian of f + y'g."""
        N, n = x.shape
        H = torch.zeros((N, n, n), dtype=x.dtype, device=x.device)
        d = torch.cat([self.w.flatten(), self.omega * self.w.flatten()]).expand(N, n).clone()
        d[:, self.u0_idx] += 0.5 * self.dx * self.dt * self.omega
        H.diagonal(dim1=1, dim2=2).copy_(d)
        lam = (y * self.row_mask)[:, self.pde_rows] * (0.5 / self.dx)
        for cols, sign in ((self.i_xp, 1.0), (self.i_xm, -1.0)):
            H[:, self.i_c, cols] += sign * lam
            H[:, cols, self.i_c] += sign * lam
        return H

    # -- links ---------------------------------------------------------------------

    def link_masks(self):
        """(N, ns) masks of the backward and forward link rows."""
        b = torch.arange(self.N, device=self.device)[:, None].expand(self.N, self.ns)
        return b > 0, b < self.N - 1

    def link_residuals(self, x, c):
        """(N, ns) backward x[start] - c_{b-1} and forward x[end] - c_b, masked 0."""
        mb, mf = self.link_masks()
        cg = c.reshape(self.N - 1, self.ns)
        zero = c.new_zeros((1, self.ns))
        prev, nxt = torch.cat([zero, cg]), torch.cat([cg, zero])
        return (x[:, self.start_idx] - prev) * mb, (x[:, self.end_idx] - nxt) * mf

    def grad_lagrangian(self, x, y, lam_b, lam_f):
        """(dL/dx (N, n), dL/dc (ncv,)) with the masked duals left out."""
        mb, mf = self.link_masks()
        lam_b, lam_f = lam_b * mb, lam_f * mf
        gx = self.grad_objective(x) + self.jt_prod(x, y)
        gx[:, self.start_idx] += lam_b
        gx[:, self.end_idx] += lam_f
        gc = -(lam_f[:-1] + lam_b[1:]).reshape(-1)
        return gx, gc

    # -- the certificate -----------------------------------------------------------

    def certificate(self, answer: dict):
        """:meth:`kkt` of an answer: a dict of the ``ANSWER`` leaves."""
        return self.kkt(*(answer[leaf] for leaf in ANSWER))

    def kkt(self, x, c, y, lam):
        """The optimality numbers of an answer (x (N, n), c (ncv,), y (N, m),
        lam (N, 2 ns) = [backward, forward]), in this object's dtype:
        primal_inf (max |g|, |link|), dual_inf (max |grad L|), the dual scaling
        s_d, kkt_error = max(primal_inf, dual_inf / s_d), objective."""
        cast = lambda a: torch.as_tensor(a).to(dtype=self.dtype, device=self.device)
        x, c, y, lam = cast(x), cast(c), cast(y), cast(lam)
        lam_b, lam_f = lam[:, : self.ns], lam[:, self.ns :]
        rb, rf = self.link_residuals(x, c)
        g = self.constraints(x)
        primal = torch.stack([g.abs().max(), rb.abs().max(), rf.abs().max()]).max()
        gx, gc = self.grad_lagrangian(x, y, lam_b, lam_f)
        dual = torch.maximum(gx.abs().max(), gc.abs().max() if gc.numel() else gx.new_zeros(()))
        mb, mf = self.link_masks()
        n_real = self.row_mask.sum() + mb.sum() + mf.sum()
        dual_sum = (y * self.row_mask).abs().sum() + (lam_b * mb).abs().sum() + (lam_f * mf).abs().sum()
        s_d = torch.clamp(dual_sum / n_real, min=S_MAX) / S_MAX
        return {
            "primal_inf": float(primal),
            "dual_inf": float(dual),
            "dual_scaling": float(s_d),
            "kkt_error": float(torch.maximum(primal, dual / s_d)),
            "objective": float(self.objective(x).sum()),
        }

    # -- a Newton solver of the same NLP ------------------------------------------------

    def solve(self, tol: float, max_iter: int = 50, stall: int = 5) -> dict:
        """Newton's method on the KKT conditions from (initial_primals, zero
        duals), full steps, every number in this object's dtype.  Each block's
        KKT matrix is solved densely and the coupling steps through the dense
        Schur complement.  Stops at kkt_error <= tol (status "optimal") or
        after ``max_iter`` iterations or ``stall`` without a new least error
        (status "error"); returns the iterate with the least error."""
        N, n, m, ns = self.N, self.n, self.m, self.ns
        x, c = self.initial_primals()
        y = torch.zeros((N, m), dtype=self.dtype, device=self.device)
        lam = torch.zeros((N, 2 * ns), dtype=self.dtype, device=self.device)
        best, since, it = None, 0, 0
        while True:
            cert = self.kkt(x, c, y, lam)
            if best is None or cert["kkt_error"] < best["cert"]["kkt_error"]:
                best, since = {"x": x, "c": c, "y": y, "lam": lam, "cert": cert, "iterations": it}, 0
            else:
                since += 1
            if cert["kkt_error"] <= tol or it >= max_iter or since >= stall:
                break
            x, c, y, lam = self._newton_step(x, c, y, lam)
            it += 1
        best["status"] = "optimal" if best["cert"]["kkt_error"] <= tol else "error"
        return best

    def _newton_step(self, x, c, y, lam):
        N, n, m, ns = self.N, self.n, self.m, self.ns
        nk = n + m + 2 * ns
        dt_, dev = self.dtype, self.device
        mb, mf = self.link_masks()
        lam_b, lam_f = lam[:, :ns], lam[:, ns:]
        rx, rc = self.grad_lagrangian(x, y, lam_b, lam_f)
        rb, rf = self.link_residuals(x, c)
        rhs = -torch.cat([rx, self.constraints(x), rb, rf], 1)

        K = torch.zeros((N, nk, nk), dtype=dt_, device=dev)
        K[:, :n, :n] = self.lagrangian_hessian(x, y)
        J = self.jacobian(x)
        K[:, n : n + m, :n] = J
        K[:, :n, n : n + m] = J.transpose(1, 2)
        rows = torch.arange(ns, device=dev)
        for off, cols, mask in ((n + m, self.start_idx, mb), (n + m + ns, self.end_idx, mf)):
            sel = mask.to(dt_)
            K[:, off + rows, cols] = sel
            K[:, cols, off + rows] = sel
        # a masked row is decoupled: -1 on its diagonal, zero right-hand side
        real = torch.cat([torch.ones((N, n), dtype=torch.bool, device=dev), self.row_mask, mb, mf], 1)
        K.diagonal(dim1=1, dim2=2).sub_((~real).to(dt_))

        # couplings enter the link rows: +dc_{b-1} (backward), +dc_b (forward)
        E = torch.zeros((N, nk, 2 * ns), dtype=dt_, device=dev)
        E[:, n + m + rows, rows] = mb.to(dt_)
        E[:, n + m + ns + rows, ns + rows] = mf.to(dt_)
        sol = torch.linalg.solve(K, torch.cat([rhs[:, :, None], E], 2))
        a, G = sol[:, :, 0], sol[:, :, 1:]

        # coupling rows: dlam_f(g) + dlam_b(g+1) = grad_c L = -(lam_f(g) + lam_b(g+1))
        lb, lf = slice(n + m, n + m + ns), slice(n + m + ns, nk)
        S = torch.zeros((N - 1, ns, N + 1, ns), dtype=dt_, device=dev)
        g = torch.arange(N - 1, device=dev)
        # column group k of S's padded layout is coupling group k - 1
        S[g, :, g] += G[:-1, lf, :ns]
        S[g, :, g + 1] += G[:-1, lf, ns:] + G[1:, lb, :ns]
        S[g, :, g + 2] += G[1:, lb, ns:]
        S = S[:, :, 1:N].reshape(self.ncv, self.ncv)
        rhs_c = rc - (a[:-1, lf] + a[1:, lb]).reshape(-1)
        dc = torch.linalg.solve(S, rhs_c)

        dcg = dc.reshape(N - 1, ns)
        zero = dc.new_zeros((1, ns))
        dc_b = torch.cat([torch.cat([zero, dcg]), torch.cat([dcg, zero])], 1)
        z = a + (G @ dc_b[:, :, None])[:, :, 0]
        return x + z[:, :n], c + dc, y + z[:, n : n + m], lam + z[:, n + m :]


NLP = BurgersNLP
