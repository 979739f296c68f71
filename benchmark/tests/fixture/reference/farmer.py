"""Plain reference of the farmer two-stage stochastic LP (Birge and Louveaux;
reference parapint examples/stochastic.py:20-124): the model, its exact
derivatives and the optimality certificate that judges an answer.

Plain PyTorch, written from the equations; it imports nothing of the
program.  Per scenario the variables are [acreage (3), sold under the quota
(3), sold above it (3), purchased (3)], the crops WHEAT, CORN, SUGAR_BEETS;
the inequality rows are [total acreage; cattle feed (3); sales within the
harvest (3); the quota (3)]; the acreage is the first stage, tied to the
coupling values c by the rows x[first] - c = 0.  The layout is the one a
``StochasticSchurComplementInteriorPointInterface`` over the farmer returns,
with slacks s = g(x) and the Lagrangian

    f + y'(g(x) - s) + lam'(x[first] - c) - zl'(x - xl) + zu'(x - xu)
      - vl'(s - gl) + vu'(s - gu).

The certificate is the Burgers reference's IPOPT-scaled optimality error,
extended by the inequality rows, the bounds and complementarity.
"""

import numpy as np
import torch

# IPOPT's scaling of the dual infeasibility and of complementarity:
# s = max(s_max, mean |dual|) / s_max
S_MAX = 100.0
# IPOPT's bound_relax_factor, which the program applies too: every finite
# bound b moves out by BOUND_RELAX * max(1, |b|).  The answer is judged
# against the relaxed bounds, as IPOPT judges its own: a sound answer sits
# strictly inside them, and against the stated bounds its complementarity
# products would read up to 5e-6 (the 500-acre row) times a dual in the
# tens, far over the tolerance, though nothing is wrong.
BOUND_RELAX = 1e-8

# the problem's data (reference stochastic.py:22-39), in crop order
PRICE_QUOTA = (100000.0, 100000.0, 6000.0)
SUB_PRICE = (170.0, 150.0, 36.0)
SUPER_PRICE = (0.0, 0.0, 10.0)
CATTLE_FEED = (200.0, 240.0, 0.0)
PURCHASE_PRICE = (238.0, 210.0, 100000.0)
PLANT_COST = (150.0, 230.0, 260.0)
TOTAL_ACREAGE = 500.0
FIRST_STAGE = (0, 1, 2)

# the leaves of the program's returned iterate that the certificate judges,
# as (field, key-or-None) pairs
ANSWER = (
    ("primals", "blocks"), ("primals", "coupling"), ("slacks", None), ("duals_eq", "link"),
    ("duals_ineq", None), ("duals_primals_lb", "blocks"), ("duals_primals_ub", "blocks"),
    ("duals_slacks_lb", None), ("duals_slacks_ub", None),
)


def _relaxed(bound, sign):
    return np.where(np.isfinite(bound), bound + sign * BOUND_RELAX * np.maximum(1.0, np.abs(bound)), bound)


class FarmerNLP:
    """The farmer over ``member``'s scenarios (its ``yields`` (N, 3) and
    ``probs`` (N,)), evaluated in ``dtype`` on ``device``."""

    def __init__(self, config: dict, member: dict, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        yields = np.asarray(member["yields"], dtype=np.float64)
        probs = np.asarray(member["probs"], dtype=np.float64)
        N = self.N = yields.shape[0]
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=self.device)

        cost = np.concatenate([PLANT_COST, -np.asarray(SUB_PRICE), -np.asarray(SUPER_PRICE), PURCHASE_PRICE])
        self.grad_f = t(probs[:, None] * cost[None, :])  # (N, 12): the objective is linear
        # the inequality rows are linear too: g(x) = J x, J (N, 10, 12)
        J = np.zeros((N, 10, 12))
        J[:, 0, 0:3] = 1.0
        for i in range(3):
            acre, sub, sup, purch = i, 3 + i, 6 + i, 9 + i
            J[:, 1 + i, acre] = yields[:, i]  # feed: yield * acre + purch - sub - sup
            J[:, 1 + i, purch] = 1.0
            J[:, 1 + i, sub] = J[:, 1 + i, sup] = -1.0
            J[:, 4 + i, sub] = J[:, 4 + i, sup] = 1.0  # sub + sup - yield * acre <= 0
            J[:, 4 + i, acre] = -yields[:, i]
            J[:, 7 + i, sub] = 1.0  # 0 <= sub <= quota
        self.J = t(J)

        inf = np.inf
        xl, xu = np.zeros(12), np.full(12, inf)
        xu[0:3] = TOTAL_ACREAGE
        gl = np.concatenate([[-inf], CATTLE_FEED, [-inf] * 3, [0.0] * 3])
        gu = np.concatenate([[TOTAL_ACREAGE], [inf] * 3, [0.0] * 3, PRICE_QUOTA])
        self.bounds = {  # (N, .) relaxed lower and upper bounds of x and of s
            name: t(_relaxed(b, sign)).expand(N, b.size)
            for name, b, sign in (("xl", xl, -1.0), ("xu", xu, 1.0), ("gl", gl, -1.0), ("gu", gu, 1.0))
        }
        self.first = torch.as_tensor(FIRST_STAGE, device=self.device)

    def objective(self, x):
        return (self.grad_f * x).sum()

    def constraints(self, x):
        """(N, 10) g(x)."""
        return (self.J @ x[:, :, None])[:, :, 0]

    def certificate(self, answer: dict) -> dict:
        """The optimality numbers of an answer (a dict of the ``ANSWER``
        leaves), in this object's dtype: primal_inf, dual_inf (unscaled),
        dual_scaling s_d, compl_inf (unscaled, at mu = 0), compl_scaling
        s_c, sign_inf, kkt_error = max(primal_inf, dual_inf / s_d,
        compl_inf / s_c, sign_inf), objective.

        Every term is held to the configuration's tol through kkt_error:
        - primal_inf: max |g(x) - s|, |x[first] - c| and how far x or s lies
          beyond its relaxed bounds.  The program stops where its own
          max(primal, scaled dual, scaled complementarity) reaches tol, with
          these definitions, so a sound answer reads at most tol; the
          fraction to the boundary keeps every iterate strictly inside the
          relaxed bounds, so the bound part reads 0.
        - dual_inf over s_d: max |grad L| over x, c and s, scaled as IPOPT
          and the program scale it (the farmer's duals reach 2.5e4, so a
          raw tol would judge rounding in the largest dual).
        - compl_inf over s_c: max |(x - xl) zl|, |(xu - x) zu| and the same
          for s, over the finite bounds, scaled as IPOPT scales it.
        - sign_inf: a bound dual below 0 or a dual of an absent (infinite)
          bound other than 0.  The fraction to the boundary keeps every
          bound dual positive and the absent ones stay 0, so a sound answer
          reads exactly 0; any reading is a fault.
        """
        cast = lambda a: torch.as_tensor(a).to(dtype=self.dtype, device=self.device)
        (x, c, s, lam, y, zl, zu, vl, vu) = (cast(answer[leaf]) for leaf in ANSWER)
        b = self.bounds
        fin = {k: torch.isfinite(v) for k, v in b.items()}
        beyond = lambda v, lo, hi: torch.stack([
            torch.where(fin[lo], b[lo] - v, 0.0).clamp(min=0.0).max(),
            torch.where(fin[hi], v - b[hi], 0.0).clamp(min=0.0).max(),
        ]).max()
        primal = torch.stack([
            (self.constraints(x) - s).abs().max(), (x[:, self.first] - c).abs().max(),
            beyond(x, "xl", "xu"), beyond(s, "gl", "gu"),
        ]).max()

        gx = self.grad_f + (self.J.transpose(1, 2) @ y[:, :, None])[:, :, 0] - zl + zu
        gx[:, self.first] += lam
        gc = -lam.sum(0)
        gs = -y - vl + vu
        dual = torch.stack([gx.abs().max(), gc.abs().max(), gs.abs().max()]).max()

        pairs = ((x, "xl", zl, 1.0), (x, "xu", zu, -1.0), (s, "gl", vl, 1.0), (s, "gu", vu, -1.0))
        compl = torch.stack([torch.where(fin[k], (v - b[k]) * z * sign, 0.0).abs().max()
                             for v, k, z, sign in pairs]).max()
        sign_inf = torch.stack([torch.where(fin[k], (-z).clamp(min=0.0), z.abs()).max()
                                for _, k, z, _ in pairs]).max()

        bound_duals = sum(torch.where(fin[k], z, 0.0).abs().sum() for _, k, z, _ in pairs)
        n_bounds = sum(f.sum() for f in fin.values())
        s_d = torch.clamp((lam.abs().sum() + y.abs().sum() + bound_duals) / (lam.numel() + y.numel() + n_bounds),
                          min=S_MAX) / S_MAX
        s_c = torch.clamp(bound_duals / n_bounds, min=S_MAX) / S_MAX
        return {
            "primal_inf": float(primal),
            "dual_inf": float(dual),
            "dual_scaling": float(s_d),
            "compl_inf": float(compl),
            "compl_scaling": float(s_c),
            "sign_inf": float(sign_inf),
            "kkt_error": float(torch.stack([primal, dual / s_d, compl / s_c, sign_inf]).max()),
            "objective": float(self.objective(x)),
        }


NLP = FarmerNLP
