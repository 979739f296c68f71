"""Two-stage stochastic examples, models in torch (counterpart of
``parapint_tpu.examples.stochastic`` and of the stochastic families of the
JAX package's ``bench_all.py``).

- The farmer (Birge & Louveaux; reference parapint/examples/stochastic.py:
  20-124): three yield scenarios, the first-stage decision is the acreage of
  each crop.  Golden solution WHEAT=170, CORN=80, SUGAR_BEETS=250 acres
  (reference examples/tests/test_examples.py:31-33).  :func:`farmer_family`
  builds the 32-scenario variant with perturbed yields.
- :func:`qp_spec`: a synthetic two-stage stochastic QP with ~1k variables
  per scenario (``stochastic_qp_32scenarios_1k`` at the defaults), whose
  per-scenario KKT block has nk = n + me + n_first = 1024.
"""

import numpy as np
import torch

import parapint_tpu_torch as ptt
from parapint_tpu_torch.interfaces.stochastic import StochasticModelSpec
from parapint_tpu_torch.utils.device import require_device

# crop order: WHEAT, CORN, SUGAR_BEETS (reference stochastic.py:22-39)
CROPS = ["WHEAT", "CORN", "SUGAR_BEETS"]
PRICE_QUOTA = np.array([100000.0, 100000.0, 6000.0])
SUB_PRICE = np.array([170.0, 150.0, 36.0])
SUPER_PRICE = np.array([0.0, 0.0, 10.0])
CATTLE_FEED = np.array([200.0, 240.0, 0.0])
PURCHASE_PRICE = np.array([238.0, 210.0, 100000.0])
PLANT_COST = np.array([150.0, 230.0, 260.0])
TOTAL_ACREAGE = 500.0
YIELDS = np.array(
    [
        [2.0, 2.4, 16.0],  # BelowAverageScenario
        [2.5, 3.0, 20.0],  # AverageScenario
        [3.0, 3.6, 24.0],  # AboveAverageScenario
    ]
)
PROBS = np.array([0.3333, 0.3334, 0.3333])


def _f64(a, like):
    return torch.as_tensor(a, dtype=torch.float64, device=like.device)


def scenario_objective(x, p):
    """One scenario's probability-weighted cost."""
    acre, sub, sup, purch = x[:3], x[3:6], x[6:9], x[9:12]
    expr = (
        (_f64(PURCHASE_PRICE, x) * purch).sum()
        - (_f64(SUB_PRICE, x) * sub).sum()
        - (_f64(SUPER_PRICE, x) * sup).sum()
        + (_f64(PLANT_COST, x) * acre).sum()
    )
    return p["prob"] * expr


def scenario_ineq(x, p):
    """One scenario's inequality rows: total acreage, cattle feed, the quota
    limit and the quota itself."""
    acre, sub, sup, purch = x[:3], x[3:6], x[6:9], x[9:12]
    total = acre.sum()[None]
    feed = p["yield"] * acre + purch - sub - sup  # >= CattleFeedRequirement
    limit = sub + sup - p["yield"] * acre  # <= 0
    quota = sub  # 0 <= sub <= PriceQuota
    return torch.cat([total, feed, limit, quota])


def build_spec(yields=YIELDS, probs=PROBS, device="cuda") -> StochasticModelSpec:
    """The farmer family on ``device`` (the card by default; raises without
    CUDA — pass ``device="cpu"`` for a CPU run)."""
    device = require_device(device)
    N = yields.shape[0]
    n = 12  # [acreage(3), sub_quota_sold(3), super_quota_sold(3), purchased(3)]
    xl = np.zeros((N, n))
    xu = np.full((N, n), np.inf)
    xu[:, :3] = TOTAL_ACREAGE
    gl = np.concatenate([[-np.inf], CATTLE_FEED, [-np.inf] * 3, [0.0] * 3])
    gu = np.concatenate([[TOTAL_ACREAGE], [np.inf] * 3, [0.0] * 3, PRICE_QUOTA])
    return StochasticModelSpec(
        num_scenarios=N,
        objective=scenario_objective,
        ineq_constraints=scenario_ineq,
        params={"yield": np.asarray(yields, dtype=np.float64), "prob": np.asarray(probs, dtype=np.float64)},
        x0=np.full((N, n), 10.0),
        first_stage_idx=[0, 1, 2],
        xl=xl,
        xu=xu,
        gl=np.broadcast_to(gl, (N, 10)),
        gu=np.broadcast_to(gu, (N, 10)),
        device=device,
    )


def farmer_family(num_scenarios=32, device="cuda") -> StochasticModelSpec:
    """The farmer with ``num_scenarios`` scenarios: the average yields scaled
    from 0.7x to 1.3x with 5% noise (``np.random.default_rng(0)``), equal
    probabilities (the JAX package's ``bench_all.stochastic_32``)."""
    rng = np.random.default_rng(0)
    scale = np.linspace(0.7, 1.3, num_scenarios)[:, None]
    yields = YIELDS[1][None, :] * scale * (1.0 + 0.05 * rng.standard_normal((num_scenarios, 3)))
    return build_spec(yields=yields, probs=np.full(num_scenarios, 1.0 / num_scenarios), device=device)


def qp_spec(n_scenarios=32, n=768, me=192, n_first=64, seed=7, device="cuda") -> StochasticModelSpec:
    """Synthetic two-stage stochastic QP (the JAX package's
    ``bench_all.stochastic_qp``, same data from ``np.random.default_rng(seed)``):

      min  sum_s p_s [ 0.5 x_s^T diag(q_s) x_s + c_s^T x_s ]
      s.t. A x_s = b_s,  x_s >= 0,  x_s[:n_first] == theta (nonanticipativity)

    with a shared Gaussian A and per-scenario (q_s, c_s, b_s); b_s = A x*_s
    for a strictly positive x*_s, so a strict interior exists, and c_s makes
    a fraction of the bounds active at the optimum.
    """
    device = require_device(device)
    rng = np.random.default_rng(seed)
    N = n_scenarios
    A_np = rng.standard_normal((me, n)) / np.sqrt(n)
    A = torch.as_tensor(A_np, dtype=torch.float64, device=device)
    q = rng.uniform(0.5, 2.0, size=(N, n))
    c = rng.standard_normal((N, n))
    x_tgt = np.abs(rng.standard_normal((N, n))) + 0.1
    b = x_tgt @ A_np.T

    def objective(x, p):
        return p["prob"] * (0.5 * (p["q"] * x * x).sum() + (p["c"] * x).sum())

    def eq_constraints(x, p):
        return A.to(x.dtype) @ x - p["b"]

    return StochasticModelSpec(
        num_scenarios=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={"q": q, "c": c, "b": b, "prob": np.full(N, 1.0 / N)},
        x0=np.full((N, n), 1.0),
        first_stage_idx=np.arange(n_first),
        xl=np.zeros((N, n)),
        device=device,
    )


def main(linear_solver=None, mesh=None, device="cuda"):
    """The farmer through ``ip_solve`` with ``SchurComplementSolver(block_size=16)``;
    ``mesh``: the interface's, as for ``burgers.main``."""
    interface = ptt.StochasticSchurComplementInteriorPointInterface(
        build_spec(device=device), mesh=mesh
    )
    options = ptt.IPOptions()
    options.linalg.solver = linear_solver or ptt.SchurComplementSolver(block_size=16)
    status = ptt.ip_solve(interface, options)
    if status != ptt.InteriorPointStatus.optimal:
        raise RuntimeError(f"farmer: ip_solve ended with {status}")
    return interface


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    interface = main()
    for crop, val in zip(CROPS, interface.get_first_stage_values().tolist()):
        print(f"devoted_acreage[{crop}] = {val:.4f}")
