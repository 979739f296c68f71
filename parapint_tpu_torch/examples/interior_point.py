"""Toy NLP example, model in torch (counterpart of
``parapint_tpu.examples.interior_point``; reference
parapint/examples/interior_point.py:5-27):

    min x^2 + y^2  s.t.  y = exp(x),  y >= (x-1)^2
"""

import torch

import parapint_tpu_torch as ptt


def main(linear_solver=None, device="cuda", timer=None):
    model = ptt.NLPModel(
        objective=lambda v: v[0] ** 2 + v[1] ** 2,
        eq_constraints=lambda v: torch.stack([v[1] - torch.exp(v[0])]),
        # body oriented as Pyomo canonicalizes `y >= (x-1)**2`
        ineq_constraints=lambda v: torch.stack([(v[0] - 1.0) ** 2 - v[1]]),
        gu=[0.0],
        x0=[0.0, 0.0],
        device=device,
    )
    interface = ptt.InteriorPointInterface(model)
    options = ptt.IPOptions()
    options.linalg.solver = linear_solver or ptt.DenseLDLSolver(block_size=8)
    status = ptt.ip_solve(interface, options, timer=timer)
    if status != ptt.InteriorPointStatus.optimal:
        raise RuntimeError(f"interior_point: ip_solve ended with {status}")
    return interface


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    print("x* =", main().get_primals())
