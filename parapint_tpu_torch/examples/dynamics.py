"""Sin-tracking dynamics example, model in torch (counterpart of
``parapint_tpu.examples.dynamics``; reference
parapint/examples/dynamics.py:37-206): track sin(0.1 t) + 1 with
first-order dynamics dx/dt = p - x (implicit Euler), piecewise-constant
control p <= 2, trapezoid tracking objective; the horizon is split into
time blocks solved through the Schur-complement interface.

Per-block model (uniform across blocks, no initial-condition rows, as in
the reference model):
  vars:  x[0..nfe] (nfe+1 states), p[0..np-1] (np controls)
  eq:    x[k+1] - x[k] - dt*(p[k // ccd] - x[k+1]) = 0
  obj:   sum_k 0.5*dt*((x[k]-target_k)^2 + (x[k+1]-target_{k+1})^2)
"""

import numpy as np
import torch

import parapint_tpu_torch as ptt
from parapint_tpu_torch.interfaces.dynamic import DynamicModelSpec
from parapint_tpu_torch.utils.device import require_device


def build_spec(
    t0: int = 0,
    delta_t: int = 1,
    num_finite_elements: int = 90,
    constant_control_duration: int = 10,
    time_scale: float = 0.1,
    num_time_blocks: int = 3,
    device="cuda",
) -> DynamicModelSpec:
    """The model family on ``device`` (the card by default; raises without
    CUDA — pass ``device="cpu"`` for a CPU run)."""
    device = require_device(device)
    if num_finite_elements % num_time_blocks:
        raise ValueError("num_finite_elements must be a multiple of num_time_blocks")
    nfe = num_finite_elements // num_time_blocks  # per block
    if constant_control_duration % delta_t or (nfe * delta_t) % constant_control_duration:
        raise ValueError("the control duration must divide the block length")
    n_p = (nfe * delta_t) // constant_control_duration
    fe_per_p = nfe // n_p
    n = (nfe + 1) + n_p  # x states then p controls
    steps = delta_t * torch.arange(nfe + 1, dtype=torch.float64, device=device)
    p_of_fe = torch.arange(nfe, device=device) // fe_per_p  # control of each element

    def objective(v, p):
        x = v[: nfe + 1]
        target = torch.sin(time_scale * (p["t0"] + steps)) + 1.0
        d2 = (x - target) ** 2
        return 0.5 * delta_t * (d2[:-1] + d2[1:]).sum()

    def eq_constraints(v, p):
        x = v[: nfe + 1]
        ctrl = v[nfe + 1 :]
        return x[1:] - x[:-1] - delta_t * (ctrl[p_of_fe] - x[1:])

    N = num_time_blocks
    block_len = nfe * delta_t
    xu = np.full((N, n), np.inf)
    xu[:, nfe + 1 :] = 2.0  # p <= 2 (reference dynamics.py:81)
    return DynamicModelSpec(
        num_blocks=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={"t0": (t0 + block_len * np.arange(N)).astype(np.float64)},
        x0=np.zeros((N, n)),
        xu=xu,
        start_state_idx=[0],
        end_state_idx=[nfe],
        device=device,
    )


def main(
    linear_solver=None,
    num_finite_elements: int = 90,
    num_time_blocks: int = 3,
    constant_control_duration: int = 10,
    mesh=None,
    options=None,
    device="cuda",
):
    """Solve through ``ip_solve``; returns (interface, x(t), p(t)) with the
    trajectories stitched across blocks, as numpy.  ``mesh``: the
    interface's, as for ``burgers.main``."""
    spec = build_spec(
        num_finite_elements=num_finite_elements,
        num_time_blocks=num_time_blocks,
        constant_control_duration=constant_control_duration,
        device=device,
    )
    interface = ptt.DynamicSchurComplementInteriorPointInterface(spec, mesh=mesh)
    if options is None:
        options = ptt.IPOptions()
    options.linalg.solver = linear_solver or ptt.SchurComplementSolver(block_size=32)
    status = ptt.ip_solve(interface, options)
    if status != ptt.InteriorPointStatus.optimal:
        raise RuntimeError(f"dynamics: ip_solve ended with {status}")

    nfe = num_finite_elements // num_time_blocks
    xs = interface.get_state().primals["blocks"].cpu().numpy()
    x_traj = np.concatenate([xs[0, : nfe + 1]] + [xs[i, 1 : nfe + 1] for i in range(1, num_time_blocks)])
    p_traj = xs[:, nfe + 1 :].reshape(-1)
    return interface, x_traj, p_traj


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    interface, x, p = main()
    print("p(t) =", p)
