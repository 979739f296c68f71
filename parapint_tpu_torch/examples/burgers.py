"""Burgers PDE optimal control — the flagship example, model in torch
(counterpart of ``parapint_tpu.examples.burgers``).

1D viscous Burgers distributed control (reference
parapint/examples/burgers.py:53-287),

    min  0.5 * int int ((y - y0)^2 + omega u^2) dx dt  (+ per-block t0 term)
    s.t. dy/dt - v d2y/dx2 + y dy/dx = r + u(x, t - dt)
         y = u = 0 at x in {0, 1};   y(x, 0) = y0(x), u(x, 0) = 0

discretized backward in time / central in space, with the horizon split
into blocks coupled through the interior y values at block boundaries.
"""

import numpy as np
import torch

from parapint_tpu_torch.interfaces.dynamic import DynamicModelSpec
from parapint_tpu_torch.utils.device import require_device

OMEGA = 0.02
V = 0.01
R = 0.0


def build_spec(
    nfe_x: int = 50,
    nfe_t: int = 200,
    num_time_blocks: int = 4,
    start_t: float = 0.0,
    end_t: float = 1.0,
    device="cuda",
) -> DynamicModelSpec:
    """The Burgers model family on ``device`` (the card by default; raises
    without CUDA — pass ``device="cpu"`` for a CPU run)."""
    device = require_device(device)
    if nfe_t % num_time_blocks != 0:
        raise ValueError("nfe_t must be a multiple of num_time_blocks")
    N = num_time_blocks
    nx = nfe_x  # space intervals; nx+1 grid points
    nt = nfe_t // N  # time steps per block; nt+1 local time points
    dt = (end_t - start_t) / nfe_t
    dx = 1.0 / nx
    npts = nx + 1
    n_y = (nt + 1) * npts
    n = 2 * n_y  # y then u, each (nt+1, npts) row-major (t, x)

    x_grid = dx * np.arange(npts)
    y0_np = (x_grid <= 0.5).astype(np.float64)
    wx = np.full(npts, dx)
    wx[0] = wx[-1] = 0.5 * dx
    wt = np.full(nt + 1, dt)
    wt[0] = wt[-1] = 0.5 * dt
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    y0_profile, wx, wt = f64(y0_np), f64(wx), f64(wt)

    def split(vec):
        y = vec[:n_y].reshape(nt + 1, npts)
        u = vec[n_y:].reshape(nt + 1, npts)
        return y, u

    def objective(vec, p):
        y, u = split(vec)
        integrand = (y - y0_profile[None, :]) ** 2 + OMEGA * u**2
        obj = 0.5 * (wt * (integrand @ wx)).sum()
        # per-block t0 control term (reference burgers.py:158-165)
        return obj + 0.25 * dx * dt * OMEGA * (u[0, 1:nx] ** 2).sum()

    def eq_constraints(vec, p):
        y, u = split(vec)
        bc = torch.cat([y[:, 0], y[:, nx], u[:, 0], u[:, nx]])
        init = torch.cat([y[0, 1:nx] - y0_profile[1:nx], u[0, 1:nx]])
        # PDE rows for t = 1..nt, x = 1..nx-1 (backward Euler in t, central
        # in x; u lagged one time step, reference burgers.py:127-136)
        y_c = y[1:, 1:nx]
        y_m = y[:-1, 1:nx]
        y_xp = y[1:, 2:]
        y_xm = y[1:, : nx - 1]
        u_lag = u[:-1, 1:nx]
        pde = (
            (y_c - y_m) / dt
            - V * (y_xp - 2.0 * y_c + y_xm) / dx**2
            + y_c * (y_xp - y_xm) / (2.0 * dx)
            - R
            - u_lag
        )
        return torch.cat([bc, init, pde.reshape(-1)])

    me = 4 * (nt + 1) + 2 * (nx - 1) + nt * (nx - 1)
    eq_mask = np.ones((N, me), dtype=bool)
    # init-condition rows exist only in time block 0
    eq_mask[1:, 4 * (nt + 1) : 4 * (nt + 1) + 2 * (nx - 1)] = False

    # initial guess: y = y0 profile at all times, u = 0
    x0 = np.zeros((N, n))
    x0[:, :n_y] = np.tile(y0_np, nt + 1)

    interior = np.arange(1, nx)
    return DynamicModelSpec(
        num_blocks=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={"t0": dt * nt * np.arange(N, dtype=np.float64)},
        x0=x0,
        eq_mask=eq_mask,
        start_state_idx=interior,  # y[., t0_local] interior values
        end_state_idx=nt * npts + interior,
        device=device,
    )


def main(
    nfe_x: int = 50,
    nfe_t: int = 200,
    num_time_blocks: int = 4,
    linear_solver=None,
    mesh=None,
    options=None,
    block_form: str = "dense",
    device="cuda",
):
    """Solve through ``ip_solve``.  ``block_form="banded"`` routes the
    per-block KKTs through the banded factorization (O(nk * bandwidth)
    memory per block), which the reference's ``--nfe_x`` beyond ~100 needs
    (reference burgers.py:14-20).  ``mesh``: the interface's (each rank
    evaluates its own blocks); the default solver stays the serial one,
    which gathers the rank-local KKT whole on every rank."""
    import parapint_tpu_torch as ptt

    spec = build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=num_time_blocks, device=device)
    interface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, mesh=mesh, block_form=block_form
    )
    if options is None:
        options = ptt.IPOptions()
    if linear_solver is not None:
        options.linalg.solver = linear_solver
    elif block_form == "banded":
        options.linalg.solver = ptt.BandedSchurComplementSolver(
            schur_complement_solver=ptt.BlockTridiagSolver(ns=interface.ns)
        )
    else:
        options.linalg.solver = ptt.SchurComplementSolver(block_size=128)
    status = ptt.ip_solve(interface, options)
    if status != ptt.InteriorPointStatus.optimal:
        raise RuntimeError(f"burgers: ip_solve ended with {status}")
    return interface


if __name__ == "__main__":
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--nfe_x", type=int, default=50)
    parser.add_argument("--nfe_t", type=int, default=200)
    parser.add_argument("--nblocks", type=int, default=4)
    parser.add_argument("--block_form", choices=("dense", "banded"), default="dense")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    iface = main(args.nfe_x, args.nfe_t, args.nblocks, block_form=args.block_form, device=args.device)
    print("objective:", float(iface.evaluate_objective()))
