"""The Burgers distributed-control NLP as a user of the port writes it: model
callbacks in torch, handed to ``parapint_tpu_torch.DynamicModelSpec``.

1D viscous Burgers optimal control (reference parapint
examples/burgers.py:53-287), discretized backward in time and central in
space, the horizon split into time blocks coupled through the interior y
values at block boundaries:

    min  0.5 * int int ((y - y0)^2 + omega u^2) dx dt  (+ per-block t0 term)
    s.t. dy/dt - v d2y/dx2 + y dy/dx = r + u(x, t - dt)
         y = u = 0 at x in {0, 1};   y(x, 0) = y0(x), u(x, 0) = 0

Every size, index set and mask is that of the port's
``examples/burgers.py::build_spec``.  The instance's data is the tracking
profile y0, which is also the initial condition: a member of the
configuration's ``profile_family`` of step functions: a fixed set that every
run times (:func:`instances`) and one member that a run's seed draws and
solves once after the window (:func:`drawn`).  :func:`build_interface` hands
a member to the port as a ``DynamicSchurComplementInteriorPointInterface``.
"""

import numpy as np

# the configuration's sizes cut to what a test process holds on the CPU
TINY = dict(nfe_x=8, nfe_t=16, num_time_blocks=4)


def step_profile(nfe_x: int, height: float, edge: float) -> np.ndarray:
    """y0 on the nfe_x + 1 grid points of [0, 1]: ``height`` where x <= edge,
    0 elsewhere (height 1, edge 0.5 is the reference's own profile)."""
    x = (1.0 / nfe_x) * np.arange(nfe_x + 1)
    return np.where(x <= edge, height, 0.0)


def _draw(fam: dict, rng) -> dict:
    return {"height": float(rng.uniform(*fam["height"])), "edge": float(rng.uniform(*fam["edge"]))}


def _member(config: dict, m: dict) -> dict:
    return {**m, "y0": step_profile(config["nfe_x"], m["height"], m["edge"])}


def instances(config: dict) -> list:
    """The configuration's fixed set of instances: member 0 is the family's
    ``first`` profile, the others are drawn from its ranges by a generator
    seeded with the family's ``set_seed``.  Each is {"height", "edge", "y0"}.
    Every run times this set, a run's seed only ordering the solves, so every
    seed does the same timed work."""
    fam = config["profile_family"]
    rng = np.random.default_rng(fam["set_seed"])
    members = [dict(fam["first"])] + [_draw(fam, rng) for _ in range(fam["members"] - 1)]
    return [_member(config, m) for m in members]


def drawn(config: dict, seed: int) -> dict:
    """The member of the family that ``seed`` draws: the ``first`` profile
    for seed 0, else one drawn from the ranges by a generator of ``seed``."""
    fam = config["profile_family"]
    if seed == 0:
        return _member(config, dict(fam["first"]))
    return _member(config, _draw(fam, np.random.default_rng([abs(int(seed)), 1])))


def member_params(member: dict) -> dict:
    """The numbers that name a member in the result line."""
    return {"height": member["height"], "edge": member["edge"]}


def build_interface(config: dict, member: dict, traffic: dict, device):
    """The port's dynamic interface over ``member``'s profile, in the
    configuration's KKT precision and the traffic's block form."""
    import torch

    import parapint_tpu_torch as ptt

    spec = build_spec(config, member["y0"], device)
    return ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=getattr(torch, config["kkt_dtype"]), block_form=traffic["block_form"],
    )


def build_spec(config: dict, y0: np.ndarray, device):
    """The DynamicModelSpec of ``config``'s sizes with tracking profile ``y0``."""
    import torch

    from parapint_tpu_torch import DynamicModelSpec

    N = config["num_time_blocks"]
    nx = config["nfe_x"]
    nfe_t = config["nfe_t"]
    omega, visc, r = config["omega"], config["v"], config["r"]
    if nfe_t % N != 0:
        raise ValueError("nfe_t must be a multiple of num_time_blocks")
    nt = nfe_t // N
    dt = (config["end_t"] - config["start_t"]) / nfe_t
    dx = 1.0 / nx
    npts = nx + 1
    n_y = (nt + 1) * npts
    n = 2 * n_y  # y then u, each (nt+1, npts) row-major (t, x)

    wx = np.full(npts, dx)
    wx[0] = wx[-1] = 0.5 * dx
    wt = np.full(nt + 1, dt)
    wt[0] = wt[-1] = 0.5 * dt
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    y0_profile, wx_t, wt_t = f64(y0), f64(wx), f64(wt)

    def split(vec):
        return vec[:n_y].reshape(nt + 1, npts), vec[n_y:].reshape(nt + 1, npts)

    def objective(vec, p):
        y, u = split(vec)
        integrand = (y - y0_profile[None, :]) ** 2 + omega * u**2
        obj = 0.5 * (wt_t * (integrand @ wx_t)).sum()
        return obj + 0.25 * dx * dt * omega * (u[0, 1:nx] ** 2).sum()

    def eq_constraints(vec, p):
        y, u = split(vec)
        bc = torch.cat([y[:, 0], y[:, nx], u[:, 0], u[:, nx]])
        init = torch.cat([y[0, 1:nx] - y0_profile[1:nx], u[0, 1:nx]])
        y_c = y[1:, 1:nx]
        y_m = y[:-1, 1:nx]
        y_xp = y[1:, 2:]
        y_xm = y[1:, : nx - 1]
        u_lag = u[:-1, 1:nx]
        pde = (
            (y_c - y_m) / dt
            - visc * (y_xp - 2.0 * y_c + y_xm) / dx**2
            + y_c * (y_xp - y_xm) / (2.0 * dx)
            - r
            - u_lag
        )
        return torch.cat([bc, init, pde.reshape(-1)])

    me = 4 * (nt + 1) + 2 * (nx - 1) + nt * (nx - 1)
    eq_mask = np.ones((N, me), dtype=bool)
    # the initial-condition rows exist only in time block 0
    eq_mask[1:, 4 * (nt + 1) : 4 * (nt + 1) + 2 * (nx - 1)] = False

    x0 = np.zeros((N, n))
    x0[:, :n_y] = np.tile(y0, nt + 1)

    interior = np.arange(1, nx)
    return DynamicModelSpec(
        num_blocks=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={"t0": dt * nt * np.arange(N, dtype=np.float64)},
        x0=x0,
        eq_mask=eq_mask,
        start_state_idx=interior,
        end_state_idx=nt * npts + interior,
        device=device,
    )
