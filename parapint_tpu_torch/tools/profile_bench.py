"""Per-phase breakdown of one interior-point iteration of the Burgers
flagship (counterpart of the JAX package's ``tools/profile_bench.py``).

    python -m parapint_tpu_torch.tools.profile_bench [--block banded|dense]
        [--nfe_x 50] [--nfe_t 256] [--blocks 64] [--device cuda|cpu]

Times each phase of the iteration alone, from the initial state, through
``utils/profile.py::timed_fused`` (best of 5, each call ending in a scalar
readback of its output, the launch floor subtracted):

  eval_ad          one AD sweep (float32 Hessian/Jacobians, float64 grads)
  convergence      residual norms from the AD bundle
  kkt_rhs_from_ad  KKT data assembly from the AD bundle
  assemble         the block KKT from that data
  numeric          block factorization + SC tiles + SC factorization
  solve            block solves + SC back solve
  step_tail        deltas + fraction-to-the-boundary + apply

then their sum as an upper bound of iterations per second.  ``--block``
picks the flagship's block form and solver: "banded" (the default, as in
``bench.py``) — ``BandedSchurComplementSolver(tile_size=128)`` — or "dense"
— ``SchurComplementSolver`` in W form with cyclic-reduction coupling (the
JAX package's ``burgers_64blocks_cr``).  Both: float32 KKT.
``profile_flagship.py`` at the repository root times the phases inside a
whole solve instead.
"""

import argparse
import json

import torch

from parapint_tpu_torch.tools.kernel_lab import card_line
from parapint_tpu_torch.utils.device import require_device
from parapint_tpu_torch.utils.profile import timed_fused

MU = 0.1


def add_flagship_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--nfe_x", type=int, default=50)
    p.add_argument("--nfe_t", type=int, default=256)
    p.add_argument("--blocks", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def flagship(args, block_form: str):
    """(interface, solver) of the Burgers flagship in ``block_form`` at the
    sizes in ``args``, on ``args.device``."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    spec = burgers.build_spec(nfe_x=args.nfe_x, nfe_t=args.nfe_t,
                              num_time_blocks=args.blocks, device=args.device)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form=block_form
    )
    if block_form == "banded":
        solver = ptt.BandedSchurComplementSolver(
            tile_size=128, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)
        )
    else:
        solver = ptt.SchurComplementSolver(
            block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
            refine_steps=0, schur_complement_solver=ptt.BlockTridiagSolver(),
        )
    return iface, solver


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--block", choices=("banded", "dense"), default="banded")
    add_flagship_args(p)
    args = p.parse_args(argv)
    args.device = require_device(args.device)
    card = card_line(args.device)
    print(card, flush=True)

    iface, solver = flagship(args, args.block)
    state = iface.init_state()
    mu = torch.tensor(MU, dtype=torch.float64, device=args.device)

    times = {}
    ad, times["eval_ad"] = timed_fused(iface.eval_ad, state)
    _, times["convergence"] = timed_fused(
        lambda s, a: iface.convergence_from_ad(s, a, 0.0, 100.0), state, ad
    )
    data, times["kkt_rhs_from_ad"] = timed_fused(
        lambda s, a: iface.kkt_from_ad(s, a, mu), state, ad
    )
    kkt, times["assemble"] = timed_fused(lambda d: iface.assemble_kkt(d, 0.0, 0.0), data)
    fact, times["numeric"] = timed_fused(solver.numeric, kkt)
    sol, times["solve"] = timed_fused(solver.solve, fact, iface.kkt_rhs(data))

    def step_tail(state, sol):
        deltas = iface.extract_deltas(state, sol, mu)
        a_p, a_d = iface.fraction_to_the_boundary(state, deltas, 1.0 - MU)
        return iface.apply_step(state, deltas, a_p, a_d)

    _, times["step_tail"] = timed_fused(step_tail, state, sol)

    ms = {k: v * 1e3 for k, v in times.items()}
    total = sum(times.values())
    print(f"{args.block} flagship {(args.nfe_x, args.nfe_t, args.blocks)}: phase ms "
          f"{json.dumps(ms)} [{card}]", flush=True)
    print(f"total {total * 1e3:.4f} ms/iter -> {1.0 / max(total, 1e-12):.4f} iter/s upper bound [{card}]", flush=True)
    return ms


if __name__ == "__main__":
    main()
