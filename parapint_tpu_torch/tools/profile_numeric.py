"""Drill-down of the ``numeric`` phase (block factor + SC) of the dense
Burgers flagship (counterpart of the JAX package's
``tools/profile_numeric.py``).

    python -m parapint_tpu_torch.tools.profile_numeric [--nfe_x 50]
        [--nfe_t 256] [--blocks 64] [--device cuda|cpu]

On the first-iteration KKT of the flagship on dense blocks
(``SchurComplementSolver`` in W form, float32 factors, cyclic-reduction
coupling: the JAX package's ``burgers_64blocks_cr``), times through
``utils/profile.py::timed_fused`` (best of 5, the launch floor subtracted):

  numeric_total            ``solver.numeric``
  factor_blocks_winv       Ruiz scaling + the batched LDL^T with W
  ldl_factor_winv_batched  the batched LDL^T with W alone
  ldl_factor_batched_only  the batched LDL^T without W
  sc_tiles                 the chain SC contribution in tile form from W
  sc_factor_cr             the cyclic-reduction factorization of the SC
"""

import argparse
import json

import torch

from parapint_tpu_torch.tools.kernel_lab import card_line
from parapint_tpu_torch.tools.profile_bench import MU, add_flagship_args, flagship
from parapint_tpu_torch.utils.device import require_device
from parapint_tpu_torch.utils.profile import dispatch_floor, timed_fused


def main(argv=None) -> dict:
    from parapint_tpu_torch.linalg import schur as S
    from parapint_tpu_torch.linalg.tridiag import BlockTridiag, extract_tridiag
    from parapint_tpu_torch.ops import ldl as L

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_flagship_args(p)
    args = p.parse_args(argv)
    args.device = require_device(args.device)
    card = card_line(args.device)
    print(card, flush=True)

    iface, solver = flagship(args, "dense")
    state = iface.init_state()
    mu = torch.tensor(MU, dtype=torch.float64, device=args.device)
    kkt = iface.assemble_kkt(iface.kkt_from_ad(state, iface.eval_ad(state), mu), 1e-8, 1e-8)
    print(f"diag {tuple(kkt.diag.shape)} {kkt.diag.dtype}, border_loc "
          f"{tuple(kkt.border_loc.shape)}, q {tuple(kkt.q.shape)} [{card}]", flush=True)
    print(f"launch floor {dispatch_floor(device=args.device) * 1e3:.4f} ms (subtracted) [{card}]",
          flush=True)

    bs, f32 = solver.block_size, torch.float32
    times = {}
    _, times["numeric_total"] = timed_fused(solver.numeric, kkt)
    out, times["factor_blocks_winv"] = timed_fused(
        lambda diag, mask: S._factor_blocks_winv(diag, mask, bs, solver.factor_dtype, solver.apply_dtype),
        kkt.diag, kkt.mask,
    )
    W, d, s = out[0], out[1], out[2]
    _, times["ldl_factor_winv_batched"] = timed_fused(
        lambda diag: L.ldl_factor_winv_batched(diag.to(f32), bs), kkt.diag
    )
    _, times["ldl_factor_batched_only"] = timed_fused(
        lambda diag: L.ldl_factor_batched(diag.to(f32), bs), kkt.diag
    )
    nc = kkt.q.shape[-1]
    (dt_c, ut_full), times["sc_tiles"] = timed_fused(
        lambda W, d, s, border: S._sc_tiles_local_winv(W, d, s, border, nc), W, d, s, kkt.border_loc
    )
    ns = kkt.border_loc.shape[1] // 2

    def sc_num(dt_c, ut_full, q):
        q_tri = extract_tridiag(q.to(dt_c.dtype), ns)
        return solver.sc_solver.numeric(
            BlockTridiag(diag=q_tri.diag - dt_c, upper=q_tri.upper - ut_full[:-1])
        )

    _, times["sc_factor_cr"] = timed_fused(sc_num, dt_c, ut_full, kkt.q)

    ms = {k: v * 1e3 for k, v in times.items()}
    print(f"dense flagship {(args.nfe_x, args.nfe_t, args.blocks)} numeric split, ms: "
          f"{json.dumps(ms)} [{card}]", flush=True)
    return ms


if __name__ == "__main__":
    main()
