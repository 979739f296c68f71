"""The program's own spans and host-sync counter over a cell of the
benchmark, on one CUDA card.

    python3 profile_spans.py --workload <cell> --seed <n> [--cycles <k>]

Builds the cell's fixed set through ``benchmark/harness.py``, warms it up,
then runs ``--cycles`` whole cycles of the set (one cold solve of each
member, in an order drawn from ``--seed``) inside
``utils/profile.py::tracing``, with no profiler.  Prints the card's name
and power limit, then one JSON line: per span name its calls, total and
self seconds, the counters, the ten spans with the most self seconds a
cycle, and the four readings a ``host_syncs_per_iter``,
``sync_wait_ms_per_iter``, ``ad_kkt_host_ms_per_iter`` and
``numeric_host_ms`` metric would take.  Every solve is judged by the plain
reference like the benchmark's; exits 1 where one fails the check.

This is the benchmark's phase E run by hand until the benchmark takes the
four readings itself (PERF.md, Open questions); it goes once it does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

AD_KKT = ("iface.eval_ad", "iface.convergence_from_ad", "iface.kkt_from_ad", "iface.assemble_kkt")
NUMERIC = ("banded_sc.numeric", "sc_solver.numeric")
TOP = 10


def readings(rec, iterations: int) -> dict:
    """The four per-layer readings of one traced stretch of solves."""
    from parapint_tpu_torch.utils import profile as P

    summary = rec.summary()
    numerics = sum(rec.calls(n) for n in NUMERIC)
    return {
        "host_syncs_per_iter": rec.counters[P.SYNCS] / iterations,
        "sync_wait_ms_per_iter": 1e3 * summary.get(P.SYNC, (0, 0.0, 0.0))[1] / iterations,
        "ad_kkt_host_ms_per_iter": 1e3 * rec.host_seconds(AD_KKT) / iterations,
        "numeric_host_ms": 1e3 * rec.host_seconds(NUMERIC) / numerics if numerics else None,
    }


def run(cell, seed: int, cycles: int, device) -> dict:
    """``cycles`` traced cycles of ``cell``'s fixed set; the result object."""
    import numpy as np

    from benchmark import harness
    from parapint_tpu_torch.utils import profile as P

    rng = np.random.default_rng(abs(seed))
    instances = harness.build_instances(cell, device)
    for k, inst in enumerate(instances):
        harness.solve_once(inst, k, device, keep_answer=False)

    solves, seconds = [], 0.0
    with P.tracing() as rec:
        for _ in range(cycles):
            out, s = harness.closed_loop(instances, rng, 0, device)
            solves += out
            seconds += s
    iterations = sum(s.iterations for s in solves)
    summary = rec.summary()
    host_self = sorted(((k, v[2] / cycles) for k, v in summary.items()), key=lambda kv: -kv[1])[:TOP]
    verdict = harness.judge(cell, [inst.data for inst in instances], solves)
    return {
        "workload": cell.name, "seed": seed, "card": harness.card_info(device),
        "correct": verdict["failed"] == 0, "solves": len(solves), "checks": verdict["checks"],
        "iterations": iterations, "cycle_s": seconds / cycles,
        "readings": readings(rec, iterations), "counters": dict(rec.counters),
        "host_self_s": [[k, v] for k, v in host_self],
        "spans": {k: list(v) for k, v in sorted(summary.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cycles", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("profile_spans: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = run(harness.load_cell(args.workload), args.seed, args.cycles, device)
    print(f"card: {out['card']['kind']}, power limit {out['card']['power_limit']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    t = time.perf_counter()
    rc = main()
    print(f"profile_spans: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    sys.exit(rc)
