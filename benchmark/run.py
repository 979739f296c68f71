"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; the numbers the check compared come last, under
``checks``, and again as the last lines of standard error.  Exits non-zero
without a result when CUDA is missing or has fewer cards than the cell asks
for, and when the process holds JAX or the JAX package once the window has
closed.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "parapint_tpu_torch", "_build")

# every cache at a fixed path inside the checkout, set before anything is
# imported: the bytecode of torch and the port (the card's host keeps none),
# and the caches of any Triton or torch extension build
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(BUILD, "pycache")
PYCACHE_WARM = os.path.isdir(sys.pycache_prefix)  # else this run fills it
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    p.add_argument("--seed", type=int, required=True,
                   help="orders the timed solves and draws one more instance, judged after the window")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START, PYCACHE_WARM)
    held = harness.jax_modules()
    if held:
        print(f"benchmark: the process holds {held} after the window", file=sys.stderr)
        return 1
    if result["setup_first_in_checkout"]:
        print("benchmark: the first run in this checkout (setup_s includes the kernel "
              "build and the bytecode cache)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
