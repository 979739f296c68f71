"""The benchmark of parapint_tpu_torch: ``python3 benchmark/run.py --help``."""
