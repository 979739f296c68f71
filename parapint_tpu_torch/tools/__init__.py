"""Measurement tools of the port, run as modules:

    python -m parapint_tpu_torch.tools.kernel_lab <cmd> [--device cuda|cpu] [...]
    python -m parapint_tpu_torch.tools.profile_numeric [--device cuda|cpu] [...]
    python -m parapint_tpu_torch.tools.profile_bench [--block banded|dense] [--device cuda|cpu] [...]

Each runs on the card unless given ``--device cpu``.
"""
