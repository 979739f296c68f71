"""The port's card scripts at the repository root: they import no JAX, and
the one-ulp perturbation of ``bf16_rounding.py`` moves each entry by at
most one float32 ulp, leaving zeros and a unit diagonal exact."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ["chip_smoke.py", "profile_flagship.py", "bf16_rounding.py"]

sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

from test_torch_imports import FORBIDDEN, _imported_roots  # noqa: E402


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_no_jax(name):
    bad = sorted(set(_imported_roots(ROOT / name)) & set(FORBIDDEN))
    assert not bad, f"{name} imports {bad}"


@pytest.mark.parametrize("unit_diag", [False, True])
def test_nudge_moves_each_entry_by_at_most_one_ulp(unit_diag):
    import bf16_rounding

    rng = np.random.default_rng(0)
    X = torch.as_tensor(np.tril(rng.standard_normal((3, 16, 16)), -1) + np.eye(16),
                        dtype=torch.float32)
    Y = bf16_rounding._nudge(X, torch.Generator().manual_seed(1), unit_diag)
    up, down = torch.nextafter(X, X + 1), torch.nextafter(X, X - 1)
    assert bool(((Y == X) | (Y == up) | (Y == down)).all())
    assert bool((Y[X == 0] == 0).all())
    assert int((Y != X).sum()) > X.numel() // 4  # about 2/3 of the nonzeros move
    if unit_diag:
        assert torch.equal(torch.diagonal(Y, dim1=1, dim2=2), torch.ones(3, 16))


def test_bf16_rounding_runs_on_the_cpu():
    """``bf16_rounding.py``'s ulp witness at the ``entry()`` shape on the
    CPU (its ``--device cpu`` path): the probe wrapper of its traced solves
    takes the solver's process-group argument (it raised a ``TypeError``
    since the sharded solvers added it), every witness solve is optimal and
    the tally holds one run per solver and seed."""
    import bf16_rounding
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    spec = burgers.build_spec(nfe_x=8, nfe_t=8, num_time_blocks=4, device="cpu")
    iface = ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=torch.float32)
    tally = bf16_rounding.witness(iface, 1)
    assert {k: [st for st, *_ in v] for k, v in tally.items()} == {
        "bf16 W": ["optimal"], "f32 W": ["optimal"]}
