"""The ``host_syncs`` counter against torch's own report of synchronising
calls, over a traced cold solve (``init_state`` and the fused solve) of a
small Burgers instance on the card, banded and dense.

``torch.cuda.set_sync_debug_mode("warn")`` warns at every call that makes the
host wait for the device (a read to the host, a copy from pageable host
memory, an explicit synchronise).  The two counts are equal, so the counter
misses no site that torch can see.  Needs a CUDA card; skips elsewhere.  On
the card:

    PT_TEST_TPU=1 python -m pytest tests/test_torch_spans_cuda.py -m cuda -q
"""

import warnings

import pytest
import torch

import parapint_tpu_torch as ptt
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.utils import profile as P

pytestmark = pytest.mark.cuda

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _torch_syncs(fn):
    """(fn(), the synchronising calls torch reports while it runs)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


@pytest.mark.parametrize("form", ["banded", "dense"])
def test_host_syncs_count_every_synchronising_call(cuda, form):
    spec = burgers.build_spec(**SHAPE, device=cuda)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form=form
    )
    coupling = ptt.BlockTridiagSolver(ns=iface.ns)
    options = ptt.IPOptions()
    options.linalg.solver = (
        ptt.BandedSchurComplementSolver(schur_complement_solver=coupling)
        if form == "banded" else ptt.SchurComplementSolver(schur_complement_solver=coupling)
    )
    iface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    solve = ptt.make_fused_ip_solve(iface, options)
    solve(iface.init_state())  # warm: kernel builds and first-use work

    def traced_solve():
        with P.tracing() as rec:
            res = solve(iface.init_state())
        return res, rec

    (res, rec), seen = _torch_syncs(traced_solve)
    assert res.status == 0
    assert seen > 0
    assert rec.counters[P.SYNCS] == seen == rec.calls(P.SYNC)
