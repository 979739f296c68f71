"""The plain reference against the program at a tiny size on the CPU, its
control (the reference in float32, below the configuration's float64) at
a tiny size here and at the cells' own sizes on the card."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.burgers import NLP

CONFIGS = sorted((harness.BENCH_DIR / "configs").glob("*.json"))


def _tiny(conftest_sizes=dict(nfe_x=8, nfe_t=16, num_time_blocks=4)):
    cfg = json.loads(CONFIGS[0].read_text())
    cfg.update(conftest_sizes)
    return cfg


def test_member_zero_is_the_reference_profile():
    from benchmark.models import burgers as model
    from parapint_tpu_torch.examples import burgers as example

    cfg = _tiny()
    first = model.instances(cfg)[0]
    ours = model.build_spec(cfg, first["y0"], "cpu")
    theirs = example.build_spec(nfe_x=8, nfe_t=16, num_time_blocks=4, device="cpu")
    assert torch.equal(ours.x0, theirs.x0)
    assert (ours.eq_mask == theirs.eq_mask).all()
    assert (ours.start_state_idx == theirs.start_state_idx).all()
    x = theirs.x0[1]
    assert torch.equal(ours.eq_constraints(x, {}), theirs.eq_constraints(x, {}))
    assert torch.equal(ours.objective(x, {}), theirs.objective(x, {}))


def test_instances_are_fixed_and_distinct():
    from benchmark.models import burgers as model

    a, b = model.instances(_tiny()), model.instances(_tiny())
    assert len(a) == 4
    assert all(np.array_equal(x["y0"], y["y0"]) for x, y in zip(a, b))
    assert len({(m["height"], m["edge"]) for m in a}) == 4


def test_seed_draws_one_member_of_the_family():
    from benchmark.models import burgers as model

    cfg, fam = _tiny(), _tiny()["profile_family"]
    assert np.array_equal(model.drawn(cfg, 0)["y0"], model.instances(cfg)[0]["y0"])
    seeds = [1, 2, 2**31 + 7, 4_000_000_001, -5]
    a = [model.drawn(cfg, s) for s in seeds]
    assert all(np.array_equal(x["y0"], model.drawn(cfg, s)["y0"]) for x, s in zip(a, seeds))
    assert len({(m["height"], m["edge"]) for m in a}) == len(seeds)
    for m in a:
        assert fam["height"][0] <= m["height"] <= fam["height"][1]
        assert fam["edge"][0] <= m["edge"] <= fam["edge"][1]


@pytest.mark.parametrize("block_form", ["dense", "banded"])
def test_certificate_and_solution_agree_with_the_program(tiny_cell, block_form):
    cell = tiny_cell(mix="dense_cr" if block_form == "dense" else None)
    inst = harness.build_instances(cell, torch.device("cpu"))[1]
    res = inst.solve(inst.interface.init_state())
    assert res.status == 0
    st = res.state
    ref = NLP(cell.config, inst.data["y0"])
    cert = ref.certificate(st.primals["blocks"], st.primals["coupling"], st.duals_eq["own"],
                           st.duals_eq["link"])
    # the program's own convergence numbers, computed alike in float64
    assert cert["primal_inf"] == pytest.approx(float(res.primal_inf), rel=1e-6, abs=1e-16)
    assert cert["dual_inf"] == pytest.approx(float(res.dual_inf), rel=1e-6, abs=1e-16)
    assert cert["kkt_error"] <= cell.config["tol"]
    own = ref.solve(cell.config["tol"])
    assert own["status"] == "optimal"
    assert (st.primals["blocks"] - own["x"]).abs().max() < 1e-6
    assert cert["objective"] == pytest.approx(own["cert"]["objective"], rel=1e-9)


def test_control_fails_at_a_tiny_size():
    cfg = _tiny()
    for m in __import__("benchmark.models.burgers", fromlist=["x"]).instances(cfg):
        judge = NLP(cfg, m["y0"])
        ok = judge.solve(cfg["tol"])
        assert ok["status"] == "optimal" and ok["cert"]["kkt_error"] <= cfg["tol"]
        c = NLP(cfg, m["y0"], dtype=torch.float32).solve(cfg["tol"])
        reading = judge.certificate(c["x"], c["c"], c["y"], c["lam"])["kkt_error"]
        assert c["status"] == "error" and reading > 10 * cfg["tol"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_control_fails_at_full_size(path):
    """On the card: the float32 reference, judged in float64 on the host,
    misses the configuration's tol on every member of the fixed set and on
    the members three seeds draw; the float64 one meets it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.models import burgers as model

    cfg = json.loads(path.read_text())
    members = model.instances(cfg) + [model.drawn(cfg, s) for s in (2**31 + 1, 2**31 + 2, 2**31 + 3)]
    for k, m in enumerate(members):
        judge = NLP(cfg, m["y0"])
        readings = {}
        for dtype in (torch.float64, torch.float32):
            sol = NLP(cfg, m["y0"], dtype=dtype, device="cuda").solve(cfg["tol"])
            readings[str(dtype)] = (sol["status"], sol["iterations"],
                                    judge.certificate(sol["x"].cpu(), sol["c"].cpu(), sol["y"].cpu(),
                                                      sol["lam"].cpu())["kkt_error"])
            del sol
            torch.cuda.empty_cache()
        print(f"control {cfg['name']} member {k}: {readings}", flush=True)
        assert readings["torch.float64"][0] == "optimal"
        assert readings["torch.float64"][2] <= cfg["tol"]
        assert readings["torch.float32"][2] > cfg["tol"]
