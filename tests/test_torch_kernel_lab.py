"""The port's measurement tools on the CPU at tiny sizes: the kernel lab's six
subcommands, ``profile_numeric`` and ``profile_bench`` at the ``entry()``
shape (nfe_x=8, nfe_t=8, 4 blocks).  On the CPU every kernel wrapper takes
its plain version, so these check the tools' control flow, their output
lines and the panel entries' agreement with ``_ldl_unblocked``; the times
they print are CPU times."""

import pytest
import torch

from parapint_tpu_torch.tools import kernel_lab, profile_bench, profile_numeric

torch.set_num_threads(1)

TINY = {
    "panels": ["--B", "2", "--b", "16"],
    "factor": ["--B", "2", "--n", "32"],
    "mxu": ["--B", "2", "--n", "16"],
    "solve": ["--B", "2", "--n", "32"],
    "bw": ["--B", "2", "--n", "16", "--rows", "4", "64"],
    "dispatch": [],
}
LINES = {"panels": 4, "factor": 4, "mxu": 3, "solve": 4, "bw": 3, "dispatch": 1}
ENTRY = ["--nfe_x", "8", "--nfe_t", "8", "--blocks", "4", "--device", "cpu"]


@pytest.mark.parametrize("cmd", list(TINY))
def test_subcommand_prints_its_lines(cmd, capsys):
    out = kernel_lab.main([cmd, *TINY[cmd], "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert len(lines) == 1 + LINES[cmd]
    assert all(line.endswith("[cpu]") for line in lines[1:])
    assert out


def test_panels_agree_with_the_unblocked_sweep():
    out = kernel_lab.main(["panels", "--B", "3", "--b", "24", "--device", "cpu"])
    assert set(out) == {"column", "column_winv", "slab", "slab_winv"}
    assert all(r["rel_err"] <= 1e-6 for r in out.values())


def test_mxu_restores_the_precision_policy():
    kernel_lab.main(["mxu", *TINY["mxu"], "--device", "cpu"])
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_bw_reports_each_rows_per_cta():
    out = kernel_lab.main(["bw", *TINY["bw"], "--device", "cpu"])
    assert set(out["rows"]) == {4, 64}
    assert out["shape"] == (2, 16, 16) and out["bound_ms"] > 0.0


@pytest.mark.parametrize("tool", ["lab", "profile_numeric", "profile_bench"])
def test_card_device_requires_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"lab": lambda: kernel_lab.main(["bw", "--B", "2", "--n", "16"]),
            "profile_numeric": lambda: profile_numeric.main([]),
            "profile_bench": lambda: profile_bench.main([])}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()


def test_profile_numeric_reports_the_six_keys(capsys):
    ms = profile_numeric.main(ENTRY)
    assert list(ms) == ["numeric_total", "factor_blocks_winv", "ldl_factor_winv_batched",
                        "ldl_factor_batched_only", "sc_tiles", "sc_factor_cr"]
    assert all(v >= 0.0 for v in ms.values())
    assert capsys.readouterr().out.splitlines()[-1].endswith("[cpu]")


@pytest.mark.parametrize("block", ["banded", "dense"])
def test_profile_bench_reports_seven_phases(block, capsys):
    ms = profile_bench.main(["--block", block, *ENTRY])
    assert list(ms) == ["eval_ad", "convergence", "kkt_rhs_from_ad", "assemble", "numeric",
                        "solve", "step_tail"]
    assert all(v >= 0.0 for v in ms.values())
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("total ") and "iter/s upper bound" in last
