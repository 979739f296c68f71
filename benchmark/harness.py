"""One run of one cell: find its files by name, build its fixed set of
instances on the card, warm up, measure a closed loop of cold solves, solve
once more the member the seed draws, judge every answer with the plain
reference, and print the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

- the configuration: the ``file`` its entry names, whose ``model`` names
  ``models/<model>.py`` (the user's model code: ``instances(config)``,
  ``drawn(config, seed)``, ``build_interface(config, member, traffic,
  device)``, ``member_params(member)`` and ``TINY``) and
  ``reference/<model>.py`` (the plain reference: ``NLP(config, member,
  dtype, device)`` with ``certificate(answer)``, and ``ANSWER``, the leaves
  of the returned iterate that it judges);
- the traffic mix: ``traffic/<traffic>.json``, read by :func:`make_solver`
  and :func:`closed_loop`;
- each per-layer metric: ``metrics/<metric>.py`` (see ``metrics/__init__.py``).

A member is opaque here: the model module makes it and the reference reads
it, so nothing in this file knows one interface or model from another.
"""

import dataclasses
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import trace, yardstick

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
GIB = 2.0**30
# the top-level module names the program's process must not hold
JAX_NAMES = ("jax", "jaxlib", "flax", "parapint_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``spec_path`` with its configuration and mix."""
    spec = json.loads(Path(spec_path).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"], config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def model_module(config: dict):
    return importlib.import_module(f"benchmark.models.{config['model']}")


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['model']}")


# -- the solver a traffic mix names ------------------------------------------------


def _dtype(name: str):
    import torch

    return getattr(torch, name)


def build_object(desc: dict, interface):
    """A solver from its description: {"class": name in parapint_tpu_torch,
    "kwargs": {...}}; a nested description builds an object, "$ns" is the
    interface's number of coupling states, "float32"/"float64" are dtypes."""
    import parapint_tpu_torch as ptt

    def value(v):
        if isinstance(v, dict) and "class" in v:
            return build_object(v, interface)
        if v == "$ns":
            return interface.ns
        if isinstance(v, str) and v.startswith("float"):
            return _dtype(v)
        return v

    return getattr(ptt, desc["class"])(**{k: value(v) for k, v in desc.get("kwargs", {}).items()})


def make_solver(traffic: dict, interface):
    return build_object(traffic["solver"], interface)


@dataclasses.dataclass
class Instance:
    """One member of the configuration's set: its data, the program's
    interface, solver and solve function built on it, and the leaves of the
    returned iterate that the reference judges (its ``ANSWER``)."""

    data: dict
    interface: object
    solver: object
    solve: object
    answer: tuple


def build_instance(cell: Cell, data: dict, device) -> Instance:
    """The program's interface, solver and solve function for one member's
    data, on ``device``, through the program's public API."""
    import parapint_tpu_torch as ptt

    iface = model_module(cell.config).build_interface(cell.config, data, cell.traffic, device)
    options = ptt.IPOptions()
    options.tol = cell.config["tol"]
    options.max_iter = cell.traffic["max_iter"]
    options.linalg.solver = make_solver(cell.traffic, iface)
    solve = ptt.make_fused_ip_solve(iface, options)
    iface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    return Instance(data=data, interface=iface, solver=options.linalg.solver, solve=solve,
                    answer=reference_module(cell.config).ANSWER)


def build_instances(cell: Cell, device) -> list:
    """Every member of the configuration's fixed set, on ``device``."""
    return [build_instance(cell, data, device) for data in model_module(cell.config).instances(cell.config)]


# -- the closed loop ---------------------------------------------------------------


@dataclasses.dataclass
class Solve:
    member: int
    seconds: float
    iterations: int
    status: int
    answer: dict  # the returned iterate on the host


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_once(inst: Instance, k: int, device, keep_answer: bool) -> Solve:
    """One cold solve from ``init_state()``, timed to the card's finish."""
    t = time.perf_counter()
    res = inst.solve(inst.interface.init_state())
    sync(device)
    dt = time.perf_counter() - t
    answer = None
    if keep_answer:
        answer = {leaf: leaf_of(res.state, leaf).cpu() for leaf in inst.answer}
    return Solve(k, dt, int(res.iterations), int(res.status), answer)


def leaf_of(state, leaf):
    """The tensor that ``leaf``, a (field, key-or-None) pair of a reference's
    ``ANSWER``, names in ``state``."""
    field, key = leaf
    value = getattr(state, field)
    return value if key is None else value[key]


def closed_loop(instances, rng, seconds: float, device):
    """One caller re-solving the set: each cycle solves every member once, in
    an order drawn from ``rng``, the next solve starting when the last has
    finished.  Runs whole cycles, at least one, until ``seconds`` have
    passed.  Returns (solves, window seconds)."""
    solves = []
    t0 = time.perf_counter()
    while not solves or time.perf_counter() - t0 < seconds:
        for k in rng.permutation(len(instances)):
            solves.append(solve_once(instances[k], int(k), device, keep_answer=True))
    return solves, time.perf_counter() - t0


# -- the card ----------------------------------------------------------------------


def card_info(device) -> dict:
    """{"kind", "power_limit"} of the card (``nvidia-smi``)."""
    import torch

    info = {"kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "power_limit": "unknown"}
    if device.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 f"--id={device.index or 0}"],
                capture_output=True, text=True, timeout=30,
            )
            if out.returncode == 0 and out.stdout.strip():
                info["power_limit"] = out.stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            pass
    return info


def jax_modules() -> list:
    """JAX or the JAX package in ``sys.modules``, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in JAX_NAMES})


# -- the check -----------------------------------------------------------------------


def judge(cell: Cell, instances_data: list, solves: list) -> dict:
    """Every answer judged by the plain reference in float64 on the host:
    status and the optimality certificate's kkt_error against the
    configuration's tol.  Returns the compared numbers with their limits."""
    import torch

    ref_mod = reference_module(cell.config)
    refs = [ref_mod.NLP(cell.config, d, dtype=torch.float64, device="cpu") for d in instances_data]
    tol = cell.config["tol"]
    worst, non_optimal, failed = 0.0, 0, 0
    for s in solves:
        cert = refs[s.member].certificate(s.answer)
        bad = s.status != 0 or not cert["kkt_error"] <= tol
        non_optimal += s.status != 0
        failed += bad
        worst = max(worst, cert["kkt_error"]) if np.isfinite(cert["kkt_error"]) else float("inf")
    return {
        "failed": failed,
        "checks": {
            "non_optimal": {"value": non_optimal, "limit": 0},
            "kkt_error_max": {"value": worst, "limit": tol},
        },
    }


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def first_in_checkout(pycache_warm: bool) -> bool:
    """Whether this run built the program's kernels or filled the bytecode
    cache: the first run in a checkout, whose ``setup_s`` includes that."""
    from parapint_tpu_torch.ops import cuda_build

    return bool(cuda_build.build_logs) or not pycache_warm


# -- one run -------------------------------------------------------------------------


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        pycache_warm: bool = True) -> dict:
    """One run of ``cell``; returns the result object (the caller prints it).
    ``pycache_warm``: whether the bytecode cache existed at process start."""
    import torch

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the allocator's stats exist from here
        torch.cuda.reset_peak_memory_stats(device)
    card = card_info(device)
    rng = np.random.default_rng(abs(int(seed)))

    instances = build_instances(cell, device)
    for k, inst in enumerate(instances):  # warm: every member, its own shapes
        solve_once(inst, k, device, keep_answer=False)
    setup_s = time.perf_counter() - t_start

    if traced:
        solves, window_s, layer = trace.traced_window(cell, instances, rng, seconds, device)
    else:
        solves, window_s = closed_loop(instances, rng, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    data = [inst.data for inst in instances]
    del instances
    free(device)
    # the member the seed draws from the family: solved once, judged with the
    # window's solves, in none of the timed metrics
    extra = build_instance(cell, model_module(cell.config).drawn(cell.config, seed), device)
    drawn = solve_once(extra, len(data), device, keep_answer=True)
    data.append(extra.data)
    del extra
    free(device)

    verdict = judge(cell, data, solves + [drawn])
    times = [s.seconds for s in solves]
    iters = [s.iterations for s in solves]
    if traced:
        metrics = {m["name"]: {"value": layer[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if layer.get(m["name"]) is not None}
    else:
        e2e = {
            "solve_s": window_s / len(solves),
            "solve_s_p90": yardstick.percentile(times, 90),
            "iters_per_s": sum(iters) / window_s,
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result = {
        "correct": verdict["failed"] == 0 and len(solves) > 0,
        "attempted": len(solves) + 1,
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": card["kind"], "count": cell.chips, "memory_peak_bytes": int(peak),
        },
        "power_limit": card["power_limit"],
        "window_s": window_s,
        "iterations": {"min": min(iters), "median": statistics.median(iters), "max": max(iters),
                       "per_member": _per_member(solves)},
        "solve_seconds": times,
        "drawn": {**model_module(cell.config).member_params(data[-1]),
                  "iterations": drawn.iterations, "status": drawn.status},
        "setup_first_in_checkout": first_in_checkout(pycache_warm),
    }
    if traced:
        result["device"].update(busy_s=layer["_busy_s"], window_s=layer["_window_s"])
        result["breakdown"] = layer["_breakdown"]
        result["kernels"] = layer["_kernels"]
        result["trace_cost"] = layer["_cost"]
    result["checks"] = verdict["checks"]
    return result


def _per_member(solves) -> dict:
    out = {}
    for s in solves:
        out.setdefault(str(s.member), set()).add(s.iterations)
    return {k: sorted(v) for k, v in sorted(out.items())}
