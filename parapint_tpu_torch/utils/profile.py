"""``torch.profiler`` integration and honest per-call timing (counterpart of
``parapint_tpu.utils.profile``).

The reference threads a HierarchicalTimer through every layer; the device
side of the same picture is a profiler trace.  :func:`trace` wraps any
solve or step in one, written as a Chrome trace that Perfetto and
TensorBoard load; the solvers' ``sc_solver.*`` phase labels
(``torch.profiler.record_function``) appear in it.

:func:`timed_fused` times one call the way the JAX package's tools do: the
call is followed by a readback of a scalar that depends on every floating
output (:func:`leafsum`), which waits for the device, and the measured
cost of one trivial launch plus readback (:func:`dispatch_floor`) is
subtracted.  On the JAX package's relayed TPU that floor was ~27 ms; on a
local card it is the launch and copy latency.
"""

import contextlib
import dataclasses
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from parapint_tpu_torch.utils.device import require_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: trace host and (where there is a card) device
    activity and write it to ``log_dir/trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _leaves(out):
    """Every leaf of ``out`` through tensors, dicts, lists, tuples and
    dataclasses (the port's IPState, FusedResult, SchurFactor)."""
    if isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _leaves(getattr(out, f.name))
    elif out is not None:
        yield out


def _sync(out) -> None:
    """Wait for the device that holds ``out``'s first tensor."""
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


def profile_call(log_dir: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :func:`trace` and wait for the
    device of its output."""
    with trace(log_dir):
        out = fn(*args, **kwargs)
        _sync(out)
    return out


def leafsum(out) -> torch.Tensor:
    """A float32 scalar tensor, sum |x| over every floating leaf of ``out``
    (each cast to float32 first, as in the JAX package); Python floats count
    as leaves, other leaves are skipped.  Reading it waits for every
    computation that produced ``out``."""
    tensors = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    tot = torch.zeros((), dtype=torch.float32, device=device)
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel() and leaf.is_floating_point():
                tot = tot + leaf.to(torch.float32).abs().sum().to(device)
        elif isinstance(leaf, float):
            tot = tot + abs(leaf)
    return tot


_FLOOR = {}


def dispatch_floor(refresh: bool = False, device="cuda") -> float:
    """Seconds of one launch of a trivial op plus a scalar readback on
    ``device``, best of 5, cached per device (re-measure with
    ``refresh=True`` near the timings it is subtracted from)."""
    device = require_device(device)
    key = str(device)
    if key not in _FLOOR or refresh:
        x = torch.zeros((), dtype=torch.float32, device=device)
        float(x + 1.0)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            float(x + 1.0)
            best = min(best, time.perf_counter() - t0)
        _FLOOR[key] = best
    return _FLOOR[key]


def timed_fused(f, *a, reps: int = 5, subtract_floor: bool = True):
    """(output, best-of-``reps`` seconds) for one call of ``f(*a)``.

    Each timed call ends in a readback of :func:`leafsum` of its output, so
    the clock stops only when the device has finished; the floor of the
    output's device (:func:`dispatch_floor`) is subtracted.  The first call
    warms up (kernel builds, allocator) and is not timed."""
    out = f(*a)
    tot = leafsum(out)
    float(tot)
    floor = dispatch_floor(device=tot.device) if subtract_floor else 0.0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*a)
        float(leafsum(out))
        best = min(best, time.perf_counter() - t0)
    return out, max(0.0, best - floor)


def solver_phase_breakdown(solver, kkt, rhs, reps: int = 3):
    """Host wall times of one factor + solve cycle, by phase.

    The reference's MPI SC solver reports internal timers for ``form SC`` /
    ``factorize SC`` / ``communicate`` / ``back solve``.  This runs the two
    public phases of ``solver`` on the given KKT system, each timed by
    :func:`timed_fused`; for the split inside a phase, trace it
    (:func:`trace`) and read the ``sc_solver.*`` labels.

    Returns a dict: phase name -> best-of-``reps`` seconds.
    """
    times = {}
    fact, times["numeric (factor blocks + form SC + factor SC)"] = timed_fused(
        solver.numeric, kkt, reps=reps
    )
    _, times["solve (block solves + SC back solve)"] = timed_fused(
        solver.solve, fact, rhs, reps=reps
    )
    return times
