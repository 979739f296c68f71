"""The port's tracing, ``torch.profiler`` integration and honest per-call
timing (counterpart of ``parapint_tpu.utils.profile``).

Tracing.  The layers of a solve carry named spans: ``ip.*`` in the fused
interior-point loop, ``iface.*`` in the structured interfaces, ``ad.*`` around
each batched AD closure, ``banded_sc.*``, ``sc_solver.*`` and ``tridiag.*`` in
the linear solvers.  Every blocking read of a device value goes through
:func:`host_read` (or, where a statement blocks otherwise, :func:`host_sync`),
which counts ``host_syncs`` and times the wait as a span ``ip.host_sync``.
The CUDA-graph replay of the AD calls (``interfaces/ad_graph.py``) counts
each engaged call under :data:`AD_GRAPH`'s names, in total and per method
(``ad_graph.replay.eval_ad``, ...), with :func:`count`.

- Outside :func:`tracing` and any profiler, :func:`span` returns one shared
  no-op context: two flag reads, no allocation, no clock read.
- Inside ``with tracing() as record:`` each span appends a :class:`Span` to
  ``record.spans`` (``perf_counter_ns`` start and end, the enclosing span, the
  enclosing ``ip.solve``) and the counters go to ``record.counters``.
- While a ``torch.profiler`` records, each span also opens
  ``record_function(name)``, so it lies on the profiler's timeline, the clock
  of the CUDA activity: idle gaps of the card can be put down to the
  innermost span.  :func:`trace` writes such a profile, with the spans in it,
  as a Chrome trace that Perfetto and TensorBoard load.

:func:`timed_fused` times one call the way the JAX package's tools do: the
call is followed by a readback of a scalar that depends on every floating
output (:func:`leafsum`), which waits for the device, and the measured
cost of one trivial launch plus readback (:func:`dispatch_floor`) is
subtracted.  On the JAX package's relayed TPU that floor was ~27 ms; on a
local card it is the launch and copy latency.
"""

import collections
import contextlib
import dataclasses
import functools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from parapint_tpu_torch.utils.device import require_device

TRACE_FILE = "trace.json"
SOLVE = "ip.solve"  # a span that opens a new solve id
SYNC = "ip.host_sync"  # the span of a blocking host read
SYNCS = "host_syncs"  # its counter
# the counters of the AD calls' CUDA graphs: a call captured, replayed, or run
# eagerly though it engaged (``interfaces/ad_graph.py``)
AD_GRAPH = ("ad_graph.capture", "ad_graph.replay", "ad_graph.eager")
# the prefixes of every span name, one per layer
SPAN_PREFIXES = ("ip.", "iface.", "ad.", "banded_sc.", "sc_solver.", "tridiag.")


@dataclasses.dataclass(slots=True)
class Span:
    """One closed (or still open: ``end_ns`` 0) span of a record."""

    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span in the record, -1 at the top
    solve: int  # index of the enclosing ``ip.solve`` span, -1 outside a solve


@dataclasses.dataclass
class TraceRecord:
    """What one :func:`tracing` block recorded."""

    spans: list = dataclasses.field(default_factory=list)
    counters: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    _stack: list = dataclasses.field(default_factory=list, repr=False)

    def _open(self, name: str) -> int:
        i = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        solve = i if name == SOLVE else (self.spans[parent].solve if parent >= 0 else -1)
        self.spans.append(Span(name, time.perf_counter_ns(), 0, parent, solve))
        self._stack.append(i)
        return i

    def _close(self, i: int) -> None:
        self.spans[i].end_ns = time.perf_counter_ns()
        self._stack.pop()

    def calls(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)

    def summary(self) -> dict:
        """{name: (calls, total seconds, self seconds)}, self seconds being
        each span's duration less the part its child spans cover."""
        child = [0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0:
                child[s.parent] += s.end_ns - s.start_ns
        out = collections.defaultdict(lambda: [0, 0, 0])
        for s, c in zip(self.spans, child):
            row = out[s.name]
            row[0] += 1
            row[1] += s.end_ns - s.start_ns
            row[2] += s.end_ns - s.start_ns - c
        return {k: (n, t * 1e-9, own * 1e-9) for k, (n, t, own) in out.items()}

    def host_seconds(self, names) -> float:
        """Seconds in the spans named in ``names``, less the host syncs nested
        in them: the host's own cost of those calls, without the waits."""
        names = set(names)
        total = sum(s.end_ns - s.start_ns for s in self.spans if s.name in names)
        for s in self.spans:
            if s.name != SYNC:
                continue
            p = s.parent
            while p >= 0 and self.spans[p].name not in names:
                p = self.spans[p].parent
            if p >= 0:
                total -= s.end_ns - s.start_ns
        return total * 1e-9


_record = None  # the TraceRecord of the innermost open tracing() block
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_count", "_rec", "_i", "_rf")

    def __init__(self, name: str, count: bool = False):
        self.name, self._count = name, count

    def __enter__(self):
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._rec = rec = _record
        if rec is not None:
            if self._count:
                rec.counters[SYNCS] += 1
            self._i = rec._open(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._close(self._i)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """Context manager: the span ``name`` (module docstring); a shared no-op
    outside :func:`tracing` and any profiler."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function inside :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def host_sync():
    """Context manager around one statement that blocks until the device
    has caught up (a read to the host, a copy from pageable host memory):
    counts ``host_syncs`` and times the wait as a span ``ip.host_sync``."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(SYNC, count=True)


def count(name: str) -> None:
    """Add one to the counter ``name`` of the open :func:`tracing` record
    (nothing outside one)."""
    if _record is not None:
        _record.counters[name] += 1


def host_read(t: torch.Tensor):
    """``t.item()``: the hot path's one way to read a device value to the
    host (:func:`host_sync`)."""
    with host_sync():
        return t.item()


@contextlib.contextmanager
def tracing():
    """Context manager: record the spans and counters of everything run
    inside it; yields the :class:`TraceRecord`, read once the block ends."""
    global _record
    outer, rec = _record, TraceRecord()
    _record = rec
    try:
        yield rec
    finally:
        _record = outer


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: trace host and (where there is a card) device
    activity, with the program's spans, and write it to
    ``log_dir/trace.json``; yields the :func:`tracing` record."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing() as rec:
        yield rec
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
