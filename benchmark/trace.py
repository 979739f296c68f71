"""The traced run (``--trace 1``): the per-layer readings of one window.

The window is split in four, each of whole cycles of the set:

A. plain solves for half of ``--seconds``: per-solve host times, and the
   plain cycle's seconds that the device's idle share is read against;
B. one cycle with every call into the layers the metrics name bracketed by
   ``torch.cuda.synchronize()`` (``profile_flagship.py::_bracket_phases``,
   copied): the layers' host time with their device work;
C. one cycle under ``torch.profiler`` with CUDA activity alone, which slows
   the host least: device busy time, launches and device time per operation;
D. one cycle under ``torch.profiler`` with CPU and CUDA activity, every layer
   call and every kernel entry a metric names inside a ``bench.*`` label and
   each kernel entry's bytes and operations counted from its arguments'
   shapes: device time per kernel entry, and which host span each idle gap
   of the device falls in.  Recording every host operation slows this cycle
   (about 1.9x); its idle gaps are scaled to the plain cycle's idle time.

Each per-layer metric is a reader in ``metrics/<name>.py``; its optional
``BRACKETS`` and ``KERNELS`` say what to instrument (``metrics/__init__.py``).
Every solve of A, B and C is judged like the untraced window's.
"""

import collections
import dataclasses
import functools
import importlib
import sys
import time

from benchmark import harness, yardstick

# calls whose labels name the host's activity during the device's idle gaps
NAMING_SPANS = (
    ("interface", "init_state"), ("interface", "eval_ad"), ("interface", "convergence_from_ad"),
    ("interface", "kkt_from_ad"), ("interface", "assemble_kkt"), ("interface", "kkt_rhs"),
    ("interface", "extract_deltas"), ("interface", "fraction_to_the_boundary"),
    ("interface", "merit_components"), ("interface", "apply_step"),
    ("solver", "numeric"), ("solver", "solve_with_status"),
)
SPAN_PREFIXES = ("bench.", "sc_solver.", "banded_sc.")
TOP = 10


@dataclasses.dataclass
class TraceData:
    """What the readers read."""

    plain_seconds: list  # A: host seconds of each solve
    plain_cycle_s: float  # A: mean seconds of one cycle of the set
    span_seconds: dict  # B: method -> synchronised host seconds
    span_calls: dict  # B: method -> calls
    span_iterations: int  # B: interior-point iterations
    window_s: float  # C: the profiled cycle's length
    busy_s: float  # C: seconds in which some device operation ran
    launches: int  # C: kernels run on the device
    iterations: int  # C: interior-point iterations
    kernel_device_s: dict  # D: kernel label -> device seconds of the kernels it launched
    kernel_bound_s: dict  # D: kernel label -> least seconds its calls' bytes or flops need
    kernel_calls: dict  # D: kernel label -> calls


def load_readers(per_layer: list) -> dict:
    return {m["name"]: importlib.import_module(f"benchmark.metrics.{m['name']}") for m in per_layer}


def _objects(inst, role):
    return inst.interface if role == "interface" else inst.solver


def _patch_methods(instances, pairs, make):
    """Replace each named bound method of each instance's interface or
    solver by ``make(name, method)``; returns a function undoing it."""
    saved = []
    for inst in instances:
        for role, name in pairs:
            obj = _objects(inst, role)
            f = getattr(obj, name, None)
            if f is None:
                continue
            setattr(obj, name, make(name, f))
            saved.append((obj, name))
    return lambda: [delattr(obj, name) for obj, name in saved]


def _patch_functions(module_name, works, make):
    """Replace each function ``works`` names, defined in ``module_name``, in
    every loaded module of the program that holds it; returns the undo."""
    mod = importlib.import_module(module_name)
    originals = {id(getattr(mod, fn)): fn for fn in works}
    saved = []
    for mname, m in list(sys.modules.items()):
        if m is None or mname.split(".")[0] != "parapint_tpu_torch":
            continue
        for attr, val in list(vars(m).items()):
            if id(val) in originals:
                setattr(m, attr, make(val, works[originals[id(val)]]))
                saved.append((m, attr, val))
    return lambda: [setattr(m, attr, val) for m, attr, val in saved]


def _bracketed(instances, pairs, device):
    """Phase B's synchronised brackets; returns (seconds, calls, undo)."""
    seconds, calls = collections.defaultdict(float), collections.Counter()

    def make(name, f):
        @functools.wraps(f)
        def wrapped(*a, **k):
            harness.sync(device)
            t = time.perf_counter()
            out = f(*a, **k)
            harness.sync(device)
            seconds[name] += time.perf_counter() - t
            calls[name] += 1
            return out

        return wrapped

    return seconds, calls, _patch_methods(instances, pairs, make)


def _labelled(instances, pairs, kernels):
    """Phase C's labels; returns (bound seconds, calls, undo)."""
    from torch.profiler import record_function

    bound, calls = collections.defaultdict(float), collections.Counter()

    def make_method(name, f):
        @functools.wraps(f)
        def wrapped(*a, **k):
            with record_function(f"bench.{name}"):
                return f(*a, **k)

        return wrapped

    undo = [_patch_methods(instances, pairs, make_method)]
    for label, (module_name, works) in kernels.items():

        def make_kernel(f, work, label=label):
            @functools.wraps(f)
            def wrapped(*a, **k):
                nbytes, flops = work(*a, **k)
                bound[label] += yardstick.bound_seconds(nbytes, flops)
                calls[label] += 1
                with record_function(f"bench.k.{label}"):
                    return f(*a, **k)

            return wrapped

        undo.append(_patch_functions(module_name, works, make_kernel))
    return bound, calls, lambda: [u() for u in reversed(undo)]


def _is_annotation(e, labels) -> bool:
    return getattr(e, "is_user_annotation", False) or e.name in labels


def _inside(events, dev, label) -> float:
    """Device seconds of the operations that ran inside the device-side
    ranges of ``label`` (the profiler spans each such range over the work
    launched inside the label on the host)."""
    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and e.name == label)
    total, i = 0.0, 0
    for e in sorted(dev, key=lambda e: e.time_range.start):
        s = e.time_range.start
        while i < len(ranges) and ranges[i][1] < s:
            i += 1
        if i < len(ranges) and ranges[i][0] <= s <= ranges[i][1]:
            total += e.time_range.end - s
    return total * 1e-6


def _device_ops(dev):
    """(device seconds per operation name, kernels launched) of ``dev``."""
    ops = collections.defaultdict(float)
    for e in dev:
        ops[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    return ops, sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev)


def _busy(dev, w0, w1):
    """(busy microseconds, idle gaps) of the union of ``dev``'s intervals
    within [w0, w1]."""
    busy, gaps, cur = 0.0, [], w0
    for s, t in sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev):
        if t <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def analyse_device(events):
    """(busy_s, launches, device seconds per operation) of a profile with
    CUDA activity alone (phase C); busy_s is 0 where it holds no device
    operation."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e, set())]
    if not dev:
        return 0.0, 0, {}
    ops, launches = _device_ops(dev)
    busy, _ = _busy(dev, min(e.time_range.start for e in dev), max(e.time_range.end for e in dev))
    return busy * 1e-6, launches, ops


def analyse(events, kernel_labels):
    """(window_s, busy_s, launches, device seconds per kernel label, device
    seconds per operation, idle seconds per host span) of the events of a
    profile whose solves ran inside one ``bench.window`` label (phase D)."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = next(e for e in cpu if e.name == "bench.window")
    w0, w1 = win.time_range.start, win.time_range.end
    labels = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    labels |= {e.name for e in cpu if e.name.startswith(SPAN_PREFIXES)}
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e, labels)]
    ops, launches = _device_ops(dev)
    busy, gaps = _busy(dev, w0, w1)

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in cpu
        if e.thread == win.thread and e.name.startswith(SPAN_PREFIXES) and e.name != "bench.window"
    )
    idle = collections.defaultdict(float)
    stack, i = [], 0
    for s, t in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + t) / 2
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        stack = [sp for sp in stack if sp[1] >= mid]
        name = stack[-1][2] if stack else "bench.window (between layer calls)"
        idle[name] += (t - s) * 1e-6

    kernel_s = {lab: _inside(events, dev, f"bench.k.{lab}") for lab in kernel_labels}
    return (w1 - w0) * 1e-6, busy * 1e-6, launches, kernel_s, ops, idle


def _top(d, scale=1.0):
    return [[k, v * scale] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def traced_window(cell, instances, rng, seconds, device):
    """Phases A-D; returns (solves, window seconds, readings), the readings
    holding each per-layer metric's value (None where it read nothing) and
    ``_busy_s``, ``_window_s``, ``_breakdown``, ``_kernels``, ``_cost``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    readers = load_readers(cell.per_layer)
    pairs = sorted({p for r in readers.values() for p in getattr(r, "BRACKETS", ())})
    kernels = {}
    for r in readers.values():
        kernels.update(getattr(r, "KERNELS", {}))
    n = len(instances)
    t0 = time.perf_counter()

    plain, plain_s = harness.closed_loop(instances, rng, seconds / 2, device)
    plain_cycle = plain_s * n / len(plain)

    span_s, span_calls, undo = _bracketed(instances, pairs, device)
    try:
        spanned, _ = harness.closed_loop(instances, rng, 0, device)
    finally:
        undo()

    quiet, quiet_s, busy, launches, ops = [], 0.0, 0.0, 0, {}
    if device.type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            quiet, quiet_s = harness.closed_loop(instances, rng, 0, device)
        busy, launches, ops = analyse_device(prof.events())
        del prof

    bound, kcalls, undo = _labelled(instances, sorted(set(pairs) | set(NAMING_SPANS)), kernels)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                profiled, _ = harness.closed_loop(instances, rng, 0, device)
    finally:
        undo()
    window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    lab_s, lab_busy, lab_launches, kernel_s, lab_ops, idle = analyse(prof.events(), kernels)
    del prof
    counted = quiet
    if busy <= 0:  # the CUDA-only cycle read nothing: the labelled one's device side
        counted, quiet_s, busy, launches, ops = profiled, lab_s, lab_busy, lab_launches, lab_ops
    # the labelled cycle's idle gaps, scaled to the plain cycle's idle time
    scale = (plain_cycle - busy) / (lab_s - lab_busy) if lab_s > lab_busy else 1.0
    cost = {"plain_cycle_s": plain_cycle, "device_only_cycle_s": quiet_s, "labelled_cycle_s": lab_s,
            "idle_scale": scale}
    print(f"trace: phases A-D {window_s:.1f} s, reading the profile {time.perf_counter() - t1:.1f} s; "
          f"cycle s: plain {plain_cycle:.3f}, device-only {quiet_s:.3f}, labelled {lab_s:.3f}",
          file=sys.stderr)

    data = TraceData(
        plain_seconds=[s.seconds for s in plain], plain_cycle_s=plain_cycle,
        span_seconds=dict(span_s), span_calls=dict(span_calls),
        span_iterations=sum(s.iterations for s in spanned),
        window_s=quiet_s, busy_s=busy, launches=launches,
        iterations=sum(s.iterations for s in counted),
        kernel_device_s=kernel_s, kernel_bound_s=dict(bound), kernel_calls=dict(kcalls),
    )
    readings = {name: r.read(data) for name, r in readers.items()}
    readings.update(
        _busy_s=busy, _window_s=quiet_s, _cost=cost,
        _breakdown={"device_ops": _top(ops), "idle_gaps": _top(idle, scale)},
        _kernels={lab: {"calls": kcalls[lab], "device_s": kernel_s[lab], "bound_s": bound[lab]}
                  for lab in kernels})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return plain + spanned + quiet + profiled, window_s, readings
