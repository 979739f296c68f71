"""Per-layer metric readers, one module per metric, named as in
``BENCHMARK.json``'s ``per_layer``.

A reader has ``read(data: benchmark.trace.TraceData) -> float | None`` and
returns None where its run gave it nothing to read (the harness then leaves
the metric out of the line).  It may ask for instrumentation:

- ``BRACKETS``: (role, method) pairs, role "interface" or "solver", whose
  calls phase B times between synchronisations and phase C labels;
- ``KERNELS``: {label: (module, {function: work})}, the program's kernel
  entries whose calls phase C labels ``bench.k.<label>``, with
  ``work(*args, **kwargs) -> (bytes, flops)`` from the arguments' shapes
  (``benchmark/yardstick.py``).
"""
