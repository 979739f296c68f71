"""Share of a plain cycle of the set (phase A) in which no operation runs
on the card: one minus the device's busy seconds in a cycle profiled with
CUDA activity alone (phase C) over the plain cycle's seconds.  The plain
cycle, not a profiled one, is the denominator: profiling slows the host."""


def read(data):
    if data.plain_cycle_s <= 0 or data.busy_s <= 0:
        return None
    return 100.0 * (data.plain_cycle_s - data.busy_s) / data.plain_cycle_s
