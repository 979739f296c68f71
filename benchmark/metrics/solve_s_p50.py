"""Median host seconds of one cold solve (phase A): a steadier statistic of
the pieces, kept beside the end-to-end ``solve_s``."""

import statistics


def read(data):
    return statistics.median(data.plain_seconds) if data.plain_seconds else None
