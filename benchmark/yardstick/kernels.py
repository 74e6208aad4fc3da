"""Which of the program's kernels a device function belongs to.

A table is a list of [name fragment, kernel] pairs read from a metric's
data file (a frozen copy of the map the program's smoke run uses); the
first fragment found in the function's demangled name wins.
"""
from __future__ import annotations


def kernel_of(name: str, table) -> str | None:
    return next((k for frag, k in table if frag in name), None)


def seconds_of(summary, table, kernels) -> float:
    """Device seconds of the functions the table assigns to ``kernels``."""
    wanted = set(kernels)
    return summary.seconds_where(lambda n: kernel_of(n, table) in wanted)
