"""Percent of the profiler's window with no device operation
(``counts.idle_share``)."""
from cardbench import counts


def read(run):
    return counts.idle_share(run)
