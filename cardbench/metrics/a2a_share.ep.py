"""Percent of rank 0's device busy time in the profiler's window spent
in NCCL kernels: the expert exchange of every MoE layer, its wait for
the slowest rank included (``counts_ep.a2a_share``).  ``None`` where the
run's reduction has no NCCL time (a driver without the exchange)."""
from cardbench import counts_ep


def read(run):
    return counts_ep.a2a_share(run)
