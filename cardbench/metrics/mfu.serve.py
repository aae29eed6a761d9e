"""The whole step's share of the chip's peak, percent
(``counts.serve_mfu``)."""
from cardbench import counts


def read(run):
    return counts.serve_mfu(run)
