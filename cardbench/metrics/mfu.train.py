"""The whole step's share of the chip's peak, percent
(``counts.train_mfu``)."""
from cardbench import counts


def read(run):
    return counts.train_mfu(run)
