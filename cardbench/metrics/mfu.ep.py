"""Rank 0's whole decode step's share of the chip's peak bandwidth,
percent (``counts_ep.serve_mfu``)."""
from cardbench import counts_ep


def read(run):
    return counts_ep.serve_mfu(run)
