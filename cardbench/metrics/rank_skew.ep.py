"""Percent: the rows the busiest rank's experts received over the
window over the mean of the ranks', from the program's exchange counters
(``ExpertShare.counters``, summed over the ranks;
``counts_ep.rank_skew``).  ``None`` where the program keeps no such
counters."""
from cardbench import counts_ep


def read(run):
    return counts_ep.rank_skew(run)
