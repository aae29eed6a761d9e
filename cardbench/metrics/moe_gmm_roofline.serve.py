"""The grouped matmul's share of its roofline, percent
(``counts.gmm_roofline``)."""
from cardbench import counts


def read(run):
    return counts.gmm_roofline(run)
