"""Grouped expert matmul (replaces ``repro/kernels/moe_gmm``)."""
