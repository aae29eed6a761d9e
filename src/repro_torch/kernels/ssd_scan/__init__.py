"""Mamba selective scan (replaces ``repro/kernels/ssd_scan``)."""
