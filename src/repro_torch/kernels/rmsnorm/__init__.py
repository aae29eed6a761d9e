"""Fused RMSNorm (replaces ``repro/kernels/rmsnorm``)."""
