"""Flash attention forward (replaces ``repro/kernels/flash_attention``)."""
