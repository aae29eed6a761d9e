"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].  SWA window 4096 bounds the decode state,
making long_500k applicable (window-bounded KV)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab=32000, head_dim=120,
        attn_window=4096,
        sub_quadratic=True,     # SWA: decode state bounded by the window
        source="arXiv:2401.16818",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="danube-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        attn_window=16,
        sub_quadratic=True,
        source="arXiv:2401.16818",
    )
