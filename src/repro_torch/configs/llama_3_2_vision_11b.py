"""llama-3.2-vision-11b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Every 5th layer
cross-attends to image patch embeddings; the vision tower is a STUB per
the assignment (``input_specs()`` provides precomputed patch embeddings of
shape (batch, 1600, d_model))."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        cross_attn_every=5, n_img_tokens=1600,
        frontend="vision",
        sub_quadratic=False,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama-vision-smoke", family="vlm",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        cross_attn_every=5, n_img_tokens=8,
        frontend="vision",
        sub_quadratic=False,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
