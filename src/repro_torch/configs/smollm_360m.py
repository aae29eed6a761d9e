"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab=49152, head_dim=64,
        tie_embeddings=True,
        sub_quadratic=False,
        source="hf:HuggingFaceTB/SmolLM-360M",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m-smoke", family="dense",
        n_layers=2, d_model=60, n_heads=5, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=12,
        tie_embeddings=True,
        sub_quadratic=False,
        source="hf:HuggingFaceTB/SmolLM-360M",
    )
