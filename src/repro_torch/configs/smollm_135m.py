"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab=49152, head_dim=64,
        tie_embeddings=True,
        sub_quadratic=False,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16,
        tie_embeddings=True,
        sub_quadratic=False,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
