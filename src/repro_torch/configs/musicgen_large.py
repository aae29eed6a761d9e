"""musicgen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
(batch, seq, d_model); the 4-codebook interleaving is collapsed to a
single vocab=2048 head (stub noted in DESIGN.md)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        frontend="audio_frames",
        norm="ln",
        sub_quadratic=False,    # full attention → long_500k skipped
        source="arXiv:2306.05284",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=64, head_dim=16,
        frontend="audio_frames", norm="ln",
        sub_quadratic=False,
        source="arXiv:2306.05284",
    )
