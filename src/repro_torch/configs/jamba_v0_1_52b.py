"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE 16e
top-2 [arXiv:2403.19887; hf].  Attention (GQA kv=8) at layer i%8==3; MoE
FFN on odd layers (period-2, as the Jamba paper's e=2)."""
from .base import ArchConfig, MambaConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536, head_dim=128,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
        attn_every=8, attn_offset=3,
        moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=14336),
        moe_every=2,
        sub_quadratic=True,     # 28/32 layers are Mamba; attn is 1:7
        source="arXiv:2403.19887",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
        attn_every=8, attn_offset=3,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=128,
                      capacity_factor=4.0),
        moe_every=2,
        sub_quadratic=True,
        source="arXiv:2403.19887",
    )
