"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed experts
top-6 [arXiv:2405.04434; hf].  First layer is dense FFN (d_ff 12288, the
HF config's intermediate_size); routed experts use d_expert=1536 (the
assignment's d_ff column = moe_intermediate_size)."""
from .base import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab=102400, head_dim=192,  # 128 nope + 64 rope
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_expert=1536),
        n_dense_layers=1, dense_d_ff=12288,
        mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64,
                      nope_dim=128, v_dim=128),
        sub_quadratic=False,    # MLA is full quadratic attention
        source="arXiv:2405.04434",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, head_dim=24,  # 16 nope + 8 rope
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32,
                      capacity_factor=4.0),
        n_dense_layers=1, dense_d_ff=128,
        mla=MLAConfig(kv_lora=16, q_lora=24, rope_dim=8,
                      nope_dim=16, v_dim=16),
        sub_quadratic=False,
        source="arXiv:2405.04434",
    )
