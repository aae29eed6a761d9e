"""deepseek-v3-671b — MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437; hf].  First 3 layers dense (d_ff 18432); MTP depth-1
head; bf16 AdamW moments as in the V3 paper's low-precision recipe."""
from .base import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab=129280, head_dim=192,  # 128 nope + 64 rope
        moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert=2048),
        n_dense_layers=3, dense_d_ff=18432,
        mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64,
                      nope_dim=128, v_dim=128),
        mtp=True,
        opt_moment_dtype="bf16",
        sub_quadratic=False,
        source="arXiv:2412.19437",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, head_dim=24,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32,
                      capacity_factor=4.0),
        n_dense_layers=1, dense_d_ff=128,
        mla=MLAConfig(kv_lora=16, q_lora=24, rope_dim=8,
                      nope_dim=16, v_dim=16),
        mtp=True,
        opt_moment_dtype="bf16",
        sub_quadratic=False,
        source="arXiv:2412.19437",
    )
