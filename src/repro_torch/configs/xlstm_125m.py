"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
d_ff=0: the projections live inside the xLSTM blocks (mLSTM pre-up-projects
2x; the sLSTM block carries a gated 8/3x FFN).  sLSTM at i%8==3 (the
paper's [7:1] ratio); the sLSTM recurrence is sequence-sequential, so its
``seq`` dim is marked non-shardable for the parallelizer."""
from .base import ArchConfig, XLSTMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=192,
        xlstm=XLSTMConfig(slstm_every=8, slstm_offset=3,
                          proj_factor_mlstm=2, d_ff_slstm=2048, chunk=256),
        sub_quadratic=True,
        source="arXiv:2405.04517",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256, head_dim=16,
        xlstm=XLSTMConfig(slstm_every=4, slstm_offset=1,
                          proj_factor_mlstm=2, d_ff_slstm=128, chunk=16),
        sub_quadratic=True,
        source="arXiv:2405.04517",
    )
