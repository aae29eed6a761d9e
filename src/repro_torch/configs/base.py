"""Architecture configuration schema.

One ``ArchConfig`` fully describes an assigned architecture: the block
pattern (dense attention / SWA / cross-attn / Mamba / sLSTM / mLSTM), the
FFN flavour (dense or MoE with shared experts), MLA compression, and the
modality frontend (tokens / stubbed audio frames / stubbed vision patches).

``layer_groups`` compresses the per-layer pattern into homogeneous repeated
segments whose parameters are stacked on a leading ``layers`` axis.  This
is a copy of ``repro.configs.base`` (pure data, no JAX), kept identical so
parameter paths and layer groups line up with the reference package.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0          # expert intermediate dim
    capacity_factor: float = 1.25
    router_dtype: str = "f32"
    # DeepSeek-V2's group-limited greedy routing (port only): the top
    # ``topk_group`` of ``n_group`` expert groups, each scored by its best
    # expert, then the top-k inside them; ``norm_topk`` False keeps the
    # softmax gates unnormalised, times ``routed_scale``.  The defaults
    # are the reference's softmax top-k, renormalised.
    n_group: int = 1
    topk_group: int = 1
    norm_topk: bool = True
    routed_scale: float = 1.0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128
    # port only: RMSNorm on the compressed query and on the kv latent
    # (DeepSeek-V2's q_a_layernorm and kv_a_layernorm), and YaRN's rope:
    # ``yarn`` (factor, original context, beta_fast, beta_slow,
    # mscale_all_dim), ``None`` for plain RoPE and the plain softmax
    # scale.  YaRN's cos/sin factor, the ratio of its attention factors at
    # ``mscale`` and ``mscale_all_dim``, is 1 where the two are equal, as
    # DeepSeek-V2 publishes them (0.707 both), so only the second is kept
    latent_norm: bool = False
    yarn: Optional[tuple] = None

    def __post_init__(self):
        if self.yarn is not None:
            # a configuration file gives a list
            object.__setattr__(self, "yarn", tuple(self.yarn))


#: fields the reference's config schema lacks, by class: at their
#: defaults (which keep the reference's behaviour) a config is the
#: reference's (``reference_dict``)
PORT_ONLY = {
    "MoEConfig": ("n_group", "topk_group", "norm_topk", "routed_scale"),
    "MLAConfig": ("latent_norm", "yarn"),
}


def reference_dict(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port-only fields that sit
    at their defaults: equal to the reference's ``asdict`` of the same
    config wherever the port's fields keep the reference's behaviour."""
    def walk(obj):
        if not is_dataclass(obj):
            return obj
        skip = {f.name for f in fields(obj)
                if f.name in PORT_ONLY.get(type(obj).__name__, ())
                and getattr(obj, f.name) == f.default}
        return {f.name: walk(getattr(obj, f.name)) for f in fields(obj)
                if f.name not in skip}
    return walk(cfg)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8        # sLSTM at layer index % every == offset
    slstm_offset: int = 3
    proj_factor_mlstm: int = 2
    d_ff_slstm: int = 0         # gated FFN inside the sLSTM block
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense FFN dim, or MoE expert dim for moe
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    norm: str = "rms"           # rms|ln
    rope_pct: float = 1.0       # partial rotary (stablelm)
    attn_window: Optional[int] = None   # sliding-window attention
    cross_attn_every: Optional[int] = None  # vlm: cross-attn layer stride
    n_img_tokens: int = 1024    # vlm stub: image patch embeddings
    moe: Optional[MoEConfig] = None
    moe_every: int = 1          # MoE FFN at layer index % moe_every == 1
    n_dense_layers: int = 0     # leading dense-FFN layers (deepseek)
    dense_d_ff: int = 0         # FFN dim of those dense layers
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_every: int = 0         # hybrid: attention at index % every == offset
    attn_offset: int = 3
    xlstm: Optional[XLSTMConfig] = None
    frontend: str = "tokens"    # tokens|audio_frames|vision
    mtp: bool = False           # multi-token-prediction head (deepseek-v3)
    tie_embeddings: bool = False
    dtype: str = "bf16"
    opt_moment_dtype: str = "f32"  # bf16 for deepseek-v3 (as its paper)
    sub_quadratic: bool = False    # eligible for long_500k
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # -- per-layer block descriptors -----------------------------------------
    def block_kind(self, i: int) -> str:
        """Sequence-mixer kind of layer ``i``."""
        if self.xlstm is not None:
            x = self.xlstm
            return ("slstm" if i % x.slstm_every == x.slstm_offset
                    else "mlstm")
        if self.mamba is not None and self.attn_every:
            return ("attn" if i % self.attn_every == self.attn_offset
                    else "mamba")
        if self.cross_attn_every and i % self.cross_attn_every == (
                self.cross_attn_every - 1):
            return "xattn"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """Channel-mixer kind of layer ``i``."""
        if self.xlstm is not None:
            return "none"       # projections live inside the xLSTM blocks
        if self.moe is None:
            return "dense"
        if i < self.n_dense_layers:
            return "dense"
        if self.moe_every > 1 and i % self.moe_every != 1:
            return "dense"
        return "moe"

    def layer_kinds(self) -> list[tuple[str, str]]:
        return [(self.block_kind(i), self.ffn_kind(i))
                for i in range(self.n_layers)]

    def layer_groups(self) -> list[tuple[tuple[tuple[str, str], ...], int]]:
        """Compress layers into (pattern, repeats) groups for scanning.

        Finds the smallest period p such that the kind sequence is
        (prefix, p-periodic body); emits the prefix layer-by-layer and the
        body as one scanned group of super-blocks."""
        kinds = self.layer_kinds()
        n = len(kinds)
        for period in range(1, n + 1):
            for start in range(0, min(period, n - 1) + 1):
                body = kinds[start:]
                if len(body) % period != 0:
                    continue
                pattern = tuple(body[:period])
                if all(tuple(body[j * period:(j + 1) * period]) == pattern
                       for j in range(len(body) // period)):
                    groups = [((k,), 1) for k in kinds[:start]]
                    groups.append((pattern, len(body) // period))
                    return groups
        return [(tuple(kinds), 1)]


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                   # train|prefill|decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (assignment rule)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture; "
                       "long_500k requires sub-quadratic attention "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""
