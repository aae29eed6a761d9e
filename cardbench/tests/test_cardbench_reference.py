"""The plain reference agrees with the port's plain path at a small
size: each mixer and FFN in float32 to round-off, and the whole model's
logits (bfloat16 in the port) to bfloat16's precision."""
from __future__ import annotations

import pytest
import torch

from cardbench import harness as H
from cardbench.reference.model import Precision, Ref, param_specs
from conftest import JAMBA, SMOLLM


def _noc(t, dims, site=None):
    return t


def _block(flat, pfx, idx, part):
    return {k.split("/")[-1]: (v[idx] if idx is not None else v)
            for k, v in flat.items() if k.startswith(f"{pfx}/{part}/")}


def test_layout_matches_the_program():
    for arch in (SMOLLM, JAMBA):
        flat = H.make_params(param_specs(arch), 1, "cpu")
        H.check_layout(H.arch_config(arch), flat)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixers_and_ffns_in_f32(seed):
    from repro_torch.models import attention, moe, ssm
    cfg = H.arch_config(JAMBA)
    flat = {k: v.float() for k, v in
            H.make_params(param_specs(JAMBA), seed, "cpu").items()}
    ref = Ref(JAMBA, flat)
    x = torch.randn(2, 32, JAMBA["d_model"],
                    generator=torch.Generator().manual_seed(seed))
    pos = torch.arange(32).expand(2, 32)
    with torch.no_grad():
        for pfx, idx, mix, ffn in ref.sites:
            if mix == "mamba":
                got = ssm.mamba_block(x, _block(flat, pfx, idx, "mix"), cfg,
                                      _noc)
                want = ref.mamba(x, pfx, idx)
            else:
                got, _ = attention.gqa_attention(
                    x, _block(flat, pfx, idx, "mix"), cfg, pos, _noc)
                want = ref.attention(x, pfx, idx, pos)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            if ffn == "moe":
                got, _ = moe.moe_ffn(x, _block(flat, pfx, idx, "ffn"), cfg,
                                     _noc)
                want = ref.moe(x, pfx, idx, "sequence")
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_capacity_drops_as_the_program():
    """At capacity factor 0.5 most experts overflow: the reference keeps
    the same (token, k) copies as the program, token-major."""
    from repro_torch.models import moe
    arch = dict(JAMBA, moe=dict(JAMBA["moe"], capacity_factor=0.5))
    cfg = H.arch_config(arch)
    flat = {k: v.float() for k, v in
            H.make_params(param_specs(arch), 3, "cpu").items()}
    ref = Ref(arch, flat)
    x = torch.randn(4, 64, arch["d_model"],
                    generator=torch.Generator().manual_seed(3))
    pfx, idx = next((p, i) for p, i, _m, f in ref.sites if f == "moe")
    with torch.no_grad():
        got, aux = moe.moe_ffn(x, _block(flat, pfx, idx, "ffn"), cfg, _noc)
        want = ref.moe(x, pfx, idx, "sequence")
    assert float(aux.dropped_fraction) > 0.1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,tol", [(SMOLLM, 0.02), (JAMBA, 0.5)])
def test_whole_model_logits(arch, tol):
    """The port's bf16 logits against the float32 reference's, and the
    fp8 control further off.  jamba's small model is chaotic (top-2
    near-ties move whole experts), so its bound is loose."""
    from repro_torch.models.lm import LM
    flat = H.make_params(param_specs(arch), 5, "cpu")
    lm = LM(H.arch_config(arch), device="cpu")
    toks = torch.randint(0, arch["vocab"], (2, 32),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = lm.logits_fn(H.nest(flat), {"tokens": toks}).float()
        want = Ref(arch, flat).forward(toks)
        ctl = Ref(arch, flat, Precision.FP8).forward(toks)
    err = float((got - want).abs().max())
    assert err < tol
    if arch is SMOLLM:
        assert float((ctl - want).abs().max()) > 3 * err


def test_jamba_layers_sit_where_the_published_config_puts_them():
    """Attention at ``attn_layer_offset`` of each period, experts at
    ``expert_layer_offset`` of theirs, in the reference and the port."""
    import json
    from cardbench.reference.model import layer_kinds
    from conftest import ROOT
    conf = json.loads((ROOT / "cardbench" / "configs"
                       / "jamba-v0.1-52b-l16.json").read_text())
    cfg = H.arch_config(conf["arch"])
    want = [("attn" if i % conf["attn_layer_period"]
             == conf["attn_layer_offset"] else "mamba",
             "moe" if i % conf["expert_layer_period"]
             == conf["expert_layer_offset"] else "dense")
            for i in range(conf["num_hidden_layers"])]
    assert layer_kinds(conf["arch"]) == want
    assert [(cfg.block_kind(i), cfg.ffn_kind(i))
            for i in range(cfg.n_layers)] == want
