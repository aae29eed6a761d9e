"""The frozen count functions against hand counts at the shapes the
port's kernel table lists."""
from __future__ import annotations

from cardbench import counts as C
from cardbench.reference.model import param_specs
from conftest import ROOT


def _arch(name):
    import json
    return json.loads((ROOT / "cardbench" / "configs" / name).read_text())[
        "arch"]


def test_moe_gmm_prefill_product():
    # jamba's first prefill product: 8,192 live rows, D 4096, F 2x14336
    flops, nbytes = C.moe_gmm_work(16, 8192, 4096, 28672)
    assert flops == 2 * 8192 * 4096 * 28672
    assert abs(flops / 1e12 - 1.924) < 1e-3
    assert abs(C.bound_s(flops, nbytes) * 1e3 - 1.9455) < 1e-3


def test_moe_gmm_decode_product_is_bytes_bound():
    # 16 live rows in 8 live experts: the experts' weights dominate
    flops, nbytes = C.moe_gmm_work(8, 16, 4096, 28672)
    assert nbytes == (8 * 4096 * 28672 + 16 * (4096 + 28672)) * 2
    assert C.bound_s(flops, nbytes) == nbytes / C.HBM_BYTES_PER_S
    assert abs(C.bound_s(flops, nbytes) * 1e3 - 0.561) < 1e-3


def test_model_sizes():
    s = _arch("smollm-135m.json")
    assert C.n_params(param_specs(s)) == 134_515_008
    j = _arch("jamba-v0.1-52b-l16.json")
    specs = param_specs(j)
    ex = C.expert_params(specs, j)
    assert ex == 8 * 16 * 3 * 4096 * 14336
    # 2 x 2 bytes x every parameter: the weights alone are ~52 GB
    assert abs(C.n_params(specs) * 2 / 1e9 - 52.1) < 0.5


def test_train_flops():
    s = _arch("smollm-135m.json")
    per_tok = C.train_flops_per_token(param_specs(s), s, 4096)
    assert per_tok == 6 * 134_515_008 + 6 * 30 * 4096 * 576
    # 32,768 tokens a step: ~40.4 TFLOP of model work
    assert abs(per_tok * 32768 / 1e12 - 40.4) < 0.5


def test_dense_weight_bytes():
    s = _arch("smollm-135m.json")
    # tied: the table is read whole as the head
    assert C.dense_weight_bytes(param_specs(s), s) > 0.26e9
    j = _arch("jamba-v0.1-52b-l16.json")
    specs = param_specs(j)
    dense = C.dense_weight_bytes(specs, j)
    assert dense < 10e9 and dense + C.expert_params(specs, j) * 2 > 50e9
