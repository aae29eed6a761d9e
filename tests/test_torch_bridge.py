"""Reference params cross into the port by path, bit for bit."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.lm import LM
from torch_parity import f32, numpy_tree

DENSE = ["smollm-135m", "smollm-360m", "stablelm-3b", "h2o-danube-3-4b"]
#: MLA in every layer; deepseek-v3 adds the MTP head
MLA = ["deepseek-v2-236b", "deepseek-v3-671b"]


@pytest.fixture(scope="module")
def ref_tree():
    lm = JLM(jget("smollm-135m", smoke=True), remat="none")
    params, _ = lm.init(jax.random.PRNGKey(0))
    return numpy_tree(params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_round_trip_is_bitwise(ref_tree):
    got = params_from_numpy(ref_tree, "cpu")
    flat_ref, flat_got = _flat(ref_tree), _flat(got)
    assert sorted(flat_got) == sorted(flat_ref)
    assert "group0/b0/mix/w_q" in flat_got
    saw_bf16 = False
    for path, a in flat_ref.items():
        t = flat_got[path]
        assert tuple(t.shape) == a.shape, path
        if a.dtype == ml_dtypes.bfloat16:
            saw_bf16 = True
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), a), path
    assert saw_bf16


def test_stacked_layers_axis_is_kept(ref_tree):
    cfg = get_config("smollm-135m", smoke=True)
    got = params_from_numpy(ref_tree, "cpu")
    w_q = got["group0"]["b0"]["mix"]["w_q"]
    assert tuple(w_q.shape) == (cfg.n_layers, cfg.d_model, cfg.n_heads,
                                cfg.resolved_head_dim)


def test_load_params_checks_paths_and_shapes(ref_tree):
    lm = LM(get_config("smollm-135m", smoke=True), device="cpu")
    lm.load_params(ref_tree)
    missing = {k: v for k, v in ref_tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        lm.load_params(missing)
    extra = dict(ref_tree, head=np.zeros((4, 4), np.float32))
    with pytest.raises(KeyError, match="head"):
        lm.load_params(extra)
    bad = dict(ref_tree, embed=ref_tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        lm.load_params(bad)
    wrong = dict(ref_tree, embed=ref_tree["embed"].astype(np.float32))
    with pytest.raises(TypeError, match="embed"):
        lm.load_params(wrong)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE + MLA)
def test_param_tree_matches_reference(arch, smoke):
    """Paths, shapes, dtypes and logical dims equal the reference's, at
    full width too (on the meta device: nothing is allocated)."""
    jparams, jdims = JLM(jget(arch, smoke=smoke)).init(None, abstract=True)
    lm = LM(get_config(arch, smoke=smoke), device="cpu")
    shapes = _flat(lm.param_shapes())
    ref = _flat(jparams)
    assert sorted(shapes) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(shapes[path].shape) == tuple(leaf.shape), path
        assert str(shapes[path].dtype).split(".")[-1] == \
            np.dtype(leaf.dtype).name, path
    _, dims = lm._build(ParamBuilder(None, device=torch.device("meta")))
    assert _flat(dims) == _flat(jdims)


@pytest.mark.parametrize("arch", MLA)
def test_mla_and_mtp_leaves_cross_by_name(arch):
    """The reference's MLA and MTP leaves reach the port through
    ``load_params`` (``params_from_numpy`` with ``like=``) bit for bit,
    and a leaf of the wrong shape is refused."""
    jparams, _ = JLM(jget(arch, smoke=True)).init(jax.random.PRNGKey(3))
    lm = LM(get_config(arch, smoke=True), device="cpu")
    tree = numpy_tree(jparams)
    got = _flat(lm.load_params(tree))
    want = _flat(tree)
    names = [p for p in want if "/mix/w_u" in p or p.startswith("mtp/")]
    assert any("/mix/w_uk" in p for p in names)
    assert any(p.startswith("mtp/") for p in names) == lm.cfg.mtp
    for path in names:
        assert np.array_equal(f32(got[path]), np.asarray(want[path],
                                                         np.float32)), path
    bad = jax.tree.map(lambda a: a, tree)
    bad["group0"]["b0"]["mix"]["w_uk"] = bad["group0"]["b0"]["mix"][
        "w_uk"][..., :-1]
    with pytest.raises(ValueError):
        lm.load_params(bad)
