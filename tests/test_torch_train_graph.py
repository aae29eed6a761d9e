"""The train step on its CUDA graph (``launch/graphs.TrainGraph``) in its
CPU form, the AdamW step counter advanced in place, the driver's resume
into the tensors the graph holds, and the sLSTM's gate weights cast once
per sequence.

On the CPU a ``TrainGraph`` runs its warm-up and then the whole step
directly against its static batch buffers, ``lr_scale`` and metrics,
reading and writing the caller's params and moments in place, so these
tests hold that bookkeeping bit for bit against the eager step
(``graphs=False``).  The captures themselves run on the card
(``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import xlstm as jxlstm
from repro.models.layers import ParamBuilder as JParamBuilder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.launch import train as train_mod
from repro_torch.launch.graphs import TrainGraph
from repro_torch.launch.steps import _to_device, build_train_step
from repro_torch.models import xlstm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import AdamWState, _row_slices, tree_leaves
from torch_parity import f32, numpy_tree
from torch_parity import strict_jit as _strict_jit

B, S = 2, 16
#: a gradient leaf against the reference's: this share of its largest
#: magnitude (+1e-6), as ``tests/test_torch_train.py`` holds them
GRAD_REL = 2e-2
CPU = torch.device("cpu")
#: the five smoke configs the graph is held to the eager step on: dense,
#: xLSTM, Mamba + MoE, MLA + MoE with the MTP loss and bf16 moments, and
#: audio frames
ARCHS = ["smollm-135m", "xlstm-125m", "jamba-v0.1-52b", "deepseek-v3-671b",
         "musicgen-large"]


def _batch(cfg, i: int, b: int = B, s: int = S) -> dict:
    """Step ``i``'s batch: the synthetic corpus's tokens and labels, or
    seeded frames and labels for the audio-frames frontend."""
    if cfg.frontend == "audio_frames":
        rng = np.random.default_rng(i)
        return {"frames": rng.standard_normal((b, s, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    return SyntheticCorpus(cfg.vocab, seed=0).batch(i, 0, b, s)


def _state(step, seed: int = 0):
    params, _ = step.lm.init(seed)
    return params, step.opt.init(params)


def _leaves(params, st) -> list:
    return [*tree_leaves(params), st.step, *tree_leaves(st.mu),
            *tree_leaves(st.nu)]


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _clone(params, st):
    return _clone_tree(params), AdamWState(
        st.step.clone(), _clone_tree(st.mu), _clone_tree(st.nu))


def _assert_bits_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


# -- the graph's step against the eager step ---------------------------------

@pytest.mark.parametrize("arch,accum", [(a, 1) for a in ARCHS]
                         + [("deepseek-v3-671b", 2)])
def test_train_graph_matches_eager_step(arch, accum):
    """Three steps with a cosine lr: a ``TrainGraph`` run directly against
    the eager ``fn`` from the same params, every metric of every step and
    the final params, moments and step counter bit for bit.  ``run``
    hands back the very params and state it was given and its static
    metrics."""
    cfg = get_config(arch, smoke=True)
    lr_fn = cosine_schedule(1.0, warmup=1, total=3)
    step = build_train_step(cfg, accum_steps=accum, device="cpu",
                            graphs=False)
    params, st = _state(step)
    p_e, st_e = _clone(params, st)
    graph = TrainGraph(step, params, st, _to_device(_batch(cfg, 0), CPU))
    for i in range(3):
        batch = _batch(cfg, i)
        p_e, st_e, want = step.fn(p_e, st_e, batch, lr_scale=lr_fn(i))
        p, s, got = graph.run(params, st, batch, lr_scale=lr_fn(i))
        assert p is params and s is st and got is graph.metrics
        assert sorted(got) == sorted(want)
        _assert_bits_equal([got[k] for k in sorted(got)],
                           [want[k] for k in sorted(want)])
    assert int(st.step) == 3
    _assert_bits_equal(_leaves(params, st), _leaves(p_e, st_e))


def test_train_step_runs_on_the_graph_only_where_asked():
    """``build_train_step`` on the CPU: ``graphs=None`` (the default) and
    ``False`` run the step eagerly, ``True`` on the graph's direct form;
    all three give the same bits."""
    cfg = get_config("smollm-135m", smoke=True)
    out = []
    for graphs in (None, False, True):
        step = build_train_step(cfg, device="cpu", graphs=graphs)
        params, st = _state(step)
        for i in range(2):
            params, st, m = step.fn(params, st, _batch(cfg, i))
        out.append((m["loss"].clone(), _leaves(params, st)))
        # the eager step takes any tree; the graph only its own
        other = _state(step, seed=1)
        if graphs:
            with pytest.raises(RuntimeError, match="another tree"):
                step.fn(*other, _batch(cfg, 0))
        else:
            step.fn(*other, _batch(cfg, 0))
    for loss, leaves in out[1:]:
        assert torch.equal(loss, out[0][0])
        _assert_bits_equal(leaves, out[0][1])


def test_train_graph_refuses_other_trees_and_shapes():
    """A graph's step reads and writes the tensors it was built over:
    another param tree, other moments or another batch shape raises and
    leaves the held state as it was; a new dict of the same tensors
    runs."""
    cfg = get_config("smollm-135m", smoke=True)
    step = build_train_step(cfg, device="cpu", graphs=True)
    params, st = _state(step)
    step.fn(params, st, _batch(cfg, 0))
    held = [t.clone() for t in _leaves(params, st)]
    other_p, other_st = _state(step, seed=1)
    with pytest.raises(RuntimeError, match="another tree"):
        step.fn(other_p, st, _batch(cfg, 1))
    with pytest.raises(RuntimeError, match="another tree"):
        step.fn(params, other_st, _batch(cfg, 1))
    with pytest.raises(ValueError, match="another shape"):
        step.fn(params, st, _batch(cfg, 1, s=2 * S))
    with pytest.raises(ValueError, match="another shape"):
        step.fn(params, st, {"tokens": _batch(cfg, 1)["tokens"]})
    _assert_bits_equal(_leaves(params, st), held)
    _, st2, _ = step.fn(dict(params), AdamWState(*st), _batch(cfg, 1))
    assert int(st2.step) == 2


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b"])
def test_train_graph_warmup_leaves_the_state_bit_equal(arch):
    """Building the graph runs its warm-up (the gradient pass only): the
    params, moments and step counter stay bit-equal, and the static
    metrics take the loss's keys (``mtp`` with the MTP head)."""
    cfg = get_config(arch, smoke=True)
    step = build_train_step(cfg, device="cpu", graphs=False)
    params, st = _state(step)
    before = [t.clone() for t in _leaves(params, st)]
    graph = TrainGraph(step, params, st, _to_device(_batch(cfg, 0), CPU))
    _assert_bits_equal(_leaves(params, st), before)
    keys = ["aux_lb", "aux_z", "loss", "xent"] + (["mtp"] if cfg.mtp
                                                  else [])
    assert sorted(graph.metrics) == sorted(keys)
    assert all(t.dtype == torch.float32 and t.ndim == 0
               for t in graph.metrics.values())


# -- AdamW's step counter in place -------------------------------------------

def _update_with_new_counter(opt: AdamW, grads, state, params):
    """AdamW's update as it was before its step counter advanced in place:
    a new counter ``state.step + 1`` in a new state.  The oracle of
    ``test_adamw_counter_in_place_matches_a_new_counter``."""
    step = state.step + 1
    gs = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in gs))
    scale = torch.clamp(opt.grad_clip / (gn + 1e-9), max=1.0)
    b1, b2 = opt.b1, opt.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    lr = opt.lr * torch.tensor(0.7)
    with torch.no_grad():
        for g_all, m_all, v_all, p_all in zip(
                gs, tree_leaves(state.mu), tree_leaves(state.nu),
                tree_leaves(params)):
            for i in _row_slices(p_all):
                g, m, v, p = g_all[i], m_all[i], v_all[i], p_all[i]
                g = g.to(torch.float32) * scale
                m32 = b1 * m.to(torch.float32) + (1 - b1) * g
                v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
                delta = (m32 / c1) / (torch.sqrt(v32 / c2) + opt.eps)
                delta = delta + opt.weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr * delta)
                m.copy_(m32)
                v.copy_(v32)
    return params, AdamWState(step, state.mu, state.nu)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adamw_counter_in_place_matches_a_new_counter(moment_dtype):
    """Three updates with the counter advanced in place give the params,
    moments and counter of three with a new counter each time, bit for
    bit; the state returned is the state given."""
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(30, 7, 5, generator=gen).bfloat16(),
              "n": {"s": torch.randn(5, generator=gen)}}
    opt = AdamW(lr=1e-2, moment_dtype=moment_dtype)
    p_new, st_new = _clone(params, opt.init(params))
    p, st = _clone(params, opt.init(params))
    for k in range(3):
        grads = {"a": torch.randn(30, 7, 5, generator=gen),
                 "n": {"s": torch.randn(5, generator=gen) * 10 ** k}}
        p_new, st_new = _update_with_new_counter(opt, grads, st_new, p_new)
        counter = st.step
        p2, st2 = opt.update(grads, st, p, lr_scale=torch.tensor(0.7))
        assert p2 is p and st2 is st and st.step is counter
    assert int(st.step) == int(st_new.step) == 3
    _assert_bits_equal(_leaves(p, st), _leaves(p_new, st_new))


# -- the driver: resume by copying into the held tensors ---------------------

def test_driver_resume_on_the_graph_is_bit_equal(tmp_path, monkeypatch):
    """The driver on the graph's step (its direct form on the CPU), the
    pattern of ``tests/test_torch_train_driver.py``'s resume test:
    preempted at step 7 with a checkpoint every 3 steps, then resumed
    from step 6 by copying the checkpoint into the params and moments the
    graph holds; every loss bit-equal to the uninterrupted run's, which
    is bit-equal to the eager driver's."""
    common = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
              "--steps", "10", "--batch", "2", "--seq", "16"]
    eager = train_mod.main(common + ["--ckpt-every", "0",
                                     "--ckpt-dir", str(tmp_path / "e")])
    built = []

    def on_graph(*a, **k):
        step = build_train_step(*a, graphs=True, **k)
        built.append(step)
        return step
    monkeypatch.setattr(train_mod, "build_train_step", on_graph)
    ref = train_mod.main(common + ["--ckpt-every", "0",
                                   "--ckpt-dir", str(tmp_path / "a")])
    every = ["--ckpt-every", "3", "--ckpt-dir", str(tmp_path / "b")]
    pre = train_mod.main(common + every + ["--simulate-preemption-at", "7"])
    out = train_mod.main(common + every)
    assert len(built) == 3
    assert ref["losses"] == eager["losses"]
    assert pre["preempted_at"] == 7 and pre["losses"] == ref["losses"][:7]
    assert out["resumed_from"] == 6 and out["losses"] == ref["losses"][6:]


def test_driver_restore_copies_into_the_held_tensors(tmp_path, monkeypatch):
    """A resumed driver keeps training the tensors it made at the start:
    the checkpoint's values are copied into them, never bound in their
    place."""
    common = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
              "--steps", "4", "--batch", "2", "--seq", "16",
              "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    train_mod.main(common + ["--simulate-preemption-at", "3"])
    seen = []
    build = train_mod.build

    def spy(args):
        cfg, lm, opt, step_fn = build(args)
        init = lm.init

        def init_spy(seed):
            params, dims = init(seed)
            seen.append(list(tree_leaves(params)))
            return params, dims
        lm.init = init_spy

        def fn(params, opt_state, batch, i):
            assert all(a is b for a, b in zip(tree_leaves(params), seen[0]))
            return step_fn(params, opt_state, batch, i)
        return cfg, lm, opt, fn
    monkeypatch.setattr(train_mod, "build", spy)
    out = train_mod.main(common)
    assert out["resumed_from"] == 2 and len(out["losses"]) == 2


# -- the sLSTM's gate weights, cast once per sequence -------------------------

def _scan_cast_per_step(p, x, carry):
    """The sLSTM loop casting its gate weights at every step, as the
    reference's ``_slstm_step`` does: the oracle of the hoisted cast."""
    hs = []
    for t in range(x.shape[1]):
        carry, h = xlstm._slstm_step(p["w_gates"].to(torch.float32),
                                     p["r_gates"].to(torch.float32),
                                     carry, x[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), carry


def _slstm_params(seed: int = 0):
    jcfg = jget("xlstm-125m", smoke=True)
    pb = JParamBuilder(jax.random.PRNGKey(seed))
    jxlstm.init_slstm(pb, "s", jcfg)
    jp = pb.params["s"]
    return jcfg, jp, params_from_numpy(numpy_tree(jp), "cpu")


def _noop(t, dims, site=None):
    return t


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_cast_once_forward_is_bit_equal(with_state):
    """``slstm_block`` with the gate weights cast once per sequence
    against the loop that casts them at every step: the outputs and the
    final state bit for bit, from a fresh state and from a given one
    (the decode path's)."""
    cfg = get_config("xlstm-125m", smoke=True)
    _, _, p = _slstm_params()
    rng = np.random.default_rng(4)
    D = cfg.d_model
    x = torch.as_tensor(rng.standard_normal((B, S, D)),
                        dtype=torch.float32).bfloat16()
    state = None
    if with_state:
        state = xlstm.SLSTMState(*(torch.as_tensor(
            rng.standard_normal((B, D)), dtype=torch.float32)
            for _ in range(4)))
    got = xlstm.slstm_block(x, p, cfg, _noop, state=state)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(xlstm, "_slstm_scan", _scan_cast_per_step)
        want = xlstm.slstm_block(x, p, cfg, _noop, state=state)
    if with_state:
        _assert_bits_equal([got[0], *got[1]], [want[0], *want[1]])
    else:
        _assert_bits_equal([got], [want])


def test_slstm_cast_once_grads_match_reference():
    """The gradients of one sLSTM block (params and input) with the cast
    hoisted against the reference's, at ``GRAD_REL`` of each leaf's
    largest magnitude (+1e-6).  Its gate weights' gradients are now
    summed over the steps in f32 and rounded once, where the per-step
    cast summed each step's bf16 gradient in bf16: both stay within the
    reference's tolerance of each other."""
    jcfg, jp, p = _slstm_params()
    cfg = get_config("xlstm-125m", smoke=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(pp, xx):
        out = jxlstm.slstm_block(xx, pp, jcfg, _noop)
        return jnp.sum(out.astype(jnp.float32) * w)
    want = _strict_jit(jax.grad(jloss, argnums=(0, 1)), jp,
                       jnp.asarray(x, jnp.bfloat16))

    def grads(scan=None):
        tp = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        xt = torch.as_tensor(x).bfloat16().requires_grad_()
        with pytest.MonkeyPatch.context() as m:
            if scan is not None:
                m.setattr(xlstm, "_slstm_scan", scan)
            loss = (xlstm.slstm_block(xt, tp, cfg, _noop).float()
                    * torch.as_tensor(w)).sum()
            got = torch.autograd.grad(loss, [*tp.values(), xt])
        return dict(zip([*tp, "x"], got))
    got, per_step = grads(), grads(_scan_cast_per_step)
    for name, g in got.items():
        wnt = f32(want[1] if name == "x" else want[0][name])
        atol = GRAD_REL * np.abs(wnt).max() + 1e-6
        np.testing.assert_allclose(f32(g), wnt, rtol=0, atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(f32(g), f32(per_step[name]), rtol=0,
                                   atol=atol, err_msg=name)
        if name not in ("w_gates", "r_gates"):
            assert torch.equal(g, per_step[name]), name
