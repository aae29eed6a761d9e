"""The port's train step against the reference's: ``cross_entropy``,
``LM.loss_fn`` and its gradients, ``AdamW``, ``cosine_schedule``, the
data pipeline and one ``build_train_step`` step, on the smoke configs
with the reference's params bridged in; remat, gradient accumulation and
the kernel wrappers' refusal of gradients, port against port.

The reference's loss and gradients are computed once per config (module
fixtures), jitted with XLA's ``xla_allow_excess_precision`` off
(``_strict_jit``).  With it on, XLA keeps fused bf16 intermediates in
f32, and the jitted gradients differ from the reference's own op-by-op
gradients (``jax.disable_jit``) by more than the tolerance: xlstm's by
up to 4.5% of a leaf's largest magnitude, jamba's by up to 2.7 times it
(its router chooses other experts).  With it off they agree with the
op-by-op gradients within 0.7% and 2e-7, and compile in a third of the
op-by-op run's time.

On jamba's smoke config even the op-by-op gradients are at their noise
floor: moving one weight of the first Mamba layer by one bf16 step moves
the reference's own gradients by up to 9.5% of a leaf's largest
magnitude (and the port's sit within 5.2% of them).  So the whole
model's jamba gradients are held at 0.1 of that magnitude, and each of
its blocks (the Mamba mixer, the MoE FFN) at the 2e-2 of the others.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget
from repro.configs.base import ShapeSpec
from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticCorpus as JCorpus
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.layers import ParamBuilder as JParamBuilder
from repro.models.layers import cross_entropy as jxent
from repro.models.lm import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader, SyntheticCorpus
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.mlstm_chunk import ops as tml
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.kernels.rmsnorm import ops as trms
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import cross_entropy
from repro_torch.models.lm import LM
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from torch_parity import RouterPin, f32, numpy_tree
from torch_parity import flat as _flat
from torch_parity import strict_jit as _strict_jit

B, S = 2, 16          # S a multiple of the smoke chunks (16)
#: loss and metrics against the reference
LOSS_TOL = dict(atol=5e-3, rtol=1e-3)
#: a gradient leaf against the reference's: this share of its largest
#: magnitude (+1e-6), for bf16 gradients
GRAD_REL = 2e-2
#: the gradient share by arch (jamba's: its noise floor, see the module
#: docstring)
PARITY_ARCHS = {"smollm-135m": GRAD_REL, "xlstm-125m": GRAD_REL,
                "jamba-v0.1-52b": 0.1}


def _batch(vocab, b=B, s=S, step=0):
    return SyntheticCorpus(vocab, seed=0).batch(step, 0, b, s)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart two bf16 tensors are, elementwise."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 step at |x| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def step_bound(p0: np.ndarray, lr: float, wd: float) -> np.ndarray:
    """The most two AdamW steps from ``p0`` can part: each moves a param
    by lr·(u + wd·p) with |u| <= 1 (the first step's u is sign(g)), plus
    one bf16 step of |p| for the rounding of the stored param."""
    return 2 * lr * (1 + wd * np.abs(p0)) + _bf16_ulp(p0)


# -- cross_entropy ------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_and_grad(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 8, 64)) * 3).astype(np.float32)
    labels = rng.integers(0, 64, (2, 8))
    want, want_g = jax.value_and_grad(jxent)(
        jnp.asarray(logits), jnp.asarray(labels, jnp.int32), z_loss)
    x = torch.tensor(logits, requires_grad=True)
    got = cross_entropy(x, torch.as_tensor(labels), z_loss)
    (got_g,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(got_g), f32(want_g), rtol=2e-4,
                               atol=2e-4)


# -- AdamW and the schedule ---------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Three updates from the same params, grads and moments: one with
    the clip active, one with a tensor ``lr_scale`` (the schedule's).
    f32 leaves agree within 2e-6, bf16 leaves equal or one step apart."""
    rng = np.random.default_rng(1)
    shapes = {"w": ((16, 8), jnp.bfloat16, torch.bfloat16),
              "n": {"scale": ((8,), jnp.float32, torch.float32)},
              "e": ((4, 3, 8), jnp.bfloat16, torch.bfloat16)}

    def draw(scale):
        def one(spec):
            if isinstance(spec, dict):
                return {k: one(v) for k, v in spec.items()}
            shape, jd, td = spec
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            return (jnp.asarray(a, jd),
                    torch.as_tensor(a).to(td))
        return one(shapes)

    def split(tree, i):
        return {k: split(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    params = draw(1.0)
    jp, tp = split(params, 0), split(params, 1)
    jopt = JAdamW(moment_dtype=moment_dtype)
    topt = AdamW(moment_dtype=moment_dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    sched = [1.0, 0.5, jcosine(1.0, 1, 4)]
    for i, gscale in enumerate([10.0, 0.01, 0.3]):   # 10: the clip acts
        g = draw(gscale)
        jg, tg = split(g, 0), split(g, 1)
        lr_j = sched[i](2) if callable(sched[i]) else sched[i]
        lr_t = (cosine_schedule(1.0, 1, 4)(torch.tensor(2))
                if callable(sched[i]) else sched[i])
        jp, js = jopt.update(jg, js, jp, lr_scale=lr_j)
        tp, ts = topt.update(tg, ts, tp, lr_scale=lr_t)
        assert int(ts.step) == int(js.step) == i + 1
        for name, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu),
                             ("nu", js.nu, ts.nu)):
            jf, tf = _flat(numpy_tree(jt)), _flat(tt)
            assert sorted(jf) == sorted(tf)
            for path, a in jf.items():
                t = tf[path]
                if t.dtype == torch.bfloat16:
                    want = torch.as_tensor(np.asarray(a, np.float32)) \
                        .to(torch.bfloat16)
                    assert int(_bf16_ulps(t, want).max()) <= 1, \
                        (i, name, path)
                else:
                    assert t.dtype == torch.float32
                    np.testing.assert_allclose(f32(t), f32(a), rtol=0,
                                               atol=2e-6,
                                               err_msg=f"{i} {name} {path}")


def test_adamw_updates_in_place():
    """The counterpart of the reference's donation: the tensors passed in
    are the ones returned, written with the new values, the step counter
    too (a CUDA graph of the update reads and advances that one
    tensor)."""
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    counter = st.step
    before = p["w"].clone()
    new_p, new_st = opt.update({"w": torch.ones(4, 4)}, st, p)
    assert new_p["w"] is p["w"] and new_st.mu["w"] is st.mu["w"]
    assert not torch.equal(p["w"], before)
    assert new_st is st and new_st.step is counter and int(st.step) == 1


def _sliced_updates(monkeypatch, moment_dtype):
    """Params and moments after three updates at slice sizes 2^26, 64
    and 1, and the leaves the first run started from."""
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(30, 7, 5, generator=gen).bfloat16(),
              "b": torch.randn((), generator=gen),
              "c": torch.randn(2, 1000, generator=gen).bfloat16()}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    out = []
    for size in (1 << 26, 64, 1):
        monkeypatch.setattr(adamw_mod, "_SLICE", size)
        opt = AdamW(lr=1e-2, moment_dtype=moment_dtype)
        p = {k: v.clone() for k, v in params.items()}
        st = opt.init(p)
        for _ in range(3):
            p, st = opt.update(grads, st, p, lr_scale=torch.tensor(0.7))
        out.append([*p.values(), *st.mu.values(), *st.nu.values()])
    return out, params


def test_adamw_update_in_slices_is_bit_equal(monkeypatch):
    """The update runs over slices of each leaf's first axis (its f32
    temporaries stay small on large leaves): any slice size gives the
    same params and moments, bit for bit, a scalar leaf included."""
    out, params = _sliced_updates(monkeypatch, "f32")
    assert len(list(adamw_mod._row_slices(params["a"]))) == 30
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


def test_adamw_update_in_slices_keeps_bf16_moments_bit_equal(monkeypatch):
    """The same with deepseek-v3's bf16 moments: each slice rounds its
    moments to bf16 as the whole leaf does."""
    out, _ = _sliced_updates(monkeypatch, "bf16")
    assert all(t.dtype == torch.bfloat16 for t in out[0][3:])
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


@pytest.mark.parametrize("warmup,total", [(1, 20), (5, 50), (0, 10)])
def test_cosine_schedule_matches_reference(warmup, total):
    want = jcosine(1.0, warmup, total)
    got = cosine_schedule(1.0, warmup, total)
    for step in (0, warmup, (warmup + total) // 2, total, total + 3):
        np.testing.assert_allclose(f32(got(step)), f32(want(step)),
                                   rtol=0, atol=1e-7, err_msg=str(step))
        assert got(torch.tensor(step)).dtype == torch.float32


# -- the data pipeline --------------------------------------------------------

def test_synthetic_corpus_matches_reference_bit_for_bit():
    for vocab, seed, step, shard in [(256, 0, 0, 0), (49152, 3, 7, 1)]:
        want = JCorpus(vocab, seed=seed).batch(step, shard, 3, 17)
        got = SyntheticCorpus(vocab, seed=seed).batch(step, shard, 3, 17)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_sharded_loader_matches_reference_bit_for_bit():
    want = JLoader(JCorpus(512, seed=1), 4, 9, n_hosts=2, host_id=1)
    got = ShardedLoader(SyntheticCorpus(512, seed=1), 4, 9, n_hosts=2,
                        host_id=1)
    for step in (0, 5):
        for k, v in want.batch_at(step).items():
            np.testing.assert_array_equal(got.batch_at(step)[k], v)
    re = got.reshard(1, 0)
    np.testing.assert_array_equal(
        re.batch_at(2)["tokens"],
        want.reshard(1, 0).batch_at(2)["tokens"])
    it = iter(got)
    try:
        for step in range(3):
            b = next(it)
            np.testing.assert_array_equal(b["tokens"],
                                          want.batch_at(step)["tokens"])
    finally:
        it.close()
    with pytest.raises(ValueError, match="divide"):
        ShardedLoader(SyntheticCorpus(512), 3, 9, n_hosts=2)


# -- loss_fn and its gradients ------------------------------------------------

@pytest.fixture(scope="module", params=list(PARITY_ARCHS))
def loss_pair(request):
    """The reference's loss and gradients on one smoke config, and the
    port's LM with the same params."""
    arch = request.param
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    batch = _batch(jlm.cfg.vocab)

    def ref(p, b):
        return (jax.value_and_grad(jlm.loss_fn, has_aux=True)(p, b),
                _dropped(jlm, p, b))
    ((_, jmetrics), jgrads), dropped = _strict_jit(ref, jparams,
                                                   _jbatch(batch))
    lm = LM(get_config(arch, smoke=True), device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    return dict(batch=batch, jmetrics=jmetrics, jgrads=jgrads,
                dropped=dropped, lm=lm, params=params,
                grad_rel=PARITY_ARCHS[arch])


def _dropped(jlm, jparams, batch):
    """The largest dropped fraction of the reference's super blocks on
    this batch (its loss does not report it); 0 without MoE layers."""
    if jlm.cfg.moe is None:
        return jnp.zeros(())
    resid, img = jlm._embed(jparams, batch)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    worst = jnp.zeros(())
    for gi, (pattern, repeats) in enumerate(jlm._groups()):
        assert repeats == 1
        resid, aux, _ = jlm._super_block(resid, jparams[f"group{gi}"],
                                         pattern, pos, img)
        worst = jnp.maximum(worst, aux.dropped_fraction)
    return worst


def test_loss_fn_and_grads_match_reference(loss_pair):
    """Loss and metrics within atol 5e-3, rtol 1e-3; each gradient leaf
    within 2e-2 of its largest reference magnitude (+1e-6; jamba 0.1,
    see the module docstring).  On jamba's smoke config (capacity factor
    4) no token is dropped, so the reference's slot-0 overflow fault
    (ROADMAP C) is not in its loss."""
    lp = loss_pair
    lm, params, batch = lp["lm"], lp["params"], lp["batch"]
    assert float(lp["dropped"]) == 0.0
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = lm.loss_fn(tree_unflatten(params, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(metrics) == sorted(lp["jmetrics"]) == \
        ["aux_lb", "aux_z", "loss", "xent"]
    assert metrics["loss"] is loss
    for k, v in lp["jmetrics"].items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), **LOSS_TOL,
                                   err_msg=k)
    if lm.cfg.moe is None:
        assert float(metrics["aux_lb"]) == float(metrics["aux_z"]) == 0.0
    else:
        assert float(metrics["aux_lb"].detach()) > 0
    jg = _flat(numpy_tree(lp["jgrads"]))
    tg = _flat(tree_unflatten(params, list(grads)))
    assert sorted(jg) == sorted(tg)
    for path, want in jg.items():
        got = tg[path]
        assert got.dtype == _flat(params)[path].dtype
        w = f32(want)
        np.testing.assert_allclose(
            f32(got), w, rtol=0,
            atol=lp["grad_rel"] * np.abs(w).max() + 1e-6, err_msg=path)


@pytest.mark.parametrize("block", ["mamba", "moe"])
def test_jamba_block_grads_match_reference(block):
    """The gradients of one jamba block (a Mamba mixer of the smoke
    config, or an MoE FFN with its aux losses at the loss weights) with
    respect to its params and its input, against the reference's, at
    2e-2 of each leaf's largest magnitude (+1e-6)."""
    jcfg = jget("jamba-v0.1-52b", smoke=True)
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    pb = JParamBuilder(jax.random.PRNGKey(0))
    (jssm.init_mamba if block == "mamba" else jmoe.init_moe)(pb, "m", jcfg)
    jp = pb.params["m"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def noop(t, dims, site=None):
        return t

    def jloss(p, xx):
        if block == "mamba":
            out = jssm.mamba_block(xx, p, jcfg, noop)
            return jnp.sum(out.astype(jnp.float32) * w)
        out, aux = jmoe.moe_ffn(xx, p, jcfg, noop)
        return (jnp.sum(out.astype(jnp.float32) * w)
                + tlm.AUX_LB_WEIGHT * aux.load_balance_loss
                + tlm.AUX_Z_WEIGHT * aux.router_z_loss)
    want = _strict_jit(jax.grad(jloss, argnums=(0, 1)), jp,
                       jnp.asarray(x, jnp.bfloat16))
    tp = {k: v.requires_grad_()
          for k, v in params_from_numpy(numpy_tree(jp), "cpu").items()}
    xt = torch.as_tensor(x).bfloat16().requires_grad_()
    if block == "mamba":
        loss = (tssm.mamba_block(xt, tp, cfg, noop).float()
                * torch.as_tensor(w)).sum()
    else:
        out, aux = tmoe.moe_ffn(xt, tp, cfg, noop)
        assert float(aux.dropped_fraction.detach()) == 0.0
        loss = ((out.float() * torch.as_tensor(w)).sum()
                + tlm.AUX_LB_WEIGHT * aux.load_balance_loss
                + tlm.AUX_Z_WEIGHT * aux.router_z_loss)
    got = torch.autograd.grad(loss, [*tp.values(), xt])
    pairs = [(k, want[0][k], g) for k, g in zip(tp, got)]
    for name, wnt, g in pairs + [("x", want[1], got[-1])]:
        wnt = f32(wnt)
        np.testing.assert_allclose(
            f32(g), wnt, rtol=0, atol=GRAD_REL * np.abs(wnt).max() + 1e-6,
            err_msg=name)


# -- one train step -----------------------------------------------------------

@pytest.fixture(scope="module")
def dense_step():
    """The reference's ``build_train_step`` on the dense smoke config
    (its plan from ``optimize``, a 1x1 mesh) and one step from seed 0."""
    from repro.core import MeshSpec, build_lm_graph, optimize
    from repro.launch.mesh import make_host_mesh, set_mesh
    from repro.launch.steps import build_train_step as jbuild
    jcfg = jget("smollm-135m", smoke=True)
    shape = ShapeSpec("t", S, 4, "train")
    _, plan, _ = optimize(build_lm_graph(jcfg, shape),
                          MeshSpec((("data", 1), ("model", 1))),
                          training=True)
    mesh = make_host_mesh((1, 1))
    batch = _batch(jcfg.vocab, b=4)
    with set_mesh(mesh):
        step = jbuild(jcfg, shape, mesh, plan)
        jlm = JLM(jcfg, plan=plan, mesh=mesh)
        jparams, _ = jlm.init(jax.random.PRNGKey(0))
        p0 = numpy_tree(jparams)
        jopt = JAdamW(moment_dtype=jcfg.opt_moment_dtype)
        p1, s1, m1 = step.fn(jparams, jopt.init(jparams), _jbatch(batch))
    return dict(p0=p0, p1=numpy_tree(p1), s1=s1, m1=m1, batch=batch,
                opt=jopt)


def test_train_step_matches_reference(dense_step):
    """One port step against one reference step from the same params and
    batch: metrics as ``loss_fn``'s; every updated param within the step
    bound; the moments within the bf16 tolerance (they are built from
    bf16 gradients), the step counter equal."""
    d = dense_step
    step = build_train_step(get_config("smollm-135m", smoke=True),
                            device="cpu")
    params = step.lm.load_params(d["p0"])
    st = step.opt.init(params)
    params, st, metrics = step.fn(params, st, d["batch"])
    for k, v in d["m1"].items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), **LOSS_TOL,
                                   err_msg=k)
    assert int(st.step) == int(d["s1"].step) == 1
    p0, want = _flat(d["p0"]), _flat(d["p1"])
    got = _flat(params)
    opt = d["opt"]
    for path, w in want.items():
        g, w0 = f32(got[path]), f32(p0[path])
        bound = step_bound(w0, opt.lr, opt.weight_decay)
        assert np.all(np.abs(g - f32(w)) <= bound), path
        # and the step itself: most params move as the reference's do
        same = np.abs(g - f32(w)) <= _bf16_ulp(w0)
        assert same.mean() > 0.99, (path, same.mean())
    for name in ("mu", "nu"):
        jm = _flat(numpy_tree(getattr(d["s1"], name)))
        tm = _flat(getattr(st, name))
        for path, w in jm.items():
            w = f32(w)
            np.testing.assert_allclose(
                f32(tm[path]), w, rtol=2e-2,
                atol=2e-2 * np.abs(w).max() + 1e-12,
                err_msg=f"{name} {path}")


# -- remat, accumulation, the guard -------------------------------------------

class _CountProducts(TorchDispatchMode):
    """Counts the un-batched matrix products that run (a product that
    selective checkpointing serves from its cache does not reach it)."""
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,n_layers", [("smollm-135m", None),
                                           ("jamba-v0.1-52b", 16)])
def test_remat_modes_bit_equal(arch, n_layers):
    """``remat`` none, full and dots give the same loss and gradients, bit
    for bit, on configs with a stacked group (jamba's smoke pattern at 16
    layers, two periods, MoE layers inside).  ``full`` recomputes every
    stacked layer in the backward pass, ``dots`` keeps the un-batched
    matrix products; neither applies without gradients (prefill)."""
    cfg = get_config(arch, smoke=True)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    (pattern, repeats), = [g for g in cfg.layer_groups() if g[1] > 1]
    params, _ = LM(cfg, device="cpu").init(0)
    batch = _batch(cfg.vocab)
    out = {}
    for remat in tlm.REMATS:
        step = build_train_step(cfg, remat=remat, device="cpu")
        calls = []
        orig = step.lm._super_block
        step.lm._super_block = lambda *a, **k: (calls.append(1),
                                                orig(*a, **k))[1]
        with _CountProducts() as products:
            grads, metrics = step.grads(params, batch)
        out[remat] = (metrics, _flat(grads), len(calls), products.n)
        with torch.no_grad():
            calls.clear()
            step.lm.prefill(params, {"tokens": torch.as_tensor(
                batch["tokens"])})
        assert len(calls) == len(cfg.layer_groups()) - 1 + repeats, remat
    m0, g0, calls0, mm0 = out["none"]
    assert calls0 == len(cfg.layer_groups()) - 1 + repeats
    for remat in ("full", "dots"):
        m, g, calls, mm = out[remat]
        assert calls == calls0 + repeats, remat      # the recompute
        for k in m0:
            assert torch.equal(m[k], m0[k]), (remat, k)
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)
    # the recompute of full runs the products again; dots keeps them
    assert out["full"][3] > mm0 == out["dots"][3]


def test_remat_refuses_unknown_mode():
    with pytest.raises(ValueError, match="remat"):
        LM(get_config("smollm-135m", smoke=True), device="cpu",
           remat="offload")


def test_grad_accumulation_matches_full_batch():
    """The reference's ``test_grad_accumulation_matches_full_batch``
    (``tests/test_substrate.py``), port against port: ``accum_steps=2``
    gives the full-batch update within rtol 2e-2, atol 2e-3, and returns
    the last micro-batch's metrics, as the reference's scan carry does."""
    cfg = get_config("smollm-135m", smoke=True)
    batch = _batch(cfg.vocab, b=4)
    outs = {}
    for accum in (1, 2):
        step = build_train_step(cfg, remat="none", accum_steps=accum,
                                device="cpu")
        params, _ = step.lm.init(0)
        p0 = {k: v.clone() for k, v in _flat(params).items()}
        st = step.opt.init(params)
        p1, st, metrics = step.fn(params, st, batch)
        outs[accum] = (_flat(p1), metrics)
        assert any(not torch.equal(p0[k], v) for k, v in _flat(p1).items())
    for path, a in outs[1][0].items():
        np.testing.assert_allclose(f32(a), f32(outs[2][0][path]),
                                   rtol=2e-2, atol=2e-3, err_msg=path)
    # the metrics of the second micro-batch (rows 2-3), from the params
    # the step started from
    lm = LM(cfg, device="cpu", remat="none")
    params, _ = lm.init(0)
    with torch.no_grad():
        _, last = lm.loss_fn(params, {k: torch.as_tensor(v[2:]) for k, v in
                                      batch.items()})
    for k, v in last.items():
        np.testing.assert_allclose(f32(outs[2][1][k]), f32(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert abs(float(outs[1][1]["loss"]) - float(last["loss"])) > 1e-4
    with pytest.raises(ValueError, match="micro-batches"):
        build_train_step(cfg, accum_steps=3, device="cpu").grads(
            params, batch)


def test_train_step_leaves_no_grad_state():
    cfg = get_config("xlstm-125m", smoke=True)
    step = build_train_step(cfg, device="cpu")
    params, _ = step.lm.init(0)
    st = step.opt.init(params)
    params, st, m = step.fn(params, st, _batch(cfg.vocab))
    assert step.lm.graphs is False
    for t in tree_leaves(params):
        assert t.grad is None and not t.requires_grad
    assert all(not v.requires_grad for v in m.values())


def _wrapper_calls() -> dict:
    """Each kernel wrapper on small CPU inputs: {name: (fn, inputs)}."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    return {
        "rmsnorm": (lambda x, s: trms.rmsnorm(x, s), [r(4, 16), r(16)]),
        "flash_attention": (lambda q, k, v: tfa.flash_attention(q, k, v),
                            [r(2, 2, 8, 16), r(2, 8, 16), r(2, 8, 16)]),
        "mha": (lambda q, k, v: tfa.mha(q, k, v),
                [r(1, 8, 4, 16), r(1, 8, 2, 16), r(1, 8, 2, 16)]),
        "mlstm_chunk": (lambda q, k, v, i, f: tml.mlstm_chunk(
            q, k, v, i, f, chunk=8),
            [r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2),
             r(1, 8, 2)]),
        "ssd_scan": (lambda x, dt, A, Bm, Cm: tssd.ssd_scan(
            x, dt.abs(), -A.abs(), Bm, Cm, chunk=8),
            [r(1, 8, 16), r(1, 8, 16), r(16, 4), r(1, 8, 4), r(1, 8, 4)]),
        "moe_gmm": (lambda x, w: tgmm.moe_gmm(
            x, w, torch.tensor([3, 8], dtype=torch.int32)),
            [r(2, 8, 16), r(2, 16, 8)]),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "mha",
                                  "mlstm_chunk", "ssd_scan", "moe_gmm"])
def test_kernel_wrappers_refuse_gradients(name):
    """Every kernel wrapper raises when an input requires grad under grad
    mode (its output would carry none); without grad mode, or with no
    input requiring grad, it runs as before."""
    fn, xs = _wrapper_calls()[name]
    want = fn(*xs)
    for i in range(len(xs)):
        ys = [x.clone().requires_grad_(j == i) for j, x in enumerate(xs)]
        with pytest.raises(RuntimeError, match="carry no gradient"):
            fn(*ys)
        with torch.no_grad():
            assert torch.equal(fn(*ys), want), (name, i)


def test_loss_through_kernels_refuses_gradients():
    cfg = get_config("smollm-135m", smoke=True)
    lm = LM(cfg, use_kernels=True, device="cpu")
    params, _ = lm.init(0)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab).items()}
    with torch.no_grad():
        lm.loss_fn(params, batch)
    params = {**params, "final_norm": {
        "scale": params["final_norm"]["scale"].clone().requires_grad_()}}
    with pytest.raises(RuntimeError, match="carry no gradient"):
        lm.loss_fn(params, batch)
    with pytest.raises(NotImplementedError, match="carry no gradient"):
        build_train_step(cfg, use_kernels=True, device="cpu")


def test_train_step_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(get_config("smollm-135m", smoke=True))


# -- deepseek: MLA, the MTP loss, bf16 moments --------------------------------

DS_ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=DS_ARCHS)
def ds_pair(request):
    """The reference's strict-jit loss and gradients on a deepseek smoke
    config (MLA in every layer, MoE from the second; deepseek-v3 adds the
    MTP head), the expert ids its router picks op by op, and the port's
    LM with the same params."""
    arch = request.param
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    batch = _batch(jlm.cfg.vocab)
    (_, jmetrics), jgrads = _strict_jit(
        jax.value_and_grad(jlm.loss_fn, has_aux=True), jparams,
        _jbatch(batch))
    pin = RouterPin()
    with jax.disable_jit(), pin.recording():
        jlm.loss_fn(jparams, _jbatch(batch))
    # no remat: its recompute would route once more, past the replay
    lm = LM(get_config(arch, smoke=True), device="cpu", remat="none")
    return dict(batch=batch, jmetrics=jmetrics, jgrads=jgrads, pin=pin,
                lm=lm, params=lm.load_params(numpy_tree(jparams)),
                jparams=jparams)


def test_deepseek_loss_fn_and_grads_match_reference(ds_pair):
    """``loss_fn`` with its ``xent``, ``aux_*`` and (deepseek-v3) ``mtp``
    metrics within atol 5e-3, rtol 1e-3 of the reference's; every
    gradient leaf within 2e-2 of its largest reference magnitude, with
    the reference's expert choices replayed in the port."""
    d = ds_pair
    lm, params = d["lm"], d["params"]
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tb = {k: torch.as_tensor(v) for k, v in d["batch"].items()}
    with d["pin"].replaying():
        loss, metrics = lm.loss_fn(tree_unflatten(params, leaves), tb)
    assert d["pin"].moved <= 1
    grads = torch.autograd.grad(loss, leaves)
    want_keys = ["aux_lb", "aux_z", "loss", "xent"] + (
        ["mtp"] if lm.cfg.mtp else [])
    assert sorted(metrics) == sorted(d["jmetrics"]) == sorted(want_keys)
    for k, v in d["jmetrics"].items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), **LOSS_TOL,
                                   err_msg=k)
    jg = _flat(numpy_tree(d["jgrads"]))
    tg = _flat(tree_unflatten(params, list(grads)))
    assert sorted(jg) == sorted(tg)
    if lm.cfg.mtp:
        assert {p.split("/")[1] for p in tg if p.startswith("mtp/")} == {
            "proj", "norm1", "mix", "norm2", "ffn"}
    for path, want in jg.items():
        w = f32(want)
        np.testing.assert_allclose(
            f32(tg[path]), w, rtol=0,
            atol=GRAD_REL * np.abs(w).max() + 1e-6, err_msg=path)


def test_deepseek_v3_adamw_step_bf16_moments_matches_reference():
    """One train step of deepseek-v3's smoke config, whose config selects
    bf16 AdamW moments, against the reference's gradients and update:
    the moments are bf16 and within the bf16 tolerance of the
    reference's, every updated param within the step bound."""
    arch = "deepseek-v3-671b"
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    batch = _batch(jlm.cfg.vocab)
    jopt = JAdamW(moment_dtype="bf16")

    def ref_step(p, b):
        (_, m), g = jax.value_and_grad(jlm.loss_fn, has_aux=True)(p, b)
        p1, s1 = jopt.update(g, jopt.init(p), p)
        return p1, s1, m
    p0 = numpy_tree(jparams)
    jp1, js1, jm = _strict_jit(ref_step, jparams, _jbatch(batch))
    step = build_train_step(get_config(arch, smoke=True), device="cpu")
    assert step.opt.moment_dtype == "bf16"
    params = step.lm.load_params(p0)
    st = step.opt.init(params)
    params, st, metrics = step.fn(params, st, batch)
    for k, v in jm.items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), **LOSS_TOL,
                                   err_msg=k)
    assert int(st.step) == int(js1.step) == 1
    want, got, w0s = _flat(numpy_tree(jp1)), _flat(params), _flat(p0)
    for path, w in want.items():
        g, w0 = f32(got[path]), f32(w0s[path])
        assert np.all(np.abs(g - f32(w)) <= step_bound(
            w0, jopt.lr, jopt.weight_decay)), path
    for name in ("mu", "nu"):
        jm_, tm = _flat(numpy_tree(getattr(js1, name))), _flat(
            getattr(st, name))
        for path, w in jm_.items():
            assert tm[path].dtype == torch.bfloat16, (name, path)
            w = f32(w)
            np.testing.assert_allclose(
                f32(tm[path]), w, rtol=2e-2,
                atol=2e-2 * np.abs(w).max() + 1e-12,
                err_msg=f"{name} {path}")


def test_grad_accumulation_carries_mtp():
    """With ``accum_steps=2`` the step returns the last micro-batch's
    metrics, ``mtp`` among them, as the reference's scan carry seeds and
    returns it."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    batch = _batch(cfg.vocab, b=4)
    step = build_train_step(cfg, remat="none", accum_steps=2, device="cpu")
    params, _ = step.lm.init(0)
    with torch.no_grad():
        _, last = step.lm.loss_fn(params, {k: torch.as_tensor(v[2:])
                                           for k, v in batch.items()})
    _, _, metrics = step.fn(params, step.opt.init(params), batch)
    assert sorted(metrics) == ["aux_lb", "aux_z", "loss", "mtp", "xent"]
    for k, v in last.items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert float(metrics["mtp"]) > 0
