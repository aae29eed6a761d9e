"""The port's expert-parallel MoE (``moe_ffn_ep``, ``LM(mesh=...)``)
against the reference's ``shard_map`` + ``all_to_all`` path.

The reference runs once, in a JAX process with four host devices
(``--xla_force_host_platform_device_count=4``, as
``tests/test_multidevice.py`` runs it), on a ``(2, 2)`` ``("data",
"model")`` mesh of Auto axes, jitted with XLA's excess precision off (so
the d_ff-split partial outputs round to bf16 before their sum, as the
port's do), on deepseek-v2's smoke config at capacity
factor 8 (dropless, so capacity per source shard and globally agree).
The port runs on four gloo ranks (``tests/torch_ranks.py``, mode ``ep``)
on the same mesh, rank ``2 i + j`` at position ``(i, j)``.  The three
production layouts of ``tests/goldens/pre_dse``:

* jamba's: experts over ``("model",)``;
* deepseek-v2's: experts over ``("data",)``, each expert's d_ff split
  over ``"model"`` (``moe_tp``);
* deepseek-v3's: experts over ``("model", "data")``, which JAX reads
  model-major while a process group orders its ranks data-major (the
  exchange permutes its chunks: a wrong order sends tokens to the wrong
  experts and the outputs part).

For each: y from bf16 inputs at 2e-2 and the three aux values at 2e-4
(DTensor inputs localised by ``local_map``, and each rank's plain blocks),
the same y against the port's global ``moe_ffn`` (at the reference
test's tolerance, and at 2e-2 without a d_ff split), and the gradients of
x, ``w_router``, ``w_in`` and ``w_out`` of ``sum(y·ct) + 0.01·lb +
0.001·z`` from f32 inputs at 2e-4 against ``jax.grad`` (DTensor leaves,
and each rank's blocks of a plain run).  Then ``LM(cfg, plan, mesh)``'s
loss and prefill logits under a hand-written plan with an ``experts``
rule, its params and batch placed as DTensors, against the reference's
LM jitted on the mesh (XLA's excess precision off, so it rounds as the
port does) and against the port's LM without a mesh.  Last, the dispatch
rule: S = 1 and ``E % G != 0`` never take the expert-parallel path.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_parity import tol
from torch_ranks import SRC, spawn
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

LAYOUTS = [[["data"], ["model"], None],
           [["data"], ["data"], "model"],
           [["data"], ["model", "data"], None]]
B, S = 4, 8
LM_B, LM_S = 4, 8
CF = 8.0

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.core import ShardingPlan
from repro.core.estimator import MeshSpec
from repro.launch.mesh import set_mesh
from repro.models.layers import ParamBuilder
from repro.models.lm import LM
from repro.models.moe import init_moe, moe_ffn_ep

spec = json.load(open(sys.argv[1]))
out_path = sys.argv[2]
assert len(jax.devices()) == 4, jax.devices()
cfg = get_config("deepseek-v2-236b", smoke=True)
object.__setattr__(cfg.moe, "capacity_factor", spec["cf"])
pb = ParamBuilder(jax.random.PRNGKey(0))
init_moe(pb, "m", cfg)
p = pb.params["m"]
B, S, D = spec["B"], spec["S"], cfg.d_model
rng = np.random.default_rng(0)
x = rng.normal(size=(B, S, D)).astype(np.float32)
ct = rng.normal(size=(B, S, D)).astype(np.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {"x": x, "ct": ct}
dtypes = {}
for k, v in p.items():
    out[f"moe/{k}"] = np.asarray(v, np.float32)
    dtypes[f"moe/{k}"] = str(v.dtype)
p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)


def strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


for i, (b, e, tp) in enumerate(spec["layouts"]):
    b, e = tuple(b), tuple(e)
    with set_mesh(mesh):
        y, aux = strict(lambda x, p: moe_ffn_ep(
            x, p, cfg, b, e, (), mesh, tp_axis=tp),
            jnp.asarray(x, jnp.bfloat16), p)

        def loss(x, wr, wi, wo):
            y, a = moe_ffn_ep(x, {**p32, "w_router": wr, "w_in": wi,
                                  "w_out": wo}, cfg, b, e, (), mesh,
                              tp_axis=tp)
            return (jnp.sum(y * ct) + 0.01 * a.load_balance_loss
                    + 0.001 * a.router_z_loss)
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            jnp.asarray(x), p32["w_router"], p32["w_in"], p32["w_out"])
    out[f"{i}/y"] = np.asarray(y, np.float32)
    out[f"{i}/aux"] = np.asarray([aux.load_balance_loss, aux.router_z_loss,
                                  aux.dropped_fraction], np.float32)
    for name, gi in zip(("x", "w_router", "w_in", "w_out"), g):
        out[f"{i}/g/{name}"] = np.asarray(gi, np.float32)

# the LM under a hand-written plan with an experts rule, jitted on the
# mesh with XLA's excess precision off
plan = ShardingPlan(MeshSpec((("data", 2), ("model", 2))),
                    rules={k: tuple(v) for k, v in spec["rules"].items()})
lm = LM(cfg, plan=plan, mesh=mesh, remat="none")
params, _ = lm.init(jax.random.PRNGKey(0))
toks = rng.integers(0, cfg.vocab, (spec["LM_B"], spec["LM_S"] + 1))
batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
         "labels": jnp.asarray(toks[:, 1:], jnp.int32)}

with set_mesh(mesh):
    loss, _ = strict(lm.loss_fn, params, batch)
    logits = strict(lm.prefill, params, {"tokens": batch["tokens"]})
out["lm/loss"] = np.asarray(loss, np.float32)
out["lm/logits"] = np.asarray(logits, np.float32)
out["lm/tokens"] = toks
flat = {}


def walk(t, pre):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, f"{pre}/{k}")
    else:
        flat[pre] = t


walk(params, "lmp")
for k, v in flat.items():
    out[k] = np.asarray(v, np.float32)
    dtypes[k] = str(v.dtype)
np.savez(out_path, **out)
print(json.dumps(dtypes))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_reference")
    spec = {"cf": CF, "B": B, "S": S, "LM_B": LM_B, "LM_S": LM_S,
            "layouts": LAYOUTS,
            "rules": {"batch": ["data"], "experts": ["model"]}}
    (d / "spec.json").write_text(json.dumps(spec))
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, str(d / "reference.py"),
                          str(d / "spec.json"), str(d / "ref.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {**spec, "npz": str(d / "ref.npz"),
            "dtypes": json.loads(out.stdout.splitlines()[-1])}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    results = spawn("ep", 4, {**reference, "out": str(d / "port.npz")}, d)
    return results, np.load(d / "port.npz"), np.load(reference["npz"])


def _bad(results, prefix):
    return [f"rank {r}: {b}" for r, res in enumerate(results)
            for b in res["bad"] if b.startswith(prefix)]


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_ep_outputs_equal_reference(ranks, layout):
    results, port, ref = ranks
    np.testing.assert_allclose(port[f"{layout}/dtensor/y"],
                               ref[f"{layout}/y"], **tol("bfloat16"))
    np.testing.assert_allclose(port[f"{layout}/dtensor/aux"],
                               ref[f"{layout}/aux"], **tol("float32"))
    # dropless: nothing dropped on either side
    assert ref[f"{layout}/aux"][2] == 0.0
    # every rank's plain blocks: y at 2e-2, aux at 2e-4
    assert not _bad(results, f"{layout}/plain/")


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_ep_matches_global_moe(ranks, layout):
    """As ``test_ep_moe_matches_global``: the expert-parallel path
    against the port's own single-card ``moe_ffn``, at that test's
    tolerance; without a d_ff split each row is computed as on one card,
    so there also at the bf16 tolerance (the split rounds each partial
    output to bf16 before the sum, which parts where they cancel)."""
    _, port, _ = ranks
    got, want = port[f"{layout}/dtensor/y"], port[f"{layout}/global/y"]
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.25)
    if LAYOUTS[layout][2] is None:
        np.testing.assert_allclose(got, want, **tol("bfloat16"))


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_ep_gradients_equal_reference(ranks, layout):
    results, port, ref = ranks
    for name in ("x", "w_router", "w_in", "w_out"):
        np.testing.assert_allclose(port[f"{layout}/g/{name}"],
                                   ref[f"{layout}/g/{name}"],
                                   **tol("float32"), err_msg=name)
    assert not _bad(results, f"{layout}/grad/")
    checked = [c for c in results[0]["checked"]
               if c.startswith(f"{layout}/")]
    assert len(checked) == 6, checked


def test_lm_on_mesh_equals_reference(ranks):
    """``LM(cfg, plan, mesh)``: the loss and prefill logits with params
    and batch placed by the plan, through the expert-parallel path."""
    results, port, ref = ranks
    assert all(r["ep_calls"] == 4 for r in results), results
    np.testing.assert_allclose(port["lm/loss"], ref["lm/loss"],
                               **tol("bfloat16"))
    np.testing.assert_allclose(port["lm/logits"], ref["lm/logits"],
                               **tol("bfloat16"))
    # the same model without a mesh: the single-card path
    np.testing.assert_allclose(port["lm/loss"], port["lm/loss_plain"],
                               **tol("bfloat16"))
    np.testing.assert_allclose(port["lm/logits"], port["lm/logits_plain"],
                               **tol("bfloat16"))


class _Mesh:
    """What the dispatch rule reads of a ``DeviceMesh``."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def test_dispatch_rule():
    cfg = get_config("deepseek-v2-236b", smoke=True)       # 8 experts
    moe = cfg.moe
    mesh = _Mesh(data=2, model=2)

    def hint(e, tp=None, m=mesh):
        return (("data",), e, (), m, tp)
    assert tmoe.ep_applies(hint(("model",)), (4, 8), moe)
    assert tmoe.ep_applies(hint(("model", "data")), (4, 8), moe)
    # decode (S = 1) never takes it
    assert not tmoe.ep_applies(hint(("model",)), (4, 1), moe)
    # nor experts that do not divide over the group
    assert not tmoe.ep_applies(hint(("model",), m=_Mesh(data=2, model=3)),
                               (4, 8), moe)
    # nor one group, an indivisible batch, or d_ff not split by tp
    assert not tmoe.ep_applies(hint(("model",), m=_Mesh(data=2, model=1)),
                               (4, 8), moe)
    assert not tmoe.ep_applies(hint(("model",)), (3, 8), moe)
    assert not tmoe.ep_applies(hint(("data",), "model",
                                    _Mesh(data=2, model=3)), (4, 8), moe)
    assert not tmoe.ep_applies(None, (4, 8), moe)
    # moe_ffn at S = 1 under a hint runs the single-card path (which
    # needs no process group)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import ParamBuilder
    pb = ParamBuilder(gen)
    tmoe.init_moe(pb, "m", cfg)
    x = torch.randn(4, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    want, _ = tmoe.moe_ffn(x, pb.params["m"], cfg, lambda t, d, s=None: t)
    got, _ = tmoe.moe_ffn(x, pb.params["m"], cfg, lambda t, d, s=None: t,
                          ep=hint(("model",)))
    assert torch.equal(got, want)


def test_chip_smoke_ep_phases_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phases 20-22 on the CPU (gloo, smoke configs,
    the grouped matmul's plain version counted as its launches): the
    expert-parallel path bit-equal to ``moe_ffn`` with and without the
    d_ff split, two launches on its kernel path; compression and GPipe
    as on the card; the group destroyed after."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    def smoke(arch, smoke=False):
        return get_config(arch, smoke=True)
    monkeypatch.setattr(chip_smoke, "get_config", smoke)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name, value in (("EP_B", 4), ("EP_S", 32), ("GP_B", 4),
                        ("GP_D", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, iters=50, warmup=5: (fn(), 0.0)[1])
    plain = gmm_ops.moe_gmm

    def counted(*a, **k):
        counted.launches += 1
        return plain(*a, **k)
    counted.launches = 0
    monkeypatch.setitem(chip_smoke.COUNTED, "moe_gmm", counted)
    monkeypatch.setattr(gmm_ops, "moe_gmm", counted)
    device = {"kind": "cpu", "smi": "no card"}
    assert not dist.is_initialized()
    paths, cases = chip_smoke.phase_ep(device)
    assert [p["moe_gmm"] for p in paths] == [2, 2]
    assert sorted(cases) == [("gmm", "ep", 1), ("gmm", "ep", 2)]
    chip_smoke.phase_compress(device)
    chip_smoke.phase_gpipe(device)
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert out.count("plain path bit-equal to moe_ffn") == 2
    assert "int8 payloads and scales bit-equal" in out
    assert "bit-equal to the sequential oracle" in out
