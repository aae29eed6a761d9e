"""The port's plans on a ``torch.distributed`` ``DeviceMesh``
against the reference's ``NamedSharding``s.

The reference side is computed once, in a JAX process with four host
devices (``--xla_force_host_platform_device_count=4``, as
``tests/test_multidevice.py`` runs it): for each leaf, the slice that
``NamedSharding(...).devices_indices_map(shape)`` gives each device of a
``(2, 2)`` ``("data", "model")`` mesh.  The index map refuses a dim that
its shards do not divide; such a dim is laid out as GSPMD pads it, by
the map of the dim rounded up to a multiple of its shard count, clipped
to the dim.  The port side runs on four gloo
ranks meeting at a file rendezvous (``tests/torch_ranks.py``), on the
same ``(2, 2)`` mesh, rank ``2 i + j`` at position ``(i, j)`` as the JAX
mesh holds device ``2 i + j`` there.  Each rank distributes full tensors
of distinct values and holds its local shards to the reference's slices:

* every param leaf (weight specs, FSDP on) of four smoke configs under
  their ``(2, 2)`` train plans, and every ``cache_dims`` leaf under their
  ``(2, 2)`` decode plans (the serving plan's shape);
* hand-written specs: several mesh axes on one dim in both orders (JAX
  reads ``("model", "data")`` model-major), and uneven dims (ceil-sized
  leading shards, a short or empty last one);
* ``constrain`` under ``set_mesh``: a replicated DTensor redistributed to
  its site's placements; outside a mesh, and for a plain tensor, the
  identity.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_ranks import SRC, spawn
from repro_torch.core import MULTI_POD, SINGLE_POD, MeshSpec, ShardingPlan
from repro_torch.core.plan import ambient_mesh, check_layout, placements
from repro_torch.launch import mesh as tmesh

ARCHS = ["smollm-135m", "xlstm-125m", "jamba-v0.1-52b", "deepseek-v2-236b"]
SHAPE = {"seq": 32, "batch": 8, "cache_batch": 8, "cache_len": 512}
HAND = [((8, 6), [["model", "data"]]),
        ((8, 6), [["data", "model"]]),
        ((6, 8), [None, ["model", "data"]]),
        ((2, 8, 4), [None, ["model", "data"], None]),
        ((4, 8), ["model", "data"]),
        ((5, 3), ["data"]),
        ((3, 7), [None, "model"]),
        ((1, 4), ["model"])]
CONSTRAIN = [((8, 6), ["experts", "d_model"],
              {"experts": ["model", "data"], "d_model": ["data"]}),
             ((4, 6, 8), ["batch", "seq", "d_model"],
              {"batch": ["data"], "d_model": ["model"]}),
             ((3, 5), ["heads", "d_head"], {"heads": ["model"]})]

REFERENCE = r'''
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core import ShardingPlan, build_lm_graph, optimize
from repro.core.estimator import MeshSpec
from repro.core.ir import reset_fresh_names
from repro.models.lm import LM

spec = json.load(open(sys.argv[1]))
devices = jax.devices()
assert len(devices) == 4, devices
mesh = Mesh(np.array(devices).reshape(2, 2), ("data", "model"))
mspec = MeshSpec((("data", 2), ("model", 2)))
rank = {d: i for i, d in enumerate(devices)}


def flatten(tree, is_leaf, path=""):
    if tree is None:
        return []
    if is_leaf(tree):
        return [(path, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    out = []
    for k, v in items:
        out += flatten(v, is_leaf, f"{path}/{k}" if path else str(k))
    return out


def is_dims(x):
    return isinstance(x, tuple) and all(isinstance(i, str) for i in x)


def entry(sharding, shape):
    # an uneven dim is laid out as GSPMD pads it: the index map of the
    # dim rounded up to a multiple of its shard count, clipped to the dim
    padded = []
    for i, n in enumerate(shape):
        e = sharding.spec[i] if i < len(sharding.spec) else None
        k = 1
        for a in ((e,) if isinstance(e, str) else (e or ())):
            k *= mesh.shape[a]
        padded.append(-(-n // k) * k)
    slices = [None] * 4
    for d, idx in sharding.devices_indices_map(tuple(padded)).items():
        slices[rank[d]] = [[min(s.indices(p)[0], n), min(s.indices(p)[1], n)]
                           for s, p, n in zip(idx, padded, shape)]
    return {"spec": json.loads(json.dumps(tuple(sharding.spec))),
            "slices": slices}


leaves = {}
for arch in spec["archs"]:
    cfg = get_config(arch, smoke=True)
    reset_fresh_names()
    g = build_lm_graph(cfg, ShapeSpec("t", spec["seq"], spec["batch"],
                                      "train"))
    _, plan, _ = optimize(g, mspec, fsdp=True)
    reset_fresh_names()
    g = build_lm_graph(cfg, ShapeSpec("d", spec["cache_len"],
                                      spec["cache_batch"], "decode"))
    _, dplan, _ = optimize(g, mspec, fsdp=True)
    lm = LM(cfg, plan=plan)
    params, dims = lm.init(None, abstract=True)
    caches = lm.init_caches(spec["cache_batch"], spec["cache_len"],
                            abstract=True)
    for part, tree, dtree, weight, plan in (
            ("params", params, dims, True, plan),
            ("caches", caches, lm.cache_dims(), False, dplan)):
        shapes = flatten(tree, lambda x: hasattr(x, "shape"))
        names = flatten(dtree, is_dims)
        assert [k for k, _ in shapes] == [k for k, _ in names], arch
        for (k, leaf), (_, d) in zip(shapes, names):
            sh = plan.named_sharding(mesh, d, weight=weight,
                                     shape=leaf.shape if weight else None)
            leaves[f"{arch}/{part}/{k}"] = entry(sh, leaf.shape)
hand = [dict(shape=shape, **entry(NamedSharding(mesh, P(*(
    tuple(e) if isinstance(e, list) else e for e in s))), shape))
    for shape, s in spec["hand"]]
constrain = []
for shape, d, rules in spec["constrain"]:
    plan = ShardingPlan(mspec, rules={k: tuple(v) for k, v in rules.items()})
    constrain.append(dict(shape=shape, dims=d, rules=rules, **entry(
        NamedSharding(mesh, plan.spec_for_dims(tuple(d))), shape)))
print(json.dumps({"leaves": leaves, "hand": hand, "constrain": constrain}))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    (d / "spec.json").write_text(json.dumps(
        {"archs": ARCHS, "hand": HAND, "constrain": CONSTRAIN, **SHAPE}))
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, str(d / "reference.py"),
                          str(d / "spec.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    spec = {"archs": ARCHS, **SHAPE, "ref": reference["leaves"],
            "hand": reference["hand"], "constrain": reference["constrain"]}
    return spawn("mesh", 4, spec, tmp_path_factory.mktemp("mesh"))


def _checked(ranks, prefix):
    keys = [k for k in ranks[0]["checked"] if k.startswith(prefix)]
    for r in ranks[1:]:
        assert [k for k in r["checked"] if k.startswith(prefix)] == keys
    bad = [f"rank {i}: {b}" for i, r in enumerate(ranks)
           for b in r["bad"] if b.startswith(prefix)]
    assert not bad, "\n".join(bad[:20])
    return keys


@pytest.mark.parametrize("part", ["params", "caches"])
def test_leaves_equal_reference_slices(reference, ranks, part):
    for arch in ARCHS:
        keys = _checked(ranks, f"{arch}/{part}/")
        want = sorted(k for k in reference["leaves"]
                      if k.startswith(f"{arch}/{part}/"))
        assert sorted(keys) == want and want
    # the plans shard something: not every leaf is replicated
    sharded = [k for k, v in reference["leaves"].items()
               if f"/{part}/" in k and any(v["spec"])]
    assert sharded


def test_hand_specs_equal_reference_slices(reference, ranks):
    keys = _checked(ranks, "hand ")
    assert len(keys) == len(HAND)
    # the trap: JAX gives mesh position (0, 1) rows 4-5 of 8 under
    # ("model", "data"), where nested Shard placements would give 2-3
    assert reference["hand"][0]["slices"][1] == [[4, 6], [0, 6]]
    # uneven: ceil-sized leading shards, a short or empty last one
    assert [s[0] for s in reference["hand"][5]["slices"]] == \
        [[0, 3], [0, 3], [3, 5], [3, 5]]
    assert [s[0] for s in reference["hand"][7]["slices"]] == \
        [[0, 1], [1, 1], [0, 1], [1, 1]]


def test_constrain_redistributes_under_the_mesh(ranks):
    keys = _checked(ranks, "constrain ")
    assert len(keys) == len(CONSTRAIN)
    assert not [b for r in ranks for b in r["bad"]]


class _Mesh:
    """The two things ``placements`` reads of a ``DeviceMesh``."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


def test_placements_by_hand():
    m = _Mesh(data=2, model=4)
    assert placements(m, (("model", "data"),)) == (
        _StridedShard(0, split_factor=4), Shard(0))
    assert placements(m, (("data", "model"),)) == (Shard(0), Shard(0))
    assert placements(m, (None, "model")) == (Replicate(), Shard(1))
    assert placements(m, ()) == (Replicate(), Replicate())
    p3 = _Mesh(pod=2, data=2, model=2)
    assert placements(p3, (("model", "data", "pod"),)) == (
        _StridedShard(0, split_factor=4), _StridedShard(0, split_factor=2),
        Shard(0))
    check_layout(m, (("model", "data"),), (16, 3))
    check_layout(m, ("data",), (5,))
    with pytest.raises(ValueError, match="uneven over several mesh axes"):
        check_layout(m, (("model", "data"),), (12,))


def test_make_host_mesh_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh(device="cuda")
    assert not dist.is_initialized()


def test_single_rank_mesh_and_production_meshes():
    assert tmesh.mesh_spec() == SINGLE_POD
    assert tmesh.mesh_spec(multi_pod=True) == MULTI_POD
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        plan = ShardingPlan(MeshSpec((("data", 1), ("model", 1))),
                            rules={"d_model": ("model",)})
        sh = plan.named_sharding(mesh, ("vocab", "d_model"))
        x = torch.arange(12.0).reshape(3, 4)
        dt = sh.distribute(x)
        assert sh.spec == (None, "model")
        assert torch.equal(dt.to_local(), x)
        assert ambient_mesh() is None
        with tmesh.set_mesh(mesh):
            assert ambient_mesh() is mesh
            assert torch.equal(plan.constrain(dt, ("vocab", "d_model"))
                               .to_local(), x)
        assert ambient_mesh() is None
    finally:
        dist.destroy_process_group()


def test_chip_smoke_mesh_phase_on_cpu(monkeypatch, capsys, tmp_path):
    """``chip_smoke.py``'s phase 19 on the CPU (gloo, a smoke config, 3
    driver steps): the single-rank group and ``(1, 1)`` mesh, every
    local shard equal to its full tensor, and the driver's losses on the
    mesh bit-equal to its run without one."""
    import functools

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    def smoke(arch, smoke=False):
        return get_config(arch, smoke=True)
    for mod in (chip_smoke, train):
        monkeypatch.setattr(mod, "get_config", smoke)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name, value in (("TRAIN_B", 4), ("TRAIN_S", 32),
                        ("DRIVER_STEPS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "driver_run", functools.partial(
        chip_smoke.driver_run, eager=True))
    want = chip_smoke.driver_run("a", chip_smoke.driver_argv() + [
        "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])["losses"]
    rec = chip_smoke.phase_mesh(want, {"kind": "cpu", "smi": "no card"})
    assert not dist.is_initialized()
    assert rec["leaves"] == 9 and rec["bytes"] > 0
    out = capsys.readouterr().out
    assert "[mesh] gloo group of 1 rank" in out
    assert "3 losses bit-equal to phase 13's run" in out
