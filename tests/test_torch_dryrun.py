"""The port's dry-run (``repro_torch.launch.dryrun``), its collective
accounting (``launch/comm_analysis``) and its abstract inputs
(``launch/steps``) against the reference's.

* ``batch_specs`` and ``input_specs`` give the reference's shapes and
  dtypes (its ``ShapeDtypeStruct``s) for all 10 archs × 4 shapes.
* ``StepCounter`` counts each collective kind, with its result bytes, on
  a fake process group.
* The reduced smollm train cell of ``tests/test_multidevice.py``
  (smollm-135m at ``ShapeSpec("t", 512, 16, "train")`` on a ``(4, 2)``
  mesh under its HIDA plan, FSDP on as the dry-run sets it for a train
  cell) runs ``ok`` on a fake group of 8 ranks.  Its argument bytes
  equal the reference's compiled ``argument_size_in_bytes``; its temp
  and its all-gather and all-reduce bytes are held to the reference's
  within stated factors (a reduce-scatter counts as the all-reduce the
  reference's host lowering puts in its place); every kind it reports
  is one the reference's HLO reports.  The reference compiles it in a
  JAX process with 8 host devices on a mesh of Auto axes (with the
  default Explicit axes its ``with_sharding_constraint`` asserts, which
  is why that reference test is red).
* smollm prefill and decode cells run ``ok``.
* A train cell of deepseek-v2's smoke config under a hand-written plan
  with an ``experts`` rule has the reference's argument bytes and
  all-to-all bytes exactly, and its temp within a stated factor.
* The CLI writes the reference's keys.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_ranks import SRC
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import CollectiveStats as JStats
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import MeshSpec, ShardingPlan
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.comm_analysis import CollectiveStats, StepCounter

MESH = (("data", 4), ("model", 2))
TRAIN = ShapeSpec("t", 512, 16, "train")
EP_RULES = {"batch": ("data",), "experts": ("model",)}
EP_TRAIN = ShapeSpec("t", 32, 16, "train")

REFERENCE = r'''
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core import MeshSpec, ShardingPlan, build_lm_graph, optimize
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.mesh import set_mesh
from repro.launch.steps import build_train_step

spec = json.load(open(sys.argv[1]))
assert len(jax.devices()) == 8
mspec = MeshSpec((("data", 4), ("model", 2)))
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for name, arch, smoke, (S, B), rules in spec["cells"]:
    cfg = get_config(arch, smoke=smoke)
    shape = ShapeSpec("t", S, B, "train")
    if rules is None:
        # the dry-run's plan: FSDP on for a train cell
        _, plan, _ = optimize(build_lm_graph(cfg, shape), mspec,
                              training=True, fsdp=True)
    else:
        plan = ShardingPlan(mspec, rules={k: tuple(v)
                                          for k, v in rules.items()})
    with set_mesh(mesh):
        step = build_train_step(cfg, shape, mesh, plan)
        compiled = step.fn.lower(*step.abstract_inputs).compile()
    stats = collective_bytes(compiled.as_text())
    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    out[name] = {"count_by_kind": stats.count_by_kind,
                 "bytes_by_kind": stats.bytes_by_kind,
                 "arguments": mem.argument_size_in_bytes,
                 "temp": mem.temp_size_in_bytes,
                 "flops": cost["flops"]}
print(json.dumps(out))
'''


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a tree of dicts and (named) tuples
    of jax ``ShapeDtypeStruct``s or torch tensors; ``None`` skipped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for name in SHAPES:
        got, gdims = tsteps.batch_specs(cfg, SHAPES[name])
        want, wdims = jsteps.batch_specs(jcfg, JSHAPES[name])
        assert _flat(got) == _flat(want) and gdims == wdims, name
        assert all(t.is_meta for t in got.values())
        got = tsteps.input_specs(cfg, SHAPES[name])
        want = jsteps.input_specs(jcfg, JSHAPES[name])
        assert sorted(got) == sorted(want), name
        for part in want:
            assert _flat(got[part]) == _flat(want[part]), (name, part)


def test_step_counter_counts_each_kind():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        ranks = list(range(8))
        with FakeTensorMode():
            t = torch.empty(8, 16)              # 512 bytes
            out = torch.empty(8, 16)
            with StepCounter() as c:
                dist.all_reduce(t)
                funcol.all_gather_tensor(t, 0, ranks)
                funcol.reduce_scatter_tensor(t, "sum", 0, ranks)
                dist.all_to_all_single(out, t)
                for w in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, t, 1),
                        dist.P2POp(dist.irecv, out, 7)]):
                    w.wait()
                torch.randn(4, 8) @ torch.randn(8, 2)
    finally:
        dist.destroy_process_group()
    assert c.stats.count_by_kind == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 1}
    # the result's bytes: the gathered whole, the scattered shard
    assert c.stats.bytes_by_kind == {
        "all-reduce": 512, "all-gather": 8 * 512, "reduce-scatter": 64,
        "all-to-all": 512, "collective-permute": 512}
    assert c.flops == 2 * 4 * 8 * 2
    assert dict(c.op_histogram())["mm"] == 1
    assert sorted(CollectiveStats().to_dict()) == sorted(JStats().to_dict())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_reference")
    cells = [["smollm", "smollm-135m", False, [TRAIN.seq_len,
                                               TRAIN.global_batch], None],
             ["ep", "deepseek-v2-236b", True, [EP_TRAIN.seq_len,
                                               EP_TRAIN.global_batch],
              {k: list(v) for k, v in EP_RULES.items()}]]
    (d / "spec.json").write_text(json.dumps({"cells": cells}))
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run([sys.executable, str(d / "reference.py"),
                          str(d / "spec.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _ok(rec):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    return rec


def _kinds(rec) -> set:
    """The record's collective kinds as the reference's host HLO names
    them: XLA's CPU lowering puts an all-reduce and a local slice where
    DTensor reduce-scatters."""
    return {"all-reduce" if k == "reduce-scatter" else k
            for k in rec["collectives"]["count_by_kind"]}


def _within(got, want, factor):
    return want / factor <= got <= want * factor


def test_reduced_train_cell_agrees_with_reference(reference):
    rec = _ok(dryrun.run_cell("smollm-135m", TRAIN, mesh_axes=MESH,
                              save=False))
    ref = reference["smollm"]
    mem = rec["memory_analysis"]
    # the same local shards of params, moments, step and batch
    assert mem["argument_size_in_bytes"] == ref["arguments"]
    # eager layer by layer against XLA's schedule: 0.64x measured
    assert _within(mem["temp_size_in_bytes"], ref["temp"], 1.6), \
        (mem["temp_size_in_bytes"], ref["temp"])
    kinds = _kinds(rec)
    assert {"all-gather", "all-reduce"} <= kinds
    assert kinds <= set(ref["count_by_kind"]), (kinds, ref)
    # bytes by kind: 1.9x and 2.0x measured (PERF.md names the sites)
    got = rec["collectives"]["bytes_by_kind"]
    operand = rec["collective_operand_bytes"]
    assert _within(got["all-gather"], ref["bytes_by_kind"]["all-gather"],
                   2.5), (got, ref)
    reduced = got.get("all-reduce", 0) + operand.get("reduce-scatter", 0)
    assert _within(reduced, ref["bytes_by_kind"]["all-reduce"], 2.5), \
        (reduced, ref)
    assert rec["mesh"] == "4x2" and rec["chips"] == 8
    assert rec["fsdp"] and rec["plan_rules"]["batch"] == ["data"]
    assert rec["hida"]["nodes"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", [ShapeSpec("p", 512, 8, "prefill"),
                                   ShapeSpec("d", 1024, 8, "decode")],
                         ids=["prefill", "decode"])
def test_serving_cells_ok(shape):
    rec = _ok(dryrun.run_cell("smollm-135m", shape, mesh_axes=MESH,
                              save=False))
    assert {"all-gather", "all-reduce"} & set(
        rec["collectives"]["count_by_kind"])
    if shape.mode == "decode":
        # the caches are written in place: returned as the inputs they
        # were given
        assert rec["memory_analysis"]["alias_size_in_bytes"] > 0


def test_expert_parallel_train_cell_agrees_with_reference(reference):
    ref = reference["ep"]
    assert "all-to-all" in ref["count_by_kind"]
    plan = ShardingPlan(MeshSpec(MESH), rules=dict(EP_RULES))
    rec = _ok(dryrun.run_cell("deepseek-v2-236b", EP_TRAIN, mesh_axes=MESH,
                              smoke=True, plan=plan, save=False))
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == ref["arguments"]
    # 0.65x measured
    assert _within(mem["temp_size_in_bytes"], ref["temp"], 1.6), \
        (mem["temp_size_in_bytes"], ref["temp"])
    assert _kinds(rec) <= set(ref["count_by_kind"])
    # the exchanges move what the reference's do, byte for byte
    assert (rec["collectives"]["bytes_by_kind"]["all-to-all"]
            == ref["bytes_by_kind"]["all-to-all"])
    counts = rec["collectives"]["count_by_kind"]
    # two MoE layers, each exchanging twice, forward and remat recompute
    # and backward
    assert counts["all-to-all"] >= 8
    assert "hida" not in rec


REFERENCE_KEYS = {
    "arch", "shape", "mesh", "strategy", "status", "analytic_flops",
    "model_flops_6nd", "loop_trip", "chips", "lower_s", "compile_s",
    "memory_analysis", "cost_analysis", "collectives", "hlo_ops",
    "plan_rules", "fsdp", "hida"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}
HIDA_KEYS = {"nodes", "estimated_total_s", "estimated_critical_s",
             "estimated_dominant", "opt_time_s"}


def test_cli_writes_reference_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k"])
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__16x16.json")
                     .read_text())
    assert set(rec) == REFERENCE_KEYS | {"collective_operand_bytes"}
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert set(rec["hida"]) == HIDA_KEYS
    assert set(rec["collectives"]) == set(JStats().to_dict())
    assert rec["chips"] == 256 and rec["status"] == "ok"
    assert "decode_32k" in capsys.readouterr().out
    assert not dist.is_initialized()
    # a process group that exists already is refused
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(SystemExit, match="already exists"):
            dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k"])
    finally:
        dist.destroy_process_group()
    assert np.isfinite(rec["cost_analysis"]["flops"])
