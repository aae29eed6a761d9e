"""The port's stage analysis (``repro_torch.core.pipeline``) and elastic
re-plan (``repro_torch.distributed.elastic``) against the reference's.

* ``compute_stages`` gives the reference's mapping on every arch's
  optimized schedule, for 2 and 4 stages; ``assign_stages`` writes it,
  and ``apply_stages`` is all or nothing (``tests/test_rewrite.py``'s
  toy schedule, built with the port's IR).
* ``mesh_for_hosts`` and ``replan_for_topology`` give the reference's
  meshes, plans and sources (``tests/test_plan_cache.py``'s elastic rung:
  cold on 16 hosts, warm on 8, then a hit back on 16).
"""
import pytest

import repro.core as R
from repro.configs import get_config as rget
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.core import ir as R_ir
from repro.core.pipeline import compute_stages as r_compute
from repro.distributed import elastic as r_el
import repro_torch.core as T
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import ir as T_ir
from repro_torch.core.ir import Buffer, MemoryEffect, Node, Op, Schedule
from repro_torch.core.pipeline import (apply_stages, assign_stages,
                                       compute_stages)
from repro_torch.distributed import mesh_for_hosts, replan_for_topology
import torch_parity  # noqa: F401  (one torch thread per pytest worker)


def _schedules(arch):
    T_ir.reset_fresh_names()
    tsched, _, _ = T.optimize(T.build_lm_graph(get_config(arch),
                                               SHAPES["train_4k"]),
                              T.SINGLE_POD)
    R_ir.reset_fresh_names()
    rsched, _, _ = R.optimize(R.build_lm_graph(rget(arch),
                                               SHAPES["train_4k"]),
                              R.SINGLE_POD)
    return tsched, rsched


@pytest.mark.parametrize("arch", list_archs())
def test_stages_equal_reference(arch):
    tsched, rsched = _schedules(arch)
    for n in (2, 4):
        want = r_compute(rsched, n)
        before = tsched.to_json()
        got = compute_stages(tsched, n)
        assert tsched.to_json() == before
        assert got == want
        assert set(got.values()) <= set(range(n))
    assert assign_stages(tsched, 4) == compute_stages(tsched, 4)
    assert {n.name: n.stage for n in tsched.nodes} == r_compute(rsched, 4)


def _toy_schedule():
    s = Schedule("toy")
    for b, shape in (("a", (8,)), ("b", (8,)), ("c", (8,)), ("out", (8,))):
        s.buffers[b] = Buffer(b, shape, dims=("i",))
    s.args = ["a"]

    def op(name, ins, outs):
        return Op(name=name + "_op", kind="compute", ins=ins, outs=outs,
                  loop_dims={"i": 8}, flops=8)

    s.nodes = [
        Node(name="n0", args={"a": MemoryEffect.READ,
                              "b": MemoryEffect.WRITE},
             body=[op("n0", ["a"], ["b"])]),
        Node(name="n1", args={"b": MemoryEffect.READ,
                              "c": MemoryEffect.WRITE},
             body=[op("n1", ["b"], ["c"])]),
        Node(name="n2", args={"b": MemoryEffect.READ,
                              "c": MemoryEffect.READ,
                              "out": MemoryEffect.WRITE},
             body=[op("n2", ["b", "c"], ["out"])]),
    ]
    s.outputs = ["out"]
    return s


def test_apply_stages_writes_or_leaves_all():
    s = _toy_schedule()
    mapping = compute_stages(s, 2)
    assert set(mapping) == {"n0", "n1", "n2"} and mapping["n0"] == 0
    apply_stages(s, mapping)
    assert [n.stage for n in s.nodes] == [mapping[n.name] for n in s.nodes]
    s = _toy_schedule()
    with pytest.raises(KeyError):
        apply_stages(s, {"n0": 1, "ghost": 2, "n2": 3})
    assert [n.stage for n in s.nodes] == [0, 0, 0]


def test_mesh_for_hosts_equals_reference():
    for n in (1, 8, 16, 32):
        assert mesh_for_hosts(n).axes == r_el.mesh_for_hosts(n).axes
        assert mesh_for_hosts(n, T.MULTI_POD).axes == \
            r_el.mesh_for_hosts(n, R.MULTI_POD).axes
    assert mesh_for_hosts(16) == T.SINGLE_POD


def _elastic(core, ir, get, shapespec, mesh_for, replan, root):
    """Cold on 16 hosts, re-planned on 8, then back on 16."""
    cfg = get("smollm-135m", smoke=True)
    bucket = core.shape_bucket("decode", 128, 4)
    shape = shapespec(bucket, 128, 4, "decode")

    def factory():
        return core.build_lm_graph(cfg, shape)
    cache = core.PlanCache(root)
    m16, m8 = mesh_for(16), mesh_for(8)
    ir.reset_fresh_names()
    plan16, s0, _ = core.fetch_or_optimize(
        cache, core.PlanKey.make(cfg, m16, bucket), m16, factory)
    out = [(s0, plan16.to_json(), None)]
    for mesh in (m8, m16):
        ir.reset_fresh_names()
        plan, src, rep = replan(cache, cfg, new_mesh=mesh, bucket=bucket,
                                graph_factory=factory)
        out.append((src, plan.to_json(), None if rep is None else (
            rep.verify.ok, rep.parallelize.warm_covered,
            rep.parallelize.evaluated, rep.cost.total_s)))
    return out


def test_replan_for_topology_equals_reference(tmp_path):
    got = _elastic(T, T_ir, get_config, ShapeSpec, mesh_for_hosts,
                   replan_for_topology, tmp_path / "t")
    want = _elastic(R, R_ir, rget, RShapeSpec, r_el.mesh_for_hosts,
                    r_el.replan_for_topology, tmp_path / "r")
    assert [s for s, _, _ in got] == ["cold", "warm", "hit"]
    assert got == want
    assert got[1][2][0] and got[1][2][1] > 0
    assert T.verify_static(T.ShardingPlan.from_json(got[1][1]),
                           mesh_for_hosts(8)).ok
