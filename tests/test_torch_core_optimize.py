"""The port's ``optimize`` (``repro_torch.core``) against the reference's:
the final plan of every arch at ``train_4k`` on ``SINGLE_POD`` equals its
golden in ``tests/goldens/pre_dse`` and the reference's plan in the same
process, bit for bit as JSON; the report's counts, the costs and the
optimized schedule are the reference's; and so are the plans on a small
grid of meshes, shapes and switches, including the train driver's
one-card mesh.

Every compare keeps ``optimize``'s ``sweep_workers=None`` and
``budget_s=None``: a time budget would tie the plan to the clock.
"""
import json

import pytest

import repro.core as R
import repro_torch.core as T
from repro.configs import SHAPES as RSHAPES, get_config as rget
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.core import ir as R_ir
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import ir as T_ir
import torch_parity  # noqa: F401  (one torch thread per pytest worker)

from golden_utils import GOLDEN_DIR, SHAPE, build_pre_dse_schedule

ARCHS = list_archs()


def _optimize(core, ir, get, shape, arch, mesh_axes, **kw):
    ir.reset_fresh_names()
    g = core.build_lm_graph(get(arch), shape)
    return core.optimize(g, core.MeshSpec(mesh_axes), **kw)


def both(arch, mesh_axes=None, shape=SHAPE, **kw):
    """(port, reference) ``optimize`` results for one case; ``shape`` is
    a name of ``SHAPES`` or a ``(seq, batch, mode)`` triple."""
    mesh_axes = mesh_axes or T.SINGLE_POD.axes
    if isinstance(shape, str):
        ts, rs = SHAPES[shape], RSHAPES[shape]
    else:
        ts, rs = ShapeSpec("cli", *shape), RShapeSpec("cli", *shape)
    return (_optimize(T, T_ir, get_config, ts, arch, mesh_axes, **kw),
            _optimize(R, R_ir, rget, rs, arch, mesh_axes, **kw))


_GOLDEN_RUNS: dict = {}


def golden_runs(arch):
    if arch not in _GOLDEN_RUNS:
        _GOLDEN_RUNS[arch] = both(arch, training=True)
    return _GOLDEN_RUNS[arch]


def counts(sched, plan, rep) -> dict:
    """What a report counts, and the costs, as plain data."""
    par = rep.parallelize
    return {
        "nodes": len(sched.nodes), "regions": rep.regions,
        "evaluated": par.evaluated,
        "rejected_constraint": par.rejected_constraint,
        "rejected_budget": par.rejected_budget,
        "beam_states": par.beam_states, "joint_moves": par.joint_moves,
        "dse_mode": par.dse_mode, "order": list(par.order),
        "pf": dict(par.pf), "greedy_total_s": par.greedy_total_s,
        "total_s": rep.cost.total_s, "critical_s": rep.cost.critical_s,
        "hbm": rep.cost.hbm_bytes_per_device,
        "reshard": rep.cost.reshard_bytes, "sync": rep.cost.sync_bytes,
        "index_bytes": rep.index_bytes,
        "degradations": [(d.stage, d.action, d.error)
                         for d in rep.degradations],
        "verify": (rep.verify.ok, rep.verify.checks,
                   [str(i) for i in rep.verify.issues]),
        "analyze": (rep.analyze.ok, rep.analyze.summary()),
    }


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_golden_and_reference(arch):
    (_, plan, _), (_, rplan, _) = golden_runs(arch)
    golden = json.loads((GOLDEN_DIR / f"{arch}.json").read_text())
    assert json.loads(plan.to_json()) == golden["plan"]
    assert plan.to_json() == rplan.to_json()


@pytest.mark.parametrize("arch", ARCHS)
def test_report_counts_and_schedule_equal_reference(arch):
    (sched, plan, rep), (rsched, rplan, rrep) = golden_runs(arch)
    assert counts(sched, plan, rep) == counts(rsched, rplan, rrep)
    assert not rep.degradations and rep.verify.ok
    assert sched.to_json() == rsched.to_json()
    # every region's inner search, less its wall time
    assert ([dict(s.to_dict(), inner_s=0)
             for s in rep.parallelize.region_summaries]
            == [dict(s.to_dict(), inner_s=0)
                for s in rrep.parallelize.region_summaries])


GRID = {
    "multi_pod": dict(mesh_axes=T.MULTI_POD.axes),
    "decode": dict(shape="decode_32k"),
    "fsdp": dict(fsdp=True),
    "train_driver_mesh": dict(mesh_axes=(("data", 1), ("model", 1)),
                              shape=(64, 8, "train")),
    "train_driver_mesh_fsdp": dict(mesh_axes=(("data", 1), ("model", 1)),
                                   shape=(64, 8, "train"), fsdp=True),
    "ia_off": dict(ia=False),
    "ca_off": dict(ca=False),
    "fuse_off": dict(fuse=False),
    "flat_dse": dict(dse_mode="flat"),
    "inference": dict(training=False),
}


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("case", list(GRID))
def test_grid_equals_reference(arch, case):
    (sched, plan, rep), (rsched, rplan, rrep) = both(arch, **GRID[case])
    assert plan.to_json() == rplan.to_json()
    assert counts(sched, plan, rep) == counts(rsched, rplan, rrep)


def test_multi_pod_moe_widens_experts_as_reference():
    """deepseek-v3 on the two-pod mesh: the expert rule and ``meta``
    (``ep_widened``, ``moe_tp``) that ``optimize`` writes after the DSE."""
    (_, plan, _), (_, rplan, _) = both("deepseek-v3-671b",
                                       mesh_axes=T.MULTI_POD.axes)
    assert plan.to_json() == rplan.to_json()
    assert plan.rules.get("experts") and "ep_widened" in plan.meta


def test_best_uniform_equals_reference():
    """The DSE's floor: the best uniform assignment on the pre-DSE
    schedule, and its cost."""
    rsched = build_pre_dse_schedule("stablelm-3b")
    T_ir.reset_fresh_names()
    g = T.build_lm_graph(get_config("stablelm-3b"), SHAPES[SHAPE])
    T.construct_functional(g)
    T.fuse_tasks(g)
    sched = T.lower_to_structural(g)
    T.eliminate_multi_producers(sched)
    T.balance_paths(sched)
    assign, cost = T.best_uniform(sched, T.SINGLE_POD)
    rassign, rcost = R.best_uniform(rsched, R.SINGLE_POD)
    assert assign == rassign
    assert (cost.total_s, cost.hbm_bytes_per_device) == \
        (rcost.total_s, rcost.hbm_bytes_per_device)
    assert sched.to_json() == rsched.to_json()


def test_estimate_equals_reference():
    """The roofline estimate of the optimized schedule, node by node."""
    (sched, _, _), (rsched, _, _) = golden_runs("h2o-danube-3-4b")
    cost = T.estimate(sched, T.SINGLE_POD, training=True)
    rcost = R.estimate(rsched, R.SINGLE_POD, training=True)
    assert {k: vars(v) for k, v in cost.nodes.items()} == \
        {k: vars(v) for k, v in rcost.nodes.items()}
    assert cost.total_s == rcost.total_s


def test_chip_smoke_compiler_phase_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 18 needs no card: on two archs here, the
    goldens hold and the plan fetch goes cold, then hits."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "list_archs",
                        lambda: ["smollm-135m", "xlstm-125m"])
    rec = chip_smoke.phase_compiler({"smi": "no card"})
    assert set(rec) == {"smollm-135m", "xlstm-125m", "fetch_plan"}
    assert rec["fetch_plan"]["bucket"] == "decode_b8_s512"
    assert "2 plans equal their goldens" in capsys.readouterr().out
