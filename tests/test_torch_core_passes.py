"""The port's HIDA compiler (``repro_torch.core``) up to the DSE, against
the reference's (``repro.core``): the dataflow graph of every arch, each
pre-DSE pass's output and statistics, and the schedule the DSE receives,
which must equal both the golden of ``tests/goldens/pre_dse`` and the
reference's in the same process, bit for bit as JSON.

Generated names embed a global counter in each package, so every build
resets both (``ir.reset_fresh_names``) first.
"""
import dataclasses
import json
from fractions import Fraction

import pytest

import repro.core as R
import repro_torch.core as T
from repro.configs import SHAPES as RSHAPES, get_config as rget
from repro.core import ir as R_ir
from repro.core.balance import balance_paths as r_balance
from repro.core.multi_producer import eliminate_multi_producers as r_mp
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import ir as T_ir
from repro_torch.core.balance import balance_paths as t_balance
from repro_torch.core.multi_producer import eliminate_multi_producers as t_mp
import torch_parity  # noqa: F401  (one torch thread per pytest worker)

from golden_utils import GOLDEN_DIR, SHAPE

ARCHS = list_archs()


def _op(o) -> dict:
    return {"name": o.name, "kind": o.kind, "ins": list(o.ins),
            "outs": list(o.outs), "loop_dims": dict(o.loop_dims),
            "flops": o.flops, "repeat": o.repeat,
            "access": {v: [[d, str(s)] for d, s in m.entries]
                       for v, m in o.access.items()},
            "attrs": {k: repr(v) for k, v in sorted(o.attrs.items())},
            "region": [_op(c) for c in o.region]}


def graph_dump(g) -> dict:
    """Everything a Functional graph holds, as plain data."""
    return {"name": g.name, "inputs": list(g.inputs),
            "outputs": list(g.outputs),
            "values": {k: [list(v.shape), v.dtype, list(v.dims),
                           v.is_weight] for k, v in g.values.items()},
            "ops": [_op(o) for o in g.ops]}


def _pre_dse(pkg, arch: str, shape: str = SHAPE) -> dict:
    """construct → fuse → lower → multi-producer → balance in one package,
    with each stage's dump and each pass's statistics."""
    core, ir, get, shapes, mp, balance = pkg
    ir.reset_fresh_names()
    g = core.build_lm_graph(get(arch), shapes[shape])
    out = {"graph": graph_dump(g)}
    core.construct_functional(g)
    out["constructed"] = graph_dump(g)
    fstats = core.fuse_tasks(g)
    out["fused"] = graph_dump(g)
    sched = core.lower_to_structural(g)
    out["lowered"] = sched.to_dict()
    mstats = mp(sched)
    out["mp"] = sched.to_dict()
    bstats = balance(sched)
    out["schedule"] = sched.to_dict()
    out["stats"] = {k: dataclasses.asdict(s) for k, s in
                    (("fusion", fstats), ("mp", mstats), ("balance", bstats))}
    return out


PORT = (T, T_ir, get_config, SHAPES, t_mp, t_balance)
REF = (R, R_ir, rget, RSHAPES, r_mp, r_balance)
_RUNS: dict = {}


def runs(arch: str, shape: str = SHAPE) -> tuple[dict, dict]:
    """(port, reference) pre-DSE runs, made once per module."""
    if (arch, shape) not in _RUNS:
        _RUNS[arch, shape] = (_pre_dse(PORT, arch, shape),
                              _pre_dse(REF, arch, shape))
    return _RUNS[arch, shape]


@pytest.mark.parametrize("arch", ARCHS)
def test_pre_dse_schedule_equals_golden_and_reference(arch):
    port, ref = runs(arch)
    golden = json.loads((GOLDEN_DIR / f"{arch}.json").read_text())
    got = json.dumps(port["schedule"], indent=1)
    assert json.loads(got) == golden["schedule"]
    assert got == json.dumps(ref["schedule"], indent=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_pass_equals_reference(arch):
    """The graph, and the IR after each of the five passes, with each
    pass's statistics (fusions, duplications and merges, copies and
    skew)."""
    port, ref = runs(arch)
    for stage in ("graph", "constructed", "fused", "lowered", "mp",
                  "stats"):
        assert json.dumps(port[stage], sort_keys=True, default=str) == \
            json.dumps(ref[stage], sort_keys=True, default=str), stage


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "deepseek-v3-671b", "xlstm-125m"])
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_pre_dse_other_shapes_equal_reference(arch, shape):
    port, ref = runs(arch, shape)
    assert json.dumps(port["schedule"]) == json.dumps(ref["schedule"])
    assert port["stats"] == ref["stats"]


def test_fresh_names_reset_per_package():
    """Each package keeps its own counter: resetting one leaves the
    other's names moving, so parity cases reset both."""
    T_ir.reset_fresh_names()
    R_ir.reset_fresh_names()
    assert T_ir.fresh_name("x") == R_ir.fresh_name("x")
    T_ir.reset_fresh_names()
    assert T_ir.fresh_name("x") != R_ir.fresh_name("x")


def test_access_map_and_graph_builders_equal_reference():
    """The IR's builders on a hand-made graph: identity access maps
    restricted to an op's loop dims, strides as fractions, and the
    structure signature the topology cache keys on."""
    def build(ir):
        ir.reset_fresh_names()
        g = ir.Graph("toy")
        g.tensor("x", (4, 8), dims=("batch", "d"), is_input=True)
        g.tensor("w", (8, 16), dims=("d", "f"), is_weight=True)
        g.tensor("y", (4, 16), dims=("batch", "f"))
        g.op("matmul", ["x", "w"], ["y"],
             loop_dims={"batch": 4, "d": 8, "f": 16}, flops=2 * 4 * 8 * 16)
        g.op("relu", ["y"], ["y"], loop_dims={"batch": 4})
        am = ir.AccessMap.of(("batch", Fraction(2)), (None, 1))
        return (graph_dump(g), g.structure_signature(), g.total_flops(),
                [[d, str(s)] for d, s in am.entries],
                am.axes_for_loop_dim("batch"), am.loop_dim_for_axis(1))
    assert build(T_ir) == build(R_ir)
