"""The port's synthetic graph generator (``repro_torch.core.generate``)
against the reference's.

* The registry lists the same presets, with equal specs, beside the
  archs (``repro_torch.configs``) and in ``repro_torch.core``.
* ``synth_1k``, ``synth_5k`` and ``synth_10k`` build the reference's
  graphs: equal structure fingerprints, and equal ops in the same order;
  each lands within 15% of its op target, as ``tests/test_generate.py``
  pins for the reference.
* ``optimize`` on ``synth_1k`` gives the reference's plan JSON, byte for
  byte.

No wall-clock gate: ``chip_smoke.py`` phase 18 times the compiles.
"""
import dataclasses

import pytest

import repro.configs as rcfg
import repro.core as R
from repro.core import ir as R_ir
from repro.core.generate import build_synth_graph as r_build
import repro_torch.configs as tcfg
import repro_torch.core as T
from repro_torch.core import ir as T_ir
from repro_torch.core.generate import SYNTH_CONFIGS, SynthSpec, build_synth_graph
import torch_parity  # noqa: F401  (one torch thread per pytest worker)

NAMES = ["synth_1k", "synth_5k", "synth_10k"]


def _ops(g) -> list:
    return [(o.name, o.kind, tuple(o.ins), tuple(o.outs), o.flops,
             tuple(sorted(o.loop_dims.items())))
            for o in g.walk()]


def test_registry_equals_reference():
    assert tcfg.list_synths() == rcfg.list_synths() == NAMES
    assert list(tcfg.SYNTH_CONFIGS) == NAMES
    for name in NAMES:
        assert dataclasses.asdict(tcfg.SYNTH_CONFIGS[name]) == \
            dataclasses.asdict(rcfg.SYNTH_CONFIGS[name])
        assert tcfg.SYNTH_CONFIGS[name].name == name
    assert T.SYNTH_CONFIGS is SYNTH_CONFIGS
    assert T.get_synth is tcfg.get_synth
    with pytest.raises(KeyError):
        tcfg.get_synth("synth_999")


@pytest.mark.parametrize("name", NAMES)
def test_graph_equals_reference(name):
    got = tcfg.get_synth(name)
    want = rcfg.get_synth(name)
    assert got.structure_signature() == want.structure_signature()
    assert _ops(got) == _ops(want)
    assert got.outputs == want.outputs == ["synth_out"]
    n = sum(1 for _ in got.walk())
    assert abs(n - SYNTH_CONFIGS[name].n_ops) <= 0.15 * \
        SYNTH_CONFIGS[name].n_ops


def test_build_depends_only_on_spec():
    """Bit-identical rebuilds; another seed or no group bound rewires the
    graph, in the port as in the reference."""
    spec = SYNTH_CONFIGS["synth_1k"]
    assert build_synth_graph(spec).structure_signature() == \
        build_synth_graph(spec).structure_signature()
    for change in ({"seed": spec.seed + 1}, {"group_size": 0},
                   {"moe_every": 0, "composite_every": 0}):
        tspec = SynthSpec(**{**spec.__dict__, **change})
        rspec = rcfg.SYNTH_CONFIGS["synth_1k"].__class__(
            **{**spec.__dict__, **change})
        sig = build_synth_graph(tspec).structure_signature()
        assert sig != build_synth_graph(spec).structure_signature()
        assert sig == r_build(rspec).structure_signature()


def test_synth_1k_plan_equals_reference():
    mesh_t = T.MeshSpec((("data", 16), ("model", 16)))
    mesh_r = R.MeshSpec((("data", 16), ("model", 16)))
    T_ir.reset_fresh_names()
    tsched, tplan, trep = T.optimize(tcfg.get_synth("synth_1k"), mesh_t)
    R_ir.reset_fresh_names()
    rsched, rplan, rrep = R.optimize(rcfg.get_synth("synth_1k"), mesh_r)
    assert tplan.to_json() == rplan.to_json()
    assert not trep.verify.issues
    assert len(tsched.nodes) == len(rsched.nodes) > 500
    assert trep.regions == rrep.regions > 1
    assert [str(d) for d in trep.degradations] == \
        [str(d) for d in rrep.degradations]
