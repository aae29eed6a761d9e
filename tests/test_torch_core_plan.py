"""The port's ``ShardingPlan``, plan cache, verifier, analyzer and fault
injector (``repro_torch.core``) against the reference's.

* ``spec_for_dims`` and ``param_spec`` return plain tuples equal to
  ``tuple(P)`` of the reference's ``PartitionSpec``, over every buffer site
  of every arch's golden plan, with and without FSDP, on both meshes.
* Plans and cache entries cross between the packages as JSON, and each
  package's on-disk plan cache is a hit for the other (equal ``PlanKey``
  digests); ``fetch_or_optimize`` goes cold, hit, warm in both.
* Under one zero-fault injector and under seeded chaos injectors,
  ``optimize`` gives the same plan and the same degradations in both.
"""
import json

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.configs import get_config as rget
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.core import ir as R_ir
from repro.core.faults import inject_faults as r_inject
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import ir as T_ir
from repro_torch.core.faults import inject_faults as t_inject
from repro_torch.core.plan_cache import CachedPlan
import torch_parity  # noqa: F401  (one torch thread per pytest worker)

from golden_utils import GOLDEN_DIR

ARCHS = list_archs()


def golden(arch: str) -> dict:
    return json.loads((GOLDEN_DIR / f"{arch}.json").read_text())


def _queries(arch: str, seed: int = 0):
    """(dims, site, shape) triples: every buffer of the golden schedule at
    its own dims and shape, under its own site, no site, a role alias and
    a site whose rank mismatches; plus random shapes for the FSDP
    divisibility rule."""
    g = golden(arch)
    plan = g["plan"]
    rng = np.random.default_rng(seed)
    sizes = np.array([1, 2, 3, 5, 16, 32, 48, 64, 256, 4096])
    out = []
    for name, buf in g["schedule"]["buffers"].items():
        dims, shape = tuple(buf["dims"]), tuple(buf["shape"])
        out += [(dims, name, shape), (dims, None, shape), (dims, name, None)]
        if len(dims) > 1:
            out.append((dims[:-1], name, shape[:-1]))
        out.append((dims, name, tuple(int(s) for s in
                                      rng.choice(sizes, len(dims)))))
    for role, src in plan.get("role_sources", {}).items():
        dims = tuple(g["schedule"]["buffers"].get(src, {}).get("dims", ()))
        out.append((dims, role, None))
    return out


def _plans(arch: str, fsdp: bool, mesh: str):
    text = json.dumps(golden(arch)["plan"])
    tp, rp = T.ShardingPlan.from_json(text), R.ShardingPlan.from_json(text)
    tp.fsdp = rp.fsdp = fsdp
    if mesh == "multi_pod":
        tp.mesh_spec, rp.mesh_spec = T.MULTI_POD, R.MULTI_POD
    return tp, rp


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_partition_specs(arch):
    for fsdp in (False, True):
        for mesh in ("single_pod", "multi_pod"):
            tp, rp = _plans(arch, fsdp, mesh)
            for dims, site, shape in _queries(arch):
                got = tp.spec_for_dims(dims, site)
                assert type(got) is tuple
                assert got == tuple(rp.spec_for_dims(dims, site)), \
                    (dims, site)
                got = tp.param_spec(dims, site, shape)
                assert type(got) is tuple
                assert got == tuple(rp.param_spec(dims, site, shape)), \
                    (dims, site, shape, fsdp, mesh)
            assert tp.spec_rank_mismatches == rp.spec_rank_mismatches


def test_spec_rules_by_hand():
    """The dedupe rule (leftmost dim keeps a repeated axis), trailing
    replicated dims dropped, FSDP on the first free divisible dim and
    never on expert weights."""
    for core in (T, R):
        p = core.ShardingPlan(
            mesh_spec=core.MeshSpec((("data", 4), ("model", 2))),
            rules={"batch": ("data",), "heads": ("model",),
                   "d_ff": ("model", "data"), "experts": ("data",)},
            fsdp=True)
        got = [tuple(p.spec_for_dims(("batch", "d_ff", "heads"))),
               tuple(p.spec_for_dims(("heads", "seq"))),
               tuple(p.param_spec(("d_model", "heads"), shape=(6, 8))),
               tuple(p.param_spec(("d_model", "heads"), shape=(8, 8))),
               tuple(p.param_spec(("experts", "d_model"))),
               tuple(p.spec_for_dims(("seq",)))]
        assert got == [("data", "model"), ("model",), (None, ("model",
                       "data")), ("data", "model"), ("data",), ()], core


def test_constrain_is_the_identity():
    """No device mesh in the port: ``constrain`` returns its input, as the
    reference's does outside a mesh context."""
    p = T.ShardingPlan.from_json(json.dumps(golden("smollm-135m")["plan"]))
    x = object()
    assert p.constrain(x, ("batch", "seq", "d_model"), "logits") is x


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_json_crosses_both_ways(arch):
    text = json.dumps(golden(arch)["plan"])
    rp = R.ShardingPlan.from_json(text)
    tp = T.ShardingPlan.from_json(rp.to_json())
    assert tp.to_json() == rp.to_json()
    assert R.ShardingPlan.from_json(tp.to_json()).to_json() == tp.to_json()
    assert tp.role_sources == rp.role_sources and tp.meta == rp.meta


def test_plan_json_version_gate_and_replicated_plan():
    d = json.loads(json.dumps(golden("smollm-135m")["plan"]))
    d["version"] = T.PLAN_FORMAT_VERSION + 1
    for core in (T, R):
        with pytest.raises(ValueError, match="version"):
            core.ShardingPlan.from_json(json.dumps(d))
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        assert (T.replicated_plan(getattr(T, mesh), fsdp=True).to_json()
                == R.replicated_plan(getattr(R, mesh), fsdp=True).to_json())


def test_apply_rule_change_equals_reference():
    """The delta re-projection on the optimized schedule of each package:
    the same re-projected sites and the same plan after it."""
    plans = []
    for core, ir, get in ((T, T_ir, get_config), (R, R_ir, rget)):
        ir.reset_fresh_names()
        g = core.build_lm_graph(get("smollm-135m"), SHAPES["train_4k"])
        sched, plan, _ = core.optimize(g, core.SINGLE_POD)
        changed = plan.apply_rule_change("seq", ("data",), sched)
        changed += plan.apply_rule_change("batch", (), sched)
        plans.append((changed, plan.to_json(),
                      core.verify_static(plan, core.SINGLE_POD).ok))
    assert plans[0] == plans[1]


# -- the plan cache ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plan_keys_equal(arch):
    for smoke in (False, True):
        tc, rc = get_config(arch, smoke=smoke), rget(arch, smoke=smoke)
        assert T.config_fingerprint(tc) == R.config_fingerprint(rc)
        for mesh in ("SINGLE_POD", "MULTI_POD"):
            for seq, batch in ((100, 4), (4096, 8), (32768, 128)):
                bucket = T.shape_bucket("decode", seq, batch)
                assert bucket == R.shape_bucket("decode", seq, batch)
                tk = T.PlanKey.make(tc, getattr(T, mesh), bucket)
                rk = R.PlanKey.make(rc, getattr(R, mesh), bucket)
                assert tk.digest() == rk.digest()
                assert tk.to_dict() == rk.to_dict()


def _factory(core, get, shapespec, arch, seq, batch):
    cfg = get(arch, smoke=True)
    return cfg, lambda: core.build_lm_graph(
        cfg, shapespec("d", seq, batch, "decode"))


PKGS = {"port": (T, T_ir, get_config, ShapeSpec),
        "reference": (R, R_ir, rget, RShapeSpec)}


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_each_cache_is_a_hit_for_the_other(tmp_path, writer, reader):
    wcore, wir, wget, wshape = PKGS[writer]
    rcore, rir, rget_, rshape = PKGS[reader]
    wcfg, wfac = _factory(wcore, wget, wshape, "smollm-135m", 256, 4)
    bucket = wcore.shape_bucket("decode", 256, 4)
    wir.reset_fresh_names()
    wplan, src, _ = wcore.fetch_or_optimize(
        wcore.PlanCache(tmp_path), wcore.PlanKey.make(
            wcfg, wcore.SINGLE_POD, bucket), wcore.SINGLE_POD, wfac)
    assert src == "cold"
    rcfg, rfac = _factory(rcore, rget_, rshape, "smollm-135m", 256, 4)
    cache = rcore.PlanCache(tmp_path)
    plan, src, rep = rcore.fetch_or_optimize(
        cache, rcore.PlanKey.make(rcfg, rcore.SINGLE_POD, bucket),
        rcore.SINGLE_POD, rfac)
    assert (src, rep) == ("hit", None)
    assert cache.stats["hits_disk"] == 1
    assert plan.to_json() == wplan.to_json()


def test_cache_entries_cross_as_json(tmp_path):
    """A stored entry (plan, warm snapshot, QoR) reads back in the other
    package to the same bytes."""
    cfg, fac = _factory(R, rget, RShapeSpec, "xlstm-125m", 128, 2)
    key = R.PlanKey.make(cfg, R.SINGLE_POD, R.shape_bucket("decode", 128, 2))
    R_ir.reset_fresh_names()
    R.fetch_or_optimize(R.PlanCache(tmp_path), key, R.SINGLE_POD, fac)
    (path,) = tmp_path.glob("*.json")
    text = path.read_text()
    assert CachedPlan.from_json(text).to_json() == text
    assert path.name == f"{key.digest()}.json"


def _progression(name, root):
    """cold, then hit, then warm (same config, another bucket)."""
    core, ir, get, shapespec = PKGS[name]
    cache = core.PlanCache(root)
    out = []
    for seq, batch in ((256, 4), (256, 4), (1024, 4)):
        cfg, fac = _factory(core, get, shapespec, "stablelm-3b", seq, batch)
        key = core.PlanKey.make(cfg, core.SINGLE_POD,
                                core.shape_bucket("decode", seq, batch))
        ir.reset_fresh_names()
        plan, src, rep = core.fetch_or_optimize(
            cache, key, core.SINGLE_POD, fac)
        out.append((src, plan.to_json(),
                    None if rep is None else
                    (rep.parallelize.warm, rep.parallelize.warm_covered,
                     rep.parallelize.evaluated, rep.cost.total_s)))
    return out


def test_fetch_or_optimize_cold_hit_warm_equal_reference(tmp_path):
    port = _progression("port", tmp_path / "t")
    ref = _progression("reference", tmp_path / "r")
    assert [s for s, _, _ in port] == ["cold", "hit", "warm"]
    assert port == ref


# -- faults, verify, analyze --------------------------------------------------

def _under(inject, core, ir, get, arch, **spec):
    ir.reset_fresh_names()
    g = core.build_lm_graph(get(arch), SHAPES["train_4k"])
    with inject(**spec) as inj:
        sched, plan, rep = core.optimize(g, core.SINGLE_POD)
    return {"plan": plan.to_json(),
            "degradations": [(d.stage, d.action, d.error)
                             for d in rep.degradations],
            "fired": [(r.site, r.kind) for r in inj.records],
            "verify": rep.verify.ok, "total_s": rep.cost.total_s,
            "schedule": sched.to_json()}


def test_zero_fault_injector_is_bit_identical():
    spec = dict(seed=0, rate=0.0, corrupt_rate=0.0)
    port = _under(t_inject, T, T_ir, get_config, "smollm-360m", **spec)
    ref = _under(r_inject, R, R_ir, rget, "smollm-360m", **spec)
    assert port == ref and not port["degradations"] and not port["fired"]
    assert json.loads(port["plan"]) == golden("smollm-360m")["plan"]


#: (arch, seed, rate, sites): the first four are ``tests/test_faults.py``'s
#: rates by seed over every site; the rest aim at one layer each
CHAOS = [("smollm-135m", 0, 0.08, ("*",)), ("smollm-135m", 1, 0.03, ("*",)),
         ("smollm-135m", 2, 0.015, ("*",)), ("xlstm-125m", 3, 0.08, ("*",)),
         ("smollm-135m", 0, 0.08, ("dse.*", "plan.*")),
         ("stablelm-3b", 1, 0.3, ("dse.inner", "dse.outer")),
         ("smollm-135m", 1, 0.2, ("fusion.*", "mp.*", "balance.*",
                                  "analyze.*")),
         ("smollm-135m", 2, 0.2, ("fusion.*", "mp.*", "balance.*",
                                  "analyze.*"))]


@pytest.mark.parametrize("arch,seed,rate,sites", CHAOS)
def test_chaos_injector_degrades_as_reference(arch, seed, rate, sites):
    """The chaos lane of ``tests/test_faults.py``: one seeded injector in
    each package fires at the same sites, and ``optimize`` takes the same
    rungs of its degradation ladder to the same plan."""
    spec = dict(seed=seed, rate=rate, corrupt_rate=0.05, sites=sites)
    port = _under(t_inject, T, T_ir, get_config, arch, **spec)
    ref = _under(r_inject, R, R_ir, rget, arch, **spec)
    assert port["fired"] == ref["fired"] and port["fired"]
    assert port == ref


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "deepseek-v2-236b"])
def test_verify_and_analyze_equal_reference(arch):
    """``verify_static`` and ``analyze_plan`` of each golden plan on both
    meshes (the serve driver's lint), and the full ``verify`` and
    ``analyze`` of the optimized schedule."""
    text = json.dumps(golden(arch)["plan"])
    tp, rp = T.ShardingPlan.from_json(text), R.ShardingPlan.from_json(text)
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        tv = T.verify_static(tp, getattr(T, mesh))
        rv = R.verify_static(rp, getattr(R, mesh))
        assert (tv.ok, tv.checks, [str(i) for i in tv.issues]) == \
            (rv.ok, rv.checks, [str(i) for i in rv.issues])
        ta = T.analyze_plan(tp, getattr(T, mesh))
        ra = R.analyze_plan(rp, getattr(R, mesh))
        assert ta.summary() == ra.summary()
        assert [str(i) for i in ta.issues] == [str(i) for i in ra.issues]
    out = []
    for core, ir, get in ((T, T_ir, get_config), (R, R_ir, rget)):
        ir.reset_fresh_names()
        g = core.build_lm_graph(get(arch), SHAPES["train_4k"])
        sched, plan, _ = core.optimize(g, core.SINGLE_POD)
        v = core.verify(sched, plan, core.SINGLE_POD)
        a = core.analyze(sched, plan, core.SINGLE_POD)
        out.append((v.ok, v.checks, [str(i) for i in v.issues],
                    a.summary(), [str(i) for i in a.issues]))
    assert out[0] == out[1]
