"""The serving loop's host spans (``repro_torch.launch.spans``) and the
requests' stall counter, on the CPU with the smoke configs.

The decode step's three spans tile it and give the report's sums (on a
clock the test controls); the counts follow the steps, the one-pass
prefills and the side steps run; the batcher admits by the one-pass
prefill exactly where the stack allows it; a recording profiler sees
each span as a range and changes no token; ``stall_s`` is the admission
time a running request waited; and the benchmark's readers of them
return a number from a run of their cell's driver.
"""
import json
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch import scheduler as TS
from repro_torch.launch import spans
from repro_torch.models.lm import LM

S_MAX = 96
STEP = ("serve.launch", "serve.logits", "serve.sample")


_MODELS: dict = {}


def _model(arch):
    """The smoke ``arch`` with the kernels' plain versions, and params
    from seed 0 (built once a module)."""
    if arch not in _MODELS:
        lm = LM(get_config(arch, smoke=True), use_kernels=True,
                device="cpu")
        _MODELS[arch] = (lm, lm.init(0)[0])
    return _MODELS[arch]


@pytest.fixture(scope="module")
def model():
    return _model("smollm-135m")


def _trace(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(3, 30))),
             int(rng.integers(4, 12))) for _ in range(n)]


def _continuous(lm, params, trace, slots=3, groups=None):
    b = TS.ContinuousBatcher(lm, params, slots=slots, s_max=S_MAX)
    if groups is not None:
        admit = b._admit_group

        def record(pairs):
            groups.append([r for _, r in pairs])
            admit(pairs)
        b._admit_group = record
    for prompt, gen in trace:
        if lm.cfg.frontend == "audio_frames":
            b.submit(None, gen, prompt_len=len(prompt))
        else:
            b.submit(prompt, gen)
    return b.run()


class _Clock:
    """A clock the test controls, in place of ``time.perf_counter`` and
    ``perf_counter_ns`` (the spans' and the batcher's): each read
    advances it by a tick (1 us), each call of the model (a decode step,
    a one-pass prefill) by a step (1 ms), as the card's work would.  The
    spans then measure the loop's own structure, the reads and the steps
    inside and outside each span, and not how a loaded machine shares
    its cores among the workers that run beside the test."""

    TICK, STEP = 1_000, 1_000_000

    def __init__(self):
        self.ns = 0

    def read_ns(self) -> int:
        self.ns += self.TICK
        return self.ns

    def read(self) -> float:
        return self.read_ns() / 1e9

    def stepped(self, fn):
        def call(*args, **kw):
            self.ns += self.STEP
            return fn(*args, **kw)
        return call


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter_ns", c.read_ns)
    monkeypatch.setattr(time, "perf_counter", c.read)
    for name in ("decode_step", "prefill_into"):
        monkeypatch.setattr(LM, name, c.stepped(getattr(LM, name)))
    return c


def _static(lm, params, trace, slots=3):
    reqs = [TS.Request(rid=i, prompt_len=len(p), max_new=g, prompt=p)
            for i, (p, g) in enumerate(trace)]
    return TS.run_static(lm, params, reqs, seed=0, s_max=S_MAX, slots=slots)


def _sec(rep, name):
    return rep.spans.get(name, (0, 0.0))[1]


@pytest.mark.parametrize("path", ["continuous", "static"])
def test_step_spans_add_up_to_the_report_sums(model, path, clock):
    """launch + logits (+ sample on the static path) is ``decode_s``,
    admission (or the prompt steps) ``prefill_s``, within 1%; the step
    spans and the admission rounds cover the loop's wall time.  Both
    wall-clock checks run on the test's ``clock``: on the host's, with
    other workers on its cores, a preemption between two spans missed
    either the 1% of the tiling or the 0.97 of the cover."""
    lm, params = model
    trace = _trace(lm.cfg)
    if path == "continuous":
        rep = _continuous(lm, params, trace)
        phases, prefill = STEP[:2], "serve.admit"
    else:
        rep = _static(lm, params, trace)
        phases, prefill = STEP, "serve.prompt"
    assert rep.decode_s > 0 and rep.prefill_s > 0
    assert math.isclose(sum(_sec(rep, k) for k in phases), rep.decode_s,
                        rel_tol=0.01)
    assert math.isclose(_sec(rep, prefill), rep.prefill_s, rel_tol=0.01)
    # the three children tile each step
    assert math.isclose(sum(_sec(rep, k) for k in STEP),
                        _sec(rep, "serve.step"), rel_tol=0.01)
    if path == "continuous":
        covered = _sec(rep, "serve.step") + _sec(rep, "serve.admit")
        assert 0.97 * rep.wall_s <= covered <= rep.wall_s


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m"])
def test_counts_follow_steps_and_side_steps(arch):
    """One ``serve.install`` a group; a ``serve.prefill`` a group where
    the batcher admits in one pass (smollm), else a ``serve.side_steps``
    count a side step (xlstm, whose stack carries recurrent state)."""
    lm, params = _model(arch)
    groups: list = []
    rep = _continuous(lm, params, _trace(lm.cfg, n=7, seed=1), slots=2,
                      groups=groups)
    for name in ("serve.step",) + STEP:
        assert rep.spans[name][0] == rep.steps
    if arch == "smollm-135m":
        assert rep.spans["serve.prefill"][0] == len(groups)
        assert "serve.side_steps" not in rep.spans
    else:
        assert rep.spans["serve.side_steps"][0] == sum(
            max(r.prompt_len for r in g) for g in groups)
        assert "serve.prefill" not in rep.spans
    assert rep.spans["serve.install"][0] == len(groups)
    srep = _static(lm, params, _trace(lm.cfg, n=5), slots=2)
    for name in ("serve.step",) + STEP:
        assert srep.spans[name][0] == srep.steps
    assert srep.spans["serve.prompt"][0] == 3
    assert "serve.side_steps" not in srep.spans
    assert "serve.prefill" not in srep.spans


@pytest.mark.parametrize("arch,one_pass", [
    ("smollm-135m", True), ("h2o-danube-3-4b", True),
    ("xlstm-125m", False), ("musicgen-large", False),
    ("llama-3.2-vision-11b", False)])
def test_admission_path_follows_the_stack(arch, one_pass):
    """The batcher admits every group by the one-pass prefill where each
    layer is GQA self-attention over tokens with every cache row held
    (smollm; h2o-danube's window of 16 with all ``s_max`` rows cached),
    and by side steps, recording no ``serve.prefill``, where the stack
    carries recurrent state (xlstm), reads audio frames (musicgen) or
    cross-attends (llama-vision)."""
    lm, params = _model(arch)
    assert lm.fills_caches(S_MAX) is one_pass
    if lm.cfg.attn_window:
        # past 65536 rows the cache keeps only the window: side steps
        assert not lm.fills_caches(1 << 17)
    rep = _continuous(lm, params, _trace(lm.cfg, n=5, seed=6), slots=2)
    groups = rep.spans["serve.install"][0]
    assert groups >= 2
    if one_pass:
        assert rep.spans["serve.prefill"][0] == groups
        assert "serve.side_steps" not in rep.spans
    else:
        assert "serve.prefill" not in rep.spans
        assert rep.spans["serve.side_steps"][0] > 0


def test_process_sums_and_reset(model):
    lm, params = model
    spans.reset()
    assert spans.sums() == {}
    rep = _static(lm, params, _trace(lm.cfg, n=2), slots=2)
    assert spans.sums() == rep.spans
    before = spans.sums()
    rep2 = _static(lm, params, _trace(lm.cfg, n=2), slots=2)
    assert spans.since(before) == rep2.spans
    assert spans.sums()["serve.step"][0] == rep.steps + rep2.steps


def test_spans_holding_a_profiler_start_or_stop_are_kept_apart():
    """A profiler that starts inside one span and stops inside another
    adds both to ``<name>.profiler`` as well; a span with no change of
    the profiler's state adds nothing there."""
    spans.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    with spans.span("x"):
        pass
    with spans.span("x"):
        prof.start()
    with spans.span("x"):
        pass
    with spans.span("x"):
        prof.stop()
    got = spans.sums()
    assert got["x"][0] == 4 and got["x" + spans.PROFILER][0] == 2
    assert 0 < got["x" + spans.PROFILER][1] <= got["x"][1]


@pytest.mark.parametrize("path", ["continuous", "static"])
def test_greedy_tokens_equal_under_a_profiler(model, path):
    lm, params = model
    trace = _trace(lm.cfg, seed=2)
    serve = _continuous if path == "continuous" else _static
    plain = serve(lm, params, trace)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = serve(lm, params, trace)
    assert [r.out for r in traced.requests] == \
        [r.out for r in plain.requests]


def _ranges(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith("serve.")]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m"])
def test_chrome_trace_holds_the_ranges(arch, tmp_path):
    """One ``serve.sample`` range a step, each inside a ``serve.step``;
    each group's ``serve.prefill`` (smollm: its request ids and the
    padded batch's tokens, k × S) or ``serve.side_steps`` (xlstm: its
    request ids) lies inside a ``serve.admit``."""
    lm, params = _model(arch)
    groups: list = []
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        rep = _continuous(lm, params, _trace(lm.cfg, seed=3), slots=2,
                          groups=groups)
    ev = _ranges(prof, tmp_path)
    steps = [e for e in ev if e["name"] == "serve.step"]
    sample = [e for e in ev if e["name"] == "serve.sample"]
    assert len(steps) == len(sample) == rep.steps
    assert all(any(_inside(s, st) for st in steps) for s in sample)
    name = "serve.prefill" if arch == "smollm-135m" else "serve.side_steps"
    side = sorted((e for e in ev if e["name"] == name),
                  key=lambda e: e["ts"])
    assert [e["args"]["rids"] for e in side] == \
        [",".join(str(r.rid) for r in g) for g in groups]
    if name == "serve.prefill":
        assert [e["args"]["tokens"] for e in side] == \
            [len(g) * max(r.prompt_len for r in g) for g in groups]
    assert not [e for e in ev if e["name"] in
                {"serve.prefill", "serve.side_steps"} - {name}]
    admits = [e for e in ev if e["name"] == "serve.admit"]
    assert all(any(_inside(s, a) for a in admits) for s in side)


def test_stall_counts_admission_while_running(model):
    """Two slots, one long request beside a short one; the short one's
    slot then takes a request with a long prompt, whose prefill the
    long request waits through.  Its ``stall_s`` is the admission time
    that passed between its first token and its last."""
    lm, params = model
    rng = np.random.default_rng(4)
    b = TS.ContinuousBatcher(lm, params, slots=2, s_max=S_MAX)
    rounds: list = []
    admit = b._admit

    def timed(rep):
        t0 = time.perf_counter()
        admit(rep)
        rounds.append((t0, time.perf_counter()))
    b._admit = timed
    long = b.submit(rng.integers(0, lm.cfg.vocab, 4), 40)
    b.submit(rng.integers(0, lm.cfg.vocab, 4), 2)
    late = b.submit(rng.integers(0, lm.cfg.vocab, 60), 3)
    rep = b.run()
    assert len(rounds) == 2 and late.t_first > rounds[1][0]
    want = sum(max(0.0, min(t1, long.t_done) - max(t0, long.t_first))
               for t0, t1 in rounds)
    assert want >= rounds[1][1] - rounds[1][0] - 1e-3
    assert abs(long.stall_s - want) <= 1e-3 + 0.01 * want
    assert long.stall_s <= rep.prefill_s
    # the requests not running through a later round waited little
    assert late.stall_s < 0.1 * long.stall_s
    held = sum(r.t_done - r.t_first for r in rep.requests)
    assert math.isclose(rep.stall_share,
                        sum(r.stall_s for r in rep.requests) / held)
    d = rep.to_dict()
    assert d["stall_share"] == rep.stall_share
    assert d["spans"]["serve.admit"]["count"] == 2


# -- the benchmark's readers --------------------------------------------

SMALL = {"name": "smollm-smoke", "family": "dense", "n_layers": 2,
         "d_model": 48, "n_heads": 3, "n_kv_heads": 1, "d_ff": 128,
         "vocab": 256, "head_dim": 16, "tie_embeddings": True}
MOE = {"name": "moe-attn-smoke", "family": "hybrid", "n_layers": 2,
       "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
       "vocab": 256, "head_dim": 16, "attn_every": 1, "attn_offset": 0,
       "moe": {"n_experts": 4, "top_k": 2, "n_shared": 0, "d_expert": 128,
               "capacity_factor": 4.0},
       "moe_every": 2}
LENGTHS = {"prompt_len": {"mean": 8.0, "sigma": 0.5, "clip": [2, 16]},
           "max_new": {"mean": 6.0, "sigma": 0.5, "clip": [2, 12]}}
CELLS = {
    "smollm-135m.chat-cont32": (SMALL, dict(
        LENGTHS, driver="serve_continuous", slots=4, batch_requests=6,
        sample_requests=2, trace_seconds=0.2), {"served_gap": 1e9}),
    "jamba-l16.decode-static32": (MOE, dict(
        LENGTHS, driver="serve_static", slots=8, sample_waves=1,
        trace_seconds=0.2), {"served_gap_mean": 1e9}),
}
NEW = {"launch_ms.serve", "sample_ms.serve", "side_step_ms.cont",
       "stall_share.cont", "prefill_ms.cont"}
#: readers with nothing to read in a cell: smollm admits by the one-pass
#: prefill, so the chat driver runs no side step
SILENT = {"side_step_ms.cont"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readers_return_a_number_from_a_cpu_run(cell):
    """Each new reader of the cell, as ``BENCHMARK.json`` lists it, reads
    a number from one traced run of the cell's driver at a small size,
    ``prefill_ms.cont`` the chat driver's one-pass prefills; the side
    step's reader reads nothing there (``SILENT``)."""
    import argparse

    from cardbench import harness as H
    from cardbench import run as R
    arch, traffic, limits = CELLS[cell]
    bench = H.benchmark()
    files = {"cell": {"name": cell, "chips": 1}, "config": {"arch": arch},
             "traffic": traffic, "limits": limits,
             "end_to_end": [m for m in bench["end_to_end"]
                            if cell in m.get("workloads", [cell])],
             "per_layer": [m for m in bench["per_layer"]
                           if cell in m.get("workloads", [cell])]}
    names = {m["name"] for m in files["per_layer"]} & NEW
    assert names == (NEW if "chat" in cell
                     else {"launch_ms.serve", "sample_ms.serve"})
    args = argparse.Namespace(workload=cell, seed=2**31 + 5, seconds=0.3,
                              trace=1, readings=0)
    spans.reset()
    out = R.one_run(args, files, torch.device("cpu"), time.perf_counter())
    for name in sorted(names):
        v = H.metric_reader(name).read(out["run"])
        if name in SILENT:
            assert v is None, name
            continue
        assert isinstance(v, float) and math.isfinite(v) and v > 0, name
