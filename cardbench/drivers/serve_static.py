"""Waves through the serve driver's static path (``run_static``), the
path ``launch/serve.py`` serves a model with MoE layers on.

Setup compiles the serving plan (``fetch_plan``, no plan cache), builds
the LM with the kernels, draws the weights and captures the wave's CUDA
graph.  The window runs waves of ``slots`` requests, one ``run_static``
call each, until ``--seconds`` have passed; a wave that has started is
finished and counted.  Wave ``i`` serves one fixed set of prompt and
output lengths (``harness.length_set``) in an order fixed by ``i`` alone
(``harness.lengths``), with tokens drawn from the seed; decoding is
greedy.

The rows of a wave share each step's expert capacity, so the reference
recomputes whole waves: the tokens each decode step was fed are recorded
at the step boundary (``harness.StepWatch``; one copy on the device a
step), also those a row is fed after its own request has finished.

Traffic parameters: ``slots``, ``prompt_len`` and ``max_new``
(``{"mean", "sigma", "clip"}``: a lognormal's quantiles),
``sample_waves``, ``trace_seconds`` and ``trace_after_s`` (where in the
window the traced run's profiler begins).
"""
from __future__ import annotations

import time

import numpy as np

from cardbench import harness as H
from cardbench.drivers import common


def s_max_of(tr: dict) -> int:
    from repro_torch.launch.scheduler import prefill_bucket
    n = tr["slots"]
    return prefill_bucket(max(H.length_set(tr["prompt_len"], n)), 16) + \
        max(H.length_set(tr["max_new"], n))


def setup(run: H.Run) -> None:
    from repro_torch.launch import graphs
    from repro_torch.launch.serve import fetch_plan
    tr = run.traffic
    s_max = s_max_of(tr)
    t0 = time.perf_counter()
    plan, _info = fetch_plan(run.cfg, slots=tr["slots"], s_max=s_max,
                             cache_root=None)
    run.rec["compile_s"] = time.perf_counter() - t0
    lm, params = common.model(run, plan)
    g = graphs.step_graph(lm, params, tr["slots"], s_max, False)
    g.run(pos=0)
    g.reset()
    run.state.update(lm=lm, params=params, s_max=s_max, graph=g)


def wave_requests(run: H.Run, i: int) -> list:
    from repro_torch.launch.scheduler import Request
    tr = run.traffic
    n = tr["slots"]
    pl, mn = H.lengths(tr["prompt_len"], tr["max_new"], n, i)
    rng = np.random.default_rng(H.seed_mix(run.seed, 1, i))
    now = time.perf_counter()
    return [Request(rid=j, prompt_len=int(p), max_new=int(m),
                    prompt=rng.integers(0, run.arch["vocab"], int(p)),
                    t_submit=now) for j, (p, m) in enumerate(zip(pl, mn))]


def window(run: H.Run) -> None:
    from repro_torch.launch.scheduler import run_static
    tr, st = run.traffic, run.state
    waves, reports = [], []
    fed: list = []
    l_max = [0]

    def on_step(graph, kw):
        if graph is st["graph"] and kw["pos"] >= l_max[0]:
            fed.append((kw["pos"], kw["tokens"][:, 0].clone()))

    i, unit_s = 0, []
    with H.StepWatch(run, on_step):
        if run.tracer is not None:
            run.tracer.start()
        t0 = time.perf_counter()
        while H.more(run, t0, i):
            t1 = time.perf_counter()
            reqs = wave_requests(run, i)
            l_max[0] = max(r.prompt_len for r in reqs)
            fed.clear()
            reports.append(run_static(st["lm"], st["params"], reqs,
                                      seed=run.seed, s_max=st["s_max"],
                                      slots=tr["slots"]))
            waves.append((reqs, list(fed)))
            unit_s.append(time.perf_counter() - t1)
            i += 1
        run.sync()
        run.rec["window_s"] = time.perf_counter() - t0
    if run.tracer is not None:
        run.tracer.stop()
    run.rec["unit_s"] = unit_s
    common.serve_record(run, reports)
    run.state["waves"] = waves


def end_to_end(run: H.Run) -> dict:
    return {"serve_tok_s": run.rec["generated"] / run.rec["window_s"]}


def release(run: H.Run) -> None:
    common.release(run, keep=("flat", "waves", "requests"))


def wave_inputs(reqs: list, fed: list) -> tuple:
    """(tokens (B, L), at (B, L), served (n,)) of one wave: the prompts,
    right-padded with zeros to the longest as ``run_static`` feeds them,
    then what each decode step was fed; ``at`` marks the positions whose
    logits gave a served token."""
    B = len(reqs)
    l_max = max(r.prompt_len for r in reqs)
    g_max = max(r.max_new for r in reqs)
    L = l_max + g_max - 1
    toks = np.zeros((B, L), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :r.prompt_len] = r.prompt
    for pos, t in fed:
        toks[:, pos] = t.cpu().numpy()
    at = np.zeros((B, L), bool)
    served = []
    for i, r in enumerate(reqs):
        at[i, l_max - 1:l_max - 1 + len(r.out)] = True
        served.append(np.asarray(r.out, np.int64))
    return toks, at, np.concatenate(served)


def check(run: H.Run, readings: bool = False) -> dict:
    """The reference over whole sampled waves (every position's expert
    capacity is shared by the wave's rows); the numbers are those of
    ``common.gap_stats`` that the cell's limits name."""
    waves = run.state["waves"]
    rng = np.random.default_rng(H.seed_mix(run.seed, 2))
    pick = rng.permutation(len(waves))[:run.traffic["sample_waves"]]
    seqs = [wave_inputs(*waves[int(j)]) for j in pick]
    return common.served_gaps(run, seqs, "position", readings)
