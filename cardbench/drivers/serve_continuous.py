"""Closed batches through the serve driver's continuous batcher.

Setup compiles the serving plan as ``launch/serve.py`` does
(``fetch_plan``, no plan cache), builds the LM with the kernels under
it, draws the weights and captures every CUDA graph the traffic can
replay: the slot batch and each admission group width.  The window runs
batches of ``batch_requests`` requests through ``ContinuousBatcher.run``
one after another until ``--seconds`` have passed; a batch that has
started is finished and counted.  Batch ``i`` serves one fixed set of
prompt and output lengths (``harness.length_set``) in an order fixed by
``i`` alone (``harness.lengths``: the batcher's admission groups, and so
its work, follow the order), with tokens drawn from the seed.  Decoding
is greedy.

Traffic parameters: ``slots``, ``batch_requests``, ``prompt_len`` and
``max_new`` (``{"mean", "sigma", "clip"}``: a lognormal's quantiles),
``sample_requests`` (requests the reference checks), ``trace_seconds``
and ``trace_after_s`` (where in the window the traced run's profiler
begins).
"""
from __future__ import annotations

import time

import numpy as np

from cardbench import harness as H
from cardbench.drivers import common


def s_max_of(tr: dict) -> int:
    from repro_torch.launch.scheduler import prefill_bucket
    n = tr["batch_requests"]
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
    graphs.step_graph(lm, params, tr["slots"], s_max, True, use="slots")
    for k in range(1, tr["slots"] + 1):
        graphs.step_graph(lm, params, k, s_max, True, use="prefill")
    run.state.update(lm=lm, params=params, s_max=s_max)


def batch_requests(run: H.Run, i: int) -> list[tuple[np.ndarray, int]]:
    tr = run.traffic
    n = tr["batch_requests"]
    pl, mn = H.lengths(tr["prompt_len"], tr["max_new"], n, i)
    rng = np.random.default_rng(H.seed_mix(run.seed, 1, i))
    return [(rng.integers(0, run.arch["vocab"], int(p)), int(m))
            for p, m in zip(pl, mn)]


def window(run: H.Run) -> None:
    from repro_torch.launch.scheduler import ContinuousBatcher
    tr, st = run.traffic, run.state
    reports, i, unit_s = [], 0, []
    with H.StepWatch(run):
        if run.tracer is not None:
            run.tracer.start()
        t0 = time.perf_counter()
        while H.more(run, t0, i):
            t1 = time.perf_counter()
            b = ContinuousBatcher(st["lm"], st["params"], slots=tr["slots"],
                                  s_max=st["s_max"], seed=run.seed)
            for prompt, max_new in batch_requests(run, i):
                b.submit(prompt, max_new)
            reports.append(b.run())
            unit_s.append(time.perf_counter() - t1)
            i += 1
        run.sync()
        run.rec["window_s"] = time.perf_counter() - t0
    if run.tracer is not None:
        run.tracer.stop()
    run.rec["unit_s"] = unit_s
    common.serve_record(run, reports)


def end_to_end(run: H.Run) -> dict:
    reqs = run.state["requests"]
    tpot = [(r.t_done - r.t_first) / (len(r.out) - 1) * 1e3
            for r in reqs if len(r.out) > 1]
    return {"serve_tok_s": run.rec["generated"] / run.rec["window_s"],
            "tpot_p90_ms": H.quantile(tpot, 0.90)}


def release(run: H.Run) -> None:
    common.release(run, keep=("flat", "requests"))


def check(run: H.Run, readings: bool = False) -> dict:
    """The reference's logits over each sampled request's prompt and
    served tokens (rows are independent: one request at a time); the
    number is the widest gap by which a served token's logit lies below
    the reference's best."""
    reqs = run.state["requests"]
    rng = np.random.default_rng(H.seed_mix(run.seed, 2))
    longest = max(range(len(reqs)), key=lambda j: len(reqs[j].out)
                  + reqs[j].prompt_len)
    others = [j for j in rng.permutation(len(reqs)) if j != longest]
    pick = [longest] + others[:run.traffic["sample_requests"] - 1]
    seqs = []
    for j in pick:
        r = reqs[j]
        toks = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int64)])
        at = np.zeros(len(toks), bool)
        at[r.prompt_len - 1:] = True
        seqs.append((toks[None], at[None], np.asarray(r.out)[None]))
    return common.served_gaps(run, seqs, "sequence", readings)
