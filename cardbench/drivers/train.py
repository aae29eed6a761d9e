"""The train path: the train driver's build (``launch/train.build``): the
compiler's plan for the run's shape on a one-slot data mesh,
``build_train_step`` on its CUDA graph with full remat, AdamW.

Setup builds the step, draws the weights, and drives that same step
through its first ``check_steps`` steps, on batches from the seed
(every row distinct), reading what the check compares: each step's
loss, the first gradient as AdamW took it (its first moment over
``1 - b1``), and each leaf's change over those steps.  The window runs
the following steps, one batch each, until ``--seconds`` have passed.
No checkpoint is written.

Traffic parameters: ``batch``, ``seq``, ``remat``, ``adamw`` (lr, b1,
b2, eps, weight_decay, grad_clip), ``check_steps``, ``trace_seconds``.
"""
from __future__ import annotations

import statistics
import time

import torch

from cardbench import harness as H
from cardbench.drivers import common
from cardbench.reference.model import Precision, param_specs
from cardbench.reference.train import AdamWSpec, train_readings


def batch(run: H.Run, i: int) -> dict:
    """Step ``i``'s rows, drawn on the device from the seed."""
    tr = run.traffic
    gen = torch.Generator(device=run.device).manual_seed(
        H.seed_mix(run.seed, 3, i))
    x = torch.randint(0, run.arch["vocab"], (tr["batch"], tr["seq"] + 1),
                      generator=gen, device=run.device)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def setup(run: H.Run) -> None:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import MeshSpec, build_lm_graph, optimize
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW
    tr = run.traffic
    t0 = time.perf_counter()
    shape = ShapeSpec("cli", tr["seq"], tr["batch"], "train")
    _sched, plan, _rep = optimize(build_lm_graph(run.cfg, shape),
                                  MeshSpec((("data", 1), ("model", 1))),
                                  fsdp=False)
    run.rec["compile_s"] = time.perf_counter() - t0
    opt = AdamW(moment_dtype=run.cfg.opt_moment_dtype, **tr["adamw"])
    step = build_train_step(run.cfg, opt, remat=tr["remat"],
                            device=run.device, plan=plan)
    flat = H.make_params(param_specs(run.arch), run.seed, run.device)
    H.check_layout(run.cfg, flat)
    params = H.nest(flat)
    opt_state = opt.init(params)
    start = {p: t.clone() for p, t in flat.items()}
    losses, grad_norms = [], None
    for i in range(tr["check_steps"]):
        params, opt_state, metrics = step.fn(params, opt_state,
                                             batch(run, i))
        losses.append(float(metrics["loss"]))
        if grad_norms is None:
            mu = H.flatten(opt_state.mu)
            grad_norms = {p: float(m.float().norm()) / (1 - opt.b1)
                          for p, m in mu.items()}
    change = {p: float((flat[p].float() - start[p].float()).norm())
              for p in flat}
    del start
    run.state.update(step=step, params=params, opt_state=opt_state,
                     first={"loss": losses, "grad_norm": grad_norms,
                            "change_norm": change})


def window(run: H.Run) -> None:
    st, tr = run.state, run.traffic
    i = tr["check_steps"]
    if run.tracer is not None:
        run.tracer.start()
    t0 = time.perf_counter()
    while H.more(run, t0, i - tr["check_steps"]):
        st["params"], st["opt_state"], _m = st["step"].fn(
            st["params"], st["opt_state"], batch(run, i))
        run.sync()
        i += 1
        if run.tracer is not None:
            run.tracer.tick()
    run.rec["window_s"] = time.perf_counter() - t0
    if run.tracer is not None:
        run.tracer.stop()
    n = i - tr["check_steps"]
    run.rec.update(attempted=n, failed=0, steps=n,
                   tokens=n * tr["batch"] * tr["seq"])


def end_to_end(run: H.Run) -> dict:
    return {"train_tok_s": run.rec["tokens"] / run.rec["window_s"]}


def release(run: H.Run) -> None:
    common.release(run, keep=("first",))


def gaps(got: dict, want: dict) -> dict:
    """The numbers a check can hold: the worst step's loss gap relative
    to the reference's loss; the worst and the median leaf's gap of
    gradient norms, and of change norms, each against the larger of the
    reference leaf's norm and the median leaf's (``.leaf`` names the
    worst).  Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    change."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(got["loss"], want["loss"]))}
    gn = want["grad_norm"]
    g_med = statistics.median(gn.values())
    moved = [p for p in gn if gn[p] >= 1e-3 * g_med]
    for key, name, leaves in (("grad_norm", "grad_gap", list(gn)),
                              ("change_norm", "change_gap", moved)):
        ref = want[key]
        med = statistics.median(ref.values())
        per = {p: abs(got[key][p] - ref[p]) / max(ref[p], med)
               for p in leaves}
        worst = max(per, key=per.get)
        out.update({name: per[worst], f"{name}.leaf": worst,
                    f"{name}_median": statistics.median(per.values())})
    return out


def check(run: H.Run, readings: bool = False) -> dict:
    tr = run.traffic
    spec = AdamWSpec(**tr["adamw"])
    batches = [(b["tokens"], b["labels"]) for b in
               (batch(run, i) for i in range(tr["check_steps"]))]

    def follow(precision=Precision.F32, rows=None):
        params = H.make_params(param_specs(run.arch), run.seed, run.device)
        with common.exact_f32_grad():
            return train_readings(run.arch, params, batches, spec,
                                  precision, rows)

    want = follow()
    got = gaps(run.state["first"], want)
    lim = run.files["limits"]
    out = {"checks": [(k, got[k], lim[k]) for k in lim],
           "compared": len(batches)}
    out["readings"] = dict(got)
    if readings:
        for tag, kw in (("control", {"precision": Precision.FP8}),
                        ("half_batch", {"rows": tr["batch"] // 2})):
            for k, v in gaps(follow(**kw), want).items():
                out["readings"][f"{tag}.{k}"] = v
    return out
