"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``: the train step, the deterministic
sharded data pipeline, AdamW, async checkpointing with auto-resume,
straggler monitoring, and (optionally) simulated preemption to exercise
the restart path.  On the CPU, a smoke config::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --device cpu --steps 12 --batch 4 --seq 64 --ckpt-every 0

Preempt, then resume from the newest committed checkpoint::

    ... --steps 10 --ckpt-every 3 --simulate-preemption-at 7 --ckpt-dir D
    ... --steps 10 --ckpt-every 3 --ckpt-dir D        # resumes from 6

Checkpoints are in the reference's format (``distributed/checkpoint.py``),
so this driver resumes a run that ``repro.launch.train`` checkpointed,
and the other way round.

Without a plan: the reference optimises one (``optimize()``) and shards
the step under it; on one card there is nothing to shard, and applying a
plan is ROADMAP A8, so the driver prints ``plan: skipped`` and
``--fsdp`` has no effect.  The step runs the plain paths, as the
reference's step trains without its kernels.  As the reference jits it
with params and moments donated, the step on ``cuda`` is one CUDA graph
(``launch/steps.build_train_step``), captured at the first step and
replayed after; the graphs captured and their capture seconds are
printed at the end.  AdamW updates params and moments in place, the
counterpart of that donation, so the graph reads and writes the tensors
the driver made at the start: a resume copies the checkpoint into them,
and ``CheckpointManager.save`` copies them to the host before it
returns.  The lr schedule's value reaches the graph through its static
scalar at every step.
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config, list_archs
from ..data import ShardedLoader, SyntheticCorpus
from ..distributed import CheckpointManager, StragglerMonitor
from ..optim import AdamW, cosine_schedule
from . import graphs
from .steps import build_train_step


def build(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    print("[train] plan: skipped (one card: no sharding until ROADMAP A8)")
    opt = AdamW(lr=args.lr, moment_dtype=cfg.opt_moment_dtype)
    lr_fn = cosine_schedule(1.0, warmup=max(args.steps // 20, 1),
                            total=args.steps)
    step = build_train_step(cfg, opt, remat=args.remat, device=args.device)

    def train_step(params, opt_state, batch, i):
        return step.fn(params, opt_state, batch, lr_scale=lr_fn(i))

    return cfg, step.lm, opt, train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--fsdp", action="store_true",
                    help="accepted for the reference's command line; no "
                    "effect until the port applies plans (ROADMAP A8)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-preemption-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    cfg, lm, opt, step_fn = build(args)
    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    loader = ShardedLoader(corpus, args.batch, args.seq)
    ckpt = CheckpointManager(args.ckpt_dir)
    monitor = StragglerMonitor(n_hosts=1)

    params, _ = lm.init(args.seed)
    opt_state = opt.init(params)

    start, restored = 0, False
    latest = ckpt.latest_step()
    if latest is not None:
        start = latest
        held = {"params": params, "opt": opt_state}
        graphs.copy_into(held, ckpt.restore(latest, held))
        restored = True
        print(f"[train] resumed from step {latest}")

    before = graphs.stats()
    losses = []
    for step in range(start, args.steps):
        if step == args.simulate_preemption_at and not restored:
            print(f"[train] simulated preemption at step {step}")
            ckpt.wait()
            return {"preempted_at": step, "losses": losses}
        t0 = time.perf_counter()
        batch = loader.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        monitor.step({0: dt})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    ckpt.wait()
    after = graphs.stats()
    print(f"[train] graphs: {after['graphs'] - before['graphs']} captured "
          f"in {after['capture_s'] - before['capture_s']:.2f} s")
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "resumed_from": start}


if __name__ == "__main__":
    out = main()
    print(f"[train] done: {out.get('final_loss')}")
