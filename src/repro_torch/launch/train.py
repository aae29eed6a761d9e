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

Data-parallel over W ranks (``torchrun``, or any initialised process
group; gloo on the CPU, NCCL on the card)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --arch smollm-135m --smoke --steps 12 --batch 4 \
        --seq 64 --ckpt-every 0

As the reference does, the driver first builds the dataflow graph of the
run's shape and runs the HIDA compiler on it (``repro_torch.core``:
``build_lm_graph``, then ``optimize`` with ``--fsdp``) for a mesh whose
data axis has one slot per rank and whose model axis has one, as the
reference sizes its data axis to its devices; it prints the plan's
strategy, rules and compile seconds on a ``[train] plan:`` line and
builds the LM under the plan.  With no process group the mesh is one
slot of each, and no ``DeviceMesh`` is built; with one, the driver runs
under ``launch.mesh.make_host_mesh``'s ``(W, 1)`` mesh (``set_mesh``).
Params stay replicated, as the reference's driver leaves them; each
rank takes its shard of the global batch (``ShardedLoader(n_hosts=W,
host_id=rank)``), and the step averages the gradients and the metrics
over the data group before AdamW.  Rank 0 writes the checkpoints; every
rank restores from them.  The step runs the plain paths, as the
reference's step trains without its kernels.  On one rank, as the
reference jits it with params and moments donated, the step on ``cuda``
is one CUDA graph
(``launch/steps.build_train_step``), captured at the first step and
replayed after; the graphs captured and their capture seconds are
printed at the end.  AdamW updates params and moments in place, the
counterpart of that donation, so the graph reads and writes the tensors
the driver made at the start: a resume copies the checkpoint into them,
and ``CheckpointManager.save`` copies them to the host before it
returns.  The lr schedule's value reaches the graph through its static
scalar at every step.  Over W > 1 ranks the step runs eagerly (no
collective is captured), and the ``[train]`` line says so.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch.distributed as dist

from .. import resolve_device
from ..configs import get_config, list_archs
from ..configs.base import ShapeSpec
from ..core import MeshSpec, build_lm_graph, optimize
from ..data import ShardedLoader, SyntheticCorpus
from ..distributed import CheckpointManager, StragglerMonitor
from ..optim import AdamW, cosine_schedule
from . import graphs
from .mesh import BACKENDS, make_host_mesh, set_mesh
from .steps import build_train_step


def data_mesh(device: str):
    """The ``(W, 1)`` mesh over the process group's ranks, or ``None``
    where there is no group; under ``torchrun`` the group is initialised
    from its environment first."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[resolve_device(device).type])
    if not dist.is_initialized():
        return None
    return make_host_mesh(device=device)


def build(args):
    """The config, LM, optimizer and step of ``args``; ``args.mesh`` (set
    by ``main``; absent or ``None``: no process group) is the data
    mesh."""
    mesh = getattr(args, "mesh", None)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    # the reference sizes the data axis to its devices: here, the ranks
    world = 1 if mesh is None else mesh.size(0)
    mspec = MeshSpec((("data", world), ("model", 1)))
    t0 = time.perf_counter()
    g = build_lm_graph(cfg, shape)
    _sched, plan, report = optimize(g, mspec, fsdp=args.fsdp)
    say(f"[train] plan: {plan.meta.get('strategy', 'hida')}, rules "
        f"{dict(plan.rules)}, fsdp {plan.fsdp}, "
        f"{len(report.degradations)} degradations, compiled in "
        f"{time.perf_counter() - t0:.3f} s")
    opt = AdamW(lr=args.lr, moment_dtype=cfg.opt_moment_dtype)
    lr_fn = cosine_schedule(1.0, warmup=max(args.steps // 20, 1),
                            total=args.steps)
    group = None if mesh is None else mesh.get_group("data")
    step = build_train_step(cfg, opt, remat=args.remat, device=args.device,
                            plan=plan, data_group=group)
    if world > 1:
        say(f"[train] data-parallel over {world} ranks "
            f"({dist.get_backend()}): gradients and metrics averaged over "
            "the data group; the eager step (no CUDA graph)")

    def train_step(params, opt_state, batch, i):
        return step.fn(params, opt_state, batch, lr_scale=lr_fn(i))

    return cfg, step.lm, opt, train_step


def _committed(ckpt: CheckpointManager, mesh) -> None:
    """Wait for rank 0's checkpoint writes; over several ranks, no rank
    returns before they are committed, so that a restart of any rank
    finds them."""
    ckpt.wait()
    if mesh is not None and mesh.size(0) > 1:
        dist.barrier(group=mesh.get_group("data"))


def say(line: str) -> None:
    """Print on rank 0 only (every rank where there is no group)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line, flush=True)


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
                    help="FSDP weight sharding in the compiler's plan")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-preemption-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    mesh = args.mesh = data_mesh(args.device)
    world, rank = (1, 0) if mesh is None else (mesh.size(0),
                                               dist.get_rank())
    cfg, lm, opt, step_fn = build(args)
    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    loader = ShardedLoader(corpus, args.batch, args.seq, n_hosts=world,
                           host_id=rank)
    ckpt = CheckpointManager(args.ckpt_dir)
    writer = rank == 0
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
        say(f"[train] resumed from step {latest}")

    before = graphs.stats()
    losses = []
    with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for step in range(start, args.steps):
            if step == args.simulate_preemption_at and not restored:
                say(f"[train] simulated preemption at step {step}")
                _committed(ckpt, mesh)
                return {"preempted_at": step, "losses": losses,
                        "plan": lm.plan, "world": world}
            t0 = time.perf_counter()
            batch = loader.batch_at(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            monitor.step({0: dt})
            if step % 10 == 0 or step == args.steps - 1:
                say(f"[train] step {step:5d} loss {loss:.4f} "
                    f"({dt*1e3:.0f} ms)")
            if writer and args.ckpt_every \
                    and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    _committed(ckpt, mesh)
    after = graphs.stats()
    say(f"[train] graphs: {after['graphs'] - before['graphs']} captured "
        f"in {after['capture_s'] - before['capture_s']:.2f} s")
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "resumed_from": start, "plan": lm.plan,
            "world": world}


if __name__ == "__main__":
    out = main()
    say(f"[train] done: {out.get('final_loss')}")
    if dist.is_initialized():
        dist.destroy_process_group()
