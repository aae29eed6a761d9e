"""Quickstart: HIDA-OPT derives the sharding plan, then we train a few
steps; nobody writes a PartitionSpec by hand.  The port's counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch smollm-135m] [--steps 10] [--device cpu]

The reduced (smoke) config trains on ``cuda`` unless ``--device cpu``
is given; without a card, ``cuda`` raises.  The audio and vision
frontends' frames and images are drawn from a ``torch.Generator``
seeded with the step.
"""
from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..configs import SHAPES, get_config, list_archs
from ..core import SINGLE_POD, build_lm_graph, optimize
from ..data import SyntheticCorpus
from ..launch.steps import build_train_step
from ..optim import AdamW


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. HIDA-OPT: algorithmic description -> dataflow plan.
    full_cfg = get_config(args.arch)
    graph = build_lm_graph(full_cfg, SHAPES["train_4k"])
    sched, plan, report = optimize(graph, SINGLE_POD)
    print(f"== {args.arch}: HIDA-OPT on the 16x16 production mesh ==")
    print(f"   nodes={len(sched.nodes)} "
          f"fusions={report.fusion.pattern_fusions}p"
          f"+{report.fusion.balance_fusions}b "
          f"balance_copies={report.balance.copy_nodes} "
          f"soft_fifos={report.balance.soft_fifos}")
    print(f"   estimated step: {report.cost.total_s*1e3:.2f} ms/block-iter"
          f" dominant={report.cost.dominant}")
    print(f"   sharding rules: {dict(sorted(plan.rules.items()))}")

    # 2. Train the reduced config for a few steps on the device.
    cfg = get_config(args.arch, smoke=True)
    step = build_train_step(cfg, opt=AdamW(lr=1e-3), remat="none",
                            device=device)
    params, _ = step.lm.init(0)
    opt_state = step.opt.init(params)
    corpus = SyntheticCorpus(cfg.vocab)
    print(f"== training the reduced config for {args.steps} steps on "
          f"{device} ==")
    losses = []
    for i in range(args.steps):
        batch = dict(corpus.batch(i, 0, 4, 32))
        gen = torch.Generator().manual_seed(i)
        if cfg.frontend == "audio_frames":
            batch["frames"] = torch.randn((4, 32, cfg.d_model),
                                          generator=gen)
        if cfg.frontend == "vision":
            batch["img_embeds"] = torch.randn(
                (4, cfg.n_img_tokens, cfg.d_model), generator=gen)
        params, opt_state, metrics = step.fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        print(f"   step {i}: loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
