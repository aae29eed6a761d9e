"""End-to-end training driver: the port's counterpart of
``examples/train_e2e.py``, over ``repro_torch.launch.train``.  Trains a
smollm-135m-class model with the full substrate (HIDA plan, sharded
deterministic data, AdamW and the cosine schedule, asynchronous
checkpoints with auto-resume, the straggler monitor); the loss falls on
the Markov-flavoured synthetic corpus.

Reduced config (CPU):
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 200 \\
        --device cpu

Full config, on the card:
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --full \\
        --steps 500 --batch 8 --seq 1024

Checkpoints go under the system's temporary directory unless
``--ckpt-dir`` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import main as train_main


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="full config; default is reduced")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every",
            str(args.ckpt_every), "--device", args.device]
    if not args.full:
        argv.append("--smoke")
    out = train_main(argv)
    losses = out["losses"]
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"[e2e] loss {first:.3f} -> {last:.3f} "
          f"({'DECREASED' if last < first else 'did not decrease'})")
    return out


if __name__ == "__main__":
    main()
