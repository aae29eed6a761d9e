#!/usr/bin/env python3
"""The train driver's loop time against its checkpoint cadence, on the
card.

    python3 scripts/ckpt_cadence.py [--steps 41] [--every 0 3 10 20]

Runs ``repro_torch.launch.train.main`` at smollm-135m's full width (B=8,
S=1024, remat full, as ``chip_smoke.py`` phase 13 does) once per
``--ckpt-every`` value, each in a fresh temporary directory that is
removed afterwards, and prints the loop's ms per step (the gaps between
the driver's straggler-monitor calls, saves included: ``chip_smoke``'s
``driver_run``) beside the cadence, with the card's name and power
limit.  A 3-step run without checkpoints goes first, untimed, so the
first row starts warm.  No kernel may launch.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=41)
    ap.add_argument("--every", type=int, nargs="+", default=[0, 3, 10, 20])
    args = ap.parse_args()
    cs.phase_device()
    common = ["--arch", cs.ARCH, "--device", cs.DEVICE,
              "--seed", str(cs.SEED), "--batch", str(cs.TRAIN_B),
              "--seq", str(cs.TRAIN_S), "--remat", "full",
              "--lr", str(cs.TRAIN_LR), "--steps", str(args.steps)]
    with tempfile.TemporaryDirectory() as d:
        cs.driver_run("warm-up", common[:-1] + [
            "3", "--ckpt-dir", d, "--ckpt-every", "0"])
    rows = []
    for every in args.every:
        with tempfile.TemporaryDirectory() as d:
            cs.reset_counts()
            out = cs.driver_run(f"every {every}", common + [
                "--ckpt-dir", d, "--ckpt-every", str(every)])
            counts = cs.read_counts()
        if any(counts.values()):
            raise AssertionError(f"the driver launched kernels: {counts}")
        gaps = sorted(out["gap_ms"])
        rows.append({"ckpt_every": every, "ms_per_step": out["ms_per_step"],
                     "median_gap_ms": gaps[len(gaps) // 2],
                     "max_gap_ms": gaps[-1], "wall_s": out["wall_s"],
                     "tail_s": out["tail_s"]})
    base = rows[0]["ms_per_step"]
    for r in rows:
        print(f"[cadence] --ckpt-every {r['ckpt_every']}: the loop "
              f"{r['ms_per_step']:.1f} ms a step "
              f"({r['ms_per_step'] / base:.2f}x the first row), median gap "
              f"{r['median_gap_ms']:.1f} ms, "
              f"longest {r['max_gap_ms']:.1f} ms; {r['tail_s']:.3f} s from "
              f"the last step to the return")
    print(json.dumps({"steps": args.steps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
