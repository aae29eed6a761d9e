"""CI hazard lint: compile a config and report static dataflow hazards.

    PYTHONPATH=src python -m repro_torch.lint smollm-135m
    PYTHONPATH=src python -m repro_torch.lint all --shape train_4k
    PYTHONPATH=src python -m repro_torch.lint synth_1k --json

The port's copy of ``repro.lint``, over the port's compiler: the same
targets, flags, JSON keys, text lines and exit codes.  It runs on the
host alone.

Each target runs the full ``optimize()`` pipeline (smoke-sized model
configs by default, so the sweep is CI-cheap) and reports the exit
hazard analysis (:mod:`repro_torch.core.analyze`) alongside the legality
verdict (:mod:`repro_torch.core.verify`) and any degradation-ladder rungs
that fired.  Exit status is nonzero when any target has hazard
*errors*, verifier errors, or — under ``--strict`` — warnings or
degradations, so the command gates in CI exactly like a compiler
``-Werror`` lane.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .configs import get_config, list_archs
from .configs.base import SHAPES
from .core import SINGLE_POD, build_lm_graph, optimize
from .core.generate import list_synths

__all__ = ["lint_one", "main"]


def lint_one(name: str, *, shape: str = "train_4k",
             smoke: bool = True) -> dict:
    """Compile one target (arch or synth name) and collect its lint
    verdict.  Returns a JSON-friendly dict; never raises for hazards
    (that is the caller's exit-code decision)."""
    if name in list_synths():
        from .core.generate import get_synth
        graph = get_synth(name)
    else:
        graph = build_lm_graph(get_config(name, smoke=smoke),
                               SHAPES[shape])
    t0 = time.perf_counter()
    sched, plan, rep = optimize(graph, SINGLE_POD)
    wall_s = time.perf_counter() - t0
    arep, vrep = rep.analyze, rep.verify
    return {
        "target": name,
        "ok": bool(arep is not None and arep.ok
                   and vrep is not None and vrep.ok),
        "errors": [str(i) for i in (arep.errors() if arep else [])],
        "warnings": [str(i) for i in (arep.warnings() if arep else [])],
        "verify_errors": [str(i) for i in (vrep.errors() if vrep else [])],
        "degradations": [str(d) for d in rep.degradations],
        "checks": arep.checks if arep else 0,
        "rules_run": list(arep.rules_run) if arep else [],
        "analyze_s": rep.analyze_s,
        "wall_s": wall_s,
        "nodes": len(sched.nodes),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static dataflow hazard lint (deadlock / FIFO depth "
                    "/ shard races / ordering / index invariants)")
    ap.add_argument("targets", nargs="*", default=["all"],
                    help="arch names, synth names, or 'all' "
                         f"(archs: {', '.join(list_archs())}; "
                         f"synths: {', '.join(list_synths())})")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES),
                    help="shape for model configs (default train_4k)")
    ap.add_argument("--full", action="store_true",
                    help="full-size configs instead of smoke-sized")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON object per line instead of text")
    ap.add_argument("--strict", action="store_true",
                    help="warnings and degradations also fail the lint")
    args = ap.parse_args(argv)

    targets = list(args.targets) or ["all"]
    if "all" in targets:
        targets = list_archs() + [t for t in targets if t != "all"
                                  and t not in list_archs()]
    failed = 0
    for name in targets:
        res = lint_one(name, shape=args.shape, smoke=not args.full)
        bad = (not res["ok"]) or (args.strict and bool(
            res["warnings"] or res["degradations"]))
        failed += bad
        if args.as_json:
            print(json.dumps(res, sort_keys=True))
            continue
        verdict = "FAIL" if bad else "ok"
        print(f"[lint] {name}: {verdict} — {res['checks']} checks, "
              f"{len(res['rules_run'])} rules, "
              f"analyze {res['analyze_s'] * 1e3:.2f} ms, "
              f"compile {res['wall_s']:.2f} s, {res['nodes']} nodes")
        for line in res["errors"]:
            print(f"[lint]   hazard  {line}")
        for line in res["verify_errors"]:
            print(f"[lint]   verify  {line}")
        for line in res["warnings"]:
            print(f"[lint]   warn    {line}")
        for line in res["degradations"]:
            print(f"[lint]   degrade {line}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
