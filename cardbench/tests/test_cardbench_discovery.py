"""A configuration, a traffic mix, a cell and a per-layer metric are
added by new files and new ``BENCHMARK.json`` entries alone: in a copy
of the benchmark, none of whose files is edited, the new cell runs and
reports the new metric."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import JAMBA, KINDS, ROOT


def _digest(root) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "cardbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path)

    cb = tmp_path / "cardbench"
    (cb / "configs" / "jamba-tiny.json").write_text(json.dumps(
        {"source": "https://arxiv.org/abs/2403.19887", "reduced": [],
         "arch": JAMBA}))
    traffic = dict(KINDS["serve_static"][1], slots=4)
    (cb / "traffic" / "tiny-static4.json").write_text(json.dumps(traffic))
    cell = "jamba-tiny.tiny-static4"
    (cb / "cells" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"served_gap": 10.0}}))
    (cb / "metrics" / "waves.serve.py").write_text(
        "def read(run):\n    return float(len(run.state.get('waves', [])))\n")
    bench["configs"].append({"name": "jamba-tiny", "source": "x",
                             "file": "cardbench/configs/jamba-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "jamba-tiny",
                               "traffic": "tiny-static4", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_tok_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "waves.serve", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "scheduler", "moves": "serve_tok_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    code = f"""
import sys, json, io, contextlib, torch
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]
from cardbench import run
for trace in (0, 1):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", {cell!r}, "--seed", "4", "--seconds",
                       "0.3", "--trace", str(trace)],
                      device=torch.device("cpu"))
    assert rc == 0
    print(out.getvalue().strip().splitlines()[-1])
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()[-2:]]
    assert set(lines[0]["metrics"]) == {"serve_tok_s", "setup_s"}
    assert lines[1]["metrics"]["waves.serve"]["value"] >= 1
    assert all(x["correct"] for x in lines)
