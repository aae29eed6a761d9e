"""The expert-parallel serving kind (``drivers/serve_ep.py``) at a small
size on four gloo ranks on the CPU: a run is ``correct``, what decides
it fails on the faults the exchange can have and on the control (the
reference in fp8), and a run whose program lacks the expert-parallel
entry exits non-zero at once and leaves no worker behind."""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import OUTPUTS, PROMPTS, ROOT, run_cell

CELL = "deepseek-v2-l20.decode-ep4x32"
#: deepseek-v2's smoke sizes with the published model's routing, latent
#: norms and YaRN: 8 experts in 4 groups, top-2 in the best 2, gates
#: unnormalised times 2
ARCH = {"name": "deepseek-v2-smoke", "family": "moe", "n_layers": 3,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 32,
        "vocab": 256, "head_dim": 24,
        "moe": {"n_experts": 8, "top_k": 2, "n_shared": 1, "d_expert": 32,
                "capacity_factor": 4.0, "n_group": 4, "topk_group": 2,
                "norm_topk": False, "routed_scale": 2.0},
        "n_dense_layers": 1, "dense_d_ff": 128,
        "mla": {"kv_lora": 16, "q_lora": 24, "rope_dim": 8, "nope_dim": 16,
                "v_dim": 16, "latent_norm": True,
                "yarn": [40.0, 4096, 32.0, 1.0, 0.707]}}
TRAFFIC = {"driver": "serve_ep", "ranks": 4, "slots": 4,
           "prompt_len": PROMPTS, "max_new": OUTPUTS, "sample_waves": 1,
           "trace_seconds": 0.2}
#: the cell's number, the served tokens' mean gap less the bfloat16
#: witness's, above the program's largest reading at this size and under
#: the control's (``--readings`` from seeds 41-52, control on each: the
#: program -0.0026-0.0025, the control 0.0036-0.0273; the mean gap alone,
#: before the witness, read 0-0.0025 against 0.0004-0.0346 on 24 seeds)
LIMITS = {"served_gap_excess": 0.004}


def files() -> dict:
    from cardbench import harness as H
    bench = H.benchmark()
    return {"cell": {"name": CELL, "chips": 4}, "config": {"arch": ARCH},
            "traffic": dict(TRAFFIC), "limits": dict(LIMITS),
            "end_to_end": [m for m in bench["end_to_end"]
                           if CELL in m.get("workloads", [CELL])],
            "per_layer": [m for m in bench["per_layer"]
                          if CELL in m.get("workloads", [CELL])]}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One thread on every rank, this process (rank 0) included, so that
    the program's sums, and the tokens it serves, do not depend on the
    thread count of the process the test runs in."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_is_correct_and_traced():
    rc, res, text = run_cell("serve_ep", seed=11, trace=1, files=files())
    assert rc == 0, text[-3000:]
    assert res["correct"] is True, res
    names = {m["name"] for m in files()["per_layer"]}
    got = set(res["metrics"])
    # the CPU trace has no NCCL kernel and no grouped-matmul kernel time
    assert names - got <= {"a2a_share.ep", "moe_gmm_roofline.serve"}, got
    assert res["metrics"]["rank_skew.ep"]["value"] >= 100.0


def _rank0_seed() -> int:
    """A seed whose check samples rank 0: a fault planted in this
    process (rank 0) shows in rank 0's rows first."""
    from cardbench.drivers import serve_ep
    return next(s for s in range(300, 400) if serve_ep.pick(s, 4, 1)[0] == 0)


def _chunks_permuted(monkeypatch):
    """Rank 0's exchange sends each chunk to the next rank's experts."""
    from repro_torch.models import moe
    orig = moe._exchange

    def exchange(t, group, order):
        return orig(t.roll(1, 0), group, order)
    monkeypatch.setattr(moe, "_exchange", exchange)


def _experts_swapped(monkeypatch):
    """Rank 0 holds rank 1's experts in the place of its own."""
    from cardbench.drivers import serve_ep
    orig = serve_ep.held
    monkeypatch.setattr(serve_ep, "held", lambda rank, ranks, E: orig(
        1 if rank == 0 else rank, ranks, E))


@pytest.mark.parametrize("fault", [_chunks_permuted, _experts_swapped],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, res, text = run_cell("serve_ep", seed=_rank0_seed(), files=files())
    assert rc == 0, text[-3000:]
    assert res["correct"] is False, res["checks"]


def test_control_is_not_correct():
    """``--readings`` over three seeds, one wave each: the program's
    number under its limit on each, the control's over it on each."""
    from cardbench import run as R
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        R.main(["--workload", CELL, "--seed", "41", "--seconds", "0.01",
                "--readings", "3"], files=files(),
               device=torch.device("cpu"))
    lines = [json.loads(x[len("[readings] "):])["readings"]
             for x in out.getvalue().splitlines()
             if x.startswith("[readings] ")]
    assert len(lines) == 3
    for r in lines:
        assert all(r[k] <= v for k, v in LIMITS.items()), r
        assert all(r[f"control.{k}"] > v for k, v in LIMITS.items()), r


_NO_ENTRY = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from repro_torch.models import lm, moe
del moe.moe_ffn_serve_ep, lm.moe_ffn_serve_ep
import torch
from test_cardbench_ep import files
from cardbench import run
sys.exit(run.main(["--workload", "x", "--seed", "5", "--seconds", "0.3",
                   "--trace", "0"], files=files(),
                  device=torch.device("cpu")))
"""


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[1][0] != "Z"
    except FileNotFoundError:
        return False


def test_missing_entry_exits_and_leaves_no_worker():
    """A program without the expert-parallel entry: rank 0 fails in its
    set-up, after it started the other ranks, exits non-zero at once, and
    every worker is gone within a few seconds."""
    code = _NO_ENTRY.format(src=str(ROOT / "src"), root=str(ROOT),
                            tests=str(ROOT / "cardbench" / "tests"))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0, p.stderr[-3000:]
    assert time.perf_counter() - t0 < 120
    pids = [int(line.split("pid ")[1]) for line in p.stderr.splitlines()
            if line.startswith("[serve_ep] rank ")]
    assert len(pids) == 3, p.stderr[-3000:]
    deadline = time.perf_counter() + 20
    while any(_alive(q) for q in pids) and time.perf_counter() < deadline:
        time.sleep(0.2)
    assert not any(_alive(q) for q in pids), pids
