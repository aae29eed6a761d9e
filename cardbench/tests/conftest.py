"""Small configurations and cells of every traffic kind, for the
benchmark's CPU tests (and its card tests, marked ``gpu``)."""
from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SMOLLM = {"name": "smollm-smoke", "family": "dense", "n_layers": 2,
          "d_model": 48, "n_heads": 3, "n_kv_heads": 1, "d_ff": 128,
          "vocab": 256, "head_dim": 16, "tie_embeddings": True}
#: jamba's three kinds of layer in two: Mamba, then attention + MoE
#: (deeper small models drift further from the reference: bf16 round-off
#: grows through each Mamba layer and moves near-tied routes)
JAMBA = {"name": "jamba-smoke", "family": "hybrid", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
         "vocab": 256, "head_dim": 16,
         "mamba": {"d_state": 8, "d_conv": 4, "expand": 2, "chunk": 16},
         "attn_every": 2, "attn_offset": 1,
         "moe": {"n_experts": 4, "top_k": 2, "n_shared": 0,
                 "d_expert": 128, "capacity_factor": 4.0},
         "moe_every": 2}
#: the static path's small model: attention + MoE in every layer (the
#: small Mamba's bf16 drift moves near-tied routes at decode as often as
#: fp8 does, so at this size it would hide the control)
MOE_ATTN = dict(JAMBA, name="moe-attn-smoke", attn_every=1, attn_offset=0)
ADAMW = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.1, "grad_clip": 1.0}

#: the serving kinds' lengths at this size: lognormal quantiles, as the
#: cells' traffic draws them (``harness.length_set``)
PROMPTS = {"mean": 8.0, "sigma": 0.5, "clip": [2, 16]}
OUTPUTS = {"mean": 6.0, "sigma": 0.5, "clip": [2, 12]}

#: kind -> (arch, traffic, limits at this size, the cell it stands for);
#: each limit holds the number its cell compares, between the largest
#: reading of the program and the smallest of the control
#: (``--readings``) over twelve seeds or more at this size (forty-two for
#: the static kind, whose mean gap one row served wrong also fails here)
KINDS = {
    "serve_continuous": (
        SMOLLM, {"driver": "serve_continuous", "slots": 4,
                 "batch_requests": 6, "prompt_len": PROMPTS,
                 "max_new": OUTPUTS, "sample_requests": 6,
                 "trace_seconds": 0.2},
        {"served_gap": 0.01}, "smollm-135m.chat-cont32"),
    "serve_static": (
        MOE_ATTN, {"driver": "serve_static", "slots": 16,
                   "prompt_len": PROMPTS, "max_new": OUTPUTS,
                   "sample_waves": 1, "trace_seconds": 0.2},
        {"served_gap_mean": 0.001},
        "jamba-l16.decode-static32"),
    "train": (
        SMOLLM, {"driver": "train", "batch": 4, "seq": 64, "remat": "full",
                 "adamw": ADAMW, "check_steps": 3, "trace_seconds": 0.2},
        {"loss_gap": 3e-4, "grad_gap": 0.004, "change_gap": 0.005},
        "smollm-135m.train-s4k"),
}


def files_of(kind: str) -> dict:
    """The ``files`` a run of ``kind`` reads, at the small size, with the
    end-to-end and per-layer metrics of the cell it stands for."""
    from cardbench import harness as H
    arch, traffic, limits, cell = KINDS[kind]
    bench = H.benchmark()
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if cell in m.get("workloads", [cell])],
               "per_layer": [m for m in bench["per_layer"]
                             if cell in m.get("workloads", [cell])]}
    return {"cell": {"name": cell, "chips": 1}, "config": {"arch": arch},
            "traffic": dict(traffic), "limits": dict(limits), **metrics}


def run_cell(kind: str, seed: int = 11, trace: int = 0, files=None,
             device="cpu", seconds: float = 0.5) -> tuple[int, dict, str]:
    """(exit code, the result line, all of standard output) of one run
    of ``kind`` on ``device``, the harness's look for a card skipped."""
    from cardbench import run as R
    files = files or files_of(kind)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = R.main(["--workload", files["cell"]["name"], "--seed",
                     str(seed), "--seconds", str(seconds), "--trace",
                     str(trace)], files=files, device=torch.device(device))
    text = out.getvalue()
    last = text.strip().splitlines()[-1] if text.strip() else "{}"
    return rc, json.loads(last) if last.startswith("{") else {}, text


@pytest.fixture
def cuda():
    """Skips a card test where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)
