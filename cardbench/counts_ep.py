"""The yardstick's arithmetic for expert-parallel serving
(``drivers/serve_ep.py``), beside ``counts.py``, whose peaks and kernel
counts it uses: a rank's share of the chip's peak in its decode steps,
the exchange's share of the device's busy time, and how evenly the ranks'
experts were loaded."""
from __future__ import annotations

import math

from cardbench import counts

#: bytes of a latent cache row of one MLA layer (bf16)
LATENT_ELT = counts.BF16


def rank_weight_bytes(arch: dict) -> float:
    """Bytes of the weights a rank's decode step reads whole: every leaf
    of the rank's layout but the routed experts' matrices (counted from
    the kernel's calls) and the embedding table (a step gathers its
    rows)."""
    from cardbench.reference import deepseek_v2 as D2
    routed = D2.moe_leaves(arch)
    total = 0.0
    for p, (shape, dname, _init, _std) in D2.param_specs(arch).items():
        if p in routed or p == "embed":
            continue
        total += math.prod(shape) * (counts.BF16 if dname == "bf16"
                                     else counts.F32)
    return total


def serve_mfu(run) -> float | None:
    """Percent: rank 0's decode steps at the chip's bandwidth over the
    window.  A step reads the weights it uses whole (its experts' from
    the grouped matmul's device counters), and each of its rows the
    latent cache rows at or before its position in every layer."""
    rec = run.rec
    if "step_runs" not in rec or not rec.get("window_s"):
        return None
    a = run.arch
    m = a["mla"]
    row = a["n_layers"] * (m["kv_lora"] + m["rope_dim"]) * LATENT_ELT
    nbytes = rec["step_runs"] * rank_weight_bytes(a) + \
        rec.get("cache_rows", 0) * row
    flops = 0.0
    for key, (live_e, rows, _calls) in rec.get("window_counters",
                                               {}).items():
        if key.startswith("moe_gmm/"):
            D, F = (int(v) for v in key.split("/")[1].split("x"))
            f, b = counts.moe_gmm_work(live_e, rows, D, F)
            flops, nbytes = flops + f, nbytes + b
    return 100.0 * counts.bound_s(flops, nbytes) / rec["window_s"]


def a2a_share(run) -> float | None:
    """Percent of rank 0's device busy time in the profiler's window
    spent in NCCL kernels (the exchange, its wait for the slowest rank
    included)."""
    t = run.traced
    if not t or "nccl_s" not in t or not t["busy_s"]:
        return None
    return 100.0 * t["nccl_s"] / t["busy_s"]


def rank_skew(run) -> float | None:
    """Percent: the (token, k) rows the busiest rank's experts received
    over the window, over the mean of the ranks'."""
    got = run.rec.get("ep_received")
    if not got or not sum(got):
        return None
    return 100.0 * max(got) * len(got) / sum(got)
