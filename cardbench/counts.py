"""The yardstick's arithmetic, frozen with the benchmark: the chip's
peaks, the operations and bytes of the kernels the per-layer metrics
read, and the model's work per step.

Peaks are NVIDIA's data sheet for one H100 SXM (dense bf16, HBM3), at
its 700 W limit.  A kernel's least time is the larger of its operations
over the peak rate and its bytes over the peak bandwidth; each input
byte counts once as read and each output byte once as written, and only
the rows the inputs make live (an expert's rows past its group size,
and an expert with no rows, cost nothing).
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def moe_gmm_work(live_experts: int, live_rows: int, D: int, F: int,
                 elt: int = BF16) -> tuple[float, float]:
    """(operations, bytes) of ``y[e] = x[e] @ w[e]`` over the live rows:
    ``x`` (rows, D) read, ``w`` (D, F) of each live expert read, ``y``
    (rows, F) written."""
    flops = 2.0 * live_rows * D * F
    nbytes = (live_experts * D * F + live_rows * (D + F)) * elt
    return flops, nbytes


def n_params(specs: dict) -> int:
    return sum(math.prod(s[0]) for s in specs.values())


def expert_paths(arch: dict) -> set:
    """The leaves of the routed experts' matrices."""
    from cardbench.reference.model import layer_sites
    return {f"{pfx}/ffn/{w}" for pfx, _i, _mix, ffn in layer_sites(arch)
            if ffn == "moe" for w in ("w_in", "w_out")}


def expert_params(specs: dict, arch: dict) -> int:
    """Parameters of the routed experts' matrices (0 without MoE)."""
    return sum(math.prod(specs[p][0]) for p in expert_paths(arch))


def train_flops_per_token(specs: dict, arch: dict, seq: int) -> float:
    """Model FLOPs of one trained token, without recomputation:
    ``6 N + 6 L S d`` (N every parameter, L layers, S the sequence, d the
    model width)."""
    return 6.0 * n_params(specs) + 6.0 * arch["n_layers"] * seq * \
        arch["d_model"]


def dense_weight_bytes(specs: dict, arch: dict) -> float:
    """Bytes of the weights a decode step reads whole: every leaf but
    the routed experts' matrices and the embedding table (a step gathers
    its rows; a tied table is read whole as the head)."""
    experts = expert_paths(arch)
    total = 0.0
    for p, (shape, dname, _init, _std) in specs.items():
        if p in experts:
            continue
        if p == "embed" and not arch.get("tie_embeddings"):
            continue
        total += math.prod(shape) * (BF16 if dname == "bf16" else F32)
    return total


# --------------------------------------------------------------------------
# the readings the per-layer metrics share
# --------------------------------------------------------------------------

def gmm_roofline(run) -> float | None:
    """Percent: the grouped matmul's least time, over the live experts
    and rows its calls in the profiler's window had, over its kernels'
    time there."""
    t = run.traced
    if not t or not t["kernel_s"].get("moe_gmm"):
        return None
    least = 0.0
    for key, (live_e, rows, _calls) in t["counters"].items():
        if key.startswith("moe_gmm/"):
            D, F = (int(v) for v in key.split("/")[1].split("x"))
            least += bound_s(*moe_gmm_work(live_e, rows, D, F))
    return 100.0 * least / t["kernel_s"]["moe_gmm"]


def idle_share(run) -> float | None:
    """Percent of the profiler's window with no device operation."""
    t = run.traced
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def serve_mfu(run) -> float | None:
    """Percent: the traced run's decode steps at the chip's bandwidth
    over the window.  A step reads the weights it uses whole (the live
    experts' from the device counters) and the cache rows its live rows
    need; the side steps' cache reads are not counted."""
    from cardbench.reference.model import param_specs
    rec = run.rec
    if "step_runs" not in rec or not rec.get("window_s"):
        return None
    specs = param_specs(run.arch)
    nbytes = rec["step_runs"] * dense_weight_bytes(specs, run.arch) + \
        rec["cache_bytes"]
    flops = 0.0
    for key, (live_e, rows, _calls) in rec.get("window_counters",
                                               {}).items():
        if key.startswith("moe_gmm/"):
            D, F = (int(v) for v in key.split("/")[1].split("x"))
            f, b = moe_gmm_work(live_e, rows, D, F)
            flops, nbytes = flops + f, nbytes + b
    return 100.0 * bound_s(flops, nbytes) / rec["window_s"]


def train_mfu(run) -> float | None:
    """Percent: the window's trained tokens at ``train_flops_per_token``
    over the peak bf16 rate, over the window."""
    from cardbench.reference.model import param_specs
    rec = run.rec
    if not rec.get("tokens"):
        return None
    flops = rec["tokens"] * train_flops_per_token(
        param_specs(run.arch), run.arch, run.traffic["seq"])
    return 100.0 * flops / PEAK_BF16_FLOPS / rec["window_s"]
