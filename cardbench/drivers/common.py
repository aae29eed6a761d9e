"""Pieces the drivers share: the model and its weights, the serving
record, releasing the program's state, and the served-token comparison."""
from __future__ import annotations

import contextlib
import gc

import torch

from cardbench import harness as H
from cardbench.reference.model import Precision, Ref, param_specs


def model(run: H.Run, plan):
    """The LM with the kernels under ``plan``, and its weights from the
    seed (kept flat in ``run.state["flat"]`` for the reference)."""
    from repro_torch.models.lm import LM
    lm = LM(run.cfg, use_kernels=True, device=run.device, plan=plan)
    flat = H.make_params(param_specs(run.arch), run.seed, run.device)
    H.check_layout(run.cfg, flat)
    run.state["flat"] = flat
    return lm, H.nest(flat)


def serve_record(run: H.Run, reports: list) -> None:
    """The window's requests and the serving report's sums."""
    reqs = [r for rep in reports for r in rep.requests]
    run.state["requests"] = reqs
    steps = sum(rep.steps for rep in reports)
    run.rec.update(
        attempted=len(reqs),
        failed=sum(r.finish != "length" or len(r.out) != r.max_new
                   for r in reqs),
        generated=sum(rep.generated for rep in reports),
        steps=steps, decode_s=sum(rep.decode_s for rep in reports),
        prefill_s=sum(rep.prefill_s for rep in reports),
        serve_wall_s=sum(rep.wall_s for rep in reports),
        occupancy=(sum(rep.occupancy * rep.steps for rep in reports)
                   / steps if steps else None))


def release(run: H.Run, keep=()) -> None:
    """Drop the program's objects and graphs, keeping ``keep``."""
    from repro_torch.launch import graphs
    graphs.release()
    for k in [k for k in run.state if k not in keep]:
        del run.state[k]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def exact_f32_grad():
    """float32 products in float32 (TF32 off) inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextlib.contextmanager
def exact_f32():
    """``exact_f32_grad`` without autograd."""
    with exact_f32_grad(), torch.no_grad():
        yield


def gap_stats(gaps: torch.Tensor, rows: torch.Tensor,
              prefix: str = "") -> dict:
    """The numbers a served-token comparison can hold: the widest gap,
    its mean, and over the rows (the requests) the largest of each row's
    median gap, which one row served wrong moves by its whole gap and a
    few flipped routes in a long row do not move."""
    g = gaps.float()
    per_row = [g[rows == r] for r in torch.unique(rows)]
    return {f"{prefix}served_gap": float(g.max()),
            f"{prefix}served_gap_mean": float(g.mean()),
            f"{prefix}served_gap_row_median_max":
                float(max(r.median() for r in per_row))}


def served_gaps(run: H.Run, seqs: list, groups: str,
                readings: bool) -> dict:
    """``seqs``: (tokens (B, L), at (B, L) bool, served (n,)) with the
    served tokens in the row-major order of ``at``; each row is one
    request.  The reference's logits at ``at``; each served token's gap
    is the distance by which its logit lies below the reference's best
    there.  The numbers compared are those the cell's limits name
    (``gap_stats``).  With ``readings``, the control's too: the fp8
    reference's first token at each of those positions, read against the
    float32 reference."""
    dev = run.device
    ref = Ref(run.arch, run.state["flat"])
    control = Ref(run.arch, run.state["flat"], Precision.FP8)
    gaps, cgaps, rows, row0 = [], [], [], 0
    with exact_f32():
        for toks, at, served in seqs:
            t = torch.as_tensor(toks, device=dev)
            m = torch.as_tensor(at, device=dev)
            s = torch.as_tensor(served, device=dev).reshape(-1, 1)
            rows.append(m.nonzero()[:, 0].cpu() + row0)
            row0 += m.shape[0]
            lg = ref.forward(t, groups, at=m)
            best = lg.max(-1).values
            gaps.append((best - lg.gather(-1, s)[:, 0]).cpu())
            if readings:
                c = control.forward(t, groups, at=m).argmax(-1)[:, None]
                cgaps.append((best - lg.gather(-1, c)[:, 0]).cpu())
            del lg
    rows = torch.cat(rows)
    got = gap_stats(torch.cat(gaps), rows)
    lim = run.files["limits"]
    out = {"checks": [(k, got[k], lim[k]) for k in lim],
           "compared": sum(len(g) for g in gaps),
           "readings": dict(got)}
    if readings:
        out["readings"].update(gap_stats(torch.cat(cgaps), rows,
                                         "control."))
    return out
