"""Serving driver: continuous batching over ``decode_step`` on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --slots 8 --requests 16 --prompt-len-range 16 256 \\
        --gen-range 32 128

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch musicgen-large --smoke --device cpu

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --smoke --device cpu --ep

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-11b --smoke --device cpu

Counterpart of ``repro.launch.serve``.  As the reference does, the driver
first fetches the plan of its serving shape (:func:`fetch_plan`): the
shape is quantized onto a bucket and looked up in the persistent plan
cache (``--plan-cache``, default ``$REPRO_PLAN_CACHE``; unset, nothing
persists); a miss runs the port's HIDA compiler (``repro_torch.core``),
warm-started from the nearest cached plan of the same config where there
is one.  The cache's files are the reference's, so a plan that either
package cached is a hit for the other.  The plan is linted
(``analyze_plan``) and the LM built under it; its constraints are the
identity on the plain tensors the server holds (``ShardingPlan.constrain``
redistributes only DTensors).  ``--no-plan`` skips the fetch.  By
default the model runs with ``use_kernels=True``: the RMSNorm kernel at
every norm site of every decode step, and the grouped-matmul kernel in
every MoE FFN.  ``--plain`` builds it with ``use_kernels=False``, the
reference's serving path (``repro.launch.serve`` serves without its
kernels), which ``chip_smoke.py`` holds the kernel path's greedy tokens
to on the card.
The continuous batcher prefills each admission group's prompts in one
full-sequence pass that writes their k/v into the slots' caches, its
attention on the flash-attention kernel, where every layer is GQA
self-attention over tokens (``LM.fills_caches``: smollm, stablelm,
h2o-danube); other stacks, and ``run_static`` always, prefill as decode
steps, so attention reads the KV cache and the mLSTM and Mamba run their
step forms there; the flash-attention, mLSTM chunkwise and
selective-scan kernels serve ``LM.prefill``.  The continuous summary
prints the share of groups the one-pass prefill took; both summaries
print the share of tokens chosen on the device (greedy rows on the
card).
``--device cpu`` runs the same path on the CPU with the kernels' plain
versions.

Both serving paths step through ``launch/graphs.py``: on the card each
decode step and each prefill side step replays a CUDA graph, captured on
its first use (the counterpart of the reference's jit compiles); on the
CPU the same steps run directly.  ``--warmup`` passes build the graphs,
so the reported tok/s excludes capture, as the reference's excludes
compiles; the graphs captured and their capture seconds are printed
beside the results.

The request trace comes from its own numpy stream; the parameters from a
``torch.Generator`` seeded with ``--seed``; sampling draws, and the
audio frames and images of the musicgen and llama-vision frontends, are
keyed per (request, position) inside the scheduler.  MoE configs (jamba,
deepseek-v2 and deepseek-v3) are served on the static path only, as in
the reference: expert capacity couples the rows of a batch, so the
batcher refuses them.  None of the three fits on one 80 GB card at full
depth (jamba-v0.1-52b's 32 layers are 103 GB of bf16 weights); this
entry point, like the reference's, has no depth option, and
``chip_smoke.py`` runs jamba at 16 layers, deepseek-v2 at 7 and
deepseek-v3 at 5.

``--ep`` serves an MoE model expert-parallel over the process group's
ranks (under ``torchrun``; one rank of its own without it): a
``("experts",)`` mesh of the world (``launch/mesh.expert_mesh``), each
rank holding ``E / world`` experts of every MoE layer
(``moe.ExpertShare``) and everything else whole, and serving its own
requests on the static path, attention data-parallel.  Every MoE layer
of every step, the decode step's included, exchanges its tokens with
the other ranks (``moe.moe_ffn_serve_ep``), so all ranks step together:
each serves the same lengths in the same waves (its own prompt tokens,
from ``--seed`` and its rank), and so takes the same steps.  The
replicated weights come from ``--seed``, each rank's experts from
``--seed`` and its rank (``LM.init``).  Each rank prints the tokens of
all ranks over its own time.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, list_archs
from ..configs.base import ShapeSpec
from ..core import (SINGLE_POD, MeshSpec, PlanCache, PlanKey, analyze_plan,
                    build_lm_graph, fetch_or_optimize, shape_bucket)
from ..models.lm import LM
from . import graphs
from .mesh import expert_mesh, expert_share
from .scheduler import ContinuousBatcher, Request, prefill_bucket, run_static


def fetch_plan(cfg, *, slots: int, s_max: int,
               cache_root: str | os.PathLike | None,
               mesh: MeshSpec = SINGLE_POD,
               cache: PlanCache | None = None,
               optimize_kwargs: dict | None = None):
    """Serving-side compile: cache hit → warm re-DSE → cold DSE.

    Returns ``(plan, info)`` where ``info`` has the fetch ``source``
    (``hit``/``warm``/``cold``), wall ``fetch_ms``, the bucket, and the
    ``OptimizeReport`` when a DSE ran."""
    cache = cache if cache is not None else PlanCache(cache_root)
    bucket = shape_bucket("decode", s_max, slots)
    key = PlanKey.make(cfg, mesh, bucket)
    shape = ShapeSpec(bucket, s_max, slots, "decode")
    t0 = time.perf_counter()
    plan, source, report = fetch_or_optimize(
        cache, key, mesh, lambda: build_lm_graph(cfg, shape),
        optimize_kwargs=optimize_kwargs)
    return plan, {"source": source, "fetch_ms": (time.perf_counter() - t0)
                  * 1e3, "bucket": bucket, "report": report,
                  "cache_stats": dict(cache.stats)}


def make_trace(cfg, n_requests: int, *, seed: int,
               prompt_len_range=(4, 48), gen_range=(16, 64),
               temperature: float = 0.0) -> list[dict]:
    """Deterministic mixed-length request trace (the reference's: the same
    numpy stream draws the same shapes and prompt tokens; the audio-frames
    frontend gets ``prompt=None`` and no draw)."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len_range
    glo, ghi = gen_range
    out = []
    for _ in range(n_requests):
        pl = int(rng.integers(lo, hi + 1))
        gen = int(rng.integers(glo, ghi + 1))
        prompt = (None if cfg.frontend == "audio_frames"
                  else rng.integers(0, cfg.vocab, pl).astype(np.int32))
        out.append({"prompt": prompt, "prompt_len": pl, "max_new": gen,
                    "temperature": temperature})
    return out


def _own_prompts(trace: list[dict], vocab: int, seed: int,
                 rank: int) -> None:
    """Expert-parallel serving: this rank's prompts' tokens from its own
    stream, the lengths left as every rank has them."""
    rng = np.random.default_rng([seed, rank])
    for t in trace:
        if t["prompt"] is not None:
            t["prompt"] = rng.integers(0, vocab,
                                       t["prompt_len"]).astype(np.int32)


def _all_ranks(n: int, device) -> int:
    """``n`` summed over the process group's ranks."""
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t)
    return int(t.item())


def _static_requests(trace: list[dict]) -> list[Request]:
    now = time.perf_counter()
    return [Request(rid=i, prompt_len=t["prompt_len"],
                    max_new=t["max_new"], prompt=t["prompt"],
                    temperature=t["temperature"], t_submit=now)
            for i, t in enumerate(trace)]


def _admission(rep) -> str:
    """The batcher's admission phases: the share of groups the one-pass
    prefill took, the ms of a pass and of a side step, the stall share."""
    groups = rep.spans.get("serve.install", (0, 0.0))[0]
    if not groups:
        return ""
    passes = rep.spans.get("serve.prefill", (0, 0.0))[0]
    out = f"; prefill pass on {passes / groups:.2f} of {groups} groups"
    if passes:
        out += f" ({rep.ms_per('serve.prefill'):.3f} ms a pass)"
    if "serve.side_steps" in rep.spans:
        out += f", side step {rep.ms_per('serve.side_steps'):.3f} ms"
    return out + f", stall share {100 * rep.stall_share:.1f}%"


def _summary(rep) -> str:
    d = rep.to_dict()
    chosen = rep.device_tokens + rep.host_tokens
    return (f"{rep.generated} tokens / {len(rep.requests)} requests in "
            f"{rep.wall_s:.2f}s ({d['tok_per_s']:.0f} tok/s, occupancy "
            f"{rep.occupancy:.2f}, p50 {d['latency_p50_s'] * 1e3:.0f} ms, "
            f"p99 {d['latency_p99_s'] * 1e3:.0f} ms; "
            f"{100 * rep.device_tokens / max(1, chosen):.1f}% of "
            "tokens chosen on the device)\n"
            f"[serve]   a step: launch {rep.ms_per('serve.launch'):.3f} ms, "
            f"logits {rep.ms_per('serve.logits'):.3f} ms, sample "
            f"{rep.ms_per('serve.sample'):.3f} ms" + _admission(rep))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (concurrent requests)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len-range", type=int, nargs=2,
                    default=(4, 48), metavar=("LO", "HI"))
    ap.add_argument("--gen-range", type=int, nargs=2, default=(16, 64),
                    metavar=("LO", "HI"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--static", action="store_true",
                    help="also run the lock-step wave baseline")
    ap.add_argument("--warmup", type=int, default=0,
                    help="un-timed passes over the trace first, so the "
                    "reported numbers are steady-state")
    ap.add_argument("--plan-cache", default=os.environ.get(
        "REPRO_PLAN_CACHE"), help="plan cache root dir "
        "(default: $REPRO_PLAN_CACHE; unset = no persistence)")
    ap.add_argument("--no-plan", action="store_true",
                    help="skip the DSE/plan fetch entirely")
    ap.add_argument("--plain", action="store_true",
                    help="serve on the plain PyTorch path, the reference's "
                    "(no hand-written kernels)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--ep", action="store_true",
                    help="serve an MoE model with its experts split over "
                    "the ranks of the process group (static path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    pl_lo, pl_hi = args.prompt_len_range
    g_lo, g_hi = args.gen_range
    s_max = prefill_bucket(pl_hi, 16) + g_hi

    plan, plan_info = (None, {"source": "skipped", "fetch_ms": 0.0}) \
        if args.no_plan else fetch_plan(
            cfg, slots=args.slots, s_max=s_max,
            cache_root=args.plan_cache)
    if plan is None:
        print("[serve] plan: skipped (--no-plan)")
    else:
        print(f"[serve] plan: {plan_info['source']} in "
              f"{plan_info['fetch_ms']:.1f} ms "
              f"(bucket {plan_info['bucket']})")
        # a cache hit skips the DSE and its exit analysis: lint the plan
        # here, informational as in the reference
        lint = analyze_plan(plan, SINGLE_POD)
        plan_info["lint"] = {"ok": lint.ok,
                             "issues": [str(i) for i in lint.issues]}
        print(f"[serve] lint: {lint.summary()}")
    share = expert_share(expert_mesh(args.device)) if args.ep else None
    lm = LM(cfg, use_kernels=not args.plain, device=args.device, plan=plan,
            experts=share)
    params, _ = lm.init(args.seed)
    trace = make_trace(cfg, args.requests, seed=args.seed,
                       prompt_len_range=(pl_lo, pl_hi),
                       gen_range=(g_lo, g_hi),
                       temperature=args.temperature)
    if share is not None:
        _own_prompts(trace, cfg.vocab, args.seed, share.rank)

    before = graphs.stats()
    is_moe = any(ffn == "moe" for _, ffn in cfg.layer_kinds())
    metrics: dict = {"arch": args.arch, "device": str(lm.device),
                     "use_kernels": lm.use_kernels,
                     "plan": {k: v for k, v in plan_info.items()
                              if k != "report"}}
    if args.ep and not is_moe:
        raise SystemExit(f"--ep: {args.arch} has no MoE layers")
    if is_moe:
        print(f"[serve] {args.arch} has MoE layers: static path only "
              "(expert capacity couples batch rows)"
              + (f"; experts split over {share.size} ranks, this rank "
                 f"{share.rank}" if share is not None else ""))
    else:
        def run_once():
            b = ContinuousBatcher(lm, params, slots=args.slots,
                                  s_max=s_max, seed=args.seed,
                                  eos_id=args.eos_id)
            for t in trace:
                b.submit(t["prompt"], t["max_new"],
                         prompt_len=t["prompt_len"],
                         temperature=t["temperature"])
            return b.run()

        for _ in range(args.warmup):
            run_once()
        rep = run_once()
        metrics["continuous"] = rep.to_dict()
        print(f"[serve] continuous: {_summary(rep)}")

    if args.static or is_moe:
        for _ in range(args.warmup):
            run_static(lm, params, _static_requests(trace),
                       seed=args.seed, s_max=s_max, slots=args.slots,
                       eos_id=args.eos_id)
        srep = run_static(lm, params, _static_requests(trace),
                          seed=args.seed, s_max=s_max, slots=args.slots,
                          eos_id=args.eos_id)
        if share is not None:
            srep.generated = _all_ranks(srep.generated, lm.device)
        metrics["static"] = srep.to_dict()
        print(f"[serve] static:     {_summary(srep)}")
        if "continuous" in metrics:
            ratio = (metrics["continuous"]["tok_per_s"]
                     / max(metrics["static"]["tok_per_s"], 1e-9))
            metrics["continuous_vs_static"] = ratio
            print(f"[serve] continuous/static throughput: {ratio:.2f}x")
    after = graphs.stats()
    metrics["graphs"] = {k: after[k] - before[k] for k in after}
    print(f"[serve] graphs: {metrics['graphs']['graphs']} captured in "
          f"{metrics['graphs']['capture_s']:.2f} s"
          + (" (during the warm-up passes)" if args.warmup else ""))
    return metrics


if __name__ == "__main__":
    main()
