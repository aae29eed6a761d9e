"""Waves through the static serving path on several ranks at once, the
routed experts of every MoE layer split over them: expert-parallel
serving (``LM(experts=...)``: ``moe.moe_ffn_serve_ep`` exchanges each
MoE layer's tokens with an ``all_to_all`` in every step, the decode
step's included).  Attention, the shared experts, the dense layers, the
embedding and the head are whole on every rank, and each rank serves its
own waves (attention data-parallel).

Rank 0 is the harness's process (``cardbench/run.py``, on ``cuda:0``).
``setup`` starts ranks 1 to ``ranks - 1`` as processes of this module
(``python -m cardbench.drivers.serve_ep SPEC``) on ``cuda:1`` and up
(gloo ranks on the CPU where rank 0 runs there), which join rank 0's
process group at ``tcp://localhost`` with a timeout.  A worker exits
when rank 0's process is gone (it watches its parent); rank 0 ends its
process at once when a worker fails (it watches them), and kills them
when it exits.

Set-up on every rank: the process group and the ``("experts",)`` mesh,
the LM holding the rank's experts, its weights from the seed
(``reference/deepseek_v2.make_params``: one generator a leaf and layer,
and a leaf, layer and expert for the routed experts, so each rank draws
its share and the reference the whole layer), and the wave's CUDA graph,
the exchange captured in it; rank 0 also compiles the serving plan.
The window: before each wave rank 0 tells the others whether another
starts (until ``--seconds`` have passed; a wave that started is
finished), so every rank serves the same number of waves; wave ``i`` of
rank ``r`` serves the traffic's length set in an order fixed by
``(i, r)``, its prompts drawn from ``seed_mix(seed, r, i)``, greedily.
All ranks' waves take the same steps, which keeps the exchange in step.
The end-to-end rate is all ranks' useful tokens over rank 0's window.

The check recomputes one (rank, wave), drawn from the seed, whole with
the plain reference (``reference/deepseek_v2.py``; the rank's rows share
each step's expert capacity, and a rank's drops depend on its own rows
alone), and with the reference rounded to bfloat16 as a witness of what
the program's precision alone costs (``check``): the tokens each of its
decode steps was fed are recorded at the step boundary
(``harness.StepWatch``), and the sampled rank sends them to rank 0,
which computes the references alone after the others exit.

A traced run turns the program's exchange counters on
(``ExpertShare.count``): the kept (token, k) copies each rank sent each
rank's experts, and those it dropped, summed over the ranks at the end
of the window; and its profiler reduction adds the NCCL kernels' device
time.

Traffic parameters: ``serve_static``'s and ``ranks``.
"""
from __future__ import annotations

import atexit
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[2]
    for _p in (str(_ROOT / "src"), str(_ROOT)):
        if _p not in sys.path:
            sys.path.insert(0, _p)

from cardbench import harness as H  # noqa: E402
from cardbench.drivers import common  # noqa: E402
from cardbench.drivers.serve_static import s_max_of, wave_inputs  # noqa: E402
from cardbench.reference import deepseek_v2 as D2  # noqa: E402
from cardbench.reference.model import Precision  # noqa: E402

#: seconds a rank waits at the rendezvous and in any collective
TIMEOUT_S = 600


def held(rank: int, ranks: int, E: int) -> range:
    """The experts rank ``rank`` of ``ranks`` holds of a layer of ``E``."""
    n = E // ranks
    return range(rank * n, (rank + 1) * n)


def pick(seed: int, ranks: int, waves: int) -> tuple[int, int]:
    """The (rank, wave) the check recomputes."""
    rng = np.random.default_rng(H.seed_mix(seed, 2))
    return int(rng.integers(ranks)), int(rng.integers(waves))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Workers:
    """Ranks 1 to ``ranks - 1`` of a run, as processes of this module."""

    def __init__(self, run: H.Run, ranks: int):
        self.address = f"tcp://localhost:{_free_port()}"
        out = H.OUT
        out.mkdir(parents=True, exist_ok=True)
        self.procs = []
        self.running = True
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(H.ROOT / "src"), str(H.ROOT)]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for r in range(1, ranks):
            spec = out / f"serve_ep_{os.getpid()}_{r}.json"
            spec.write_text(json.dumps({
                "rank": r, "ranks": ranks, "address": self.address,
                "name": run.name, "seed": run.seed, "seconds": run.seconds,
                "trace": run.trace, "device": run.device.type,
                "files": run.files}))
            p = subprocess.Popen(
                [sys.executable, "-m", "cardbench.drivers.serve_ep",
                 str(spec)], cwd=H.ROOT, env=env, stdout=2)
            print(f"[serve_ep] rank {r}: pid {p.pid}", file=sys.stderr,
                  flush=True)
            self.procs.append(p)
        atexit.register(self.kill)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        """Ends this process when a worker fails while the run needs it:
        the others would wait in a collective until the timeout."""
        while self.running:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0) and self.running:
                    print(f"[serve_ep] rank {r} exited {rc}; ending the run",
                          file=sys.stderr, flush=True)
                    os._exit(1)
            time.sleep(0.5)

    def join(self, timeout: float = 120.0) -> None:
        """Waits for the workers to exit (they do after the window's last
        exchange); kills those that have not."""
        self.running = False
        t_end = time.perf_counter() + timeout
        for p in self.procs:
            try:
                p.wait(max(1.0, t_end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def kill(self) -> None:
        self.running = False
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _join(run: H.Run, rank: int, ranks: int, address: str) -> None:
    backend = "nccl" if run.device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=address, rank=rank,
                            world_size=ranks,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _build(run: H.Run, rank: int, plan) -> None:
    """The rank's LM, weights and wave graph."""
    from repro_torch.launch import graphs
    from repro_torch.launch.mesh import expert_mesh, expert_share
    from repro_torch.models.lm import LM
    tr = run.traffic
    share = expert_share(expert_mesh(run.device.type))
    if run.trace:
        # (read by this driver over the window: ``harness.Tracer`` reads
        # only the grouped matmul's three-number counters)
        share.count(run.device)
    lm = LM(run.cfg, use_kernels=True, device=run.device, plan=plan,
            experts=share)
    experts = held(rank, tr["ranks"], run.cfg.moe.n_experts)
    flat = D2.make_params(run.arch, run.seed, run.device, experts)
    want = {p: (tuple(t.shape), t.dtype)
            for p, t in H.flatten(lm.param_shapes()).items()}
    got = {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}
    if got != want:
        raise ValueError("weights do not match the program's layout: "
                         f"{sorted(set(got.items()) ^ set(want.items()))[:8]}")
    params = H.nest(flat)
    s_max = s_max_of(tr)
    g = graphs.step_graph(lm, params, tr["slots"], s_max, False)
    g.run(pos=0)
    g.reset()
    run.state.update(lm=lm, params=params, s_max=s_max, graph=g,
                     share=share, rank=rank)


def setup(run: H.Run) -> None:
    from repro_torch.launch.serve import fetch_plan
    ranks = run.traffic["ranks"]
    # the workers first: a failure below ends this process, and they go
    # with it
    workers = run.state["workers"] = Workers(run, ranks)
    _join(run, 0, ranks, workers.address)
    t0 = time.perf_counter()
    plan, _info = fetch_plan(run.cfg, slots=run.traffic["slots"],
                             s_max=s_max_of(run.traffic), cache_root=None)
    run.rec["compile_s"] = time.perf_counter() - t0
    if run.tracer is not None:
        run.tracer = _Tracer(run, run.tracer.seconds, run.tracer.after)
    _build(run, 0, plan)


def wave_requests(run: H.Run, rank: int, i: int) -> list:
    from repro_torch.launch.scheduler import Request
    tr = run.traffic
    n = tr["slots"]
    pl, mn = H.lengths(tr["prompt_len"], tr["max_new"], n,
                       i * tr["ranks"] + rank)
    rng = np.random.default_rng(H.seed_mix(run.seed, rank, i))
    now = time.perf_counter()
    return [Request(rid=j, prompt_len=int(p), max_new=int(m),
                    prompt=rng.integers(0, run.arch["vocab"], int(p)),
                    t_submit=now) for j, (p, m) in enumerate(zip(pl, mn))]


def _serve(run: H.Run) -> None:
    """The window on any rank: waves while rank 0 says so, then the
    window's sums and the sampled wave gathered on rank 0."""
    from repro_torch.launch.scheduler import run_static
    st, tr = run.state, run.traffic
    rank = st["rank"]
    fed: list = []
    l_max = [0]

    rec = run.rec
    rec.setdefault("cache_rows", 0)

    def on_step(graph, kw):
        if kw["pos"] >= l_max[0]:
            fed.append((kw["pos"], kw["tokens"][:, 0].clone()))
        if run.tracer is not None:
            # the latent rows the step's rows attend to (its cache reads)
            rec["cache_rows"] += tr["slots"] * (kw["pos"] + 1)

    share = st["share"]
    c0 = share.counters.clone() if share.counters is not None else None
    flag = torch.zeros(1, dtype=torch.int32, device=run.device)
    waves, reports, unit_s = [], [], []
    with H.StepWatch(run, on_step):
        if run.tracer is not None:
            run.tracer.start()
        t0 = time.perf_counter()
        while True:
            if rank == 0:
                flag.fill_(int(H.more(run, t0, len(waves))))
            dist.broadcast(flag, 0)
            if not int(flag.item()):
                break
            t1 = time.perf_counter()
            reqs = wave_requests(run, rank, len(waves))
            l_max[0] = max(r.prompt_len for r in reqs)
            fed.clear()
            reports.append(run_static(st["lm"], st["params"], reqs,
                                      seed=run.seed, s_max=st["s_max"],
                                      slots=tr["slots"]))
            waves.append((reqs, list(fed)))
            unit_s.append(time.perf_counter() - t1)
        run.sync()
        run.rec["window_s"] = time.perf_counter() - t0
    if run.tracer is not None:
        run.tracer.stop()
    run.rec["unit_s"] = unit_s
    common.serve_record(run, reports)
    sums = torch.tensor([rec["generated"], rec["attempted"], rec["failed"]],
                        dtype=torch.int64, device=run.device)
    dist.all_reduce(sums)
    if c0 is not None:
        counted = share.counters - c0
        dist.all_reduce(counted)
        rec["ep_received"] = counted[:share.size].tolist()
        rec["ep_dropped"] = int(counted[share.size])
    rec["generated_all"], rec["attempted"], rec["failed"] = sums.tolist()
    pr, pw = pick(run.seed, tr["ranks"], len(waves))
    mine = wave_inputs(*waves[pw]) if rank == pr else None
    got = [None] * tr["ranks"] if rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    if rank == 0:
        st["sampled"] = (pr, pw, got[pr])


def window(run: H.Run) -> None:
    _serve(run)


def end_to_end(run: H.Run) -> dict:
    return {"serve_tok_s": run.rec["generated_all"] / run.rec["window_s"]}


def _release_program(run: H.Run, keep=()) -> None:
    common.release(run, keep=keep)
    dist.destroy_process_group()


def release(run: H.Run) -> None:
    _release_program(run, keep=("workers", "sampled", "requests"))
    run.state.pop("workers").join()


def check(run: H.Run, readings: bool = False) -> dict:
    """The sampled (rank, wave) through the reference and through its
    witness, the reference with its products' operands rounded to
    bfloat16 (``D2.BF16``), their weights drawn once: the numbers of
    ``common.gap_stats`` for the served tokens and for the witness's
    first tokens at the same positions, and ``served_gap_excess``, the
    served tokens' mean gap less the witness's: what the program loses
    beyond the rounding of its own precision, which at this depth parts
    a bfloat16 model's logits from the float32 ones by half their size
    (PERF.md).  The cell's limits name some of them; with ``readings``,
    the control's (the reference in fp8) too."""
    pr, pw, (toks, at, served) = run.state["sampled"]
    dev = run.device
    t = torch.as_tensor(toks, device=dev)
    m = torch.as_tensor(at, device=dev)
    s = torch.as_tensor(served, device=dev).reshape(-1, 1)
    rows = m.nonzero()[:, 0].cpu()
    precs = [Precision.F32, D2.BF16] + ([Precision.FP8] if readings else [])
    with common.exact_f32():
        lgs = D2.forward_all([D2.DeepSeekV2Ref(run.arch, run.seed, dev, p)
                              for p in precs], t, "position", at=m)
        lg = lgs[0]
        best = lg.max(-1).values

        def gaps_of(tok):
            return (best - lg.gather(-1, tok)[:, 0]).cpu()
        gaps = {"": gaps_of(s),
                "witness.": gaps_of(lgs[1].argmax(-1)[:, None])}
        if readings:
            gaps["control."] = gaps_of(lgs[2].argmax(-1)[:, None])
        del lg, lgs
    got = {}
    for prefix, g in gaps.items():
        got.update(common.gap_stats(g, rows, prefix))
        if prefix != "witness.":
            got[f"{prefix}served_gap_excess"] = float(
                g.float().mean() - gaps["witness."].float().mean())
    lim = run.files["limits"]
    return {"checks": [(k, got[k], lim[k]) for k in lim],
            "compared": len(gaps[""]), "sampled": [pr, pw],
            "readings": dict(got, sampled=[pr, pw])}


class _Tracer(H.Tracer):
    """The harness's profiler window, whose reduction also gives the
    device time of the NCCL kernels in it (``nccl_s``)."""

    def reduce(self) -> dict:
        if self.done is None:
            raise RuntimeError(f"the window closed before the trace began "
                               f"({self.after} s into it)")
        H.OUT.mkdir(parents=True, exist_ok=True)
        path = H.OUT / f"trace_{self.run.name}.json"
        self.done.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X"]
        path.unlink()
        self.done = None
        result = H.reduce_trace(events, self.LABEL)
        win = next(e for e in events if e.get("name") == self.LABEL
                   and e.get("cat") == "user_annotation")
        lo, hi = win["ts"], win["ts"] + win["dur"]
        result["nccl_s"] = sum(
            e["dur"] for e in events if e.get("cat") == "kernel"
            and "nccl" in e.get("name", "").lower()
            and lo <= e["ts"] < hi) / 1e6
        result["counters"] = {
            k: [b - a for a, b in zip(self.c0[k], self.c1[k])]
            for k in self.c1}
        return result


# --------------------------------------------------------------------------
# a worker: ranks 1 and up
# --------------------------------------------------------------------------

def _watch_parent() -> None:
    parent = os.getppid()
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def worker(spec_path: str) -> int:
    threading.Thread(target=_watch_parent, daemon=True).start()
    spec = json.loads(Path(spec_path).read_text())
    Path(spec_path).unlink()
    H.env_dirs()
    rank = spec["rank"]
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    run = H.Run(name=spec["name"], seed=spec["seed"],
                seconds=spec["seconds"], trace=spec["trace"], device=device,
                files=spec["files"])
    run.arch = run.files["config"]["arch"]
    run.cfg = H.arch_config(run.arch)
    _join(run, rank, spec["ranks"], spec["address"])
    _build(run, rank, None)
    _serve(run)
    _release_program(run)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1]))
