"""What every cell shares: finding a cell's files by name, the weights
from the seed, the run record the metric readers read, the profiler
window, and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix.  The configuration's file holds the published sizes and,
under ``arch``, the port's ``ArchConfig`` fields as run.  The traffic
mix is ``cardbench/traffic/<traffic>.json``, whose ``driver`` names the
module of ``cardbench/drivers`` that runs it with the file's parameters.
A cell's comparison limits are ``cardbench/cells/<cell>.json``.  A
per-layer metric is ``cardbench/metrics/<metric>.py``, whose ``read(run)``
returns the number or ``None`` where the run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cardbench.reference.model import block_kind

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: where the harness writes traces (ignored by git)
OUT = ROOT / "build" / "cardbench"
#: top-level module names no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


# --------------------------------------------------------------------------
# files found by name
# --------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: dict | None = None) -> dict:
    """The cell's entry, its configuration's entry and file, its traffic
    file and its limits."""
    bench = bench or benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config_entry": conf,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "cells" / f"{name}.json")["limits"],
            "end_to_end": [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]}


def driver(name: str):
    return importlib.import_module(f"cardbench.drivers.{name}")


def metric_reader(name: str):
    """``cardbench/metrics/<name>.py`` as a module (names hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------------
# the configuration as the program takes it
# --------------------------------------------------------------------------

def arch_config(arch: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import (ArchConfig, MambaConfig, MLAConfig,
                                          MoEConfig, XLSTMConfig)
    kw = dict(arch)
    for key, cls in (("moe", MoEConfig), ("mamba", MambaConfig),
                     ("mla", MLAConfig), ("xlstm", XLSTMConfig)):
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    return ArchConfig(**kw)


# --------------------------------------------------------------------------
# weights from the seed
# --------------------------------------------------------------------------

_DT = {"bf16": torch.bfloat16, "f32": torch.float32}
_ALIGN = 64          # elements: every leaf starts 16-byte aligned or more


def make_params(specs: dict, seed: int, device) -> dict:
    """``{path: tensor}`` for ``specs`` (``reference.model.param_specs``),
    drawn on ``device`` from a generator seeded with ``seed``: one normal
    draw per dtype over all normal leaves in path order, each leaf a view
    of it scaled by its std; ones and zeros filled."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    for dname, dtype in _DT.items():
        normal = [p for p in sorted(specs) if specs[p][1] == dname
                  and specs[p][2] == "normal"]
        sizes = [math.prod(specs[p][0]) for p in normal]
        offs, n = [], 0
        for s in sizes:
            offs.append(n)
            n += -(-s // _ALIGN) * _ALIGN
        if n:
            flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
            for p, o, s in zip(normal, offs, sizes):
                out[p] = flat[o:o + s].view(specs[p][0]).mul_(specs[p][3])
    for p, (shape, dname, init, _std) in specs.items():
        if init in ("ones", "zeros"):
            out[p] = torch.full(shape, 1.0 if init == "ones" else 0.0,
                                dtype=_DT[dname], device=device)
    return out


def nest(flat: dict) -> dict:
    """The nested-dict tree of a flat ``{path: tensor}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, p + "/"))
        else:
            out[p] = v
    return out


def check_layout(cfg, flat: dict) -> None:
    """The weights hold every leaf the program's model has, at its shape
    and dtype, and nothing else."""
    from repro_torch.models.lm import LM
    want = flatten(LM(cfg, device="cpu").param_shapes())
    got = {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}
    need = {p: (tuple(t.shape), t.dtype) for p, t in want.items()}
    if got != need:
        diff = sorted(set(got.items()) ^ set(need.items()))[:8]
        raise ValueError(f"weights do not match the program's layout: {diff}")


def seed_mix(seed: int, *keys: int) -> int:
    """A 63-bit seed of (seed, keys), for the streams of one run."""
    z = seed & ((1 << 64) - 1)
    for k in keys:
        z = (z * 0x9E3779B97F4A7C15 + k + 0x632BE59BD9B4E019) \
            & ((1 << 64) - 1)
        z ^= z >> 31
    return z & ((1 << 63) - 1)


def length_set(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the midpoint quantiles ``(k + 0.5) / n`` of a
    lognormal with the spec's ``mean`` and ``sigma``, rounded and held
    to its ``clip`` range: every batch serves the same set of sizes."""
    sigma = spec["sigma"]
    mu = math.log(spec["mean"]) - sigma * sigma / 2
    lo, hi = spec["clip"]
    z = statistics.NormalDist()
    return [min(hi, max(lo, round(math.exp(
        mu + sigma * z.inv_cdf((k + 0.5) / n))))) for k in range(n)]


def lengths(prompt_len: dict, max_new: dict, n: int, i: int
            ) -> tuple[list, list]:
    """Batch ``i``'s prompt and output lengths: the ``length_set`` of
    each, paired in an order drawn from ``i`` alone, so that every seed
    serves the same work."""
    rng = np.random.default_rng(seed_mix(0x5EED, i))
    return ([int(v) for v in rng.permutation(length_set(prompt_len, n))],
            [int(v) for v in rng.permutation(length_set(max_new, n))])


def more(run: "Run", t0: float, done: int) -> bool:
    """Whether a window that began at ``t0`` and has finished ``done``
    units of work starts another: always a first, then until
    ``run.seconds`` have passed."""
    return done == 0 or time.perf_counter() - t0 < run.seconds


def quantile(vals: list[float], q: float) -> float:
    """The ``q`` quantile (0 < q < 1, a multiple of 0.01), Python's
    inclusive method."""
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[
        round(q * 100) - 1]


# --------------------------------------------------------------------------
# the run record
# --------------------------------------------------------------------------

@dataclass
class Run:
    """One run of a cell: its files, the program's objects while they
    live, what the window recorded, and the trace."""
    name: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    files: dict
    arch: dict = field(default_factory=dict)
    cfg: Any = None
    #: numbers the drivers record for the metrics
    rec: dict = field(default_factory=dict)
    #: the profiler window's reduction (``Tracer.reduce``)
    traced: dict | None = None
    #: device counters installed for a traced run (``counters``)
    counters: dict = field(default_factory=dict)
    tracer: Any = None
    #: the driver's own objects (the program's, while they live)
    state: dict = field(default_factory=dict)

    @property
    def traffic(self) -> dict:
        return self.files["traffic"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# --------------------------------------------------------------------------
# the profiler window
# --------------------------------------------------------------------------

#: symbols of the program's hand-written kernels, by wrapper (from the
#: CUDA sources); frozen here so that the benchmark's reduction does not
#: move with the program
KERNEL_SYMBOLS = {
    "rmsnorm": ("rmsnorm_kernel",),
    "flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
    "mlstm_chunk": ("mlstm_state_kernel", "mlstm_out_kernel"),
    "ssd_scan": ("ssd_scan_kernel",),
    "moe_gmm": ("gmm_bf16_wgmma_kernel", "gmm_bf16_decode_kernel",
                "gmm_zero_rows_kernel", "gmm_f32_kernel")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def device_category(name: str, cat: str) -> str:
    """A device operation's category.  Copies come before the elementwise
    kernels, since PyTorch's copy and cast kernels are elementwise
    templates (``direct_copy_kernel_cuda``)."""
    for kernel, symbols in KERNEL_SYMBOLS.items():
        if any(sym in name for sym in symbols):
            return kernel
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cublas")):
        return "cublas_gemm"
    if cat != "kernel" or "copy" in low or "cast" in low:
        return "copy_cast"
    if any(k in low for k in ("elementwise", "vectorized", "reduce")):
        return "elementwise_reduce"
    return "other"


def union_us(spans: list, lo: float, hi: float) -> float:
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


class Tracer:
    """``torch.profiler`` over ``seconds`` of a window: armed by
    ``start``, begun by the first ``tick`` ``after`` seconds later (the
    drivers tick at step boundaries; at once where ``after`` is 0),
    stopped by the first ``tick`` ``seconds`` after that or by ``stop``.
    The device counters of the run are read at both ends.  ``reduce``,
    after the window, exports the trace and returns its reduction:
    window and busy seconds, device time by operation and by category,
    the kernels' times, the counters' deltas and the longest idle gaps
    with what the host was doing."""

    LABEL = "cardbench_window"

    def __init__(self, run: Run, seconds: float, after: float = 0.0):
        self.run, self.seconds, self.after = run, seconds, after
        self.prof = self.done = None
        self.t_arm = self.t0 = 0.0
        self._ann = None

    def _counters(self) -> dict:
        return {k: v.tolist() for k, v in self.run.counters.items()}

    def start(self) -> None:
        self.t_arm = time.perf_counter()
        if self.after <= 0:
            self._begin()

    def _begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.run.sync()
        self.c0 = self._counters()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._ann = record_function(self.LABEL)
        self._ann.__enter__()
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        now = time.perf_counter()
        if self.prof is None and self.done is None and \
                now - self.t_arm >= self.after:
            self._begin()
        elif self.prof is not None and now - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        """Stops the profiler (the trace is reduced by ``reduce``, once
        the window has closed)."""
        if self.prof is None:
            return
        self.run.sync()
        self._ann.__exit__(None, None, None)
        self.prof.stop()
        self.c1 = self._counters()
        self.done, self.prof = self.prof, None

    def reduce(self) -> dict:
        if self.done is None:
            raise RuntimeError(f"the window closed before the trace began "
                               f"({self.after} s into it)")
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"trace_{self.run.name}.json"
        self.done.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X"]
        path.unlink()
        self.done = None
        result = reduce_trace(events, self.LABEL)
        result["counters"] = {
            k: [b - a for a, b in zip(self.c0[k], self.c1[k])]
            for k in self.c1}
        return result


def reduce_trace(events: list, label: str) -> dict:
    win = [e for e in events if e.get("name") == label
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"profiler trace: {len(win)} windows")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = union_us(spans, lo, hi)
    by_op: dict = {}
    by_cat: dict = {}
    kernels: dict = {k: 0.0 for k in KERNEL_SYMBOLS}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
        c = device_category(e["name"], e["cat"])
        by_cat[c] = by_cat.get(c, 0.0) + e["dur"] / 1e6
        if c in kernels:
            kernels[c] += e["dur"] / 1e6
    # idle gaps, each labelled by the innermost host event over its start
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("name") != label),
                  key=lambda h: h[0])
    gaps, end = [], lo
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for a, b in gaps:
        over = [h for h in host if h[0] <= a < h[1]]
        name = min(over, key=lambda h: h[1] - h[0])[2] if over else \
            "host between traced operations"
        idle.append([name[:120], (b - a) / 1e6])
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "device_s": sum(e["dur"] for e in dev) / 1e6,
            "device_ops": len(dev), "by_category_s": by_cat,
            "kernel_s": kernels,
            "top_ops": sorted(([n[:160], s] for n, s in by_op.items()),
                              key=lambda x: -x[1])[:10],
            "idle_gaps": idle}


# --------------------------------------------------------------------------
# device counters of a traced run
# --------------------------------------------------------------------------

class _Counted:
    """A kernel wrapper's stand-in that calls it, then ``count(args)``;
    its ``launches`` is the wrapper's own (the wrapper counts through
    its module's global name, which is this object while installed)."""

    def __init__(self, fn, count):
        self.fn, self.count = fn, count

    def __call__(self, *args, **kw):
        y = self.fn(*args, **kw)
        self.count(*args)
        return y

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


def count_kernel_work(run: Run) -> None:
    """Wrap the grouped-matmul kernel wrapper so that every call (graph
    replays included: the additions are captured with the call) adds its
    live experts, live rows and calls to counters on the device.
    Installed only in a traced run; ``uncount_kernel_work`` takes the
    wrapper off."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    arch = run.arch
    if not arch.get("moe"):
        return
    D, Fe = arch["d_model"], arch["moe"]["d_expert"]
    for d, f in ((D, 2 * Fe), (Fe, D)):
        run.counters[f"moe_gmm/{d}x{f}"] = torch.zeros(
            3, dtype=torch.int64, device=run.device)

    def gmm(x, w, group_sizes, *rest):
        acc = run.counters.get(f"moe_gmm/{x.shape[2]}x{w.shape[2]}")
        if acc is not None:
            gs = group_sizes.to(torch.int64)
            acc[0].add_((gs > 0).sum())
            acc[1].add_(gs.sum())
            acc[2].add_(1)

    run.rec["_uncount"] = gmm_ops.moe_gmm
    gmm_ops.moe_gmm = _Counted(gmm_ops.moe_gmm, gmm)


def uncount_kernel_work(run: Run) -> None:
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    saved = run.rec.pop("_uncount", None)
    if saved is not None:
        gmm_ops.moe_gmm = saved


# --------------------------------------------------------------------------
# the result line
# --------------------------------------------------------------------------

def device_info(run: Run, chips: int) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(out)


def env_dirs() -> None:
    """Every cache a run could write, inside the checkout at fixed
    paths."""
    base = ROOT / "build" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# --------------------------------------------------------------------------
# the serving step boundary
# --------------------------------------------------------------------------

class StepWatch:
    """Wraps ``launch/graphs.StepGraph.run``, the boundary between the
    scheduler and the model step, for the length of a window: it calls
    ``on_step(graph, kwargs)`` before each step (the drivers record the
    tokens a step is fed), ticks the run's tracer, and in a traced run
    counts the steps and the cache bytes each step needs (the attention
    rows at or before each live row's position, the Mamba states read
    and written)."""

    def __init__(self, run: Run, on_step=None):
        self.run, self.on_step = run, on_step
        a = run.arch
        kinds = [block_kind(a, i) for i in range(a["n_layers"])]
        Dh = a.get("head_dim") or a["d_model"] // a["n_heads"]
        self.kv_row = kinds.count("attn") * 2 * a["n_kv_heads"] * Dh * 2
        self.ssm_row = 0
        if a.get("mamba"):
            mb = a["mamba"]
            Din = mb["expand"] * a["d_model"]
            self.ssm_row = kinds.count("mamba") * (
                Din * mb["d_state"] * 4 * 2 + (mb["d_conv"] - 1) * Din * 2 * 2)

    def __enter__(self):
        from repro_torch.launch import graphs
        self.cls = graphs.StepGraph
        self.orig = orig = self.cls.run
        watch = self
        rec = self.run.rec
        rec.setdefault("step_runs", 0)
        rec.setdefault("cache_bytes", 0)

        def run(graph, *args, **kw):
            if watch.on_step is not None:
                watch.on_step(graph, kw)
            if watch.run.tracer is not None:
                watch.run.tracer.tick()
                rec["step_runs"] += 1
                rec["cache_bytes"] += watch.bytes_of(graph, kw)
            return orig(graph, *args, **kw)

        self.cls.run = run
        return self

    def bytes_of(self, graph, kw) -> int:
        """Cache bytes a step needs.  A side step's live rows sit on the
        device: it counts none (its share is left out, not guessed)."""
        import numpy as np
        pos, active = kw.get("pos", 0), kw.get("active")
        B = graph.pos.shape[0] if graph.pos.ndim else (
            graph.tokens.shape[0] if graph.tokens is not None
            else graph.frames.shape[0])
        if isinstance(pos, int) and active is None:
            return B * ((pos + 1) * self.kv_row + self.ssm_row)
        if isinstance(pos, np.ndarray) and isinstance(active, np.ndarray):
            live = active.astype(bool)
            return int(((pos[live].astype(np.int64) + 1) * self.kv_row
                        ).sum()) + int(live.sum()) * self.ssm_row
        return 0

    def __exit__(self, *exc):
        self.cls.run = self.orig
        return False

