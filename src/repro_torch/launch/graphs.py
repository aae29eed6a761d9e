"""CUDA graphs of the serving steps and of the train step: the
counterpart of the reference's ``jax.jit`` of ``LM.decode_step``
(``_JIT_MEMO``, ``_jit_cache`` and ``_jitted_step`` in
``repro.launch.scheduler``), of its prefill side step (``_prefill_fn``, a
``lax.scan`` of gated decode steps), of the sLSTM's ``lax.scan``
(``models/xlstm.py``) and of the train step, jitted with params and
moments donated (``repro.launch.steps.build_train_step``).

A graph bakes in the address of every tensor it reads or writes.  So a
:class:`StepGraph` owns static inputs (``tokens`` (B, 1) int64, or
``frames`` (B, 1, d_model) bf16 for the audio-frames frontend;
``img_embeds`` (B, n_img_tokens, d_model) bf16 for the vision frontend;
``pos`` as a scalar or a (B,) vector, ``active`` (B,) bool), a static
cache tree from ``LM.init_caches`` and a static ``logits`` output.  Its step is
``LM.decode_step`` followed by a copy of every returned cache leaf that
is not the input leaf itself back into that input leaf, so each ``run``
advances the caches in place.  On CUDA the step is captured once and
replayed; on the CPU the same object runs the step directly against the
same static buffers, so the CPU tests exercise all of the in-place
bookkeeping.  On CUDA a capture that fails raises: nothing falls back to
the eager step.

:func:`step_graph` memoises per model, as the reference's ``_JIT_MEMO``
does, with a strong reference to the model and to the params, keyed on
(B, s_max, vector_pos, use) and the params' identity.  ``release`` drops
every memoised graph and its memory.

A :class:`TrainGraph` holds the whole train step (forward, remat
recompute, backward, gradient accumulation and the AdamW update) over
static batch buffers, a static ``lr_scale`` and static metrics; it reads
and writes the caller's params and moments where they lie, as AdamW
updates them in place.  ``launch/steps.build_train_step`` keeps one per
train step.

Launch counters: a kernel wrapper adds to its ``.launches`` when its
Python code runs, which under a graph is once, at capture, when nothing
runs on the card.  :class:`Graph` takes each counter's change over the
capture back out and adds it again at every replay, so ``.launches``
counts the launches the card ran (the warm-up's included).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.mlstm_chunk import ops as ml_ops
from ..kernels.moe_gmm import ops as gmm_ops
from ..kernels.rmsnorm import ops as rms_ops
from ..kernels.ssd_scan import ops as ssd_ops
from ..models import moe
from ..models.layers import BF16
from ..models.lm import _map_cache
from ..optim.adamw import tree_leaves

F32 = torch.float32

__all__ = ["Graph", "StepGraph", "TrainGraph", "copy_into", "step_graph",
           "memo", "release", "stats"]

#: the kernel wrappers whose ``.launches`` a replay adds to
COUNTED = (rms_ops.rmsnorm, fa_ops.flash_attention, ml_ops.mlstm_chunk,
           ssd_ops.ssd_scan, gmm_ops.moe_gmm)

#: graphs captured in this process, and the seconds their captures took
#: (warm-up included)
_STATS = {"graphs": 0, "capture_s": 0.0}


def stats() -> dict:
    """``{"graphs": n, "capture_s": s}`` over this process so far."""
    return dict(_STATS)


def _add_counts(deltas: list[int], sign: int) -> None:
    for fn, d in zip(COUNTED, deltas):
        fn.launches += sign * d


class Graph:
    """``body`` captured once in a CUDA graph, after ``warmup`` ran on a
    side stream (which builds and binds the kernels, creates cuBLAS's
    handle and warms the allocator, none of which a capture allows).
    ``body`` must read and write only tensors that outlive it, or that
    it hands out through its closure.  A failed capture raises."""

    def __init__(self, body: Callable[[], None], warmup: Callable[[], None],
                 device: torch.device):
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = [fn.launches for fn in COUNTED]
        try:
            with torch.cuda.graph(self.graph):
                body()
        finally:
            deltas = [fn.launches - b for fn, b in zip(COUNTED, before)]
            _add_counts(deltas, -1)
        self.deltas = deltas
        _STATS["graphs"] += 1
        _STATS["capture_s"] += time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.deltas, 1)


def _refuse_patched(lm) -> None:
    """A graph runs the Python of its step once, at capture: a replaced
    ``moe.router_topk`` would route every replay as it routed then."""
    if moe.router_topk is not moe.ROUTER_TOPK and any(
            ffn == "moe" for _, ffn in lm.cfg.layer_kinds()):
        raise RuntimeError(
            "moe.router_topk is replaced: a CUDA graph of an MoE model "
            "would replay the routing of its capture; run with "
            "graphs=False while it is")


def copy_into(old, new) -> None:
    """Copy every leaf of ``new`` that is not the very leaf of ``old``
    into that leaf of ``old`` (dicts, tuples, NamedTuples; ``None``
    kept)."""
    if isinstance(old, dict):
        for key in old:
            copy_into(old[key], new[key])
    elif isinstance(old, tuple):
        for o, n in zip(old, new):
            copy_into(o, n)
    elif old is not None and new is not old:
        old.copy_(new)


class StepGraph:
    """``LM.decode_step`` over static inputs, caches and logits, at batch
    ``B`` and cache capacity ``s_max``; ``vector_pos`` gives per-slot
    positions and an ``active`` input (``init_caches(vector_pos=True)``),
    else one scalar position for the batch.  Captured on CUDA, run
    directly on the CPU."""

    def __init__(self, lm, params, B: int, s_max: int, vector_pos: bool):
        self.lm, self.params = lm, params
        dev = lm.device
        cfg = lm.cfg
        self.caches = lm.init_caches(B, s_max, vector_pos=vector_pos)
        audio = cfg.frontend == "audio_frames"
        self.tokens = (None if audio else
                       torch.zeros((B, 1), dtype=torch.int64, device=dev))
        self.frames = (torch.zeros((B, 1, cfg.d_model), dtype=BF16,
                                   device=dev) if audio else None)
        self.img_embeds = (torch.zeros((B, cfg.n_img_tokens, cfg.d_model),
                                       dtype=BF16, device=dev)
                           if cfg.frontend == "vision" else None)
        self.pos = torch.zeros((B,) if vector_pos else (), dtype=torch.int32,
                               device=dev)
        self.active = (torch.ones(B, dtype=torch.bool, device=dev)
                       if vector_pos else None)
        self.logits = torch.zeros((B, 1, lm.cfg.vocab), dtype=BF16,
                                  device=dev)
        self.graph = None
        if dev.type == "cuda":
            _refuse_patched(lm)
            self.graph = Graph(self._step, self._warmup, dev)

    def _batch(self) -> dict:
        batch = {"tokens": self.tokens, "frames": self.frames,
                 "img_embeds": self.img_embeds, "pos": self.pos,
                 "active": self.active}
        return {k: v for k, v in batch.items() if v is not None}

    def _step(self) -> None:
        logits, new = self.lm.decode_step(self.params, self._batch(),
                                          self.caches)
        copy_into(self.caches, new)
        self.logits.copy_(logits)

    def _warmup(self) -> None:
        """The step on a copy of the caches, which it may write."""
        self.lm.decode_step(self.params, self._batch(),
                            _map_cache(torch.clone, self.caches))

    def run(self, tokens=None, pos=0, active=None, frames=None,
            img_embeds=None) -> torch.Tensor:
        """One step: ``tokens`` (B, 1) (or ``frames`` (B, 1, d_model)) and
        ``active`` (B,) as tensors or numpy arrays, ``pos`` as those or an
        int.  ``img_embeds``, if given, replaces the static image; else
        the step reads the one it holds.  Returns the static ``logits``
        (B, 1, vocab), which the next run overwrites."""
        for buf, given in ((self.tokens, tokens), (self.frames, frames),
                           (self.img_embeds, img_embeds)):
            if given is not None:
                buf.copy_(torch.as_tensor(given))
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(torch.as_tensor(pos))
        if self.active is not None:
            self.active.copy_(torch.as_tensor(active))
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
        return self.logits

    def reset(self) -> None:
        """Zero every cache leaf in place, as ``init_caches`` makes them."""
        _map_cache(torch.Tensor.zero_, self.caches)


def _state_leaves(params, opt_state) -> list:
    """The tensors a train step reads and writes in place: the params,
    the step counter and the moments."""
    return [*tree_leaves(params), opt_state.step, *tree_leaves(opt_state.mu),
            *tree_leaves(opt_state.nu)]


class TrainGraph:
    """The whole train step of ``step`` (a ``launch/steps.TrainStep``):
    ``step.grads`` (the forward, the remat recompute, the backward and the
    gradient accumulation), then ``step.opt.update`` with ``lr_scale``,
    over static batch buffers shaped and typed as ``batch`` (a batch on
    the device, as ``steps._to_device`` makes it), a static f32
    ``lr_scale`` and static metrics.  It reads and writes ``params`` and
    ``opt_state`` where they lie: AdamW updates params, moments and the
    step counter in place, the counterpart of the reference's donation.

    The warm-up runs the gradient pass only, so it leaves params, moments
    and step as they were, then returns the cached blocks it used to the
    card before the capture allocates the graph's own pool.  It sizes the
    static metrics from the metrics it returns.  Captured on CUDA, where
    a failed capture raises; on the CPU the warm-up and then the step run
    directly against the same static buffers."""

    def __init__(self, step, params, opt_state, batch: dict):
        self.step, self.params, self.opt_state = step, params, opt_state
        self.held = _state_leaves(params, opt_state)
        self.device = dev = step.lm.device
        self.batch = {k: torch.zeros_like(v) for k, v in batch.items()}
        self.lr_scale = torch.ones((), dtype=F32, device=dev)
        self.metrics = None
        self.graph = None
        if dev.type == "cuda":
            _refuse_patched(step.lm)
            self.graph = Graph(self._step, self._warmup, dev)
        else:
            self._warmup()

    def _warmup(self) -> None:
        metrics = self.step.grads(self.params, self.batch)[1]
        self.metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        del metrics
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _step(self) -> None:
        grads, metrics = self.step.grads(self.params, self.batch)
        self.step.opt.update(grads, self.opt_state, self.params,
                             lr_scale=self.lr_scale)
        for k, v in metrics.items():
            self.metrics[k].copy_(v)

    def run(self, params, opt_state, batch: dict, lr_scale=1.0):
        """One step on ``batch`` (numpy arrays or tensors, as the eager
        step takes them) at ``lr_scale`` (a float or a scalar tensor).
        ``params`` and ``opt_state`` must hold the very tensors the graph
        was built over; ``batch`` the keys and shapes it was built for.
        Returns (params, opt_state, metrics): the metrics are the static
        tensors, which the next run overwrites."""
        if len(held := _state_leaves(params, opt_state)) != len(self.held) \
                or any(a is not b for a, b in zip(held, self.held)):
            raise RuntimeError(
                "this train step's graph reads and writes the params and "
                "moments it was captured with; another tree needs another "
                "train step (or graphs=False)")
        if batch.keys() != self.batch.keys() or any(
                tuple(torch.as_tensor(v).shape) != tuple(self.batch[k].shape)
                for k, v in batch.items()):
            raise ValueError(
                "this train step's graph was captured for the batch "
                + str({k: tuple(v.shape) for k, v in self.batch.items()})
                + "; another shape needs another train step (or "
                "graphs=False)")
        for k, v in batch.items():
            self.batch[k].copy_(torch.as_tensor(v))
        self.lr_scale.copy_(torch.as_tensor(lr_scale, dtype=F32))
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
        return params, opt_state, self.metrics


#: id(model) → (model, {key: graph}), as the reference's ``_JIT_MEMO``;
#: the strong reference keeps a dead model's id from being reused
_MEMO: dict[int, tuple[object, dict]] = {}
#: graphs memoised on their own keys (the sLSTM's, on its weights'
#: addresses)
_CALLS: dict[tuple, object] = {}


def step_graph(lm, params, B: int, s_max: int, vector_pos: bool,
               use: str = "step") -> StepGraph:
    """The memoised :class:`StepGraph` of ``lm`` with ``params`` at
    (B, s_max, vector_pos); ``use`` keeps graphs of one shape apart whose
    caches must not be shared (the batcher's slot batch and its prefill
    group of the same width)."""
    if lm.device.type == "cuda":
        _refuse_patched(lm)
    ent = _MEMO.get(id(lm))
    if ent is None or ent[0] is not lm:
        ent = _MEMO[id(lm)] = (lm, {})
    key = (B, s_max, vector_pos, use, id(params))
    g = ent[1].get(key)
    if g is None:
        g = ent[1][key] = StepGraph(lm, params, B, s_max, vector_pos)
    return g


def memo(key: tuple, build: Callable[[], object]):
    """``build()``, memoised on ``key`` until :func:`release`."""
    g = _CALLS.get(key)
    if g is None:
        g = _CALLS[key] = build()
    return g


def release() -> None:
    """Drop every memoised graph, with its static buffers and its pool."""
    _MEMO.clear()
    _CALLS.clear()
