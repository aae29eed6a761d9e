"""Continuous-batching request scheduler over ``LM.decode_step``.

Counterpart of ``repro.launch.scheduler``.  A fixed-width decode batch of
``slots`` rows steps every iteration, while a request queue feeds free
slots through a prefill of each group of requests of one power-of-two
bucket of the prompt length.  A slot is freed the moment its request
finishes (EOS or ``max_new``) and the next queued request is admitted
into it.

Correctness rests on the same three model-layer properties as the
reference: per-slot cache positions, ``active`` gating (an inactive
slot's caches come out bit-identical), and row independence (no MoE), so
the streamed tokens equal a per-request offline decode
(:func:`decode_offline`).

Prefill of a group of ``k`` same-bucket requests: where every layer is
GQA self-attention over tokens and the KV caches hold all ``s_max`` rows
(``LM.fills_caches``), one full-sequence pass over the prompts, padded on
the right, writes each prompt's k/v straight into its slot of the batch
cache (``LM.prefill_into``; its attention runs the flash kernel under
``use_kernels``).  Every other stack (recurrent state, audio frames,
cross-attention, a windowed cache shorter than ``s_max``) runs the
reference's form: a loop of gated ``decode_step``s (side steps) over a
fresh zero batch-``k`` cache, then a scatter of each filled row into its
slot.  The loop stops at the group's longest prompt: the reference scans
the whole bucket to bound its jit compiles, and the extra steps are
all-inactive no-ops.  On the card the pass's attention rounds otherwise
than the decode step's (the flash kernel keeps the scores in f32, where
the decode step rounds them to bf16, as the reference's does), so its
k/v equal the side steps' up to bf16 rounding, and greedy tokens may
part from theirs at a near tie; off the card the pass runs the plain
attention, which rounds as the decode step does.

Compiled steps (``graphs``, the default): as the reference jits its
decode step and its prefill side step, the batcher replays CUDA graphs
(``launch/graphs.py``): one of the slot batch, whose static caches are
the batch cache, and, for side steps, one per prefill group width ``k``,
over a static batch-``k`` cache zeroed before each group.  The one-pass
prefill runs eagerly (its shapes follow each group) and writes the slot
graph's static caches in place.  On the CPU the same
``StepGraph`` runs its step directly; ``graphs=False`` issues every
operation from Python (the eager path).  The graphs are memoised per
model and params, so batchers of one model share their caches: run one
at a time.

RNG: every sampling draw uses a ``torch.Generator`` seeded by a fixed
integer mix of ``(seed, request id, input position)``, so a request's
tokens do not depend on its co-tenants and the whole trace replays from
``seed``.  The draws are not JAX's: sampled tokens are held to this
package's own offline decode, greedy tokens to the reference's.

Tokens (:class:`_Tokens`, the one rule for every step's logits): on the
card a greedy row (temperature 0) takes the device's argmax, and only
the batch's token ids come to the host; a row that samples has its
logits row copied to the host and drawn there.  Off the card the logits
are in host memory already, and every row is drawn by ``_sample``, as
:func:`decode_offline` draws its one row.  ``ServeReport.device_tokens``
and ``host_tokens`` count the served tokens each way.

Spans (``launch/spans.py``): each decode step is a ``serve.step`` tiled
by three children, ``serve.launch`` (the inputs copied into the graph's
static buffers and the replay, or the eager step), ``serve.logits`` (the
host blocked until what it needs of the step is in host memory: the
token ids of the device's argmax, the logits rows that sample) and
``serve.sample`` (each row's token, positions, evictions).
The batcher's admission round is ``serve.admit``; inside it each group's
one-pass prefill is ``serve.prefill`` (range arguments ``rids`` and
``tokens``, the padded batch's k × S), or its replay loop
``serve.side_steps`` (counting its side steps), and its install
``serve.install`` (the scatter into the slot caches after side steps,
the first tokens' copy and their sampling): ``serve.prefill``'s count
over ``serve.install``'s is the share of groups the pass took.
``run_static``'s prompt steps, first logits and first tokens are
``serve.prompt``.  The report's
``prefill_s`` and ``decode_s`` are those spans' sums over the run:
``serve.admit`` (or ``serve.prompt``), and ``serve.launch`` +
``serve.logits`` in the batcher, ``serve.step`` on the static path
(sampling included).  ``Request.stall_s`` holds the admission time that
passed while the request was running, between its first token and its
last.

Frontends: an audio-frames request has no prompt (``prompt=None``); its
input at every position, prompt and generated alike, is a frame drawn for
(request, position), and a vision request carries one image drawn for the
request.  Both come from a :class:`Draws`, seeded as the sampling is;
the batcher, :func:`decode_offline` and :func:`run_static` take any
object with its two methods (``draws=``), so a test can hand in the
reference's own draws.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import spans
from .graphs import step_graph
from .spans import span

__all__ = ["Request", "ServeReport", "ContinuousBatcher", "decode_offline",
           "run_static", "prefill_bucket"]

_MASK64 = (1 << 64) - 1
#: the image draw's tag in place of a position (the reference's value)
_IMG_TAG = 0x494D47
BF16 = torch.bfloat16


def prefill_bucket(length: int, minimum: int = 16) -> int:
    """Smallest power-of-two ≥ ``length`` (floor ``minimum``)."""
    b = max(minimum, 1)
    while b < length:
        b *= 2
    return b


@dataclass
class Request:
    """One generation request plus its lifecycle bookkeeping."""
    rid: int
    prompt_len: int
    max_new: int
    #: prompt token ids, shape (prompt_len,); ``None`` for the
    #: audio-frames frontend (its frames come from the ``Draws``)
    prompt: np.ndarray | None = None
    temperature: float = 0.0
    #: generated token ids, in order.
    out: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    #: seconds of admission rounds between ``t_first`` and ``t_done``
    stall_s: float = 0.0
    finish: str = ""        # "eos" | "length" | "budget"

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class ServeReport:
    requests: list[Request] = field(default_factory=list)
    generated: int = 0
    steps: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    wall_s: float = 0.0
    occupancy: float = 0.0      # mean active-slot fraction per decode step
    slots: int = 0
    #: span name -> (count, seconds) over the run (``spans.since``)
    spans: dict = field(default_factory=dict)
    #: served tokens chosen by the device's argmax (greedy rows on the
    #: card), and drawn by ``_sample`` from logits rows in host memory
    device_tokens: int = 0
    host_tokens: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.generated / self.wall_s if self.wall_s else 0.0

    @property
    def decode_tok_per_s(self) -> float:
        return self.generated / self.decode_s if self.decode_s else 0.0

    @property
    def stall_share(self) -> float:
        """The share of the requests' time from first token to last that
        admission rounds held them."""
        run = sum(r.t_done - r.t_first for r in self.requests)
        return sum(r.stall_s for r in self.requests) / run if run else 0.0

    def ms_per(self, name: str) -> float:
        """Milliseconds a count of span ``name`` (0 where it never ran)."""
        n, s = self.spans.get(name, (0, 0.0))
        return 1e3 * s / n if n else 0.0

    def latency_percentiles(self) -> dict[str, float]:
        lats = sorted(r.latency_s for r in self.requests)
        if not lats:
            return {"p50": 0.0, "p99": 0.0}

        def pct(p: float) -> float:
            i = min(len(lats) - 1, int(round(p / 100 * (len(lats) - 1))))
            return lats[i]
        return {"p50": pct(50), "p99": pct(99)}

    def to_dict(self) -> dict:
        lat = self.latency_percentiles()
        return {"requests": len(self.requests),
                "generated": self.generated, "steps": self.steps,
                "tok_per_s": self.tok_per_s,
                "decode_tok_per_s": self.decode_tok_per_s,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "wall_s": self.wall_s, "occupancy": self.occupancy,
                "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
                "slots": self.slots, "stall_share": self.stall_share,
                "device_tokens": self.device_tokens,
                "host_tokens": self.host_tokens,
                "spans": {k: {"count": n, "s": s}
                          for k, (n, s) in self.spans.items()}}


def _draw_seed(seed: int, rid: int, pos: int) -> int:
    """Fixed 64-bit mix of (seed, rid, pos) (splitmix64 finaliser over a
    weighted sum): one independent stream per draw."""
    z = (seed * 0x9E3779B97F4A7C15 + rid * 0xBF58476D1CE4E5B9
         + pos * 0x94D049BB133111EB + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _sample(logits_row: np.ndarray, seed: int, rid: int, pos: int,
            temperature: float) -> int:
    """Sampling rule shared by the batcher and the offline reference:
    greedy at temperature 0, else categorical keyed by the *input*
    position that produced these logits (drawn on the host)."""
    if temperature > 0:
        gen = torch.Generator().manual_seed(_draw_seed(seed, rid, pos))
        probs = torch.softmax(
            torch.as_tensor(logits_row, dtype=torch.float64) / temperature,
            dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))
    return int(np.argmax(logits_row, axis=-1))


class Draws:
    """The frontends' inputs of each request, as the reference's
    ``_frames_at`` and ``_image_of`` give them: the audio frame at each
    position and the image, standard normal, each from a
    ``torch.Generator`` seeded with ``_draw_seed(seed, rid, pos)`` (the
    image with ``_IMG_TAG`` for ``pos``), drawn on the host and rounded
    to bf16.  ``frames_at(rid, pos)`` is ``(1, d_model)``,
    ``image_of(rid)`` ``(n_img_tokens, d_model)``; a replacement may
    return numpy arrays too."""

    def __init__(self, seed: int, cfg):
        self.seed, self.cfg = seed, cfg

    def _normal(self, rid: int, pos: int, rows: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(_draw_seed(self.seed, rid, pos))
        return torch.randn((rows, self.cfg.d_model), generator=gen).to(BF16)

    def frames_at(self, rid: int, pos: int) -> torch.Tensor:
        return self._normal(rid, pos, 1)

    def image_of(self, rid: int) -> torch.Tensor:
        return self._normal(rid, _IMG_TAG, self.cfg.n_img_tokens)


def _bf16(x, device) -> torch.Tensor:
    """A draw (tensor or numpy array) as a bf16 tensor on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=BF16)


def _host_rows(logits: torch.Tensor) -> np.ndarray:
    """(B, 1, vocab) device logits → (B, vocab) f32 numpy (exact for bf16)."""
    return logits[:, -1].float().cpu().numpy()


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lives on the card, where its rows would have to be
    copied to host memory."""
    return t.is_cuda


class _Tokens:
    """Each row's next token from one step's last-position logits
    ``rows`` (B, vocab), row ``i`` at ``temperatures[i]`` (0 for greedy,
    and for a row that takes no token).

    On the card a greedy row takes the device's argmax, and only the (B,)
    ids come to the host: ``torch.argmax`` gives the first maximal index,
    as ``np.argmax`` does, and bf16 orders as its exact f32 does, so the
    id is ``_sample``'s.  Only the rows that sample come whole, for
    ``_sample`` to draw on the host: its per-draw ``torch.Generator``
    stream has no bit-equal device form.  Off the card the rows are in
    host memory already, and every row goes through ``_sample``.  The
    constructor waits for the step and copies (``serve.logits``);
    :meth:`take` chooses (``serve.sample``)."""

    def __init__(self, rows: torch.Tensor, temperatures, seed: int):
        self.temperatures, self.seed = list(temperatures), seed
        self.ids, self.host = None, {}
        if not _on_card(rows):
            self.host = dict(enumerate(rows.float().cpu().numpy()))
            return
        self.ids = rows.argmax(-1).tolist()
        sampled = [i for i, t in enumerate(self.temperatures) if t > 0]
        if sampled:
            self.host = dict(zip(sampled,
                                 rows[sampled].float().cpu().numpy()))

    def take(self, i: int, rid: int, pos: int,
             rep: ServeReport | None = None) -> int:
        """Row ``i``'s token, drawn as request ``rid``'s at input
        position ``pos``; ``rep``, where given, counts it as served."""
        row = self.host.get(i)
        if rep is not None:
            if row is None:
                rep.device_tokens += 1
            else:
                rep.host_tokens += 1
        if row is None:
            return self.ids[i]
        return _sample(row, self.seed, rid, pos, self.temperatures[i])


def _check_batchable(cfg) -> None:
    if any(ffn == "moe" for _, ffn in cfg.layer_kinds()):
        raise ValueError(
            "continuous batching requires row-independent compute; "
            f"{cfg.name} has MoE layers whose expert capacity couples "
            "slots through whole-batch token counts (serve MoE "
            "configs with the static path)")


class ContinuousBatcher:
    """Admit/evict scheduler around ``decode_step``.

    Args:
        lm: the model (``repro_torch.models.lm.LM``).
        params: its parameters.
        slots: decode batch width.
        s_max: cache capacity per slot; a request needs
            ``prompt_len + max_new <= s_max``.
        seed: root of every RNG stream (see module docstring).
        eos_id: token id that finishes a request early (``None``
            disables EOS detection — length-only termination).
        prefill_min: minimum prefill bucket (power-of-two grouping).
        graphs: ``None`` or ``True`` steps through ``StepGraph``s
            (captured CUDA graphs on CUDA, the direct form on the CPU);
            ``False`` runs the eager step.
        draws: the frontends' frames and images (:class:`Draws` of
            ``seed`` by default).
    """

    def __init__(self, lm, params, *, slots: int, s_max: int,
                 seed: int = 0, eos_id: int | None = None,
                 prefill_min: int = 16, graphs: bool | None = None,
                 draws=None):
        _check_batchable(lm.cfg)
        self.lm, self.params = lm, params
        self.cfg = lm.cfg
        self.device = lm.device
        self.slots, self.s_max, self.seed = slots, s_max, seed
        self.eos_id = eos_id
        self.prefill_min = prefill_min
        self.draws = draws or Draws(seed, lm.cfg)
        self.audio = lm.cfg.frontend == "audio_frames"
        #: admission fills a group's slots in one full-sequence pass
        #: (``LM.prefill_into``) where the model's caches allow it, else
        #: token by token through side steps
        self.one_pass = lm.fills_caches(s_max)

        self.graphs = graphs is not False
        self._slot_graph = None
        if self.graphs:
            self._slot_graph = step_graph(lm, params, slots, s_max, True,
                                          use="slots")
            self._slot_graph.reset()
            self.caches = self._slot_graph.caches
            #: each slot's image, kept on the device (the reference keeps
            #: it on the host in f32): the graph's own static input
            self.img = self._slot_graph.img_embeds
        else:
            self.caches = lm.init_caches(slots, s_max, vector_pos=True)
            self.img = (torch.zeros((slots, lm.cfg.n_img_tokens,
                                     lm.cfg.d_model), dtype=BF16,
                                    device=self.device)
                        if lm.cfg.frontend == "vision" else None)
        self.queue: deque[Request] = deque()
        self._next_rid = 0
        self.pos = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)
        self.tokens = np.zeros((slots, 1), np.int64)
        self.slot_req: list[Request | None] = [None] * slots
        #: the report of the run in progress (its token counts)
        self._rep: ServeReport | None = None

    # -- submission ------------------------------------------------------
    def submit(self, prompt: np.ndarray | None, max_new: int, *,
               prompt_len: int | None = None,
               temperature: float = 0.0) -> Request:
        """Queue a request.  The audio-frames frontend takes
        ``prompt=None`` and a ``prompt_len``: its inputs are drawn."""
        if prompt is not None:
            prompt = np.asarray(prompt, np.int64).reshape(-1)
            prompt_len = len(prompt)
        elif not self.audio:
            raise ValueError(f"{self.cfg.name} reads tokens: a prompt is "
                             "needed (only the audio-frames frontend draws "
                             "its inputs)")
        if prompt_len is None or prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len + max_new > self.s_max:
            raise ValueError(f"request needs {prompt_len + max_new} "
                             f"positions, cache holds {self.s_max}")
        req = Request(rid=self._next_rid, prompt_len=prompt_len,
                      max_new=max_new, prompt=prompt,
                      temperature=temperature,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        return req

    # -- admission -------------------------------------------------------
    def _admit_group(self, pairs: list[tuple[int, Request]]) -> None:
        """Prefill one same-bucket group of requests into its slots, in
        one pass where the model allows it (``one_pass``), else as side
        steps, then sample each request's first token."""
        rids = ",".join(str(r.rid) for _, r in pairs)
        slot_vec = torch.as_tensor([s for s, _ in pairs], device=self.device)
        if self.one_pass:
            last, filled = self._prefill(pairs, slot_vec, rids), None
        else:
            last, filled = self._side_steps(pairs, rids)
        with span("serve.install", rids=rids):
            if filled is not None:
                self._install(slot_vec, *filled)
            first = _Tokens(last, [r.temperature for _, r in pairs],
                            self.seed)
            t_first = time.perf_counter()
            for i, (slot, req) in enumerate(pairs):
                tok = first.take(i, req.rid, req.prompt_len - 1, self._rep)
                req.out.append(tok)
                req.t_first = t_first
                self.pos[slot] = req.prompt_len
                self.active[slot] = True
                self.tokens[slot, 0] = tok
                self.slot_req[slot] = req
                self._maybe_finish(slot, tok)

    def _prefill(self, pairs: list[tuple[int, Request]],
                 slot_vec: torch.Tensor, rids: str) -> torch.Tensor:
        """The group's prompts, padded on the right to the longest, in
        one full-sequence pass that writes their k/v into the slots'
        caches (``LM.prefill_into``); returns each request's logits at
        its last prompt position, (k, vocab)."""
        dev = self.device
        lengths = [r.prompt_len for _, r in pairs]
        toks = np.zeros((len(pairs), max(lengths)), np.int64)
        for i, (_slot, req) in enumerate(pairs):
            toks[i, :req.prompt_len] = req.prompt
        with span("serve.prefill", rids=rids, tokens=toks.size):
            return self.lm.prefill_into(
                self.params, torch.as_tensor(toks, device=dev),
                torch.as_tensor(lengths, device=dev), self.caches,
                slot_vec)[:, -1]

    def _side_steps(self, pairs: list[tuple[int, Request]], rids: str):
        """The group's prompts as gated decode steps over a fresh
        batch-``k`` cache, token by token; returns each request's logits
        at its last prompt position, and what ``_install`` takes: the
        filled batch-``k`` cache and the group's images (``None`` but for
        the vision frontend)."""
        lm, dev = self.lm, self.device
        k = len(pairs)
        lengths = np.array([r.prompt_len for _, r in pairs], np.int64)
        steps = int(lengths.max())
        # the inputs of every step, staged on the device once; each step
        # reads its row (frames past a prompt's end are zeros)
        if self.audio:
            xs = torch.zeros((steps, k, 1, self.cfg.d_model), dtype=BF16)
            for i, (_slot, req) in enumerate(pairs):
                for t in range(req.prompt_len):
                    xs[t, i] = torch.as_tensor(
                        self.draws.frames_at(req.rid, t))
        else:
            xs = torch.zeros((steps, k, 1), dtype=torch.int64)
            for i, (_slot, req) in enumerate(pairs):
                xs[:req.prompt_len, i, 0] = torch.as_tensor(req.prompt)
        xs = xs.to(dev)
        key = "frames" if self.audio else "tokens"
        img = (torch.stack([_bf16(self.draws.image_of(r.rid), dev)
                            for _, r in pairs])
               if self.img is not None else None)
        act = torch.as_tensor(np.arange(steps)[:, None] < lengths[None],
                              device=dev)
        if self.graphs:
            graph = step_graph(lm, self.params, k, self.s_max, True,
                               use="prefill")
            graph.reset()
            small = graph.caches
            if img is not None:
                graph.img_embeds.copy_(img)

            def step(t):
                return graph.run(pos=t, active=act[t], **{key: xs[t]})
        else:
            small = lm.init_caches(k, self.s_max, vector_pos=True)

            def step(t):
                nonlocal small
                batch = {key: xs[t],
                         "pos": torch.full((k,), t, dtype=torch.int32,
                                           device=dev),
                         "active": act[t]}
                if img is not None:
                    batch["img_embeds"] = img
                logits, small = lm.decode_step(self.params, batch, small)
                return logits
        # each request's logits at its last prompt position, in a buffer
        # of their own (a graph's logits are overwritten by its next run)
        last = None
        with span("serve.side_steps", n=steps, rids=rids):
            for t in range(steps):
                row = step(t)[:, -1]
                if t == 0:
                    last = row.clone()
                    continue
                for i in np.flatnonzero(lengths - 1 == t):
                    last[int(i)] = row[int(i)]
        return last, (small, img)

    def _install(self, slot_vec: torch.Tensor, small: dict, img) -> None:
        """Scatter every leaf of each block's batch-``k`` cache (KVCache,
        MLSTMState, SLSTMState) into the group's slots: the batch axis is
        0, or 1 inside a stacked group whose leading axis is layers."""
        for gi, (_pattern, repeats) in enumerate(self.lm._groups()):
            g = f"group{gi}"
            for b, big in self.caches[g].items():
                for dst, src in zip(big, small[g][b]):
                    if repeats > 1:
                        dst[:, slot_vec] = src
                    else:
                        dst[slot_vec] = src
        if img is not None:
            self.img[slot_vec] = img

    def _evict(self, slot: int, finish: str) -> None:
        req = self.slot_req[slot]
        req.finish = finish
        req.t_done = time.perf_counter()
        self.active[slot] = False
        self.slot_req[slot] = None

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        req = self.slot_req[slot]
        if self.eos_id is not None and tok == self.eos_id:
            self._evict(slot, "eos")
            return True
        if len(req.out) >= req.max_new:
            self._evict(slot, "length")
            return True
        return False

    # -- main loop -------------------------------------------------------
    def _frames(self) -> torch.Tensor:
        """(slots, 1, d_model): each active slot's frame at its position,
        zeros in the free slots (as the reference feeds them)."""
        out = torch.zeros((self.slots, 1, self.cfg.d_model), dtype=BF16)
        for slot in np.flatnonzero(self.active):
            out[slot] = torch.as_tensor(self.draws.frames_at(
                self.slot_req[slot].rid, int(self.pos[slot])))
        return out.to(self.device)

    def _inputs(self) -> dict:
        """This step's ``tokens``, or ``frames`` for the audio frontend."""
        if self.audio:
            return {"frames": self._frames()}
        return {"tokens": torch.as_tensor(self.tokens, device=self.device)}

    def _decode_batch(self) -> dict:
        dev = self.device
        batch = {"pos": torch.as_tensor(self.pos, device=dev),
                 "active": torch.as_tensor(self.active, device=dev),
                 **self._inputs()}
        if self.img is not None:
            batch["img_embeds"] = self.img
        return batch

    def run(self, max_steps: int | None = None) -> ServeReport:
        """Drain the queue: admit → step → sample/evict until every
        submitted request has finished.  Returns the serving report;
        per-request tokens live on the :class:`Request` objects."""
        rep = self._rep = ServeReport(slots=self.slots)
        before = spans.sums()
        occ_sum = 0.0
        t_start = time.perf_counter()
        budget = max_steps if max_steps is not None else (
            sum(r.max_new for r in self.queue) + len(self.queue) + 64)
        while self.queue or self.active.any():
            if self.queue and not self.active.all():
                self._admit(rep)
            live = int(self.active.sum())
            if not live:
                continue    # every admitted request finished at token 0
            # one decode step over the whole batch
            with span("serve.step", rows=live):
                with span("serve.launch"):
                    if self._slot_graph is not None:
                        logits = self._slot_graph.run(
                            pos=self.pos, active=self.active,
                            **self._inputs())
                    else:
                        logits, self.caches = self.lm.decode_step(
                            self.params, self._decode_batch(), self.caches)
                with span("serve.logits"):
                    picks = _Tokens(logits[:, -1],
                                    [0.0 if r is None else r.temperature
                                     for r in self.slot_req], self.seed)
                with span("serve.sample"):
                    rep.steps += 1
                    occ_sum += live / self.slots
                    for slot in range(self.slots):
                        if not self.active[slot]:
                            continue
                        req = self.slot_req[slot]
                        tok = picks.take(slot, req.rid, int(self.pos[slot]),
                                         rep)
                        req.out.append(tok)
                        self.pos[slot] += 1
                        self.tokens[slot, 0] = tok
                        self._maybe_finish(slot, tok)
            if rep.steps >= budget:
                for slot in range(self.slots):
                    if self.active[slot]:
                        self._evict(slot, "budget")
                break
        rep.wall_s = time.perf_counter() - t_start
        rep.generated = sum(len(r.out) for r in rep.requests)
        rep.occupancy = occ_sum / rep.steps if rep.steps else 0.0
        rep.spans = spans.since(before)
        rep.prefill_s = rep.spans.get("serve.admit", (0, 0.0))[1]
        rep.decode_s = sum(rep.spans.get(k, (0, 0.0))[1]
                           for k in ("serve.launch", "serve.logits"))
        return rep

    def _admit(self, rep: ServeReport) -> None:
        """One admission round: fill the free slots from the queue,
        grouped by prefill bucket so each group is one batched side step;
        then charge the round's time to every request it held running."""
        width = min(len(self.queue), int((~self.active).sum()))
        with span("serve.admit", width=width):
            t0 = time.perf_counter()
            groups: dict[int, list[tuple[int, Request]]] = {}
            for slot in range(self.slots):
                if not self.queue:
                    break
                if not self.active[slot]:
                    req = self.queue.popleft()
                    b = prefill_bucket(req.prompt_len, self.prefill_min)
                    groups.setdefault(b, []).append((slot, req))
                    rep.requests.append(req)
            for _b, pairs in sorted(groups.items()):
                self._admit_group(pairs)
            t1 = time.perf_counter()
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[slot]
                req.stall_s += t1 - max(t0, req.t_first)


# -- references ----------------------------------------------------------

def decode_offline(lm, params, req: Request, *, seed: int, s_max: int,
                   eos_id: int | None = None,
                   on_logits: Callable[[np.ndarray], None] | None = None,
                   draws=None) -> list[int]:
    """Single-request lock-step decode — the scheduler's oracle.

    A different code path from the batcher: scalar cache positions
    (contiguous writes instead of per-slot scatter), no padding, no
    gating, batch 1 throughout.  ``on_logits`` receives the f32 logits row
    each generated token was drawn from.  Like the reference's, it runs
    every config, MoE included: at batch 1 an expert's capacity (at least
    8 slots, capped at the one token) drops nothing.  ``draws`` as in
    :class:`ContinuousBatcher`."""
    dev = lm.device
    cfg = lm.cfg
    draws = draws or Draws(seed, cfg)
    caches = lm.init_caches(1, s_max)
    img = (_bf16(draws.image_of(req.rid), dev)[None]
           if cfg.frontend == "vision" else None)

    def step(t: int, tok: int) -> np.ndarray:
        nonlocal caches
        batch = {"pos": torch.tensor(t, dtype=torch.int32, device=dev)}
        if cfg.frontend == "audio_frames":
            batch["frames"] = _bf16(draws.frames_at(req.rid, t), dev)[None]
        else:
            batch["tokens"] = torch.tensor([[tok]], dtype=torch.int64,
                                           device=dev)
        if img is not None:
            batch["img_embeds"] = img
        logits, caches = lm.decode_step(params, batch, caches)
        return _host_rows(logits)[0]

    def draw(row: np.ndarray, t: int) -> int:
        if on_logits is not None:
            on_logits(row)
        return _sample(row, seed, req.rid, t, req.temperature)

    row = None
    for t in range(req.prompt_len):
        row = step(t, 0 if req.prompt is None else int(req.prompt[t]))
    out: list[int] = []
    tok = draw(row, req.prompt_len - 1)
    out.append(tok)
    t = req.prompt_len
    while len(out) < req.max_new and not (eos_id is not None
                                          and tok == eos_id):
        tok = draw(step(t, tok), t)
        out.append(tok)
        t += 1
    return out


def run_static(lm, params, requests: list[Request], *, seed: int,
               s_max: int, slots: int | None = None,
               eos_id: int | None = None,
               graphs: bool | None = None, draws=None) -> ServeReport:
    """The lock-step baseline at the same batch width: requests go in
    waves of ``slots`` rows in submission order, each wave's prompts
    padded to its longest, and every row decodes until the wave's largest
    ``max_new``.  The report counts only useful tokens (each request's
    own ``max_new``).  ``graphs`` and ``draws`` as in
    :class:`ContinuousBatcher`: one ``StepGraph`` per wave width, at a
    scalar position."""
    slots = slots or len(requests)
    rep = ServeReport(slots=slots)
    if not requests:
        return rep
    dev = lm.device
    cfg = lm.cfg
    draws = draws or Draws(seed, cfg)
    audio = cfg.frontend == "audio_frames"
    before = spans.sums()
    t_start = time.perf_counter()
    for w0 in range(0, len(requests), slots):
        wave = requests[w0:w0 + slots]
        B = len(wave)
        l_max = max(r.prompt_len for r in wave)
        g_max = max(r.max_new for r in wave)
        temps = [r.temperature for r in wave]
        prompts = np.zeros((B, l_max), np.int64)
        for i, r in enumerate(wave):
            if r.prompt is not None:
                prompts[i, :r.prompt_len] = r.prompt
        img = (torch.stack([_bf16(draws.image_of(r.rid), dev)
                            for r in wave])
               if cfg.frontend == "vision" else None)

        def inputs(t: int, toks) -> dict:
            """Step ``t``'s tokens, or every row's frame at ``t``."""
            if audio:
                return {"frames": torch.stack([
                    _bf16(draws.frames_at(r.rid, t), dev) for r in wave])}
            return {"tokens": torch.as_tensor(toks, device=dev)}

        if graphs is not False:
            graph = step_graph(lm, params, B, s_max, False)
            graph.reset()
            if img is not None:
                graph.img_embeds.copy_(img)

            def step(t: int, toks) -> torch.Tensor:
                return graph.run(pos=t, **inputs(t, toks))
        else:
            caches = lm.init_caches(B, s_max)

            def step(t: int, toks) -> torch.Tensor:
                nonlocal caches
                batch = {"pos": torch.tensor(t, dtype=torch.int32,
                                             device=dev), **inputs(t, toks)}
                if img is not None:
                    batch["img_embeds"] = img
                logits, caches = lm.decode_step(params, batch, caches)
                return logits

        with span("serve.prompt", width=B):
            # the prompts are staged on the device once; only the last
            # prompt step's logits give tokens
            prompts_t = torch.as_tensor(prompts, device=dev)
            for t in range(l_max):
                logits = step(t, prompts_t[:, t:t + 1])
            picks = _Tokens(logits[:, -1], temps, seed)
            toks = np.zeros((B, 1), np.int64)
            done = [False] * B
            for i, r in enumerate(wave):
                tok = picks.take(i, r.rid, l_max - 1, rep)
                r.out = [tok]
                toks[i, 0] = tok
                done[i] = eos_id is not None and tok == eos_id
        for n in range(1, g_max):
            with span("serve.step", rows=B):
                with span("serve.launch"):
                    logits = step(l_max + n - 1, toks)
                with span("serve.logits"):
                    picks = _Tokens(logits[:, -1], temps, seed)
                with span("serve.sample"):
                    rep.steps += 1
                    for i, r in enumerate(wave):
                        served = not done[i] and len(r.out) < r.max_new
                        tok = picks.take(i, r.rid, l_max + n - 1,
                                         rep if served else None)
                        if served:
                            r.out.append(tok)
                            done[i] = eos_id is not None and tok == eos_id
                        toks[i, 0] = tok
        for r in wave:
            r.t_first = r.t_first or time.perf_counter()
            r.t_done = time.perf_counter()   # wave finishes together
            r.finish = "length"
            rep.requests.append(r)
        rep.occupancy += sum(r.max_new for r in wave)
    rep.wall_s = time.perf_counter() - t_start
    rep.generated = sum(len(r.out) for r in rep.requests)
    rep.occupancy = (rep.occupancy
                     / max(1, (rep.steps + 1) * slots))
    rep.spans = spans.since(before)
    rep.prefill_s = rep.spans.get("serve.prompt", (0, 0.0))[1]
    rep.decode_s = rep.spans.get("serve.step", (0, 0.0))[1]
    return rep
