"""Data pipeline: deterministic synthetic corpus + host-sharded loader.

The port's own copy of ``repro.data.pipeline`` (numpy only): the same
``(seed, step, shard)`` gives the same tokens, bit for bit.

Design mirrors production loaders: each host deterministically owns a
disjoint shard of every global batch (keyed by ``(step, host_id)``), so
(a) restarts resume mid-stream bit-identically from the step index alone
(no loader checkpoint needed), (b) elastic rescaling re-partitions the
stream without duplicating or dropping samples, and (c) straggler
re-balancing can hand a slow host's shard range to another host.

The corpus is a seeded Zipf-ish token stream — markov-flavoured so the
LM loss actually decreases in the end-to-end example (pure uniform noise
would train to a flat ln(V)).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Iterator

import numpy as np


@dataclass
class SyntheticCorpus:
    vocab: int
    seed: int = 0
    zipf_a: float = 1.2

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def batch(self, step: int, shard: int, batch: int, seq: int
              ) -> dict[str, np.ndarray]:
        """One shard of the global batch at ``step`` (deterministic)."""
        rng = self._rng(step, shard)
        z = rng.zipf(self.zipf_a, size=(batch, seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        # Markov flavour: even positions partially predict the next token.
        tokens[:, 1::2] = (tokens[:, 0:-1:2] * 31 + 7) % self.vocab
        return {"tokens": tokens[:, :-1],
                "labels": np.ascontiguousarray(tokens[:, 1:])}


@dataclass
class ShardedLoader:
    """Host-local loader: yields this host's shard with background
    prefetch (double-buffered, like the TPU infeed)."""

    corpus: SyntheticCorpus
    global_batch: int
    seq: int
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        return self.corpus.batch(step, self.host_id, self.local_batch,
                                 self.seq)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = 0
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def reshard(self, n_hosts: int, host_id: int) -> "ShardedLoader":
        """Elastic re-partition: same global stream, new host layout."""
        return ShardedLoader(self.corpus, self.global_batch, self.seq,
                             n_hosts=n_hosts, host_id=host_id,
                             prefetch=self.prefetch)
