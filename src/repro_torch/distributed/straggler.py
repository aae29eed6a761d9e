"""Straggler detection & mitigation policy.

The port's own copy of ``repro.distributed.straggler`` (plain Python):
the same timings give the same actions and shard weights.

On a 1000+ node fleet, a single slow host gates every synchronous
collective.  The monitor keeps a per-host EMA of step times, flags hosts
slower than ``threshold`` × the fleet median, and recommends actions the
trainer applies:

* ``rebalance``  — shift part of the loader shard range away from the
  straggler (works because the loader is keyed by (step, shard)),
* ``checkpoint_and_evict`` — persistent stragglers trigger an early
  checkpoint so the scheduler can replace the host and the job restarts
  elastically (see elastic.py).

The container has one host; tests drive the policy with synthetic
timings — the decision logic is exactly what a fleet deployment uses.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    n_hosts: int
    ema: float = 0.9
    threshold: float = 1.5       # × median ⇒ straggler
    evict_after: int = 20        # consecutive flagged steps
    _ema_s: dict[int, float] = field(default_factory=dict)
    _flagged: dict[int, int] = field(default_factory=dict)

    def record(self, host_times_s: dict[int, float]) -> None:
        for h, t in host_times_s.items():
            prev = self._ema_s.get(h, t)
            self._ema_s[h] = self.ema * prev + (1 - self.ema) * t

    def stragglers(self) -> list[int]:
        if len(self._ema_s) < 2:
            return []
        # median_low: on tiny fleets the plain median of [fast, slow]
        # averages the straggler into the baseline and masks it.
        med = statistics.median_low(sorted(self._ema_s.values()))
        return [h for h, t in self._ema_s.items()
                if t > self.threshold * med]

    def step(self, host_times_s: dict[int, float]) -> list[dict]:
        """Record one step; return mitigation actions."""
        self.record(host_times_s)
        actions = []
        current = set(self.stragglers())
        for h in list(self._flagged):
            if h not in current:
                del self._flagged[h]
        for h in current:
            self._flagged[h] = self._flagged.get(h, 0) + 1
            if self._flagged[h] == 1:
                med = statistics.median(self._ema_s.values())
                actions.append({
                    "action": "rebalance", "host": h,
                    "shed_fraction": min(
                        0.5, 1.0 - med / self._ema_s[h])})
            elif self._flagged[h] >= self.evict_after:
                actions.append({"action": "checkpoint_and_evict",
                                "host": h})
                self._flagged[h] = 1  # reset after recommending eviction
        return actions

    def shard_weights(self) -> dict[int, float]:
        """Relative loader share per host ∝ 1/EMA (slow hosts get less).

        Hosts with no timing sample yet are assumed fleet-median speed
        (not dropped — every host in ``range(n_hosts)`` gets a share),
        and EMAs are clamped away from zero so a degenerate 0-second
        sample cannot divide out the whole distribution."""
        if not self._ema_s:
            return {h: 1.0 / self.n_hosts for h in range(self.n_hosts)}
        eps = 1e-9
        med = max(statistics.median(self._ema_s.values()), eps)
        hosts = set(range(self.n_hosts)) | set(self._ema_s)
        inv = {h: 1.0 / max(self._ema_s.get(h, med), eps) for h in hosts}
        z = sum(inv.values())
        return {h: v / z for h, v in inv.items()}
