"""Deterministic fault injection for the compile pipeline.

The degradation ladder in :func:`repro_torch.core.optimize.optimize` claims
that *any* failure inside a structural pass, the DSE, or plan
projection degrades to a verifier-clean plan instead of an exception.
That claim is only testable if failures can be manufactured on demand,
deterministically, at the exact boundaries the ladder defends.  This
module provides the harness:

* Every pass exposes named **injection sites** — cheap
  :func:`fault_point` calls at the top of each rewrite step
  (``"fusion.pattern"``, ``"mp.merge"``, …), plus
  :func:`corrupt_value` hooks where a *wrong number* is more damaging
  than an exception (DSE proposal scoring).
* :func:`inject_faults` activates a seeded :class:`FaultInjector` for
  the dynamic extent of a ``with`` block.  Each site visit draws from
  one ``random.Random(seed)`` stream in call order, so a fixed
  ``(seed, rate, sites)`` configuration reproduces the exact same
  failure pattern on every run — chaos tests are regular regression
  tests, not flaky ones.
* When no injector is active every hook is a single global-load +
  ``is None`` check, and **zero** RNG draws happen — the zero-fault
  path is bit-identical to a build without the harness (the golden
  tests in ``tests/test_faults.py`` pin this).

Registered sites (kept in sync with docs/ARCHITECTURE.md):

===================  =====================================================
site                 location
===================  =====================================================
``construct.wrap``   per dispatch-region wrap in ``construct_functional``
``fusion.pattern``   per pattern-phase fuse in ``fuse_tasks``
``fusion.balance``   per balance-phase fuse in ``fuse_tasks``
``lower.node``       per task lowered in ``lower_to_structural``
``mp.duplicate``     per internal-duplication rewrite in multi-producer
``mp.merge``         per producer-merge rewrite in multi-producer
``balance.edge``     per skewed edge rewritten in ``balance_paths``
``dse.node``         per per-node DSE in ``parallelize``
``dse.score``        proposal scoring (corruption site: perturbs QoR)
``dse.joint``        per joint beam move in ``parallelize``
``dse.inner``        per region inner search in the hierarchical DSE
``dse.outer``        outer composition entry + per combo swap move
``plan.build``       ``build_plan`` entry
``plan.project``     per-buffer projection in ``project_rules``
``plan.delta``       ``ShardingPlan.apply_rule_change`` entry
``cache.load``       per disk read in ``PlanCache.get`` (plan cache)
``cache.store``      per disk write in ``PlanCache.put`` (plan cache)
``analyze.rules``    per analysis rule in ``analyze()`` (hazard lint)
===================  =====================================================

Sites accept :mod:`fnmatch` patterns, so a sweep can target one pass
(``sites=("fusion.*",)``) or everything (the default ``("*",)``).
"""
from __future__ import annotations

import fnmatch
import random
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Sequence

__all__ = ["InjectedFault", "FaultRecord", "FaultInjector", "inject_faults",
           "fault_point", "corrupt_value", "active_injector"]


class InjectedFault(RuntimeError):
    """Raised by :func:`fault_point` when the active injector fires.

    Deliberately a plain ``RuntimeError`` subclass: the degradation
    ladder must catch injected faults through the *same* ``except
    Exception`` boundaries that catch organic bugs — nothing in the
    production path is allowed to special-case this type."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


@dataclass(frozen=True)
class FaultRecord:
    """One fired injection, for post-hoc assertions in chaos tests."""
    site: str
    kind: str  # "raise" | "corrupt"


class FaultInjector:
    """Seeded probabilistic fault source.  Use via :func:`inject_faults`.

    Args:
        seed: seeds the single ``random.Random`` stream all sites share;
            same seed + same site-visit order ⇒ same failures.
        rate: probability that a :func:`fault_point` visit raises
            :class:`InjectedFault`.
        corrupt_rate: probability that a :func:`corrupt_value` visit
            perturbs the value instead of passing it through.
        sites: :mod:`fnmatch` patterns selecting which sites are armed.
            Visits to unarmed sites draw nothing, so each
            ``(seed, rate, sites)`` configuration is deterministic on
            its own terms (different ``sites`` filters are different
            draw streams — compare runs only within one config).
        corrupt_scale: relative half-width of the multiplicative
            perturbation applied by :func:`corrupt_value`.
    """

    def __init__(self, seed: int = 0, rate: float = 0.05,
                 corrupt_rate: float = 0.0,
                 sites: Sequence[str] = ("*",),
                 corrupt_scale: float = 0.5):
        self.seed = seed
        self.rate = rate
        self.corrupt_rate = corrupt_rate
        self.sites = tuple(sites)
        self.corrupt_scale = corrupt_scale
        self.records: list[FaultRecord] = []
        self._rng = random.Random(seed)

    # -- queries ---------------------------------------------------------
    def fired(self, pattern: str = "*") -> list[FaultRecord]:
        return [r for r in self.records
                if fnmatch.fnmatchcase(r.site, pattern)]

    def _armed(self, site: str) -> bool:
        return any(fnmatch.fnmatchcase(site, p) for p in self.sites)

    # -- hooks -----------------------------------------------------------
    def fire(self, site: str) -> None:
        if self.rate > 0 and self._armed(site) \
                and self._rng.random() < self.rate:
            self.records.append(FaultRecord(site, "raise"))
            raise InjectedFault(site)

    def corrupt(self, site: str, value: float) -> float:
        if self.corrupt_rate > 0 and self._armed(site) \
                and self._rng.random() < self.corrupt_rate:
            self.records.append(FaultRecord(site, "corrupt"))
            # Multiplicative perturbation in [1-s, 1+s): big enough to
            # reorder proposals, never NaN/negative for positive costs.
            f = 1.0 + self.corrupt_scale * (2.0 * self._rng.random() - 1.0)
            return value * f
        return value


#: The active injector.  A plain module global (not a thread-local):
#: the fault *arming* is process-wide on purpose — the DSE's optional
#: scoring pool must see the injector too, and chaos runs are
#: single-context by construction (``inject_faults`` refuses to nest).
_ACTIVE: FaultInjector | None = None


def active_injector() -> FaultInjector | None:
    """The injector currently armed by :func:`inject_faults`, if any.
    The degradation ladder uses this to decide whether belt-and-braces
    work (the uniform QoR floor) is warranted."""
    return _ACTIVE


def fault_point(site: str) -> None:
    """Injection site: raises :class:`InjectedFault` with probability
    ``rate`` when an injector is active and ``site`` is armed.  A single
    ``is None`` test otherwise — cheap enough for per-rewrite-step
    placement on the compile hot path."""
    if _ACTIVE is not None:
        _ACTIVE.fire(site)


def corrupt_value(site: str, value: float) -> float:
    """Corruption site: returns ``value``, possibly perturbed.  Used
    where a silently-wrong number exercises different defenses than an
    exception (the DSE's proposal scores feed ranking, not control
    flow)."""
    if _ACTIVE is not None:
        return _ACTIVE.corrupt(site, value)
    return value


@contextmanager
def inject_faults(seed: int = 0, rate: float = 0.05,
                  corrupt_rate: float = 0.0,
                  sites: Sequence[str] = ("*",),
                  corrupt_scale: float = 0.5
                  ) -> Iterator[FaultInjector]:
    """Arm a :class:`FaultInjector` for the ``with`` block.

    ::

        with inject_faults(seed=7, rate=0.05) as inj:
            sched, plan, report = optimize(graph, mesh)
        assert not inj.fired() or report.degradations

    Nesting is refused (two active injectors would interleave one
    site-visit stream unpredictably)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("inject_faults contexts cannot nest")
    inj = FaultInjector(seed=seed, rate=rate, corrupt_rate=corrupt_rate,
                        sites=sites, corrupt_scale=corrupt_scale)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = None
