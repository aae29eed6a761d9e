"""Persistent :class:`ShardingPlan` cache with warm-start seeding.

HIDA's premise is that the dataflow schedule is computed once and then
*streamed through* at steady state.  The serving analogue: a production
endpoint sees the same (config, mesh, shape-bucket) triples over and
over, so the ~0.65 s DSE should run at most once per triple per
deployment — afterwards the plan is a microsecond dictionary fetch.

Three tiers, fastest first:

1. **In-process LRU** — ``PlanCache.get`` on a resident key is a dict
   hit (sub-microsecond, no I/O, no verification re-run).
2. **Disk** — one JSON file per key under the cache root, written
   atomically (tmp + ``os.replace``), carrying the plan
   (``ShardingPlan.to_json`` payload, version-checked by
   ``from_json``), the DSE's canonical assignment snapshot, and the
   recorded QoR.  Loads are gated by
   :func:`~repro_torch.core.verify.verify_static` and the plan-only hazard
   rules of :func:`~repro_torch.core.analyze.analyze_plan` in
   :meth:`PlanCache.fetch` — a plan is only served against the mesh it
   was derived for, and never with stale/chained role aliases.  Any
   corruption (truncated file, bad JSON, stale format version, injected
   ``cache.load`` fault) degrades to a miss, never an exception.
3. **Warm-started re-DSE** — on a miss, :meth:`PlanCache.nearest` finds
   the closest stored entry (same config fingerprint first, then same
   mesh, then same bucket) and :func:`fetch_or_optimize` seeds
   ``optimize(warm_start=...)`` from its snapshot: the beam phase is
   skipped, covered nodes start from the donor assignment (sanitized
   onto the new mesh), and coordinate descent converges from there —
   warm wall is a fraction of cold wall at equal-or-better QoR (the
   ``bench_serve`` gate pins this on every config).

Cache keys (:class:`PlanKey`) are (config fingerprint, mesh axes, shape
bucket).  The fingerprint hashes every :class:`ArchConfig` field, so
*any* architectural change — silently different ``d_ff``, a new MoE
setting — is a different key; there is no way to mis-serve a plan to a
config it was not derived for.  Shape buckets are names
(``decode_32k``) or :func:`shape_bucket` strings for free-form serving
shapes, so nearby request shapes share one plan while far-apart ones do
not.

Chaos sites ``cache.load`` / ``cache.store`` (see
:mod:`repro_torch.core.faults`) let tests assert the degrade-to-miss and
degrade-to-unstored contracts under injected I/O failure.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from .estimator import MeshSpec
from .faults import fault_point
from ..configs.base import reference_dict
from .incremental import Snapshot
from .plan import ShardingPlan
from .verify import VerifyReport, verify_static

__all__ = ["PlanKey", "CachedPlan", "PlanCache", "config_fingerprint",
           "shape_bucket", "fetch_or_optimize", "CACHE_FORMAT_VERSION"]

#: Bumped whenever the entry envelope (not the plan payload — that has
#: its own ``PLAN_FORMAT_VERSION``) changes incompatibly.
CACHE_FORMAT_VERSION = 1


def config_fingerprint(cfg) -> str:
    """Content hash of an :class:`ArchConfig` (or any dataclass).

    Every field participates — two configs differing in one number get
    different fingerprints, so a cached plan can never be served to an
    architecture it was not derived for — except the port-only fields at
    their defaults (``configs.base.reference_dict``), so that a config
    the reference also has keeps the reference's fingerprint."""
    if dataclasses.is_dataclass(cfg):
        payload = reference_dict(cfg)
    elif isinstance(cfg, dict):
        payload = cfg
    else:
        payload = {"repr": repr(cfg)}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def shape_bucket(mode: str, seq_len: int, batch: int) -> str:
    """Quantize a free-form request shape onto a bucket name.

    Serving traffic has arbitrary prompt lengths; compiling per exact
    length would defeat the cache.  Lengths round up to the next power
    of two (min 128) — the same padding the scheduler's prefill side
    steps use — so nearby shapes share one plan."""
    b = 128
    while b < seq_len:
        b *= 2
    return f"{mode}_b{batch}_s{b}"


@dataclass(frozen=True)
class PlanKey:
    """(what model, what machine, what shapes) — the cache identity."""
    fingerprint: str
    mesh: tuple[tuple[str, int], ...]
    bucket: str

    @classmethod
    def make(cls, cfg, mesh: MeshSpec, bucket: str) -> "PlanKey":
        return cls(config_fingerprint(cfg),
                   tuple((a, int(s)) for a, s in mesh.axes), str(bucket))

    def digest(self) -> str:
        blob = json.dumps([self.fingerprint, list(map(list, self.mesh)),
                           self.bucket])
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def to_dict(self) -> dict:
        return {"fingerprint": self.fingerprint,
                "mesh": [list(m) for m in self.mesh],
                "bucket": self.bucket}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanKey":
        return cls(d["fingerprint"],
                   tuple((a, int(s)) for a, s in d["mesh"]), d["bucket"])


@dataclass
class CachedPlan:
    """One cache entry: the plan plus everything a warm start needs."""
    key: PlanKey
    plan: ShardingPlan
    #: canonical-keyed whole-schedule assignment
    #: (:func:`repro_torch.core.parallelize.canonical_snapshot`) — the warm seed.
    snapshot: Snapshot
    #: ``cost.total_s`` recorded when the entry was stored.
    qor_total_s: float
    stored_unix: float = 0.0

    def to_json(self) -> str:
        snap = {name: [{d: list(axes) for d, axes in am.items()},
                       dict(ur)]
                for name, (am, ur) in self.snapshot.items()}
        return json.dumps({
            "cache_version": CACHE_FORMAT_VERSION,
            "key": self.key.to_dict(),
            "plan": json.loads(self.plan.to_json()),
            "snapshot": snap,
            "qor_total_s": self.qor_total_s,
            "stored_unix": self.stored_unix,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CachedPlan":
        d = json.loads(text)
        version = d.get("cache_version")
        if version != CACHE_FORMAT_VERSION:
            raise ValueError(
                f"cache entry version {version!r} != supported "
                f"{CACHE_FORMAT_VERSION}")
        snapshot: Snapshot = {
            name: ({dim: tuple(axes) for dim, axes in am.items()},
                   {dim: int(f) for dim, f in ur.items()})
            for name, (am, ur) in d["snapshot"].items()}
        return cls(key=PlanKey.from_dict(d["key"]),
                   plan=ShardingPlan.from_json(json.dumps(d["plan"])),
                   snapshot=snapshot,
                   qor_total_s=float(d["qor_total_s"]),
                   stored_unix=float(d.get("stored_unix", 0.0)))


class PlanCache:
    """LRU-fronted on-disk plan cache.  Load and store paths never
    raise: corruption, version skew, and I/O failure all degrade to a
    miss (load) or an unstored entry (store), counted in :attr:`stats`.

    Args:
        root: cache directory (created if missing).  ``None`` disables
            the disk tier — a pure in-process LRU.
        capacity: maximum resident entries; least-recently-used entries
            are dropped from memory (their disk files remain).
    """

    def __init__(self, root: str | os.PathLike | None,
                 capacity: int = 64):
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self.capacity = max(1, capacity)
        self._lru: OrderedDict[PlanKey, CachedPlan] = OrderedDict()
        self.stats = {"hits_mem": 0, "hits_disk": 0, "misses": 0,
                      "corrupt": 0, "stores": 0, "store_errors": 0,
                      "rejected": 0, "hazard_rejected": 0}

    # -- internals -------------------------------------------------------
    def _path(self, key: PlanKey) -> Path | None:
        return (self.root / f"{key.digest()}.json"
                if self.root is not None else None)

    def _remember(self, entry: CachedPlan) -> None:
        self._lru[entry.key] = entry
        self._lru.move_to_end(entry.key)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    # -- load path -------------------------------------------------------
    def get(self, key: PlanKey) -> CachedPlan | None:
        """Fetch an entry by exact key.  Memory first, then disk; any
        disk-tier failure (bad JSON, stale version, injected
        ``cache.load`` fault) is a miss, never an exception."""
        entry = self._lru.get(key)
        if entry is not None:
            self._lru.move_to_end(key)
            self.stats["hits_mem"] += 1
            return entry
        path = self._path(key)
        if path is None or not path.exists():
            self.stats["misses"] += 1
            return None
        try:
            fault_point("cache.load")
            entry = CachedPlan.from_json(path.read_text())
            if entry.key != key:
                raise ValueError(f"entry at {path.name} carries key "
                                 f"{entry.key}, expected {key}")
        except Exception:
            self.stats["corrupt"] += 1
            self.stats["misses"] += 1
            return None
        self.stats["hits_disk"] += 1
        self._remember(entry)
        return entry

    def fetch(self, key: PlanKey, mesh: MeshSpec
              ) -> tuple[CachedPlan | None, VerifyReport | None]:
        """:meth:`get` gated by :func:`verify_static` against ``mesh``
        plus the plan-only hazard rules of
        :func:`repro_torch.core.analyze.analyze_plan` (stale / chained role
        aliases — the memory tier mutates plans in place via
        ``apply_rule_change``, so an entry can rot between store and
        reuse).  A present-but-illegal or hazardous entry counts as a
        miss (and is dropped from the LRU so it is not re-tried every
        request)."""
        from .analyze import analyze_plan   # local: avoid import cycle
        entry = self.get(key)
        if entry is None:
            return None, None
        rep = verify_static(entry.plan, mesh)
        if not rep.ok:
            self.stats["rejected"] += 1
            self._lru.pop(key, None)
            return None, rep
        arep = analyze_plan(entry.plan, mesh)
        if not arep.ok:
            self.stats["hazard_rejected"] += 1
            self._lru.pop(key, None)
            return None, rep
        return entry, rep

    # -- store path ------------------------------------------------------
    def put(self, entry: CachedPlan) -> bool:
        """Store an entry (memory + atomic disk write).  Returns False —
        never raises — when the disk write fails (the entry still lands
        in the LRU: this process keeps its work either way)."""
        self._remember(entry)
        path = self._path(entry.key)
        if path is None:
            self.stats["stores"] += 1
            return True
        try:
            fault_point("cache.store")
            blob = entry.to_json()
            tmp = path.with_suffix(f".tmp.{os.getpid()}")
            tmp.write_text(blob)
            os.replace(tmp, path)  # atomic: readers see old or new, never half
        except Exception:
            self.stats["store_errors"] += 1
            return False
        self.stats["stores"] += 1
        return True

    # -- warm-start donor selection --------------------------------------
    def nearest(self, key: PlanKey) -> CachedPlan | None:
        """Closest stored entry to ``key`` (which itself missed): same
        config fingerprint outranks same mesh outranks same bucket —
        an identical architecture on a different mesh or shape bucket
        is a far better seed than a different architecture anywhere.
        Exact-key entries are excluded (that is :meth:`get`'s job)."""
        best: CachedPlan | None = None
        best_score = 0
        for cand in self._iter_entries():
            if cand.key == key:
                continue
            score = (4 * (cand.key.fingerprint == key.fingerprint)
                     + 2 * (cand.key.mesh == key.mesh)
                     + (cand.key.bucket == key.bucket))
            if score > best_score:
                best, best_score = cand, score
        return best

    def _iter_entries(self):
        seen: set[PlanKey] = set()
        for entry in reversed(self._lru.values()):  # most recent first
            seen.add(entry.key)
            yield entry
        if self.root is None:
            return
        try:
            paths = sorted(self.root.glob("*.json"))
        except OSError:
            return
        for path in paths:
            try:
                fault_point("cache.load")
                entry = CachedPlan.from_json(path.read_text())
            except Exception:
                self.stats["corrupt"] += 1
                continue
            if entry.key not in seen:
                seen.add(entry.key)
                yield entry


def fetch_or_optimize(cache: PlanCache, key: PlanKey, mesh: MeshSpec,
                      graph_factory: Callable[[], object], *,
                      optimize_kwargs: dict | None = None
                      ) -> tuple[ShardingPlan, str, object]:
    """The serving compile path: cache hit → warm re-DSE → cold DSE.

    Args:
        cache: the plan cache.
        key: identity of the requested (config, mesh, bucket).
        mesh: target mesh (must match ``key.mesh``; verified statically
            on every cache-served plan).
        graph_factory: zero-arg callable building a fresh Functional
            graph for the config+shape — only invoked on a miss, so a
            hit pays no graph construction.
        optimize_kwargs: forwarded to :func:`repro_torch.core.optimize.optimize`
            (e.g. ``training=False``, ``budget_s``).

    Returns:
        ``(plan, source, report)`` where ``source`` is ``"hit"``,
        ``"warm"`` or ``"cold"`` and ``report`` is the
        :class:`OptimizeReport` (``None`` on a hit).
    """
    from .optimize import optimize          # local: avoid import cycle
    from .parallelize import canonical_snapshot

    entry, _rep = cache.fetch(key, mesh)
    if entry is not None:
        return entry.plan, "hit", None

    donor = cache.nearest(key)
    kw = dict(optimize_kwargs or {})
    if donor is not None:
        kw["warm_start"] = donor.snapshot
    sched, plan, report = optimize(graph_factory(), mesh, **kw)

    # Store only what the exit verifier passed clean — the load path's
    # static gate assumes store-time full verification.
    if report.verify is not None and report.verify.ok \
            and report.cost is not None:
        cache.put(CachedPlan(
            key=key, plan=plan, snapshot=canonical_snapshot(sched),
            qor_total_s=report.cost.total_s, stored_unix=time.time()))
    return plan, ("warm" if donor is not None else "cold"), report
