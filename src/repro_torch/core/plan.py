"""ShardingPlan: the artifact HIDA-OPT hands to the model.

A copy of the reference's ``repro.core.plan`` without JAX.  The data half
(``rules``, ``buffer_specs``, ``meta``, ``role_sources``, the JSON format,
the delta re-projection, ``build_plan`` / ``project_rules``) is the
reference's, line for line.  Specs are plain tuples whose entries equal
those of the reference's ``PartitionSpec`` (``None``, an axis name, or a
tuple of names).  The port runs on one card with no device mesh, so
:meth:`ShardingPlan.constrain` returns its input, as the reference's does
outside a mesh context; placing tensors on a ``DeviceMesh`` (the
reference's ``named_sharding``) is not ported yet.

``build_plan`` converts a parallelized Structural schedule into:

* ``buffer_specs`` — per Structural buffer, the mesh axes sharding each
  tensor dimension (derived from the owning node's ``axis_map`` through its
  access map).  Model code applies these at the corresponding
  ``with_sharding_constraint`` sites (the TPU realisation of HIDA's buffer
  partition attributes).
* ``rules`` — logical-dim-name → mesh axes, the majority assignment across
  nodes; used for tensors that are not first-class Structural buffers
  (optimizer state, RNG keys, …).
* ``fsdp`` — optional ZeRO-3-style extra sharding of weight buffers over
  the unused data axes (beyond-paper feature required to fit the 100B+
  configs in HBM; recorded separately in EXPERIMENTS.md).

The plan is pure data (JSON-serialisable via ``to_json``) so dry-run
artifacts can be diffed across perf iterations.
"""
from __future__ import annotations

import json
import logging
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .estimator import MeshSpec
from .faults import fault_point
from .ir import Schedule, ScheduleTopology

logger = logging.getLogger(__name__)

Axes = tuple[str, ...]
#: A partition spec: per tensor dim ``None``, one mesh axis name, or a
#: tuple of names; trailing ``None`` entries dropped (``tuple(P)`` of the
#: reference's ``PartitionSpec``).
Spec = tuple

#: Serialization format version written by :meth:`ShardingPlan.to_json`
#: and required (exactly) by :meth:`ShardingPlan.from_json`.  Bump it
#: whenever the JSON schema or the semantics of any field change — the
#: persistent plan cache (:mod:`repro_torch.core.plan_cache`) rejects entries
#: whose version differs instead of misapplying a stale layout.
PLAN_FORMAT_VERSION = 1


@dataclass
class ShardingPlan:
    mesh_spec: MeshSpec
    buffer_specs: dict[str, tuple[Axes, ...]] = field(default_factory=dict)
    rules: dict[str, Axes] = field(default_factory=dict)
    fsdp: bool = False
    meta: dict = field(default_factory=dict)
    #: role alias -> source buffer site (e.g. ``"qkv" -> "L0__qkv"``); the
    #: alias's spec in ``buffer_specs`` mirrors the source's and is kept in
    #: step by :meth:`apply_rule_change`.  Derivable from the names, so it
    #: is not serialized.
    role_sources: dict[str, str] = field(default_factory=dict)
    #: site -> count of overrides dropped by :meth:`spec_for_dims` because
    #: the stored per-dim rank mismatched the queried dims.  A diagnostic
    #: populated on the query path, so kept out of ``meta`` / ``to_json``
    #: — the serialized plan stays pure data, independent of query history.
    spec_rank_mismatches: dict[str, int] = field(default_factory=dict)

    # -- spec construction ---------------------------------------------------
    def _dedupe(self, axes_per_dim: Sequence[Axes]) -> tuple:
        """PartitionSpec axes must be unique; first use (leftmost dim) wins,
        later dims drop the duplicate axis (replicate instead)."""
        used: set[str] = set()
        out = []
        for axes in axes_per_dim:
            keep = tuple(a for a in axes if a not in used)
            used.update(keep)
            if not keep:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(keep)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec_for_dims(self, dims: Sequence[str],
                      site: str | None = None) -> Spec:
        """PartitionSpec for a tensor described by logical dim names,
        honouring a buffer-site override when given.  A site override
        whose stored rank mismatches ``dims`` (common for role aliases
        stripped from layer-prefixed names) falls back to the rules — the
        drop is counted in :attr:`spec_rank_mismatches` (and debug-logged)
        so silently replicated tensors are diagnosable."""
        if site is not None and site in self.buffer_specs:
            per_dim = self.buffer_specs[site]
            if len(per_dim) == len(dims):
                return self._dedupe(per_dim)
            mm = self.spec_rank_mismatches
            mm[site] = mm.get(site, 0) + 1
            logger.debug(
                "spec_for_dims: site %r override rank %d != dims %r; "
                "falling back to rules", site, len(per_dim), tuple(dims))
        per_dim = [self.rules.get(d, ()) for d in dims]
        return self._dedupe(per_dim)

    def param_spec(self, dims: Sequence[str], site: str | None = None,
                   shape: Sequence[int] | None = None) -> Spec:
        """Weight spec; with ``fsdp`` the unused data axes additionally
        shard a remaining dim (ZeRO-3), preferring evenly divisible dims
        when the shape is known (avoids GSPMD padding waste)."""
        base = self.spec_for_dims(dims, site)
        # Expert weights are fully sharded by expert (EP widened over the
        # data axis for big expert counts) — extra FSDP axes on their
        # other dims would force per-layer gathers that XLA hoists out of
        # the layer scan into a stacked multi-hundred-GiB temp.
        if not self.fsdp or "experts" in dims:
            return base
        spec = list(base) + [None] * (len(dims) - len(base))
        used = {a for entry in spec if entry
                for a in ((entry,) if isinstance(entry, str) else entry)}

        def place(axis_name: str, i: int) -> None:
            entry = spec[i]
            if entry is None:
                spec[i] = axis_name
            else:
                cur = (entry,) if isinstance(entry, str) else tuple(entry)
                spec[i] = cur + (axis_name,)
            used.add(axis_name)

        for axis_name in ("data", "pod"):
            try:
                size = self.mesh_spec.size(axis_name)
            except KeyError:
                continue
            if axis_name in used:
                continue
            candidates = [i for i, e in enumerate(spec) if e is None]
            candidates += [i for i in range(len(spec))
                           if i not in candidates]
            if shape is not None:
                # The composed factor (existing axes × fsdp axis) must
                # divide the dim — jit argument shardings reject padding.
                def factor(i):
                    e = spec[i]
                    f = size
                    for a in ((e,) if isinstance(e, str) else (e or ())):
                        f *= self.mesh_spec.size(a)
                    return f
                candidates = [i for i in candidates
                              if shape[i] % factor(i) == 0]
            if candidates:
                place(axis_name, candidates[0])
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    # -- application ----------------------------------------------------------
    def constrain(self, x, dims: Sequence[str], site: str | None = None):
        """Apply a sharding constraint at a Structural buffer site.  The
        port has no device mesh, and the reference's constraint is a no-op
        outside one, so this returns ``x``."""
        return x

    # -- incremental re-projection --------------------------------------------
    def add_role_alias(self, role: str, source: str) -> None:
        """Expose ``source``'s spec under the stripped role name (first
        writer wins, matching ``setdefault``); the alias tracks its source
        through later :meth:`apply_rule_change` re-projections."""
        if role in self.buffer_specs or source not in self.buffer_specs:
            return
        self.buffer_specs[role] = self.buffer_specs[source]
        self.role_sources[role] = source

    def apply_rule_change(self, dim: str, axes: Axes,
                          sched: Schedule,
                          topology: ScheduleTopology | None = None
                          ) -> list[str]:
        """Delta re-projection: set ``rules[dim] = axes`` (empty ``axes``
        deletes the rule) and re-project **only** the buffer sites whose
        coherent access maps reference ``dim`` — plus their role aliases —
        instead of rebuilding every spec like :func:`project_rules`.

        Requires the plan to be coherent (every site already the
        projection of the current rules, i.e. built with
        ``coherent=True`` and mutated only through this method); then the
        result is bit-identical to a full :func:`project_rules` rebuild
        under the new rules.  Returns the re-projected site names."""
        fault_point("plan.delta")
        if axes:
            self.rules[dim] = tuple(axes)
        else:
            self.rules.pop(dim, None)
        topo = topology or sched.topology()
        changed: list[str] = []
        for bname in topo.buffers_of_dim.get(dim, ()):
            if bname not in self.buffer_specs:
                continue
            per_dim = _projected_spec(self.rules, topo.axis_dims[bname])
            self.buffer_specs[bname] = per_dim
            buf = sched.buffers.get(bname)
            if buf is not None:
                buf.spec = per_dim
            changed.append(bname)
        touched = set(changed)
        for role, source in self.role_sources.items():
            if source in touched:
                self.buffer_specs[role] = self.buffer_specs[source]
                changed.append(role)
        return changed

    # -- serialisation ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "version": PLAN_FORMAT_VERSION,
            "mesh": [[a, int(s)] for a, s in self.mesh_spec.axes],
            "buffer_specs": {k: [list(a) for a in v]
                             for k, v in self.buffer_specs.items()},
            "rules": {k: list(v) for k, v in self.rules.items()},
            "fsdp": self.fsdp,
            "meta": self.meta,
            # Role aliases are derivable from the "__"-prefixed names on a
            # live plan, but a deserialized plan must re-project aliases
            # through apply_rule_change without re-deriving, so the map is
            # carried explicitly (round-trip exactness > redundancy).
            "role_sources": dict(self.role_sources),
            # sort_keys makes the serialization canonical: two plans with
            # equal content serialize to the same bytes regardless of the
            # insertion order their dicts were built in — the round trip
            # from_json(to_json(p)).to_json() is bit-identical, and plan
            # JSON is directly comparable/hashable by the cache layer.
        }, indent=2, sort_keys=True, default=str)

    @classmethod
    def from_json(cls, text: str) -> "ShardingPlan":
        """Exact inverse of :meth:`to_json`: the round trip
        ``ShardingPlan.from_json(p.to_json()).to_json() == p.to_json()``
        is bit-identical, including role aliases and ``meta``.

        Raises ``ValueError`` when the serialized ``version`` is not
        :data:`PLAN_FORMAT_VERSION` — a stale persisted plan must be
        rejected (and re-derived), never silently misapplied."""
        d = json.loads(text)
        version = d.get("version")
        if version != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"plan format version {version!r} != supported "
                f"{PLAN_FORMAT_VERSION}; stale entry must be re-derived")
        return cls(
            mesh_spec=MeshSpec(tuple((a, int(s)) for a, s in d["mesh"])),
            buffer_specs={k: tuple(tuple(a) for a in v)
                          for k, v in d["buffer_specs"].items()},
            rules={k: tuple(v) for k, v in d["rules"].items()},
            fsdp=bool(d["fsdp"]),
            meta=d["meta"],
            role_sources=dict(d.get("role_sources", {})))


def replicated_plan(mesh_spec: MeshSpec, data_axes: Axes = ("pod", "data"),
                    fsdp: bool = False) -> ShardingPlan:
    """The naive baseline: batch over data axes, everything else
    replicated (what you get without the paper's technique)."""
    rules = {"batch": tuple(a for a in data_axes
                            if a in mesh_spec.names)}
    return ShardingPlan(mesh_spec=mesh_spec, rules=rules, fsdp=fsdp,
                        meta={"strategy": "naive-dp"})


def _projected_spec(rules: dict[str, Axes],
                    axis_dims: Sequence[Optional[str]]) -> tuple[Axes, ...]:
    """THE projection routine: per-buffer spec as the consensus rules seen
    through the buffer's coherent per-axis loop dims (first non-None dim
    any owner's access map names at each axis — see
    ``ScheduleTopology.axis_dims``).  Both the full rebuild
    (:func:`project_rules`) and the delta path
    (:meth:`ShardingPlan.apply_rule_change`) go through here, so they
    cannot diverge.  Scanning *all* owners per axis (not just the first
    owner with any access map) is what fixes the silent-unshard hazard:
    a producer whose access map has ``None`` at an axis no longer hides a
    consumer's loop dim there."""
    return tuple(rules.get(d, ()) if d else () for d in axis_dims)


def build_plan(sched: Schedule, mesh_spec: MeshSpec,
               fsdp: bool = False, meta: dict | None = None,
               coherent: bool = True,
               topology: ScheduleTopology | None = None) -> ShardingPlan:
    """Derive the :class:`ShardingPlan` from a parallelized schedule.

    Runs after the DSE (greedy + beam search, see
    :func:`repro_torch.core.parallelize.parallelize`) has written ``unroll`` /
    ``axis_map`` onto every node: per-buffer specs come from the owning
    nodes' axis maps projected through their access maps; per-logical-dim
    ``rules`` are the intensity-weighted majority vote across nodes.

    Args:
        sched: parallelized Structural schedule (read-only here).
        mesh_spec: target mesh (recorded in the plan for ``specs()``).
        fsdp: ZeRO-3-style extra weight sharding over unused data axes
            (beyond-paper; needed to fit the 100B+ configs in HBM).
        meta: free-form provenance recorded in the plan (JSON-serialised
            with it).
        coherent: ``True`` (the CA-on product) projects one
            intensity-weighted consensus rule per logical dim onto every
            buffer site — constraint sites never disagree, so GSPMD
            resharding stays incremental.  ``False`` keeps raw per-node
            layouts (the CA-off ablation arm); measured on deepseek-v3
            train_4k this triggers GSPMD "involuntary full
            rematerialization" and ~2.3 TiB/device of temp — the TPU
            incarnation of the paper's Fig. 11 'flawed designs'.
        topology: the shared :class:`ScheduleTopology`; defaults to the
            schedule's cached one (the same structure the incremental
            estimator's DSE ran on).
    """
    fault_point("plan.build")
    plan = ShardingPlan(mesh_spec=mesh_spec, fsdp=fsdp, meta=meta or {})
    topo = topology or sched.topology()

    votes: dict[str, Counter] = {}
    for bname, buf in sched.buffers.items():
        if not topo.owners(bname):
            continue
        per_dim: list[Axes] = []
        for pairs in topo.axis_owner_dims[bname]:
            axes: Axes = ()
            # Producer's layout wins; an unparallelized producer (e.g. the
            # amortized embed node, pf=1) defers to its consumers so the
            # buffer does not force a reshard at every layer boundary.
            for node, d in pairs:
                a = tuple(node.axis_map.get(d, ()))
                if a:
                    axes = a
                    break
            per_dim.append(axes)
            if pairs:
                votes.setdefault(pairs[0][1], Counter())[axes] += 1
        plan.buffer_specs[bname] = tuple(per_dim)
        buf.spec = tuple(per_dim)

    for node in sched.nodes:
        # Intensity-weighted votes: the critical nodes decide the rules.
        w = max(int(node.intensity() ** 0.5), 1)
        for dim, axes in node.axis_map.items():
            votes.setdefault(dim, Counter())[tuple(axes)] += w

    for dim, counter in votes.items():
        winner, _ = counter.most_common(1)[0]
        if winner:
            plan.rules[dim] = winner

    if coherent:
        project_rules(plan, sched, topology=topo)
    return plan


def project_rules(plan: ShardingPlan, sched: Schedule,
                  topology: ScheduleTopology | None = None) -> None:
    """Rewrite every buffer site as the projection of the consensus rules
    — one layout basin across the whole dataflow.  This is the full
    rebuild; :meth:`ShardingPlan.apply_rule_change` is the O(Δ) path for
    a single-rule update.  Both run the same projection
    (:func:`_projected_spec`) over the same cached per-axis dims, so a
    delta-maintained plan and a from-scratch rebuild are bit-identical."""
    fault_point("plan.project")
    topo = topology or sched.topology()
    for bname, buf in sched.buffers.items():
        if bname not in plan.buffer_specs:
            continue
        per_dim = _projected_spec(plan.rules, topo.axis_dims[bname])
        plan.buffer_specs[bname] = per_dim
        buf.spec = per_dim
    for role, source in plan.role_sources.items():
        if source in plan.buffer_specs:
            plan.buffer_specs[role] = plan.buffer_specs[source]
