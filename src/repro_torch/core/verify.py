"""Independent static legality checker for ``(Schedule, ShardingPlan)``.

HIDA's pitch is fully-automated optimization the user never has to
inspect; ScaleHLS couples every transform to a legality check so the DSE
cannot commit an invalid point.  This module is our equivalent: a
*verifier* that shares no code path with the passes that construct the
artifacts it checks (it reads the schedule and plan, projects specs
through :func:`repro_torch.core.plan._projected_spec`, and recomputes every
invariant from scratch), so a bug in a pass cannot also hide in the
check that was supposed to catch it.

``verify()`` returns a structured :class:`VerifyReport` — a list of
:class:`VerifyIssue` with machine-readable codes, not a bool — so the
degradation ladder in :func:`repro_torch.core.optimize.optimize` can decide
*which* repair rung an illegal plan needs, and tests can assert on the
precise violation a hand-corrupted plan trips.

Check families (codes in parentheses; ``severity="error"`` unless
noted):

* **Topology** — the schedule's dataflow is acyclic
  (``topology-cycle``) and pipeline stages are monotone along every
  producer→consumer edge (``stage-order``).
* **Node assignments** — every ``axis_map`` axis exists in the mesh
  (``axis-unknown``), no mesh axis serves two dims of one node
  (``axis-conflict``), ``unroll`` factors equal the product of the
  assigned axes' sizes (``unroll-mismatch``) and divide the node's loop
  dims (``unroll-divisibility``).
* **Rules** — every rule's axes exist in the mesh (``axis-unknown``)
  and no rule assigns the same axis twice, i.e. never asks for more
  capacity than the mesh has on that axis (``rule-capacity``).
* **Buffer specs** — stored per-buffer specs have the buffer's rank
  (``spec-rank``), name only real mesh axes (``axis-unknown``), and —
  for coherent plans — equal the projection of the consensus rules
  through the buffer's merged access maps across *all* touching nodes
  (``spec-incoherent``); non-divisible shardings are legal under GSPMD
  padding but wasteful, so they are a ``warning`` (``spec-pad``).
* **Role aliases** — every alias resolves to an existing source buffer
  and mirrors its spec exactly (``alias-incoherent``).
* **HBM fit** — per-device resident bytes under the plan's shardings,
  using the same per-axis shard-factor model as the roofline
  estimator's ``_bytes_touched``; over an explicit
  ``hbm_capacity_bytes`` it is an error, over the default
  :data:`HBM_CAPACITY_BYTES` only a ``warning`` (big dense configs
  without ``fsdp`` legitimately exceed a single chip — the launch layer
  decides whether that is fatal) (``hbm-overflow``).

The verifier itself must never take the pipeline down: every check
family runs inside its own guard, and an unexpected exception inside a
check becomes a ``verify-internal`` error on the report instead of
propagating.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .estimator import MeshSpec
from .ir import Schedule, ScheduleTopology, topo_order_over
from .plan import ShardingPlan, _projected_spec

__all__ = ["VerifyIssue", "VerifyReport", "VerifyError", "verify",
           "verify_static", "HBM_CAPACITY_BYTES"]

#: TPU v5e per-chip HBM (16 GiB).  The default fit check warns (rather
#: than errors) above this — see the module docstring.  The reference
#: verifier's assumed capacity, kept so that this copy reports what the
#: reference reports; not the memory of the card the port runs on.
HBM_CAPACITY_BYTES = 16 * 1024 ** 3


class VerifyError(RuntimeError):
    """Raised by :meth:`VerifyReport.raise_if_failed`."""

    def __init__(self, report: "VerifyReport"):
        super().__init__(report.summary())
        self.report = report


@dataclass(frozen=True)
class VerifyIssue:
    code: str       # machine-readable check identifier (see module doc)
    severity: str   # "error" | "warning"
    site: str       # node / buffer / rule / alias name ("" = global)
    message: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.severity}:{self.code}] {self.site}: {self.message}"


@dataclass
class VerifyReport:
    issues: list[VerifyIssue] = field(default_factory=list)
    #: individual invariant evaluations performed (for "did it actually
    #: check anything" assertions — an empty schedule trivially passes).
    checks: int = 0
    stats: dict = field(default_factory=dict)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.errors()

    def errors(self) -> list[VerifyIssue]:
        return [i for i in self.issues if i.severity == "error"]

    def warnings(self) -> list[VerifyIssue]:
        return [i for i in self.issues if i.severity == "warning"]

    def codes(self) -> set[str]:
        return {i.code for i in self.issues}

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise VerifyError(self)

    def summary(self) -> str:
        errs, warns = self.errors(), self.warnings()
        if not errs and not warns:
            return f"verify: clean ({self.checks} checks)"
        head = (f"verify: {len(errs)} error(s), {len(warns)} warning(s) "
                f"over {self.checks} checks")
        lines = [str(i) for i in errs[:8]] + \
            ([f"... {len(errs) - 8} more errors"] if len(errs) > 8 else [])
        return "\n".join([head] + lines)


def _axes_of(entry) -> tuple[str, ...]:
    """Normalise a spec entry (tuple of axis names) defensively."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def verify(sched: Schedule, plan: ShardingPlan, mesh: MeshSpec, *,
           coherent: bool | None = None,
           hbm_capacity_bytes: int | None = None,
           topology: ScheduleTopology | None = None) -> VerifyReport:
    """Statically check that ``plan`` is a legal sharding of ``sched``
    on ``mesh``.  Read-only: neither the schedule nor the plan is
    mutated.  See the module docstring for the check families.

    Args:
        sched: the (parallelized) Structural schedule.
        plan: the sharding plan to validate against it.
        mesh: the target mesh the plan claims to shard over.
        coherent: whether buffer specs must equal the rule projection
            (the CA-on product).  ``None`` reads ``plan.meta["ca"]``
            (absent ⇒ not enforced), matching how ``optimize()`` builds
            plans.
        hbm_capacity_bytes: explicit per-device HBM budget — overflow
            becomes an *error*.  ``None`` checks against the default
            v5e capacity as a warning only.
        topology: shared :class:`ScheduleTopology` (defaults to the
            schedule's cached one).
    """
    t0 = time.perf_counter()
    rep = VerifyReport()
    names = set(mesh.names)
    if coherent is None:
        coherent = bool(plan.meta.get("ca", False)) if isinstance(
            plan.meta, dict) else False

    def issue(code: str, site: str, message: str,
              severity: str = "error") -> None:
        rep.issues.append(VerifyIssue(code, severity, site, message))

    def guarded(check):
        try:
            check()
        except Exception as e:  # the verifier must never crash a compile
            issue("verify-internal", check.__name__,
                  f"checker crashed: {type(e).__name__}: {e}")

    topo: ScheduleTopology | None = None

    # -- topology: acyclicity + stage monotonicity -----------------------
    def check_topology() -> None:
        nonlocal topo
        try:
            topo = topology or sched.topology()
        except Exception as e:
            issue("topology-cycle", sched.name,
                  f"topology construction failed: {e}")
            return
        rep.checks += 1
        try:
            topo_order_over(sched.nodes, topo.edges, sched.name)
        except ValueError as e:
            issue("topology-cycle", sched.name, str(e))
        for src, dst, bname in topo.edges:
            rep.checks += 1
            s_stage = sched.node(src).stage
            d_stage = sched.node(dst).stage
            if s_stage > d_stage:
                issue("stage-order", bname,
                      f"edge {src}(stage {s_stage}) -> "
                      f"{dst}(stage {d_stage}) runs backwards in the "
                      "pipeline stage map")

    # -- node assignments ------------------------------------------------
    def check_nodes() -> None:
        for node in sched.nodes:
            dims = node.loop_dims()
            used_axes: dict[str, str] = {}
            for dim, axes in node.axis_map.items():
                axes = _axes_of(axes)
                rep.checks += 1
                for a in axes:
                    if a not in names:
                        issue("axis-unknown", node.name,
                              f"dim {dim!r} assigned unknown mesh axis "
                              f"{a!r} (mesh has {sorted(names)})")
                    elif a in used_axes and used_axes[a] != dim:
                        issue("axis-conflict", node.name,
                              f"mesh axis {a!r} assigned to both "
                              f"{used_axes[a]!r} and {dim!r}")
                    else:
                        used_axes[a] = dim
                factor = 1
                for a in axes:
                    if a in names:
                        factor *= mesh.size(a)
                got = node.unroll.get(dim)
                if got != factor:
                    issue("unroll-mismatch", node.name,
                          f"dim {dim!r}: unroll {got} != product of "
                          f"axes {axes} = {factor}")
            for dim, f in node.unroll.items():
                rep.checks += 1
                if dim not in node.axis_map:
                    issue("unroll-mismatch", node.name,
                          f"unroll factor for dim {dim!r} has no "
                          "axis_map entry")
                size = dims.get(dim)
                if size is not None and f and size % f != 0:
                    issue("unroll-divisibility", node.name,
                          f"dim {dim!r} extent {size} not divisible by "
                          f"unroll {f}")

    # -- rules -----------------------------------------------------------
    def check_rules() -> None:
        for dim, axes in plan.rules.items():
            axes = _axes_of(axes)
            rep.checks += 1
            for a in axes:
                if a not in names:
                    issue("axis-unknown", dim,
                          f"rule names unknown mesh axis {a!r}")
            if len(set(axes)) != len(axes):
                issue("rule-capacity", dim,
                      f"rule {axes} assigns a mesh axis more than once "
                      "— exceeds that axis's capacity")

    # -- buffer specs ----------------------------------------------------
    def check_buffer_specs() -> None:
        if topo is None:
            return
        for bname, buf in sched.buffers.items():
            spec = plan.buffer_specs.get(bname)
            if spec is None:
                continue
            rep.checks += 1
            if len(spec) != len(buf.shape):
                issue("spec-rank", bname,
                      f"spec rank {len(spec)} != buffer rank "
                      f"{len(buf.shape)}")
                continue
            seen: set[str] = set()
            for axis_idx, entry in enumerate(spec):
                axes = _axes_of(entry)
                factor = 1
                for a in axes:
                    if a not in names:
                        issue("axis-unknown", bname,
                              f"spec axis {axis_idx} names unknown mesh "
                              f"axis {a!r}")
                    elif a not in seen:
                        seen.add(a)
                        factor *= mesh.size(a)
                if factor > 1 and buf.shape[axis_idx] % factor != 0:
                    issue("spec-pad", bname,
                          f"axis {axis_idx} extent "
                          f"{buf.shape[axis_idx]} not divisible by "
                          f"shard factor {factor} (GSPMD will pad)",
                          severity="warning")
            if coherent and topo.owners(bname):
                want = _projected_spec(plan.rules, topo.axis_dims[bname])
                got = tuple(_axes_of(e) for e in spec)
                if got != tuple(_axes_of(e) for e in want):
                    issue("spec-incoherent", bname,
                          f"stored spec {got} != rule projection {want} "
                          "through the buffer's access maps")

    # -- role aliases ----------------------------------------------------
    def check_aliases() -> None:
        for role, source in plan.role_sources.items():
            rep.checks += 1
            if source not in plan.buffer_specs:
                issue("alias-incoherent", role,
                      f"alias source {source!r} has no spec")
                continue
            if plan.buffer_specs.get(role) != plan.buffer_specs[source]:
                issue("alias-incoherent", role,
                      f"alias spec {plan.buffer_specs.get(role)} != "
                      f"source {source!r} spec "
                      f"{plan.buffer_specs[source]}")

    # -- per-device HBM fit ---------------------------------------------
    def check_hbm() -> None:
        resident = 0.0
        for bname, buf in sched.buffers.items():
            spec = plan.buffer_specs.get(bname)
            factor = 1
            if spec:
                seen: set[str] = set()
                for axis_idx, entry in enumerate(spec):
                    if axis_idx >= len(buf.shape):
                        break
                    f = 1
                    for a in _axes_of(entry):
                        if a in names and a not in seen:
                            seen.add(a)
                            f *= mesh.size(a)
                    # A shard factor beyond the axis extent cannot reduce
                    # residency further (same clamp as the estimator's
                    # buffer_shard_factor).
                    factor *= min(f, buf.shape[axis_idx]) if f > 1 else 1
            resident += buf.bytes / max(factor, 1)
        rep.checks += 1
        rep.stats["hbm_resident_bytes"] = int(resident)
        cap = hbm_capacity_bytes or HBM_CAPACITY_BYTES
        if resident > cap:
            issue("hbm-overflow", sched.name,
                  f"resident {resident / 1e9:.2f} GB/device exceeds "
                  f"capacity {cap / 1e9:.2f} GB",
                  severity=("error" if hbm_capacity_bytes is not None
                            else "warning"))

    for check in (check_topology, check_nodes, check_rules,
                  check_buffer_specs, check_aliases, check_hbm):
        guarded(check)

    rep.stats.setdefault("nodes", len(sched.nodes))
    rep.stats.setdefault("buffers", len(sched.buffers))
    rep.elapsed_s = time.perf_counter() - t0
    return rep


def verify_static(plan: ShardingPlan, mesh: MeshSpec) -> VerifyReport:
    """Schedule-free legality check of a plan against a mesh — the
    plan-cache *load* gate.

    A cache hit must cost microseconds, so this checks every invariant
    that the plan alone can witness: the plan was derived **for** this
    mesh (``mesh-mismatch``), rules and buffer specs name only real mesh
    axes without over-subscribing one (``axis-unknown``,
    ``rule-capacity``), and role aliases mirror an existing source spec
    (``alias-incoherent``).  Schedule-coupled families (topology, node
    assignments, spec coherence/rank, HBM fit) need the live schedule
    and already ran through the full :func:`verify` when the entry was
    *stored* — the cache only persists plans whose store-time report was
    clean.  Same never-crash contract as ``verify()``."""
    t0 = time.perf_counter()
    rep = VerifyReport()
    names = set(mesh.names)

    def issue(code: str, site: str, message: str,
              severity: str = "error") -> None:
        rep.issues.append(VerifyIssue(code, severity, site, message))

    def guarded(check):
        try:
            check()
        except Exception as e:
            issue("verify-internal", check.__name__,
                  f"checker crashed: {type(e).__name__}: {e}")

    def check_mesh() -> None:
        rep.checks += 1
        if tuple(plan.mesh_spec.axes) != tuple(mesh.axes):
            issue("mesh-mismatch", "mesh",
                  f"plan derived for mesh {plan.mesh_spec.axes}, "
                  f"requested {mesh.axes}")

    def check_rules() -> None:
        for dim, axes in plan.rules.items():
            axes = _axes_of(axes)
            rep.checks += 1
            for a in axes:
                if a not in names:
                    issue("axis-unknown", dim,
                          f"rule names unknown mesh axis {a!r}")
            if len(set(axes)) != len(axes):
                issue("rule-capacity", dim,
                      f"rule {axes} assigns a mesh axis more than once")

    def check_specs() -> None:
        for bname, spec in plan.buffer_specs.items():
            rep.checks += 1
            seen: set[str] = set()
            for axis_idx, entry in enumerate(spec):
                for a in _axes_of(entry):
                    if a not in names:
                        issue("axis-unknown", bname,
                              f"spec axis {axis_idx} names unknown mesh "
                              f"axis {a!r}")
                    elif a in seen:
                        # The full verifier tolerates this (it skips the
                        # duplicate when computing shard factors), so the
                        # load gate must not reject what store-time
                        # verify passed.
                        issue("rule-capacity", bname,
                              f"spec uses mesh axis {a!r} on two "
                              "dimensions of one buffer",
                              severity="warning")
                    else:
                        seen.add(a)

    def check_aliases() -> None:
        for role, source in plan.role_sources.items():
            rep.checks += 1
            if source not in plan.buffer_specs:
                issue("alias-incoherent", role,
                      f"alias source {source!r} has no spec")
            elif plan.buffer_specs.get(role) != plan.buffer_specs[source]:
                issue("alias-incoherent", role,
                      f"alias spec {plan.buffer_specs.get(role)} != "
                      f"source {source!r} spec")

    for check in (check_mesh, check_rules, check_specs, check_aliases):
        guarded(check)
    rep.stats["static"] = True
    rep.elapsed_s = time.perf_counter() - t0
    return rep
