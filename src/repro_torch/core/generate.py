"""Seeded synthetic dataflow-graph generator — the scale-stress suite.

The port's copy of ``repro.core.generate``, line for line over the
port's IR: the same specs build the same graphs, structure fingerprint
for fingerprint (``tests/test_torch_generate.py``).

Every real config in the repo tops out at 43 schedule nodes; the indexing
layers (the blocked closure rows of ``core.rewrite._RegionIndex``, the
Schedule-level topo/depth memos, ``dse_regions`` partitioning) exist to
scale two orders of magnitude past that.  This module generates the
graphs that prove it: deterministic, seeded, *structured* synthetic
pipelines in the 1k–10k-op range, exposed as named specs
(``synth_1k`` / ``synth_5k`` / ``synth_10k``) consumed by
the compile-time arms, the lint CLI (``repro_torch.lint``) and the tests.

Determinism contract
--------------------
``build_synth_graph(spec)`` is a pure function of the spec.  The only
randomness source is ``random.Random`` seeded from ``spec.seed`` (an
explicit field — there is deliberately no wall-clock or global-RNG
default), so the same spec yields a bit-identical graph on every call,
machine and Python run.  The tests pin this with a structure fingerprint.

Generated structure
-------------------
A spec describes ``n_chains`` parallel transformer-ish pipelines built
**chain-major** (all of chain 0, then chain 1, …).  Chain-major layout
matters: the closure rows of ``_RegionIndex`` index tasks by program
position, so keeping each chain's ops contiguous keeps every
reachability row a handful of dense 64-bit blocks instead of one bit
per block — the blocked representation's best case, and the layout real
unrolled pipelines exhibit anyway.

Each chain is a non-uniform stack of layer blocks drawn by the seeded
RNG:

* ``mlp`` — norm → matmul → activation → matmul → residual (the fusion
  patterns collapse it to ~2 tasks, like a real FFN);
* ``glu`` — norm → gate/up matmuls → elementwise gate → down matmul →
  residual (a diamond);
* ``composite`` — a PolyBench-style 3mm diamond (two independent
  matmuls feeding a combine and a third matmul);
* ``moe`` — router → ``moe_dispatch`` fanning out to ``n_experts``
  *separate* expert matmuls → ``moe_combine`` fan-in (the widest
  structural fan-out in the suite).

Chains cross-link sparsely: every ``cross_every`` layers a chain's
residual additionally reads the *previous* chain's trunk at the same
depth — but only within groups of ``group_size`` chains, so the links
never compose transitively across the whole graph.  The result is a
band-limited closure (a task's reachable cone spreads sideways at most
``group_size - 1`` chains) while still denying the partitioner a
trivial per-chain cut.  A final elementwise join over all chain trunks
makes the graph single-output.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from .ir import AccessMap, Graph

BF = "bf16"

__all__ = ["SynthSpec", "SYNTH_CONFIGS", "build_synth_graph",
           "get_synth", "list_synths"]


@dataclass(frozen=True)
class SynthSpec:
    """One synthetic scale-stress configuration (pure data, hashable)."""

    name: str
    #: explicit RNG seed — the *only* randomness source of the builder.
    seed: int
    #: target op count; the generated graph lands within ~15% of it
    #: (chains are non-uniform by design, so the total is approximate).
    n_ops: int
    #: parallel pipeline chains (graph width).
    n_chains: int = 32
    #: a chain's residual reads its left neighbour every this many
    #: layers (0 disables cross-links entirely).
    cross_every: int = 8
    #: chains are cross-linked only within groups of this many: chain k
    #: reads chain k-1 unless k opens a new group.  Without the bound the
    #: links compose transitively (0→1→…→n_chains) and every early
    #: chain's reachability cone spans the whole graph — closure rows,
    #: fuse folds and region crossings all go superlinear.  Grouping
    #: keeps cones band-limited (the realistic shape: real models share
    #: within a block, not across the entire network) while still
    #: denying the partitioner a trivial per-chain cut.
    group_size: int = 4
    #: every this many layers a chain emits an MoE fan-out block
    #: (0 disables).
    moe_every: int = 0
    #: every this many layers a chain emits a PolyBench-style composite
    #: (0 disables).
    composite_every: int = 0
    #: expert fan-out width of the MoE blocks.
    n_experts: int = 8
    batch: int = 8
    seq: int = 1024
    d_model: int = 1024


#: Named presets — the scale ladder the bench arms and tests consume.
#: 1k is the tier-1 smoke (fast lane), 5k carries the <20 s / <2 MB
#: acceptance gate, 10k is the headroom arm (slow lane only).
SYNTH_CONFIGS: dict[str, SynthSpec] = {
    "synth_1k": SynthSpec("synth_1k", seed=11, n_ops=1000, n_chains=12,
                          cross_every=6, moe_every=7, composite_every=5,
                          n_experts=8),
    "synth_5k": SynthSpec("synth_5k", seed=13, n_ops=5000, n_chains=48,
                          cross_every=8, moe_every=9, composite_every=6,
                          n_experts=8),
    "synth_10k": SynthSpec("synth_10k", seed=17, n_ops=10000, n_chains=80,
                           cross_every=8, moe_every=9, composite_every=6,
                           n_experts=8),
}


def list_synths() -> list[str]:
    return list(SYNTH_CONFIGS)


def get_synth(name: str) -> Graph:
    """Build the named preset (``synth_1k`` / ``synth_5k`` / ``synth_10k``)."""
    if name not in SYNTH_CONFIGS:
        raise KeyError(f"unknown synth config {name!r}; "
                       f"known: {list_synths()}")
    return build_synth_graph(SYNTH_CONFIGS[name])


# -- layer-block emitters ----------------------------------------------------
# Each emitter appends the block's ops to ``g`` and returns the new trunk
# value name.  ``extra`` carries the optional cross-link input into the
# residual.  Hidden dims are named by size (``d_ff2048`` …) so equal
# sizes share one plan rule and unequal sizes never collide.

def _mlp(g: Graph, pre: str, trunk: str, B: int, S: int, D: int,
         F: int, extra: list[str]) -> str:
    fd = f"d_ff{F}"
    g.tensor(f"{pre}_xn", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("norm", [trunk], [f"{pre}_xn"], {"batch": B, "seq": S,
         "d_model": D}, flops=5 * B * S * D, name=f"{pre}_norm",
         reduce=("d_model",))
    g.tensor(f"{pre}_w1", (D, F), BF, ("d_model", fd), is_weight=True)
    g.tensor(f"{pre}_h", (B, S, F), BF, ("batch", "seq", fd))
    g.op("matmul", [f"{pre}_xn", f"{pre}_w1"], [f"{pre}_h"],
         {"batch": B, "seq": S, "d_model": D, fd: F},
         flops=2 * B * S * D * F, name=f"{pre}_mm1")
    g.tensor(f"{pre}_ha", (B, S, F), BF, ("batch", "seq", fd))
    g.op("activation", [f"{pre}_h"], [f"{pre}_ha"],
         {"batch": B, "seq": S, fd: F}, flops=B * S * F,
         name=f"{pre}_act")
    g.tensor(f"{pre}_w2", (F, D), BF, (fd, "d_model"), is_weight=True)
    g.tensor(f"{pre}_o", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("matmul", [f"{pre}_ha", f"{pre}_w2"], [f"{pre}_o"],
         {"batch": B, "seq": S, fd: F, "d_model": D},
         flops=2 * B * S * F * D, name=f"{pre}_mm2")
    g.tensor(f"{pre}_r", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("residual", [f"{pre}_o", trunk] + extra, [f"{pre}_r"],
         {"batch": B, "seq": S, "d_model": D}, flops=B * S * D,
         name=f"{pre}_res")
    return f"{pre}_r"


def _glu(g: Graph, pre: str, trunk: str, B: int, S: int, D: int,
         F: int, extra: list[str]) -> str:
    fd = f"d_ff{F}"
    g.tensor(f"{pre}_xn", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("norm", [trunk], [f"{pre}_xn"], {"batch": B, "seq": S,
         "d_model": D}, flops=5 * B * S * D, name=f"{pre}_norm",
         reduce=("d_model",))
    for arm in ("gate", "up"):
        g.tensor(f"{pre}_w_{arm}", (D, F), BF, ("d_model", fd),
                 is_weight=True)
        g.tensor(f"{pre}_{arm}", (B, S, F), BF, ("batch", "seq", fd))
        g.op("matmul", [f"{pre}_xn", f"{pre}_w_{arm}"], [f"{pre}_{arm}"],
             {"batch": B, "seq": S, "d_model": D, fd: F},
             flops=2 * B * S * D * F, name=f"{pre}_mm_{arm}")
    g.tensor(f"{pre}_h", (B, S, F), BF, ("batch", "seq", fd))
    g.op("elementwise", [f"{pre}_gate", f"{pre}_up"], [f"{pre}_h"],
         {"batch": B, "seq": S, fd: F}, flops=2 * B * S * F,
         name=f"{pre}_glu")
    g.tensor(f"{pre}_w2", (F, D), BF, (fd, "d_model"), is_weight=True)
    g.tensor(f"{pre}_o", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("matmul", [f"{pre}_h", f"{pre}_w2"], [f"{pre}_o"],
         {"batch": B, "seq": S, fd: F, "d_model": D},
         flops=2 * B * S * F * D, name=f"{pre}_mm2")
    g.tensor(f"{pre}_r", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("residual", [f"{pre}_o", trunk] + extra, [f"{pre}_r"],
         {"batch": B, "seq": S, "d_model": D}, flops=B * S * D,
         name=f"{pre}_res")
    return f"{pre}_r"


def _composite(g: Graph, pre: str, trunk: str, B: int, S: int, D: int,
               F: int, extra: list[str]) -> str:
    """PolyBench 3mm-style diamond: two independent matmuls from the
    trunk, an elementwise combine, a third matmul back to d_model."""
    cd = f"d_cmp{F}"
    for arm in ("a", "b"):
        g.tensor(f"{pre}_w_{arm}", (D, F), BF, ("d_model", cd),
                 is_weight=True)
        g.tensor(f"{pre}_{arm}", (B, S, F), BF, ("batch", "seq", cd))
        g.op("matmul", [trunk, f"{pre}_w_{arm}"], [f"{pre}_{arm}"],
             {"batch": B, "seq": S, "d_model": D, cd: F},
             flops=2 * B * S * D * F, name=f"{pre}_mm_{arm}")
    g.tensor(f"{pre}_c", (B, S, F), BF, ("batch", "seq", cd))
    g.op("elementwise", [f"{pre}_a", f"{pre}_b"], [f"{pre}_c"],
         {"batch": B, "seq": S, cd: F}, flops=B * S * F,
         name=f"{pre}_combine")
    g.tensor(f"{pre}_w_c", (F, D), BF, (cd, "d_model"), is_weight=True)
    g.tensor(f"{pre}_o", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("matmul", [f"{pre}_c", f"{pre}_w_c"], [f"{pre}_o"],
         {"batch": B, "seq": S, cd: F, "d_model": D},
         flops=2 * B * S * F * D, name=f"{pre}_mm_c")
    g.tensor(f"{pre}_r", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("residual", [f"{pre}_o", trunk] + extra, [f"{pre}_r"],
         {"batch": B, "seq": S, "d_model": D}, flops=B * S * D,
         name=f"{pre}_res")
    return f"{pre}_r"


def _moe(g: Graph, pre: str, trunk: str, B: int, S: int, D: int,
         E: int, extra: list[str]) -> str:
    """Structural MoE fan-out: the dispatch writes one buffer *per
    expert* and each expert is its own matmul op — unlike the batched
    expert dim of the real LM builder, this stresses graph width (fan-out
    E, fan-in E) rather than a single fat op."""
    cap = max(1, (B * S * 2) // E)
    g.tensor(f"{pre}_xn", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("norm", [trunk], [f"{pre}_xn"], {"batch": B, "seq": S,
         "d_model": D}, flops=5 * B * S * D, name=f"{pre}_norm",
         reduce=("d_model",))
    g.tensor(f"{pre}_w_r", (D, E), "f32", ("d_model", "experts"),
             is_weight=True)
    g.tensor(f"{pre}_logits", (B, S, E), "f32",
             ("batch", "seq", "experts"))
    g.op("matmul", [f"{pre}_xn", f"{pre}_w_r"], [f"{pre}_logits"],
         {"batch": B, "seq": S, "d_model": D, "experts": E},
         flops=2 * B * S * D * E, name=f"{pre}_router")
    disp = []
    for e in range(E):
        g.tensor(f"{pre}_d{e}", (cap, D), BF, ("cap", "d_model"))
        disp.append(f"{pre}_d{e}")
    g.op("moe_dispatch", [f"{pre}_xn", f"{pre}_logits"], disp,
         {"cap": cap, "d_model": D}, flops=B * S * D,
         name=f"{pre}_dispatch",
         access={f"{pre}_xn": AccessMap.of(("batch", 1), (None, 1),
                                           ("d_model", 1)),
                 f"{pre}_logits": AccessMap.of(("batch", 1), (None, 1),
                                               (None, 1))})
    outs = []
    for e in range(E):
        g.tensor(f"{pre}_we{e}", (D, D), BF, ("d_model", "d_model"),
                 is_weight=True)
        g.tensor(f"{pre}_eo{e}", (cap, D), BF, ("cap", "d_model"))
        g.op("matmul", [f"{pre}_d{e}", f"{pre}_we{e}"], [f"{pre}_eo{e}"],
             {"cap": cap, "d_model": D}, flops=2 * cap * D * D,
             name=f"{pre}_exp{e}")
        outs.append(f"{pre}_eo{e}")
    g.tensor(f"{pre}_comb", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("moe_combine", outs + [f"{pre}_logits"], [f"{pre}_comb"],
         {"batch": B, "seq": S, "d_model": D}, flops=B * S * D,
         name=f"{pre}_combine",
         access={f"{pre}_logits": AccessMap.of(("batch", 1), ("seq", 1),
                                               (None, 1))})
    g.tensor(f"{pre}_r", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("residual", [f"{pre}_comb", trunk] + extra, [f"{pre}_r"],
         {"batch": B, "seq": S, "d_model": D}, flops=B * S * D,
         name=f"{pre}_res")
    return f"{pre}_r"


#: mean ops per layer block across the kind mix — used only to size the
#: per-chain layer budget from ``n_ops``.
_OPS_PER_LAYER = 5.6


def build_synth_graph(spec: SynthSpec) -> Graph:
    """Deterministically build the synthetic graph described by ``spec``.

    Pure function of the spec (see the module docstring's determinism
    contract); the op/value orders are generation order, so the structure
    fingerprint is stable across calls."""
    g = Graph(spec.name)
    B, S, D = spec.batch, spec.seq, spec.d_model
    ff_sizes = (2 * D, 3 * D, 4 * D)

    base_layers = max(2.0, spec.n_ops / spec.n_chains / _OPS_PER_LAYER)
    finals: list[str] = []
    # trunk value of (chain, layer) — the cross-link source; only the
    # previous chain's entries are ever read, but keeping all of them is
    # simpler and the dict dies with this call.
    trunk_at: dict[tuple[int, int], str] = {}
    ops_left = spec.n_ops
    for k in range(spec.n_chains):
        rng = random.Random(spec.seed * 1_000_003 + k)
        n_layers = max(2, round(base_layers * rng.uniform(0.7, 1.3)))
        g.tensor(f"c{k}_x", (B, S, D), BF, ("batch", "seq", "d_model"),
                 is_input=True)
        trunk = f"c{k}_x"
        for j in range(n_layers):
            if ops_left <= 0 and j >= 2:
                break  # global budget hit; keep the 2-layer minimum
            extra: list[str] = []
            if (spec.cross_every and k > 0
                    and (spec.group_size <= 0
                         or k % spec.group_size != 0)
                    and j % spec.cross_every == k % spec.cross_every
                    and (k - 1, j) in trunk_at):
                extra = [trunk_at[(k - 1, j)]]
            pre = f"c{k}_l{j}"
            n_before = len(g.ops)
            if spec.moe_every and j % spec.moe_every == spec.moe_every - 1:
                trunk = _moe(g, pre, trunk, B, S, D, spec.n_experts,
                             extra)
            elif (spec.composite_every
                    and j % spec.composite_every
                    == spec.composite_every - 1):
                trunk = _composite(g, pre, trunk, B, S, D,
                                   rng.choice(ff_sizes) // 2, extra)
            elif rng.random() < 0.35:
                trunk = _glu(g, pre, trunk, B, S, D,
                             rng.choice(ff_sizes), extra)
            else:
                trunk = _mlp(g, pre, trunk, B, S, D,
                             rng.choice(ff_sizes), extra)
            trunk_at[(k, j)] = trunk
            ops_left -= len(g.ops) - n_before
        finals.append(trunk)

    g.tensor("synth_out", (B, S, D), BF, ("batch", "seq", "d_model"))
    g.op("elementwise", finals, ["synth_out"],
         {"batch": B, "seq": S, "d_model": D},
         flops=B * S * D * len(finals), name="join")
    g.outputs = ["synth_out"]
    return g
