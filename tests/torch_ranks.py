"""One rank of a multi-rank CPU test of the PyTorch port, over gloo.

    python tests/torch_ranks.py MODE RANK WORLD RENDEZVOUS_FILE IN.json OUT.json

The test starts WORLD of these with ``PYTHONPATH=src``; they meet at a
file rendezvous, run MODE's body on the port alone (no JAX), and write
what they found to OUT.json.  Modes:

* ``mesh``: the plans' layouts on a ``(2, 2)`` ``DeviceMesh``
  (``tests/test_torch_mesh.py``): every param and cache leaf of IN.json's
  smoke configs under their ``(2, 2)`` plans with FSDP (the train
  shape's for params, the decode shape's for caches), its hand-written
  specs and its ``constrain`` cases, each distributed from a full tensor
  of distinct values; each local shard is held against the slice that
  the reference's ``NamedSharding`` gives this rank (IN.json's
  ``slices``, computed by the test in a JAX process).
* ``train``: ``repro_torch.launch.train.main`` on each of IN.json's
  argvs in turn (``tests/test_torch_train_driver.py``); their losses.
* ``ep``: the expert-parallel MoE and ``LM(mesh=...)`` on a ``(2, 2)``
  mesh against the reference's (``tests/test_torch_ep.py``).
* ``compress``: ``dp_allreduce_compressed`` over the world
  (``tests/test_torch_compression.py``).
* ``gpipe``: ``gpipe`` over a ``("pod",)`` mesh of the world
  (``tests/test_torch_gpipe.py``).
* ``ep_serve``: a DeepSeek model served expert-parallel over an
  ``("experts",)`` mesh of the world (``LM(experts=...)``), each rank
  holding its share of the experts drawn by the benchmark's rule, against
  the plain reference ``cardbench/reference/deepseek_v2.py`` computed in
  the rank (``tests/test_torch_ep_serve.py``): every position's logits of
  decode steps through the latent cache, the full-sequence prefill's last
  logits, and one MoE layer's experts rank by rank.
* ``layouts``: an LM's loss and gradients on a ``(2, 2)`` mesh, its
  params and batch placed by each of IN.json's hand-written plans (FSDP
  on), against the same LM without a mesh
  (``tests/test_torch_layouts.py``).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parent.parent / "src"


def spawn(mode: str, world: int, spec: dict, directory: Path,
          timeout: float = 300.0) -> list:
    """Run ``world`` ranks of ``mode`` on ``spec`` (rendezvous and files
    in ``directory``); every rank must exit 0.  Returns their results in
    rank order."""
    directory.mkdir(parents=True, exist_ok=True)
    src = directory / "in.json"
    src.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    outs = [directory / f"out{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world),
         str(directory / "rendezvous"), str(src), str(outs[r])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            + log[-4000:]
    return [json.loads(o.read_text()) for o in outs]


def flatten(tree, is_leaf, path: str = "") -> list:
    """``(path, leaf)`` pairs of a tree of dicts and (named) tuples in
    key and field order, ``None`` skipped; the test flattens the
    reference's trees the same way."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = enumerate(tree)
    out = []
    for k, v in items:
        out += flatten(v, is_leaf, f"{path}/{k}" if path else str(k))
    return out


def mesh_body(rank: int, spec: dict) -> dict:
    """Each leaf's local shard against ``full[slices]``, the reference's
    slice for this rank; returns the leaves checked and what differed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import (MeshSpec, ShardingPlan, build_lm_graph,
                                  optimize)
    from repro_torch.core.ir import reset_fresh_names
    from repro_torch.core.plan import placements
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import distribute_tree, sharding_tree
    from repro_torch.models.lm import LM
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)

    mesh = make_host_mesh((2, 2), device="cpu")
    mspec = MeshSpec((("data", 2), ("model", 2)))
    checked: list = []
    bad: list = []

    def check(key, got_spec, dt, full, ref):
        checked.append(key)
        want = full[tuple(slice(a, b) for a, b in ref["slices"][rank])]
        if json.loads(json.dumps(got_spec)) != ref["spec"]:
            bad.append(f"{key}: spec {got_spec} != {ref['spec']}")
        if not torch.equal(dt.to_local(), want):
            bad.append(f"{key}: local {tuple(dt.to_local().shape)} is not "
                       f"the reference's slice {ref['slices'][rank]}")
        if not torch.equal(dt.full_tensor(), full):
            bad.append(f"{key}: full_tensor() differs")

    def placed_leaves(plan, tree, dims, **kw):
        fulls = _distinct(tree)
        shards = sharding_tree(dims, mesh, plan, **kw)
        placed = distribute_tree(_rebuild(tree, fulls), shards)
        return zip(flatten(placed, torch.is_tensor),
                   flatten(shards, lambda x: hasattr(x, "placements"))), \
            fulls

    for arch in spec["archs"]:
        cfg = get_config(arch, smoke=True)
        reset_fresh_names()
        g = build_lm_graph(cfg, ShapeSpec("t", spec["seq"], spec["batch"],
                                          "train"))
        _, plan, _ = optimize(g, mspec, fsdp=True)
        reset_fresh_names()
        g = build_lm_graph(cfg, ShapeSpec("d", spec["cache_len"],
                                          spec["cache_batch"], "decode"))
        _, dplan, _ = optimize(g, mspec, fsdp=True)
        lm = LM(cfg, device="cpu", plan=plan)
        params, dims = lm.init(0)
        caches = lm.init_caches(spec["cache_batch"], spec["cache_len"])
        for part, leaves in (
                ("params", placed_leaves(plan, params, dims, weight=True,
                                         shapes_tree=params)),
                ("caches", placed_leaves(dplan, caches,
                                         lm.cache_dims()))):
            pairs, fulls = leaves
            for (k, dt), (_, sh) in pairs:
                key = f"{arch}/{part}/{k}"
                if key not in spec["ref"]:
                    bad.append(f"{key}: no such leaf in the reference")
                    continue
                check(key, sh.spec, dt, fulls[k], spec["ref"][key])
    for i, case in enumerate(spec["hand"]):
        pspec = _spec(case["spec"])
        full = _full(case["shape"])
        dt = distribute_tensor(full, mesh, list(placements(mesh, pspec)))
        check(f"hand {i} {pspec}", pspec, dt, full, case)
    # constrain: a replicated DTensor redistributed to the site's
    # placements under the ambient mesh only
    for i, case in enumerate(spec["constrain"]):
        plan = ShardingPlan(mspec, rules={k: tuple(v) for k, v in
                                          case["rules"].items()})
        dims = tuple(case["dims"])
        full = _full(case["shape"])
        x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
        if plan.constrain(x, dims) is not x:
            bad.append(f"constrain {i}: not the identity outside a mesh")
        with set_mesh(mesh):
            y = plan.constrain(x, dims)
            if plan.constrain(full, dims) is not full:
                bad.append(f"constrain {i}: a plain tensor changed")
        if not isinstance(y, DTensor) or tuple(y.placements) != \
                placements(mesh, plan.spec_for_dims(dims)):
            bad.append(f"constrain {i}: placements {y.placements}")
        check(f"constrain {i}", plan.spec_for_dims(dims), y, full, case)
    return {"checked": checked, "bad": bad}


def _full(shape) -> torch.Tensor:
    """A tensor of ``shape`` whose values are distinct: 0, 1, 2, ..."""
    shape = tuple(shape)
    return torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)


def _distinct(tree) -> dict:
    return {k: _full(v.shape) for k, v in flatten(tree, torch.is_tensor)}


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _rebuild(tree, fulls: dict, path: str = ""):
    """``tree`` with each tensor leaf replaced by ``fulls[path]``."""
    if torch.is_tensor(tree):
        return fulls[path]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fulls, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    items = [_rebuild(v, fulls, f"{path}/{i}" if path else str(i))
             for i, v in enumerate(tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def train_body(rank: int, spec: dict) -> list:
    """The driver on each argv of ``spec["argvs"]`` in turn, over the
    same process group."""
    from repro_torch.launch import train
    runs = []
    for argv in spec["argvs"]:
        out = train.main(argv)
        runs.append({"losses": out["losses"], "world": out["world"],
                     "preempted_at": out.get("preempted_at"),
                     "resumed_from": out.get("resumed_from"),
                     "mesh_axes": [list(a) for a in
                                   out["plan"].mesh_spec.axes]})
    return runs


def _npz_tree(data, prefix: str, dtypes: dict) -> dict:
    """The arrays of ``data`` under ``prefix/`` as a nested dict of CPU
    tensors, each in the reference's dtype (``dtypes``; stored as f32,
    which holds bf16 values exactly)."""
    tree: dict = {}
    for key in data.files:
        if not key.startswith(prefix + "/"):
            continue
        t = torch.from_numpy(data[key])
        if dtypes.get(key) == "bfloat16":
            t = t.to(torch.bfloat16)
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def ep_body(rank: int, spec: dict) -> dict:
    """The expert-parallel MoE and ``LM(mesh=...)`` on a ``(2, 2)`` mesh
    (``tests/test_torch_ep.py``): per layout of ``spec["layouts"]``, the
    outputs and gradients with DTensor inputs (rank 0 saves them whole to
    ``spec["out"]``) and with this rank's plain blocks (held here to the
    reference's blocks); then the LM's loss and prefill logits with its
    params and batch placed by the plan, and without a mesh."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import MeshSpec, ShardingPlan
    from repro_torch.core.plan import NamedSharding, placements
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import distribute_tree, sharding_tree
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import LM

    ref = np.load(spec["npz"])
    cfg = get_config("deepseek-v2-236b", smoke=True)
    object.__setattr__(cfg.moe, "capacity_factor", spec["cf"])
    mesh = make_host_mesh((2, 2), device="cpu")
    p = _npz_tree(ref, "moe", spec["dtypes"])
    x = torch.from_numpy(ref["x"])
    ct = torch.from_numpy(ref["ct"])
    out: dict = {}
    checked, bad = [], []

    def place(t, sp):
        return NamedSharding(mesh, sp, placements(mesh, sp)).distribute(t)

    def check(key, got, want, rtol):
        checked.append(key)
        if not torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=rtol):
            err = (got.float() - want.float()).abs().max().item()
            bad.append(f"{key}: max abs err {err}")

    def noop(t, d, s=None):
        return t

    names = ("w_router", "w_in", "w_out")
    for i, (b, e, tp) in enumerate(spec["layouts"]):
        b, e = tuple(b), tuple(e)
        es = e if len(e) > 1 else e[0]
        ws = {"w_router": (), "w_shared_in": (), "w_shared_out": (),
              "w_in": (es, None, None, tp) if tp else (es,),
              "w_out": (es, tp, None) if tp else (es,)}
        xs = (b,)
        args = (cfg, b, e, (), mesh)
        # bf16 forward: DTensor inputs, then this rank's plain blocks
        dx = place(x.to(torch.bfloat16), xs)
        dp = {k: place(v, ws[k]) for k, v in p.items()}
        y, aux = tmoe.moe_ffn_ep(dx, dp, *args, tp_axis=tp)
        out[f"{i}/dtensor/y"] = y.full_tensor().float()
        out[f"{i}/dtensor/aux"] = torch.stack([a.full_tensor()
                                               for a in aux]).float()
        out[f"{i}/global/y"] = tmoe.moe_ffn(x.to(torch.bfloat16), p, cfg,
                                            noop)[0].float()
        yl, auxl = tmoe.moe_ffn_ep(dx.to_local(), {
            k: v.to_local() for k, v in dp.items()}, *args, tp_axis=tp)
        check(f"{i}/plain/y", yl,
              place(torch.from_numpy(ref[f"{i}/y"]), xs).to_local(), 2e-2)
        check(f"{i}/plain/aux", torch.stack(list(auxl)),
              torch.from_numpy(ref[f"{i}/aux"]), 2e-4)
        # f32 gradients of sum(y * ct) + 0.01 lb + 0.001 z
        p32 = {k: v.float() for k, v in p.items()}
        leaves = [place(x, xs)] + [place(p32[k], ws[k]) for k in names]
        for t in leaves:
            t.requires_grad_()
        y, aux = tmoe.moe_ffn_ep(leaves[0], {**{k: place(v, ws[k]) for
                                                k, v in p32.items()},
                                             **dict(zip(names, leaves[1:]))},
                                 *args, tp_axis=tp)
        loss = (y * place(ct, xs)).sum() + 0.01 * aux.load_balance_loss \
            + 0.001 * aux.router_z_loss
        grads = torch.autograd.grad(loss, leaves)
        for name, g in zip(("x",) + names, grads):
            out[f"{i}/g/{name}"] = g.full_tensor()
        local = [t.detach().to_local().requires_grad_() for t in leaves]
        y, aux = tmoe.moe_ffn_ep(local[0], {
            **{k: place(v, ws[k]).to_local() for k, v in p32.items()},
            **dict(zip(names, local[1:]))}, *args, tp_axis=tp)
        grads = torch.autograd.grad(
            [y, aux.load_balance_loss, aux.router_z_loss], local,
            grad_outputs=[place(ct, xs).to_local(), torch.tensor(0.01),
                          torch.tensor(0.001)])
        for name, g, sp in zip(("x",) + names, grads,
                               (xs,) + tuple(ws[k] for k in names)):
            want = place(torch.from_numpy(ref[f"{i}/g/{name}"]), sp)
            check(f"{i}/grad/{name}", g, want.to_local(), 2e-4)

    # the LM: params and batch placed by a hand-written plan
    calls = []
    orig = tmoe.moe_ffn_ep

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    tmoe.moe_ffn_ep = counted
    try:
        plan = ShardingPlan(MeshSpec((("data", 2), ("model", 2))),
                            rules={k: tuple(v)
                                   for k, v in spec["rules"].items()})
        lm = LM(cfg, plan=plan, mesh=mesh, device="cpu", remat="none")
        _, dims = lm.init_abstract()
        params = _npz_tree(ref, "lmp", spec["dtypes"])
        toks = torch.from_numpy(ref["lm/tokens"]).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        dparams = distribute_tree(params, sharding_tree(
            dims, mesh, plan, weight=True, shapes_tree=params))
        dbatch = distribute_tree(batch, sharding_tree(
            {"tokens": ("batch", "seq"), "labels": ("batch", "seq")},
            mesh, plan))
        with set_mesh(mesh):
            loss, _ = lm.loss_fn(dparams, dbatch)
            logits = lm.prefill(dparams, {"tokens": dbatch["tokens"]})
        out["lm/loss"] = loss.full_tensor()
        out["lm/logits"] = logits.full_tensor().float()
        plain = LM(cfg, device="cpu", remat="none")
        out["lm/loss_plain"] = plain.loss_fn(params, batch)[0]
        out["lm/logits_plain"] = plain.prefill(
            params, {"tokens": batch["tokens"]}).float()
    finally:
        tmoe.moe_ffn_ep = orig
    if rank == 0:
        np.savez(spec["out"], **{k: v.detach().numpy()
                                 for k, v in out.items()})
    return {"checked": checked, "bad": bad, "ep_calls": len(calls)}


def compress_body(rank: int, spec: dict) -> dict:
    """``dp_allreduce_compressed`` over the world (``tests/
    test_torch_compression.py``): this rank's gradients and residuals
    are slice ``rank`` of IN's stacked arrays; returns the mean and the
    new residuals."""
    from repro_torch.optim import EFState, dp_allreduce_compressed
    grads = {k: torch.tensor(v[rank], dtype=torch.float32)
             for k, v in spec["grads"].items()}
    res = {k: torch.tensor(v[rank], dtype=torch.float32)
           for k, v in spec["residual"].items()}
    mean, state = dp_allreduce_compressed(grads, EFState(res))
    return {"mean": {k: v.tolist() for k, v in mean.items()},
            "residual": {k: v.tolist() for k, v in state.residual.items()}}


def gpipe_body(rank: int, spec: dict) -> list:
    """``gpipe`` over a ``("pod",)`` mesh of the world's ranks
    (``tests/test_torch_gpipe.py``): ``tanh(x @ w)`` per stage on IN's
    stacked weights and microbatches; returns the outputs."""
    from repro_torch.core.pipeline import PipelineConfig, gpipe
    from repro_torch.launch.mesh import make_host_mesh
    world = dist.get_world_size()
    mesh = make_host_mesh((world,), axes=("pod",), device="cpu")
    ws = torch.tensor(spec["ws"], dtype=torch.float32)
    mb = torch.tensor(spec["mb"], dtype=torch.float32)
    run = gpipe(lambda w, x, sid: torch.tanh(x @ w),
                PipelineConfig(world, mb.shape[0]), mesh, None, None)
    return run(ws, mb).tolist()


def layouts_body(rank: int, spec: dict) -> dict:
    """``spec["arch"]``'s smoke LM (remat ``spec["remat"]``): the loss and
    every param's gradient of one seeded batch without a mesh, then on a
    ``(2, 2)`` mesh under each plan of ``spec["plans"]``; per plan, the
    loss's absolute error and the largest gradient error relative to
    that leaf's largest plain gradient."""
    from repro_torch.configs import get_config
    from repro_torch.core import MeshSpec, ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import distribute_tree, sharding_tree
    from repro_torch.models.lm import LM

    cfg = get_config(spec["arch"], smoke=True)
    mesh = make_host_mesh((2, 2), device="cpu")
    plain = LM(cfg, device="cpu", remat=spec["remat"])
    params, dims = plain.init(seed=0)
    gen = torch.Generator().manual_seed(1)
    B, S = spec["batch"], spec["seq"]
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    is_leaf = torch.is_tensor
    leaves = [t.requires_grad_() for _, t in flatten(params, is_leaf)]
    loss_p, _ = plain.loss_fn(params, batch)
    grads_p = torch.autograd.grad(loss_p, leaves)
    out = {}
    for name, rules in spec["plans"].items():
        plan = ShardingPlan(MeshSpec((("data", 2), ("model", 2))),
                            rules={k: tuple(v) for k, v in rules.items()},
                            fsdp=True)
        lm = LM(cfg, plan=plan, device="cpu", remat=spec["remat"])
        fixed = _rebuild_detached(params)
        dparams = distribute_tree(fixed, sharding_tree(
            dims, mesh, plan, weight=True, shapes_tree=fixed))
        dbatch = distribute_tree(batch, sharding_tree(
            {"tokens": ("batch", "seq"), "labels": ("batch", "seq")},
            mesh, plan))
        dleaves = [t.requires_grad_() for _, t in flatten(dparams, is_leaf)]
        with set_mesh(mesh):
            loss, _ = lm.loss_fn(dparams, dbatch)
            grads = torch.autograd.grad(loss, dleaves)
        rel = 0.0
        for g, gp in zip(grads, grads_p, strict=True):
            diff = (g.full_tensor().float() - gp.float()).abs().max()
            rel = max(rel, (diff / gp.float().abs().max().clamp(
                min=1e-12)).item())
        out[name] = {"loss": loss.full_tensor().item(),
                     "loss_plain": loss_p.item(), "grad_rel": rel}
    return out


def ep_serve_body(rank: int, spec: dict) -> dict:
    import dataclasses
    sys.path.insert(0, str(SRC.parent))
    from cardbench import harness as H
    from cardbench.reference import deepseek_v2 as D2
    from repro_torch.launch.mesh import expert_mesh, expert_share
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import LM

    arch, seed = spec["arch"], spec["seed"]
    B, L = spec["batch"], spec["length"]
    cfg = H.arch_config(arch)
    share = expert_share(expert_mesh("cpu"))
    El = share.local(cfg.moe.n_experts)
    experts = range(rank * El, (rank + 1) * El)
    lm = LM(cfg, device="cpu", experts=share)
    params = H.nest(D2.make_params(arch, seed, "cpu", experts))
    want = {p: (tuple(t.shape), t.dtype) for p, t in
            H.flatten(lm.param_shapes()).items()}
    got = {p: (tuple(t.shape), t.dtype) for p, t in
           H.flatten(params).items()}
    assert got == want, sorted(set(got.items()) ^ set(want.items()))[:4]
    ref = D2.DeepSeekV2Ref(arch, seed, "cpu")
    gen = torch.Generator().manual_seed(seed * 7 + rank)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=gen)
    out = {}
    with torch.no_grad():
        # decode steps from position 0, the static path's prefill and
        # decode, through the latent cache
        caches = lm.init_caches(B, L)
        steps = []
        for t in range(L):
            lg, caches = lm.decode_step(
                params, {"tokens": tokens[:, t:t + 1],
                         "pos": torch.tensor(t, dtype=torch.int32)}, caches)
            steps.append(lg.float())
        stepped = torch.cat(steps, 1)
        want_steps = ref.forward(tokens, "position")
        out["decode_gaps"] = (stepped - want_steps).abs().amax(-1) \
            .flatten().tolist()
        out["decode_scale"] = float(want_steps.abs().max())
        pre = lm.prefill(params, {"tokens": tokens}).float()[:, 0]
        want_pre = ref.forward(tokens, "sequence")[:, -1]
        out["prefill_gaps"] = (pre - want_pre).abs().amax(-1).tolist()
        # one MoE layer: the ranks' experts, rank by rank, and the shared
        # experts once, against the uncut layer
        pfx = "group1/b0"
        lp = {k: v[0] for k, v in params["group1"]["b0"]["ffn"].items()}
        x = torch.randn(1, B * 2, cfg.d_model,
                        generator=torch.Generator().manual_seed(seed)
                        ).to(torch.bfloat16)
        alone = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared=0))
        parts = []
        for r in range(share.size):
            pr = dict(lp, w_out=lp["w_out"] if r == rank
                      else torch.zeros_like(lp["w_out"]))
            parts.append(tmoe.moe_ffn_serve_ep(x, pr, alone, share)[0])
        whole = tmoe.moe_ffn_serve_ep(x, lp, cfg, share)[0]
        summed = sum(p.float() for p in parts) \
            + tmoe._shared_experts(x, lp).float()
        w = ref.weights(pfx, 0)
        uncut = ref.moe(x.float(), w, "sequence") + ref.swiglu(
            x.float(), w["ffn/w_shared_in"], w["ffn/w_shared_out"])
        out["shares_gap"] = float((summed - uncut).abs().max())
        out["shares_whole_gap"] = float((summed - whole.float()).abs()
                                        .max())
        out["moe_scale"] = float(uncut.abs().max())
    return out


def _rebuild_detached(tree):
    if isinstance(tree, dict):
        return {k: _rebuild_detached(v) for k, v in tree.items()}
    return tree.detach()


def main() -> None:
    mode, rank, world, rdv, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    try:
        spec = json.loads(Path(src).read_text())
        body = {"mesh": mesh_body, "train": train_body, "ep": ep_body,
                "compress": compress_body, "gpipe": gpipe_body,
                "layouts": layouts_body, "ep_serve": ep_serve_body}[mode]
        result = body(rank, spec)
    finally:
        dist.destroy_process_group()
    Path(dst).write_text(json.dumps(result))


if __name__ == "__main__":
    main()
