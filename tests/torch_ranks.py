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


def main() -> None:
    mode, rank, world, rdv, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    try:
        spec = json.loads(Path(src).read_text())
        body = {"mesh": mesh_body, "train": train_body}[mode]
        result = body(rank, spec)
    finally:
        dist.destroy_process_group()
    Path(dst).write_text(json.dumps(result))


if __name__ == "__main__":
    main()
