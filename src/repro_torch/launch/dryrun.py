"""Multi-pod dry-run: the port's counterpart of ``repro.launch.dryrun``.

For each (architecture × input shape) cell, the real train step (train
shapes) or serving step (prefill / decode shapes) runs against the
production mesh (16×16, or 2×16×16 multi-pod) under the cell's HIDA
plan, with every input a fake tensor: ``FakeTensorMode`` over a fake
process group of that many ranks (backend ``"fake"``, its store from
``torch.testing``), so nothing is allocated and nothing is computed.
The reference compiles the step for as many forced host devices and
reads XLA's analyses; the port runs it once as rank 0 and counts:

* ``memory_analysis``: ``argument_size_in_bytes`` the local shards of
  params, optimizer state, batch and caches; ``temp_size_in_bytes`` the
  peak of what the step allocates
  (``torch.distributed._tools.mem_tracker.MemTracker``); the step's
  returned tensors as ``alias_size_in_bytes`` where they are its
  arguments (updated in place), ``output_size_in_bytes`` otherwise;
* ``cost_analysis.flops``: per-rank FLOPs by
  ``torch.utils.flop_counter``'s formulas (``comm_analysis``);
* ``collectives``: collective bytes by kind (``comm_analysis``; every
  layer is seen, so ``loop_trip`` is 1), and ``hlo_ops``: the aten
  operations it ran, by count (the port has no HLO);
  ``collective_operand_bytes``, the port's own key: the bytes of each
  kind's operands, so that a reduce-scatter compares with the
  all-reduce that the reference's host lowering puts in its place;
* ``analytic_flops``, ``model_flops_6nd``, ``plan_rules``, ``fsdp`` and
  the ``hida`` report, as the reference records them;
* ``lower_s``: building the step and placing its inputs; ``compile_s``:
  the fake run.

These are counts of the port's program on fake tensors, not times or
memory measured on a card.  Artifacts land in
``build/dryrun/<arch>__<shape>__<mesh>.json``.  A cell that raises is
recorded as ``failed`` with its traceback: a failure here is a bug in
the system.

Usage (the world size is fixed when the fake group starts, as XLA's
device count is, so the CLI refuses to run where a process group already
exists):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--multi-pod] [--all] [--strategy hida|naive|...]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..core import MULTI_POD, SINGLE_POD, MeshSpec, build_lm_graph, optimize
from ..core.graph import model_flops_6nd, step_flops
from ..core.plan import ShardingPlan, replicated_plan
from .comm_analysis import StepCounter, shape_propagation_unseen
from .mesh import set_mesh
from .steps import (_map_tree, batch_specs, build_prefill_step,
                    build_serve_step, build_train_step, distribute_tree,
                    sharding_tree)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: where the fake tensors live (no memory is allocated on it)
DEVICE = "cpu"


def make_plan(arch: str, shape_name, multi_pod: bool,
              strategy: str = "hida", fsdp: bool | None = None, *,
              mesh_spec: MeshSpec | None = None, smoke: bool = False):
    """(cfg, shape, plan, report) of a cell: the HIDA plan of the
    strategy (``naive``: replicated, no report) on the production mesh
    spec, or on ``mesh_spec``."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mspec = mesh_spec or (MULTI_POD if multi_pod else SINGLE_POD)
    if fsdp is None:
        # big configs need ZeRO-3 params/opt sharding to fit in HBM
        fsdp = shape.mode == "train"
    if strategy == "naive":
        return cfg, shape, replicated_plan(mspec, fsdp=fsdp), None
    ia = strategy in ("hida", "ia")
    ca = strategy in ("hida", "ca")
    _, plan, report = optimize(build_lm_graph(cfg, shape), mspec, ia=ia,
                               ca=ca, fsdp=fsdp,
                               training=shape.mode == "train")
    return cfg, shape, plan, report


def _fake_group(world: int) -> bool:
    """A fake process group of ``world`` ranks, this process rank 0;
    ``True`` if it was made here.  An existing group must be a fake one
    of that size."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; the dry-run needs "
                f"a fake group of {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def _placed(meta_tree, shardings):
    """Fake tensors of ``meta_tree``'s shapes and dtypes, placed by
    ``shardings`` (run under ``FakeTensorMode``)."""
    fake = _map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device=DEVICE),
                     meta_tree, is_leaf=torch.is_tensor)
    return distribute_tree(fake, shardings)


def _leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(t: torch.Tensor) -> int:
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


def _run_step(cfg, shape, mesh, plan, remat: str, accum_steps: int):
    """Build the cell's step, place its fake inputs and run it once under
    the counters; returns (args, outputs, counter, peak bytes, build s,
    run s)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.perf_counter()
    if shape.mode == "train":
        step = build_train_step(cfg, remat=remat, accum_steps=accum_steps,
                                device=DEVICE, graphs=False, plan=plan,
                                mesh=mesh)
        params_abs, dims = step.lm.init_abstract()
        bspecs, bdims = batch_specs(cfg, shape)
        params = _placed(params_abs, sharding_tree(
            dims, mesh, plan, weight=True, shapes_tree=params_abs))
        with set_mesh(mesh):
            opt_state = step.opt.init(params)
        args = (params, opt_state,
                _placed(bspecs, sharding_tree(bdims, mesh, plan)))

        def fn():
            with set_mesh(mesh):
                return step.fn(*args)
    elif shape.mode == "prefill":
        fn_, abstract, shardings = build_prefill_step(cfg, shape, mesh,
                                                      plan, device=DEVICE)
        args = tuple(_placed(a, s) for a, s in zip(abstract, shardings))

        def fn():
            return fn_(*args)
    else:
        step = build_serve_step(cfg, shape, mesh, plan, device=DEVICE)
        args = tuple(_placed(a, s) for a, s in zip(step.abstract_inputs,
                                                    step.shardings))

        def fn():
            return step.decode(*args)
    t_build = time.perf_counter() - t0
    counter = StepCounter()
    tracker = MemTracker()
    with shape_propagation_unseen(), tracker, counter:
        out = fn()
    peak = sum(v.get("Total", 0) for v in
               tracker.get_tracker_snapshot("peak").values())
    return args, out, counter, peak, t_build, \
        time.perf_counter() - t0 - t_build


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             strategy: str = "hida", save: bool = True,
             remat: str = "full", accum_steps: int = 1, *,
             mesh_axes: tuple | None = None, smoke: bool = False,
             plan: ShardingPlan | None = None) -> dict:
    """One cell's record (see the module docstring).  ``mesh_axes``
    ((name, size), ...) replaces the production mesh, ``smoke`` the
    config by its smoke config, and ``plan`` the HIDA plan (then the
    record has no ``hida`` report)."""
    mspec = MeshSpec(tuple(mesh_axes)) if mesh_axes else None
    if plan is None:
        cfg, shape, plan, report = make_plan(arch, shape_name, multi_pod,
                                             strategy, mesh_spec=mspec,
                                             smoke=smoke)
    else:
        cfg = get_config(arch, smoke=smoke)
        shape = SHAPES[shape_name] if isinstance(shape_name, str) \
            else shape_name
        report = None
    axes = tuple(plan.mesh_spec.axes)
    mesh_name = "x".join(str(s) for _, s in axes)
    result = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
              "strategy": strategy, "status": "ok"}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        if save:
            _save(result)
        return result

    chips = math.prod(s for _, s in axes)
    made = _fake_group(chips)
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(DEVICE, tuple(s for _, s in axes),
                                mesh_dim_names=tuple(a for a, _ in axes))
        # real constants (a cached RoPE table) join as fake tensors
        with FakeTensorMode(allow_non_fake_inputs=True):
            args, out, counter, peak, t_build, t_run = _run_step(
                cfg, shape, mesh, plan, remat, accum_steps)
            arg_leaves = _leaves(args)
            arg_ids = {id(t) for t in arg_leaves}
            outs = _leaves(out)
            arg_bytes = sum(_local_bytes(t) for t in arg_leaves)
            alias = sum(_local_bytes(t) for t in outs if id(t) in arg_ids)
            out_bytes = sum(_local_bytes(t) for t in outs
                            if id(t) not in arg_ids)
        g = build_lm_graph(cfg, shape)
        tokens = shape.global_batch * (1 if shape.mode == "decode"
                                       else shape.seq_len)
        result.update({
            "analytic_flops": step_flops(g, shape.mode),
            "model_flops_6nd": model_flops_6nd(
                cfg, tokens) * (1.0 if shape.mode == "train" else 1 / 3),
            "loop_trip": 1,
            "chips": chips,
            "lower_s": round(t_build, 2),
            "compile_s": round(t_run, 2),
            "memory_analysis": {
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": int(peak),
                "generated_code_size_in_bytes": 0,
                "alias_size_in_bytes": alias},
            "cost_analysis": {"flops": float(counter.flops)},
            "collectives": counter.stats.to_dict(1),
            "collective_operand_bytes": dict(counter.operand_bytes),
            "hlo_ops": counter.op_histogram(top=12),
            "plan_rules": {k: list(v) for k, v in plan.rules.items()},
            "fsdp": plan.fsdp,
        })
        if report is not None:
            result["hida"] = {
                "nodes": report.meta.get("nodes"),
                "estimated_total_s": report.cost.total_s,
                "estimated_critical_s": report.cost.critical_s,
                "estimated_dominant": report.cost.dominant,
                "opt_time_s": round(report.compile_time_s, 2),
            }
    except Exception as e:  # a failure here is a bug in the system
        result.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    finally:
        if made:
            dist.destroy_process_group()
    if save:
        _save(result)
    return result


def _save(result: dict) -> None:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    name = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
            + (f"__{result['strategy']}" if result.get("strategy", "hida")
               != "hida" else "") + ".json")
    (ARTIFACT_DIR / name).write_text(json.dumps(result, indent=2))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch, shape) cell")
    ap.add_argument("--strategy", default="hida",
                    choices=("hida", "naive", "ia", "ca"))
    ap.add_argument("--remat", default="full",
                    choices=("full", "none", "dots"))
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    args = ap.parse_args(argv)
    if dist.is_initialized():
        raise SystemExit("dryrun: a process group already exists; the "
                         "dry-run starts its own fake group of the mesh's "
                         "size")

    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, multi_pod=mp,
                             strategy=args.strategy, remat=args.remat,
                             accum_steps=args.accum)
                status = r["status"]
                line = f"{arch:22s} {shape:12s} {r['mesh']:8s} {status}"
                if status == "ok":
                    mem = r["memory_analysis"]
                    per_dev = (mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"])
                    line += (f" args+temp={per_dev / 2**30:.2f}GiB/rank"
                             f" flops={r['cost_analysis']['flops']:.3g}"
                             f" coll={r['collectives']['total_bytes'] / 2**30:.3f}GiB"
                             f" run={r['compile_s']:.1f}s (fake tensors)")
                elif status == "failed":
                    failures += 1
                    line += f"  {r['error'][:120]}"
                print(line, flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
