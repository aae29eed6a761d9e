"""Inspect HIDA-OPT pass by pass: the paper's pipeline made visible.  The
port's counterpart of ``examples/autoshard_inspect.py``, on the port's
compiler (``repro_torch.core``), whose plans equal the reference's.  It
runs on the host only: the compiler touches no device.

    PYTHONPATH=src python -m repro_torch.examples.autoshard_inspect \\
        --arch deepseek-v3-671b --shape train_4k [--multi-pod] [--ablate]
"""
from __future__ import annotations

import argparse

from ..configs import SHAPES, get_config, list_archs
from ..core import MULTI_POD, SINGLE_POD, build_lm_graph, optimize


def show(arch, shape_name, mesh, ia=True, ca=True, label="IA+CA"):
    cfg = get_config(arch)
    g = build_lm_graph(cfg, SHAPES[shape_name])
    sched, plan, rep = optimize(g, mesh, ia=ia, ca=ca,
                                training=SHAPES[shape_name].mode == "train")
    print(f"\n==== {label}: {arch} x {shape_name} ====")
    print(f"[1-2] construct+fuse: {rep.fusion.pattern_fusions} pattern + "
          f"{rep.fusion.balance_fusions} balance fusions "
          f"-> {len(sched.nodes)} Structural nodes")
    print(f"[3]   multi-producer: {rep.multi_producer.duplicated} buffers "
          f"duplicated, {rep.multi_producer.copies} copies, "
          f"{rep.multi_producer.merged} producers merged")
    print(f"[4]   path balancing: {rep.balance.copy_nodes} skid buffers, "
          f"{rep.balance.soft_fifos} soft FIFOs "
          f"(max skew {rep.balance.max_skew})")
    print(f"[5]   IA+CA parallelization: {rep.parallelize.evaluated} "
          f"proposals, {rep.parallelize.rejected_constraint} rejected by "
          f"divisibility (CA), order={rep.parallelize.order[:4]}...")
    print(f"      rules: {dict(sorted(plan.rules.items()))}")
    print(f"      estimate: {rep.cost.total_s*1e3:.2f} ms/iter, "
          f"critical node {rep.cost.critical_s*1e3:.2f} ms, "
          f"dominant={rep.cost.dominant}, "
          f"hbm={rep.cost.hbm_bytes_per_device/2**30:.2f} GiB/dev")
    return rep


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v3-671b",
                    choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ablate", action="store_true",
                    help="also run the IA / CA / naive arms (Fig. 11)")
    args = ap.parse_args(argv)
    mesh = MULTI_POD if args.multi_pod else SINGLE_POD

    base = show(args.arch, args.shape, mesh)
    if args.ablate:
        for label, ia, ca in (("IA-only", True, False),
                              ("CA-only", False, True),
                              ("naive", False, False)):
            rep = show(args.arch, args.shape, mesh, ia, ca, label)
            print(f"      vs IA+CA: "
                  f"{rep.cost.total_s/base.cost.total_s:.2f}x time, "
                  f"{rep.cost.hbm_bytes_per_device / max(base.cost.hbm_bytes_per_device,1):.2f}x HBM")


if __name__ == "__main__":
    main()
