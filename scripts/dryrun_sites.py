#!/usr/bin/env python3
"""Where a dry-run cell's temp and collectives come from, by site.

    PYTHONPATH=src python3 scripts/dryrun_sites.py [--src DIR] [--cell reduced|train_4k]

Runs one cell of ``repro_torch.launch.dryrun`` (fake tensors over a fake
process group, nothing allocated; no card needed) with two extra
dispatch modes:

- in place of ``MemTracker``, a tracker of the storages each operation
  creates; at its peak it keeps, per (operation, site), the bytes then
  alive;
- beside ``StepCounter``, a tally of each collective's count and result
  bytes per (kind, site).

A site is the innermost three ``repro_torch`` frames of the call, or in
the backward the autograd node that runs and the frames of the forward
call that made it (``torch.autograd.set_detect_anomaly`` records them).
``--src`` is the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's), so a parent's tree can be read the same way.  Cells:
``reduced`` is smollm-135m at ``ShapeSpec("t", 512, 16, "train")`` on a
(4, 2) mesh (the cell ``tests/test_torch_dryrun.py`` holds to the
reference), ``train_4k`` smollm-135m on the 16x16 mesh.
"""
from __future__ import annotations

import argparse
import re
import sys
import traceback
import weakref
from collections import Counter
from pathlib import Path

TOP = 15


def _site() -> str:
    import torch
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_", "")
        tb = "".join(tb) if isinstance(tb, list) else str(tb)
        locs = re.findall(r'repro_torch/([\w/]+\.py)", line (\d+)', tb)
        return node.name() + " @ " + " < ".join(
            f"{f}:{n}" for f, n in locs[::-1][:3])
    frames = [f for f in traceback.extract_stack()[:-3]
              if "repro_torch" in f.filename
              and "comm_analysis" not in f.filename]
    return " < ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                      for f in frames[-3:][::-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--cell", default="reduced",
                    choices=("reduced", "train_4k"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch
    import torch.distributed._tools.mem_tracker as mem_tracker
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.weak import WeakIdKeyDictionary

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import comm_analysis, dryrun

    class Storages(TorchDispatchMode):
        """Bytes of live storages; at the peak, by (operation, site)."""

        def __init__(self):
            super().__init__()
            self.live = WeakIdKeyDictionary()
            self.now = self.peak = 0
            self.at_peak: Counter = Counter()
            self.coll: dict = {}

        def _free(self, n):
            self.now -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if isinstance(func, torch._ops.HigherOrderOperator):
                return out
            kind = comm_analysis.collective_kind(func)
            if kind is not None:
                ns = func._schema.name.partition("::")[0]
                key = (kind, _site())
                n, b = self.coll.get(key, (0, 0))
                self.coll[key] = (n + 1, b + comm_analysis._nbytes(
                    args[0] if ns == "c10d" else out))
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                if st in self.live:
                    continue
                n = st.nbytes()
                self.live[st] = (n, str(func.overloadpacket), _site())
                self.now += n
                weakref.finalize(st, self._free, n)
            if self.now > self.peak:
                self.peak = self.now
                self.at_peak = Counter()
                for n, op, where in list(self.live.values()):
                    self.at_peak[(op, where)] += n
            return out

        def get_tracker_snapshot(self, _kind):
            return {"cpu": {"Total": self.peak}}

    made = []

    def tracker():
        made.append(Storages())
        return made[-1]
    mem_tracker.MemTracker = tracker
    torch.autograd.set_detect_anomaly(True, check_nan=False)
    if args.cell == "reduced":
        rec = dryrun.run_cell("smollm-135m", ShapeSpec("t", 512, 16, "train"),
                              mesh_axes=(("data", 4), ("model", 2)),
                              save=False)
    else:
        rec = dryrun.run_cell("smollm-135m", "train_4k", save=False)
    if rec["status"] != "ok":
        raise SystemExit(rec.get("traceback"))
    mem, coll = rec["memory_analysis"], rec["collectives"]
    print(f"{args.cell}: temp {mem['temp_size_in_bytes']} B (this "
          f"tracker's peak), arguments {mem['argument_size_in_bytes']} B; "
          f"collectives {coll['count_by_kind']} {coll['bytes_by_kind']}")
    print(f"\nalive at the peak, top {TOP}:")
    for (op, where), n in made[0].at_peak.most_common(TOP):
        print(f"{n / 1e6:12.1f} MB  {op:40s} {where}")
    print(f"\ncollectives by site, top {TOP} by bytes:")
    for (kind, where), (n, b) in sorted(made[0].coll.items(),
                                        key=lambda kv: -kv[1][1])[:TOP]:
        print(f"{kind:20s} {n:6d} {b / 1e6:12.1f} MB  {where}")


if __name__ == "__main__":
    main()
