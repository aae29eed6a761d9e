"""Elastic scaling: re-stitch checkpoints across host-count changes.

Counterpart of the half of ``repro.distributed.elastic`` that works on
the checkpoint format alone.  A job restarted on a different topology
(16→8 hosts after failures, or grown back to 16) calls
``reshard_checkpoint``: every host loads the union of the old shards it
needs and slices out its new shard.  Because the data loader is keyed by
``(step, shard)`` (see ``repro_torch.data``), the input stream
re-partitions consistently too — no sample is lost or duplicated.

For one process the "hosts" are simulated shard files; the stitching
logic is identical to the multi-host case.  ``mesh_for_hosts`` needs the
device mesh (ROADMAP A8), and ``replan_for_topology`` is not ported yet
(ROADMAP A14's rest).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .checkpoint import CheckpointManager, _flatten, _from_bits, _unflatten


def _values(bits: np.ndarray) -> np.ndarray:
    """Stored bf16 bits → the same values in f32 (exact), so that
    replicas compare by value, as the reference compares its bf16
    arrays: -0 equals +0, and NaN equals nothing."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def gather_full_tree(directory: str | Path, step: int, like: Any) -> Any:
    """Load + concatenate every host shard of a checkpoint along the
    leading (data-sharded) axis when host shards differ, or verify
    replicas agree.  Returns a tree shaped like ``like`` of CPU tensors
    in the stored dtypes.

    Validates the step before stitching: the directory must carry the
    ``COMMITTED`` marker, and every host shard the manifest promises
    (``n_hosts``) must be present — a silently-missing shard would
    otherwise stitch a smaller, wrong tree."""
    directory = Path(directory)
    d = directory / f"step_{step:06d}"
    if not (d / "COMMITTED").exists():
        raise ValueError(
            f"checkpoint step {step} at {d} is not committed "
            "(missing COMMITTED marker); refusing to stitch a "
            "partial write")
    manifest = json.loads((d / "manifest.json").read_text())
    bf16 = set(manifest.get("bf16_keys", ()))
    shards = sorted(d.glob("shard_h*.npz"))
    n_hosts = int(manifest.get("n_hosts", len(shards)))
    have = {int(s.name[len("shard_h"):-len(".npz")]) for s in shards}
    missing = sorted(set(range(n_hosts)) - have)
    if missing:
        raise ValueError(
            f"checkpoint step {step} at {d}: manifest promises "
            f"{n_hosts} host shards but hosts {missing} are missing "
            f"(found {sorted(have)})")
    datas = [np.load(s) for s in shards]
    try:
        leaves = []
        for key, _ in _flatten(like):
            parts = [dt[key] for dt in datas]
            if all(p.shape == parts[0].shape for p in parts) \
                    and len(parts) > 1:
                vals = [_values(p) if key in bf16 else p for p in parts]
                same = all(np.array_equal(vals[0], v) for v in vals[1:])
                arr = parts[0] if same else np.concatenate(parts, axis=0)
            else:
                arr = (parts[0] if len(parts) == 1
                       else np.concatenate(parts, axis=0))
            leaves.append(_from_bits(arr) if key in bf16
                          else torch.from_numpy(arr))
    finally:
        for dt in datas:
            dt.close()
    return _unflatten(like, leaves)


def reshard_checkpoint(src_dir: str | Path, step: int, like: Any,
                       new_n_hosts: int, dst_dir: str | Path) -> None:
    """Rewrite a committed checkpoint for a different host count.  Host
    shards are assumed replicated (params and optimizer state under FSDP
    are saved replicated per host after an all-gather, or identical per
    host) — each new host gets a full copy, sliced lazily at restore by
    the new mesh's shardings."""
    full = gather_full_tree(src_dir, step, like)
    for h in range(new_n_hosts):
        mgr = CheckpointManager(dst_dir, host_id=h, n_hosts=new_n_hosts)
        mgr.save(step, full, blocking=True)


def scale_batch_schedule(global_batch: int, old_hosts: int,
                         new_hosts: int) -> dict:
    """Keep the *global* batch invariant across rescales (per-host batch
    changes); returns the new loader partition."""
    if global_batch % new_hosts:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"{new_hosts} hosts")
    return {"n_hosts": new_hosts,
            "local_batch": global_batch // new_hosts,
            "note": f"rescaled from {old_hosts} hosts; global batch and "
                    f"data stream unchanged"}
