"""Fault-tolerant sharded checkpointing, in the reference's on-disk format.

Counterpart of ``repro.distributed.checkpoint``.  Layout (one directory
per step):

    ckpt_dir/
      step_000120/
        manifest.json          # leaf names, shapes, dtypes, CRCs
        shard_h000.npz         # this host's param and optimizer shards
        COMMITTED              # written last — atomic commit marker

The format is the reference's, byte for byte where it can be: the same
leaf names (``_flatten``), bf16 leaves stored as their uint16 bits and
listed in ``bf16_keys``, a CRC32 per shard file in the manifest.  So a
checkpoint that either package writes, the other restores.

Writes go to ``step_XXXX.tmp`` and are renamed only after every shard +
manifest lands, so a preemption mid-write can never corrupt the latest
checkpoint; ``latest_step`` ignores uncommitted directories.  ``save``
copies every leaf to host memory before it returns (the port's AdamW
updates params and moments in place, and on the CPU ``Tensor.numpy()``
shares the tensor's memory), then serialises on a background thread.  A
failure inside the background write is captured and re-raised on the
next ``wait()`` / ``save()``.  ``restore`` verifies the shard's CRC32
first; ``restore_latest`` walks back to the newest step that verifies.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed CRC verification on restore."""


def _flatten(tree: Any) -> list[tuple[str, Any]]:
    """The ``(name, leaf)`` pairs of a tree of nested dicts and
    NamedTuples (``AdamWState``), in the order and with the names of
    ``jax.tree_util``'s key paths, as the reference writes them: dict keys
    sorted and printed as themselves, a NamedTuple field as ``.name``,
    ``/`` between levels."""
    out: list[tuple[str, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + (f".{f}",))
        else:
            out.append(("/".join(path), t))
    walk(tree, ())
    return out


def _unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in ``_flatten``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("_unflatten: more leaves than the tree holds")
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The tensor's own host copy as numpy (bf16 as its uint16 bits).
    ``copy=True`` also copies a CPU tensor, whose ``numpy()`` would share
    memory with a tensor the next step updates in place; from the card
    the copy is synchronous."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_bits(arr: np.ndarray) -> torch.Tensor:
    """Stored uint16 bits → a CPU bf16 tensor."""
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


@dataclass
class CheckpointManager:
    directory: str | Path
    host_id: int = 0
    n_hosts: int = 1
    keep: int = 3
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        # Copy every leaf to host memory synchronously, serialise + CRC in
        # the background.  bfloat16 has no numpy dtype: persist it as
        # uint16 bits + a dtype tag, as the reference does.
        host_named = []
        bf16_keys = []
        for k, v in _flatten(tree):
            if v.dtype == torch.bfloat16:
                bf16_keys.append(k)
            host_named.append((k, _to_host(v)))
        self.wait()

        def write():
            tmp = self.directory / f"step_{step:06d}.tmp"
            final = self.directory / f"step_{step:06d}"
            tmp.mkdir(parents=True, exist_ok=True)
            shard_name = f"shard_h{self.host_id:03d}.npz"
            np.savez(tmp / shard_name, **dict(host_named))
            crc32 = {shard_name: zlib.crc32((tmp / shard_name).read_bytes())}
            if (final / "manifest.json").exists():
                # Another host committed this step first: carry its shard
                # CRCs forward so ours don't clobber them.
                prev = json.loads((final / "manifest.json").read_text())
                crc32 = {**prev.get("crc32", {}), **crc32}
            manifest = {
                "step": step,
                "n_hosts": self.n_hosts,
                "keys": [k for k, _ in host_named],
                "shapes": {k: list(v.shape) for k, v in host_named},
                "dtypes": {k: str(v.dtype) for k, v in host_named},
                "bf16_keys": bf16_keys,
                "crc32": crc32,
                "time": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMITTED").touch()
            if final.exists():
                # Another host already committed this step: merge our
                # shard + manifest into the shared directory.
                for f in tmp.iterdir():
                    os.replace(f, final / f.name)
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.replace(tmp, final)
            self._gc()

        def guarded_write():
            try:
                write()
            except BaseException as e:   # surfaced on wait()/next save()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=guarded_write,
                                            daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the in-flight background save.  A failure captured on the
        writer thread is re-raised *here* (and from the next ``save()``,
        which waits first) — an async save error must not be silent."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:06d}",
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in sorted(self.directory.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "COMMITTED").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``, a tree of tensors
        (shapes must match); each leaf lands on its ``like`` leaf's device
        in its dtype.

        The host shard's CRC32 is verified against the manifest before
        deserialising; a mismatch raises
        :class:`CheckpointCorruptionError` (post-commit bit-rot — the
        atomic-commit marker cannot catch it)."""
        d = self.directory / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        bf16 = set(manifest.get("bf16_keys", ()))
        shard_name = f"shard_h{self.host_id:03d}.npz"
        expect = manifest.get("crc32", {}).get(shard_name)
        if expect is not None:
            got = zlib.crc32((d / shard_name).read_bytes())
            if got != expect:
                raise CheckpointCorruptionError(
                    f"step {step}: {shard_name} crc32 {got:#010x} != "
                    f"manifest {expect:#010x} (corrupt shard)")
        leaves = []
        with np.load(d / shard_name) as data:
            for key, ref in _flatten(like):
                arr = data[key]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} != "
                        f"{tuple(ref.shape)}; use "
                        "repro_torch.distributed.elastic.reshard_checkpoint")
                t = _from_bits(arr) if key in bf16 else torch.from_numpy(arr)
                leaves.append(t.to(device=ref.device, dtype=ref.dtype))
        return _unflatten(like, leaves)

    def restore_latest(self, like: Any) -> tuple[Optional[int], Any]:
        """Restore the newest committed step that *verifies*.  A step
        failing CRC (or deserialisation) is skipped with a warning and
        the previous committed step is tried — one corrupt checkpoint
        costs re-training from the prior one, not the job.  Raises only
        when every committed step fails."""
        steps = self.steps()
        if not steps:
            return None, like
        last_err: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                return step, self.restore(step, like)
            except (CheckpointCorruptionError, OSError,
                    ValueError, KeyError) as e:
                logger.warning(
                    "checkpoint step %d failed to restore (%s); falling "
                    "back to previous committed step", step, e)
                last_err = e
        raise CheckpointCorruptionError(
            f"no committed step in {self.directory} restored cleanly "
            f"(tried {steps[::-1]})") from last_err
