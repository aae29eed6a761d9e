"""Parameters across the two packages, by path.

PyTorch cannot reproduce JAX's random streams, so weights cross by name:
the reference parameter pytree, handed over as nested dicts of numpy
arrays (``group0/b0/mix/w_q`` and so on, the leading stacked ``layers``
axis included), becomes the same tree of torch tensors.

bf16 leaves arrive as ``ml_dtypes`` bfloat16, which ``torch.from_numpy``
rejects.  They go through float32, which holds every bf16 value exactly,
and then to ``torch.bfloat16``: the round trip is bitwise.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

#: the dtypes of the reference's parameters
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaf_to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    name = arr.dtype.name
    if name not in _DTYPES:
        raise TypeError(f"unsupported leaf dtype {name}")
    if name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    # a copy: the caller's array may be read-only (a JAX buffer's view)
    return torch.from_numpy(np.array(arr)).to(device)


def _paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def params_from_numpy(tree: dict, device: str | torch.device,
                      like: dict | None = None) -> dict:
    """Nested dicts of numpy arrays → the same tree of torch tensors on
    ``device``.  With ``like`` (a tree of tensors, e.g. the meta-device
    shapes of ``LM.param_shapes()``), every path must be present on both
    sides with the same shape and dtype; anything else raises."""
    device = torch.device(device)
    flat = _paths(tree)
    if like is not None:
        want = _paths(like)
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        if missing or extra:
            raise KeyError(f"param paths differ: missing {missing}, "
                           f"extra {extra}")
        for path, ref in want.items():
            arr = np.asarray(flat[path])
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: shape {tuple(arr.shape)}, "
                                 f"expected {tuple(ref.shape)}")
            got = _DTYPES.get(arr.dtype.name)
            if got != ref.dtype:
                raise TypeError(f"{path}: dtype {arr.dtype.name}, "
                                f"expected {ref.dtype}")
    return _unflatten({p: _leaf_to_torch(a, device) for p, a in flat.items()})


__all__ = ["params_from_numpy"]
