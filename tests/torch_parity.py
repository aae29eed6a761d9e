"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are drawn with numpy and handed to both packages; results come
back as float32 numpy arrays and are compared at the tolerances
``test_kernels.py`` uses: 2e-2 for bf16, 2e-4 for f32.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

#: every torch test runs single-threaded: the suite runs several pytest
#: workers side by side, and the sizes here are small.
torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16")


def tol(dtype: str) -> dict:
    """Tolerance by working dtype (``test_kernels.py``'s)."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def torch_dtype(dtype: str) -> torch.dtype:
    return getattr(torch, dtype)


def f32(x) -> np.ndarray:
    """A jax array, torch tensor or numpy array as f32 numpy (exact for
    bf16)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def both(a: np.ndarray, dtype: str):
    """The same numpy array as a jax array and a CPU torch tensor, both
    rounded to ``dtype``."""
    import jax.numpy as jnp
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.as_tensor(np.asarray(a, np.float32)).to(torch_dtype(dtype))
    return j, t


def numpy_tree(tree):
    """A jax param pytree as nested dicts of numpy arrays (bf16 leaves as
    ml_dtypes bfloat16), the bridge's input."""
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def cuda() -> torch.device:
    """The card, for tests marked ``gpu``.  Decided here, when the test
    runs, so every pytest worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return torch.device("cuda")


def strict_jit(fn, *args):
    """``fn(*args)`` jitted with XLA's ``xla_allow_excess_precision`` off,
    so bf16 intermediates round where the reference's op-by-op run rounds
    them (``test_torch_train.py`` says why)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


class RefDraws:
    """The reference scheduler's frontend draws (``_frames_at``,
    ``_image_of`` of ``_request_key(seed, rid)``) behind the port's
    ``Draws`` seam, as f32 numpy arrays (exact for their bf16 values)."""

    def __init__(self, seed: int, cfg):
        self.seed, self.cfg = seed, cfg

    def _key(self, rid):
        from repro.launch import scheduler as JS
        return JS._request_key(self.seed, rid)

    def frames_at(self, rid, pos):
        from repro.launch import scheduler as JS
        return np.asarray(JS._frames_at(self._key(rid), pos,
                                        self.cfg.d_model), np.float32)[0]

    def image_of(self, rid):
        from repro.launch import scheduler as JS
        return np.asarray(JS._image_of(self._key(rid), self.cfg.n_img_tokens,
                                       self.cfg.d_model), np.float32)[0]


class RouterPin:
    """Records the expert ids the reference's ``router_topk`` picks and
    replays them, call by call, in the port's, with gates from the port's
    own router probabilities at those experts (``torch.where`` keeps the
    router's own gates of a token whose choice did not move).  ``moved``
    counts the tokens whose expert set the port's own router would have
    changed."""

    def __init__(self):
        self.ids: list[np.ndarray] = []
        self.moved = 0

    @contextlib.contextmanager
    def recording(self):
        from repro.models import moe as jmoe
        orig = jmoe.router_topk

        def record(x, w_router, moe):
            gate, idx, aux = orig(x, w_router, moe)
            self.ids.append(np.array(idx))
            return gate, idx, aux
        jmoe.router_topk = record
        try:
            yield
        finally:
            jmoe.router_topk = orig

    @contextlib.contextmanager
    def replaying(self):
        from repro_torch.models import moe as tmoe
        orig = tmoe.router_topk
        calls = iter(self.ids)

        def replay(x, w_router, moe):
            own_gate, own, aux = orig(x, w_router, moe)
            idx = torch.as_tensor(next(calls)).to(own.dtype)
            self.moved += int((idx.sort(-1).values != own.sort(-1).values)
                              .any(-1).sum())
            probs = torch.softmax(x.to(torch.float32) @ w_router, dim=-1)
            gate = probs.gather(-1, idx)
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            # a token whose choice did not move keeps the router's own
            # gates, so its gradients take the unpinned path bit for bit
            same = (idx == own).all(-1, keepdim=True)
            return torch.where(same, own_gate, gate), idx, aux
        tmoe.router_topk = replay
        try:
            yield
        finally:
            tmoe.router_topk = orig
        assert next(calls, None) is None, "the port routed fewer times"
