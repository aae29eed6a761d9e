"""The port's checkpointing (``repro_torch.distributed``) against the
reference's: its own cases of ``tests/test_substrate.py`` and
``tests/test_faults.py``, port against port; the in-place update made
deterministic; and the on-disk format across the two packages, both
ways, on the smoke configs of smollm-135m, xlstm-125m and jamba-v0.1-52b.
Every leaf must come back bit for bit (bf16 compared as its uint16
bits)."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.distributed import checkpoint as jckpt
from repro.distributed.elastic import gather_full_tree as jgather
from repro.models.lm import LM as JLM
from repro.optim import AdamWState as JAdamWState
from repro_torch.bridge import params_from_numpy
from repro_torch.distributed import (CheckpointManager, gather_full_tree,
                                     reshard_checkpoint)
from repro_torch.distributed.checkpoint import (CheckpointCorruptionError,
                                                _flatten, _unflatten)
from repro_torch.optim import AdamW, AdamWState
from torch_parity import numpy_tree

#: deepseek-v2's MLA leaves; deepseek-v3's MLA and MTP leaves, with bf16
#: moments
ARCHS = ("smollm-135m", "xlstm-125m", "jamba-v0.1-52b", "deepseek-v2-236b",
         "deepseek-v3-671b")
#: the manifest fields both writers must agree on (``time`` and the CRCs
#: of two different zip writers need not)
MANIFEST_FIELDS = ("keys", "shapes", "dtypes", "bf16_keys", "n_hosts",
                   "step")


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as uint16), from either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def assert_bits_equal(a, b, key=""):
    a, b = _bits(a), _bits(b)
    assert a.dtype == b.dtype and a.shape == b.shape, key
    np.testing.assert_array_equal(a, b, err_msg=key)


def _zeros_like(tree):
    return _unflatten(tree, [torch.zeros_like(v) for _, v in _flatten(tree)])


# -- the reference's cases, port against port -----------------------------

def _tree(scale=1.0):
    return {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8) * scale,
            "b": torch.ones(8) * scale}


def _every_bf16() -> torch.Tensor:
    """Every bf16 bit pattern once (NaNs, infinities, -0 included)."""
    return torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).reshape(256, 256)


@pytest.mark.parametrize("kind", ["f32", "bf16", "adamw"])
def test_checkpoint_save_restore_roundtrip(tmp_path, kind):
    """``tests/test_substrate.py:130``, and a bf16 leaf holding every bit
    pattern, and an ``AdamWState`` with its int32 step."""
    mgr = CheckpointManager(tmp_path)
    tree = {"p": torch.arange(12.0).reshape(3, 4),
            "opt": {"m": torch.ones((3, 4)) * 0.5}}
    if kind == "bf16":
        tree["opt"]["bits"] = _every_bf16()
    if kind == "adamw":
        tree = {"params": tree, "opt": AdamWState(
            torch.tensor(7, dtype=torch.int32), {"p": torch.randn(3, 4)},
            {"p": torch.rand(3, 4).to(torch.bfloat16)})}
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_step() == 10
    restored = mgr.restore(10, _zeros_like(tree))
    names = [k for k, _ in _flatten(tree)]
    assert names == [k for k, _ in _flatten(restored)]
    for (k, a), (_, b) in zip(_flatten(tree), _flatten(restored)):
        assert_bits_equal(a, b, k)


def test_checkpoint_atomic_commit_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"p": torch.zeros(2)}, blocking=True)
    # a torn write: a directory without the COMMITTED marker
    (tmp_path / "step_000009").mkdir()
    assert mgr.latest_step() == 5


def test_checkpoint_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": torch.zeros(2)}, blocking=True)
    assert mgr.steps() == [3, 4]


def test_restore_refuses_a_shape_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    like = {"w": torch.zeros(8, 4), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="repro_torch.distributed.elastic."
                       "reshard_checkpoint"):
        mgr.restore(1, like)


def test_restore_lands_in_the_like_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.arange(6.0).to(torch.bfloat16)}, blocking=True)
    got = mgr.restore(1, {"w": torch.zeros(6)})["w"]
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.arange(6.0))


def test_corrupt_shard_fails_crc_and_restore_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, host_id=0, n_hosts=1)
    mgr.save(10, _tree(1.0), blocking=True)
    mgr.save(20, _tree(2.0), blocking=True)
    shard = tmp_path / "step_000020" / "shard_h000.npz"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(20, _tree())
    step, got = mgr.restore_latest(_tree())
    assert step == 10
    assert torch.equal(got["w"], _tree(1.0)["w"])


def test_all_steps_corrupt_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, host_id=0, n_hosts=1)
    mgr.save(10, _tree(), blocking=True)
    (tmp_path / "step_000010" / "shard_h000.npz").write_bytes(b"garbage")
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore_latest(_tree())


def test_background_save_error_reraised_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, host_id=0, n_hosts=1)

    def boom(*a, **k):
        raise OSError("disk on fire")

    monkeypatch.setattr("repro_torch.distributed.checkpoint.np.savez", boom)
    mgr.save(10, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    # the error is consumed: the next wait is clean
    mgr.wait()


def test_gather_full_tree_validates_commit_and_shards(tmp_path):
    for h in range(2):
        CheckpointManager(tmp_path, host_id=h, n_hosts=2).save(
            5, _tree(), blocking=True)
    d = tmp_path / "step_000005"
    (d / "shard_h001.npz").unlink()
    with pytest.raises(ValueError, match=r"hosts \[1\] are missing"):
        gather_full_tree(tmp_path, 5, _tree())
    (d / "COMMITTED").unlink()
    with pytest.raises(ValueError, match="not committed"):
        gather_full_tree(tmp_path, 5, _tree())


def test_elastic_reshard_checkpoint(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    CheckpointManager(tmp_path / "src").save(2, tree, blocking=True)
    reshard_checkpoint(tmp_path / "src", 2, tree, new_n_hosts=2,
                       dst_dir=tmp_path / "dst")
    for h in range(2):
        m2 = CheckpointManager(tmp_path / "dst", host_id=h, n_hosts=2)
        got = m2.restore(2, {"w": torch.zeros(4, 4)})
        assert torch.equal(got["w"], tree["w"])


def test_save_copies_before_an_in_place_update(tmp_path, monkeypatch):
    """The writer is held inside ``np.savez`` while AdamW updates the
    saved params and moments in place; the checkpoint must hold the
    values from before the update (``save`` takes its own host copy)."""
    entered, release = threading.Event(), threading.Event()
    real = np.savez

    def held(*a, **k):
        entered.set()
        assert release.wait(timeout=30)
        return real(*a, **k)
    monkeypatch.setattr("repro_torch.distributed.checkpoint.np.savez", held)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(16, 8, generator=gen).to(torch.bfloat16),
              "b": torch.randn(8, generator=gen)}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    tree = {"params": params, "opt": state}
    before = [(k, v.clone()) for k, v in _flatten(tree)]
    b0 = dict(before)["params/b"]
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    try:
        assert entered.wait(timeout=30)
        grads = {k: torch.ones_like(v) for k, v in params.items()}
        opt.update(grads, state, params)
        assert not torch.equal(params["b"], b0)   # moved in place
    finally:
        release.set()
        mgr.wait()
    got = mgr.restore(1, _zeros_like(tree))
    for (k, a), (_, b) in zip(before, _flatten(got)):
        assert_bits_equal(a, b, k)


# -- the format across the two packages -----------------------------------

STEP = 37


@pytest.fixture(scope="module", params=ARCHS)
def trees(request, tmp_path_factory):
    """The same state as the reference's tree and the port's: the
    reference's smoke params bridged by path, moments drawn with numpy in
    the moment dtype, a nonzero int32 step; each package has written it
    once."""
    arch = request.param
    jcfg = jget(arch, smoke=True)
    jparams, _ = JLM(jcfg).init(jax.random.PRNGKey(0))
    nparams = numpy_tree(jparams)
    rng = np.random.default_rng(0)
    mdt = np.float32 if jcfg.opt_moment_dtype == "f32" else jnp.bfloat16
    mu, nu = (jax.tree.map(lambda p: rng.standard_normal(p.shape)
                           .astype(mdt), nparams) for _ in range(2))
    jtree = {"params": jparams, "opt": JAdamWState(
        jnp.asarray(STEP, jnp.int32), jax.tree.map(jnp.asarray, mu),
        jax.tree.map(jnp.asarray, nu))}
    mtd = torch.float32 if jcfg.opt_moment_dtype == "f32" else torch.bfloat16
    ttree = {"params": params_from_numpy(nparams, "cpu"), "opt": AdamWState(
        torch.tensor(STEP, dtype=torch.int32),
        params_from_numpy(mu, "cpu"), params_from_numpy(nu, "cpu"))}
    root = tmp_path_factory.mktemp(arch)
    CheckpointManager(root / "port").save(STEP, ttree, blocking=True)
    jckpt.CheckpointManager(root / "ref").save(STEP, jtree, blocking=True)
    return dict(root=root, jtree=jtree, ttree=ttree, n_leaves=len(
        jax.tree.leaves(jtree)))


def _manifest(d):
    return json.loads((d / f"step_{STEP:06d}" / "manifest.json").read_text())


def test_port_checkpoint_restores_in_reference(trees):
    jtree = trees["jtree"]
    got = jckpt.CheckpointManager(trees["root"] / "port").restore(
        STEP, jax.tree.map(jnp.zeros_like, jtree))
    want = jax.tree.leaves(jtree)
    assert len(want) == trees["n_leaves"]
    for a, b in zip(jax.tree.leaves(got), want):
        assert_bits_equal(a, b)


def test_reference_checkpoint_restores_in_port(trees):
    ttree = trees["ttree"]
    got = CheckpointManager(trees["root"] / "ref").restore(
        STEP, _zeros_like(ttree))
    for (k, a), (_, b) in zip(_flatten(got), _flatten(ttree)):
        assert_bits_equal(a, b, k)


def test_manifests_agree(trees):
    """The two writers name, shape and type every leaf alike; the names
    are the reference's ``_flatten`` names of the same tree."""
    mp, mr = _manifest(trees["root"] / "port"), _manifest(trees["root"] /
                                                          "ref")
    for f in MANIFEST_FIELDS:
        assert mp[f] == mr[f], f
    names, _ = jckpt._flatten(trees["jtree"])
    assert [k for k, _ in _flatten(trees["ttree"])] == [k for k, _ in names]
    assert mp["keys"][:2] == ["opt/.step", "opt/.mu/embed"]


def test_port_reshard_restores_in_reference(trees):
    root, jtree = trees["root"], trees["jtree"]
    reshard_checkpoint(root / "port", STEP, trees["ttree"], new_n_hosts=2,
                       dst_dir=root / "resharded")
    like = jax.tree.map(jnp.zeros_like, jtree)
    for h in range(2):
        got = jckpt.CheckpointManager(root / "resharded", host_id=h,
                                      n_hosts=2).restore(STEP, like)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            assert_bits_equal(a, b)


def test_gather_full_tree_stitches_as_the_reference(tmp_path):
    """Two hosts whose shards differ (concatenated along axis 0) and
    agree (kept once), by value as the reference compares: a bf16 +0 and
    -0 agree, a NaN never does."""
    nan = torch.tensor([float("nan"), 1.0]).to(torch.bfloat16)
    hosts = [{"w": torch.full((2, 3), float(h)),
              "z": torch.tensor([(-0.0, 0.0)[h], 1.0]).to(torch.bfloat16),
              "n": nan, "b": torch.arange(3.0).to(torch.bfloat16)}
             for h in range(2)]
    for h, tree in enumerate(hosts):
        CheckpointManager(tmp_path, host_id=h, n_hosts=2).save(
            3, tree, blocking=True)
    got = gather_full_tree(tmp_path, 3, hosts[0])
    want = jgather(tmp_path, 3, {k: np.zeros(v.shape)
                                 for k, v in hosts[0].items()})
    assert got["w"].shape == (4, 3) and got["z"].shape == (2,)
    assert got["n"].shape == (4,) and got["b"].shape == (3,)
    for k in hosts[0]:
        assert_bits_equal(got[k], want[k], k)
