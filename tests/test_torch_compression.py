"""The port's int8 error-feedback compression (``repro_torch.optim.
compression``) against the reference's ``repro.optim.compression``.

* ``compress`` of the same f32 gradient and residual gives the
  reference's int8 payload and f32 scale bit for bit (round half to
  even, as ``jnp.round``), and its residual;
* the reference's three properties (``tests/test_substrate.py``), on the
  port: the error bound, feedback beating no feedback, the tree round
  trip;
* ``dp_allreduce_compressed`` on 4 gloo ranks (``tests/torch_ranks.py``,
  mode ``compress``) against the reference's inside a jitted
  ``shard_map`` over 4 host devices: the mean and each rank's new
  residual at 2e-4 (XLA fuses the jitted arithmetic and sums in another
  order; op by op, ``compress`` is bit-equal above).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import compress as jcompress
import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_parity import tol
from torch_ranks import SRC, spawn
from repro_torch.optim import (EFState, compress, decompress,
                               ef_compress_tree, ef_decompress_tree,
                               init_ef_state)

SHAPES = {"a": (8, 16), "b": (33,), "c": (2, 3, 5)}

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.compression import EFState, dp_allreduce_compressed

spec = json.load(open(sys.argv[1]))
assert len(jax.devices()) == 4
mesh = jax.make_mesh((4,), ("data",))
grads = {k: jnp.asarray(v, jnp.float32) for k, v in spec["grads"].items()}
res = {k: jnp.asarray(v, jnp.float32) for k, v in spec["residual"].items()}


def body(g, r):
    g = {k: v[0] for k, v in g.items()}
    r = {k: v[0] for k, v in r.items()}
    mean, st = dp_allreduce_compressed(g, EFState(r), "data")
    return ({k: v[None] for k, v in mean.items()},
            {k: v[None] for k, v in st.residual.items()})


f = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
              out_specs=(P("data"), P("data")), check_rep=False)
mean, resid = jax.jit(f)(grads, res)
print(json.dumps({"mean": {k: np.asarray(v).tolist() for k, v in mean.items()},
                  "residual": {k: np.asarray(v).tolist()
                               for k, v in resid.items()}}))
'''


def _draw(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * scale


@pytest.mark.parametrize("seed", range(4))
def test_compress_equals_reference_bit_for_bit(seed):
    g = _draw(seed, (257,), 10.0 ** (seed - 2))
    r = _draw(seed + 10, (257,), 10.0 ** (seed - 4))
    # exact halves: the rounding rule decides them
    g[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.0],
                     np.float32) * (g.__abs__().max() / 127.0)
    jq, js, jr = jcompress(jnp.asarray(g), jnp.asarray(r))
    q, s, nr = compress(torch.from_numpy(g), torch.from_numpy(r))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))


def test_ef_compression_roundtrip_error_bounded():
    g = torch.from_numpy(_draw(0, (256,)))
    q, scale, resid = compress(g, torch.zeros_like(g))
    deq = decompress(q, scale)
    assert (deq - g).abs().max().item() <= scale.item() + 1e-6
    # the residual holds exactly the rounding error
    np.testing.assert_allclose((deq + resid).numpy(), g.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ef_feedback_corrects_bias_over_steps():
    """With error feedback the accumulated compressed sum tracks the
    accumulated true sum far better than memoryless quantization."""
    rng = np.random.default_rng(1)
    gs = [torch.from_numpy((rng.normal(size=(64,)) * 1e-3)
                           .astype(np.float32)) for _ in range(50)]
    acc_ef = np.zeros(64)
    acc_nofb = np.zeros(64)
    resid = torch.zeros(64)
    for g in gs:
        q, s, resid = compress(g, resid)
        acc_ef += decompress(q, s).numpy()
        q2, s2, _ = compress(g, torch.zeros(64))
        acc_nofb += decompress(q2, s2).numpy()
    true = np.sum([g.numpy() for g in gs], axis=0)
    assert np.abs(acc_ef - true).max() < np.abs(acc_nofb - true).max() + 1e-9


def test_ef_tree_roundtrip():
    grads = {"a": torch.ones(8), "b": {"c": torch.full((4,), -2.0)}}
    state = init_ef_state(grads)
    assert state.residual["b"]["c"].dtype == torch.float32
    q, s, new_state = ef_compress_tree(grads, state)
    assert q["b"]["c"].dtype == torch.int8
    deq = ef_decompress_tree(q, s)
    np.testing.assert_allclose(deq["a"].numpy(), grads["a"].numpy(),
                               rtol=0.02)
    np.testing.assert_allclose(deq["b"]["c"].numpy(),
                               grads["b"]["c"].numpy(), rtol=0.02)
    # meta leaves give meta residuals: the dry-run's abstract state
    meta = init_ef_state({"w": torch.empty(3, 4, device="meta")})
    assert meta.residual["w"].is_meta


def test_dp_allreduce_compressed_on_four_ranks(tmp_path):
    spec = {"grads": {k: _draw(i, (4,) + s).tolist()
                      for i, (k, s) in enumerate(SHAPES.items())},
            "residual": {k: _draw(i + 20, (4,) + s, 1e-2).tolist()
                         for i, (k, s) in enumerate(SHAPES.items())}}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    (tmp_path / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, str(tmp_path / "reference.py"),
                          str(tmp_path / "spec.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.splitlines()[-1])
    ranks = spawn("compress", 4, spec, tmp_path / "ranks")
    for r, got in enumerate(ranks):
        for k in SHAPES:
            np.testing.assert_allclose(np.asarray(got["mean"][k]),
                                       np.asarray(ref["mean"][k][r]),
                                       **tol("float32"), err_msg=k)
            np.testing.assert_allclose(
                np.asarray(got["residual"][k], np.float32),
                np.asarray(ref["residual"][k][r], np.float32),
                **tol("float32"), err_msg=k)
        # every rank holds the same mean
        for k in SHAPES:
            assert got["mean"][k] == ranks[0]["mean"][k]
