"""The port's GPipe runtime (``repro_torch.core.pipeline.gpipe``)
against the sequential oracle and the reference's ``gpipe``.

At the reference test's sizes (``tests/test_multidevice.py``: S = 4
stages, M = 6 microbatches of (B = 2, D = 8), ``tanh(x @ w)`` per stage)
the port runs on 4 gloo ranks over a ``("pod",)`` mesh
(``tests/torch_ranks.py``, mode ``gpipe``), the reference in a JAX
process with 4 host devices; both at 1e-5 of the oracle and of each
other.  At S = 1 the ring is a copy to itself, on one rank, and the
outputs equal the oracle bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_ranks import SRC, spawn
from repro_torch.core.pipeline import PipelineConfig, gpipe
from repro_torch.launch.mesh import make_host_mesh

S, M, B, D = 4, 6, 2, 8

REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.pipeline import PipelineConfig, gpipe

spec = json.load(open(sys.argv[1]))
S = len(spec["ws"])
mesh = jax.make_mesh((S,), ("pod",))
Ws = jnp.asarray(spec["ws"], jnp.float32)
mb = jnp.asarray(spec["mb"], jnp.float32)
run = gpipe(lambda w, x, sid: jnp.tanh(x @ w), PipelineConfig(S, len(mb)),
            mesh, None, None)
print(json.dumps(np.asarray(run(Ws, mb)).tolist()))
'''


def _inputs(stages):
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(stages, D, D)) * 0.3).astype(np.float32)
    mb = rng.normal(size=(M, B, D)).astype(np.float32)
    return ws, mb


def _oracle(ws, mb):
    ref = torch.from_numpy(mb)
    for w in ws:
        ref = torch.tanh(ref @ torch.from_numpy(w))
    return ref


def test_gpipe_four_stages_match_oracle_and_reference(tmp_path):
    ws, mb = _inputs(S)
    spec = {"ws": ws.tolist(), "mb": mb.tolist()}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    (tmp_path / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={S}"}
    out = subprocess.run([sys.executable, str(tmp_path / "reference.py"),
                          str(tmp_path / "spec.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.asarray(json.loads(out.stdout.splitlines()[-1]), np.float32)
    oracle = _oracle(ws, mb).numpy()
    np.testing.assert_allclose(ref, oracle, rtol=1e-5, atol=1e-5)
    ranks = spawn("gpipe", S, spec, tmp_path / "ranks")
    for got in ranks:
        got = np.asarray(got, np.float32)
        assert got.shape == (M, B, D)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_gpipe_one_stage_is_the_oracle():
    ws, mb = _inputs(1)
    assert not dist.is_initialized()
    mesh = make_host_mesh((1,), axes=("pod",), device="cpu")
    try:
        run = gpipe(lambda w, x, sid: torch.tanh(x @ w),
                    PipelineConfig(1, M), mesh)
        got = run(torch.from_numpy(ws), torch.from_numpy(mb))
        with pytest.raises(ValueError, match="not 2 stages"):
            gpipe(lambda w, x, sid: x, PipelineConfig(2, M), mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, _oracle(ws, mb))
