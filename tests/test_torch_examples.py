"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``).

* ``autoshard_inspect`` prints what the reference example prints, pass
  by pass, rules and estimates included, with and without ``--ablate``
  (the port's compiler derives the reference's plans bit for bit).
* ``quickstart --device cpu`` for 4 steps drops the loss; on ``cuda``
  without a card it raises before it trains.
* ``train_e2e --device cpu`` runs the train driver end to end.
"""
import os
import subprocess
import sys

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_ranks import SRC
from repro_torch.core.ir import reset_fresh_names
from repro_torch.examples import autoshard_inspect, quickstart, train_e2e

REPO = SRC.parent


@pytest.mark.parametrize("argv", [["--arch", "smollm-135m"],
                                  ["--arch", "jamba-v0.1-52b", "--ablate"]],
                         ids=["smollm", "jamba-ablate"])
def test_autoshard_inspect_prints_the_reference(argv, capsys):
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable,
                          str(REPO / "examples" / "autoshard_inspect.py"),
                          *argv], env=env, capture_output=True, text=True,
                         timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    # node names come from a fresh-name counter, fresh in the reference's
    # process
    reset_fresh_names()
    autoshard_inspect.main(argv)
    got = capsys.readouterr().out
    assert got.splitlines() == ref.stdout.splitlines()
    assert "rules: {" in got


def test_quickstart_drops_the_loss(capsys):
    losses = quickstart.main(["--device", "cpu", "--steps", "4"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "sharding rules:" in out and "on cpu" in out


def test_examples_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        quickstart.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        train_e2e.main(["--steps", "1", "--ckpt-every", "0"])


def test_train_e2e_on_cpu(tmp_path, capsys):
    out = train_e2e.main(["--device", "cpu", "--steps", "12", "--batch",
                          "4", "--seq", "32", "--ckpt-every", "0",
                          "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 12
    assert "[e2e] loss" in capsys.readouterr().out
