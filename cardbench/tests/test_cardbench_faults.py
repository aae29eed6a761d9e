"""What decides ``correct`` fails when the timed path is broken
underneath, and fails the control: the reference in fp8 put in the
program's place.  Runs skip the harness's look for a card and drive the
rest of a run at a small size on the CPU, with each fault the cell can
have planted in the program."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import KINDS, files_of, run_cell


def _frozen_decode(monkeypatch):
    """A decode step that returns its caches unchanged."""
    from repro_torch.models import lm as lm_mod
    orig = lm_mod.LM.decode_step

    def step(self, params, batch, caches):
        old = lm_mod._map_cache(torch.clone, caches)
        logits, _new = orig(self, params, batch, caches)
        lm_mod._map_cache(lambda a, b: a.copy_(b), caches, old)
        return logits, caches
    monkeypatch.setattr(lm_mod.LM, "decode_step", step)


def _altered_token(monkeypatch):
    """Every served token altered where it is sampled."""
    from repro_torch.launch import scheduler
    orig = scheduler._sample

    def sample(row, seed, rid, pos, temperature):
        return (orig(row, seed, rid, pos, temperature) + 1) % len(row)
    monkeypatch.setattr(scheduler, "_sample", sample)


def _frozen_train_step(monkeypatch):
    """A train step that leaves params and moments as they were."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw.AdamW, "update",
                        lambda self, grads, state, params, lr_scale=1.0:
                        (params, state))


def _half_batch(monkeypatch):
    """The loss over the first half of the rows, the rest left out."""
    from repro_torch.models import lm as lm_mod
    orig = lm_mod.LM.loss_fn

    def loss(self, params, batch):
        half = batch["labels"].shape[0] // 2
        return orig(self, params, {k: v[:half] for k, v in batch.items()})
    monkeypatch.setattr(lm_mod.LM, "loss_fn", loss)


def _one_row_altered(monkeypatch):
    """One request's served tokens altered where they are sampled: the
    wave's first slot served wrong, the others right."""
    from repro_torch.launch import scheduler
    orig = scheduler._sample

    def sample(row, seed, rid, pos, temperature):
        tok = orig(row, seed, rid, pos, temperature)
        return (tok + 1) % len(row) if rid == 0 else tok
    monkeypatch.setattr(scheduler, "_sample", sample)


FAULTS = [("serve_continuous", _frozen_decode),
          ("serve_continuous", _altered_token),
          ("serve_static", _frozen_decode),
          ("serve_static", _altered_token),
          ("serve_static", _one_row_altered),
          ("train", _frozen_train_step),
          ("train", _half_batch)]


@pytest.mark.parametrize("kind,fault", FAULTS,
                         ids=[f"{k}-{f.__name__[1:]}" for k, f in FAULTS])
def test_fault_is_not_correct(kind, fault, monkeypatch):
    fault(monkeypatch)
    rc, res, _ = run_cell(kind, seed=21)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_control_is_not_correct(kind):
    """``--readings`` over three seeds: the program's numbers under their
    limits on each, the control's over one of them on each."""
    import contextlib
    import io
    from cardbench import run as R
    files = files_of(kind)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        R.main(["--workload", "x", "--seed", "41", "--seconds", "0.3",
                "--readings", "3"], files=files,
               device=torch.device("cpu"))
    lim = files["limits"]
    lines = [json.loads(x[len("[readings] "):])["readings"]
             for x in out.getvalue().splitlines()
             if x.startswith("[readings] ")]
    assert len(lines) == 3
    for r in lines:
        assert all(r[k] <= v for k, v in lim.items()), r
        assert any(r[f"control.{k}"] > v for k, v in lim.items()), r
