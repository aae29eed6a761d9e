"""The port's train driver (``repro_torch.launch.train``) on the CPU: the
loss falls, a preempted run resumes from its checkpoint on the
uninterrupted run's trajectory, it resumes a run that the reference's
driver checkpointed, and it needs a card unless told otherwise; and the
batch's dtypes on their way to the device (``launch/steps._to_device``).
"""
import numpy as np
import pytest
import torch

from repro.launch.train import main as jtrain_main
from repro_torch.launch.steps import _to_device
from repro_torch.launch.train import main as train_main
import torch_parity  # noqa: F401  (one torch thread per pytest worker)

#: the smoke run of the reference's resume test (tests/test_substrate.py)
COMMON = ["--arch", "smollm-135m", "--smoke", "--steps", "10",
          "--batch", "2", "--seq", "16"]
#: the port's loss against the reference's (tests/test_torch_train.py)
LOSS_TOL = dict(atol=5e-3, rtol=1e-3)


def test_to_device_keeps_floats_floating():
    """Integers go to int64; floating entries (audio frames, image
    embeddings) to bf16, as the reference's ``LM._embed`` casts them."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 8)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 8)).astype(np.int32),
             "frames": rng.standard_normal((2, 8, 16)).astype(np.float32)}
    out = _to_device(batch, torch.device("cpu"))
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    assert out["frames"].dtype == torch.bfloat16
    assert torch.equal(out["tokens"], torch.from_numpy(batch["tokens"]).long())
    assert torch.equal(out["frames"],
                       torch.from_numpy(batch["frames"]).to(torch.bfloat16))


def test_train_loss_decreases_end_to_end(tmp_path):
    """``tests/test_system.py:13`` through the port's driver."""
    out = train_main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                      "--steps", "40", "--batch", "4", "--seq", "32",
                      "--lr", "3e-3", "--ckpt-every", "0",
                      "--ckpt-dir", str(tmp_path)])
    losses = out["losses"]
    assert len(losses) == 40 and out["resumed_from"] == 0
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


@pytest.mark.slow
def test_train_resume_bitwise(tmp_path):
    """``tests/test_substrate.py:159``: kill at step 7, restart, and the
    loss trajectory matches an uninterrupted run."""
    common = COMMON + ["--device", "cpu", "--ckpt-every", "3"]
    ref = train_main(common + ["--ckpt-dir", str(tmp_path / "a")])
    out1 = train_main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                "--simulate-preemption-at", "7"])
    assert out1.get("preempted_at") == 7
    assert out1["losses"] == ref["losses"][:7]
    out2 = train_main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert out2["resumed_from"] == 6
    np.testing.assert_allclose(out2["losses"][-1], ref["losses"][-1],
                               rtol=1e-4)


@pytest.mark.slow
def test_driver_resumes_a_reference_checkpoint(tmp_path):
    """The reference's driver is preempted at step 7 (checkpoints every 3
    steps); the port's driver resumes its run from step 6, and its loss
    there is the reference's uninterrupted loss at step 6."""
    ref = jtrain_main(COMMON + ["--ckpt-every", "0",
                                "--ckpt-dir", str(tmp_path / "a")])
    pre = jtrain_main(COMMON + ["--ckpt-every", "3",
                                "--simulate-preemption-at", "7",
                                "--ckpt-dir", str(tmp_path / "b")])
    assert pre.get("preempted_at") == 7
    out = train_main(COMMON + ["--device", "cpu", "--ckpt-every", "3",
                               "--ckpt-dir", str(tmp_path / "b")])
    assert out["resumed_from"] == 6 and len(out["losses"]) == 4
    np.testing.assert_allclose(out["losses"][0], ref["losses"][6],
                               **LOSS_TOL)


def test_driver_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(COMMON + ["--ckpt-dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_driver_trains_and_resumes_deepseek(tmp_path, arch):
    """The driver trains the deepseek smoke configs (deepseek-v3 with its
    MTP loss and bf16 moments), checkpoints every 3 steps and, preempted
    at step 5, resumes from 3 on the uninterrupted run's losses."""
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6",
              "--batch", "2", "--seq", "16", "--ckpt-every", "3"]
    ref = train_main(common + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(ref["losses"]) == 6 and np.all(np.isfinite(ref["losses"]))
    pre = train_main(common + ["--ckpt-dir", str(tmp_path / "b"),
                               "--simulate-preemption-at", "5"])
    assert pre.get("preempted_at") == 5
    out = train_main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert out["resumed_from"] == 3 and len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], ref["losses"][3:], rtol=1e-4)


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
def test_driver_plan_equals_reference_driver(fsdp, capsys):
    """The driver compiles its plan as the reference's ``build`` does
    (``build_lm_graph`` of the run's shape, then ``optimize`` on a
    one-slot data axis, ``--fsdp`` passed through): the same plan JSON,
    printed on one ``[train] plan:`` line and held by the LM."""
    import argparse

    from repro.core.ir import reset_fresh_names as jreset
    from repro.launch.train import build as jbuild
    from repro_torch.core.ir import reset_fresh_names
    from repro_torch.launch.train import build

    args = argparse.Namespace(arch="smollm-135m", smoke=True, steps=10,
                              batch=2, seq=16, lr=1e-3, remat="none",
                              fsdp=fsdp, device="cpu")
    jreset()
    want = jbuild(args)[3]
    reset_fresh_names()
    _, lm, _, _ = build(args)
    assert lm.plan.to_json() == want.to_json()
    assert lm.plan.fsdp is fsdp and lm.plan.mesh_spec.axes == \
        (("data", 1), ("model", 1))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] plan:")]
    assert len(lines) == 1 and f"fsdp {fsdp}" in lines[0], lines


def test_driver_returns_its_plan(tmp_path):
    out = train_main(COMMON[:3] + ["--steps", "2", "--batch", "2", "--seq",
                                   "16", "--device", "cpu", "--ckpt-every",
                                   "0", "--ckpt-dir", str(tmp_path)])
    assert out["plan"] is not None and not out["plan"].fsdp
    assert out["plan"].meta["graph"] == "smollm-135m-smoke_cli"
