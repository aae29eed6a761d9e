"""On the card: each kind of traffic at the small size through the
port's CUDA kernels and graphs, traced, correct, with device time in
its trace (``python -m pytest -m gpu cardbench/tests`` on a machine with
an NVIDIA GPU; skipped elsewhere)."""
from __future__ import annotations

import pytest

from conftest import KINDS, run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kind_on_the_card(kind, cuda):
    rc, res, _ = run_cell(kind, trace=1, device=str(cuda))
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
