"""The chat cell's admission reader: a traced CPU run of the continuous
kind (the smoke smollm, which admits every group by the one-pass
prefill) reads ``prefill_ms.cont``, and no side step runs there."""
from __future__ import annotations

from conftest import run_cell


def test_chat_run_reads_the_one_pass_prefill():
    rc, res, _text = run_cell("serve_continuous", trace=1)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["prefill_ms.cont"]["value"] > 0
    assert res["metrics"]["prefill_ms.cont"]["unit"] == "ms"
    assert "side_step_ms.cont" not in res["metrics"]
