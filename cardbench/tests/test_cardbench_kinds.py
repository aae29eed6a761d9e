"""Each kind of traffic runs end to end at a small size on the CPU (the
kernels' plain versions) and prints a result line of the benchmark's
shape, untraced and traced."""
from __future__ import annotations

import pytest

from conftest import KINDS, run_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("trace", [0, 1])
def test_kind_runs_and_prints_a_result(kind, trace):
    rc, res, _text = run_cell(kind, trace=trace)
    assert rc == 0
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "compile_s" in res["metrics"]
    else:
        assert "setup_s" in res["metrics"]
        assert len(res["metrics"]) >= 2


def test_same_seed_same_work():
    """One seed serves the same requests and tokens; another seed the
    same lengths in the same order (the batcher's work), other tokens;
    another batch another order."""
    from cardbench import harness as H
    from cardbench.drivers import serve_continuous as sc
    from conftest import files_of
    run = H.Run(name="x", seed=2**31 + 9, seconds=1, trace=False,
                device=__import__("torch").device("cpu"),
                files=files_of("serve_continuous"))
    run.arch = run.files["config"]["arch"]
    a, b = sc.batch_requests(run, 0), sc.batch_requests(run, 0)
    assert all((x[0] == y[0]).all() and x[1] == y[1] for x, y in zip(a, b))
    run.seed += 1
    c = sc.batch_requests(run, 0)
    assert [(len(x[0]), x[1]) for x in a] == [(len(x[0]), x[1]) for x in c]
    assert any((x[0] != y[0]).any() for x, y in zip(a, c))
    d = sc.batch_requests(run, 1)
    assert sorted(len(x[0]) for x in a) == sorted(len(x[0]) for x in d)
    assert [len(x[0]) for x in a] != [len(x[0]) for x in d]


def test_lengths_are_the_published_means_quantiles():
    """The serving cells' lengths: the midpoint quantiles of lognormals
    with LMSYS-Chat-1M's mean prompt and response, the same set in every
    batch, in an order of the batch's own."""
    import json
    from cardbench import harness as H
    from conftest import ROOT
    tr = json.loads((ROOT / "cardbench" / "traffic" / "chat-cont32.json")
                    .read_text())
    p = H.length_set(tr["prompt_len"], 64)
    m = H.length_set(tr["max_new"], 64)
    assert (min(p), max(p), min(m), max(m)) == (4, 473, 12, 1460)
    assert abs(sum(p) / 64 - 69.5) < 2 and abs(sum(m) / 64 - 214.5) < 5
    a, b = H.lengths(tr["prompt_len"], tr["max_new"], 64, 0), \
        H.lengths(tr["prompt_len"], tr["max_new"], 64, 1)
    assert sorted(a[0]) == sorted(b[0]) == p and a[0] != b[0]
