"""The port's ``StragglerMonitor`` and ``scale_batch_schedule`` against
the reference's: the same synthetic timings through both, and the
actions, ``stragglers()`` and ``shard_weights()`` equal at every step.
The sequences are the reference's own tests' (``tests/test_substrate.py``
and ``tests/test_faults.py``) and one seeded fleet."""
import numpy as np
import pytest

from repro.distributed.elastic import scale_batch_schedule as jscale
from repro.distributed.straggler import StragglerMonitor as JMonitor
from repro_torch.distributed import StragglerMonitor, scale_batch_schedule


def _fleet(n_hosts=6, steps=60):
    """Seeded timings: hosts 2 and 5 slow for a stretch, then host 2
    recovers."""
    rng = np.random.default_rng(0)
    out = []
    for s in range(steps):
        t = {h: float(1.0 + 0.05 * rng.standard_normal())
             for h in range(n_hosts)}
        if 5 <= s < 40:
            t[2] *= 2.5
        if s >= 20:
            t[5] *= 1.8
        out.append(("step", t))
    return out


CASES = {
    # tests/test_substrate.py:192: host 3 slow, rebalanced then evicted
    "rebalance_and_evict": (
        dict(n_hosts=4, ema=0.5, threshold=1.4, evict_after=5),
        [("step", {0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0})] * 10),
    # tests/test_substrate.py:207: a straggler that recovers
    "recovery_clears_flag": (
        dict(n_hosts=2, ema=0.1, threshold=1.5),
        [("step", {0: 1.0, 1: 3.0})] * 5 + [("step", {0: 1.0, 1: 1.0})] * 30),
    # tests/test_faults.py:422: unseen hosts, then a zero-second sample
    "unseen_hosts": (dict(n_hosts=4), [("record", {0: 1.0, 1: 2.0})]),
    "zero_seconds": (dict(n_hosts=2, ema=0.0),
                     [("record", {0: 0.0, 1: 1.0})]),
    "fleet": (dict(n_hosts=6, ema=0.8, threshold=1.5, evict_after=10),
              _fleet()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_monitor_matches_reference(case):
    kwargs, seq = CASES[case]
    mine, ref = StragglerMonitor(**kwargs), JMonitor(**kwargs)
    assert mine.shard_weights() == ref.shard_weights()
    for op, times in seq:
        assert getattr(mine, op)(times) == getattr(ref, op)(times)
        assert mine.stragglers() == ref.stragglers()
        assert mine.shard_weights() == ref.shard_weights()


@pytest.mark.parametrize("global_batch,old,new", [
    (64, 16, 8), (64, 8, 16), (48, 4, 3), (12, 1, 12), (10, 2, 4)])
def test_scale_batch_schedule_matches_reference(global_batch, old, new):
    try:
        want = jscale(global_batch, old, new)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            scale_batch_schedule(global_batch, old, new)
        return
    assert scale_batch_schedule(global_batch, old, new) == want
