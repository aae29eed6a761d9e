"""The LM under a mesh against the same LM without one.

On a ``(2, 2)`` mesh of 4 gloo ranks (``tests/torch_ranks.py``, mode
``layouts``), smollm-135m's smoke LM (GQA, dense MLP, tied head; remat
``full``, as the dry-run runs it) takes one seeded batch with its params
and batch placed by a hand-written plan with FSDP on:

* ``seq``: batch over ``data``, seq over ``model`` (sequence
  parallelism: ``core.plan.attend`` runs each rank's seq block against
  gathered keys, ``project`` carries the split through the products);
* ``tensor``: batch over ``data``; ``d_model``, ``d_ff`` and vocab over
  ``model`` (``project``'s contracted and column splits, the vocab-split
  loss of ``logsumexp_and_take``).

Its loss and every param's gradient (gathered) are held to the plain
LM's at the bf16 tolerance, 2e-2: the loss relative to itself, each
gradient relative to its leaf's largest plain gradient.  The dry-run
(``tests/test_torch_dryrun.py``) runs these paths on fake tensors only;
this holds their values.
"""
import pytest

import torch_parity  # noqa: F401  (one torch thread per pytest worker)
from torch_ranks import spawn

PLANS = {
    "seq": {"batch": ["data"], "seq": ["model"]},
    "tensor": {"batch": ["data"], "d_model": ["model"], "d_ff": ["model"],
               "vocab": ["model"]},
}
TOL = 2e-2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    spec = {"arch": "smollm-135m", "remat": "full", "batch": 4, "seq": 32,
            "plans": PLANS}
    return spawn("layouts", 4, spec, tmp_path_factory.mktemp("layouts"))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_lm_on_a_mesh_matches_plain(results, plan):
    for rank, out in enumerate(results):
        got = out[plan]
        assert abs(got["loss"] - got["loss_plain"]) \
            <= TOL * abs(got["loss_plain"]), (rank, got)
        assert got["grad_rel"] <= TOL, (rank, got)
