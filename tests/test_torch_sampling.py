"""How the scheduler turns a step's logits into tokens (``_Tokens``), on
the CPU with the card's branch forced by the module's CUDA predicate.

On the card a greedy row takes the device's argmax and only the token
ids come to the host; a row that samples has its logits row copied and
drawn by ``_sample``.  Each case holds the helper to ``_sample`` itself,
row by row, on logits with planted ties; the serving paths, with the
card's branch forced, stream the host branch's tokens, and
``ServeReport`` counts every served token once.  ``test_torch_serve.py``
holds the card's branch to the reference's greedy tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import scheduler as TS
from repro_torch.models.lm import LM

S_MAX = 64
VOCAB = 1000
SEED = 5


@pytest.fixture(scope="module")
def smollm():
    """The smoke smollm with the kernels' plain versions, and params from
    seed 0."""
    lm = LM(get_config("smollm-135m", smoke=True), use_kernels=True,
            device="cpu")
    return lm, lm.init(0)[0]


def _tied_logits(dtype) -> torch.Tensor:
    """(16, VOCAB) random logits with equal maxima planted at several
    indices of most rows: three inside the row, at both ends, the whole
    row constant, and a maximum repeated next to itself."""
    gen = torch.Generator().manual_seed(3)
    rows = torch.randn((16, VOCAB), generator=gen)
    rng = np.random.default_rng(4)
    for i in range(12):
        at = sorted(rng.choice(VOCAB, 3, replace=False))
        rows[i, at] = rows[i].max() + 0.5
    rows[12, [0, VOCAB - 1]] = rows[12].max() + 1.0
    rows[13] = 0.25
    rows[14, 500:502] = rows[14].max() + 2.0
    return rows.to(dtype)


MIXED = [0.0, 0.7, 0.0, 1.3] * 4


@pytest.mark.parametrize("card", [True, False], ids=["card", "host"])
@pytest.mark.parametrize("temps", [[0.0] * 16, MIXED],
                         ids=["greedy", "mixed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tokens_equal_sample(dtype, temps, card, monkeypatch):
    """Every row's token is ``_sample``'s on the row's f32 logits, for its
    seed, rid and position: the greedy ones the first maximal index; on
    the card only the rows that sample come to the host, and the served
    counts split by where each token was chosen."""
    monkeypatch.setattr(TS, "_on_card", lambda t: card)
    rows = _tied_logits(dtype)
    host = rows.float().numpy()
    assert ((host == host.max(-1, keepdims=True)).sum(-1)[:15] >= 2).all()
    picks = TS._Tokens(rows, temps, SEED)
    rep = TS.ServeReport()
    for i, t in enumerate(temps):
        rid, pos = 7 + i, 20 + 3 * i
        assert picks.take(i, rid, pos, rep) == \
            TS._sample(host[i], SEED, rid, pos, t), f"row {i}"
    sampled = {i for i, t in enumerate(temps) if t > 0}
    assert set(picks.host) == (sampled if card else set(range(16)))
    greedy = len(temps) - len(sampled)
    assert rep.device_tokens == (greedy if card else 0)
    assert rep.host_tokens == len(temps) - rep.device_tokens
    # the planted ties of the greedy rows resolve to their first index
    for i, first in ((12, 0), (13, 0), (14, 500)):
        if temps[i] == 0:
            assert picks.take(i, 0, 0) == first


def _requests(cfg, n, temperature, seed):
    """``n`` requests of unequal prompts, every other one at
    ``temperature``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pl = int(rng.integers(3, 20))
        out.append(TS.Request(rid=i, prompt_len=pl,
                              max_new=int(rng.integers(4, 10)),
                              prompt=rng.integers(0, cfg.vocab, pl),
                              temperature=temperature if i % 2 else 0.0))
    return out


def _serve(path, lm, params, reqs):
    """``reqs`` (fresh copies) through the batcher, seven requests
    through three slots with admission and eviction, or through
    ``run_static``, waves of three whose shorter prompts are padded."""
    reqs = [TS.Request(rid=r.rid, prompt_len=r.prompt_len,
                       max_new=r.max_new, prompt=r.prompt,
                       temperature=r.temperature) for r in reqs]
    if path == "static":
        return TS.run_static(lm, params, reqs, seed=SEED, s_max=S_MAX,
                             slots=3)
    b = TS.ContinuousBatcher(lm, params, slots=3, s_max=S_MAX, seed=SEED)
    for r in reqs:
        b.submit(r.prompt, r.max_new, temperature=r.temperature)
    return b.run()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "mixed"])
@pytest.mark.parametrize("path", ["continuous", "static"])
def test_card_branch_serves_host_tokens(path, temperature, smollm,
                                        monkeypatch):
    """With the card's branch forced, each serving path streams the host
    branch's tokens (which the exact batcher tests hold to
    ``decode_offline``), every row's temperature reaching its row, and
    the report counts each served token once: on the host branch all of
    them as host tokens, on the card's the sampled requests' alone."""
    lm, params = smollm
    reqs = _requests(lm.cfg, 7, temperature, seed=1)
    host = _serve(path, lm, params, reqs)
    monkeypatch.setattr(TS, "_on_card", lambda t: True)
    card = _serve(path, lm, params, reqs)
    assert [r.out for r in card.requests] == [r.out for r in host.requests]
    assert all(len(r.out) == r.max_new for r in card.requests)
    assert host.device_tokens == 0 and host.host_tokens == host.generated
    assert card.generated == sum(len(r.out) for r in card.requests)
    assert card.device_tokens + card.host_tokens == card.generated
    assert card.host_tokens == sum(len(r.out) for r in card.requests
                                   if r.temperature > 0)
    assert (card.host_tokens > 0) == (temperature > 0)
