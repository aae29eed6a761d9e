"""The port's continuous batcher and serve driver.

Within the port, streamed tokens equal ``decode_offline``, greedy and
sampled.  Across packages, with the reference's params bridged in, greedy
tokens equal the reference's ``decode_offline`` run op by op
(``jax.disable_jit``), where the two packages compute the same bits.
Under ``jit`` XLA fuses elementwise chains and rounds bf16 at other
places, so against the jitted reference the tokens may part only at a
step whose top-2 logits tie within the bf16 tolerance.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import scheduler as TS
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.lm import LM
from torch_parity import numpy_tree

S_MAX = 96
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def served():
    jlm = JLM(jget("smollm-135m", smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("smollm-135m", smoke=True), use_kernels=True,
            device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    return jlm, jparams, lm, params


def _trace(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pl = int(rng.integers(3, 14))
        gen = int(rng.integers(4, 12))
        temp = 0.0 if i % 2 else 0.7
        prompt = rng.integers(0, cfg.vocab, pl).astype(np.int32)
        out.append((prompt, gen, temp))
    return out


def _run(lm, params, trace, *, slots=3, seed=0, eos_id=None,
         max_steps=None):
    b = TS.ContinuousBatcher(lm, params, slots=slots, s_max=S_MAX,
                             seed=seed, eos_id=eos_id)
    for prompt, gen, temp in trace:
        b.submit(prompt, gen, temperature=temp)
    return b.run(max_steps=max_steps)


@pytest.fixture(scope="module")
def base_run(served):
    _, _, lm, params = served
    return _run(lm, params, _trace(lm.cfg))


def test_prefill_bucket():
    assert [TS.prefill_bucket(n) for n in (1, 16, 17)] == [16, 16, 32]
    assert TS.prefill_bucket(33, minimum=8) == 64


def test_streamed_tokens_match_offline(served, base_run):
    _, _, lm, params = served
    assert len(base_run.requests) == 6
    assert {r.temperature for r in base_run.requests} == {0.0, 0.7}
    for r in base_run.requests:
        assert r.finish == "length" and len(r.out) == r.max_new
        assert r.out == TS.decode_offline(lm, params, r, seed=0,
                                          s_max=S_MAX), f"rid {r.rid}"


def test_greedy_tokens_match_reference(served):
    jlm, jparams, lm, params = served
    trace = [(p, g + 8, 0.0) for p, g, _ in _trace(lm.cfg, n=4, seed=3)]
    rep = _run(lm, params, trace, slots=2)
    with jax.disable_jit():
        for r in rep.requests:
            jr = JS.Request(rid=r.rid, prompt_len=r.prompt_len,
                            max_new=r.max_new,
                            prompt=r.prompt.astype(np.int32))
            want = JS.decode_offline(jlm, jparams, jr, seed=0, s_max=S_MAX)
            assert r.out == want, f"rid {r.rid}: {r.out} != {want}"


def test_greedy_tokens_match_jitted_reference_up_to_ties(served):
    """Against the jitted reference, whose bf16 rounding differs in the
    last place, greedy tokens may part only where the reference's own
    top-2 logits are within the bf16 tolerance of each other."""
    jlm, jparams, lm, params = served
    step = jax.jit(jlm.decode_step)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, lm.cfg.vocab, int(rng.integers(3, 14)))
        n = int(rng.integers(16, 32))
        got = TS.decode_offline(lm, params, TS.Request(
            rid=rid, prompt_len=len(prompt), max_new=n, prompt=prompt),
            seed=0, s_max=S_MAX)
        caches = jlm.init_caches(1, S_MAX)
        feed = list(prompt) + got[:-1]
        for t, tok in enumerate(feed):
            logits, caches = step(jparams, {
                "tokens": jnp.asarray([[tok]], jnp.int32),
                "pos": jnp.asarray(t, jnp.int32)}, caches)
            if t < len(prompt) - 1:
                continue
            row = np.asarray(logits[0, -1], np.float32)
            want = int(row.argmax())
            if want != got[t - len(prompt) + 1]:
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= 2e-2 * max(1.0, abs(top2[1])), \
                    f"rid {rid} step {t}: margin {top2[1] - top2[0]}"
                break


@pytest.fixture(scope="module")
def served_xlstm():
    jlm = JLM(jget("xlstm-125m", smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("xlstm-125m", smoke=True), use_kernels=True,
            device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    return jlm, jparams, lm, params


def test_xlstm_streamed_tokens_match_offline(served_xlstm):
    """State caches (MLSTMState, SLSTMState) through the batcher: the
    group prefill installs every leaf into its slot, and each request
    streams the tokens of its own offline decode."""
    _, _, lm, params = served_xlstm
    rep = _run(lm, params, _trace(lm.cfg, n=5, seed=2), slots=2)
    assert len(rep.requests) == 5
    for r in rep.requests:
        assert r.finish == "length" and len(r.out) == r.max_new
        assert r.out == TS.decode_offline(lm, params, r, seed=0,
                                          s_max=S_MAX), f"rid {r.rid}"


def test_xlstm_greedy_tokens_match_reference(served_xlstm):
    jlm, jparams, lm, params = served_xlstm
    trace = [(p, g + 4, 0.0) for p, g, _ in _trace(lm.cfg, n=3, seed=4)]
    rep = _run(lm, params, trace, slots=2)
    with jax.disable_jit():
        for r in rep.requests:
            jr = JS.Request(rid=r.rid, prompt_len=r.prompt_len,
                            max_new=r.max_new,
                            prompt=r.prompt.astype(np.int32))
            want = JS.decode_offline(jlm, jparams, jr, seed=0, s_max=S_MAX)
            assert r.out == want, f"rid {r.rid}: {r.out} != {want}"


def test_xlstm_static_baseline(served_xlstm):
    _, _, lm, params = served_xlstm
    trace = _trace(lm.cfg, n=3, seed=5)
    reqs = [TS.Request(rid=i, prompt_len=len(p), max_new=g, prompt=p,
                       temperature=t) for i, (p, g, t) in enumerate(trace)]
    rep = TS.run_static(lm, params, reqs, seed=0, s_max=S_MAX, slots=2)
    assert rep.generated == sum(g for _, g, _ in trace)


def test_slot_reuse_and_occupancy(served):
    _, _, lm, params = served
    trace = _trace(lm.cfg, n=7)
    rep = _run(lm, params, trace, slots=2)
    assert len(rep.requests) == 7
    assert 0.0 < rep.occupancy <= 1.0
    assert rep.generated == sum(g for _, g, _ in trace)
    d = rep.to_dict()
    assert d["tok_per_s"] > 0 and d["latency_p99_s"] >= d["latency_p50_s"]


def test_eos_evicts_early(served, base_run):
    _, _, lm, params = served
    victim = max(base_run.requests, key=lambda r: len(r.out))
    eos = victim.out[1]
    rep = _run(lm, params, _trace(lm.cfg), eos_id=eos)
    assert any(r.finish == "eos" for r in rep.requests)
    for r in rep.requests:
        assert r.out == TS.decode_offline(lm, params, r, seed=0,
                                          s_max=S_MAX, eos_id=eos)
        if eos in r.out:
            assert r.out.index(eos) == len(r.out) - 1


def test_budget_eviction_terminates(served):
    _, _, lm, params = served
    rep = _run(lm, params, _trace(lm.cfg), max_steps=3)
    assert rep.steps <= 3
    assert any(r.finish == "budget" for r in rep.requests)


def test_sampling_is_keyed_by_seed_request_and_position(served, base_run):
    _, _, lm, params = served
    again = _run(lm, params, _trace(lm.cfg))
    assert [r.out for r in again.requests] == \
        [r.out for r in base_run.requests]
    other = _run(lm, params, _trace(lm.cfg), seed=8)
    assert [r.out for r in other.requests if r.temperature > 0] != \
        [r.out for r in base_run.requests if r.temperature > 0]
    # the same request decodes identically without its co-tenants
    solo = _run(lm, params, _trace(lm.cfg)[:1], slots=1)
    assert solo.requests[0].out == base_run.requests[0].out


def test_moe_configs_refused():
    moe = types.SimpleNamespace(cfg=get_config("jamba-v0.1-52b", smoke=True),
                                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="MoE|capacity"):
        TS.ContinuousBatcher(moe, None, slots=2, s_max=S_MAX)


def test_static_baseline_counts_useful_tokens(served):
    _, _, lm, params = served
    trace = _trace(lm.cfg)
    reqs = [TS.Request(rid=i, prompt_len=len(p), max_new=g, prompt=p,
                       temperature=t) for i, (p, g, t) in enumerate(trace)]
    rep = TS.run_static(lm, params, reqs, seed=0, s_max=S_MAX, slots=3)
    assert rep.generated == sum(g for _, g, _ in trace)
    assert 0.0 < rep.occupancy <= 1.0


def test_serve_main_on_cpu(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    m = serve_main(["--arch", "smollm-135m", "--smoke", "--slots", "2",
                    "--requests", "4", "--prompt-len-range", "3", "10",
                    "--gen-range", "3", "6", "--static", "--device", "cpu"])
    assert m["plan"]["source"] == "cold" and m["device"] == "cpu"
    assert m["continuous"]["requests"] == 4
    assert m["continuous"]["tok_per_s"] > 0 and m["static"]["tok_per_s"] > 0


def test_serve_main_xlstm_on_cpu():
    m = serve_main(["--arch", "xlstm-125m", "--smoke", "--slots", "2",
                    "--requests", "3", "--prompt-len-range", "3", "10",
                    "--gen-range", "3", "6", "--device", "cpu"])
    assert m["arch"] == "xlstm-125m" and m["device"] == "cpu"
    assert m["continuous"]["requests"] == 3
    assert m["continuous"]["generated"] >= 9


SERVE_SMOKE = ["--arch", "smollm-135m", "--smoke", "--slots", "2",
               "--requests", "2", "--prompt-len-range", "3", "10",
               "--gen-range", "3", "4", "--device", "cpu"]


def test_serve_main_fetches_cold_then_hit_and_lints(tmp_path, capsys):
    """The driver fetches its plan through the plan cache as the
    reference's does: cold into an empty cache, then a hit; the lint
    line prints, and ``--no-plan`` skips the fetch."""
    cache = ["--plan-cache", str(tmp_path)]
    first = serve_main(SERVE_SMOKE + cache)
    second = serve_main(SERVE_SMOKE + cache)
    skipped = serve_main(SERVE_SMOKE + ["--no-plan"])
    out = capsys.readouterr().out.splitlines()
    assert first["plan"]["source"] == "cold"
    assert second["plan"]["source"] == "hit"
    assert first["plan"]["bucket"] == second["plan"]["bucket"] \
        == "decode_b2_s128"
    assert second["plan"]["lint"]["ok"] and second["plan"]["cache_stats"][
        "hits_disk"] == 1
    assert skipped["plan"] == {"source": "skipped", "fetch_ms": 0.0}
    plan_lines = [ln for ln in out if ln.startswith("[serve] plan:")]
    assert [ln.split()[2] for ln in plan_lines] == ["cold", "hit",
                                                    "skipped"]
    assert sum(ln.startswith("[serve] lint: analyze: clean")
               for ln in out) == 2


def test_fetch_plan_equals_reference(tmp_path):
    """``fetch_plan`` of both packages, each into its own cache: the same
    bucket, the same source, cold then hit, and the same plan; then the
    reference's cache serves the port a hit."""
    from repro.core.ir import reset_fresh_names as jreset
    from repro.launch.serve import fetch_plan as jfetch
    from repro_torch.core.ir import reset_fresh_names
    from repro_torch.launch.serve import fetch_plan

    got, want = [], []
    for _ in range(2):
        reset_fresh_names()
        got.append(fetch_plan(get_config("xlstm-125m", smoke=True), slots=4,
                              s_max=96, cache_root=tmp_path / "t"))
        jreset()
        want.append(jfetch(jget("xlstm-125m", smoke=True), slots=4,
                           s_max=96, cache_root=tmp_path / "r"))
    for (p, i), (jp, ji) in zip(got, want):
        assert (i["source"], i["bucket"]) == (ji["source"], ji["bucket"])
        assert p.to_json() == jp.to_json()
    assert [i["source"] for _, i in got] == ["cold", "hit"]
    p, i = fetch_plan(get_config("xlstm-125m", smoke=True), slots=4,
                      s_max=96, cache_root=tmp_path / "r")
    assert i["source"] == "hit" and p.to_json() == want[0][0].to_json()


def test_serve_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_main(["--arch", "smollm-135m", "--smoke", "--requests", "1"])


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke``, import without
    loading JAX or anything of the reference package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "repro_torch.launch.serve" in names and len(names) > 20, names
print("ok", len(names))
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


@pytest.fixture(scope="module")
def served_jamba():
    jlm = JLM(jget("jamba-v0.1-52b", smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("jamba-v0.1-52b", smoke=True), use_kernels=True,
            device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    return jlm, jparams, lm, params


def _greedy_requests(mod, trace):
    return [mod.Request(rid=i, prompt_len=len(p), max_new=g,
                        prompt=p.astype(np.int32))
            for i, (p, g, _) in enumerate(trace)]


def test_jamba_static_greedy_tokens_match_reference(served_jamba):
    """MoE configs serve on the static path: one wave of three requests
    through ``run_static``, greedy, equals the reference's ``run_static``
    run op by op, token for token."""
    jlm, jparams, lm, params = served_jamba
    trace = _trace(lm.cfg, n=3, seed=6)
    rep = TS.run_static(lm, params, _greedy_requests(TS, trace), seed=0,
                        s_max=S_MAX, slots=3)
    with jax.disable_jit():
        jrep = JS.run_static(jlm, jparams, _greedy_requests(JS, trace),
                             seed=0, s_max=S_MAX, slots=3)
    assert rep.generated == sum(g for _, g, _ in trace)
    for r, jr in zip(rep.requests, jrep.requests):
        assert r.out == jr.out, f"rid {r.rid}: {r.out} != {jr.out}"


def test_decode_offline_runs_moe_configs(served_jamba):
    """The port's ``decode_offline`` runs a MoE config, as the
    reference's does (it used to refuse them).  At batch 1 no token is
    dropped, and the request whose prompt is its wave's longest (so
    ``run_static`` pads it with nothing) streams the same tokens."""
    jlm, jparams, lm, params = served_jamba
    trace = _trace(lm.cfg, n=3, seed=6)
    rep = TS.run_static(lm, params, _greedy_requests(TS, trace), seed=0,
                        s_max=S_MAX, slots=3)
    longest = max(rep.requests, key=lambda r: r.prompt_len)
    got = TS.decode_offline(lm, params, longest, seed=0, s_max=S_MAX)
    assert len(got) == longest.max_new
    assert got == longest.out
    with jax.disable_jit():
        want = JS.decode_offline(jlm, jparams, JS.Request(
            rid=longest.rid, prompt_len=longest.prompt_len,
            max_new=longest.max_new, prompt=longest.prompt), seed=0,
            s_max=S_MAX)
    assert got == want


def test_serve_main_jamba_on_cpu():
    m = serve_main(["--arch", "jamba-v0.1-52b", "--smoke", "--slots", "2",
                    "--requests", "3", "--prompt-len-range", "3", "10",
                    "--gen-range", "3", "6", "--device", "cpu"])
    assert m["arch"] == "jamba-v0.1-52b" and "continuous" not in m
    assert m["static"]["requests"] == 3 and m["static"]["generated"] >= 9


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_serve_main_deepseek_on_cpu(arch):
    """deepseek serves on the static path, as the reference's does: MLA
    decodes in its absorbed form over the latent cache."""
    m = serve_main(["--arch", arch, "--smoke", "--slots", "2",
                    "--requests", "3", "--prompt-len-range", "3", "10",
                    "--gen-range", "3", "6", "--device", "cpu"])
    assert m["arch"] == arch and "continuous" not in m
    assert m["static"]["requests"] == 3 and m["static"]["generated"] >= 9
