"""Port vs reference: the bucketed ``ServingEngine``.

Greedy decode of the port's engine gives the reference's bucketed engine's
tokens (``ServingEngine(continuous_batching=False)``) on the ``reduced``
configs, weights carried across from the reference's ``init_params``; EOS
stops, ``cache_bytes``, and the serve cases of ``tests/test_serve.py`` and
``tests/test_resilience.py`` (validation, bounded admission, timeouts,
retry-or-degrade under the port's fault injector — the same spec and seed
give the reference's outcome), which configs the slot-swap path serves, and
seeded sampling that repeats per ``(seed, uid, count)``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import init_params as ref_init_params
from repro.resilience import faults as ref_faults
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import ServingEngine as RefServingEngine
from repro.serve import cache_bytes as ref_cache_bytes

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import forward
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.resilience.errors import (
    AdmissionError,
    KernelUnavailableError,
    ReproValidationError,
)
from repro_torch.resilience.retry import RetryPolicy
from repro_torch.serve import EngineConfig, ServingEngine, cache_bytes

CPU = "cpu"
# every serve site at >= 10%, as tests/test_resilience.py's chaos spec
CHAOS_SPEC = "serve.prefill:oom:0.15,serve.decode:nan:0.10"
CHAOS_SEED = 42
# the reference's engine cannot serve an encoder-decoder from prompts alone
# (its prefill needs audio frames), so whisper is left out of the parity
SERVED = [a for a in sorted(REF_ARCHS) if not REF_ARCHS[a].enc_dec]


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh port and reference fault injectors, port tracer and metrics."""
    faults.configure("", 0)
    ref_faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()
    ref_faults.configure("", 0)


def _setup(name):
    ref_cfg = ref_reduced(REF_ARCHS[name])
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    return ref_cfg, ref_params, reduced(ARCHS[name]), params


@pytest.fixture(scope="module")
def smollm():
    return _setup("smollm-360m")


def _engine(cfg, params, **kw):
    return ServingEngine(cfg, params,
                         EngineConfig(continuous_batching=False, **kw),
                         device=CPU)


def _ref_engine(cfg, params, **kw):
    return RefServingEngine(cfg, params,
                            RefEngineConfig(continuous_batching=False, **kw))


def _submit_mix(engines, vocab, n=6, max_new=5, seed=0):
    """Two buckets (prompt lengths 8 and 12) of the same requests into
    every engine."""
    rng = np.random.default_rng(seed)
    reqs = [(uid, rng.integers(0, vocab, 8 if uid % 2 == 0 else 12))
            for uid in range(n)]
    for eng in engines:
        for uid, prompt in reqs:
            eng.submit(uid, prompt, max_new=max_new)
    return reqs


def _first_call_only(site, kind, calls, rate=0.2):
    """A spec and seed under which the first of ``calls`` calls at ``site``
    faults and the rest do not."""
    for seed in range(10_000):
        rolls = [faults._unit_roll(seed, site, k, f"{kind}0")
                 for k in range(calls)]
        if rolls[0] < rate and min(rolls[1:]) >= rate:
            return f"{site}:{kind}:{rate}", seed
    raise AssertionError("no such seed")


def _outcome(results):
    return {u: (r.ok, r.degraded, r.reason.split(":")[0], r.attempts,
                r.tokens.tolist()) for u, r in results.items()}


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("name", SERVED)
def test_greedy_token_identical_to_reference_bucketed(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    ours = _engine(cfg, params, max_batch=4, max_seq=64)
    theirs = _ref_engine(ref_cfg, ref_params, max_batch=4, max_seq=64)
    _submit_mix([ours, theirs], cfg.vocab)
    got, want = ours.run(), theirs.run()
    assert set(got) == set(want) == set(range(6))
    for uid in want:
        assert got[uid].tolist() == np.asarray(want[uid]).tolist(), uid
        assert len(got[uid]) == 5
    assert ours.last_stats["mode"] == "bucketed"
    for key in ("n_tokens", "decode_steps", "slot_steps",
                "active_slot_steps"):
        assert ours.last_stats[key] == theirs.last_stats[key], key


def test_engine_matches_forward_greedy(smollm):
    """Engine's greedy continuation == argmax over teacher-forced forward."""
    _, _, cfg, params = smollm
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 8)
    eng = _engine(cfg, params, max_batch=1, max_seq=64)
    eng.submit(0, prompt, max_new=4)
    got = eng.run()[0]
    seq, want = list(prompt), []
    for _ in range(4):
        logits, _ = forward(cfg, params, torch.tensor([seq]))
        want.append(int(torch.argmax(logits[0, -1])))
        seq.append(want[-1])
    assert got.tolist() == want


def test_eos_stops_as_the_reference(smollm):
    ref_cfg, ref_params, cfg, params = smollm
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 8)
    eng = _engine(cfg, params, max_batch=1, max_seq=64)
    eng.submit(0, prompt, max_new=8)
    first = eng.run()[0]
    eos = int(first[1])
    ours = _engine(cfg, params, max_batch=1, max_seq=64, eos_id=eos)
    theirs = _ref_engine(ref_cfg, ref_params, max_batch=1, max_seq=64,
                         eos_id=eos)
    for e in (ours, theirs):
        e.submit(0, prompt, max_new=8)
    out = ours.run()[0]
    assert out.tolist() == np.asarray(theirs.run()[0]).tolist()
    assert out.tolist() == first[:2].tolist()


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_cache_bytes_equal(name):
    for cfg, ref in ((ARCHS[name], REF_ARCHS[name]),
                     (reduced(ARCHS[name]), ref_reduced(REF_ARCHS[name]))):
        for batch, seq in ((1, 32768), (8, 512)):
            assert cache_bytes(cfg, batch, seq) == ref_cache_bytes(
                ref, batch, seq)


# ------------------------------------------------------------ resilience
def test_admission_bounded(smollm):
    _, _, cfg, params = smollm
    eng = _engine(cfg, params, max_batch=2, max_seq=64, max_queue=3)
    rng = np.random.default_rng(0)
    for uid in range(3):
        eng.submit(uid, rng.integers(0, cfg.vocab, 8), max_new=2)
    with pytest.raises(AdmissionError) as ei:
        eng.submit(3, rng.integers(0, cfg.vocab, 8))
    assert ei.value.reason == "queue_full"
    assert metrics.export()["counters"]["serve.rejected"] == 1
    assert set(eng.run()) == {0, 1, 2}   # the queue drains
    eng.submit(4, rng.integers(0, cfg.vocab, 8), max_new=2)


def test_submit_validation(smollm):
    _, _, cfg, params = smollm
    eng = _engine(cfg, params, max_batch=2, max_seq=16)
    for bad in (np.array([], np.int32), np.zeros(32, np.int32),
                np.array([1, -2, 3]), np.array([1, cfg.vocab + 5]),
                np.array([np.nan, 1.0]), np.array([1.5, 2.0])):
        with pytest.raises(ReproValidationError):
            eng.submit(0, bad)
    with pytest.raises(ReproValidationError):
        eng.submit(0, np.array([1, 2]), max_new=0)
    assert eng.queue == []
    with pytest.raises(ReproValidationError):
        _engine(cfg, params, max_batch=0)
    with pytest.raises(ReproValidationError):
        _engine(cfg, params, request_timeout_s=-1.0)


def test_chaos_completes_every_request_as_the_reference(smollm):
    """>= 10% injection at both serve sites: every request terminates (ok /
    degraded / typed-failed), the same spec and seed replay the same
    outcome, and the outcome is the reference engine's."""
    ref_cfg, ref_params, cfg, params = smollm

    def run(make, inj):
        inj.configure(CHAOS_SPEC, seed=CHAOS_SEED)
        eng = make(max_batch=4, max_seq=64, max_queue=32)
        rng = np.random.default_rng(0)
        for uid in range(10):
            eng.submit(uid, rng.integers(0, cfg.vocab, 8 if uid % 2 == 0
                                         else 12), max_new=4)
        return eng.run_detailed()

    res = run(lambda **kw: _engine(cfg, params, **kw), faults)
    assert set(res) == set(range(10))
    for r in res.values():
        assert r.ok or (r.degraded and r.reason), r
        assert isinstance(r.tokens, np.ndarray)
    assert any(r.degraded for r in res.values())
    again = run(lambda **kw: _engine(cfg, params, **kw), faults)
    want = run(lambda **kw: _ref_engine(ref_cfg, ref_params, **kw),
               ref_faults)
    assert _outcome(res) == _outcome(again) == _outcome(want)


def test_request_timeout_degrades(smollm):
    _, _, cfg, params = smollm
    eng = _engine(cfg, params, max_batch=1, max_seq=64,
                  request_timeout_s=1e-6)            # expires immediately
    eng.submit(0, np.arange(8) % cfg.vocab, max_new=16)
    res = eng.run_detailed()
    assert res[0].degraded and res[0].reason == "deadline_truncated"
    assert len(res[0].tokens) < 16
    assert metrics.export()["counters"]["serve.deadline_truncated"] >= 1


def test_unbatchable_poison_degrades_to_solo(smollm):
    """A 100% decode-NaN site sinks every attempt, of the bucket and of each
    request alone: each request still ends in a typed failure."""
    _, _, cfg, params = smollm
    faults.configure("serve.decode:nan:1.0", seed=0)
    eng = _engine(cfg, params, max_batch=4, max_seq=64,
                  retry=RetryPolicy(max_attempts=2, base_delay_s=0.001))
    rng = np.random.default_rng(1)
    for uid in range(4):
        eng.submit(uid, rng.integers(0, cfg.vocab, 8), max_new=3)
    res = eng.run_detailed()
    assert set(res) == set(range(4))
    for r in res.values():
        assert not r.ok and r.degraded
        assert "NonFinite" in r.reason or "Retries" in r.reason
    c = metrics.export()["counters"]
    assert c["serve.failed"] == 4 and c["serve.bucket_failed"] == 5


def test_prefill_fault_retried_whole(smollm):
    """One injected prefill OOM (the first bucket's first attempt): that
    bucket is retried whole, tagged ``retried``, and every request gets the
    clean run's tokens."""
    _, _, cfg, params = smollm
    clean = _engine(cfg, params, max_batch=4, max_seq=64)
    _submit_mix([clean], cfg.vocab, n=4)
    want = clean.run()
    faults.configure(*_first_call_only("serve.prefill", "oom", calls=3))
    eng = _engine(cfg, params, max_batch=4, max_seq=64)
    _submit_mix([eng], cfg.vocab, n=4)
    res = eng.run_detailed()
    assert [(u, r.reason, r.attempts) for u, r in sorted(res.items())] == [
        (0, "retried", 2), (1, "", 1), (2, "retried", 2), (3, "", 1)]
    assert {u: r.tokens.tolist() for u, r in res.items()} == {
        u: t.tolist() for u, t in want.items()}


def test_continuous_batching_is_refused(smollm):
    """Only an encoder-decoder is refused the slot-swap path (the twin of
    the reference's ``test_enc_dec_falls_back_to_bucketed``): whisper is
    served bucketed, and the default ``EngineConfig()`` builds the
    continuous engine for a decoder-only config."""
    _, _, cfg, params = smollm
    eng = ServingEngine(cfg, params, EngineConfig(), device=CPU)
    assert eng._continuous
    whisper = reduced(ARCHS["whisper-large-v3"])
    eng = ServingEngine(whisper, {}, EngineConfig(), device=CPU)
    assert not eng._continuous


def test_engine_defaults_to_the_card(smollm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, _, cfg, params = smollm
    with pytest.raises(KernelUnavailableError):
        ServingEngine(cfg, params, EngineConfig(continuous_batching=False))


# ------------------------------------------------------------- sampling
def test_sampling_repeats_per_seed_uid_count(smollm):
    """Temperature sampling is a function of (seed, uid, count): the same
    seed repeats, a request's tokens do not depend on its bucket
    neighbours, and another seed (overwhelmingly) samples others."""
    _, _, cfg, params = smollm
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, 8)
    others = [rng.integers(0, cfg.vocab, 8) for _ in range(3)]

    def sample(seed, with_neighbours=False):
        eng = _engine(cfg, params, max_batch=4, max_seq=64, temperature=1.5,
                      seed=seed)
        eng.submit(7, prompt, max_new=8)
        if with_neighbours:
            for uid, p in enumerate(others):
                eng.submit(uid, p, max_new=8)
        return eng.run()[7].tolist()

    a = sample(1)
    assert a == sample(1) == sample(1, with_neighbours=True)
    assert a != sample(2)
    greedy = _engine(cfg, params, max_batch=1, max_seq=64)
    greedy.submit(7, prompt, max_new=8)
    assert a != greedy.run()[7].tolist()


def test_sampled_tokens_survive_a_retry(smollm):
    """A bucket retried after an injected decode NaN resamples the clean
    run's tokens."""
    _, _, cfg, params = smollm
    kw = dict(max_batch=4, max_seq=64, temperature=1.0, seed=5)
    clean = _engine(cfg, params, **kw)
    _submit_mix([clean], cfg.vocab, n=4)
    want = clean.run()
    faults.configure(*_first_call_only("serve.decode", "nan", calls=9))
    eng = _engine(cfg, params, **kw)
    _submit_mix([eng], cfg.vocab, n=4)
    res = eng.run_detailed()
    assert [r.reason for _, r in sorted(res.items())] == [
        "retried", "", "retried", ""]
    assert {u: r.tokens.tolist() for u, r in res.items()} == {
        u: t.tolist() for u, t in want.items()}
