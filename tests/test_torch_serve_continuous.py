"""Port vs reference: slot-swap continuous batching.

The port's twins of ``tests/test_serve_continuous.py``: greedy slot-swap
decode gives the port's bucketed engine's tokens, and the reference's
bucketed engine's, on mixed-length prompts with varied ``max_new`` and
staggered EOS, for a dense config, MLA and rwkv6; an encoder-decoder is
served bucketed; per-slot deadlines, chaos, a poisoned decode, queue wait
observed once per request, the swap and occupancy metrics, and sampling
that depends on ``(seed, uid, count)`` only. Beside them, the per-row
primitives against the reference: ``attn_decode(positions=)``,
``mla_decode(positions=)`` (a row at the cache's end writes nothing) and
``write_slot`` / ``prefill(state=, slot=)``.

A MoE layer drops the tokens past its experts' capacity, and the capacity
grows with the number of tokens in the call: a prompt prefilled alone (a
slot swap) can drop tokens that the same prompt prefilled in a bucket keeps.
That is why the reference's own MLA case fails (ROADMAP §C.4; its MLA
config is a MoE). The MLA cursors are held here with a capacity that drops
nothing, and the dropping case on its own: there the port's continuous
engine gives the reference's continuous engine's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attention
from repro.models import init_params as ref_init_params
from repro.models import mla as ref_mla
from repro.models import model as ref_model
from repro.resilience import faults as ref_faults
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import ServingEngine as RefServingEngine

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import attention, mla
from repro_torch.models import model as model_lib
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.resilience.errors import ReproValidationError
from repro_torch.resilience.retry import RetryPolicy
from repro_torch.serve import EngineConfig, ServingEngine

CPU = "cpu"
CHAOS_SPEC = "serve.prefill:oom:0.15,serve.decode:nan:0.10"
CHAOS_SEED = 42
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh port and reference fault injectors, port tracer and metrics;
    the port's tracer records for the test (it is off by default), as the
    tests read the engine's spans."""
    faults.configure("", 0)
    ref_faults.configure("", 0)
    trace.enable()
    yield
    trace.enable(False)
    trace.reset()
    metrics.reset()
    faults.reset()
    ref_faults.configure("", 0)


def _setup(name, **replace):
    ref_cfg = ref_reduced(REF_ARCHS[name]).replace(**replace)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    return ref_cfg, ref_params, reduced(ARCHS[name]).replace(**replace), \
        params


@pytest.fixture(scope="module")
def smollm():
    return _setup("smollm-360m")


def _mixed_workload(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    lens = [8, 12, 8, 16, 12, 9, 8, 16][:n]
    return [(uid, rng.integers(0, cfg.vocab, L), 3 + (uid % 3) * 3)
            for uid, L in enumerate(lens)]


def _run(cfg, params, workload, **ekw):
    ekw = {"max_batch": 4, "max_seq": 64, **ekw}
    eng = ServingEngine(cfg, params, EngineConfig(**ekw), device=CPU)
    for uid, prompt, max_new in workload:
        eng.submit(uid, prompt, max_new=max_new)
    return eng, eng.run_detailed()


def _ref_run(cfg, params, workload, **ekw):
    eng = RefServingEngine(cfg, params, RefEngineConfig(
        max_batch=4, max_seq=64, **ekw))
    for uid, prompt, max_new in workload:
        eng.submit(uid, prompt, max_new=max_new)
    return {u: r.tokens.tolist() for u, r in eng.run_detailed().items()}


def _tokens(res):
    return {u: r.tokens.tolist() for u, r in res.items()}


# ----------------------------------------------------- oracle equivalence
def test_greedy_matches_bucketed_oracle(smollm):
    """Slot-swap greedy decode gives the bucketed path's tokens, the port's
    and the reference's, on mixed-length prompts with varied max_new."""
    ref_cfg, ref_params, cfg, params = smollm
    wl = _mixed_workload(cfg)
    _, ref = _run(cfg, params, wl, continuous_batching=False)
    eng, got = _run(cfg, params, wl, continuous_batching=True)
    assert eng.last_stats["mode"] == "continuous"
    assert set(got) == set(ref) == set(range(8))
    for uid in ref:
        assert got[uid].tokens.tolist() == ref[uid].tokens.tolist(), uid
        assert got[uid].ok and ref[uid].ok
    assert _tokens(got) == _ref_run(ref_cfg, ref_params, wl,
                                    continuous_batching=False)


def test_greedy_matches_oracle_with_staggered_eos(smollm):
    """Rows hitting EOS at different depths swap out early; outputs still
    match the bucketed path exactly."""
    _, _, cfg, params = smollm
    wl = _mixed_workload(cfg)
    _, free = _run(cfg, params, wl, continuous_batching=True)
    counts = {}
    for r in free.values():
        for t in r.tokens.tolist()[1:]:
            counts[t] = counts.get(t, 0) + 1
    eos = max(counts, key=counts.get)
    _, ref = _run(cfg, params, wl, continuous_batching=False, eos_id=eos)
    _, got = _run(cfg, params, wl, continuous_batching=True, eos_id=eos)
    lengths = set()
    for uid in ref:
        assert got[uid].tokens.tolist() == ref[uid].tokens.tolist(), uid
        lengths.add(len(got[uid].tokens))
    assert len(lengths) > 1, "EOS stops did not stagger"


def _no_drop(name):
    """A capacity factor under which no MoE layer drops a token: each
    expert can take every token of the call (top-k picks distinct experts)."""
    cfg = REF_ARCHS[name]
    return ({"capacity_factor": float(ref_reduced(cfg).n_experts)}
            if cfg.mlp == "moe" else {})


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-3b"])
def test_greedy_matches_oracle_other_mixers(arch):
    """Per-row cursors hold for MLA latent caches and recurrent state: the
    continuous tokens equal the port's and the reference's bucketed ones."""
    ref_cfg, ref_params, cfg, params = _setup(arch, **_no_drop(arch))
    wl = _mixed_workload(cfg, n=5)
    _, ref = _run(cfg, params, wl, continuous_batching=False)
    _, got = _run(cfg, params, wl, continuous_batching=True)
    for uid in ref:
        assert got[uid].tokens.tolist() == ref[uid].tokens.tolist(), uid
    assert _tokens(got) == _ref_run(ref_cfg, ref_params, wl,
                                    continuous_batching=False)


def test_moe_capacity_drops_as_the_reference():
    """At the configured capacity a MoE prefill drops tokens by how many
    share the call. The port's continuous engine then gives the reference's
    continuous engine's tokens, and the bucketed path's for every request
    whose prompt drops the same tokens alone as in its bucket."""
    ref_cfg, ref_params, cfg, params = _setup("deepseek-v2-lite-16b")
    wl = _mixed_workload(cfg, n=5)
    _, bucketed = _run(cfg, params, wl, continuous_batching=False)
    _, got = _run(cfg, params, wl, continuous_batching=True)
    assert _tokens(got) == _ref_run(ref_cfg, ref_params, wl,
                                    continuous_batching=True)
    differ = [u for u in got
              if got[u].tokens.tolist() != bucketed[u].tokens.tolist()]
    assert differ == [1]      # uid 1: 12 tokens alone -> capacity 8 < 16


def test_enc_dec_falls_back_to_bucketed():
    """A slot swap has no per-row encoder output scatter: whisper-style
    configs use the bucketed path."""
    cfg = reduced(ARCHS["whisper-large-v3"])
    eng = ServingEngine(cfg, {}, EngineConfig(max_batch=2, max_seq=32),
                        device=CPU)
    assert not eng._continuous


def test_idle_rows_run_past_the_cache_end(smollm):
    """Idle slots keep decoding and their cursors run past ``max_seq``: their
    writes are dropped, nothing raises, and the served tokens are the
    bucketed path's."""
    _, _, cfg, params = smollm
    rng = np.random.default_rng(4)
    wl = [(0, rng.integers(0, cfg.vocab, 20), 2),
          (1, rng.integers(0, cfg.vocab, 6), 20)]
    kw = dict(max_batch=3, max_seq=26)
    _, ref = _run(cfg, params, wl, continuous_batching=False, **kw)
    eng, got = _run(cfg, params, wl, continuous_batching=True, **kw)
    assert _tokens(got) == _tokens(ref)
    # uid 0's row, idle after one step, stepped on with the pool from 20
    assert 20 + eng.last_stats["decode_steps"] > kw["max_seq"]


# ------------------------------------------------------ per-slot deadline
def test_per_slot_deadline_truncates(smollm):
    _, _, cfg, params = smollm
    _, res = _run(cfg, params, [(0, np.arange(8), 16)],
                  continuous_batching=True, request_timeout_s=1e-6)
    assert res[0].ok and res[0].degraded
    assert res[0].reason == "deadline_truncated"
    assert 1 <= len(res[0].tokens) < 16


def test_timeout_zero_means_expire_now(smollm):
    """request_timeout_s=0 is a real (immediate) deadline, not 'disabled'."""
    _, _, cfg, params = smollm
    _, res = _run(cfg, params, [(0, np.arange(8), 16)],
                  continuous_batching=True, request_timeout_s=0.0)
    assert res[0].degraded and res[0].reason == "deadline_truncated"
    assert len(res[0].tokens) < 16


def test_negative_timeout_rejected(smollm):
    _, _, cfg, params = smollm
    with pytest.raises(ReproValidationError):
        ServingEngine(cfg, params,
                      EngineConfig(max_seq=64, request_timeout_s=-0.5),
                      device=CPU)


# ----------------------------------------------------------------- chaos
def test_chaos_every_uid_terminal_and_deterministic(smollm):
    """Injected prefill/decode faults: every admitted uid ends in a terminal
    RequestResult, and a fresh engine with a freshly seeded injector replays
    the same outcome."""
    _, _, cfg, params = smollm

    def chaos_run():
        faults.configure(CHAOS_SPEC, seed=CHAOS_SEED)
        _, res = _run(cfg, params, _mixed_workload(cfg),
                      continuous_batching=True, max_queue=32)
        return res

    res = chaos_run()
    assert set(res) == set(range(8))
    for r in res.values():
        assert r.ok or (r.degraded and r.reason), r
        assert isinstance(r.tokens, np.ndarray)
    assert metrics.export()["counters"].get("resilience.retries", 0) >= 1
    res2 = chaos_run()
    assert {u: (r.ok, r.degraded, r.tokens.tolist())
            for u, r in res.items()} == \
           {u: (r.ok, r.degraded, r.tokens.tolist())
            for u, r in res2.items()}


def test_poisoned_decode_fails_per_slot_not_engine(smollm):
    """A 100% decode-NaN site: every request still ends in a typed failure
    and the scheduler itself never raises."""
    _, _, cfg, params = smollm
    faults.configure("serve.decode:nan:1.0", seed=0)
    _, res = _run(cfg, params, _mixed_workload(cfg, n=5),
                  continuous_batching=True,
                  retry=RetryPolicy(max_attempts=2, base_delay_s=0.001))
    assert set(res) == set(range(5))
    for r in res.values():
        assert not r.ok and r.degraded
        assert "NonFinite" in r.reason or "Retries" in r.reason
    assert metrics.export()["counters"]["serve.failed"] == 5


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("continuous", [True, False])
def test_queue_wait_observed_once_per_request(smollm, continuous):
    """Retried work does not observe serve.queue_wait_s again: one sample
    per request, taken at the first service attempt."""
    _, _, cfg, params = smollm
    faults.configure("serve.prefill:oom:0.5", seed=3)
    wl = _mixed_workload(cfg, n=6)
    _, res = _run(cfg, params, wl, continuous_batching=continuous)
    exported = metrics.export()
    assert exported["histograms"]["serve.queue_wait_s"]["count"] == len(wl)
    assert exported["counters"].get(
        "resilience.retries.serve.prefill" if continuous
        else "resilience.retries.serve.bucket", 0) >= 1
    assert set(res) == {uid for uid, _, _ in wl}


def test_swap_and_occupancy_metrics(smollm):
    _, _, cfg, params = smollm
    wl = _mixed_workload(cfg)
    eng, res = _run(cfg, params, wl, continuous_batching=True)
    exported = metrics.export()
    assert exported["histograms"]["serve.swap_s"]["count"] == len(wl)
    assert 0.0 <= exported["gauges"]["serve.slot_occupancy"] <= 1.0
    assert "serve.slot_idle_frac" in exported["gauges"]
    assert len(trace.get_tracer().spans("serve.continuous")) == 1
    st = eng.last_stats
    assert st["mode"] == "continuous"
    assert st["swaps"] == len(wl)
    assert 0 < st["active_slot_steps"] <= st["slot_steps"]
    assert st["n_tokens"] == sum(len(r.tokens) for r in res.values())


# ------------------------------------------------- sampling determinism
def test_sampling_independent_of_fault_history(smollm):
    """A retried, fault-ridden run serves the clean run's tokens for every
    request that completes."""
    _, _, cfg, params = smollm
    wl = _mixed_workload(cfg, n=6)

    def run(spec):
        faults.configure(spec, seed=7)
        _, res = _run(cfg, params, wl, continuous_batching=True,
                      temperature=1.0, seed=5)
        return {u: (r.ok, r.tokens.tolist()) for u, r in res.items()}

    clean = run("")
    chaotic = run("serve.prefill:oom:0.3,serve.decode:oom:0.2")
    assert (metrics.export()["counters"].get("resilience.retries", 0) >= 1
            or any(not ok for ok, _ in chaotic.values()))
    for uid, (ok, toks) in chaotic.items():
        if ok:
            assert toks == clean[uid][1], uid


def test_sampled_stream_matches_bucketed(smollm):
    """Both scheduling paths draw from the same (seed, uid, count) seeds, so
    temperature sampling does not depend on the schedule."""
    _, _, cfg, params = smollm
    wl = _mixed_workload(cfg, n=6)
    _, ref = _run(cfg, params, wl, continuous_batching=False,
                  temperature=1.0, seed=3)
    _, got = _run(cfg, params, wl, continuous_batching=True,
                  temperature=1.0, seed=3)
    for uid in ref:
        assert got[uid].tokens.tolist() == ref[uid].tokens.tolist(), uid


# ----------------------------------------- per-row primitives, direct parity
def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attn_decode_positions_matches_reference():
    """Per-row K/V writes and masks, sliding window included (starcoder2's
    reduced window is 32); the row at ``max_seq`` writes nothing."""
    name = "starcoder2-3b"
    ref_cfg = ref_reduced(REF_ARCHS[name])
    cfg = reduced(ARCHS[name])
    p_ref = jax.tree.map(lambda a: np.asarray(a[0]), ref_init_params(
        ref_cfg, jax.random.PRNGKey(0))["blocks"]["attn"])
    p = {k: torch.from_numpy(v.copy()) for k, v in p_ref.items()}
    B, S = 4, 40
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, S, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    pos = np.array([3, 35, S, 17])
    want, wc = ref_attention.attn_decode(
        ref_cfg, p_ref, jnp.asarray(x),
        ref_attention.KVCache(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
                              index=jnp.zeros((), jnp.int32)),
        positions=jnp.asarray(pos, jnp.int32))
    cache = attention.KVCache(k=torch.from_numpy(kv[0].copy()),
                              v=torch.from_numpy(kv[1].copy()), index=0)
    got, gc = attention.attn_decode(cfg, p, torch.from_numpy(x), cache,
                                    positions=torch.from_numpy(pos))
    _close(got, want)
    _close(gc.k, wc.k)
    _close(gc.v, wc.v)
    np.testing.assert_array_equal(gc.k[2].numpy(), kv[0][2])   # dropped


def test_mla_decode_positions_matches_reference():
    name = "deepseek-v2-lite-16b"
    ref_cfg = ref_reduced(REF_ARCHS[name])
    cfg = reduced(ARCHS[name])
    p_ref = jax.tree.map(lambda a: np.asarray(a[0]), ref_init_params(
        ref_cfg, jax.random.PRNGKey(0))["blocks"]["mla"])
    p = {k: torch.from_numpy(v.copy()) for k, v in p_ref.items()}
    B, S = 3, 24
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    c_kv = rng.normal(size=(B, S, cfg.kv_lora)).astype(np.float32)
    k_rope = rng.normal(size=(B, S, cfg.qk_rope_dims)).astype(np.float32)
    pos = np.array([S, 0, 11])
    want, wc = ref_mla.mla_decode(
        ref_cfg, p_ref, jnp.asarray(x),
        ref_mla.MLACache(c_kv=jnp.asarray(c_kv), k_rope=jnp.asarray(k_rope),
                         index=jnp.zeros((), jnp.int32)),
        positions=jnp.asarray(pos, jnp.int32))
    got, gc = mla.mla_decode(
        cfg, p, torch.from_numpy(x),
        mla.MLACache(c_kv=torch.from_numpy(c_kv.copy()),
                     k_rope=torch.from_numpy(k_rope.copy()), index=0),
        positions=torch.from_numpy(pos))
    _close(got, want)
    _close(gc.c_kv, wc.c_kv)
    _close(gc.k_rope, wc.k_rope)
    np.testing.assert_array_equal(gc.c_kv[0].numpy(), c_kv[0])  # dropped


# prefill and decode through the whole model: the bar of
# tests/test_torch_models.py (a MoE's or rwkv6's reductions run in other
# orders in the two packages)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
POOL_ARCHS = ["smollm-360m", "deepseek-v2-lite-16b", "rwkv6-3b", "zamba2-7b"]


def _fill(ref_state, rng):
    """The reference state with every batched leaf (rank >= 2) drawn from
    ``rng``, as numpy arrays."""
    return jax.tree.map(
        lambda a: (rng.normal(size=a.shape).astype(np.float32)
                   if np.ndim(a) >= 2 else np.asarray(a)), ref_state)


def _port_state(cfg, ref_state, batch, seq, per_row):
    """The port's state holding the values of the reference's (stacked on
    a leading L or site axis there, one cache per layer or site here)."""
    st = model_lib.init_decode_state(cfg, batch, seq, torch.float32, CPU,
                                     per_row=per_row)
    for caches, stacked in ((st.layer, ref_state.layer),
                            (st.shared or [], ref_state.shared)):
        for i, cache in enumerate(caches):
            for name in cache._fields:
                t = getattr(cache, name)
                if isinstance(t, torch.Tensor):
                    t.copy_(torch.from_numpy(getattr(stacked, name)[i]))
    step = (torch.from_numpy(np.asarray(ref_state.step, np.int64))
            if per_row else int(ref_state.step))
    return st._replace(step=step)


def _assert_pool_equal(cfg, got, want, check):
    for caches, stacked in ((got.layer, want.layer),
                            (got.shared or [], want.shared)):
        for i, cache in enumerate(caches):
            for name in cache._fields:
                t = getattr(cache, name)
                if isinstance(t, torch.Tensor):
                    check(t.numpy(), np.asarray(getattr(stacked, name)[i]))
    assert got.step.tolist() == np.asarray(want.step).tolist()


@pytest.mark.parametrize("name", POOL_ARCHS)
def test_write_slot_matches_reference(name):
    """``write_slot`` of the same batch-1 state into row 1 of the same pool
    (every leaf random): the whole pool, shared sites and cursors included,
    equals the reference's bit for bit."""
    ref_cfg, cfg = ref_reduced(REF_ARCHS[name]), reduced(ARCHS[name])
    B, S = 3, 16
    rng = np.random.default_rng(3)
    pool = _fill(ref_model.init_decode_state(ref_cfg, B, S, jnp.float32,
                                             per_row=True), rng)
    pool = pool._replace(step=np.array([4, 9, 2], np.int32))
    fresh = _fill(ref_model.init_decode_state(ref_cfg, 1, S, jnp.float32),
                  rng)._replace(step=np.int32(7))
    want = ref_model.write_slot(
        ref_cfg, jax.tree.map(jnp.asarray, pool),
        jax.tree.map(jnp.asarray, fresh), jnp.asarray(1, jnp.int32))
    got = model_lib.write_slot(
        cfg, _port_state(cfg, pool, B, S, per_row=True),
        _port_state(cfg, fresh, 1, S, per_row=False), 1)
    _assert_pool_equal(cfg, got, want, np.testing.assert_array_equal)
    assert got.step.tolist() == [4, 7, 2]


@pytest.mark.parametrize("name", POOL_ARCHS)
def test_slot_prefill_matches_reference(name):
    """A pool of three slots: a request prefilled into slot 1, two masked
    decode steps, then another request prefilled into slot 1 over it. The
    logits and the whole pool equal the reference's."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    B, S = 3, 24
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, cfg.vocab, 7), rng.integers(0, cfg.vocab, 5)
    steps = rng.integers(0, cfg.vocab, (2, B, 1))
    rs = ref_model.init_decode_state(ref_cfg, B, S, jnp.float32,
                                     per_row=True)
    ps = model_lib.init_decode_state(cfg, B, S, torch.float32, CPU,
                                     per_row=True)
    assert ps.step.dtype == torch.int64 and ps.step.shape == (B,)
    logits = []
    for prompt, tokens in ((a, steps), (b, [])):
        wl, rs = ref_model.prefill(ref_cfg, ref_params,
                                   jnp.asarray(prompt[None]), S, state=rs,
                                   slot=jnp.asarray(1, jnp.int32))
        gl, ps = model_lib.prefill(cfg, params,
                                   torch.from_numpy(prompt[None]), S,
                                   state=ps, slot=1)
        logits.append((gl, wl))
        for tok in tokens:
            wl, rs = ref_model.decode_step(ref_cfg, ref_params,
                                           jnp.asarray(tok), rs)
            gl, ps = model_lib.decode_step(cfg, params,
                                           torch.from_numpy(tok), ps)
            logits.append((gl, wl))
    for gl, wl in logits:
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL_TOL)
    assert ps.step.tolist() == [2, 5, 2]
    _assert_pool_equal(cfg, ps, rs, lambda g, w: np.testing.assert_allclose(
        g, w, **MODEL_TOL))
