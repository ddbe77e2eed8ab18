"""Port vs reference: one-device training.

The port's twins of ``tests/test_train.py``'s one-device cases and of the
checkpoint and data cases of ``tests/test_resilience.py``: the LR schedule,
AdamW's update, loss and gradients of ``make_loss_fn`` on the ten
``reduced`` configs against ``jax.value_and_grad``, three train steps,
``SyntheticLM`` batches bit for bit, checkpoints (round trip, bf16 leaves,
CRC fallback, keep-K, strict ``step=``, write faults retried, restore across
the two packages in both directions), the runner (resume bit for bit, the
non-finite skip, stragglers, preemption) and both ``launch`` CLIs on the
CPU.

Tolerances, all measured on the CPU against float64 as the referee:

* loss ``rtol=1e-5``.
* gradients ``rtol=1e-4, atol=1e-5 x max|g|`` per leaf. Two fp32
  computations of one gradient that add in other orders differ by what
  each is off from the exact value: the reference's own fp32 gradient is
  up to 1.0e-5 x max|g| from the float64 one (rwkv6's ``tmix/wr``), and
  there the port's is closer (4.6e-7 against 1.5e-6 absolute). The port is
  also held to the same bar against its own float64 gradient.
* parameters after three steps ``atol=0.05 x lr``: Adam moves an element by
  about ``lr x m/sqrt(v)``, which for a gradient a few ulps from zero is
  ``lr`` in magnitude whatever tiny value the gradient has, so a rounding
  difference in such an element shows up at the scale of ``lr``; measured
  at most 0.0101 x lr on the two configs held here.
"""
import json
import os
import signal
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init_params
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import checkpoint as ref_ckpt
from repro.train import make_loss_fn as ref_make_loss_fn
from repro.train import make_train_step as ref_make_train_step
from repro.train import optimizer as ref_opt

from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.models.transformer import leaves, tree_map
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.resilience.errors import (
    CheckpointCorruptError,
    KernelUnavailableError,
)
from repro_torch.train import (
    OptimizerConfig, RunnerConfig, TrainRunner, make_eval_step,
    make_loss_fn, make_train_step, checkpoint as ckpt, optimizer as opt,
)
from repro_torch.train.train_step import value_and_grad

CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
STEP_ATOL_LR = 0.05


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh port fault injector, tracer and metrics; the tracer records for
    the test (it is off by default), as the tests read the steps' and the
    checkpoints' spans."""
    faults.configure("", 0)
    trace.enable()
    yield
    trace.enable(False)
    trace.reset()
    metrics.reset()
    faults.reset()


def _flat(tree, prefix=""):
    """path -> numpy array for a tree of dicts / NamedTuples (either
    package's), paths as the checkpoints name them."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        if isinstance(tree, torch.Tensor):
            out[prefix[:-1]] = (tree.float().numpy()
                                if tree.dtype == torch.bfloat16
                                else tree.numpy())
        else:
            out[prefix[:-1]] = np.asarray(tree)
    return out


def _setup(name, **replace):
    ref_cfg = ref_reduced(REF_ARCHS[name]).replace(**replace)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref_params), device=CPU)
    return ref_cfg, ref_params, reduced(ARCHS[name]).replace(**replace), \
        params


def _batch(cfg, step, batch=2, seq=16):
    """SyntheticLM tokens, plus stub frontend inputs from numpy."""
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch)).batch_at(step)
    rng = np.random.default_rng(step)
    if cfg.frontend == "vision":
        b["vision_embeds"] = (rng.normal(size=(
            batch, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.enc_dec:
        b["audio_frames"] = (rng.normal(size=(
            batch, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ------------------------------------------------------------ optimizer
def test_lr_schedule_matches_reference():
    ocfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    ref = RefOptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    assert float(opt.lr_at(ocfg, 0)) == 0.0
    assert abs(float(opt.lr_at(ocfg, 10)) - 1.0) < 0.11
    assert abs(float(opt.lr_at(ocfg, 100)) - 0.1) < 1e-5
    for s in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        got = opt.lr_at(ocfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref_opt.lr_at(ref, s)),
                                   rtol=1e-6)


def test_clipping():
    ocfg = OptimizerConfig(clip_norm=1.0)
    p = {"w": torch.ones((4, 4))}
    g = {"w": torch.full((4, 4), 100.0)}
    p2, _, m = opt.update(ocfg, p, g, opt.init(p))
    assert float(m["grad_norm"]) > 1.0
    # post-clip update magnitude bounded by lr * O(1)
    assert float((p2["w"] - p["w"]).abs().max()) < 10 * ocfg.lr


def test_decay_only_on_matrices():
    ocfg = OptimizerConfig(lr=1e-2, weight_decay=1.0, warmup_steps=0)
    p = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    g = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    p2, _, _ = opt.update(ocfg, p, g, opt.init(p))
    assert float(p2["w"][0, 0]) < 1.0        # decayed
    assert float(p2["b"][0]) == 1.0          # not decayed


def test_update_matches_reference():
    """Three AdamW updates of a seeded tree (matrices, vectors, a bf16
    leaf, a gradient large enough to clip) equal the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (8, 4), "b": (4,)}, "z": (3, 5, 2), "n": (6,)}

    def draw(scale):
        return {"a": {k: (rng.normal(size=s) * scale).astype(np.float32)
                      for k, s in shapes["a"].items()},
                "z": (rng.normal(size=shapes["z"]) * scale).astype(
                    np.float32),
                "n": (rng.normal(size=shapes["n"]) * scale).astype(
                    np.float32)}

    p_np = draw(1.0)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    ref_p = jax.tree.map(jnp.asarray, p_np)
    ref_p["n"] = ref_p["n"].astype(jnp.bfloat16)
    p = tree_map(torch.from_numpy, p_np)
    p["n"] = p["n"].to(torch.bfloat16)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for scale in (0.1, 3.0, 0.01):
        g_np = draw(scale)
        ref_p, ref_s, ref_m = ref_opt.update(
            RefOptimizerConfig(**ocfg), ref_p, jax.tree.map(jnp.asarray, g_np),
            ref_s)
        p, s, m = opt.update(OptimizerConfig(**ocfg), p,
                             tree_map(torch.from_numpy, g_np), s)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
    assert p["n"].dtype == torch.bfloat16
    assert int(s.step) == int(ref_s.step) == 3
    got = _flat((tree_map(lambda t: t.float(), p), s))
    want = _flat((jax.tree.map(lambda a: np.asarray(a, np.float32), ref_p),
                  ref_s))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_opt_state_from_reference_is_bit_exact():
    ref_cfg, ref_params, _, params = _setup("smollm-360m")
    step = jax.jit(ref_make_train_step(ref_cfg, RefOptimizerConfig()))
    _, ref_s, _ = step(ref_params, ref_opt.init(ref_params),
                       _jnp(_batch(ref_cfg, 0)))
    s = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, ref_s), device=CPU)
    assert isinstance(s, opt.OptState)
    assert s.step.dtype == torch.int32 and int(s.step) == 1
    got, want = _flat(s), _flat(jax.tree.map(np.asarray, ref_s))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------- loss and gradients
def _grad_close(got, want, what):
    for k in want:
        w, g = want[k], got[k]
        atol = GRAD_ATOL_REL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_loss_and_grads_match_reference(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    b = _batch(cfg, 0)
    (ref_total, ref_parts), ref_grads = jax.value_and_grad(
        ref_make_loss_fn(ref_cfg), has_aux=True)(ref_params, _jnp(b))
    (total, parts), grads = value_and_grad(make_loss_fn(cfg), params,
                                           _torch(b))
    np.testing.assert_allclose(float(total), float(ref_total),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(ref_parts["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(ref_parts["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    got = _flat(grads)
    want = _flat(jax.tree.map(np.asarray, ref_grads))
    assert set(got) == set(want)
    _grad_close(got, want, "vs reference")
    # the same bar against the exact (float64) gradient of the same weights
    (_, _), g64 = value_and_grad(
        make_loss_fn(cfg.replace(compute_dtype="float64")),
        tree_map(lambda a: a.double(), params), _torch(b))
    _grad_close(got, _flat(g64), "vs float64")
    # the eval step gives the train loss
    ev = make_eval_step(cfg)(params, _torch(b))
    assert float(ev["loss"]) == float(total)


def test_tied_embedding_gradient_adds_both_uses(monkeypatch):
    """smollm ties its embeddings: the table's gradient is the sum of its
    use as the input embedding and as the output head."""
    from repro_torch.models import layers

    _, _, cfg, params = _setup("smollm-360m")
    assert cfg.tie_embeddings and "head" not in params
    b = _torch(_batch(cfg, 1))
    (_, _), g = value_and_grad(make_loss_fn(cfg), params, b)
    tok = params["embed"]["tok"]
    inp = tok.detach().clone().requires_grad_(True)
    out = tok.detach().clone().requires_grad_(True)
    head = layers.logits_from_hidden
    # the input embedding reads `inp`, the output head reads `out`
    monkeypatch.setattr(layers, "logits_from_hidden", lambda c, p, x: head(
        c, dict(p, embed={"tok": out}), x))
    loss, _ = make_loss_fn(cfg)(dict(params, embed={"tok": inp}), b)
    gi, go = torch.autograd.grad(loss, [inp, out])
    assert float(gi.abs().max()) > 0 and float(go.abs().max()) > 0
    np.testing.assert_allclose(g["embed"]["tok"].numpy(), (gi + go).numpy(),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_three_train_steps_match_reference(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_cfg,
                                           RefOptimizerConfig(**ocfg)))
    step = make_train_step(cfg, OptimizerConfig(**ocfg))
    ref_s, s = ref_opt.init(ref_params), opt.init(params)
    for i in range(3):
        b = _batch(cfg, i)
        ref_params, ref_s, ref_m = ref_step(ref_params, ref_s, _jnp(b))
        params, s, m = step(params, s, _torch(b))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
    got = _flat(params)
    want = _flat(jax.tree.map(np.asarray, ref_params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=STEP_ATOL_LR * ocfg["lr"], err_msg=k)
    assert int(s.step) == 3


def test_train_step_leaves_its_inputs_alone():
    _, _, cfg, params = _setup("smollm-360m")
    state = opt.init(params)
    before = {k: v.copy() for k, v in _flat((params, state)).items()}
    new_p, new_s, _ = make_train_step(cfg, OptimizerConfig(lr=1e-2))(
        params, state, _torch(_batch(cfg, 0)))
    after = _flat((params, state))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert all(a is not b for a, b in zip(leaves(new_p), leaves(params)))
    assert int(new_s.step) == 1 and int(state.step) == 0


def test_loss_decreases():
    cfg = reduced(ARCHS["smollm-360m"]).replace(vocab=256)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=64, global_batch=16))
    params = init_params(cfg, device=CPU, seed=0)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=10,
                                                total_steps=100))
    state = opt.init(params)
    losses = []
    # one intra-op thread: on a host whose cores are busy (pytest-xdist's
    # other workers), a thread per core waits on the busy ones at every op,
    # and these 100 steps took minutes instead of seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for s in range(100):
            params, state, m = step(params, state, _torch(data.batch_at(s)))
            losses.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 1.0, (first, last)


def test_determinism():
    _, _, cfg, params = _setup("smollm-360m")
    step = make_train_step(cfg, OptimizerConfig())
    b = _torch(_batch(cfg, 0))
    _, _, m1 = step(params, opt.init(params), b)
    _, _, m2 = step(params, opt.init(params), b)
    assert float(m1["loss"]) == float(m2["loss"])


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n_host", [1, 2])
def test_synthetic_lm_matches_reference(n_host):
    for host in range(n_host):
        kw = dict(vocab=5000, seq_len=24, global_batch=6, seed=3,
                  n_host=n_host, host_id=host)
        ours = SyntheticLM(DataConfig(**kw))
        theirs = RefSyntheticLM(RefDataConfig(**kw))
        for step in (0, 1, 17, 1000):
            got, want = ours.batch_at(step), theirs.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_determinism_and_seekability():
    d1 = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=8))
    d2 = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=8))
    np.testing.assert_array_equal(d1.batch_at(17)["tokens"],
                                  d2.batch_at(17)["tokens"])
    dA = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=8,
                                n_host=2, host_id=0))
    dB = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=8,
                                n_host=2, host_id=1))
    full = d1.batch_at(3)["tokens"]
    np.testing.assert_array_equal(dA.batch_at(3)["tokens"], full[0::2])
    np.testing.assert_array_equal(dB.batch_at(3)["tokens"], full[1::2])
    b = d1.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    it = d1.iter_from(5)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  d1.batch_at(5)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  d1.batch_at(6)["tokens"])


def test_read_faults_retried_and_deterministic():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=4)
    clean = SyntheticLM(cfg).batch_at(3)
    # the first seed whose first read drops and whose second does not
    seed = next(s for s in range(1000)
                if faults._unit_roll(s, "data.read", 0, "drop0") < 0.4
                <= faults._unit_roll(s, "data.read", 1, "drop0"))
    faults.configure("data.read:drop:0.4", seed=seed)
    chaotic = SyntheticLM(cfg).batch_at(3)
    np.testing.assert_array_equal(clean["tokens"], chaotic["tokens"])
    c = metrics.export()["counters"]
    assert c["resilience.retries.data.read"] == 1


# ------------------------------------------------------------ checkpoint
def _trees():
    t1 = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    t2 = {"w": t1["w"] * 2, "b": t1["b"] * 2}
    return t1, t2


def test_roundtrip_fp32_bf16_int(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "nested": {"b": torch.linspace(-3, 3, 12).to(
                torch.bfloat16).reshape(4, 3),
                "c": torch.randn(5, generator=torch.Generator().manual_seed(
                    0))},
            "s": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["dtypes"] == {"a": "int32", "nested/b": "bfloat16",
                             "nested/c": "float32", "s": "int32"}
    assert man["shapes"]["nested/b"] == [4, 3] and man["keys"] == sorted(
        man["dtypes"])
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
        assert sorted(z.files) == ["a", "nested__b", "nested__c", "s"]
        assert z["nested__b"].dtype == np.uint8
        assert z["nested__b"].shape == (4, 6)          # the byte view
    out, step, extra = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and extra == {"note": "x"}
    for k, v in _flat(tree).items():
        g = _flat(out)[k]
        assert g.dtype == v.dtype
        np.testing.assert_array_equal(g, v)
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])


def test_npz_members_are_numpys(tmp_path):
    """The checkpoint's ``.npz`` writer gives ``np.savez``'s member bytes
    (C-order arrays: matrices, 0-d, empty, bytes), and its reader reads
    what ``np.savez`` writes, a Fortran-order member included."""
    import io
    import zipfile

    rng = np.random.default_rng(0)
    arrs = {"a__b": rng.random((3, 4)).astype(np.float32),
            "s": np.array(3, np.int32), "e": np.zeros((0, 3), np.float32),
            "u": np.arange(12, dtype=np.uint8).reshape(2, 6)}
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    ours = zipfile.ZipFile(io.BytesIO(bytes(ckpt._npz(arrs))))
    theirs = zipfile.ZipFile(io.BytesIO(buf.getvalue()))
    assert ours.namelist() == theirs.namelist()
    for n in theirs.namelist():
        assert ours.read(n) == theirs.read(n), n
    arrs["f"] = np.asfortranarray(rng.random((3, 5)))
    path = tmp_path / "x.npz"
    np.savez(path, **arrs)
    data = bytearray(path.read_bytes())
    for check in (True, False):
        got = ckpt._npz_arrays(str(path), data, check_members=check)
        assert sorted(got) == sorted(arrs)
        for k, v in arrs.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(CheckpointCorruptError):
        ckpt._npz_arrays(str(path), data, check_members=True)


def test_crc_and_io_in_pieces(tmp_path, monkeypatch):
    """``crc32_combine`` joins CRCs as zlib would, and a payload checksummed,
    written and read in pieces on threads gives zlib's CRC and its bytes."""
    rng = np.random.default_rng(1)
    for la, lb in ((0, 5), (5, 0), (1, 1), (17, 1000), (12345, 67891)):
        a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
        assert ckpt.crc32_combine(zlib.crc32(a), zlib.crc32(b),
                                  len(b)) == zlib.crc32(a + b)
    monkeypatch.setattr(ckpt, "_PIECE_MIN", 1000)
    monkeypatch.setattr(ckpt, "_PIECES", 4)
    for n in (0, 999, 4001, 100_003):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert len(ckpt._pieces(n)) == (1 if n <= 1000 else 4)
        assert ckpt._crc(payload) == zlib.crc32(payload)
        ckpt._write(str(tmp_path / "p.bin"), payload)
        assert bytes(ckpt._read(str(tmp_path / "p.bin"))) == payload
        assert ckpt._file_crc(str(tmp_path / "p.bin")) == zlib.crc32(payload)


def test_namedtuple_roundtrip(tmp_path):
    state = opt.init({"w": torch.ones((3, 3))})
    ckpt.save(str(tmp_path), 1, state)
    out, _, _ = ckpt.restore(str(tmp_path), state)
    assert isinstance(out, opt.OptState)
    assert out.step.dtype == torch.int32 and int(out.step) == 0


def test_latest_and_gc(tmp_path):
    tree = {"x": torch.zeros(2)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ac.save(s, tree)
    ac.wait()
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_async_save_snapshots_before_writing(tmp_path):
    """The snapshot is taken on the caller's thread: a tensor changed after
    ``save`` returns does not reach the checkpoint."""
    x = torch.arange(4.0)
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(1, {"x": x})
    x.add_(100.0)
    ac.wait()
    out, _, _ = ckpt.restore(str(tmp_path), {"x": x})
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(4.0))
    assert len(trace.get_tracer().spans("ckpt.save")) == 1


def test_bitflip_falls_back_to_previous(tmp_path):
    t1, t2 = _trees()
    ckpt.save(str(tmp_path), 1, t1)
    ckpt.save(str(tmp_path), 2, t2)
    p = tmp_path / "step_00000002" / "arrays.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))
    assert not ckpt.verify(str(tmp_path), 2)
    out, step, _ = ckpt.restore(str(tmp_path), t1)
    assert step == 1
    np.testing.assert_array_equal(out["w"].numpy(), t1["w"].numpy())
    assert metrics.export()["counters"]["resilience.ckpt_fallback"] == 1


def test_truncation_falls_back(tmp_path):
    t1, t2 = _trees()
    ckpt.save(str(tmp_path), 1, t1)
    ckpt.save(str(tmp_path), 2, t2)
    p = tmp_path / "step_00000002" / "arrays.npz"
    p.write_bytes(p.read_bytes()[:20])
    _, step, _ = ckpt.restore(str(tmp_path), t1)
    assert step == 1


def test_all_corrupt_raises_typed(tmp_path):
    t1, _ = _trees()
    ckpt.save(str(tmp_path), 1, t1)
    (tmp_path / "step_00000001" / "arrays.npz").write_bytes(b"junk")
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(str(tmp_path), t1)


def test_explicit_step_is_strict(tmp_path):
    t1, t2 = _trees()
    ckpt.save(str(tmp_path), 1, t1)
    ckpt.save(str(tmp_path), 2, t2)
    p = tmp_path / "step_00000002" / "arrays.npz"
    raw = bytearray(p.read_bytes())
    raw[-5] ^= 0x01
    p.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(str(tmp_path), t1, step=2)
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(str(tmp_path), t1, step=3)          # missing
    _, step, _ = ckpt.restore(str(tmp_path), t1, step=1)
    assert step == 1


def test_injected_write_corruption_retried(tmp_path):
    t1, _ = _trees()
    faults.configure("ckpt.write:corrupt:0.5", seed=11)
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, t1, keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert all(ckpt.verify(str(tmp_path), s) for s in (3, 4, 5))
    c = metrics.export()["counters"]
    assert c["resilience.injected.ckpt.write"] >= 1
    assert c.get("resilience.retries.ckpt.write", 0) >= 1
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_checksum_recorded(tmp_path):
    t1, _ = _trees()
    ckpt.save(str(tmp_path), 1, t1)
    man = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    payload = (tmp_path / "step_00000001" / "arrays.npz").read_bytes()
    assert man["checksum_crc32"] == zlib.crc32(payload)


def _trained_pair():
    """Both packages one train step in from the same weights and batch,
    with a bf16 leaf added to each tree."""
    ref_cfg, ref_params, cfg, params = _setup("smollm-360m")
    step = jax.jit(ref_make_train_step(ref_cfg, RefOptimizerConfig()))
    ref_p, ref_s, _ = step(ref_params, ref_opt.init(ref_params),
                           _jnp(_batch(ref_cfg, 0)))
    ref_p = dict(ref_p, extra_bf16=jnp.linspace(-2, 2, 6, dtype=jnp.float32)
                 .astype(jnp.bfloat16).reshape(2, 3))
    p, s, _ = make_train_step(cfg, OptimizerConfig())(
        params, opt.init(params), _torch(_batch(cfg, 0)))
    p = dict(p, extra_bf16=torch.linspace(-2, 2, 6).to(torch.bfloat16)
             .reshape(2, 3))
    return (ref_p, ref_s), (p, s)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_tree, tree = _trained_pair()
    ref_ckpt.save(str(tmp_path), 3, ref_tree, extra={"by": "reference"})
    out, step, extra = ckpt.restore(str(tmp_path), tree)
    assert step == 3 and extra == {"by": "reference"}
    assert isinstance(out[1], opt.OptState)
    assert out[0]["extra_bf16"].dtype == torch.bfloat16
    got = _flat(tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                         else t, out[0]))
    want = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32),
                              ref_tree[0]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in _flat(jax.tree.map(np.asarray, ref_tree[1])).items():
        np.testing.assert_array_equal(_flat(out[1])[k], v, err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_tree, tree = _trained_pair()
    ckpt.save(str(tmp_path), 4, tree, extra={"by": "port"})
    out, step, extra = ref_ckpt.restore(str(tmp_path), ref_tree)
    assert step == 4 and extra == {"by": "port"}
    assert out[0]["extra_bf16"].dtype == jnp.bfloat16
    want = _flat(tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                          else t, tree[0]))
    got = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), out[0]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in _flat(tree[1]).items():
        np.testing.assert_array_equal(np.asarray(_flat(out[1])[k]), v,
                                      err_msg=k)


# ---------------------------------------------------------------- runner
def _tiny(steps=100):
    cfg = reduced(ARCHS["smollm-360m"]).replace(vocab=256)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=8))
    params = init_params(cfg, device=CPU, seed=0)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=10,
                                                total_steps=steps))
    return data, params, step


def _batches(data, start=0):
    s = start
    while True:
        yield _torch(data.batch_at(s))
        s += 1


def _quiet(_msg):
    pass


def test_runner_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    """Train 10; against train 5 with a checkpoint every 5, stop, and a new
    runner that resumes and trains to 10: the same parameters and moments,
    bit for bit."""
    data, params, step = _tiny()
    full = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path / "a"),
                                    ckpt_every=5, max_steps=10),
                       step, params, opt.init(params), log=_quiet)
    out = full.run(_batches(data))
    assert out["final_step"] == 10

    rc = dict(ckpt_dir=str(tmp_path / "b"), ckpt_every=5)
    first = TrainRunner(RunnerConfig(max_steps=5, **rc), step, params,
                        opt.init(params), log=_quiet)
    first.run(_batches(data))
    logs = []
    second = TrainRunner(RunnerConfig(max_steps=10, **rc), step, params,
                         opt.init(params), log=logs.append)
    assert second.step == 5 and logs == ["[runner] resumed from step 5"]
    out2 = second.run(_batches(data, 5))
    assert out2["final_step"] == 10
    assert out2["last_loss"] == out["last_loss"]
    a = _flat((full.params, full.opt_state))
    b = _flat((second.params, second.opt_state))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ckpt.all_steps(rc["ckpt_dir"]) == [5, 10]
    c = metrics.export()["counters"]
    assert c["train.steps"] == 20
    assert metrics.export()["histograms"]["train.step_s"]["count"] == 20
    assert len(trace.get_tracer().spans("train.step")) == 20


def test_nonfinite_loss_skips_the_update(tmp_path):
    """A step whose loss is NaN is skipped: the runner keeps the tensors it
    had (the train step did not touch them) and counts the step."""
    data, params, step = _tiny()
    calls = []

    def poisoned(p, o, b):
        calls.append(1)
        new_p, new_o, m = step(p, o, b)
        if len(calls) == 2:
            m = dict(m, loss=m["loss"] * float("nan"))
        return new_p, new_o, m

    r = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                 max_steps=2), poisoned, params,
                    opt.init(params), log=_quiet)
    it = _batches(data)
    r.run(it)
    assert r.step == 2 and len(r.metrics_history) == 1
    assert metrics.export()["counters"]["train.nonfinite_steps"] == 1
    # the state after step 1 is what the runner holds after the skip
    want_p, want_o, _ = step(params, opt.init(params),
                             _torch(data.batch_at(0)))
    got, want = _flat((r.params, r.opt_state)), _flat((want_p, want_o))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_straggler_counted(tmp_path):
    """Steps of 50 ms and one of 500 ms (a step that only sleeps, so the
    host's load moves the times little): that one is counted."""
    _, params, _ = _tiny()
    n = []

    def step(p, o, b):
        n.append(1)
        time.sleep(0.5 if len(n) == 4 else 0.05)
        return p, o, {"loss": torch.tensor(1.0)}

    r = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                 max_steps=6, straggler_factor=3.0),
                    step, params, opt.init(params), log=_quiet)
    assert r.run(iter([None] * 6))["stragglers"] == 1
    assert r.straggler_events[0][0] == 3
    assert metrics.export()["counters"]["train.stragglers"] == 1


def test_sigterm_checkpoints_and_stops(tmp_path):
    data, params, step = _tiny()
    n = []

    def preempted(p, o, b):
        n.append(1)
        if len(n) == 2:
            signal.raise_signal(signal.SIGTERM)
        return step(p, o, b)

    prev = signal.getsignal(signal.SIGTERM)
    r = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                 max_steps=10), preempted, params,
                    opt.init(params), log=_quiet)
    try:
        r.install_preemption_hook()
        out = r.run(_batches(data))
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert out["final_step"] == 2
    assert ckpt.all_steps(str(tmp_path)) == [2]


# ---------------------------------------------------------------- launch
def test_launch_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path)]
    prev = signal.getsignal(signal.SIGTERM)
    out = launch_train.main(argv)
    assert signal.getsignal(signal.SIGTERM) == prev       # hook removed
    assert out["final_step"] == 4 and np.isfinite(out["last_loss"])
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    argv[argv.index("--steps") + 1] = "6"
    again = launch_train.main(argv)
    assert again["final_step"] == 6
    assert "resumed from step 4" in capsys.readouterr().out


def test_launch_train_refuses_a_model_axis(tmp_path, capsys):
    """A model axis wider than the devices is cut to them, as the
    reference's ``min(--model-axis, n_dev)``: one CPU device trains on a
    (1, 1) mesh, with the one-device step."""
    out = launch_train.main(["--reduced", "--device", "cpu", "--model-axis",
                             "2", "--steps", "2", "--batch", "2", "--seq",
                             "16", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and np.isfinite(out["last_loss"])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out


def test_launch_train_takes_a_config_cut_in_depth(tmp_path, capsys):
    """``cfg`` replaces ``--arch``'s config: smollm-360m's reduced config
    cut to one block trains a one-block model."""
    cfg = reduced(ARCHS["smollm-360m"]).replace(n_layers=1)
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    runner, _ = launch_train.make_runner(argv, cfg)
    assert {v.shape[0] for v in leaves(runner.params["blocks"])} == {1}
    out = launch_train.main(argv, cfg)
    assert out["final_step"] == 2 and np.isfinite(out["last_loss"])


def test_launch_serve_cli():
    out = launch_serve.main(["--reduced", "--device", "cpu", "--requests",
                             "5", "--prompt-len", "12", "--max-new", "4"])
    assert sorted(out) == list(range(5))
    assert all(len(v) == 4 for v in out.values())


def test_launch_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(KernelUnavailableError):
        launch_train.main(["--reduced", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(KernelUnavailableError):
        launch_serve.main(["--reduced"])
