"""Port vs reference: int8 gradient compression with error feedback
(``train/grad_compress.py``).

The port's twins of ``tests/test_train.py::TestGradCompression`` (the
round-trip bound, error feedback keeping the running sums together, the
compressed sum over a ``("pod",)`` axis of 4 shards), plus: ``quantize``'s
int8 output and scale **bit-identical** to the reference's on the same fp32
inputs, ``compress_tree`` equal to the reference's over several steps, and
``psum_compressed`` over 4 CPU shards equal to the reference's
``shard_map`` result (sums, shared scales and residuals). The reference's
multi-device case runs once for the file, in one subprocess with 4 fake
XLA devices.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

from repro.train import grad_compress as ref_gc

from repro_torch.distributed.collectives import shard_array
from repro_torch.train import grad_compress as gc

N_POD = 4


def _inputs():
    """fp32 gradients of several scales and shapes, with values on the
    rounding boundaries of their own scale among them."""
    rng = np.random.default_rng(0)
    out = {"normal": rng.standard_normal((64,)).astype(np.float32),
           "tiny": (rng.standard_normal((64,)) * 1e-20).astype(np.float32),
           "huge": (rng.standard_normal((8, 8)) * 1e20).astype(np.float32),
           "zeros": np.zeros((64,), np.float32),
           "one": np.full((64,), -3.5, np.float32)}
    g = rng.standard_normal((64,)).astype(np.float32)
    s = (np.abs(g).max() + np.float32(1e-12)) / np.float32(127.0)
    g[1:20] = (np.arange(19, dtype=np.float32) - 9.5) * s   # k + .5 steps
    out["halves"] = g
    return out


def test_quantize_bit_identical_to_the_reference():
    for name, g in _inputs().items():
        q, s = gc.quantize(torch.from_numpy(g))
        rq, rs = ref_gc.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), name)
        assert s.numpy().tobytes() == np.asarray(rs).tobytes(), name
        np.testing.assert_array_equal(
            gc.dequantize(q, s).numpy(), np.asarray(ref_gc.dequantize(rq,
                                                                      rs)))


def test_quantize_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        128).astype(np.float32))
    q, s = gc.quantize(g)
    err = float((gc.dequantize(q, s) - g).abs().max())
    assert err <= float(s) / 2 + 1e-7


def test_error_feedback_converges():
    """Mean of compressed grads ≈ mean of true grads over time."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64)
    comp_sum = np.zeros(64)
    state = gc.init({"g": torch.zeros(64)})
    for _ in range(200):
        g = {"g": torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32))}
        q, s, state = gc.compress_tree(g, state)
        true_sum += g["g"].numpy()
        comp_sum += gc.dequantize(q["g"], s["g"]).numpy()
    # error feedback keeps the running sums together
    assert np.abs(true_sum - comp_sum).max() < 1.0


def test_compress_tree_matches_the_reference():
    rng = np.random.default_rng(4)
    shapes = {"a": (16, 8), "b": {"c": (16, 8), "d": (16, 8)}}

    def draw():
        return {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
                "b": {k: rng.standard_normal(v).astype(np.float32)
                      for k, v in shapes["b"].items()}}

    g0 = draw()
    st = gc.init({"a": torch.zeros(16, 8), "b": {
        "c": torch.zeros(16, 8), "d": torch.zeros(16, 8)}})
    rst = ref_gc.init(jax.tree.map(jnp.asarray, g0))
    for _ in range(5):
        g = draw()
        q, s, st = gc.compress_tree(
            {"a": torch.from_numpy(g["a"]), "b": {
                k: torch.from_numpy(v) for k, v in g["b"].items()}}, st)
        rq, rs, rst = ref_gc.compress_tree(jax.tree.map(jnp.asarray, g), rst)
        for path, want in (("a", rq["a"]), ("c", rq["b"]["c"]),
                           ("d", rq["b"]["d"])):
            got = q["a"] if path == "a" else q["b"][path]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(st.error["a"].numpy(),
                                      np.asarray(rst.error["a"]))


REFERENCE = textwrap.dedent(
    """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P, AxisType
    from jax import shard_map
    from repro.train import grad_compress as gc

    g = jnp.asarray(np.load({path!r})["g"])
    mesh = jax.make_mesh(({n},), ("pod",), axis_types=(AxisType.Auto,))

    def f(gl, steps):
        grads = {{"g": gl[0]}}
        state = gc.init(grads)
        outs = []
        for s in range(steps):
            out, state = gc.psum_compressed(
                {{"g": grads["g"] * (1.0 + 0.25 * s)}}, state, "pod")
            outs.append(out["g"])
        return jnp.stack(outs)[None], state.error["g"][None]

    got, err = shard_map(lambda gl: f(gl, 3), mesh=mesh,
                         in_specs=P("pod", None),
                         out_specs=(P("pod", None, None), P("pod", None)))(g)
    np.savez({out!r}, got=np.asarray(got), err=np.asarray(err))
    print("REFERENCE DONE")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("gc")
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N_POD, 64)))
    np.savez(d / "g.npz", g=g)
    code = REFERENCE.format(path=str(d / "g.npz"), n=N_POD,
                            out=str(d / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, N_POD)
    with np.load(d / "out.npz") as z:
        return g, z["got"], z["err"]


def _shards(rows):
    return shard_array([torch.from_numpy(np.array(r)) for r in rows])


def test_psum_compressed_multidevice(ref):
    g, _, _ = ref
    grads = {"g": _shards(g)}
    out, _ = gc.psum_compressed(grads, gc.init(grads), 0)
    got = out["g"].item().numpy()
    want = g.sum(0)
    err = np.abs(got - want).max()
    rel = err / (np.abs(want).max() + 1e-9)
    assert rel < 0.05, (err, rel)


def test_psum_compressed_matches_the_reference_shard_map(ref):
    """Three error-fed steps over 4 CPU shards: each step's dequantized sum
    and the shards' final residuals equal the reference's bit for bit (the
    int8 payloads and int32 sums are exact; the scale is one division)."""
    g, want, want_err = ref
    grads = {"g": _shards(g)}
    state = gc.init(grads)
    for s in range(3):
        step = {"g": _shards(g * np.float32(1.0 + 0.25 * s))}
        out, state = gc.psum_compressed(step, state, 0)
        got = out["g"].item().numpy()
        for k in range(N_POD):                      # every shard's copy
            np.testing.assert_array_equal(got, want[k, s])
    for k in range(N_POD):
        np.testing.assert_array_equal(state.error["g"][k].numpy(),
                                      want_err[k])


def test_psum_compressed_over_an_axis_of_a_2d_array():
    """Summing over array axis 1 of a (2, 4) array of shards gives one sum
    per row, each the row's own compressed sum."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((2, 4, 32)).astype(np.float32)
    arr = np.empty((2, 4), dtype=object)
    for i, j in np.ndindex(2, 4):
        arr[i, j] = torch.from_numpy(g[i, j].copy())
    grads = {"w": arr}
    out, st = gc.psum_compressed(grads, gc.init(grads), 1)
    assert out["w"].shape == (2,) and st.error["w"].shape == (2, 4)
    for i in range(2):
        row = {"w": _shards(g[i])}
        o, _ = gc.psum_compressed(row, gc.init(row), 0)
        assert torch.equal(out["w"][i], o["w"].item())
        bound = 4 * float(np.abs(g[i]).max() + 1e-12) / 127.0 / 2
        assert float((out["w"][i] - torch.from_numpy(g[i].sum(0))).abs()
                     .max()) <= bound * (1 + 1e-6)
