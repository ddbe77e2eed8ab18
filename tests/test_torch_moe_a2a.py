"""Port vs reference: the expert-parallel all-to-all MoE layer
(``models/moe.py::moe_apply_a2a``) on meshes of CPU shards.

The port's twins of the two cases of ``tests/test_moe_a2a.py`` (a2a equal
to ``moe_apply``, forward and every gradient, under 1e-6 as the reference
holds it; the fallback when the experts do not divide the model axis), the
reference's fallback rule itself, and the port's a2a against the
reference's a2a on the same weights and inputs: output, aux and gradients
at ``rtol=1e-5, atol=1e-6`` on (4, 2) and (2, 2, 2) meshes. Last, reduced
``dbrx-132b`` through ``forward`` under ``hint_mesh`` on (4, 2): against the
reference's ``forward`` under its mesh (its a2a path), and against the
port's own ``forward`` without a mesh at a capacity under which neither
path drops a token (the two capacity rules differ by design).

The reference runs once for the file, in one subprocess with 8 fake XLA
devices, on weights and inputs made here with numpy; its results come back
in an ``.npz``.
"""
import textwrap

import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro_torch import convert
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh, make_host_mesh
from repro_torch.distributed import sharding as sh
from repro_torch.models import forward, moe
from repro_torch.models.config import ModelConfig

CPU = "cpu"
CROSS = dict(rtol=1e-5, atol=1e-6)       # port vs reference
SAME = 1e-6                              # a2a vs moe_apply (the reference's)
SMALL = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=128, vocab=256, mlp="moe", n_experts=8,
             top_k=2, d_ff_expert=32, capacity_factor=8.0)
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
KEYS = ("router", "wg", "wu", "wo")


def _weights(cfg, seed):
    """MoE weights and an input from numpy, with the init's scales."""
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def dense(shape, fan_in, scale=1.0):
        w = rng.standard_normal(shape).clip(-2, 2) * scale / np.sqrt(fan_in)
        return w.astype(np.float32)

    p = {"router": dense((D, E), D, 0.5), "wg": dense((E, D, Fe), D),
         "wu": dense((E, D, Fe), D), "wo": dense((E, Fe, D), Fe, 0.5)}
    x = (rng.standard_normal((4, 16, D)) * 0.5).astype(np.float32)
    return p, x


REFERENCE = textwrap.dedent(
    """
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import ARCHS, reduced
    from repro.distributed import sharding
    from repro.models import forward, init_params, moe
    from repro.models.config import ModelConfig

    inp = dict(np.load({inp!r}))
    out = {{}}
    cfg = ModelConfig(**{small!r})
    p = {{k: jnp.asarray(inp["p/" + k]) for k in {keys!r}}}
    x = jnp.asarray(inp["x"])

    def mesh(shape, names):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    for tag, (shape, names) in {meshes!r}.items():
        m = mesh(tuple(shape), tuple(names))

        def loss(p, x):
            y, aux = moe.moe_apply_a2a(cfg, p, x, m)
            return (y ** 2).mean() + aux, (y, aux)

        (_, (y, aux)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
        out[tag + "/y"], out[tag + "/aux"] = np.asarray(y), np.asarray(aux)
        for k in {keys!r}:
            out[tag + "/g/" + k] = np.asarray(g[0][k])
        out[tag + "/g/x"] = np.asarray(g[1])

    # reduced dbrx through forward, under a (4, 2) hint mesh (its a2a path)
    dcfg = reduced(ARCHS["dbrx-132b"])
    params = init_params(dcfg, jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["dbrx/p/" + "/".join(str(k.key) for k in path)] = np.asarray(
            leaf)
    toks = jnp.asarray(inp["dbrx_tokens"])
    m = mesh((4, 2), ("data", "model"))

    def fwd(params, toks):
        with sharding.hint_mesh(m):
            return forward(dcfg, params, toks)

    logits, aux = jax.jit(fwd)(params, toks)
    out["dbrx/logits"], out["dbrx/aux"] = np.asarray(logits), np.asarray(aux)
    np.savez({path!r}, **out)
    print("REFERENCE DONE")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("a2a")
    cfg = ModelConfig(**SMALL)
    p, x = _weights(cfg, 0)
    toks = np.random.default_rng(1).integers(0, 512, (4, 16)).astype(np.int32)
    np.savez(d / "inp.npz", x=x, dbrx_tokens=toks,
             **{"p/" + k: v for k, v in p.items()})
    code = REFERENCE.format(inp=str(d / "inp.npz"), small=SMALL,
                            keys=KEYS, meshes=MESHES,
                            path=str(d / "out.npz"))
    assert "REFERENCE DONE" in run_with_devices(code, 8)
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}, p, x, toks


def _mesh(shape, names):
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _loss_grads(cfg, p_np, x_np, mesh=None):
    """Output, aux and the gradients (each weight, and x) of
    ``(y**2).mean() + aux``."""
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in p_np.items()}
    x = torch.from_numpy(x_np.copy()).requires_grad_(True)
    y, aux = (moe.moe_apply(cfg, p, x) if mesh is None
              else moe.moe_apply_a2a(cfg, p, x, mesh))
    loss = (y ** 2).mean() + aux
    grads = torch.autograd.grad(loss, [p[k] for k in KEYS] + [x])
    g = {k: t.numpy() for k, t in zip(KEYS + ("x",), grads)}
    return y.detach().numpy(), float(aux.detach()), g


def test_a2a_equals_gspmd_fwd_and_grad():
    cfg = ModelConfig(**SMALL)
    p, x = _weights(cfg, 0)
    mesh = make_host_mesh(8, device=CPU)
    assert moe.a2a_applies(cfg, x.shape, mesh)
    want, aux_w, g1 = _loss_grads(cfg, p, x)
    got, aux_g, g2 = _loss_grads(cfg, p, x, mesh)
    assert float(np.abs(got - want).max()) < SAME
    assert abs(aux_w - aux_g) < SAME
    for k in g1:
        assert float(np.abs(g1[k] - g2[k]).max()) < SAME, k


def test_a2a_fallback_when_indivisible():
    # n_experts=6 not divisible by model axis 4 -> falls back, still correct
    cfg = ModelConfig(**dict(SMALL, d_model=32, n_heads=2, n_kv_heads=2,
                             d_ff=64, vocab=128, n_experts=6,
                             d_ff_expert=16))
    p, x = _weights(cfg, 3)
    x = x[:2, :8, :]
    mesh = _mesh((2, 4), ("data", "model"))
    assert not moe.a2a_applies(cfg, x.shape, mesh)
    xt = torch.from_numpy(x)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    want, aux_w = moe.moe_apply(cfg, pt, xt)
    got, aux_g = moe.moe_apply_a2a(cfg, pt, xt, mesh)
    assert float((got - want).abs().max()) < SAME
    assert torch.equal(got, want) and torch.equal(aux_g, aux_w)


def test_fallback_rule_is_the_references():
    """``M == 1 or E % M or (T // n_bd) % M`` (``src/repro/models/
    moe.py:150``): each clause alone sends the layer to ``moe_apply``."""
    cfg = ModelConfig(**SMALL)                          # E = 8
    cases = [
        ((8, 1), ("data", "model"), (4, 16), False),    # M == 1
        ((2, 4), ("data", "model"), (4, 16), True),
        ((1, 8), ("data", "model"), (4, 16), True),
        ((2, 3), ("data", "model"), (4, 18), False),    # E % M
        ((4, 2), ("data", "model"), (3, 4), False),     # (12 // 4) % 2
        ((4, 2), ("data", "model"), (4, 4), True),
        ((2, 2, 2), ("pod", "data", "model"), (2, 6), False),  # 3 % 2
        ((2, 2, 2), ("pod", "data", "model"), (2, 8), True),
        ((8,), ("model",), (1, 8), True),               # no batch axes
    ]
    for shape, names, (B, S), applies in cases:
        mesh = _mesh(shape, names)
        assert moe.a2a_applies(cfg, (B, S, 64), mesh) is applies, (shape, B,
                                                                    S)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_a2a_matches_the_reference_a2a(ref, tag):
    out, p, x, _ = ref
    cfg = ModelConfig(**SMALL)
    y, aux, g = _loss_grads(cfg, p, x, _mesh(*MESHES[tag]))
    np.testing.assert_allclose(y, out[tag + "/y"], **CROSS)
    np.testing.assert_allclose(aux, out[tag + "/aux"], **CROSS)
    for k in KEYS + ("x",):
        np.testing.assert_allclose(g[k], out[f"{tag}/g/{k}"], **CROSS,
                                   err_msg=k)


def _dbrx_params(out):
    tree = {}
    for k, v in out.items():
        if k.startswith("dbrx/p/"):
            node = tree
            *path, leaf = k[len("dbrx/p/"):].split("/")
            for n in path:
                node = node.setdefault(n, {})
            node[leaf] = v
    return convert.lm_params_from_reference(tree, device=CPU)


def test_dbrx_forward_under_a_hint_mesh(ref):
    out, _, _, toks = ref
    cfg = reduced(ARCHS["dbrx-132b"])
    assert cfg.moe_impl == "a2a" and cfg.first_dense_layers == 0
    params = _dbrx_params(out)
    t = torch.from_numpy(toks)
    mesh = make_host_mesh(8, device=CPU)
    calls = []
    real = moe.moe_apply_a2a

    def spy(*a):
        calls.append(1)
        return real(*a)

    moe.moe_apply_a2a = spy
    try:
        with torch.no_grad(), sh.hint_mesh(mesh):
            logits, aux = forward(cfg, params, t)
        assert len(calls) == cfg.n_layers          # every layer exchanged
        # against the reference's forward under its (4, 2) mesh
        np.testing.assert_allclose(logits.numpy(), out["dbrx/logits"],
                                   rtol=1e-4, atol=1e-5 * float(
                                       np.abs(out["dbrx/logits"]).max()))
        np.testing.assert_allclose(float(aux), out["dbrx/aux"], rtol=1e-5)
        # against moe_apply (no mesh), where neither path drops a token
        wide = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        calls.clear()
        with torch.no_grad():
            plain, aux_p = forward(wide, params, t)
            assert not calls
            with sh.hint_mesh(mesh):
                exch, aux_e = forward(wide, params, t)
        assert len(calls) == cfg.n_layers
    finally:
        moe.moe_apply_a2a = real
    np.testing.assert_allclose(exch.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6 * float(plain.abs().max()))
    np.testing.assert_allclose(float(aux_e), float(aux_p), rtol=1e-6)


def test_first_dense_configs_never_exchange():
    """deepseek-v2-lite has first-dense layers: the reference routes its MoE
    layers through ``moe_apply`` whatever the mesh, and so does the port."""
    cfg = reduced(ARCHS["deepseek-v2-lite-16b"])
    assert cfg.moe_impl == "a2a" and cfg.first_dense_layers > 0
    from repro_torch.models import init_params

    params = init_params(cfg, device=CPU, seed=0)
    t = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 16)))
    real = moe.moe_apply_a2a
    moe.moe_apply_a2a = lambda *a: pytest.fail("a2a called")
    try:
        with torch.no_grad():
            want, _ = forward(cfg, params, t)
            with sh.hint_mesh(make_host_mesh(8, device=CPU)):
                got, _ = forward(cfg, params, t)
    finally:
        moe.moe_apply_a2a = real
    assert torch.equal(got, want)
