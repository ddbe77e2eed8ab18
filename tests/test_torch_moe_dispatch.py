"""The MoE layer's global dispatch by batch shard
(``models/moe.py::global_dispatch``, ``Dispatch``, ``global_aux``).

``moe_apply`` on the global input against the concatenation of its calls on
1, 2, 4 and 8 row blocks of it, each under ``global_dispatch`` with the
offsets its predecessors carried, on reduced ``deepseek-v2-lite-16b``'s MoE
layer (4 experts, top-2, a shared expert) at capacity factors 0.5 and
1.25: expert ids, keep masks and slots equal exactly; output and the global
aux within ``rtol=1e-6``; the input's rows lean towards some experts, so
both capacities drop (token, slot)s. Without the context ``moe_apply`` is
the reference's ``moe_apply`` (``rtol=1e-5, atol=1e-6 x max|y|``: the MoE
tests' cross-package bar, its absolute part scaled to this input's
outputs, which reach 3.5), and a capacity counted per block keeps other
ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import moe as ref_moe

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import moe

SAME = 1e-6
CROSS_RTOL, CROSS_ATOL_REL = 1e-5, 1e-6
NAME = "deepseek-v2-lite-16b"
KEYS = ("expert", "keep", "slot")


def _layer(cf, seed=0):
    """The config, its MoE weights (the init's scales) and an input whose
    rows share a direction, so the router prefers some experts."""
    cfg = reduced(ARCHS[NAME]).replace(capacity_factor=cf)
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    Fs = cfg.n_shared_experts * Fe

    def dense(shape, fan_in, scale=1.0):
        w = rng.standard_normal(shape).clip(-2, 2) * scale / np.sqrt(fan_in)
        return w.astype(np.float32)

    p = {"router": dense((D, E), D, 0.5), "wg": dense((E, D, Fe), D),
         "wu": dense((E, D, Fe), D), "wo": dense((E, Fe, D), Fe, 0.5),
         "shared": {"wg": dense((D, Fs), D), "wu": dense((D, Fs), D),
                    "wo": dense((Fs, D), Fs, 0.5)}}
    x = rng.standard_normal((8, 16, D)) + 2.0 * rng.standard_normal(D)
    return cfg, p, x.astype(np.float32)


def _torch(p):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


def _by_shards(cfg, p, x, n):
    """``moe_apply`` on ``n`` row blocks of ``x`` in turn under
    ``global_dispatch``: the joined output, the global aux, the routes."""
    rows = x.shape[0] // n
    ys, disps, offsets = [], [], []
    with moe.recording_routes() as routes:
        for k in range(n):
            d = moe.Dispatch(x.shape[0] * x.shape[1], offsets)
            with moe.global_dispatch(d):
                y, aux = moe.moe_apply(cfg, p, x[k * rows:(k + 1) * rows])
            assert float(aux) == 0.0
            assert len(d.counts) == len(d.me_sum) == len(d.ce_sum) == 1
            offsets = d.carried(x.device)
            ys.append(y)
            disps.append(d)
    joined = {key: torch.cat([r[key] for r in routes]) for key in KEYS}
    return torch.cat(ys), moe.global_aux(cfg, disps, x.device), joined


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shards_under_global_dispatch_are_the_global_call(n, cf):
    cfg, p_np, x_np = _layer(cf)
    p, x = _torch(p_np), torch.from_numpy(x_np)
    with moe.recording_routes() as routes:
        want, aux_w = moe.moe_apply(cfg, p, x)
    (r,) = routes
    assert int((~r["keep"]).sum()) > 0, "no (token, slot) dropped"
    got, aux_g, joined = _by_shards(cfg, p, x, n)
    for key in KEYS:
        assert torch.equal(joined[key], r[key]), key
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SAME,
                               atol=SAME * float(want.abs().max()))
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=SAME)
    assert moe._DISPATCH.get() is None and moe._ROUTES.get() is None


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_without_dispatch_moe_apply_is_the_references(cf):
    cfg, p_np, x_np = _layer(cf)
    y, aux = moe.moe_apply(cfg, _torch(p_np), torch.from_numpy(x_np))
    ref_cfg = ref_reduced(REF_ARCHS[NAME]).replace(capacity_factor=cf)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in p_np.items()}
    y_r, aux_r = ref_moe.moe_apply(ref_cfg, jp, jnp.asarray(x_np))
    y_r = np.asarray(y_r)
    np.testing.assert_allclose(y.numpy(), y_r, rtol=CROSS_RTOL,
                               atol=CROSS_ATOL_REL * float(np.abs(y_r).max()))
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=CROSS_RTOL)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_capacity_per_block_keeps_other_slots(cf):
    """The wrong answer the dispatch exists to avoid: blocks sized and
    counted on their own tokens."""
    cfg, p_np, x_np = _layer(cf)
    p, x = _torch(p_np), torch.from_numpy(x_np)
    with moe.recording_routes() as routes:
        moe.moe_apply(cfg, p, x)
        for k in range(4):
            moe.moe_apply(cfg, p, x[2 * k:2 * k + 2])
    glob, *blocks = routes
    assert torch.equal(torch.cat([b["expert"] for b in blocks]),
                       glob["expert"])
    assert not torch.equal(torch.cat([b["keep"] for b in blocks]),
                           glob["keep"])
