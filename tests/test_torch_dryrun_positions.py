"""The dry run's position identity (``distributed/mesh.py``: every
position of a mesh on one fake device, each with a device object of its
own; ``launch/dryrun.py``'s tracker places storages by it) against the
direct count, each position on its own fake device ``meta:k``: the same
per-position peaks, collective bytes and flops, for train cells (dense,
an ``fsdp`` config with the batch over the model axis, the MoE global
dispatch, dbrx's all-to-all under the hint mesh; remat on, so blocks are
recomputed in backward) and the sharded prefill and decode, on (4, 2) and
(2, 2, 2) meshes.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)

from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import Mesh
from repro_torch.launch import dryrun, specs
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults

META = torch.device("meta")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _fresh_state():
    faults.configure("", 0)
    yield
    trace.reset()
    metrics.reset()
    faults.reset()


def _position_mesh(tag):
    shape, names = MESHES[tag]
    return Mesh(np.full(shape, META, dtype=object), names, positions=True)


def _device_mesh(tag):
    """Each position on its own fake device ``meta:k`` (row-major)."""
    shape, names = MESHES[tag]
    devs = np.empty(int(np.prod(shape)), dtype=object)
    for k in range(devs.size):
        devs[k] = torch.device("meta", k)
    return Mesh(devs.reshape(shape), names)


CASES = [("smollm-360m", "train", "2x2x2"),
         ("deepseek-v2-lite-16b", "train", "2x2x2"),
         ("dbrx-132b", "train", "4x2"),
         ("mistral-nemo-12b", "prefill", "2x2x2"),
         ("deepseek-v2-lite-16b", "decode", "4x2")]


@pytest.mark.parametrize("name,kind,tag", CASES)
def test_positions_account_as_distinct_devices(name, kind, tag):
    """The position identity (every position on one fake device) gives
    the per-position peaks and the collective bytes of the direct count,
    each position on its own ``meta:k`` device (remat on; dbrx's MoE
    through the all-to-all under the hint mesh)."""
    cfg = reduced(ARCHS[name]).replace(remat=True)
    shape = specs.ShapeCell("c", kind, 32, 8)
    got = {}
    for route, make in (("positions", _position_mesh),
                        ("devices", _device_mesh)):
        mesh = make(tag)
        got[route] = dryrun.run_built(dryrun._build(cfg, mesh, shape), mesh)
    a, b = got["positions"], got["devices"]
    assert a["memory"]["per_position"] == b["memory"]["per_position"]
    # (2, 2, 2): the parameters live on pod 0, batch shards at model 0
    assert len(a["memory"]["per_position"]) >= 6
    assert a["collectives"] == b["collectives"]
    assert a["collectives"]["total"] > 0
    assert a["cost"]["flops"] == b["cost"]["flops"]
