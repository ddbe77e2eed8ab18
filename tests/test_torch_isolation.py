"""The port stands alone: it imports neither jax nor the reference package,
and the ids it hands the CUDA kernel are the ids the kernel's source names."""
import pathlib
import re
import subprocess
import sys

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
import repro_torch
from repro_torch.core import kernels_math as km

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          prefix="repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    k for k, v in sys.modules.items()
    if v is not None and (k == "jax" or k.startswith(("jax.", "jaxlib"))
                          or k == "repro" or k.startswith("repro.")))
print("IMPORTED", len(names))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    n = int(re.search(r"IMPORTED (\d+)", proc.stdout).group(1))
    assert n >= 64, proc.stdout


def test_distributed_modules_stand_alone():
    """The mesh, collectives, strategies, placement, sharding-rule and
    coloring modules are imported with jax unimportable, and bring in
    neither jax nor the reference."""
    probe = _PROBE + r"""
want = {"repro_torch.distributed", "repro_torch.distributed.mesh",
        "repro_torch.distributed.collectives",
        "repro_torch.distributed.stkde_dist",
        "repro_torch.distributed.partition",
        "repro_torch.distributed.sharding", "repro_torch.core.coloring"}
print("MISSING", sorted(want - set(names)))
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout and "MISSING []" in proc.stdout, \
        proc.stdout


def test_lm_modules_stand_alone():
    """The language models, their configs, the serving engine, the training
    stack (gradient compression included), its data stream, the launch
    entry points and the launch arithmetic (mesh shapes, shape specs,
    roofline) are imported with jax unimportable, and bring in neither jax
    nor the reference."""
    probe = _PROBE + r"""
want = {"repro_torch.models", "repro_torch.models.config",
        "repro_torch.models.layers", "repro_torch.models.attention",
        "repro_torch.models.mla", "repro_torch.models.moe",
        "repro_torch.models.ssm", "repro_torch.models.rwkv",
        "repro_torch.models.transformer", "repro_torch.models.model",
        "repro_torch.configs", "repro_torch.configs.lm_archs",
        "repro_torch.serve", "repro_torch.serve.engine",
        "repro_torch.train", "repro_torch.train.optimizer",
        "repro_torch.train.train_step", "repro_torch.train.checkpoint",
        "repro_torch.train.runner", "repro_torch.data",
        "repro_torch.data.pipeline", "repro_torch.launch",
        "repro_torch.launch.train", "repro_torch.launch.serve",
        "repro_torch.train.grad_compress", "repro_torch.launch.mesh",
        "repro_torch.launch.specs", "repro_torch.launch.roofline",
        "repro_torch.launch.dryrun"}
print("MISSING", sorted(want - set(names)))
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout and "MISSING []" in proc.stdout, \
        proc.stdout


def test_no_module_of_the_port_names_jax_or_the_reference():
    root = pathlib.Path(repro_torch.__file__).resolve().parent
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    hits = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


def test_kernel_ids_match_the_cuda_source():
    cu = (pathlib.Path(repro_torch.__file__).resolve().parent
          / "kernels" / "csrc" / "stkde_tile.cu").read_text()
    defines = dict(re.findall(r"^#define (K[ST]_[A-Z_]+) (\d+)$", cu, re.M))
    want = {fn.__name__.upper(): str(i) for fn, i in km.KERNEL_IDS.items()}
    assert defines == want
