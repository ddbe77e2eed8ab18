"""Builds the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/<name>-<hash of the source>.so`` at
the root of the checkout, then loaded with ``ctypes``. Nothing but the sources
in the repository goes into the build; a changed source gets a new file name,
so a stale library is never loaded. A failed build raises
``KernelUnavailableError`` with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..resilience.errors import KernelUnavailableError

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir() -> Path:
    """``build/repro_torch/`` beside ``src/`` (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise KernelUnavailableError(
        "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise KernelUnavailableError(f"no kernel source {src}")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named kernel that is not built yet, one ``nvcc`` for each
    source, all started together. Returns name -> library path. The
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    names = kernel_names() if names is None else list(names)
    libs = {n: library_path(n) for n in names}
    todo = [n for n in names if not libs[n].is_file()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = libs[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0 or not tmp.is_file():
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{report}")
            continue
        Path(str(libs[n]) + ".log").write_text(report)
        os.replace(tmp, libs[n])
    if failed:
        raise KernelUnavailableError(
            "CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it when missing."""
    path = build_all([name])[name]
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelUnavailableError(f"cannot load {path}: {e}") from e


def build_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when ``name`` was built ("" if unbuilt)."""
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.is_file() else ""
