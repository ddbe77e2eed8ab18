"""Fault-tolerant checkpointing in the reference's on-disk format.

A checkpoint is a directory ``step_%08d/`` holding ``arrays.npz`` (one
member per leaf, the leaf's path with ``/`` written ``__``) and
``manifest.json`` (``step``, ``keys``, ``dtypes``, ``shapes``,
``checksum_crc32``, ``extra``): a checkpoint written by either package
restores in the other. Leaves are tensors (or numpy arrays) in trees of
dicts, lists, tuples and NamedTuples; the paths are the reference's
(``0/blocks/attn/wq``, ``1/mu/...``, ``1/step`` for ``(params,
opt_state)``). numpy has no bfloat16, so a bf16 leaf is written as its
``uint8`` byte view with the dtype name ``"bfloat16"`` (what the
reference's ``_encode`` writes) and read back through
``torch.Tensor.view(torch.bfloat16)``.

Resilience, as the reference's:
  * write to a temporary directory, fsync, re-read the landed bytes and
    check their CRC-32 before the atomic rename; a mismatch (the
    ``ckpt.write`` fault site corrupts the payload in flight) is retried;
  * ``save(..., keep=K)`` prunes to the newest K after a landing, never
    before;
  * ``restore(step=None)`` walks checkpoints newest to oldest past damaged
    ones (``resilience.ckpt_fallback`` counter); an explicit ``step`` is
    strict;
  * ``AsyncCheckpointer`` snapshots to host memory on the caller's thread
    (the device-to-host copy is the sync point) and writes on a thread.

Restore puts each leaf on the device of the template's leaf. A sharded
leaf (``distributed.sharding.Sharded``, the pieces of a parameter on a mesh)
is saved gathered whole, so the file is the reference's whatever the mesh,
and restored by cutting it again by the template leaf's spec and mesh.

The ``.npz`` is written and read here rather than by ``np.savez`` /
``np.load``, which copy each array in 16 MiB pieces and check each member's
CRC again: members are stored, ``.npy`` format 1.0, C order, exactly what
``np.savez`` writes for C-order arrays; each array goes into the zip as one
buffer and comes out as a view of the file's bytes once the whole file's
CRC-32 has matched the manifest. A multi-GB payload is assembled by numpy
copies (which let the training thread run, unlike ``io.BytesIO``'s),
checksummed, written and read back in pieces on threads (``crc32_combine``
joins the pieces' CRCs), since one thread's memory copies and CRCs set the
time of a save.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import tempfile
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..distributed.sharding import Sharded, gather, shard
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from ..resilience.errors import CheckpointCorruptError


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {
            k: _unflatten_into(v, flat, f"{prefix}{k}/")
            for k, v in template.items()
        }
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields
        ))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(template)
        )
    return flat[prefix[:-1]]


class _HostLeaf:
    """A leaf in host memory as it goes into the ``.npz``: its encoded
    array (a bf16 leaf as its ``uint8`` byte view), dtype name and shape."""

    def __init__(self, leaf):
        if isinstance(leaf, Sharded):
            leaf = gather(leaf)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True).contiguous()
            self.dtype = str(t.dtype).removeprefix("torch.")
            self.shape = list(t.shape)
            if t.dtype == torch.bfloat16:
                t = (t.reshape(-1) if t.ndim == 0 else t).view(torch.uint8)
            self.array = t.numpy()
        else:
            a = np.array(leaf, copy=True)
            self.array, self.dtype, self.shape = a, a.dtype.name, list(
                a.shape)


class _Buffer:
    """A seekable in-memory file of fixed capacity for ``zipfile``: its
    writes copy with numpy, which lets the training thread run meanwhile,
    where ``io.BytesIO`` copies holding the interpreter lock."""

    def __init__(self, capacity: int):
        self._buf = np.empty(capacity, np.uint8)
        self._pos = self._end = 0

    def write(self, b) -> int:
        src = np.frombuffer(b, np.uint8)
        self._buf[self._pos:self._pos + len(src)] = src
        self._pos += len(src)
        self._end = max(self._end, self._pos)
        return len(src)

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = 0) -> int:
        self._pos = pos + (0, self._pos, self._end)[whence]
        return self._pos

    def flush(self) -> None:
        pass

    def getbuffer(self) -> memoryview:
        return memoryview(self._buf[:self._end])


def _npz(arrays: Dict[str, np.ndarray]) -> memoryview:
    """The bytes ``np.savez`` writes for ``arrays`` (stored members named
    ``<key>.npy``, ``.npy`` format 1.0), each array written in one piece."""
    arrays = {k: np.asarray(a, order="C") for k, a in arrays.items()}
    # data, and per member at most: local header + zip64 extra (50), .npy
    # header (< 256), central entry + zip64 extra (74), both names; + ends
    buf = _Buffer(sum(a.nbytes + 512 + 2 * len(k) for k, a in arrays.items())
                  + 1024)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(a.reshape(-1).view(np.uint8).data)
    return buf.getbuffer()


def _npz_arrays(path: str, data: bytearray,
                check_members: bool) -> Dict[str, np.ndarray]:
    """The arrays of the ``.npz`` at ``path`` whose bytes are ``data``, as
    views of ``data``; each member's own CRC-32 is checked only when
    ``check_members`` (the whole file's has been checked otherwise)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    for info in infos:
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{path}: compressed member {info.filename}")
        off = info.header_offset
        name_len, extra_len = struct.unpack("<HH", data[off + 26:off + 30])
        start = off + 30 + name_len + extra_len
        member = memoryview(data)[start:start + info.file_size]
        if check_members and zlib.crc32(member) != info.CRC:
            raise CheckpointCorruptError(
                f"{path}: member {info.filename} fails its CRC")
        fp = io.BytesIO(bytes(member[:4096]))
        version = np.lib.format.read_magic(fp)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(fp)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(fp)
        else:
            raise ValueError(f"{path}: .npy format {version}")
        count = int(np.prod(shape))
        if fp.tell() + count * dtype.itemsize != info.file_size:
            raise ValueError(f"{path}: member {info.filename} is cut")
        arr = np.frombuffer(data, dtype=dtype, count=count,
                            offset=start + fp.tell())
        out[info.filename.removesuffix(".npy")] = arr.reshape(
            shape, order="F" if fortran else "C")
    return out


def _to_host(tree) -> Dict[str, _HostLeaf]:
    with obs.span("ckpt.snapshot"):
        return {k: _HostLeaf(v) for k, v in _flatten(tree).items()}


def _save_host(ckpt_dir, step, host, extra, keep):
    with obs.span("ckpt.save", step=int(step)):
        return _save(ckpt_dir, step, host, extra, keep)


# checksums and reads of a multi-GB checkpoint run in this many pieces at
# once (zlib.crc32 and os.preadv release the interpreter lock)
_PIECES = min(8, os.cpu_count() or 1)
_PIECE_MIN = 64 << 20


def _gf2_times(mat, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and ``len(b)``
    (zlib's ``crc32_combine``, which Python's ``zlib`` does not expose)."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    even = _gf2_square(odd)                           # two zero bits
    odd = _gf2_square(even)                           # four zero bits
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def _pieces(n: int):
    step = max(-(-n // _PIECES), _PIECE_MIN)
    return [(i, min(i + step, n)) for i in range(0, n, step)] or [(0, 0)]


def _crc(buf) -> int:
    """``zlib.crc32(buf)``, its pieces taken on threads."""
    mv = memoryview(buf).cast("B")
    parts = [mv[a:b] for a, b in _pieces(len(mv))]
    if len(parts) == 1:
        return zlib.crc32(parts[0])
    with ThreadPoolExecutor(len(parts)) as ex:
        crcs = list(ex.map(zlib.crc32, parts))
    crc = crcs[0]
    for part, c in zip(parts[1:], crcs[1:]):
        crc = crc32_combine(crc, c, len(part))
    return crc


def _read(path: str) -> bytearray:
    """The bytes of the file at ``path``, its pieces read on threads."""
    data = bytearray(os.path.getsize(path))
    mv = memoryview(data)
    fd = os.open(path, os.O_RDONLY)
    try:
        def piece(span):
            a, b = span
            while a < b:
                got = os.preadv(fd, [mv[a:b]], a)
                if got == 0:
                    raise CheckpointCorruptError(f"{path}: short read")
                a += got

        with ThreadPoolExecutor(_PIECES) as ex:
            list(ex.map(piece, _pieces(len(data))))
    finally:
        os.close(fd)
    return data


def _write(path: str, buf) -> None:
    """Write ``buf`` as the file at ``path`` (its pieces on threads) and
    fsync it."""
    mv = memoryview(buf).cast("B")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        def piece(span):
            a, b = span
            while a < b:
                a += os.pwritev(fd, [mv[a:b]], a)

        with ThreadPoolExecutor(_PIECES) as ex:
            list(ex.map(piece, _pieces(len(mv))))
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_crc(path: str) -> int:
    return _crc(_read(path))


_WRITE_POLICY = _retry.RetryPolicy(max_attempts=5, base_delay_s=0.01,
                                   max_delay_s=0.2)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: Optional[int] = None):
    """Crash-consistent save: serialize, write-verify (CRC), atomic rename.

    The write is retried under ``_WRITE_POLICY`` when the landed bytes
    fail verification (injected or real corruption); ``keep`` prunes to
    the newest K checkpoints after this one lands.
    """
    return _save_host(ckpt_dir, step, _to_host(tree), extra, keep)


def _save(ckpt_dir, step, host, extra, keep):
    os.makedirs(ckpt_dir, exist_ok=True)
    with obs.span("ckpt.serialize"):
        payload = _npz({k.replace("/", "__"): v.array
                        for k, v in host.items()})
        checksum = _crc(payload)
    manifest = {
        "step": int(step),
        "keys": sorted(host),
        "dtypes": {k: v.dtype for k, v in host.items()},
        "shapes": {k: v.shape for k, v in host.items()},
        "checksum_crc32": checksum,
        "extra": extra or {},
    }

    def write_once() -> str:
        _faults.fault_point("ckpt.write")
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
        try:
            apath = os.path.join(tmp, "arrays.npz")
            with obs.span("ckpt.write"):
                # the ckpt.write fault site bit-flips the payload in
                # flight; the read-back below catches it before the rename
                _write(apath, _faults.corrupt("ckpt.write", payload))
            with obs.span("ckpt.verify"):
                landed = _file_crc(apath)
            if landed != checksum:
                raise CheckpointCorruptError(
                    f"step {step}: landed crc {landed:#x} != "
                    f"{checksum:#x} (write corrupted)"
                )
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(ckpt_dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            return final
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    final = _retry.with_retry(write_once, policy=_WRITE_POLICY,
                              site="ckpt.write")
    if keep is not None:
        gc_steps(ckpt_dir, keep)
    return final


def gc_steps(ckpt_dir: str, keep: int) -> None:
    """Prune to the newest ``keep`` checkpoints."""
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(
            os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True
        )


class AsyncCheckpointer:
    """Snapshot to host on the caller's thread, then write on a daemon
    thread; join on demand."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        # snapshot on the caller's thread (device -> host is the sync point)
        host = _to_host(tree)

        def write():
            try:
                _save_host(self.ckpt_dir, step, host, extra, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, d, "manifest.json")
        ):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def verify(ckpt_dir: str, step: int) -> bool:
    """Cheap integrity check: manifest parses and the payload CRC matches
    (checkpoints written before checksums are accepted as they are)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want = manifest.get("checksum_crc32")
        if want is None:
            return True
        return _file_crc(os.path.join(path, "arrays.npz")) == want
    except (OSError, ValueError):
        return False


def _decode(arr: np.ndarray, dtype: Optional[str], shape) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    elif dtype is not None and arr.dtype.name != dtype:
        raise ValueError(f"leaf stored as {arr.dtype.name}, manifest says "
                         f"{dtype}")
    return t.reshape(shape) if shape is not None else t


def _load_step(path: str, template: Any) -> Tuple[Any, dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    apath = os.path.join(path, "arrays.npz")
    want = manifest.get("checksum_crc32")
    with obs.span("ckpt.verify"):
        data = _read(apath)
        got = _crc(data) if want is not None else None
    if got != want:
        raise CheckpointCorruptError(
            f"{path}: payload crc {got:#x} != manifest {want:#x}")
    dtypes = manifest.get("dtypes", {})
    shapes = manifest.get("shapes", {})
    with obs.span("ckpt.decode"):
        flat = {}
        for k, arr in _npz_arrays(apath, data, want is None).items():
            key = k.replace("__", "/")
            flat[key] = _decode(arr, dtypes.get(key), shapes.get(key))

    def place(t, like):
        if isinstance(like, Sharded):
            return shard(t, like.spec, like.mesh)
        return t.to(like.device if isinstance(like, torch.Tensor)
                    else torch.device("cpu"))

    with obs.span("ckpt.place"):
        placed = {k: place(flat[k], v)
                  for k, v in _flatten(template).items()}
    return _unflatten_into(template, placed), manifest


def restore(
    ckpt_dir: str,
    template: Any,
    step: Optional[int] = None,
) -> Tuple[Any, int, dict]:
    """Restore into ``template``'s structure, each leaf on the device of
    the template's leaf.

    With ``step=None``, walks checkpoints newest to oldest and skips
    corrupt or unreadable ones (``resilience.ckpt_fallback`` counts each
    skip); an explicit ``step`` is loaded strictly and raises
    ``CheckpointCorruptError`` on damage.
    """
    if step is not None:
        candidates = [step]
        strict = True
    else:
        candidates = list(reversed(all_steps(ckpt_dir)))
        strict = False
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: Optional[BaseException] = None
    for s in candidates:
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            with obs.span("ckpt.restore", step=s):
                tree, manifest = _load_step(path, template)
        except (CheckpointCorruptError, OSError, ValueError, KeyError,
                zlib.error, zipfile.BadZipFile, struct.error) as e:
            if strict:
                if isinstance(e, CheckpointCorruptError):
                    raise
                raise CheckpointCorruptError(f"{path}: {e}") from e
            obs.counter("resilience.ckpt_fallback").inc()
            last_err = e
            continue
        return tree, s, manifest.get("extra", {})
    raise CheckpointCorruptError(
        f"no valid checkpoint in {ckpt_dir} "
        f"(tried {len(candidates)}; last: {last_err})"
    )
