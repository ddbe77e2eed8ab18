"""Port vs reference: crash-safe chunked STKDE (counterparts of the
single-device cases of ``tests/test_journal.py``) and the journal's
cross-package contract — one fingerprint, one wire format, and a journal
left partial by either package resumed by the other.

Here too: the serve partial answer (from either package's journal) and the
H100 planner record fitted from the committed reconcile rows (the
counterpart of the reference's calibrated host record). The mesh-shrink and
device-loss cases are in ``tests/test_torch_distributed.py``."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import Domain as RefDomain
from repro.core import kernels_math as ref_km
from repro.core.api import _chunk_fingerprint as ref_chunk_fingerprint
from repro.core.api import stkde_chunked as ref_stkde_chunked
from repro.core.datasets import STKDEInstance as RefInstance
from repro.data.pipeline import stkde_stream as ref_stkde_stream
from repro.resilience import faults as ref_faults
from repro.resilience.journal import ProgressJournal as RefJournal
from repro.resilience.journal import fingerprint_of as ref_fingerprint_of
from repro.resilience.journal import iter_records as ref_iter_records

from repro_torch import convert
from repro_torch.core import clustered_events, pb
from repro_torch.core import kernels_math as km
from repro_torch.core.api import (
    ChunkedResult,
    _chunk_fingerprint,
    stkde,
    stkde_chunked,
)
from repro_torch.core.datasets import STKDEInstance
from repro_torch.data.pipeline import stkde_stream
from repro_torch.obs import metrics, trace
from repro_torch.resilience import ReproValidationError, faults
from repro_torch.resilience.errors import KernelUnavailableError
from repro_torch.serve import stkde_partial_answer
from repro_torch.resilience.journal import (
    MAGIC,
    ProgressJournal,
    fingerprint_of,
    iter_records,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
REF_DOM = RefDomain(gx=32.0, gy=28.0, gt=12.0, sres=1.0, tres=1.0, hs=3.0,
                    ht=2.0)
DOM = convert.domain_from_reference(REF_DOM)
CPU = dict(device="cpu")
CROSS_TOL = dict(rtol=1e-5, atol=1e-8)


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's fault injector, metrics registry and tracer are process
    globals of their own: start each test clean and leave nothing behind.
    The tracer records for the test (it is off by default): the tests read
    the chunked runs' and the partial answers' spans."""
    faults.configure("", 0)
    trace.enable()
    yield
    trace.enable(False)
    faults.reset()
    metrics.reset()
    trace.reset()


def _pts(n=500, seed=7):
    return clustered_events(n, DOM, seed=seed)


def _chunked(pts, **kw):
    return stkde_chunked(pts, DOM, **CPU, **kw)


# ------------------------------------------------------- fault sites
def test_new_sites_registered():
    assert {"stkde.chunk", "journal.write", "dist.device"} <= set(faults.SITES)
    rules = faults.parse_spec("*:oom:0.5")
    assert {r.site for r in rules} == set(faults.SITES)


def test_fault_spec_means_the_same_in_both_packages():
    """Same sites, kinds and grammar, and the same decisions for one
    ``REPRO_FAULTS`` spec and seed."""
    assert faults.SITES == ref_faults.SITES
    assert faults.KINDS == ref_faults.KINDS
    assert (faults.ENV_SPEC, faults.ENV_SEED) == (ref_faults.ENV_SPEC,
                                                  ref_faults.ENV_SEED)
    spec = "stkde.chunk:oom:0.3,journal.write:corrupt:0.5:0.2,*:delay:0.1"
    ours, theirs = faults.parse_spec(spec), ref_faults.parse_spec(spec)
    assert [(r.site, r.kind, r.rate, r.param) for r in ours] == [
        (r.site, r.kind, r.rate, r.param) for r in theirs]
    a = faults.FaultInjector(ours, seed=3)
    b = ref_faults.FaultInjector(theirs, seed=3)
    for site in ("stkde.chunk", "journal.write"):
        for _ in range(40):
            assert (a._trigger(site, ("oom", "corrupt")) is None) == (
                b._trigger(site, ("oom", "corrupt")) is None)


# --------------------------------------------------- chunked == mono
def test_chunked_matches_monolithic():
    pts = _pts()
    mono = stkde(pts, DOM, **CPU).numpy().astype(np.float64)
    res = _chunked(pts, chunk_size=128)
    assert isinstance(res, ChunkedResult)
    assert res.grid.dtype == np.float64
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6)
    rep = res.report
    assert rep["chunks_total"] == 4 and rep["chunks_computed"] == 4
    assert rep["coverage"] == 1.0
    assert rep["max_chunk_points"] <= 128
    assert rep["final_strategy"] == "local" and rep["final_mesh"] is None
    assert metrics.counter("chunk.computed").value == 4
    assert len(trace.get_tracer().spans("chunk.compute")) == 4


def test_chunked_matches_reference():
    pts = _pts()
    want = ref_stkde_chunked(pts, REF_DOM, chunk_size=128)
    got = _chunked(pts, chunk_size=128)
    np.testing.assert_allclose(got.grid, want.grid, **CROSS_TOL)
    assert got.report == want.report


def test_chunked_bitwise_deterministic():
    pts = _pts()
    a = _chunked(pts, chunk_size=128).grid
    b = _chunked(pts, chunk_size=128).grid
    assert np.array_equal(a, b)


def test_chunk_size_independence_32k_stream():
    """32k-point instance streams through bounded chunks (peak point buffer
    is one chunk), yields the reference's chunks, and matches the
    monolithic grid."""
    inst = STKDEInstance("Kill32k", n=32768, Gx=32, Gy=28, Gt=12,
                         Hs=3, Ht=2, seed=5)
    ref_inst = RefInstance("Kill32k", n=32768, Gx=32, Gy=28, Gt=12,
                           Hs=3, Ht=2, seed=5)
    dom = inst.domain()
    res = stkde_chunked(stkde_stream(inst, chunk=2048), dom, **CPU)
    rep = res.report
    assert rep["n_total"] == 32768
    assert rep["chunks_total"] == 16
    assert rep["max_chunk_points"] <= 2048  # bounded point buffer
    ours = [c for c, _ in stkde_stream(inst, chunk=2048)]
    theirs = [c for c, _ in ref_stkde_stream(ref_inst, chunk=2048)]
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    mono = pb(np.concatenate(ours, axis=0), dom, **CPU).numpy()
    assert np.allclose(res.grid, mono.astype(np.float64), rtol=1e-3,
                       atol=1e-7)


# ------------------------------------------------------ resume paths
def test_partial_then_resume_bit_identical(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    ref = _chunked(pts, chunk_size=128).grid
    part = _chunked(pts, chunk_size=128, journal=jdir, max_chunks=2)
    assert part.report["truncated"] and part.report["coverage"] < 1.0
    res = _chunked(pts, chunk_size=128, journal=jdir, resume=True)
    assert res.report["chunks_salvaged"] == 2
    assert res.report["chunks_computed"] == 2
    assert res.report["resumed"] and res.report["coverage"] == 1.0
    assert np.array_equal(res.grid, ref)


def test_truncated_tail_record_recovers(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    ref = _chunked(pts, chunk_size=128, journal=jdir).grid
    jpath = os.path.join(jdir, "journal.bin")
    size = os.path.getsize(jpath)
    with open(jpath, "r+b") as f:  # torn final append (crash mid-write)
        f.truncate(size - 7)
    res = _chunked(pts, chunk_size=128, journal=jdir, resume=True)
    assert res.report["dropped_tail_records"] == 1
    assert res.report["chunks_computed"] == 1  # only the torn chunk redone
    assert np.array_equal(res.grid, ref)


def test_flipped_crc_byte_recovers(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    ref = _chunked(pts, chunk_size=128, journal=jdir).grid
    jpath = os.path.join(jdir, "journal.bin")
    with open(jpath, "r+b") as f:  # flip one payload byte of the tail
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    res = _chunked(pts, chunk_size=128, journal=jdir, resume=True)
    assert res.report["dropped_tail_records"] >= 1
    assert np.array_equal(res.grid, ref)


def test_lost_snapshots_force_full_recompute(tmp_path):
    """Every snapshot gone -> salvage nothing, recompute from chunk 0,
    still bit-identical."""
    pts = _pts()
    jdir = str(tmp_path / "j")
    ref = _chunked(pts, chunk_size=128, journal=jdir).grid
    for f in os.listdir(jdir):
        if f.startswith("grid_"):
            os.remove(os.path.join(jdir, f))
    res = _chunked(pts, chunk_size=128, journal=jdir, resume=True)
    assert res.report["chunks_salvaged"] == 0
    assert res.report["chunks_computed"] == 4
    assert np.array_equal(res.grid, ref)


def test_stale_fingerprint_refuses(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    _chunked(pts, chunk_size=128, journal=jdir, max_chunks=1)
    with pytest.raises(ReproValidationError):  # different chunking
        _chunked(pts, chunk_size=64, journal=jdir, resume=True)
    other_ref = RefDomain(gx=16.0, gy=16.0, gt=8.0, sres=1.0, tres=1.0,
                          hs=3.0, ht=2.0)
    other = convert.domain_from_reference(other_ref)
    with pytest.raises(ReproValidationError):  # different domain
        stkde_chunked(clustered_events(500, other, seed=7), other,
                      chunk_size=128, journal=jdir, resume=True, **CPU)


def test_stkde_resume_wrapper_recovers_chunk_size(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    ref = np.asarray(stkde(pts, DOM, chunk_size=128, journal=jdir, **CPU))
    again = stkde(pts, DOM, resume=jdir, **CPU)  # all salvaged
    assert again.report["chunks_salvaged"] == 4
    assert again.report["chunks_computed"] == 0
    assert np.array_equal(np.asarray(again), ref)


def test_journal_write_faults_retried(tmp_path):
    """In-flight corruption at journal.write: read-back verify catches it,
    the torn append is truncated and retried, and the run + replay still
    land clean."""
    pts = _pts()
    jdir = str(tmp_path / "j")
    faults.configure("journal.write:corrupt:0.4", seed=1)
    before = metrics.counter("resilience.retries.journal.write").value
    res = _chunked(pts, chunk_size=128, journal=jdir)
    assert metrics.counter(
        "resilience.retries.journal.write").value > before
    faults.configure("", 0)
    salvage = ProgressJournal(jdir).replay()
    assert salvage.dropped_tail == 0
    assert salvage.grid is not None
    assert np.array_equal(salvage.grid, res.grid)
    for rec in iter_records(jdir):
        assert rec["kind"] in ("meta", "chunk", "event")


def test_chunk_faults_retried_in_place():
    """An injected OOM at ``stkde.chunk`` is retried; the grid is the one
    of a clean run, bit for bit."""
    pts = _pts()
    ref = _chunked(pts, chunk_size=128).grid
    faults.configure("stkde.chunk:oom:0.3", seed=2)
    res = _chunked(pts, chunk_size=128)
    assert metrics.counter("resilience.retries.stkde.chunk").value > 0
    assert np.array_equal(res.grid, ref)


def test_journal_wire_format(tmp_path):
    jdir = str(tmp_path / "j")
    _chunked(_pts(), chunk_size=256, journal=jdir)
    with open(os.path.join(jdir, "journal.bin"), "rb") as f:
        assert f.read(4) == MAGIC
    recs = list(iter_records(jdir))
    assert recs[0]["kind"] == "meta"
    chunk_recs = [r for r in recs if r["kind"] == "chunk"]
    assert [r["chunk_id"] for r in chunk_recs] == [0, 1]
    assert all("grid_crc32" in r for r in chunk_recs)


def test_chunked_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    for call in (lambda: stkde_chunked(_pts(), DOM, chunk_size=128),
                 lambda: stkde(_pts(), DOM, chunk_size=128)):
        with pytest.raises(KernelUnavailableError, match="CUDA"):
            call()


# --------------------------------------------------- SIGKILL + resume
KILL_CODE = """
from repro_torch.core import Domain, clustered_events
from repro_torch.core.api import stkde_chunked
from repro_torch.resilience import faults

dom = Domain(gx=32., gy=28., gt=12., sres=1., tres=1., hs=3., ht=2.)
pts = clustered_events(500, dom, seed=7)
# delay-only fault widens the kill window without touching the math
faults.configure("stkde.chunk:delay:1.0:0.4", seed=0)
stkde_chunked(pts, dom, chunk_size=50, journal={jdir!r}, device="cpu")
print("DONE", flush=True)
"""


def test_sigkill_midrun_resume_bit_identical(tmp_path):
    """SIGKILL a journaled chunked run mid-flight, resume from the journal:
    the grid is bit-identical to an uninterrupted run."""
    jdir = str(tmp_path / "j")
    snap1 = os.path.join(jdir, "grid_00000001.npy")
    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    env["PYTHONPATH"] = SRC
    proc = subprocess.Popen(
        [sys.executable, "-c", KILL_CODE.format(jdir=jdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:  # wait until >= 2 chunks landed
            if os.path.exists(snap1) or proc.poll() is not None:
                break
            time.sleep(0.02)
        assert proc.poll() is None, (
            "run finished before we could kill it:\n"
            + proc.stdout.read() + proc.stderr.read())
        proc.kill()  # SIGKILL: no handlers, no atexit, no flush
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert rc == -9
    assert "DONE" not in (proc.stdout.read() or "")

    pts = _pts()
    ref = _chunked(pts, chunk_size=50).grid
    res = _chunked(pts, chunk_size=50, journal=jdir, resume=True)
    assert res.report["resumed"]
    assert res.report["chunks_salvaged"] >= 1
    assert res.report["chunks_computed"] >= 1
    assert np.array_equal(res.grid, ref)  # atol=0, rtol=0


# ------------------------------------------------------- cross-package
def test_fingerprint_same_in_both_packages():
    fields = dict(dom={"gx": 1.5, "hs": 3.0}, n_total=500, chunk_size=128,
                  strategy="auto", ks="ks_epanechnikov", version=1)
    assert fingerprint_of(**fields) == ref_fingerprint_of(**fields)
    for pair, chunk in (("epanechnikov", 128), ("paper_verbatim", "stream")):
        ks, kt = (getattr(km, f"{k}_{pair}") for k in ("ks", "kt"))
        ref_ks, ref_kt = (getattr(ref_km, f"{k}_{pair}") for k in ("ks", "kt"))
        assert _chunk_fingerprint(DOM, 500, chunk, "auto", ks, kt) == \
            ref_chunk_fingerprint(REF_DOM, 500, chunk, "auto", ref_ks, ref_kt)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_journal(tmp_path, writer):
    pts = _pts()
    jdir = str(tmp_path / "j")
    if writer == "port":
        grid = _chunked(pts, chunk_size=128, journal=jdir).grid
        read_records, journal = ref_iter_records, RefJournal(jdir)
    else:
        grid = ref_stkde_chunked(pts, REF_DOM, chunk_size=128,
                                 journal=jdir).grid
        read_records, journal = iter_records, ProgressJournal(jdir)
    recs = list(read_records(jdir))
    assert recs[0]["kind"] == "meta"
    assert [r["chunk_id"] for r in recs if r["kind"] == "chunk"] == [
        0, 1, 2, 3]
    salvage = journal.replay()
    assert salvage.chunk_id == 3 and salvage.dropped_tail == 0
    assert np.array_equal(salvage.grid, grid)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_partial_journal_resumed_by_the_other_package(tmp_path, first):
    pts = _pts()
    jdir = str(tmp_path / "j")
    port_full = _chunked(pts, chunk_size=128).grid
    ref_full = ref_stkde_chunked(pts, REF_DOM, chunk_size=128).grid
    if first == "reference":
        ref_stkde_chunked(pts, REF_DOM, chunk_size=128, journal=jdir,
                          max_chunks=2)
        res = _chunked(pts, chunk_size=128, journal=jdir, resume=True)
    else:
        _chunked(pts, chunk_size=128, journal=jdir, max_chunks=2)
        res = ref_stkde_chunked(pts, REF_DOM, chunk_size=128, journal=jdir,
                                resume=True)
    assert res.report["resumed"] and res.report["coverage"] == 1.0
    assert res.report["chunks_salvaged"] == 2
    assert res.report["chunks_computed"] == 2
    np.testing.assert_allclose(res.grid, port_full, **CROSS_TOL)
    np.testing.assert_allclose(res.grid, ref_full, **CROSS_TOL)


def test_chunked_path_asks_for_fixed_order_adds(monkeypatch):
    """Every chunk's scatter is the fixed-order one (it is what keeps a
    resumed run bit-identical on the card, where ``index_add_`` adds with
    atomics)."""
    import repro_torch.core.api as api

    seen = []
    real = api._pb_impl

    def spy(*args, **kw):
        seen.append(kw.get("deterministic"))
        return real(*args, **kw)

    monkeypatch.setattr(api, "_pb_impl", spy)
    _chunked(_pts(), chunk_size=128)
    assert seen == [True] * 4


# --------------------------------------------------- serve partial answer
def test_serve_partial_answer(tmp_path):
    pts = _pts()
    jdir = str(tmp_path / "j")
    part = _chunked(pts, chunk_size=128, journal=jdir, max_chunks=3)
    ans = stkde_partial_answer(jdir, rescale=False)
    assert ans.coverage == pytest.approx(3 * 128 / 500)
    assert ans.chunks == 3 and ans.n_total == 500
    assert np.array_equal(ans.grid, part.grid)
    scaled = stkde_partial_answer(jdir, rescale=True)
    assert scaled.rescaled
    assert np.allclose(scaled.grid, part.grid / ans.coverage)
    with pytest.raises(ReproValidationError):
        stkde_partial_answer(str(tmp_path / "empty"))
    assert metrics.export()["counters"]["serve.partial_answers"] == 2
    assert len(trace.get_tracer().spans("serve.partial_answer")) == 2


def test_partial_answer_from_a_reference_journal(tmp_path):
    """A journal the reference left after 3 chunks: the port's partial
    answer is the reference's, bit for bit, rescaled or not."""
    from repro.serve.engine import stkde_partial_answer as ref_answer

    jdir = str(tmp_path / "j")
    part = ref_stkde_chunked(_pts(), REF_DOM, chunk_size=128, journal=jdir,
                             max_chunks=3)
    for rescale in (False, True):
        got, want = stkde_partial_answer(jdir, rescale), ref_answer(
            jdir, rescale)
        assert np.array_equal(got.grid, want.grid), rescale
        assert (got.coverage, got.chunks, got.n_total, got.rescaled) == (
            want.coverage, want.chunks, want.n_total, want.rescaled)
        assert got.journal_path == want.journal_path == jdir
    assert np.array_equal(stkde_partial_answer(jdir, False).grid, part.grid)


# --------------------------------------------------- H100 calibration
def test_h100_model_calibrated_against_committed_reconcile():
    """``plan.H100`` is fitted from results/torch/reconcile_h100.json: the
    card's name and power limit are there, every probed strategy has a
    compute row within 5x of ``H100``'s prediction on both meshes, and a
    re-fit from the whole file lands within 2x of the record."""
    from repro_torch.core import bucketing, get_instance, plan
    from repro_torch.distributed import make_host_mesh
    from repro_torch.distributed.stkde_dist import _device_grid_dims
    from repro_torch.obs import reconcile

    path = ROOT / "results" / "torch" / "reconcile_h100.json"
    assert path == plan.H100_ROWS
    reports = json.load(open(path))
    assert [r["mesh"] for r in reports] == ["2x2x2", "2x2"]
    inst = get_instance("PollenUS_Hr-Lb")
    dom, pts = inst.domain(), inst.points()
    for rep in reports:
        name, limit = rep["nvidia_smi"].split(", ")
        assert name.startswith("NVIDIA H100") and limit.endswith(" W")
        assert float(limit[:-2]) > 0
        assert rep["hw"] == "h100_seed" and rep["instance"] == inst.name
        assert (rep["n"], rep["grid"]) == (inst.n, "651x301x84")
    # H100 is the fit of the (2, 2, 2) report, from the card's peaks
    assert plan.H100 == plan.calibrate_host(reports[0]["rows"],
                                            base=plan.H100_SEED)
    assert not hasattr(plan, "V5E")
    meshes = {"2x2x2": make_host_mesh(8, multi_pod=True, device="cpu"),
              "2x2": make_host_mesh(4, device="cpu")}
    for rep in reports:
        mesh = meshes[rep["mesh"]]
        gx, gy = _device_grid_dims(dom, *[mesh.shape[a]
                                          for a in mesh.axis_names[-2:]])
        loads = bucketing.bucket_points_home(pts, dom, (gx, gy, dom.Gt)) \
            .counts.reshape(-1).astype(np.float64)
        compute = {r["strategy"]: r for r in rep["rows"]
                   if r["term"] == "compute_s"}
        want = (set(plan.probed_strategies()) if rep["mesh"] == "2x2x2"
                else {"dr", "dd", "pd", "pd_xt", "dd_lpt"})
        assert set(compute) == want
        for s, r in compute.items():
            spec = reconcile.PROBED[s]
            shape = spec.plan_shape(mesh, spec.default_axes(mesh))
            pred = plan.estimate(dom, inst.n, shape, loads=loads)[s]
            ratio = r["measured_s"] / pred["compute_s"]
            assert 1 / 5 < ratio < 5, (rep["mesh"], s, ratio)
    cal = plan.calibrate_host(str(path), base=plan.H100_SEED)
    assert 0.5 < cal.peak_flops / plan.H100.peak_flops < 2.0
    assert 0.5 < cal.mxu_derate / plan.H100.mxu_derate < 2.0
    # the fit moved far from the card's published peak
    assert plan.H100_SEED.peak_flops / plan.H100.peak_flops > 1e3
