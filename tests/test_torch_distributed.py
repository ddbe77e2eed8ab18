"""Port vs reference: the seven multi-device STKDE strategies, meshes and
collectives, the mesh branch of ``stkde`` / ``stkde_chunked`` (fallback,
chaos, chunked runs on a mesh and their resume).

Counterparts of every case of ``tests/test_stkde_distributed.py``, of the
two distributed cases of ``tests/test_resilience.py`` and of the mesh cases
of ``tests/test_journal.py`` (the mesh-shrink recovery among them). The
reference runs once for the whole file, in one subprocess with 8 fake XLA
devices, and leaves its grids in an ``.npz``; the port runs in this process
on meshes of CPU shards. On CPU meshes both packages plan with the same
``HOST`` record, so their choices and recovery events are equal.
"""
import textwrap

import numpy as np
import pytest
import torch

from util_subproc import run_with_devices

import repro.core  # noqa: F401  (conftest's teardown imports repro.resilience,
#                     which the reference can import only after repro.core)
from repro_torch.core import Domain, clustered_events, pb
from repro_torch.core.api import stkde, stkde_chunked
from repro_torch.distributed import (
    Mesh,
    STRATEGIES,
    make_host_mesh,
    shrink_mesh,
)
from repro_torch.distributed import stkde_dist as sd
from repro_torch.distributed.collectives import ppermute, psum
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.resilience.errors import (
    KernelUnavailableError,
    ReproValidationError,
    RetriesExhaustedError,
)
from repro_torch.resilience.journal import iter_records

CROSS_TOL = dict(rtol=1e-5, atol=1e-8)   # port vs reference
PB_ATOL = 5e-7                           # strategy vs single-device pb
CPU = "cpu"

# (domain, n, seed) of each reference test; the snippet below builds the
# same ones
DOMS = {
    "all": (dict(gx=48., gy=40., gt=20., sres=1., tres=1., hs=3., ht=2.),
            1500, 5),
    "sweep": (dict(gx=40., gy=36., gt=10., sres=1., tres=1., hs=2., ht=1.),
              700, 9),
    "pad": (dict(gx=45., gy=34., gt=13., sres=1., tres=1., hs=2., ht=2.),
            600, 3),
    "small": (dict(gx=16., gy=16., gt=8., sres=1., tres=1., hs=8., ht=2.),
              100, 1),
    "nocomm": (dict(gx=48., gy=48., gt=16., sres=1., tres=1., hs=3., ht=2.),
               1500, 7),
    "chaos": (dict(gx=40., gy=36., gt=10., sres=1., tres=1., hs=2., ht=1.),
              500, 9),
    "chaos_rate": (dict(gx=40., gy=36., gt=10., sres=1., tres=1., hs=2.,
                        ht=1.), 400, 4),
    "journal": (dict(gx=32., gy=28., gt=12., sres=1., tres=1., hs=3.,
                     ht=2.), 600, 11),
    "auto": (dict(gx=48., gy=32., gt=16., sres=1., tres=1., hs=3., ht=2.),
             900, 2),
}
SWEEP_SHAPES = [(1, 8), (8, 1), (2, 4)]
AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")


def _case(name):
    d, n, seed = DOMS[name]
    dom = Domain(**d)
    return dom, clustered_events(n, dom, seed=seed)


def _heavy():
    """All mass in one corner: worst case for block DD, fine for LPT."""
    dom = Domain(gx=64., gy=64., gt=8., sres=1., tres=1., hs=3., ht=1.)
    rng = np.random.default_rng(0)
    pts = (rng.normal(8, 2.0, size=(2000, 3))
           .clip(0.1, 60).astype(np.float32))
    pts[:, 2] = rng.uniform(0, 7.9, 2000)
    return dom, pts


REFERENCE = textwrap.dedent(
    """
    import json
    import numpy as np, jax
    from jax.sharding import AxisType, Mesh
    from repro.core import Domain, clustered_events
    from repro.core.api import stkde, stkde_chunked
    from repro.distributed import stkde_dist as sd
    from repro.launch.mesh import make_host_mesh, shrink_mesh
    from repro.obs import metrics
    from repro.resilience import faults

    DOMS = {doms!r}
    out, info = {{}}, {{}}

    def case(name):
        d, n, seed = DOMS[name]
        dom = Domain(**d)
        return dom, clustered_events(n, dom, seed=seed)

    def mesh(shape, names):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    m2, m3 = mesh((4, 2), ("data", "model")), mesh(
        (2, 2, 2), ("pod", "data", "model"))
    w2, ax3 = ("data", "model"), ("pod", "data", "model")

    dom, pts = case("all")
    for s in ("dr", "dd", "pd", "pd_xt", "dd_lpt"):
        out["all/" + s] = np.asarray(sd.STRATEGIES[s](pts, dom, m2))
    for s in ("hybrid", "pd_xyt"):
        out["all/" + s] = np.asarray(sd.STRATEGIES[s](pts, dom, m3))

    dom, pts = case("sweep")
    for shape in {sweep!r}:
        m = mesh(tuple(shape), w2)
        for s in ("dd", "pd", "pd_xt"):
            out[f"sweep/{{s}}/{{shape[0]}}x{{shape[1]}}"] = np.asarray(
                sd.STRATEGIES[s](pts, dom, m))

    dom, pts = case("pad")
    for s in ("dd", "pd", "dd_lpt"):
        out["pad/" + s] = np.asarray(sd.STRATEGIES[s](pts, dom, m2))

    rng = np.random.default_rng(0)
    hdom = Domain(gx=64., gy=64., gt=8., sres=1., tres=1., hs=3., ht=1.)
    hpts = (rng.normal(8, 2.0, size=(2000, 3))
            .clip(0.1, 60).astype(np.float32))
    hpts[:, 2] = rng.uniform(0, 7.9, 2000)
    out["heavy/dd_lpt"] = np.asarray(
        sd.stkde_dd_lpt(hpts, hdom, m2, tile=(16, 16, 8)))
    out["heavy/dr"] = np.asarray(sd.stkde_dr(hpts, hdom, m2))

    # collectives=False probes against the full builds, 1 and 8 devices
    dom, pts = case("nocomm")
    n = len(pts)
    one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ax3)
    for tag, m in (("1dev", one), ("8dev", m3)):
        for s, prep, build, axes in (
                ("pd", sd.prepare_pd, sd.build_pd, w2),
                ("pd_xt", sd.prepare_pd_xt, sd.build_pd_xt, w2),
                ("pd_xyt", sd.prepare_pd_xyt, sd.build_pd_xyt, ax3)):
            args = prep(pts, dom, m, axes)
            out[f"nocomm/{{tag}}/{{s}}/full"] = np.asarray(
                build(dom, m, axes, n)(*args))
            out[f"nocomm/{{tag}}/{{s}}/probe"] = np.asarray(
                build(dom, m, axes, n, collectives=False)(*args))
        args = sd.prepare_hybrid(pts, dom, m, w2, rep_axis="pod")
        out[f"nocomm/{{tag}}/hybrid/full"] = np.asarray(
            sd.build_pd(dom, m, w2, n, rep_axis="pod")(*args))
        out[f"nocomm/{{tag}}/hybrid/probe"] = np.asarray(
            sd.build_pd(dom, m, w2, n, rep_axis="pod",
                        collectives=False)(*args))
    args = sd.prepare_dr(pts, dom, m3, w2)
    out["nocomm/8dev/dr/probe"] = np.asarray(
        sd.build_dr(dom, m3, w2, n, collectives=False)(args))
    args, ctx = sd.prepare_dd_lpt(pts, dom, m3, w2)
    out["nocomm/8dev/dd_lpt/probe"] = np.asarray(sd.build_dd_lpt(
        dom, m3, w2, n, ctx["tile"], ctx["k"], ctx["cap"], ctx["ntiles"],
        collectives=False)(*args))

    # halo faults: pd falls back to dr
    dom, pts = case("chaos")
    for kind in ("nan", "oom"):
        faults.configure(f"dist.halo:{{kind}}:1.0", seed=0)
        out["fallback/" + kind] = np.asarray(
            stkde(pts, dom, mesh=m2, strategy="pd"))
    c = metrics.export()["counters"]
    info["fallback_counters"] = {{
        k: c[k] for k in ("resilience.fallbacks",
                          "resilience.fallbacks.stkde.pd")}}
    metrics.reset()
    dom, pts = case("chaos_rate")
    faults.configure("dist.halo:nan:0.3", seed=13)
    for q in range(6):
        out[f"chaos_rate/{{q}}"] = np.asarray(
            stkde(pts, dom, mesh=m2, strategy="pd"))
    info["chaos_rate_fallbacks"] = metrics.export()["counters"].get(
        "resilience.fallbacks", 0)
    faults.configure("", 0)

    # chunked dr on the (4, 2) host mesh
    dom, pts = case("journal")
    res = stkde_chunked(pts, dom, mesh=make_host_mesh(8), strategy="dr",
                        chunk_size=100)
    out["journal/dr"] = res.grid
    info["journal_report"] = {{k: res.report[k] for k in (
        "chunks_total", "final_mesh", "final_strategy")}}

    # strategy="auto" on a mesh: the query, and a chunked run
    dom, pts = case("auto")
    out["auto"] = np.asarray(stkde(pts, dom, mesh=m2, strategy="auto"))
    res = stkde_chunked(pts, dom, mesh=make_host_mesh(8), chunk_size=300)
    out["auto/chunked"] = res.grid
    info["auto_chunked_strategy"] = res.report["final_strategy"]

    # a device lost in 40% of the chunk calls: shrink, re-plan, finish
    dom, pts = case("journal")
    faults.configure("dist.device:oom:0.4", seed=3)
    res = stkde_chunked(pts, dom, mesh=make_host_mesh(8), strategy="dr",
                        chunk_size=100)
    faults.configure("", 0)
    out["shrink/dr"] = res.grid
    info["shrink_report"] = {{k: res.report[k] for k in (
        "recovery", "final_mesh", "final_strategy", "coverage")}}

    shrinks = {{}}
    for tag, m in (("host", make_host_mesh(8)), ("pod", m3)):
        seq = []
        while m is not None:
            seq.append([list(m.axis_names), list(m.devices.shape)])
            m = shrink_mesh(m)
        shrinks[tag] = seq
    info["shrinks"] = shrinks

    np.savez({path!r}, **out)
    print("INFO", json.dumps(info))
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's grids and facts for every case of this file."""
    import json

    path = str(tmp_path_factory.mktemp("reference") / "dist.npz")
    code = REFERENCE.format(doms=DOMS, sweep=SWEEP_SHAPES, path=path)
    stdout = run_with_devices(code, 8)
    line = [ln for ln in stdout.splitlines() if ln.startswith("INFO ")][-1]
    with np.load(path) as z:
        grids = {k: z[k] for k in z.files}
    return grids, json.loads(line[5:])


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's fault injector, metrics and tracer are process globals of
    their own: start each test clean and leave nothing behind. The tracer
    records for the test (it is off by default): a test reads the
    fallback's spans."""
    faults.configure("", 0)
    trace.enable()
    yield
    trace.enable(False)
    faults.reset()
    metrics.reset()
    trace.reset()


def _mesh(shape, names=AXES2):
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _host(n=8, multi_pod=False):
    return make_host_mesh(n, multi_pod=multi_pod, device=CPU)


def _check(got: torch.Tensor, want_pb: np.ndarray, want_ref: np.ndarray,
           tag: str) -> None:
    got = got.numpy()
    assert got.shape == want_pb.shape == want_ref.shape, tag
    assert np.abs(got - want_pb).max() < PB_ATOL, tag
    np.testing.assert_allclose(got, want_ref, **CROSS_TOL, err_msg=tag)


# ----------------------------------------------------------------- meshes
def test_mesh_shape_names_and_repeated_devices():
    m = _host()
    assert m.shape == {"data": 4, "model": 2}
    assert m.axis_names == AXES2 and m.size == 8
    assert all(d == torch.device(CPU) for d in m.devices.flat)
    m3 = _host(multi_pod=True)
    assert m3.shape == {"pod": 2, "data": 2, "model": 2}
    assert m3.devices_of(("data", "model")).shape == (2, 2)
    assert m3.devices_of(("model", "pod")).shape == (2, 2)
    with pytest.raises(ValueError):
        Mesh(np.full((2, 2), CPU, dtype=object), ("data",))
    with pytest.raises(ValueError):
        m.devices_of(("pod",))


def test_mesh_devices_of_keeps_axis_order():
    """A shard of a value split over some axes runs on the device at its
    coordinates, the other axes at 0."""
    devs = np.empty((2, 3), dtype=object)
    for i, j in np.ndindex(2, 3):
        devs[i, j] = f"cpu:{3 * i + j}"
    m = Mesh(devs, ("a", "b"))
    assert [str(d) for d in m.devices_of(("b",))] == ["cpu:0", "cpu:1",
                                                      "cpu:2"]
    swapped = m.devices_of(("b", "a"))
    assert swapped.shape == (3, 2) and str(swapped[2, 1]) == "cpu:5"


def test_host_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(KernelUnavailableError, match="CUDA"):
        make_host_mesh(8)


def test_shrink_mesh_single_device_exhausts():
    mesh = _mesh((1, 1))
    assert shrink_mesh(mesh) is None  # no survivors -> local fallback


def test_shrink_mesh_matches_reference(ref):
    _, info = ref
    for tag, m in (("host", _host()), ("pod", _host(multi_pod=True))):
        seq = []
        while m is not None:
            seq.append([list(m.axis_names), list(m.devices.shape)])
            m = shrink_mesh(m)
        assert seq == info["shrinks"][tag], tag


# ------------------------------------------------------------ collectives
def test_psum_adds_each_group_in_row_major_order():
    vals = np.empty((2, 3), dtype=object)
    for i, j in np.ndindex(2, 3):
        vals[i, j] = torch.tensor([float(10 * i + j)])
    rows = psum(vals, 1)
    assert rows.shape == (2,)
    assert [float(t) for t in rows] == [3.0, 33.0]
    total = psum(vals, (0, 1))
    assert total.shape == () and float(total[()]) == 36.0
    # fixed order: 1e8 + 1 - 1e8 in float32 depends on the order of adds
    order = np.empty(3, dtype=object)
    for k, v in enumerate((1e8, 1.0, -1e8)):
        order[k] = torch.tensor([v], dtype=torch.float32)
    assert float(psum(order, 0)[()]) == float(
        (torch.tensor([1e8]) + 1.0) - 1e8)


def test_ppermute_shifts_and_fills_zeros():
    devs = np.full((3, 2), torch.device(CPU), dtype=object)
    bands = np.empty((3, 2), dtype=object)
    for i, j in np.ndindex(3, 2):
        bands[i, j] = torch.full((2,), float(10 * i + j))
    fwd = ppermute(bands, devs, 0, 1)
    bwd = ppermute(bands, devs, 1, -1)
    assert [float(fwd[i, 1][0]) for i in range(3)] == [0.0, 1.0, 11.0]
    assert [float(bwd[2, j][0]) for j in range(2)] == [21.0, 0.0]
    # a received band is a copy: the sender's later adds do not reach it
    bands[0, 1].add_(100.0)
    assert float(fwd[1, 1][0]) == 1.0


# -------------------------------------------------- strategies vs reference
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_all_strategies_match_reference(ref, strategy):
    grids, _ = ref
    dom, pts = _case("all")
    mesh = (_host(multi_pod=True) if strategy in ("hybrid", "pd_xyt")
            else _host())
    got = STRATEGIES[strategy](pts, dom, mesh)
    _check(got, pb(pts, dom, device=CPU).numpy(), grids["all/" + strategy],
           strategy)


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("strategy", ["dd", "pd", "pd_xt"])
def test_mesh_shape_sweep(ref, strategy, shape):
    grids, _ = ref
    dom, pts = _case("sweep")
    got = STRATEGIES[strategy](pts, dom, _mesh(shape))
    _check(got, pb(pts, dom, device=CPU).numpy(),
           grids[f"sweep/{strategy}/{shape[0]}x{shape[1]}"], strategy)


@pytest.mark.parametrize("strategy", ["dd", "pd", "dd_lpt"])
def test_nondivisible_grid_padding(ref, strategy):
    """Grid dims not divisible by the device grid exercise the pad/slice."""
    grids, _ = ref
    dom, pts = _case("pad")
    got = STRATEGIES[strategy](pts, dom, _host())
    _check(got, pb(pts, dom, device=CPU).numpy(), grids["pad/" + strategy],
           strategy)


def test_pd_rejects_too_small_subdomains():
    dom, pts = _case("small")
    with pytest.raises(ValueError, match="bandwidth"):
        sd.stkde_pd(pts, dom, _host())


def test_heavy_clustering_with_lpt(ref):
    """All mass in one corner: worst case for block DD, fine for LPT."""
    grids, _ = ref
    dom, pts = _heavy()
    want = pb(pts, dom, device=CPU).numpy()
    _check(sd.stkde_dd_lpt(pts, dom, _host(), tile=(16, 16, 8)), want,
           grids["heavy/dd_lpt"], "lpt")
    _check(sd.stkde_dr(pts, dom, _host()), want, grids["heavy/dr"], "dr")


def test_dd_lpt_batches_cut_to_used_prefix():
    """A tight element budget (one tile a batch) and the default one give
    the same grid."""
    dom, pts = _heavy()
    mesh = _host()
    args, ctx = sd.prepare_dd_lpt(pts, dom, mesh, AXES2, tile=(16, 16, 8))
    build = lambda budget: sd.build_dd_lpt(  # noqa: E731
        dom, mesh, AXES2, len(pts), ctx["tile"], ctx["k"], ctx["cap"],
        ctx["ntiles"], budget_elems=budget)
    np.testing.assert_allclose(build(1)(*args).numpy(),
                               build(1 << 26)(*args).numpy(), rtol=1e-6,
                               atol=1e-9)
    batches = list(sd._tile_batches(np.array([9, 7, 0, 5, 0]), 4, 64))
    assert batches == [(0, 1, 9), (1, 2, 7), (3, 4, 5)]


def _dd_lpt_host_loop(pts, dom, mesh, axes, tile=None):
    """DD-LPT's layout as the port built it on the host before its buckets
    moved to the device: numpy overlap buckets, a padded (P, k, cap, 3)
    array filled tile by tile in LPT order."""
    from repro_torch.core import bucketing
    from repro_torch.distributed import partition

    P = int(np.prod([mesh.shape[a] for a in axes]))
    tile = tile or bucketing.default_tile(dom)
    b = bucketing.bucket_points_overlap(pts, dom, tile)
    assign = partition.lpt_assign(b.counts.reshape(-1).astype(np.float64), P)
    k = max(len(t) for t in assign.tiles_of_device)
    dpts = np.full((P, k, b.cap, 3), sd.PARK, dtype=np.float32)
    dval = np.zeros((P, k, b.cap), dtype=np.float32)
    dpos = np.zeros((P, k, 3), dtype=np.int32)
    for p, tiles in enumerate(assign.tiles_of_device):
        for s, t in enumerate(tiles):
            ti, tj, tk = np.unravel_index(t, b.ntiles)
            dpts[p, s] = b.points.reshape(-1, b.cap, 3)[t]
            dval[p, s] = b.valid.reshape(-1, b.cap)[t]
            dpos[p, s] = (ti * tile[0], tj * tile[1], tk * tile[2])
    ctx = {"tile": tile, "k": k, "cap": b.cap, "ntiles": b.ntiles}
    return (dpts, dval, dpos), ctx


@pytest.mark.parametrize("case,multi_pod,tile", [
    ("all", False, None), ("pad", False, None), ("small", False, None),
    ("heavy", False, (16, 16, 8)), ("nocomm", True, None),
])
def test_prepare_dd_lpt_equals_the_host_loop(case, multi_pod, tile):
    """Bucketing on the mesh's device and one gather through the slot table
    give the layout the host loop gave, bit for bit."""
    dom, pts = _heavy() if case == "heavy" else _case(case)
    mesh = _host(multi_pod=multi_pod)
    args, ctx = sd.prepare_dd_lpt(pts, dom, mesh, AXES2, tile=tile)
    want, want_ctx = _dd_lpt_host_loop(pts, dom, mesh, AXES2, tile)
    assert ctx == want_ctx
    for got, w in zip(args, want):
        assert got.device == mesh.first_device and got.dtype == {
            np.float32: torch.float32, np.int32: torch.int32}[w.dtype.type]
        np.testing.assert_array_equal(got.numpy(), w)


# ------------------------------------------------- collectives=False probes
_PROBED = {
    "pd": (sd.prepare_pd, sd.build_pd, AXES2),
    "pd_xt": (sd.prepare_pd_xt, sd.build_pd_xt, AXES2),
    "pd_xyt": (sd.prepare_pd_xyt, sd.build_pd_xyt, AXES3),
}


def _probe_pair(strategy, mesh, dom, pts):
    """(full build, collectives=False build) of a halo strategy."""
    n = len(pts)
    if strategy == "hybrid":
        args = sd.prepare_hybrid(pts, dom, mesh, AXES2, rep_axis="pod")
        return (sd.build_pd(dom, mesh, AXES2, n, rep_axis="pod")(*args),
                sd.build_pd(dom, mesh, AXES2, n, rep_axis="pod",
                            collectives=False)(*args))
    prep, build, axes = _PROBED[strategy]
    args = prep(pts, dom, mesh, axes)
    return (build(dom, mesh, axes, n)(*args),
            build(dom, mesh, axes, n, collectives=False)(*args))


@pytest.mark.parametrize("strategy", ["pd", "pd_xt", "pd_xyt", "hybrid"])
def test_nocomm_builds_identical_on_single_device(ref, strategy):
    """collectives=False probes are identical to the full builds on a
    1-device mesh (no neighbour sends anything, a size-1 psum is the
    identity)."""
    grids, _ = ref
    dom, pts = _case("nocomm")
    full, noc = _probe_pair(strategy, _mesh((1, 1, 1), AXES3), dom, pts)
    if strategy == "hybrid":
        assert noc.shape == (1,) + full.shape
        noc = noc[0]
    assert torch.equal(full, noc)
    np.testing.assert_allclose(
        full.numpy(), grids[f"nocomm/1dev/{strategy}/full"], **CROSS_TOL)


@pytest.mark.parametrize("strategy", ["pd", "pd_xt", "pd_xyt", "hybrid"])
def test_nocomm_builds_differ_only_by_halo_terms_8dev(ref, strategy):
    """On a 2x2x2 mesh the probes differ from the full builds only in the
    halo bands / rep-psum: subdomain interiors more than one bandwidth from
    a cut boundary are bitwise identical, and the boundary bands do differ
    (comm moves real mass). Both agree with the reference's."""
    grids, _ = ref
    dom, pts = _case("nocomm")
    Hs, Ht = dom.Hs, dom.Ht
    full, noc = _probe_pair(strategy, _host(multi_pod=True), dom, pts)
    key = f"nocomm/8dev/{strategy}"
    np.testing.assert_allclose(full.numpy(), grids[key + "/full"],
                               **CROSS_TOL)
    np.testing.assert_allclose(noc.numpy(), grids[key + "/probe"],
                               **CROSS_TOL)
    full, noc = full.numpy(), noc.numpy()
    interior = {
        "pd": np.s_[:, :, Hs:-Hs, Hs:-Hs, :],
        "pd_xt": np.s_[:, :, Hs:-Hs, :, Ht:-Ht],
        "pd_xyt": np.s_[:, :, :, Hs:-Hs, Hs:-Hs, Ht:-Ht],
        "hybrid": np.s_[:, :, Hs:-Hs, Hs:-Hs, :],
    }[strategy]
    if strategy == "hybrid":
        assert noc.shape == (2,) + full.shape
        asm = noc.sum(axis=0)
        assert (full != asm).any(), "hybrid: no halo mass moved"
        np.testing.assert_allclose(full[interior], asm[interior], rtol=1e-6,
                                   atol=1e-8)
        return
    assert full.shape == noc.shape
    assert (full != noc).any(), strategy + ": no halo mass moved"
    np.testing.assert_array_equal(full[interior], noc[interior])


@pytest.mark.parametrize("strategy", ["dr", "dd_lpt"])
def test_assembly_probes_match_reference(ref, strategy):
    """DR's and DD-LPT's probes are the device-stacked partial grids: the
    same split of the work as the reference's, and their sum is the full
    build."""
    grids, _ = ref
    dom, pts = _case("nocomm")
    mesh, n = _host(multi_pod=True), len(pts)
    if strategy == "dr":
        args = (sd.prepare_dr(pts, dom, mesh, AXES2),)
        build = lambda c: sd.build_dr(dom, mesh, AXES2, n,  # noqa: E731
                                      collectives=c)
    else:
        args, ctx = sd.prepare_dd_lpt(pts, dom, mesh, AXES2)
        build = lambda c: sd.build_dd_lpt(  # noqa: E731
            dom, mesh, AXES2, n, ctx["tile"], ctx["k"], ctx["cap"],
            ctx["ntiles"], collectives=c)
    noc, full = build(False)(*args), build(True)(*args)
    assert noc.shape == (4,) + full.shape
    np.testing.assert_allclose(noc.numpy(),
                               grids[f"nocomm/8dev/{strategy}/probe"],
                               **CROSS_TOL)
    total = noc[0].clone()
    for g in noc[1:]:
        total += g
    assert torch.equal(total, full)


# ------------------------------------------------------------ public API
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_api_runs_each_strategy_on_a_mesh(ref, strategy):
    grids, _ = ref
    dom, pts = _case("all")
    mesh = (_host(multi_pod=True) if strategy in ("hybrid", "pd_xyt")
            else _host())
    got = stkde(pts, dom, mesh=mesh, strategy=strategy,
                rep_axis="pod" if strategy == "pd_xyt" else None)
    _check(got, pb(pts, dom, device=CPU).numpy(), grids["all/" + strategy],
           strategy)


def test_auto_api_on_mesh(ref):
    """``strategy="auto"`` (also the default) on a mesh: the planner's pick
    gives the single-device grid and the reference's."""
    grids, _ = ref
    dom, pts = _case("auto")
    want = pb(pts, dom, device=CPU).numpy()
    _check(stkde(pts, dom, mesh=_host(), strategy="auto"), want,
           grids["auto"], "auto")
    _check(stkde(pts, dom, mesh=_host()), want, grids["auto"], "default")


def test_auto_chunked_on_mesh_plans_as_the_reference(ref):
    """``stkde_chunked`` with ``auto`` on a CPU mesh prices with ``HOST``
    from the chunk's home-bucket loads and picks the reference's
    strategy."""
    grids, info = ref
    dom, pts = _case("auto")
    res = stkde_chunked(pts, dom, mesh=_host(), chunk_size=300)
    assert res.report["final_strategy"] == info["auto_chunked_strategy"]
    assert res.report["strategy"] == "auto"
    np.testing.assert_allclose(res.grid, grids["auto/chunked"], **CROSS_TOL)
    mono = pb(pts, dom, device=CPU).numpy().astype(np.float64)
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6)


def test_auto_strategy_on_a_mesh_raises():
    """On a mesh only an unknown strategy name raises now; ``"auto"`` asks
    the planner (``test_auto_api_on_mesh``)."""
    dom, pts = _case("all")
    for call in (lambda: stkde(pts, dom, mesh=_host(), strategy="pb"),
                 lambda: stkde_chunked(pts, dom, mesh=_host(),
                                       strategy="pb", chunk_size=500)):
        with pytest.raises(ReproValidationError,
                           match="unknown strategy 'pb'; have 'auto'"):
            call()


def test_distributed_fallback_to_dr(ref):
    """An injected halo fault (NaN or OOM) must reroute pd to dr with an
    answer identical to the reference, counted as the reference counts."""
    grids, info = ref
    dom, pts = _case("chaos")
    want = pb(pts, dom, device=CPU).numpy()
    for kind in ("nan", "oom"):
        faults.configure(f"dist.halo:{kind}:1.0", seed=0)
        got = stkde(pts, dom, mesh=_host(), strategy="pd")
        _check(got, want, grids["fallback/" + kind], kind)
    c = metrics.export()["counters"]
    assert c["resilience.fallbacks"] == 2, c
    assert c["resilience.fallbacks.stkde.pd"] == 2, c
    assert {k: c[k] for k in info["fallback_counters"]} == \
        info["fallback_counters"]
    assert len(trace.get_tracer().spans("resilience.fallback")) == 2
    faults.configure("dist.halo:oom:1.0", seed=0)
    with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
        stkde(pts, dom, mesh=_host(), strategy="pd", fallback=False)


def test_distributed_chaos_rate_still_serves(ref):
    """Nonzero halo injection rate: every query answered and exact
    (fallback or clean path), with the reference's fault decisions."""
    grids, info = ref
    dom, pts = _case("chaos_rate")
    want = pb(pts, dom, device=CPU).numpy()
    faults.configure("dist.halo:nan:0.3", seed=13)
    for q in range(6):
        got = stkde(pts, dom, mesh=_host(), strategy="pd")
        _check(got, want, grids[f"chaos_rate/{q}"], f"query {q}")
    assert metrics.export()["counters"].get(
        "resilience.fallbacks", 0) == info["chaos_rate_fallbacks"]


# -------------------------------------------------- chunked on a mesh
def test_chunked_dr_on_mesh_matches_monolithic_and_reference(ref):
    grids, info = ref
    dom, pts = _case("journal")
    res = stkde_chunked(pts, dom, mesh=_host(), strategy="dr",
                        chunk_size=100)
    mono = pb(pts, dom, device=CPU).numpy().astype(np.float64)
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.grid, grids["journal/dr"], **CROSS_TOL)
    rep = res.report
    assert {k: rep[k] for k in info["journal_report"]} == \
        info["journal_report"]
    assert rep["coverage"] == 1.0 and rep["recovery"] == []


@pytest.mark.parametrize("strategy", ["dr", "pd", "hybrid"])
def test_chunked_on_mesh_resume_bit_identical(tmp_path, strategy):
    dom, pts = _case("journal")
    mesh = _host(multi_pod=strategy == "hybrid")
    kw = dict(mesh=mesh, strategy=strategy, chunk_size=100)
    full = stkde_chunked(pts, dom, **kw)
    again = stkde_chunked(pts, dom, **kw)
    assert np.array_equal(full.grid, again.grid)
    jdir = str(tmp_path / "j")
    part = stkde_chunked(pts, dom, journal=jdir, max_chunks=2, **kw)
    assert part.report["truncated"]
    res = stkde_chunked(pts, dom, journal=jdir, resume=True, **kw)
    assert res.report["chunks_salvaged"] == 2
    assert np.array_equal(res.grid, full.grid)
    chunks = [r for r in iter_records(jdir) if r["kind"] == "chunk"]
    assert all(r["mesh"] == list(mesh.devices.shape) for r in chunks)
    assert all(r["strategy"] == strategy for r in chunks)


def test_mesh_shrink_recovery_8dev(ref):
    """``dist.device`` loses a device in 40% of the chunk calls (seed 3):
    the run shrinks the mesh, re-plans with ``HOST`` and finishes, with the
    reference's recovery events, down to running ``local``."""
    grids, info = ref
    dom, pts = _case("journal")
    faults.configure("dist.device:oom:0.4", seed=3)
    res = stkde_chunked(pts, dom, mesh=_host(), strategy="dr",
                        chunk_size=100)
    faults.configure("", 0)
    mono = pb(pts, dom, device=CPU).numpy().astype(np.float64)
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6), \
        np.abs(res.grid - mono).max()
    np.testing.assert_allclose(res.grid, grids["shrink/dr"], **CROSS_TOL)
    rec = res.report["recovery"]
    assert rec, "expected device-loss recovery events"
    assert all(e["event"] == "device_lost" for e in rec)
    meshes = [tuple(e["from_mesh"]) for e in rec]
    assert meshes[0] == (4, 2)
    sizes = [int(np.prod(m)) for m in meshes]
    assert sizes == sorted(sizes, reverse=True), meshes  # monotone shrink
    assert res.report["coverage"] == 1.0
    assert {k: res.report[k] for k in info["shrink_report"]} == \
        info["shrink_report"]
    c = metrics.export()["counters"]
    assert c["chunk.device_lost"] == c["chunk.replans"] == len(rec)


def test_device_loss_leaves_journal_intact_and_resume_matches(tmp_path):
    """A journaled run that loses devices and stops after 4 chunks keeps its
    chunks and its ``device_lost`` events in the journal; a resume on the
    first mesh salvages the chunks, reports the events and finishes within
    the bar of the single-device grid."""
    dom, pts = _case("journal")
    kw = dict(mesh=_host(), strategy="dr", chunk_size=100)
    jdir = str(tmp_path / "j")
    faults.configure("dist.device:oom:0.4", seed=3)
    part = stkde_chunked(pts, dom, journal=jdir, max_chunks=4, **kw)
    faults.configure("", 0)
    lost = part.report["recovery"]
    assert part.report["truncated"] and lost
    events = [r for r in iter_records(jdir) if r["kind"] == "event"]
    assert [{k: e[k] for k in lost[0]} for e in events] == lost
    chunks = [r for r in iter_records(jdir) if r["kind"] == "chunk"]
    assert chunks[-1]["mesh"] == lost[-1]["to_mesh"]
    res = stkde_chunked(pts, dom, journal=jdir, resume=True, **kw)
    assert res.report["chunks_salvaged"] == 4
    assert res.report["coverage"] == 1.0
    assert [{k: e[k] for k in lost[0]} for e in res.report["recovery"]] \
        == lost
    mono = pb(pts, dom, device=CPU).numpy().astype(np.float64)
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6)


def test_device_loss_with_no_mesh_left_runs_local_on_the_mesh_device(
        monkeypatch):
    """When no mesh survives, the remaining chunks run ``local`` on the
    device the mesh was on, with fixed-order adds; a loss there raises."""
    import repro_torch.core.api as api

    seen = []
    real = api._pb_impl

    def spy(points, *args, **kw):
        seen.append((points.device, kw.get("deterministic")))
        return real(points, *args, **kw)

    monkeypatch.setattr(api, "_pb_impl", spy)
    dom, pts = _case("journal")
    faults.configure("dist.device:oom:1.0", seed=0)
    res = stkde_chunked(pts, dom, mesh=_mesh((2, 1)), strategy="dr",
                        chunk_size=300)
    assert [e["to_mesh"] for e in res.report["recovery"]] == [None]
    assert res.report["final_strategy"] == "local"
    assert seen == [(torch.device(CPU), True)] * 2
    mono = pb(pts, dom, device=CPU).numpy().astype(np.float64)
    assert np.allclose(res.grid, mono, rtol=1e-4, atol=1e-6)
    faults.configure("stkde.chunk:oom:1.0", seed=0)
    with pytest.raises(RetriesExhaustedError):
        stkde_chunked(pts, dom, mesh=_mesh((2, 1)), strategy="dr",
                      chunk_size=300)


def test_execute_chunk_asks_for_fixed_order_adds(monkeypatch):
    """Every shard's scatter of a chunk is the fixed-order one (what keeps a
    resumed run bit-identical on the card, where ``index_add_`` adds with
    atomics); a single query keeps the atomics."""
    seen = []
    real = sd._pb_impl

    def spy(*args, **kw):
        seen.append(kw.get("deterministic"))
        return real(*args, **kw)

    monkeypatch.setattr(sd, "_pb_impl", spy)
    dom, pts = _case("journal")
    stkde_chunked(pts, dom, mesh=_host(), strategy="pd", chunk_size=300)
    assert seen == [True] * 16
    seen.clear()
    stkde(pts, dom, mesh=_host(), strategy="pd")
    assert seen == [False] * 8


@pytest.mark.parametrize("strategy", ["dd", "pd", "pd_xt", "pd_xyt",
                                      "hybrid"])
def test_shards_walk_only_their_buckets_used_prefix(monkeypatch, strategy):
    """Each shard's scatter gets the valid points of its bucket and no
    padding: the home-bucketed strategies hand over every point exactly
    once, DD each overlap copy."""
    seen = []
    real = sd._pb_impl

    def spy(points, *args, **kw):
        seen.append(int(points.shape[0]))
        return real(points, *args, **kw)

    monkeypatch.setattr(sd, "_pb_impl", spy)
    dom, pts = _case("pad")
    mesh = (_host(multi_pod=True) if strategy in ("hybrid", "pd_xyt")
            else _host())
    got = STRATEGIES[strategy](pts, dom, mesh)
    assert len(seen) == mesh.size
    if strategy == "dd":
        b = sd.bucketing.bucket_points_overlap(pts, dom, (12, 17, dom.Gt))
        assert sorted(seen) == sorted(b.counts.reshape(-1).tolist())
    else:
        assert sum(seen) == len(pts)
    assert np.abs(got.numpy() - pb(pts, dom, device=CPU).numpy()).max() \
        < PB_ATOL
