"""PyTorch port, ingestion: ``repro_torch.io`` (parsers, preprocessing, the
CSR store, the dataset registry), ``Engine.fit(path)`` and the ingest CLI,
against the JAX package's ``repro.io``.

* parsed edge lists and preprocessing outputs equal the reference's;
* a loaded graph equals the reference's ``build_graph`` of the same edges,
  arrays byte for byte and fingerprint;
* a store entry written by either package loads in the other with the same
  arrays and fingerprint (one on-disk layout, one key);
* a store hit shares the entry's pages (no copy) and re-attaches the saved
  fingerprint;
* ``Engine.fit(path)`` equals the JAX engine's fit of the same file.

Every test points ``REPRO_GRAPH_CACHE`` at its own ``tmp_path``, and
``fetch`` is tested over ``file://`` URLs only.  The port runs with
``device="cpu"``.
"""
import gzip
import hashlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import io as jio  # noqa: E402
from repro.io.preprocess import (  # noqa: E402
    largest_component_mask as j_largest_component_mask,
)
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.core.graph import graph_fingerprint as jfp  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch import io as tio  # noqa: E402
from repro_torch.core.graph import graph_fingerprint  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.io import (  # noqa: E402
    CsrStore,
    EdgeList,
    FormatError,
    PreprocessOptions,
    datasets,
    file_content_hash,
    load_graph,
    parse_edge_file,
    parse_mtx,
    parse_snap,
    preprocess,
    sniff_format,
    write_mtx,
    write_snap,
)
from repro_torch.io.preprocess import (  # noqa: E402
    connected_components,
    largest_component_mask,
)
from repro_torch.launch import ingest  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures"
FIXTURE_FILES = ("toy_general.mtx", "toy_symmetric.mtx", "toy.snap.txt",
                 "messy.snap.txt", "toy.snap.txt.gz")
TOY_EDGES = np.array([[0, 1], [0, 2], [1, 2], [2, 3], [3, 4], [0, 4]])
TOY_WEIGHTS = np.array([1.5, 2.0, 1.0, 0.5, 2.25, 1.0])
TRI_EDGES = np.array([[0, 1], [1, 2], [0, 2], [3, 4], [4, 5], [3, 5],
                      [0, 3]])
FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()


@pytest.fixture(autouse=True)
def graph_store(tmp_path, monkeypatch):
    """Every store this test touches lives under its tmp_path."""
    store = tmp_path / "store"
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(store))
    return store


def assert_same_graph(want, got, ctx=""):
    """``want``: a JAX-package graph; ``got``: a port graph."""
    assert (want.n, want.m_pad, want.num_edges) \
        == (got.n, got.m_pad, got.num_edges), ctx
    for f in FIELDS:
        x, y = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f)
    assert graph_fingerprint(got) == jfp(want), ctx


def assert_same_edgelist(want, got):
    assert want.n == got.n and want.meta == got.meta
    assert want.edges.dtype == got.edges.dtype
    assert np.array_equal(want.edges, got.edges)
    if want.weights is None:
        assert got.weights is None
    else:
        assert np.array_equal(want.weights, got.weights)


def mapped_ranges(path: Path) -> list[tuple[int, int]]:
    """Address ranges of this process's mappings of ``path``."""
    out = []
    with open("/proc/self/maps") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 6 and parts[5] == str(path):
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                out.append((lo, hi))
    return out


# --- parsers and preprocessing against the reference ---------------------

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_parse_fixture_matches_reference(name):
    assert sniff_format(FIXTURES / name) == jio.sniff_format(FIXTURES / name)
    assert_same_edgelist(jio.parse_edge_file(FIXTURES / name),
                         parse_edge_file(FIXTURES / name))
    assert_same_edgelist(jio.parse_edge_file(FIXTURES / name, block_bytes=16),
                         parse_edge_file(FIXTURES / name, block_bytes=16))


def test_parse_toy_contents():
    el = parse_mtx(FIXTURES / "toy_general.mtx")
    assert el.n == 5 and np.array_equal(el.edges, TOY_EDGES)
    assert np.array_equal(el.weights, TOY_WEIGHTS)
    el = parse_mtx(FIXTURES / "toy_symmetric.mtx")
    assert el.meta["mirrored_entries"] == 7 and el.num_edges == 14
    assert {tuple(sorted(e)) for e in el.edges.tolist()} \
        == {tuple(e) for e in TRI_EDGES.tolist()}
    el = parse_snap(FIXTURES / "toy.snap.txt")
    assert el.meta["comment_lines"] == 3 and el.weights is None
    with pytest.raises(FormatError):
        parse_edge_file(FIXTURES / "toy.snap.txt", fmt="snap",
                        one_based=True)


def test_parse_rejects_malformed(tmp_path):
    cases = {
        "bad.mtx": "%%MatrixMarket matrix array real general\n2 2\n1\n",
        "rect.mtx": "%%MatrixMarket matrix coordinate real general\n"
                    "3 1000 1\n1 500 1.0\n",
        "trunc.mtx": "%%MatrixMarket matrix coordinate pattern general\n"
                     "3 3 5\n1 2\n2 3\n",
        "skew.mtx": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                    "3 3 1\n2 1 1.0\n",
    }
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        with pytest.raises(FormatError):
            parse_mtx(tmp_path / name)
        with pytest.raises(jio.FormatError):
            jio.parse_mtx(tmp_path / name)


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("fmt,symmetric", [("mtx", False), ("mtx", True),
                                           ("snap", False)])
@pytest.mark.parametrize("weighted", (False, True))
def test_roundtrip_matches_reference(tmp_path, seed, fmt, symmetric,
                                     weighted):
    """Random unique edges: written by the port, parsed, cleaned and built
    by the port, they give the reference's build of the same edges; the
    reference's parse of the same file equals the port's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    e = rng.integers(0, n, size=(int(rng.integers(1, 120)), 2))
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    if not len(e):
        e = np.array([[0, 1]])
    w = rng.uniform(1e-3, 1e3, size=len(e)) if weighted else None
    path = tmp_path / ("g.mtx" if fmt == "mtx" else "g.snap.txt")
    if fmt == "mtx":
        write_mtx(path, e, w, n=n, symmetric=symmetric)
    else:
        write_snap(path, e, w)
    kw = {} if fmt == "mtx" else {"n": n}
    parsed = parse_edge_file(path, **kw)
    assert_same_edgelist(jio.parse_edge_file(path, **kw), parsed)
    opts = PreprocessOptions(unit_weights=not weighted)
    cleaned, stats = preprocess(parsed, opts)
    assert stats.edges == len(e)
    from repro_torch.core.graph import build_graph
    got = build_graph(cleaned.edges, cleaned.weights, n=cleaned.n)
    assert_same_graph(jbuild(e, w, n=n), got)


@pytest.mark.parametrize("opts", [
    PreprocessOptions(), PreprocessOptions(unit_weights=False),
    PreprocessOptions(dedup=False, drop_self_loops=False),
    PreprocessOptions(largest_component=True),
    PreprocessOptions(compact_ids=True, unit_weights=False)])
def test_preprocess_matches_reference(opts):
    raw = parse_snap(FIXTURES / "messy.snap.txt")
    jraw = jio.parse_snap(FIXTURES / "messy.snap.txt")
    want, wstats = jio.preprocess(
        jraw, jio.PreprocessOptions(**vars(opts)))
    got, stats = preprocess(raw, opts)
    assert stats.as_dict() == wstats.as_dict()
    assert_same_edgelist(want, got)
    rng = np.random.default_rng(4)
    el = EdgeList(edges=rng.integers(0, 300, size=(260, 2)),
                  weights=rng.uniform(0.1, 4.0, size=260), n=300)
    jel = jio.EdgeList(edges=el.edges, weights=el.weights, n=300)
    want, wstats = jio.preprocess(jel, jio.PreprocessOptions(**vars(opts)))
    got, stats = preprocess(el, opts)
    assert stats.as_dict() == wstats.as_dict()
    assert_same_edgelist(want, got)


def test_preprocess_messy_stats():
    cleaned, stats = preprocess(parse_snap(FIXTURES / "messy.snap.txt"),
                                PreprocessOptions(unit_weights=False))
    assert (stats.raw_edges, stats.self_loops, stats.duplicates,
            stats.edges, stats.isolated_vertices) == (7, 1, 2, 4, 1)
    d = {tuple(e): w for e, w in zip(cleaned.edges.tolist(),
                                     cleaned.weights.tolist())}
    assert d[(0, 1)] == 2.5   # the max of the stored weights, not the sum


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_connected_components_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    e = rng.integers(0, n, size=(int(rng.integers(0, 150)), 2))
    comp = connected_components(e, n)
    assert np.array_equal(comp, jio.connected_components(e, n))
    assert np.array_equal(largest_component_mask(e, n),
                          j_largest_component_mask(e, n))


# --- load_graph and the store --------------------------------------------

@pytest.mark.parametrize("name,edges", [("toy_general.mtx", TOY_EDGES),
                                        ("toy.snap.txt", TOY_EDGES),
                                        ("toy.snap.txt.gz", TOY_EDGES),
                                        ("toy_symmetric.mtx", TRI_EDGES)])
def test_load_graph_equals_reference_and_hits(name, edges):
    want = jbuild(edges, n=int(edges.max()) + 1)
    g, rep = load_graph(FIXTURES / name, return_report=True)
    assert not rep.cache_hit and rep.parse_seconds > 0
    assert_same_graph(want, g)
    g2, rep2 = load_graph(FIXTURES / name, return_report=True)
    assert rep2.cache_hit and rep2.parse_seconds == 0.0
    assert rep2.key == rep.key and rep2.stats == rep.stats
    assert_same_graph(want, g2)
    assert g2.device.type == "cpu"


def test_store_hit_shares_the_entry_pages(graph_store):
    """A store hit wraps the entry's copy-on-write map: every host tensor
    lies inside the mapping of its arrays.bin, and the saved fingerprint
    is attached without a CRC."""
    g0, rep = load_graph(FIXTURES / "toy_general.mtx", return_report=True)
    g = load_graph(FIXTURES / "toy_general.mtx")
    ranges = mapped_ranges(
        (graph_store / rep.key / "arrays.bin").resolve())
    assert ranges
    for f in FIELDS:
        ptr = getattr(g, f).data_ptr()
        assert any(lo <= ptr < hi for lo, hi in ranges), f
    with mock.patch("zlib.crc32",
                    side_effect=AssertionError("fingerprint recomputed")):
        assert graph_fingerprint(g) == graph_fingerprint(g0)
    g.wgt[0] = 99.0          # copy-on-write: the entry's bytes stay
    assert load_graph(FIXTURES / "toy_general.mtx").wgt[0] == 1.0


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_store_entries_are_shared_between_packages(writer, graph_store):
    """One layout and one key: an entry written by either package loads
    in the other with the same arrays and fingerprint, and as a hit."""
    path = FIXTURES / "toy_general.mtx"
    opts = dict(unit_weights=False)
    if writer == "jax":
        want, rep = jio.load_graph(path, jio.PreprocessOptions(**opts),
                                   return_report=True)
        got, rep2 = load_graph(path, PreprocessOptions(**opts),
                               return_report=True)
        assert_same_graph(want, got)
    else:
        got, rep = load_graph(path, PreprocessOptions(**opts),
                              return_report=True)
        want, rep2 = jio.load_graph(path, jio.PreprocessOptions(**opts),
                                    return_report=True)
        assert_same_graph(want, got)
    assert not rep.cache_hit and rep2.cache_hit and rep.key == rep2.key
    assert (graph_store / rep.key / "arrays.bin").read_bytes() \
        == (graph_store / rep2.key / "arrays.bin").read_bytes()
    handle = CsrStore().open(rep.key)
    assert handle.fingerprint == jfp(want)
    assert np.array_equal(handle.window("dst", 2, 5),
                          np.asarray(want.dst)[2:5])


def test_load_graph_options_key_separately():
    unit = load_graph(FIXTURES / "toy_general.mtx")
    weighted, rep = load_graph(FIXTURES / "toy_general.mtx",
                               PreprocessOptions(unit_weights=False),
                               return_report=True)
    assert not rep.cache_hit
    assert_same_graph(jbuild(TOY_EDGES, TOY_WEIGHTS, n=5), weighted)
    assert not torch.equal(unit.wgt, weighted.wgt)
    for kw in (dict(n=50), dict(one_based=True)):
        with pytest.raises(ValueError, match="mtx"):
            load_graph(FIXTURES / "toy_general.mtx", **kw)


def test_load_graph_keys_on_content_force_and_no_cache(tmp_path):
    src = (FIXTURES / "toy_general.mtx").read_text()
    a, b = tmp_path / "a.mtx", tmp_path / "renamed.mtx"
    a.write_text(src)
    b.write_text(src)
    _, rep1 = load_graph(a, return_report=True)
    _, rep2 = load_graph(b, return_report=True)
    assert rep2.cache_hit and rep2.key == rep1.key
    a.write_text(src.replace("1 2 1.5", "1 2 7.5"))
    assert not load_graph(a, return_report=True)[1].cache_hit
    _, rep3 = load_graph(b, force=True, return_report=True)
    assert not rep3.cache_hit and rep3.parse_seconds > 0
    _, rep4 = load_graph(b, cache=False, return_report=True)
    assert rep4.key == "" and not rep4.cache_hit


def test_store_repairs_corrupt_entry():
    _, rep = load_graph(FIXTURES / "toy.snap.txt", return_report=True)
    store = CsrStore()
    assert store.has(rep.key)
    (store.entry_dir(rep.key) / "arrays.bin").write_bytes(b"garbage")
    assert store.load(rep.key) is None and store.open(rep.key) is None
    g = load_graph(FIXTURES / "toy.snap.txt")
    assert_same_graph(jbuild(TOY_EDGES, n=5), g)
    assert load_graph(FIXTURES / "toy.snap.txt",
                      return_report=True)[1].cache_hit
    assert store.evict(rep.key) and not store.has(rep.key)


def test_open_graph_windows_and_to_graph():
    handle = tio.open_graph(FIXTURES / "toy_symmetric.mtx")
    want = jbuild(TRI_EDGES, n=6)
    assert (handle.n, handle.num_edges) == (want.n, want.num_edges)
    assert np.array_equal(handle.array("row_ptr"), np.asarray(want.row_ptr))
    assert_same_graph(want, handle.to_graph())


def test_file_content_hash_streams(tmp_path):
    p = tmp_path / "blob.txt"
    p.write_bytes(b"x" * 1000)
    assert file_content_hash(p) == hashlib.sha256(b"x" * 1000).hexdigest()


# --- the engine on a path ------------------------------------------------

@pytest.mark.parametrize("backend", ("segment", "tile"))
@pytest.mark.parametrize("name", ("toy_symmetric.mtx", "road.mtx"))
def test_engine_fit_path_equals_reference(tmp_path, backend, name):
    if name == "road.mtx":
        from repro_torch.graphgen import grid2d
        from repro_torch.core.delta import undirected_edges
        path = tmp_path / name
        write_mtx(path, undirected_edges(grid2d(20))[0], n=400,
                  symmetric=True)
    else:
        path = FIXTURES / name
    want = JEngine(JConfig(backend=backend), cache=JAX_CACHE).fit(str(path))
    eng = Engine(EngineConfig(device="cpu", backend=backend),
                 cache=PlanCache())
    got = eng.fit(str(path))
    assert np.array_equal(got.labels, want.labels)
    assert (got.lpa_iterations, got.split_iterations,
            got.num_communities) == (want.lpa_iterations,
                                     want.split_iterations,
                                     want.num_communities)
    g = load_graph(path)
    assert got.check_connected(g) == 0.0
    assert np.array_equal(eng.fit_many([path])[0].labels, got.labels)
    with pytest.raises(TypeError):
        eng.fit(42)


def test_warm_start_auto_through_the_stored_fingerprint():
    """A later engine (as a restarted process would) fitting the same file
    warm-starts from labels stored under the entry's fingerprint."""
    path = str(FIXTURES / "toy_symmetric.mtx")
    cfg = EngineConfig(device="cpu", warm_start="auto")
    eng = Engine(cfg, cache=PlanCache())
    first = eng.fit(path)
    assert not first.warm_started
    with mock.patch("zlib.crc32",
                    side_effect=AssertionError("fingerprint recomputed")):
        second = eng.fit(path)
    assert second.warm_started
    want = Engine(EngineConfig(device="cpu"), cache=PlanCache()).fit(
        load_graph(path), init_labels=first.labels)
    assert np.array_equal(second.labels, want.labels)


# --- the dataset registry ------------------------------------------------

@pytest.mark.parametrize("name", ("web_rmat", "road_grid", "kmer_sparse",
                                  "planted"))
def test_registry_builtins_match_reference(name):
    assert set(datasets.names()) >= {"web_rmat", "social_rmat", "road_grid",
                                     "kmer_sparse", "planted"}
    g = datasets.get(name)
    assert datasets.get(name) is g
    assert graph_fingerprint(g) == jfp(jio.datasets.get(name))
    assert datasets.entry(name).description \
        == jio.datasets.entry(name).description


def test_registry_file_entries_and_missing(tmp_path):
    name = "toy_fixture_port_test"
    datasets.unregister(name)
    datasets.register_file(name, FIXTURES / "toy_general.mtx",
                           description="fixture")
    try:
        g, stats = datasets.get_with_stats(name)
        assert_same_graph(jbuild(TOY_EDGES, n=5), g)
        assert stats["raw_edges"] == 6
        with pytest.raises(ValueError):
            datasets.register_file(name, "elsewhere.mtx")
    finally:
        datasets.unregister(name)
    datasets.register_file(name, tmp_path / "nope.mtx")
    try:
        with pytest.raises(FileNotFoundError):
            datasets.get(name)
    finally:
        datasets.unregister(name)
    with pytest.raises(KeyError):
        datasets.get("definitely-not-registered")


def _file_url(path) -> str:
    return Path(path).resolve().as_uri()


def test_fetch_verifies_registers_and_repairs(tmp_path):
    name = "fetch_toy_port_test"
    datasets.unregister(name)
    src = FIXTURES / "toy_general.mtx"
    sha = file_content_hash(src)
    dl = tmp_path / "dl"
    try:
        entry = datasets.fetch(name, _file_url(src), sha, cache_dir=dl)
        dest = Path(entry.path)
        assert entry.kind == "file" and dest.parent == dl
        assert_same_graph(jbuild(TOY_EDGES, n=5), datasets.get(name))
        before = dest.stat().st_mtime_ns
        datasets.fetch(name, _file_url(src), sha, cache_dir=dl,
                       overwrite=True)
        assert dest.stat().st_mtime_ns == before      # not re-fetched
        dest.write_text("truncated garbage")
        datasets.fetch(name, _file_url(src), sha, cache_dir=dl,
                       overwrite=True)
        assert file_content_hash(dest) == sha          # repaired
    finally:
        datasets.unregister(name)


def test_fetch_checksum_mismatch_and_gzip_payload(tmp_path):
    name = "fetch_bad_port_test"
    datasets.unregister(name)
    with pytest.raises(ValueError, match="checksum mismatch"):
        datasets.fetch(name, _file_url(FIXTURES / "toy_general.mtx"),
                       "0" * 64, cache_dir=tmp_path / "dl")
    assert name not in datasets.names()
    assert not [p for p in (tmp_path / "dl").glob("*") if p.is_file()]
    src_gz = tmp_path / "toy.snap.txt.gz"
    src_gz.write_bytes(gzip.compress(
        (FIXTURES / "toy.snap.txt").read_bytes()))
    try:
        datasets.fetch(name, _file_url(src_gz), file_content_hash(src_gz),
                       cache_dir=tmp_path / "dl", cache=False)
        assert_same_graph(jbuild(TOY_EDGES, n=5), datasets.get(name))
    finally:
        datasets.unregister(name)


# --- the ingest CLI ------------------------------------------------------

def test_ingest_cli_in_process(tmp_path, capsys, graph_store):
    path = str(FIXTURES / "toy_symmetric.mtx")
    out = tmp_path / "report.json"
    assert ingest.main([path, "--stats", "--detect", "--device", "cpu",
                        "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "ingested" in text and "[§4.1] raw edges 14 -> 7" in text
    assert "detect[" in text and "disconnected=0.0" in text
    import json
    rep = json.loads(out.read_text())[0]
    want = JEngine(JConfig(), cache=JAX_CACHE).fit(path)
    assert rep["detect"]["communities"] == want.num_communities
    assert rep["detect"]["device"] == "cpu"
    assert ingest.main([path, "--stats"]) == 0
    assert "cache hit" in capsys.readouterr().out
    assert ingest.main(["--list-cache"]) == 0
    assert f"1 cached graphs in {graph_store}" in capsys.readouterr().out
    # A9 is ported: --ooc fits out of core from the store entry
    assert ingest.main([path, "--ooc", "--memory-budget", "1KB",
                        "--backend", "tile", "--device", "cpu",
                        "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "store entry" in text and "ooc[tile]" in text
    rep = json.loads(out.read_text())[0]
    assert rep["ooc"]["partitions"] > 1
    assert rep["ooc"]["communities"] == want.num_communities


def test_ingest_cli_subprocess(tmp_path, graph_store):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "REPRO_GRAPH_CACHE": str(graph_store), "HOME": str(tmp_path)}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ingest",
         str(FIXTURES / "toy.snap.txt"), "--stats", "--detect",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert run.returncode == 0, run.stderr
    assert "ingested" in run.stdout and "detect[" in run.stdout
    assert len(CsrStore(graph_store).entries()) == 1
