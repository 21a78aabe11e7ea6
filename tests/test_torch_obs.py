"""PyTorch port, observability: ``repro_torch.obs`` against the JAX
package's ``repro.obs``.

* Convergence profiles: ``Engine.fit`` with ``profile="convergence"`` and
  ``"full"`` gives the reference's per-sub-sweep arrays exactly (tile
  fused, tile unfused and segment, split none / lp / lpp), the labels
  and iteration counts of the unprofiled fit, and the figure-1 curves
  the reference pins; ``fit_many`` members give the reference's batched
  curves and their solo curves.
* Registry and export: the same operations on both registries give equal
  snapshots and equal Prometheus text; the tracer nests and exports;
  the engine and the micro-batcher write their scopes and spans.
* Threads and servers: every wait is bounded, every server closed in
  ``finally``.

Graphs are small and carry integer weights, so every count is exact.  The
port runs with ``device="cpu"``.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()
WAIT = 60.0   # seconds: the bound of every wait on a thread or a server

GRAPHS = {
    "er": lambda: jgen.erdos_renyi(120, 5.0, seed=7),
    "karate": lambda: jgen.karate_club()[0],
    "figure1": lambda: jgen.figure1_graph()[0],
}
BACKENDS = [("segment", "auto"), ("tile", "off"), ("tile", "on")]


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def port_engine(**cfg):
    return Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache())


def assert_same_phase(want, got, ctx):
    assert (want is None) == (got is None), ctx
    if want is None:
        return
    assert want.phase == got.phase, ctx
    for f in ("sweep", "active", "changed"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), (ctx, f)
        assert getattr(want, f).dtype == getattr(got, f).dtype, (ctx, f)
    assert want.truncated == got.truncated, ctx


def assert_same_profile(want, got, ctx):
    assert want.n == got.n, ctx
    assert_same_phase(want.propagation, got.propagation, ctx)
    assert_same_phase(want.split, got.split, ctx)


# --- convergence profiles against the reference --------------------------

@pytest.mark.parametrize("mode", ["convergence", "full"])
@pytest.mark.parametrize("split", ["none", "lp", "lpp"])
@pytest.mark.parametrize("backend,fuse", BACKENDS)
def test_profile_matches_reference(backend, fuse, split, mode):
    for name, make in GRAPHS.items():
        g = make()
        ctx = (name, backend, fuse, split, mode)
        want = JEngine(JConfig(split=split, fuse_sweeps=fuse, profile=mode),
                       cache=JAX_CACHE).fit(g, backend=backend)
        got = port_engine(split=split, fuse_sweeps=fuse,
                          profile=mode).fit(port_of(g), backend=backend)
        base = port_engine(split=split, fuse_sweeps=fuse).fit(
            port_of(g), backend=backend)
        assert base.profile is None
        assert np.array_equal(got.labels, base.labels), ctx
        assert (got.lpa_iterations, got.split_iterations) \
            == (base.lpa_iterations, base.split_iterations), ctx
        assert np.array_equal(got.labels, want.labels), ctx
        assert isinstance(got.profile, obs.ConvergenceProfile), ctx
        assert_same_profile(want.profile, got.profile, ctx)
        prop = got.profile.propagation
        assert prop.num_sub_sweeps == 2 * got.lpa_iterations, ctx
        assert (prop.changed <= prop.active).all(), ctx
        has_split = mode == "full" and split != "none"
        assert (got.profile.split is not None) == has_split, ctx
        if has_split:
            assert got.profile.split.num_sub_sweeps \
                == got.split_iterations, ctx


@pytest.mark.parametrize("split", ["lp", "lpp"])
def test_profile_split_active_column_across_fusion(split):
    """Fusion keeps the propagation curve and the split's changed column;
    the split's active column is the worklist unfused, the wake source
    fused."""
    g = port_of(jgen.erdos_renyi(120, 5.0, seed=7))
    fused, unfused = (port_engine(backend="tile", split=split,
                                  fuse_sweeps=f, profile="full").fit(g)
                      for f in ("on", "off"))
    assert_same_phase(fused.profile.propagation,
                      unfused.profile.propagation, split)
    assert np.array_equal(fused.profile.split.changed,
                          unfused.profile.split.changed)
    assert fused.profile.split.active[0] == unfused.profile.split.active[0] \
        == g.n
    seg = port_engine(backend="segment", split=split,
                      profile="full").fit(g)
    assert_same_phase(seg.profile.propagation,
                      unfused.profile.propagation, split)
    assert_same_phase(seg.profile.split, unfused.profile.split, split)


@pytest.mark.parametrize("backend,fuse", BACKENDS)
def test_profile_figure1_values(backend, fuse):
    g = port_of(jgen.figure1_graph()[0])
    r = port_engine(backend=backend, fuse_sweeps=fuse, split="lp",
                    profile="full").fit(g)
    p = r.profile
    assert p.n == g.n == 10
    assert p.propagation.sweep.tolist() == [0, 1, 2, 3, 4, 5]
    assert p.propagation.active.tolist() == [6, 4, 6, 3, 3, 0]
    assert p.propagation.changed.tolist() == [6, 3, 2, 0, 0, 0]
    assert not p.propagation.truncated
    assert p.frontier_decay().tolist() == pytest.approx(
        [0.6, 0.4, 0.6, 0.3, 0.3, 0.0])
    assert p.split.num_sub_sweeps == r.split_iterations == 2
    assert p.split.changed.tolist()[-1] == 0
    assert not p.split.truncated
    d = p.to_dict()
    assert d["propagation"]["active"] == [6, 4, 6, 3, 3, 0]
    json.dumps(d)


@pytest.mark.parametrize("backend,fuse", BACKENDS)
@pytest.mark.parametrize("split", ["lp", "lpp"])
def test_profile_batched_matches_reference(backend, fuse, split):
    graphs = [jgen.erdos_renyi(100, 4.0, seed=1), jgen.karate_club()[0],
              jgen.erdos_renyi(100, 4.0, seed=2), jgen.figure1_graph()[0]]
    cfg = dict(split=split, fuse_sweeps=fuse)
    want = JEngine(JConfig(profile="full", **cfg), cache=JAX_CACHE) \
        .fit_many(graphs, backend=backend)
    ports = [port_of(g) for g in graphs]
    base = port_engine(**cfg).fit_many(ports, backend=backend)
    got = port_engine(profile="full", **cfg).fit_many(ports, backend=backend)
    solo = [port_engine(profile="full", **cfg).fit(g, backend=backend)
            for g in ports]
    for i, (w, b, r, s) in enumerate(zip(want, base, got, solo)):
        ctx = (backend, fuse, split, i)
        assert np.array_equal(r.labels, b.labels), ctx
        assert (r.lpa_iterations, r.split_iterations) \
            == (b.lpa_iterations, b.split_iterations), ctx
        assert_same_profile(w.profile, r.profile, ctx)
        # a member's curves are its solo curves, the split's too
        assert_same_profile(s.profile, r.profile, ctx)
        assert r.profile.n == ports[i].n


def test_profile_split_truncation_flags_the_last_row():
    """A split longer than its buffer overwrites the last row and is
    flagged, as the reference does."""
    g = jgen.erdos_renyi(120, 5.0, seed=7)
    want = JEngine(JConfig(split="lp", max_iterations=1, profile="full"),
                   cache=JAX_CACHE).fit(g, backend="segment")
    for backend, fuse in BACKENDS:
        got = port_engine(split="lp", max_iterations=1, fuse_sweeps=fuse,
                          profile="full").fit(port_of(g), backend=backend)
        assert got.split_iterations > 2
        assert got.profile.split.truncated
        assert got.profile.split.num_sub_sweeps == 2
        if backend == "segment":
            assert_same_profile(want.profile, got.profile, backend)


@pytest.mark.parametrize("backend,fuse", BACKENDS)
def test_profile_batched_truncation_copies_reference(backend, fuse):
    """A batched member whose split outruns the buffer: its last row is
    overwritten by the batch's later sweeps, as in the reference, so
    under lpp it holds a later sweep's active count (0), not the member's
    own last sweep's as its solo fit does (ROADMAP Queue C)."""
    graphs = [jgen.erdos_renyi(120, 5.0, seed=7),
              jgen.grid2d(30)]
    cfg = dict(split="lpp", max_iterations=1, profile="full",
               fuse_sweeps=fuse)
    want = JEngine(JConfig(**cfg), cache=JAX_CACHE).fit_many(
        graphs, backend=backend)
    ports = [port_of(g) for g in graphs]
    got = port_engine(**cfg).fit_many(ports, backend=backend)
    solo = port_engine(**cfg).fit(ports[0], backend=backend)
    for w, r in zip(want, got):
        assert_same_profile(w.profile, r.profile, (backend, fuse))
        assert r.profile.split.truncated
    assert got[0].split_iterations < got[1].split_iterations
    assert got[0].profile.split.active[-1] == 0 \
        < solo.profile.split.active[-1]
    assert np.array_equal(got[0].profile.split.changed,
                          solo.profile.split.changed)


def test_profile_off_attaches_nothing_and_joins_the_plan_key():
    g = port_of(jgen.karate_club()[0])
    eng = port_engine()
    assert eng.fit(g).profile is None
    assert eng.fit_many([g])[0].profile is None
    assert EngineConfig(device="cpu", profile="off").algo_key() \
        != EngineConfig(device="cpu", profile="convergence").algo_key()
    cache = PlanCache()
    Engine(EngineConfig(device="cpu"), cache=cache).fit(g)
    Engine(EngineConfig(device="cpu", profile="full"), cache=cache).fit(g)
    assert cache.stats()["plans"] == 2


def test_profile_buffers_and_rows():
    buf = obs.empty_profile_buffer(4)
    assert buf.dtype == torch.int32 and buf.shape == (4, 3)
    assert (buf == -1).all()
    bb = obs.empty_batch_profile_buffer(3, 5, device="cpu")
    assert bb.shape == (3, 2, 5) and (bb == -1).all()
    from repro_torch.obs.convergence import record_row
    record_row(buf, 1, torch.tensor(7), torch.tensor(2), 1)
    assert buf[1].tolist() == [7, 2, 1]
    record_row(bb, 0, torch.arange(5), torch.ones(5, dtype=torch.int64), 0)
    assert bb[0].tolist() == [[0, 1, 2, 3, 4], [1] * 5]
    ph = obs.phase_from_buffer("propagation", buf, 2)
    assert ph.sweep.tolist() == [-1, 1] and ph.active.dtype == np.int64
    rows = [(0, 10, 4), (1, 6, 1), (2, 2, 0)]
    for mod in (obs, jobs):
        p = mod.phase_from_rows("propagation", rows)
        assert p.sweep.tolist() == [0, 1, 2]
        assert p.active.tolist() == [10, 6, 2]
        assert p.changed.tolist() == [4, 1, 0]
        assert mod.phase_from_rows("split", []).num_sub_sweeps == 0


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1000, 4096])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_count_true_is_exact(n, p):
    from repro_torch.obs.convergence import count_true
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < p)
    for m in (mask, mask[1:], mask[8:], mask[::2]):
        got = count_true(m)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == int(m.sum()) == int(m.numpy().sum())


def test_profile_config_validation():
    for mode in ("off", "convergence", "full"):
        assert EngineConfig(device="cpu", profile=mode).profile == mode
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", profile="everything")


# --- registry and export against the reference ---------------------------

def _drive(mod):
    """The same operations on a registry of ``mod`` (no spans: span ids
    are process counters of each package)."""
    reg = mod.MetricsRegistry()
    reg.counter("svc.requests").inc(3)
    reg.gauge("svc.depth").set(5)
    reg.gauge("svc.depth").add(-2)
    reg.gauge("svc.quality.modularity").set(0.4125)
    h = reg.histogram("svc.lat_ms", (1, 10, 100))
    for v in (0.5, 7.0, 7.0, 55.0, 5000.0):
        h.observe(v)
    s1, s2 = reg.scope("engine"), reg.scope("engine")
    s1.counter("fits").inc()
    s2.counter("fits").inc(2)
    s2.scope("quality").histogram("churn", (0.01, 0.1)).observe(0.05)
    capped = mod.CappedCounterSet(s1, "tenant", max_labels=2)
    for key in ("a", "b", "c.d", "a"):
        capped.inc(key)
    gone = reg.scope("gone")
    gone.counter("x").inc()
    gone.release()
    return reg


def test_registry_snapshot_and_text_equal_reference():
    want, got = _drive(jobs), _drive(obs)
    assert got.snapshot() == want.snapshot()
    assert got.render_text() == want.render_text()
    assert obs.prometheus_text(got) == jobs.prometheus_text(want)
    assert obs.parse_prometheus_text(obs.prometheus_text(got)) \
        == jobs.parse_prometheus_text(jobs.prometheus_text(want))
    assert "engine#1.quality.churn" in got.snapshot()
    assert got.scope("gone").label == "gone"
    got.reset()
    assert got.snapshot() == {}


def test_registry_type_conflict_and_scope_release():
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    s1 = reg.scope("svc")
    assert s1.scope("inner").label == "svc.inner"
    s1.release()
    s1.release()
    s2 = reg.scope("svc")
    assert s2.label == "svc" and s2.scope("inner").label == "svc.inner"
    with pytest.raises(ValueError):
        obs.CappedCounterSet(s2, "t", max_labels=0)


def test_histogram_exemplars_and_prometheus_round_trip():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat", (10, 100))
    h.observe(5)
    assert h.exemplars() == [None, None, None]
    with obs.TRACER.span("req") as s:
        h.observe(50)
        h.observe(500)
    assert h.exemplars() == [None, (50.0, s.span_id), (500.0, s.span_id)]
    text = obs.prometheus_text(reg)
    assert text.endswith("# EOF\n")
    buckets = obs.parse_prometheus_text(text)["repro_lat_bucket"]
    assert [b["labels"]["le"] for b in buckets] == ["10", "100", "+Inf"]
    assert [b["value"] for b in buckets] == [1.0, 2.0, 3.0]
    assert buckets[1]["exemplar"]["labels"]["span_id"] == str(s.span_id)
    # the reference's strict parser takes the port's text, exemplars too
    assert jobs.parse_prometheus_text(text)["repro_lat_count"][0][
        "value"] == 3.0


@pytest.mark.parametrize("text,match", [
    ("repro_x_total 1\n", "EOF"),
    ("not a metric line!\n# EOF\n", "malformed sample"),
    ("# EOF\nrepro_x_total 1\n", "after # EOF"),
    ("# FREeform chatter\n# EOF\n", "malformed comment"),
    ('repro_x{le=1} 1\n# EOF\n', "malformed label")])
def test_prometheus_parser_is_strict(text, match):
    with pytest.raises(ValueError, match=match):
        obs.parse_prometheus_text(text)


def test_registry_threaded_stress():
    reg = obs.MetricsRegistry()
    c = reg.counter("hot")
    h = reg.histogram("lat", (1, 10))
    labels = []
    lock = threading.Lock()

    def work(i):
        for _ in range(500):
            c.inc()
            h.observe(i)
            reg.snapshot() if _ % 100 == 0 else None
        s = reg.scope("worker")
        s.counter("n").inc()
        with lock:
            labels.append(s)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert c.value == 8 * 500 and h.count == 8 * 500
    assert len({s.label for s in labels}) == 8
    for s in labels:
        s.release()
    assert not [k for k in reg.snapshot() if k.startswith("worker")]


def test_tracer_nests_and_exports_chrome(tmp_path):
    tr = obs.Tracer()
    with tr.span("outer", k=1) as outer:
        with tr.span("inner") as inner:
            assert tr.current() is inner
        outer.set(result="done")
    assert tr.current() is None
    by_name = {s.name: s for s in tr.spans()}
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["outer"].attrs == {"k": 1, "result": "done"}
    assert by_name["outer"].dur >= by_name["inner"].dur >= 0
    n = tr.export_chrome(tmp_path / "trace.json")
    events = json.loads((tmp_path / "trace.json").read_text())
    assert n == len(events) == 2
    for ev in events:
        assert set(ev) == {"name", "ph", "pid", "tid", "ts", "dur", "args"}
        assert ev["ph"] == "X" and ev["ts"] >= 0 and ev["dur"] >= 0
    off = obs.Tracer(enabled=False)
    with off.span("x") as s:
        s.set(ignored=True)
    assert off.spans() == []


def test_engine_scope_spans_and_stats_keys():
    g = port_of(jgen.karate_club()[0])
    eng = port_engine(warm_start="auto", split="bfs_host")
    label = eng._obs.label
    before = set(eng.stats())
    obs.TRACER.reset()
    eng.fit(g)
    eng.fit(g)
    eng.fit_many([g, g])
    assert set(eng.stats()) == before
    names = {s.name for s in obs.TRACER.spans("engine.")}
    assert {"engine.fit", "engine.prepare", "engine.dispatch",
            "engine.split_host", "engine.compact",
            "engine.fit_many"} <= names
    snap = obs.REGISTRY.snapshot()
    assert snap[f"{label}.fits"] == 4 and snap[f"{label}.batch_fits"] == 1
    st = eng.stats()
    # the warm cache writes through: one miss, then three hits
    assert (snap[f"{label}.warm_misses"], snap[f"{label}.warm_hits"]) \
        == (st["warm_misses"], st["warm_hits"]) == (1, 3)
    assert snap[f"{label}.warm_entries"] == st["warm_entries"] == 1
    fit = obs.TRACER.spans("engine.fit")[0]
    kids = [s for s in obs.TRACER.spans() if s.parent_id == fit.span_id]
    assert {s.name for s in kids} >= {"engine.prepare", "engine.dispatch"}


def test_microbatcher_scope_spans_and_release():
    from repro_torch.launch.microbatch import MicroBatcher
    g = port_of(jgen.karate_club()[0])
    mb = MicroBatcher(port_engine(), max_batch=4, autostart=False)
    label = mb._obs.label
    try:
        obs.TRACER.reset()
        subs = [mb.submit(g) for _ in range(3)]
        mb.start()
        [s.result(timeout=WAIT) for s in subs]
        st = mb.stats()
        assert set(st) == {"requests", "batches", "batch_size_hist",
                           "mean_batch", "p50_ms", "p95_ms", "mean_ms"}
        snap = obs.REGISTRY.snapshot()
        assert snap[f"{label}.requests"] == st["requests"] == 3
        assert snap[f"{label}.batches"] == st["batches"] == 1
        assert snap[f"{label}.latency_ms"]["count"] == 3
        assert snap[f"{label}.batch_size"]["count"] == 1
        names = {s.name for s in obs.TRACER.spans("batch.")}
        assert names == {"batch.dispatch", "batch.settle"}
    finally:
        mb.close(timeout=WAIT)
    assert not mb._thread.is_alive()
    assert f"{label}.requests" not in obs.REGISTRY.snapshot()


def test_metrics_server_routes():
    reg = obs.MetricsRegistry()
    reg.counter("hits").inc(2)
    srv = obs.MetricsServer(reg, port=0, health_fn=lambda: {"tenants": 3})
    try:
        srv.start()
        assert srv.host == "127.0.0.1" and srv.port > 0

        def get(path):
            with urllib.request.urlopen(srv.url + path, timeout=WAIT) as r:
                return r.headers.get("Content-Type"), r.read().decode()

        ctype, text = get("/metrics")
        assert ctype.startswith("text/plain")
        assert obs.parse_prometheus_text(text)["repro_hits_total"][0][
            "value"] == 2.0
        assert json.loads(get("/metrics.json")[1])["hits"] == 2
        assert json.loads(get("/healthz")[1]) == {"ok": True, "tenants": 3}
        reg.counter("hits").inc()
        assert obs.parse_prometheus_text(get("/metrics")[1])[
            "repro_hits_total"][0]["value"] == 3.0
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        srv.close()
    assert not srv._thread.is_alive()


def test_jsonl_sink_appends_snapshots(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("n").inc()
    path = tmp_path / "metrics.jsonl"
    with obs.JsonlSink(str(path)) as sink:
        sink.emit(reg, tag="a")
        reg.counter("n").inc()
        sink.emit(reg, tag="b")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["tag"] for x in lines] == ["a", "b"]
    assert [x["metrics"]["n"] for x in lines] == [1, 2]


# --- the CLI ---------------------------------------------------------------

def test_obs_cli_fit_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.obs import main
    trace, out = tmp_path / "trace.json", tmp_path / "obs.json"
    assert main(["--device", "cpu", "--n", "150", "--trace", str(trace),
                 "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "propagation curve" in text and "split curve" in text
    assert "device=cpu" in text
    payload = json.loads(out.read_text())
    prop = payload["profile"]["propagation"]
    assert prop["sweep"] == list(range(len(prop["sweep"])))
    events = json.loads(trace.read_text())
    assert {"engine.fit", "engine.dispatch"} <= {e["name"] for e in events}


def test_obs_cli_audit_names_its_roadmap_item(capsys):
    """``--workload audit`` runs the port's audit workload (A14's CLI
    hook): the coverage line and dict the reference's CLI prints."""
    from repro.launch.obs import main as jmain
    from repro_torch.launch.obs import main

    def coverage_line(run):
        assert run() == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[obs] audit workload coverage:")]
        assert len(lines) == 1
        return lines[0]

    want = coverage_line(lambda: jmain(["--workload", "audit"]))
    assert coverage_line(lambda: main(["--workload", "audit", "--device",
                                       "cpu"])) == want
    assert want == "[obs] audit workload coverage: fits=25 ooc=True " \
        "sharded=True"


def test_obs_top_renders_frames_and_polls_a_server():
    from repro_torch.launch.obs import render_top, run_top
    reg = obs.MetricsRegistry()
    reg.counter("svc.requests").inc(7)
    reg.histogram("svc.lat_ms", (1, 10)).observe(3.0)
    frame = render_top(reg.snapshot(), limit=1)
    assert "metric" in frame and "... 1 more metrics" in frame
    outputs = []
    assert run_top(every_s=0.0, iterations=2, registry=reg,
                   out=outputs.append) == 2
    assert "[obs top] frame 2" in "\n".join(outputs)
    srv = obs.MetricsServer(reg, port=0)
    try:
        srv.start()
        outputs = []
        assert run_top(endpoint=srv.url, every_s=0.0, iterations=1,
                       out=outputs.append) == 1
        assert any("svc.requests" in line for line in outputs)
    finally:
        srv.close()
