"""PyTorch port, static analysis: ``repro_torch.analysis`` (R001–R006)
and ``python -m repro_torch.launch.lint``, against the JAX package's
``repro.analysis``.

* The counterparts of ``tests/test_analysis.py``: rule ids, file:line
  anchors, suppressions (same line, line above, wrong tag, inside a
  string), scoping by rule-relative path, syntax errors as ``E000``, the
  baseline round trip, the CLI's exit codes and ``--strict`` with a
  baseline, the ``--smem-ceiling`` knob, and the repo-clean gate over
  ``src/repro_torch/``.
* Fixtures are torch-flavoured sources in this file, keyed by their
  rule-relative path; each positive fixture triggers exactly one rule
  and marks its expected lines with ``# EXPECT-R00X``.  The CLI tests
  write them under ``tmp_path / "fixtures" / "lint"``.
* Parity with the JAX package on the same inputs: the suppression
  parser, ``Finding.identity``, baseline JSON in both directions, and
  the port's R005 over the reference's own R005 fixtures (read only).
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import Baseline as JBaseline  # noqa: E402
from repro.analysis import Finding as JFinding  # noqa: E402
from repro.analysis import lint_paths as jlint_paths  # noqa: E402
from repro.analysis.rules.base import (  # noqa: E402
    _parse_suppressions as j_parse_suppressions,
)
from repro_torch.analysis import (  # noqa: E402
    Baseline,
    Finding,
    all_rules,
    lint_paths,
    lint_source,
    rule_relpath,
)
from repro_torch.analysis.rules import LedgerRule  # noqa: E402
from repro_torch.analysis.rules.base import _parse_suppressions  # noqa: E402
from repro_torch.launch.lint import main as lint_main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
REF_FIXTURES = Path(__file__).parent / "fixtures" / "lint"
_EXPECT = re.compile(r"#\s*EXPECT-(R\d{3})")

# rule-relative path -> source.  Positive fixtures flag exactly their
# EXPECT lines; *_clean ones flag nothing (suppressed findings included);
# *_suppressed ones flag only suppressed findings.
FIXTURES = {
    "core/r001_host_sync.py": '''\
"""R001 positive: host syncs on device values in a sweep loop."""
import numpy as np
import torch

from repro_torch.kernels import ops


def drive(nbr, nw, nmask, labels, active, threshold):
    it, dn = 0, labels.shape[0]
    while dn > threshold:
        best, best_w, cur_w = ops.label_argmax(nbr, nw, nmask, labels, it)
        new = torch.where(active & (best_w > cur_w), best, labels)
        changed = new != labels
        dn = int(changed.sum())  # EXPECT-R001
        first = changed.nonzero()[0].item()  # EXPECT-R001
        host = np.asarray(new)  # EXPECT-R001
        if changed.any():  # EXPECT-R001
            labels = new
        it += 1
    return labels, host, first


def visits(be, sweeps, parts, labels_loc):
    total = 0
    for inputs in parts:
        new, = to_host(  # EXPECT-R001
            be.partition_move(sweeps, inputs, labels_loc, None, 0, 0), 8)
        total += int((new != 0).sum())
    return total


@torch.compile
def compiled_step(labels, mask):
    return labels + int(mask.sum())  # EXPECT-R001
''',
    "core/r001_clean.py": '''\
"""R001 negative: device-only sweeps, one read after the loop, host
values tested in the loop."""
import numpy as np
import torch

from repro_torch.kernels import ops


def drive(nbr, nw, nmask, labels, active, mask_np, buf=None):
    it = 0
    while it < 20 and labels.shape[0] > 4:
        best, best_w, cur_w = ops.label_argmax(nbr, nw, nmask, labels, it)
        new = torch.where(active & (best_w > cur_w), best, labels)
        if buf is not None:
            buf[it] = (new != labels).sum()
        labels = new
        it += 1 + int(np.sum(mask_np))
    return labels.cpu().numpy(), it
''',
    "core/r001_suppressed.py": '''\
"""R001 suppression: the hazard is real but justified inline."""


def drive(plan, graph, labels, active):
    while True:
        labels, active, dn = plan.step(graph, labels, active)
        # lint: host-sync-ok — fixture: justified convergence readback
        if int(dn) == 0:
            break
    return labels
''',
    "engine/r002_retrace.py": '''\
"""R002 positive: ad-hoc executables in glue code, a stringified key."""
import ctypes

import torch

from repro_torch.kernels import build


def fast_path(fn):
    return torch.compile(fn)  # EXPECT-R002


@torch.compile  # EXPECT-R002
def step(x):
    return x + 1


def load(path):
    lib = build.load_library()  # EXPECT-R002
    return lib, ctypes.CDLL(path)  # EXPECT-R002


def lookup(cache, backend, bucket, be, cfg):
    key = f"{backend}-{bucket}"
    return cache.get_or_build(key, lambda: be.build(bucket, cfg))  # EXPECT-R002
''',
    "engine/r002_clean.py": '''\
"""R002 negative: a structured plan-cache key (a device included)."""


def lookup(cache, name, bucket, cfg, be, device):
    key = (name, bucket, cfg.bucketing, cfg.algo_key(), be.plan_key(cfg),
           device)
    return cache.get_or_build(key, lambda: be.build(bucket, cfg, device))
''',
    "engine/backends/r003_protocol.py": '''\
"""R003 positive: a backend that drifts from the port's surface."""


@register_backend("drifty")
class DriftyBackend:  # EXPECT-R003
    name = "drifty"
    supports_partition = True

    def plan_key(self, config):
        return ()

    def build(self, bucket, config):  # EXPECT-R003
        return None

    def prepare(self, graph, bucket, config):
        return graph

    def run(self, plan, inputs, n_real, init_labels, init_active=None):
        return None

    def build_partition(self, config, device):
        return None

    def partition_caps(self, budget, d_bucket):
        return 1, 1

    def partition_prepare_nbytes(self, shapes):
        return 0

    def prepare_partition(self, resident, shapes, config, device):
        return None, 0

    def partition_move(self, sweeps, g, labels_loc, cand_owned, seed,  # EXPECT-R003
                       bound):
        return None

    def partition_wake(self, sweeps, inputs, changed_loc):
        return None

    def partition_split(self, sweeps, inputs, comm_loc, labels_loc,
                        active_owned, bound):
        return None

    def partition_split_wake(self, sweeps, inputs, comm_loc, changed_loc):
        return None

    def partition_move_fused(self, sweeps, inputs, labels_loc, changed_loc,
                             active_owned, cand_prev_owned, klass_owned,
                             seed, bound):
        return None, None
''',
    "engine/backends/r003_clean.py": '''\
"""R003 negative: the port's whole surface, solo, batched, partition."""


@register_backend("tidy")
class TidyBackend:
    name = "tidy"
    supports_batch = True
    supports_partition = True

    def plan_key(self, config): ...
    def build(self, bucket, config, device): ...
    def prepare(self, graph, bucket, config): ...
    def run(self, plan, inputs, n_real, init_labels, init_active=None): ...
    def build_batch(self, bucket, config, device): ...
    def prepare_batch(self, batch, bucket, config): ...
    def run_batch(self, plan, inputs, init_labels=None,
                  init_active=None): ...
    def build_partition(self, config, device): ...
    def partition_caps(self, budget, d_bucket): ...
    def partition_prepare_nbytes(self, shapes): ...
    def prepare_partition(self, resident, shapes, config, device): ...
    def partition_move(self, sweeps, inputs, labels_loc, cand_owned, seed,
                       bound): ...
    def partition_wake(self, sweeps, inputs, changed_loc): ...
    def partition_split(self, sweeps, inputs, comm_loc, labels_loc,
                        active_owned, bound): ...
    def partition_split_wake(self, sweeps, inputs, comm_loc,
                             changed_loc): ...
    def partition_move_fused(self, sweeps, inputs, labels_loc, changed_loc,
                             active_owned, cand_prev_owned, klass_owned,
                             seed, bound): ...
    def partition_split_fused(self, sweeps, inputs, comm_loc, labels_loc,
                              changed_loc, bound): ...


@register_backend("solo")
class SoloBackend:
    name = "solo"
    supports_batch = False

    def plan_key(self, config): ...
    def build(self, bucket, config, device): ...
    def prepare(self, graph, bucket, config): ...
    def run(self, plan, inputs, n_real, init_labels, init_active=None): ...
''',
    "kernels/r004_pallas.py": '''\
"""R004 positive: an unguarded launch, a host op in a launching wrapper,
a width bound whose rows overflow shared memory, an unbudgeted cube."""
MAX_DEGREE = 1 << 15


def _launch(name, dev, *args):
    return None


def _tiles(nbr):
    rows, d = nbr.shape
    if d > MAX_DEGREE:
        raise ValueError("row too wide")
    return rows, d


def unguarded(nbr, out):
    _launch("k", nbr.device, nbr.data_ptr(), out.data_ptr())  # EXPECT-R004


def chatty(nbr, out):
    rows, d = _tiles(nbr)
    print(rows)  # EXPECT-R004
    _launch("k", nbr.device, nbr.data_ptr(), rows, d, out.data_ptr())  # EXPECT-R004
    return out


def plain_cube(lab):
    return lab[:, :, None] == lab[:, None, :]  # EXPECT-R004
''',
    "kernels/r004_clean.py": '''\
"""R004 negative: guarded launches within the ceiling, a bounded cube."""
MAX_DEGREE = 1024
CUBE_BUDGET_BYTES = 1 << 22


def _launch(name, dev, *args):
    return None


def _tiles(nbr):
    rows, d = nbr.shape
    if d > MAX_DEGREE:
        raise ValueError("row too wide")
    return rows, d


def label_argmax(nbr, out):
    rows, d = _tiles(nbr)
    if rows:
        _launch("label_argmax", nbr.device, nbr.data_ptr(), rows, d,
                out.data_ptr())
    return out


def plain_cube(lab):
    rows, d = lab.shape
    assert rows * d * d * 4 <= CUBE_BUDGET_BYTES
    return lab[:, :, None] == lab[:, None, :]
''',
    "partition/r005_ledger.py": '''\
"""R005 positive: edge-scale allocations with no ledger evidence."""
import numpy as np
import torch


def stage_edges(m_pad, dst):
    buf = np.zeros(m_pad, np.int32)  # EXPECT-R005
    buf[: len(dst)] = dst
    return buf


def stage_tiles(resident, device):
    m_w = len(resident.dst)
    return torch.arange(m_w, device=device)  # EXPECT-R005
''',
    "partition/r005_clean.py": '''\
"""R005 negative: the same allocations, ledger-accounted."""
import numpy as np
import torch


def stage_edges(ledger, m_pad, dst):
    nbytes = m_pad * 4
    ledger.acquire(nbytes)
    buf = np.zeros(m_pad, np.int32)
    buf[: len(dst)] = dst
    return torch.zeros(m_pad, dtype=torch.int32), buf
''',
    "engine/backends/r006_telemetry.py": '''\
"""R006 positive: telemetry inside a sweep-dispatch loop."""
import time

from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, span


def sweep_loop(nbr, nmask, labels, comm, counter):
    for _ in range(10):
        t0 = time.perf_counter()  # EXPECT-R006
        with span("sweep"):  # EXPECT-R006
            labels = ops.min_label(nbr, nmask, labels, comm)
        counter.inc()  # EXPECT-R006
        REGISTRY.counter("sweeps")  # EXPECT-R006
    return labels, t0
''',
    "engine/backends/r006_clean.py": '''\
"""R006 negative: stage timing around the loop, the device-side profile
write inside it."""
import time

from repro_torch.kernels import ops
from repro_torch.obs.convergence import record_row


def sweep_loop(nbr, nmask, labels, comm, buf):
    t0 = time.perf_counter()
    for it in range(10):
        new = ops.min_label(nbr, nmask, labels, comm)
        record_row(buf, it, (new != labels).sum(), 0, it)
        labels = new
    return labels, time.perf_counter() - t0
''',
    "engine/backends/r006_suppressed.py": '''\
"""R006 suppression: a justified per-sweep timer."""
import time

from repro_torch.kernels import ops


def sweep_loop(nbr, nmask, labels, comm, times):
    for _ in range(10):
        times.append(time.perf_counter())  # lint: telemetry-ok — fixture
        labels = ops.min_label(nbr, nmask, labels, comm)
    return labels
''',
}
POSITIVE = sorted(k for k in FIXTURES
                  if not k.endswith(("_clean.py", "_suppressed.py")))
NEGATIVE = sorted(k for k in FIXTURES if k.endswith("_clean.py"))
SUPPRESSED = sorted(k for k in FIXTURES if k.endswith("_suppressed.py"))


def _expected(source: str) -> set[tuple[str, int]]:
    out = set()
    for lineno, line in enumerate(source.splitlines(), 1):
        for rule in _EXPECT.findall(line):
            out.add((rule, lineno))
    return out


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _write_fixtures(root: Path) -> Path:
    """The fixtures under ``root/fixtures/lint/<relpath>``; returns that
    directory."""
    base = root / "fixtures" / "lint"
    for rel, src in FIXTURES.items():
        path = base / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return base


@pytest.fixture
def fixture_dir(tmp_path):
    return _write_fixtures(tmp_path)


@pytest.mark.parametrize("rel", POSITIVE)
def test_positive_fixture_flags_marked_lines(rel, fixture_dir):
    expected = _expected(FIXTURES[rel])
    assert expected, f"{rel} has no EXPECT markers"
    assert len({r for r, _ in expected}) == 1, \
        "each positive fixture triggers exactly one rule"
    path = fixture_dir / rel
    findings = _active(lint_paths([path]))
    got = {(f.rule, f.line) for f in findings}
    assert got == expected, f"{rel}: {got} != {expected}"
    for f in findings:
        assert f.path == rule_relpath(path) == rel
        assert f.line >= 1 and f.col >= 0


@pytest.mark.parametrize("rel", NEGATIVE)
def test_negative_fixture_stays_clean(rel, fixture_dir):
    assert lint_paths([fixture_dir / rel]) == []


def test_all_rules_covered_by_fixtures():
    seen = {r for rel in POSITIVE for r, _ in _expected(FIXTURES[rel])}
    assert seen == {r.id for r in all_rules()} \
        == {"R001", "R002", "R003", "R004", "R005", "R006"}
    assert [r.id for r in all_rules()] == sorted(seen)
    assert [r.tag for r in all_rules()] == [
        "host-sync", "retrace", "protocol", "pallas", "ledger", "telemetry"]


@pytest.mark.parametrize("rel", SUPPRESSED)
def test_suppression_reported_not_active(rel):
    findings = lint_source(FIXTURES[rel], rel)
    assert findings and all(f.suppressed for f in findings)
    assert len({f.rule for f in findings}) == 1


_HAZARD = (
    "def drive(plan, g, labels, active):\n"
    "    while True:\n"
    "        labels, active, dn = plan.step(g, labels, active)\n"
    "        if int(dn) == 0:  {comment}\n"
    "            break\n"
)


def test_suppression_same_line_and_wrong_tag():
    ok = lint_source(_HAZARD.format(comment="# lint: host-sync-ok — why"),
                     "core/x.py")
    assert ok and ok[0].suppressed
    wrong = lint_source(_HAZARD.format(comment="# lint: retrace-ok"),
                        "core/x.py")
    assert wrong and not wrong[0].suppressed
    string_not_comment = lint_source(
        _HAZARD.format(comment='+ len("lint: host-sync-ok")'), "core/x.py")
    assert string_not_comment and not string_not_comment[0].suppressed


def test_rules_scope_by_relpath():
    """The same hazard outside a hot-path module is not R001's business;
    a torch.compile in a compile-owning module is not R002's."""
    src = _HAZARD.format(comment="")
    assert lint_source(src, "core/lpa.py")
    assert lint_source(src, "partition/ooc.py")
    assert lint_source(src, "io/formats.py") == []
    compiled = "import torch\n\n\ndef f(g):\n    return torch.compile(g)\n"
    assert [f.rule for f in lint_source(compiled, "launch/serve.py")] \
        == ["R002"]
    assert lint_source(compiled, "core/dense.py") == []
    assert lint_source(FIXTURES["kernels/r004_pallas.py"], "core/x.py") \
        == []


def test_flow_sensitive_host_values():
    """A name rebound to a host value is a host value afterwards: only
    the concretizer is reported, not the tests and counts on its result
    (the out-of-core loop's numpy passes after ``to_host``)."""
    src = (
        "import torch\n"
        "from repro_torch.kernels import ops\n\n\n"
        "def f(nbr, nmask, labels, comm, thr):\n"
        "    dn = 1\n"
        "    while dn > thr:\n"
        "        new = ops.min_label(nbr, nmask, labels, comm)\n"
        "        ch = (new != labels).cpu().numpy()\n"
        "        dn = int(ch.sum())\n"
        "        if ch.any():\n"
        "            labels = new\n"
        "    return labels\n")
    got = [(f.rule, f.line, f.message.split()[0])
           for f in lint_source(src, "core/x.py")]
    assert got == [("R001", 9, ".cpu()")]


def test_syntax_error_becomes_finding():
    bad = lint_source("def broken(:\n", "core/x.py")
    assert len(bad) == 1 and bad[0].rule == "E000"


def test_rule_relpath_anchors():
    assert rule_relpath(
        Path("/r/src/repro_torch/engine/backends/segment.py")) \
        == "engine/backends/segment.py"
    assert rule_relpath(Path("/r/src/repro_torch/core/lpa.py")) \
        == "core/lpa.py"
    assert rule_relpath(Path("/r/tests/fixtures/lint/core/x.py")) \
        == "core/x.py"
    # the JAX package's anchor is not the port's
    assert rule_relpath(Path("/r/src/repro/core/lpa.py")) == "lpa.py"
    assert rule_relpath(Path("/elsewhere/thing.py")) == "thing.py"


def test_baseline_roundtrip(tmp_path, fixture_dir):
    findings = _active(lint_paths([fixture_dir]))
    assert findings
    path = tmp_path / "baseline.json"
    n = Baseline.dump(findings, path)
    assert n == len({f.identity() for f in findings})
    baseline = Baseline.load(str(path))
    assert all(f in baseline for f in findings)
    # line-shifted twin still matches (identity is line-independent)
    f = findings[0]
    shifted = Finding(rule=f.rule, path=f.path, line=f.line + 40,
                      col=f.col, message=f.message)
    assert shifted in baseline
    assert Finding(rule=f.rule, path=f.path, line=f.line, col=f.col,
                   message="other") not in baseline


def test_cli_exit_codes(fixture_dir, capsys):
    # fixtures carry positives -> strict fails, report-only passes
    assert lint_main([str(fixture_dir), "--strict"]) == 1
    assert lint_main([str(fixture_dir)]) == 0
    clean = fixture_dir / "core" / "r001_clean.py"
    assert lint_main([str(clean), "--strict"]) == 0
    assert lint_main(["--list-rules"]) == 0
    assert lint_main([str(fixture_dir), "--rules", "R999"]) == 2
    capsys.readouterr()
    assert lint_main([str(fixture_dir), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["new"] == len(payload["findings"]) > 0
    rules = {f["rule"] for f in payload["findings"]}
    assert rules == {"R001", "R002", "R003", "R004", "R005", "R006"}
    assert len(payload["suppressed"]) == len(SUPPRESSED)
    assert lint_main([str(fixture_dir), "--rules", "r004", "--strict"]) == 1
    with pytest.raises(SystemExit) as exc:
        lint_main(["--no-such-flag"])
    assert exc.value.code == 2


def test_cli_baseline_gates_strict(tmp_path, fixture_dir):
    baseline = tmp_path / "baseline.json"
    assert lint_main([str(fixture_dir), "--write-baseline",
                      "--baseline", str(baseline)]) == 0
    assert lint_main([str(fixture_dir), "--strict",
                      "--baseline", str(baseline)]) == 0


def test_smem_ceiling_knob(fixture_dir):
    path = fixture_dir / "kernels" / "r004_clean.py"
    assert lint_paths([path]) == []
    # MAX_DEGREE 1024: one warp's row is 1024 slots x 16 B = 16 KiB, so a
    # 8 KiB ceiling trips it, and the CLI flag passes the ceiling on
    tight = all_rules(smem_ceiling=8192)
    findings = _active(lint_paths([path], tight))
    assert findings and "shared memory" in findings[0].message
    assert lint_main([str(path), "--strict", "--smem-ceiling", "8192"]) == 1
    assert lint_main([str(path), "--strict", "--smem-ceiling",
                      str(16 * 1024)]) == 0


def test_repo_is_clean_under_strict():
    """The committed state of src/repro_torch passes the strict gate: no
    active findings beyond the committed baseline."""
    baseline = Baseline.load(str(PKG / "analysis" / "baseline.json"))
    new = [f for f in _active(lint_paths([PKG])) if f not in baseline]
    assert new == [], "\n".join(f.format() for f in new)
    assert lint_main(["--strict"]) == 0


def test_baseline_has_no_stale_entries():
    """Every committed baseline entry is a live finding: the change that
    removes a cost removes its entry too."""
    entries = json.loads((PKG / "analysis" / "baseline.json").read_text())
    live = {f.identity() for f in _active(lint_paths([PKG]))}
    assert entries and all(
        (e["rule"], e["path"], e["message"]) in live for e in entries)


def test_every_inline_suppression_gives_its_reason():
    token = re.compile(r"#\s*lint:\s*([a-z0-9-]+-ok)(.*)$")
    seen = 0
    for path in sorted(PKG.rglob("*.py")):
        if "analysis" in path.parts:
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            m = token.search(line)
            if m:
                seen += 1
                reason = m.group(2).strip(" —-")
                assert len(reason) >= 10, f"{path}:{lineno} has no reason"
    assert seen >= 10


def test_linter_imports_no_torch():
    """The linter is stdlib only: importing the package and running the
    strict gate loads neither torch nor the JAX package."""
    code = ("import sys\n"
            "from repro_torch.launch.lint import main\n"
            "import repro_torch.analysis as a\n"
            "rc = main(['--strict'])\n"
            "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "assert callable(a.lint_paths)\n"
            "sys.exit(rc)\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean:" in out.stdout


# --- parity with the JAX package ---

SUPPRESSION_SOURCES = [
    "x = 1  # lint: host-sync-ok — why\n",
    "# lint: retrace-ok, pallas-ok\ny = 2\n",
    'z = "lint: host-sync-ok"  # plain comment\n',
    "def f(:\n    pass  # lint: ledger-ok\n",
    "a = (1,\n     2)  # lint: telemetry-ok\n# lint:protocol-ok\n",
    "s = '''\n# lint: host-sync-ok\n'''\n",
    "",
]


@pytest.mark.parametrize("source", SUPPRESSION_SOURCES)
def test_parse_suppressions_matches_reference(source):
    assert _parse_suppressions(source) == j_parse_suppressions(source)


def test_finding_identity_matches_reference():
    fields = dict(rule="R001", path="core/lpa.py", line=3, col=4,
                  message="int() on device value 'dn'")
    port, ref = Finding(**fields), JFinding(**fields)
    assert port.identity() == ref.identity()
    assert port.format() == ref.format()
    assert port.to_json() == ref.to_json()


def test_baseline_json_loads_across_packages(tmp_path, fixture_dir):
    findings = _active(lint_paths([fixture_dir]))
    twins = [JFinding(rule=f.rule, path=f.path, line=f.line, col=f.col,
                      message=f.message) for f in findings]
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    assert Baseline.dump(findings, ours) == JBaseline.dump(twins, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    from_ref = Baseline.load(str(theirs))
    from_port = JBaseline.load(str(ours))
    assert len(from_ref) == len(from_port) == len(
        {f.identity() for f in findings})
    assert all(f in from_ref for f in findings)
    assert all(f in from_port for f in twins)
    stranger = Finding(rule="R009", path="x.py", line=1, col=0, message="m")
    assert stranger not in from_ref


@pytest.mark.parametrize("name", ["r005_ledger.py", "r005_clean.py"])
def test_r005_over_reference_fixtures(name):
    path = REF_FIXTURES / "partition" / name
    ours = {(f.rule, f.line) for f in lint_paths([path], [LedgerRule()])}
    theirs = {(f.rule, f.line) for f in jlint_paths([path])
              if f.rule == "R005"}
    assert ours == theirs
    assert bool(ours) == (name == "r005_ledger.py")
