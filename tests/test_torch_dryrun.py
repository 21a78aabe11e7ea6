"""PyTorch port, the dry run (``launch/dryrun.py``, ``launch/sweep.py``)
against the JAX package's (``repro.launch.dryrun``, ``repro.launch.sweep``).

Exact comparisons (shapes, dtypes, integer bytes and the ring formulas'
floats): the cells' input specs, ``graph_input_specs``, ``collective_bytes``
per kind and group size, the per-device state bytes of every cell on both
production meshes, and the sweep's cell list.  The fake-world traces (the
reference machinery test's reduced cells on a (4, 2) world, reduced yi-9b
on one rank, a full-size graph-lpa cell) run in one subprocess, as a fake
process group belongs to its process; the reference's side (its
``collective_bytes`` and ``_analytic_bytes_per_device``, whose module sets
512 host devices as it is imported) runs in another, with 512 XLA host
devices.  The kernels' ``meta`` paths are held to their CPU paths' shapes
and dtypes and must call no plain version.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.core.distributed import graph_input_specs as j_graph  # noqa: E402
from repro_torch.configs import ARCHS, get_config, input_specs  # noqa: E402
from repro_torch.configs import supported_shapes  # noqa: E402
from repro_torch.core.distributed import graph_input_specs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.parallel.compat import abstract_mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
GROUP_SIZES = (1, 2, 16, 256)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
RESULT_BYTES = 3 * 1024 * 1024 + 8


def _cells():
    return [(a, s) for a, cfg in ARCHS.items() for s in supported_shapes(cfg)]


# ------------------------------------------------------ the reference side

REF_SCRIPT = r"""
import json
from repro.launch.dryrun import _analytic_bytes_per_device, collective_bytes
from repro.configs import ARCHS, supported_shapes
from repro.configs.base import SHAPES
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as T
from repro.train import steps as S

out = {"collectives": {}, "state_bytes": {}}
for kind in %(kinds)r:
    for s in %(sizes)r:
        groups = "replica_groups=[%%d,%%d]<=[%%d]" %% (256 // s, s, 256)
        line = ("  %%c = u8[%(nbytes)d]{0} " + kind
                + "(u8[%(nbytes)d]{0} %%x), " + groups)
        out["collectives"]["%%s/%%d" %% (kind, s)] = collective_bytes(line)
for name, multi in (("pod", False), ("multipod", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, cfg in ARCHS.items():
        for shape in supported_shapes(cfg):
            sp = SHAPES[shape]
            rules, psh, osh, params = S.state_shardings(cfg, mesh, shape)
            n = _analytic_bytes_per_device(psh, params, mesh)
            if sp.step == "train":
                n += _analytic_bytes_per_device(
                    osh, S.abstract_opt_state(cfg, params), mesh)
            elif sp.step == "decode":
                csh = S.make_decode_step(cfg, mesh, shape)[3]
                n += _analytic_bytes_per_device(
                    csh, T.init_decode_caches(cfg, sp.global_batch,
                                              sp.seq_len, abstract=True),
                    mesh)
            out["state_bytes"]["%%s/%%s/%%s" %% (arch, shape, name)] = n
print("RESULT" + json.dumps(out))
""" % {"kinds": KINDS, "sizes": GROUP_SIZES, "nbytes": RESULT_BYTES}


def _run(script: str, timeout: float, **env) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def reference():
    return _run(REF_SCRIPT, 300, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=512")


# -------------------------------------------------- the port's fake worlds

PORT_SCRIPT = r"""
import dataclasses, json, sys
from pathlib import Path
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models.attention import KVCache
out = {}
with fake_world(8):
    mesh = make_host_mesh((4, 2), ("data", "model"))
    for name, shape in [("yi-9b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
                        ("jamba-v0.1-52b", "long_500k")]:
        run, args, meta = D._lower_cell(name, shape, mesh,
                                        cfg=reduced_config(name))
        trace, mem = D.trace_cell(run, args)
        coll = D.collective_bytes(trace.collectives)
        cache = None
        if shape == "long_500k":
            kv = next(c for c in args[1].values() if isinstance(c, KVCache))
            cache = str(tuple(kv.k.placements))
        out[name + "/" + shape] = {"cost": trace.cost(), "mem": mem,
                                   "coll": coll, "cache": cache}
cfg = dataclasses.replace(reduced_config("yi-9b"), remat="full")
with fake_world(1):
    mesh = make_host_mesh((1, 1), ("data", "model"))
    run, args, meta = D._lower_cell("yi-9b", "train_4k", mesh, cfg=cfg)
    trace, mem = D.trace_cell(run, args)
    out["one_rank"] = {"cost": trace.cost(), "mem": mem,
                       "coll": D.collective_bytes(trace.collectives)}
out["graph"] = D.run_cell("graph-lpa", "graph", "pod",
                          out_dir=Path(sys.argv[1]))
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", PORT_SCRIPT, str(tmp)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):]), tmp


# ------------------------------------------------------------ input specs

def _same_specs(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        t = got[k]
        assert t.device.type == "meta" and tuple(t.shape) == tuple(w.shape), k
        assert str(t.dtype).replace("torch.", "") == jnp.dtype(w.dtype).name


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match_reference(arch, shape):
    """Every cell's model inputs: the reference's keys, shapes and dtypes
    exactly, on the ``meta`` device."""
    _same_specs(input_specs(get_config(arch), shape),
                j_input_specs(JARCHS[arch], shape))


def test_graph_input_specs_match_reference():
    n_pad = 1 << 26
    _same_specs(graph_input_specs(n_pad, 64), j_graph(n_pad, 64))


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_match_reference(kind, reference):
    """The ring formulas: the port's ``collective_bytes`` on one record
    (kind, result bytes, group size) equals the reference's on one HLO
    line of that collective, for S in {1, 2, 16, 256}, exactly."""
    for s in GROUP_SIZES:
        got = D.collective_bytes([(kind, RESULT_BYTES, s)])
        assert got == reference["collectives"][f"{kind}/{s}"], (kind, s)


def test_collective_bytes_sum_records_and_trips():
    recs = [("all-gather", 100, 4), ("all-gather", 60, 4),
            ("all-reduce", 8, 1)]
    got = D.collective_bytes(recs, loop_trips=3)
    assert got["counts"] == {"all-gather": 2, "all-reduce": 1}
    assert got["bytes"] == {"all-gather": 480, "all-reduce": 24,
                            "total": 504}
    assert got["wire_bytes"]["all-gather"] == 100 * 0.75 * 3 + 60 * 0.75 * 3
    assert got["wire_bytes"]["all-reduce"] == 0.0
    assert got["loop_trips_applied"] == 3


# ------------------------------------------------------------ state bytes

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_state_bytes_match_reference(mesh, reference):
    """Per-device state bytes (parameters, + optimizer for train, + caches
    for decode) of every cell, from the port's rules on an abstract
    production mesh, against the reference's ``_analytic_bytes_per_device``
    over its own shardings on 512 host devices: exactly equal."""
    am = abstract_mesh(*MESHES[mesh])
    want = reference["state_bytes"]
    for arch, shape in _cells():
        got = D.analytic_state_bytes(get_config(arch), shape, am)
        assert got == want[f"{arch}/{shape}/{mesh}"], (arch, shape, mesh)


# ------------------------------------------------------ fake-world traces

@pytest.mark.parametrize("cell", ["yi-9b/train_4k", "qwen2-moe-a2.7b/train_4k",
                                  "jamba-v0.1-52b/long_500k"])
def test_reduced_cells_trace_on_a_fake_world(cell, port):
    """The reference machinery test's three reduced cells, traced on a fake
    (4, 2) world: FLOPs and argument bytes > 0; the train cells record a
    reduce-scatter and an all-gather with wire bytes; jamba's long decode
    runs on the sequence-parallel cache (rows over ``data``)."""
    r = port[0][cell]
    assert r["cost"]["flops"] > 0
    assert r["mem"]["argument_size_in_bytes"] > 0
    assert r["mem"]["temp_size_in_bytes"] > 0
    if cell.endswith("train_4k"):
        for kind in ("reduce-scatter", "all-gather"):
            assert r["coll"]["counts"].get(kind, 0) > 0, (cell, kind)
            assert r["coll"]["wire_bytes"][kind] > 0, (cell, kind)
        assert r["mem"]["alias_size_in_bytes"] > 0     # donated state
    else:
        # the K / V caches (G, B, S, K, hd) split on their rows over data
        assert r["cache"].startswith("(Shard(dim=2),"), r["cache"]
        assert r["cost"]["flash_attention calls"] > 0


def test_one_rank_flops_are_the_configs_count(port):
    """Reduced yi-9b, remat full, train_4k on a one-rank world: the
    product FLOPs equal the count written from the config (the forward's
    products, twice that for the backward, once more for remat's
    recompute of every layer but its last product, the MLP's down
    projection, whose output no backward reads: torch's checkpoint stops
    its recompute early there; the LM head forward and backward), and B5 /
    B5-bwd's equal their causal pairs' (4 and 10 operations a pair and
    head dim; B5 twice a layer, B5-bwd once): exactly."""
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import SHAPES
    r = port[0]["one_rank"]
    cfg = reduced_config("yi-9b")
    sp = SHAPES["train_4k"]
    t = sp.global_batch * sp.seq_len
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    h, k = cfg.n_heads_padded, cfg.n_kv_padded
    down = 2 * t * ff * d
    layer = 2 * t * d * (h + 2 * k) * hd + 2 * t * h * hd * d \
        + 2 * 2 * t * d * ff + down
    head = 2 * t * d * cfg.vocab_padded
    assert r["cost"]["product_flops"] == \
        cfg.n_layers * (4 * layer - down) + 3 * head
    pairs = sp.seq_len * (sp.seq_len + 1) // 2
    per = sp.global_batch * h * hd * pairs
    assert r["cost"]["flash_attention flops"] == 2 * cfg.n_layers * 4 * per
    assert r["cost"]["flash_attention_bwd flops"] == cfg.n_layers * 10 * per
    assert r["cost"]["flops"] == r["cost"]["product_flops"] + \
        r["cost"]["flash_attention flops"] + \
        r["cost"]["flash_attention_bwd flops"]
    assert r["coll"]["wire_bytes"]["total"] == 0.0   # groups of one


def test_graph_cell_writes_its_record(port):
    """graph-lpa at full size (n = 2^26, d_max = 64) on the 256-rank pod:
    rank 0's 262,144 rows, two B1 sweeps, each ending in the replica's
    all-gather; the JSON written with the reference's keys."""
    out, tmp = port
    rec = json.loads((tmp / "graph-lpa_graph_pod.json").read_text())
    assert rec == out["graph"]
    assert sorted(rec) == sorted(["arch", "shape", "mesh", "chips", "meta",
                                  "cost_analysis", "memory_analysis",
                                  "collectives", "unrolled", "lower_seconds",
                                  "compile_seconds"])
    n_loc = (1 << 26) // 256
    cost = rec["cost_analysis"]
    assert cost["label_argmax calls"] == 2
    assert cost["label_argmax bytes"] == 2 * ops.CELL_BYTES["label_argmax"] \
        * n_loc * 64
    assert cost["flops"] == cost["label_argmax flops"] == 2 * 2 * 64 * n_loc \
        * 64
    assert rec["collectives"]["counts"]["all-gather"] == 2
    assert rec["collectives"]["bytes"]["all-gather"] == 2 * 4 * (1 << 26)
    # nbr, nw, nmask of rank 0's rows, the replica, the active flags
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        n_loc * 64 * 9 + 4 * (1 << 26) + n_loc
    assert rec["chips"] == 256 and rec["unrolled"] is False


# ------------------------------------------------------ the kernels on meta

def _lpa_tiles(device, rows=24, d=5):
    g = torch.Generator().manual_seed(3)
    t = dict(nbr=torch.randint(0, rows, (rows, d), generator=g,
                               dtype=torch.int32),
             nw=torch.rand((rows, d), generator=g),
             nmask=torch.rand((rows, d), generator=g) < 0.7,
             labels=torch.randint(0, 9, (rows,), generator=g,
                                  dtype=torch.int32),
             comm=torch.randint(0, 3, (rows,), generator=g,
                                dtype=torch.int32),
             chg=torch.rand((rows,), generator=g) < 0.5)
    for k in ("active", "cand_prev", "klass", "real"):
        t[k] = torch.rand((rows,), generator=g) < 0.5
    return {k: v.to(device) for k, v in t.items()}


def _attn(device, dtype, grad=False):
    g = torch.Generator().manual_seed(4)
    out = [torch.randn(s, generator=g).to(dtype).to(device)
           for s in ((2, 70, 6, 64), (2, 70, 2, 64), (2, 70, 2, 64))]
    return [t.requires_grad_(grad) for t in out]


ENTRY_POINTS = {
    "label_argmax": lambda t, a: ops.label_argmax(
        t["nbr"], t["nw"], t["nmask"], t["labels"], 7),
    "min_label": lambda t, a: ops.min_label(
        t["nbr"], t["nmask"], t["labels"], t["comm"]),
    "fused_move": lambda t, a: ops.fused_move(
        t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"], t["active"],
        t["cand_prev"], t["klass"], t["real"], 7),
    "fused_split": lambda t, a: ops.fused_split(
        t["nbr"], t["nmask"], t["labels"], t["comm"], t["chg"], True),
    "flash_attention": lambda t, a: ops.flash_attention(
        *a, causal=True, window=16),
    "flash_attention_decode": lambda t, a: ops.flash_attention(
        a[0][:, :1].contiguous(), a[1], a[2], causal=False, kv_len=50,
        q_offset=49),
    "flash_attention_fwd": lambda t, a: ops.flash_attention_fwd(
        *a, causal=True),
    "flash_attention_bwd": lambda t, a: ops.flash_attention_bwd(
        *a, *ops.flash_attention_fwd(*a, causal=True, window=9)[:1],
        torch.ones_like(a[0]),
        ops.flash_attention_fwd(*a, causal=True, window=9)[1], True,
        window=9),
}


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return [(tuple(x.shape), x.dtype)]
    return [s for t in x for s in _shapes(t)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_meta_paths_give_the_cpu_shapes_and_call_no_plain_version(
        name, dtype, monkeypatch):
    """Each kernel entry point on ``meta`` inputs returns the CPU path's
    shapes and dtypes for same-shaped inputs, adds its cost to the table,
    and calls nothing in ``kernels/ref.py``."""
    from repro_torch.parallel.compat import cost_analysis
    fn = ENTRY_POINTS[name]
    want = _shapes(fn(_lpa_tiles("cpu"), _attn("cpu", dtype)))

    def plain(*a, **k):
        raise AssertionError("a meta path called a plain version")
    for attr in dir(ref):
        if attr.endswith("_ref"):
            monkeypatch.setattr(ref, attr, plain)
    with cost_analysis() as trace:
        got = fn(_lpa_tiles("meta"), _attn("meta", dtype))
    assert _shapes(got) == want
    assert all(t.device.type == "meta" for t in
               ([got] if isinstance(got, torch.Tensor) else got))
    assert trace.kernels and all(k["calls"] > 0 for k in
                                 trace.kernels.values())


def test_meta_grad_runs_b5_bwd_on_meta(monkeypatch):
    """Under grad, ``ops.flash_attention`` on ``meta`` runs B5 with lse
    and, in the backward, B5-bwd's ``meta`` path: one call each, their
    operations those of the window's band, no launch counted."""
    from repro_torch.parallel.compat import cost_analysis
    for attr in dir(ref):
        if attr.endswith("_ref"):
            monkeypatch.setattr(ref, attr, None)
    q, k, v = _attn("meta", torch.bfloat16, grad=True)
    ops.reset_launches()
    with cost_analysis() as trace:
        ops.flash_attention(q, k, v, causal=True, window=16).sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    pairs = sum(min(i + 1, 16) for i in range(70))
    per = 2 * 6 * 64 * pairs
    assert trace.kernels["flash_attention"] == {
        "calls": 1, "flops": 4 * per,
        "bytes": trace.kernels["flash_attention"]["bytes"]}
    assert trace.kernels["flash_attention_bwd"]["flops"] == 10 * per
    assert all(n == 0 for n in ops.LAUNCHES.values())


# --------------------------------------------------------------- the sweep

def test_sweep_cells_match_reference():
    from repro.launch.sweep import cells as j_cells
    from repro_torch.launch.sweep import cells
    assert cells() == j_cells()
    assert D.all_cells() == cells()


def test_dryrun_imports_no_jax():
    """Importing the port's dry run and sweep loads neither JAX nor the
    JAX package."""
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.sweep; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; print('RESULT' + "
            "__import__('json').dumps(bad))")
    assert _run(code, 120) == []


def test_fake_world_leaves_no_group():
    """``fake_world`` starts a group of the size asked for and destroys it
    on leaving, also when the block raises."""
    code = r"""
import json, torch.distributed as dist
from repro_torch.launch.mesh import fake_world, make_production_mesh
seen = []
with fake_world(512):
    seen.append(dist.get_world_size())
    seen.append(list(make_production_mesh(multi_pod=True).shape))
try:
    with fake_world(256):
        raise KeyError
except KeyError:
    pass
print("RESULT" + json.dumps(seen + [dist.is_initialized()]))
"""
    assert _run(code, 120) == [512, [2, 16, 16], False]
