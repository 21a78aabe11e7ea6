"""PyTorch port, LM training: ``models.transformer.loss_fn`` for the ten
archs, ``train.steps`` and ``launch.train`` against the JAX package on the
same numpy-seeded inputs, the reference's weights carried over with
``params_from_numpy``; the remat policies; the reference's training-loop
checks (``tests/test_train_loop.py``) on the port.

Tolerances (relative: max abs difference over max abs): the loss within
1e-5 in float32 (the weights upcast) and 0.02 in bf16 (the reference's
``TOL``: the frameworks round other partial sums to bf16); three train
steps' losses and final parameters within 1e-4 in float32 and 0.02 in
bf16.  The steps run the schedule's warmup (``make_train_step``'s
defaults): Adam's first updates are +-lr wherever |g| >> eps, so a
gradient near 0 that the two sides round to opposite signs puts its
parameter 2 lr apart, and a small lr keeps that inside the bound.

The encoder-decoder in float32: the reference's ``encode`` casts its
frames to bf16 and ``lax.scan`` refuses a carry that float32 weights then
promote to float32, so its float32 runs replace ``encode`` with the same
body looped in Python (``_encode_unrolled``), which is what the port's
loop computes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.ft import StragglerMonitor as JStraggler  # noqa: E402
from repro.parallel.compat import make_mesh  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.engine.config import UNPORTED  # noqa: E402
from repro_torch.ft import PreemptionHandler, StragglerMonitor  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.common import map_specs  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from test_torch_transformer import (  # noqa: E402
    ALL,
    JT,
    TT,
    configs,
    extras,
    jinit,
    params_from_numpy,
    tokens,
)

TOL = {"float32": 1e-5, "bfloat16": 0.02}
STEP_TOL = {"float32": 1e-4, "bfloat16": 0.02}


def _encode_unrolled(cfg, params, frames):
    """The reference's ``encode`` with its scan written as a loop."""
    x = frames.astype(jnp.bfloat16)
    positions = jnp.arange(x.shape[1], dtype=jnp.int32)
    for i in range(cfg.enc_layers):
        p = jax.tree.map(lambda a: a[i], params["enc_groups"])["0"]
        h = JT._norm(cfg, p["norm1"], x)
        ap = JT.attn.mask_padded_heads(p["attn"], cfg.n_heads, cfg.n_kv)
        x = x + JT.attn.attention_train(
            ap, h, positions, n_heads=cfg.n_heads_padded,
            n_kv=cfg.n_kv_padded, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=False, chunk=cfg.attn_chunk)
        x = JT._apply_mlp(cfg, "dense", p, x)
    return JT._norm(cfg, params["enc_norm"], x)


def carried(name, dtype, remat=None):
    """(jcfg, tcfg, jax params, port params) in ``dtype``, the port's
    carried over from the reference's (PRNGKey(1))."""
    jcfg, tcfg = configs(name)
    if remat is not None:
        jcfg = dataclasses.replace(jcfg, remat=remat)
        tcfg = dataclasses.replace(tcfg, remat=remat)
    jp = jinit(JT.model_specs(jcfg), jax.random.PRNGKey(1))
    specs = TT.model_specs(tcfg)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        specs = map_specs(lambda s: dataclasses.replace(
            s, dtype=torch.float32), specs)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, specs, "cpu")


def lm_batch(cfg, dtype, b=2, s=17, seed=5):
    """(reference's, port's) batch: tokens, targets and the family's
    extras, in ``dtype``."""
    toks, tg = tokens(cfg, b, s, seed), tokens(cfg, b, s, seed + 1)
    jx, tx = extras(cfg, b, seed)
    if dtype == "float32":
        jx = {k: v.astype(jnp.float32) for k, v in jx.items()}
        tx = {k: v.float() for k, v in tx.items()}
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg), **jx},
            {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg),
             **tx})


@pytest.fixture
def unrolled_encode(monkeypatch):
    monkeypatch.setattr(JT, "encode", _encode_unrolled)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ALL)
def test_loss_fn_matches_reference(name, dtype, unrolled_encode):
    jcfg, tcfg, jp, tp = carried(name, dtype)
    jb, tb = lm_batch(tcfg, dtype)
    want = float(JT.loss_fn(jcfg, jp, jb))
    with torch.no_grad():
        got = TT.loss_fn(tcfg, tp, tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= TOL[dtype] * abs(want)


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_reference(dtype, microbatch):
    """Three ``make_train_step`` steps against the reference's on a (1, 1)
    mesh, donate off, the same params and batches: the losses per step,
    the final params, the optimizer count."""
    jcfg, tcfg, jp, tp = carried("yi-9b", dtype)
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, *_ = JS.make_train_step(jcfg, mesh, "train_4k",
                                   microbatch=microbatch, donate=False)
    tstep, rules, psh, osh = TS.make_train_step(
        tcfg, None, "train_4k", microbatch=microbatch, donate=False)
    assert (rules, psh, osh) == (None, None, None)
    jo, to = JS.init_opt_state(jcfg, jp), TS.init_opt_state(tcfg, tp)
    for i in range(3):
        toks, tg = tokens(tcfg, 4, 16, 20 + i), tokens(tcfg, 4, 16, 30 + i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks),
                                    "targets": jnp.asarray(tg)},
                           jnp.int32(i + 10))
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tg)}, i + 10)
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= STEP_TOL[dtype] * want
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=STEP_TOL[dtype])
    assert int(to.count) == int(jo.count) == 3
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        a = np.asarray(a.astype(jnp.float32))
        assert str(b.dtype) == f"torch.{dtype}"
        assert np.abs(a - b.float().numpy()).max() \
            <= STEP_TOL[dtype] * np.abs(a).max()


def test_windowed_train_step_matches_reference():
    """One ``make_train_step`` step of reduced starcoder2-15b with its
    sliding window cut to 8 (so that 16-token sequences bind it), float32,
    against the reference's on a (1, 1) mesh: the loss within 1e-5, every
    gradient (``jax.grad`` of the reference's ``loss_fn``) and the updated
    params within 1e-4, relative to the leaf's max abs.

    The params are compared where the reference's gradient exceeds 1e3 x
    AdamW's eps (1e-8).  Adam's first update is lr g / (|g| + eps), so an
    element whose gradient is rounding-sized moves by a share of lr that
    rounding decides; starcoder2's zero-initialised biases hold such
    elements (the key bias's gradient is 0 exactly: softmax ignores a
    shift shared by a query's scores), and their leaves' max abs is the
    update itself."""
    jcfg, tcfg, jp, tp = carried("starcoder2-15b", "float32")
    jcfg = dataclasses.replace(jcfg, window=8)
    tcfg = dataclasses.replace(tcfg, window=8)
    toks, tg = tokens(tcfg, 2, 16, 40), tokens(tcfg, 2, 16, 41)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)}
    jgrads = jax.grad(lambda p: JT.loss_fn(jcfg, p, jb))(jp)
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, *_ = JS.make_train_step(jcfg, mesh, "train_4k", donate=False)
    jp, _, jm = jstep(jp, JS.init_opt_state(jcfg, jp), jb, jnp.int32(10))
    tstep, *_ = TS.make_train_step(tcfg, None, "train_4k", donate=False,
                                   keep_grads=True)
    tp, _, tm = tstep(tp, TS.init_opt_state(tcfg, tp),
                      {"tokens": torch.from_numpy(toks),
                       "targets": torch.from_numpy(tg)}, 10)
    want = float(jm["loss"])
    assert abs(float(tm["loss"]) - want) <= TOL["float32"] * want
    for g, a, gt, b in zip(jax.tree.leaves(jgrads), jax.tree.leaves(jp),
                           tree_leaves(tm["grads"]), tree_leaves(tp)):
        g, a = np.asarray(g, np.float32), np.asarray(a, np.float32)
        assert np.abs(g - gt.numpy()).max() \
            <= STEP_TOL["float32"] * np.abs(g).max()
        moved = np.abs(g) > 1e3 * 1e-8
        assert np.abs(a - b.numpy())[moved].max(initial=0.0) \
            <= STEP_TOL["float32"] * np.abs(a).max()


def test_train_step_donates_in_place():
    _, tcfg, _, tp = carried("yi-9b", "bfloat16")
    step, *_ = TS.make_train_step(tcfg, donate=True)
    opt = TS.init_opt_state(tcfg, tp)
    _, tb = lm_batch(tcfg, "bfloat16")
    new, new_opt, m = step(tp, opt, {k: tb[k] for k in ("tokens",
                                                        "targets")}, 10)
    assert all(a is b for a, b in zip(tree_leaves(new), tree_leaves(tp)))
    assert new_opt.m["embed"]["table"] is opt.m["embed"]["table"]
    assert int(opt.count) == 1 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("microbatch", [None, 2])
def test_train_step_keeps_its_grads_on_request(microbatch):
    """``keep_grads`` hands back the gradients AdamW was given: those of
    ``_loss_and_grads`` (the microbatches' mean under accumulation), and
    the step's update is the one it makes without them."""
    _, tcfg, _, tp = carried("yi-9b", "float32")
    _, tb = lm_batch(tcfg, "float32", b=4)
    tb = {k: tb[k] for k in ("tokens", "targets")}
    out = {}
    for keep in (False, True):
        step, *_ = TS.make_train_step(tcfg, microbatch=microbatch,
                                      donate=False, keep_grads=keep)
        out[keep] = step(tp, TS.init_opt_state(tcfg, tp), tb, 10)
    assert "grads" not in out[False][2]
    grads = out[True][2]["grads"]
    if microbatch is None:
        want = TS._loss_and_grads(tcfg, tp, tb)[1]
        for a, b in zip(tree_leaves(grads), tree_leaves(want)):
            assert torch.equal(a, b)
    assert [a.shape for a in tree_leaves(grads)] == \
        [p.shape for p in tree_leaves(tp)]
    for a, b in zip(tree_leaves(out[True][0]), tree_leaves(out[False][0])):
        assert torch.equal(a, b)


def test_remat_policies_give_equal_loss_and_grads():
    """"full", "dots" and "none" recompute what they drop: the same loss
    and gradients (seamless: the encoder and the decoder both remat)."""
    out = {}
    for remat in ("none", "full", "dots"):
        _, tcfg, _, tp = carried("seamless-m4t-large-v2", "float32", remat)
        _, tb = lm_batch(tcfg, "float32")
        out[remat] = TS._loss_and_grads(tcfg, tp, tb)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for a, b in zip(tree_leaves(out[remat][1]),
                        tree_leaves(out["none"][1])):
            assert torch.allclose(a, b, rtol=0, atol=1e-7), remat


def test_remat_rejects_an_unknown_policy():
    _, tcfg, _, tp = carried("yi-9b", "float32", "everything")
    _, tb = lm_batch(tcfg, "float32")
    with pytest.raises(ValueError):
        TS._loss_and_grads(tcfg, tp, tb)


def test_multi_device_mesh_raises_unported():
    """A mesh of one device (or None) gives the plain serving steps, with
    no rules or shardings; a larger mesh must be a ``DeviceMesh`` (the
    sharded serving steps on one are held to the reference in
    tests/test_torch_serve_sharded.py), and no serving entry is left in
    UNPORTED."""
    class Mesh:            # a DeviceMesh's size(), without a process group
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n
    _, cfg, _, params = carried("yi-9b", "float32")
    TS.make_train_step(cfg, Mesh(1))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    for mesh in (None, Mesh(1)):
        pre, *rest = TS.make_prefill_step(cfg, mesh, s_max=16)
        dec, *drest = TS.make_decode_step(cfg, mesh)
        assert rest == drest == [None, None, None]
        lg, caches = pre(params, {"tokens": toks[:, :8]})
        lg2, caches = dec(params, caches, {"tokens": toks[:, 8:]})
        assert lg.shape == (2, cfg.vocab_padded) and caches["0"].length == 9
        assert lg2.shape == (2, 1, cfg.vocab_padded)
    for make in (TS.make_prefill_step, TS.make_decode_step):
        with pytest.raises(ValueError, match="DeviceMesh"):
            make(cfg, Mesh(4))
    assert not any(k.startswith("parallel/") for k in UNPORTED)


def test_opt_state_init_and_abstract():
    _, tcfg, _, tp = carried("yi-9b", "bfloat16")
    st = TS.init_opt_state(tcfg, tp)
    ab = TS.abstract_opt_state(tcfg, tp)
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    for p, m, a in zip(tree_leaves(tp), tree_leaves(st.m),
                       tree_leaves(ab.v)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert a.device.type == "meta" and a.shape == p.shape
    bf = TS.init_opt_state(dataclasses.replace(
        tcfg, optimizer_state_dtype="bfloat16"), tp)
    assert tree_leaves(bf.v)[0].dtype == torch.bfloat16


def test_prefill_and_decode_steps_wrap_the_model():
    jcfg, tcfg, jp, tp = carried("yi-9b", "bfloat16")
    prefill, *_ = TS.make_prefill_step(tcfg, None, "train_4k")
    decode, *_ = TS.make_decode_step(tcfg, None, "train_4k")
    toks = torch.from_numpy(tokens(tcfg, 2, 9, 4))
    lg, caches = prefill(tp, {"tokens": toks[:, :8]})
    with torch.inference_mode():
        want, _ = TT.prefill(tcfg, tp, {"tokens": toks[:, :8]}, 4096)
    assert torch.equal(lg, want)
    assert caches["0"].k.shape[2] == 4096 and caches["0"].length == 8
    lg2, caches = decode(tp, caches, {"tokens": toks[:, 8:9]})
    assert lg2.shape == (2, 1, tcfg.vocab_padded)
    assert caches["0"].length == 9


# --- the reference's tests/test_train_loop.py on the port ----------------

def test_loss_decreases():
    out = tlaunch.run("yi-9b", steps=30, seq_len=64, global_batch=8,
                      log_every=100, peak_lr=3e-3, device="cpu")
    losses = out["losses"]
    assert min(losses) < losses[0] - 0.5, (losses[0], min(losses))
    assert len(out["step_s"]) == 30 and len(out["grad_norms"]) == 30


def test_checkpoint_restart_bitexact(tmp_path):
    """Interrupted + resumed run == uninterrupted run (same final params
    and optimizer state)."""
    common = dict(arch="yi-9b", seq_len=32, global_batch=4, log_every=100,
                  device="cpu")
    ref = tlaunch.run(steps=8, **common)
    ck = tmp_path / "ck"
    tlaunch.run(steps=4, ckpt_dir=str(ck), save_every=4, **common)
    resumed = tlaunch.run(steps=8, ckpt_dir=str(ck), save_every=4,
                          resume=True, **common)
    assert resumed["final_step"] == 8
    for a, b in zip(tree_leaves(ref["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ref["opt_state"].v),
                    tree_leaves(resumed["opt_state"].v)):
        assert torch.equal(a, b)
    assert ref["losses"][4:] == resumed["losses"]


def test_preemption_checkpoints_and_stops(tmp_path):
    handler = PreemptionHandler()
    handler.request_stop()          # simulate SIGTERM before step loop
    out = tlaunch.run("yi-9b", steps=50, seq_len=32, global_batch=4,
                      ckpt_dir=str(tmp_path / "ck"), save_every=100,
                      log_every=100, preempt=handler, device="cpu")
    assert out["final_step"] == 1   # stopped at the first boundary
    assert CheckpointManager(tmp_path / "ck").latest_step() == 1


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_straggler_monitor_flags_outliers(impl):
    cls = StragglerMonitor if impl == "port" else JStraggler
    mon = cls(window=16, threshold=2.0, patience=2)
    for s in range(16):
        mon.step_end(s, duration=0.10)
    assert not mon.tripped
    mon.step_end(16, duration=0.5)
    tripped = mon.step_end(17, duration=0.6)
    assert tripped and mon.flagged_steps == [16, 17]


def test_straggler_tolerates_noise_as_the_reference():
    rng = np.random.default_rng(0)
    durations = 0.1 + 0.02 * rng.random(64)
    durations[[20, 40, 41]] = 0.5           # isolated and paired outliers
    mons = [StragglerMonitor(window=16, threshold=2.5, patience=3),
            JStraggler(window=16, threshold=2.5, patience=3)]
    for s, d in enumerate(durations):
        assert mons[0].step_end(s, d) == mons[1].step_end(s, d)
    assert mons[0].flagged_steps == mons[1].flagged_steps == [20, 40, 41]
    assert not mons[0].tripped


def test_train_cli_runs_on_cpu(capsys):
    tlaunch.main(["--arch", "rwkv6-7b", "--steps", "2", "--seq-len", "16",
                  "--global-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] done: 2 steps" in out
