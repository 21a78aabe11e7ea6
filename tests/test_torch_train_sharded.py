"""PyTorch port, sharded training: ``train.steps.make_train_step`` on a
``DeviceMesh`` against the JAX package's sharded step, and the elastic
checkpoint of the sharded train state.

Two subprocesses run side by side, each with its own deadline:

  * the reference on 4 host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the pattern
    of ``tests/test_torch_distributed.py``): ``make_train_step`` on the
    mesh (2, 2) (``data``, ``model``);
  * the port on 4 gloo ranks (``launch.mesh.spawn_ranks``), ``DeviceMesh``
    (2, 2): parameters and optimizer state as DTensors on the rules'
    shardings, ZeRO-1 reduce-scatter, AdamW on each rank's shard, the
    all-gather back.

Reduced ``yi-9b`` (dense, GQA) and ``qwen2-moe-a2.7b`` (MoE: experts over
``data``, dispatch per data shard, qkv biases) in float32, the
reference's weights (PRNGKey(1)) carried over, microbatch 1 and 2, two
steps at warmup learning rates.  Gates (``PERF.md`` §2's float32
training tolerances): each step's loss and ``grad_norm`` relative 1e-5,
every final parameter within 1e-4 of its leaf's largest magnitude (the
zero-initialised qkv biases 1e-3, see ``BIAS_TOL``), every rank's loss
and parameters identical.

The port's ranks also save the sharded state after step 1, restore it on
the same mesh and on (4, 1), and resume: the restored full arrays equal
the saved ones, and the resumed step 2 equals the uninterrupted one bit
for bit; this process restores the same checkpoint onto one device.
Last, ``launch.train.run`` in the ranks (a (4, 1) mesh of its own)
against one process's run, and resumed from its checkpoint.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import leaf_paths  # noqa: E402
from test_torch_transformer import configs, jinit  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "qwen2-moe-a2.7b")
MICRO = (1, 2)
STEPS = 2
B, S = 4, 16
# Each subprocess's deadline.
TIMEOUT_S = 300
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
# The qkv biases start at zero, so after two steps each is a few warmup
# learning rates of Adam updates, m / (sqrt(v) + eps) of gradients whose
# small entries are rounding-sized: one device's port and reference
# already differ by 2.7e-4 of bk's largest entry (qwen2-moe, float32),
# the mesh adding nothing to it.  They are held to 1e-3.
ZERO_INIT, BIAS_TOL = ("bq", "bk", "bv"), 1e-3
BF16_TOL = 0.02

COMMON = textwrap.dedent("""
    import pickle, sys
    import numpy as np

    ARCHS, MICRO, STEPS = %r, %r, %d

    def batches(vocab):
        out = []
        for i in range(STEPS):
            rng = np.random.default_rng(40 + i)
            tok = rng.integers(0, vocab, (%d, %d)).astype(np.int32)
            out.append((tok, np.roll(tok, -1, axis=1)))
        return out
""" % (ARCHS, MICRO, STEPS, B, S))

REF_SCRIPT = COMMON + textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.parallel.compat import make_mesh
    from repro.train import steps as JS

    weights = pickle.load(open(sys.argv[2], "rb"))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"devices": jax.device_count()}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        for mb in MICRO:
            params = jax.tree.map(jnp.asarray, weights[arch])
            step, *_ = JS.make_train_step(cfg, mesh, "train_4k",
                                          microbatch=mb, donate=False)
            opt = JS.init_opt_state(cfg, params)
            losses, norms = [], []
            for i, (tok, tg) in enumerate(batches(cfg.vocab)):
                params, opt, m = step(params, opt,
                                      {"tokens": jnp.asarray(tok),
                                       "targets": jnp.asarray(tg)},
                                      jnp.int32(i + 10))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out[arch, mb] = {
                "losses": losses, "norms": norms,
                "params": [np.asarray(x) for x in jax.tree.leaves(params)]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

PORT_SCRIPT = COMMON + textwrap.dedent("""
    import torch

    def rank_fn(rank, world, weights, ckpt_dir):
        torch.set_num_threads(1)
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import reduced_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import map_specs
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.optim.adamw import tree_leaves
        from repro_torch.parallel import make_mesh
        from repro_torch.train import steps as TS
        import dataclasses
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        out = {"rank": rank}

        def carried(cfg, psh, tree):
            specs = map_specs(lambda s: dataclasses.replace(
                s, dtype=torch.float32), T.model_specs(cfg))
            return TS.shard_tree(params_from_numpy(tree, specs, "cpu"), psh)

        def flat(state):
            # the full arrays of a {params, opt} state, in order
            full = TS.gather_tree(state)
            opt = full["opt"]
            return [x.numpy().copy() for x in tree_leaves(full["params"])
                    + tree_leaves(opt.m) + tree_leaves(opt.v) + [opt.count]]

        def run(cfg, mb, step, params, opt, first=0, save=None):
            losses, norms = [], []
            for i, (tok, tg) in enumerate(batches(cfg.vocab)):
                if i < first:
                    continue
                params, opt, m = step(params, opt,
                                      {"tokens": torch.from_numpy(tok),
                                       "targets": torch.from_numpy(tg)},
                                      i + 10)
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
                if save is not None and i == 0:
                    save.save(1, {"params": params, "opt": opt})
            return params, opt, losses, norms

        for arch in ARCHS:
            cfg = reduced_config(arch)
            for mb in MICRO:
                step, rules, psh, osh = TS.make_train_step(
                    cfg, mesh, "train_4k", microbatch=mb, donate=True)
                params = carried(cfg, psh, weights[arch])
                opt = TS.init_opt_state(cfg, params, osh)
                mgr = CheckpointManager(f"{ckpt_dir}/{arch}-{mb}") \\
                    if mb == 1 else None
                params, opt, losses, norms = run(cfg, mb, step, params, opt,
                                                 save=mgr)
                full = TS.gather_tree(params)
                out[arch, mb] = {
                    "losses": losses, "norms": norms,
                    "params": [x.numpy().copy() for x in tree_leaves(full)],
                    "placements": [str(x.placements)
                                   for x in tree_leaves(params)][:3]}
                if mgr is None:
                    continue
                # resume on the same mesh from step 1
                target = {"params": params, "opt": opt}
                back, at, _ = mgr.restore(target,
                                          shardings={"params": psh,
                                                     "opt": osh})
                saved = flat(back)
                p2, o2, l2, _ = run(cfg, mb, step, back["params"],
                                    back["opt"], first=1)
                out[arch, "resume"] = {
                    "at": at, "saved": saved, "losses": l2,
                    "params": [x.numpy().copy() for x in tree_leaves(
                        TS.gather_tree(p2))],
                    "count": int(o2.count.to_local())}
                # elastic: the same checkpoint onto a (4, 1) mesh
                mesh41 = make_mesh((4, 1), ("data", "model"),
                                   device_type="cpu")
                _, psh41, osh41, _ = TS.state_shardings(cfg, mesh41,
                                                        "train_4k")
                back41, _, _ = mgr.restore(target, shardings={
                    "params": psh41, "opt": osh41})
                out[arch, "elastic"] = {
                    "full": flat(back41),
                    "placements": sorted({str(x.placements) for x in
                                          tree_leaves(back41["params"])})}
        # launch.train.run with the group up and no mesh: a (4, 1) mesh;
        # then 2 steps, a checkpoint, and a resumed run to step 3
        from repro_torch.launch.train import run
        common = dict(arch="yi-9b", seq_len=16, global_batch=8,
                      log_every=100, device="cpu")
        full = run(steps=3, **common)
        run(steps=2, ckpt_dir=f"{ckpt_dir}/run", save_every=2, **common)
        resumed = run(steps=3, ckpt_dir=f"{ckpt_dir}/run", save_every=2,
                      resume=True, **common)
        out["run"] = {
            "losses": full["losses"], "final_step": resumed["final_step"],
            "mesh": str(tree_leaves(full["params"])[0].device_mesh),
            "params": [x.float().numpy() for x in tree_leaves(
                TS.gather_tree(full["params"]))],
            "resumed": [x.float().numpy() for x in tree_leaves(
                TS.gather_tree(resumed["params"]))]}
        return out

    if __name__ == "__main__":
        from repro_torch.launch.mesh import spawn_ranks
        weights = pickle.load(open(sys.argv[2], "rb"))
        res = spawn_ranks(rank_fn, 4, (weights, sys.argv[3]),
                          timeout=%d)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
""" % (TIMEOUT_S - 30))


def _weights() -> dict:
    """The reference's float32 weights of each arch (PRNGKey(1)), as
    nested dicts of numpy arrays."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = configs(arch)
        jp = jinit(JT.model_specs(jcfg), jax.random.PRNGKey(1))
        out[arch] = jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return out


def _run_both(tmp: Path) -> tuple[dict, list]:
    wpath = tmp / "weights.pkl"
    with open(wpath, "wb") as f:
        pickle.dump(_weights(), f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = {}
    for side, script, extra in (("ref", REF_SCRIPT, []),
                                ("port", PORT_SCRIPT, [str(tmp / "ckpt")])):
        path = tmp / f"{side}_script.py"
        path.write_text(script)
        procs[side] = subprocess.Popen(
            [sys.executable, str(path), str(tmp / f"{side}.pkl"),
             str(wpath), *extra], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT_S
    errors = {}
    for side, proc in procs.items():
        try:
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            proc.communicate()
            raise AssertionError(f"{side} subprocess outlived {TIMEOUT_S} s")
        if proc.returncode != 0:
            errors[side] = err[-4000:]
    assert not errors, errors
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    ref, port = _run_both(tmp)
    return ref, port, tmp


CASES = [(a, mb) for a in ARCHS for mb in MICRO]


def _names(arch):
    return ["/".join(p) for p, _ in leaf_paths(TT.model_specs(
        configs(arch)[1]))]


def test_four_devices_and_ranks(runs):
    ref, port, _ = runs
    assert ref["devices"] == 4
    assert [r["rank"] for r in port] == [0, 1, 2, 3]


@pytest.mark.parametrize("arch,mb", CASES)
def test_losses_and_grad_norms_match_reference(runs, arch, mb):
    ref, port, _ = runs
    want = ref[arch, mb]
    for r in port:
        got = r[arch, mb]
        # every rank's loss is the same number
        assert got["losses"] == port[0][arch, mb]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=LOSS_TOL)


@pytest.mark.parametrize("arch,mb", CASES)
def test_parameters_match_reference(runs, arch, mb):
    ref, port, _ = runs
    want = ref[arch, mb]["params"]
    got = port[0][arch, mb]["params"]
    assert len(want) == len(got)
    for name, a, b in zip(_names(arch), want, got):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (np.abs(a).max() + 1e-30)
        tol = BIAS_TOL if name.rsplit("/", 1)[-1] in ZERO_INIT else PARAM_TOL
        assert err <= tol, (name, err)
    for r in port[1:]:       # the all-gather leaves every rank the same
        for a, b in zip(got, r[arch, mb]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_live_as_dtensors_on_the_rules(runs, arch):
    _, port, _ = runs
    pl = port[0][arch, 1]["placements"]
    assert all(p.startswith("(") for p in pl)
    assert any("Shard" in p for p in pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_from_step_one_is_bit_exact(runs, arch):
    _, port, _ = runs
    for r in port:
        res, full = r[arch, "resume"], r[arch, 1]
        assert res["at"] == 1 and res["count"] == STEPS
        assert res["losses"] == full["losses"][1:]
        for a, b in zip(res["params"], full["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_restore_onto_4x1_and_one_device(runs, arch):
    _, port, tmp = runs
    saved = port[0][arch, "resume"]["saved"]
    for r in port:
        for a, b in zip(r[arch, "elastic"]["full"], saved):
            np.testing.assert_array_equal(a, b)
    assert any("Shard(dim=0)" in p
               for p in port[0][arch, "elastic"]["placements"])
    # one process, no mesh: the same full arrays
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import steps as TS
    _, tcfg = configs(arch)
    import dataclasses
    from repro_torch.models.common import map_specs
    specs = map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32),
                      TT.model_specs(tcfg))
    params = map_specs(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs)
    target = {"params": params, "opt": TS.init_opt_state(tcfg, params)}
    back, at, _ = CheckpointManager(tmp / "ckpt" / f"{arch}-1").restore(
        target)
    assert at == 1
    for a, b in zip(tree_leaves(back["params"]) + tree_leaves(back["opt"].m)
                    + tree_leaves(back["opt"].v)
                    + [back["opt"].count], saved):
        np.testing.assert_array_equal(a.numpy(), b)


def test_launch_train_run_on_four_ranks(runs):
    """``launch.train.run`` with a process group and no mesh trains on a
    (world, 1) mesh: its losses match one process's run (1e-5) and its
    final bf16 parameters within 0.02, and a run resumed from its step-2
    checkpoint ends on the uninterrupted run's parameters bit for bit."""
    from repro_torch.launch.train import run
    from repro_torch.optim.adamw import tree_leaves
    _, port, _ = runs
    one = run("yi-9b", steps=3, seq_len=16, global_batch=8, log_every=100,
              device="cpu")
    got = port[0]["run"]
    assert "(data=4, model=1)" in got["mesh"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_TOL)
    for a, b in zip(tree_leaves(one["params"]), got["params"]):
        a = a.float().numpy()           # bf16 weights: the reference's TOL
        assert np.abs(a - b).max() <= BF16_TOL * np.abs(a).max()
    assert got["final_step"] == 3
    for r in port:
        assert r["run"]["losses"] == got["losses"]
        for a, b in zip(r["run"]["resumed"], got["params"]):
            np.testing.assert_array_equal(a, b)
