"""PyTorch port, ``models.moe`` against the JAX package's
``repro.models.moe`` on the same numpy-seeded inputs and weights.

``moe_apply`` with drops (capacity factor 1.25 and a skewed router), with
no drop (capacity factor E / k), with padded experts (6 routed experts
padded to 8), and the shared expert and the dense residual through the
transformer's ``_apply_mlp`` (``qwen2-moe-a2.7b`` and ``arctic-480b`` at
``reduced_config``).  Outputs are held to the reference at 1e-5 relative
(max abs difference over max abs) in float32 and 0.02 in bf16; the kept
(token, expert) slots must equal the reference's exactly, ties in the
router's probabilities included.  Also the expert-placement example's
port against the JAX example.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import leaf_paths, set_leaf  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 0.02}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel(want, got):
    a = np.asarray(jnp.asarray(want).astype(jnp.float32))
    b = got.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)


def rounded(a, dtype):
    """float32 numpy values already rounded to ``dtype``."""
    return np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


def carry(tspecs, seed, dtype, scale=None):
    """(reference's, port's) parameter trees of the same values, drawn
    from numpy: normal times each spec's scale (``scale`` overrides it
    per leaf name), in the spec's dtype (float32 leaves stay float32),
    or float32 throughout when ``dtype`` is float32."""
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for path, s in leaf_paths(tspecs):
        sc = (scale or {}).get(path[-1], s.scale)
        a = (rng.standard_normal(s.shape) * sc).astype(np.float32)
        dt = "float32" if s.dtype == torch.float32 else dtype
        a = rounded(a, dt)
        set_leaf(jt, path, jnp.asarray(a, JDT[dt]))
        set_leaf(tt, path, torch.from_numpy(a).to(TDT[dt]))
    return jt, tt


def inputs(shape, dtype, seed, shift=0.0):
    """x of ``shape``: normal draws plus ``shift`` (a common component
    that skews every token toward the same experts)."""
    a = rounded(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) + shift, dtype)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def ref_dispatch(jp, x, *, n_experts, n_experts_padded, top_k,
                 capacity_factor):
    """The reference's routing and dispatch at one data shard, line for
    line (src/repro/models/moe.py, ``moe_apply``): (expert ids (T, k),
    slot, keep)."""
    t, d = x.shape[0] * x.shape[1], x.shape[2]
    e = n_experts_padded
    xt = x.reshape(t, d)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), jp["router"])
    if n_experts < e:
        logits = jnp.where((jnp.arange(e) >= n_experts)[None, :], -1e30,
                           logits)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    cap = int(max(8, -(-t * top_k * capacity_factor // e)))
    flat_e = expert_idx.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = jnp.arange(flat_e.size) - jnp.searchsorted(sorted_e, sorted_e,
                                                     side="left")
    keep = pos < cap
    slot = jnp.where(keep, sorted_e * cap + pos, e * cap)
    return (np.asarray(expert_idx), np.asarray(slot), np.asarray(keep))


# (name, (B, S, d), ff, n_experts, padded, top_k, capacity factor,
#  router scale, input shift): at 1.25 skewed routing drops entries; at
#  E / k no entry can drop
CASES = {
    "drops": ((4, 64, 32), 48, 8, 8, 2, 1.25, 1.0, 1.0),
    "no_drops": ((4, 64, 32), 48, 8, 8, 2, 4.0, 1.0, 1.0),
    "padded": ((2, 40, 32), 48, 6, 8, 2, 1.25, 0.3, 0.0),
    "top4": ((3, 24, 64), 32, 12, 16, 4, 1.25, 0.02, 0.0),
}


def port(name, dtype):
    shape, ff, n, e, k, cf, rscale, shift = CASES[name]
    specs = tmoe.moe_specs(shape[2], ff, e)
    jp, tp = carry(specs, 11, dtype, scale={"router": rscale, "gate": 0.2,
                                            "up": 0.2, "down": 0.2})
    jx, tx = inputs(shape, dtype, 12, shift)
    kw = dict(n_experts=n, n_experts_padded=e, top_k=k, capacity_factor=cf)
    return jp, tp, jx, tx, kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(name, dtype):
    jp, tp, jx, tx, kw = port(name, dtype)
    want = jmoe.moe_apply(jp, jx, **kw)
    got = tmoe.moe_apply(tp, tx, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    assert rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_keeps_the_reference_slots(name, dtype):
    """Expert choice, sort order, capacity and the kept slots equal the
    reference's exactly; every case at 1.25 drops entries, and none
    drops at E / k."""
    jp, tp, jx, tx, kw = port(name, dtype)
    want_idx, want_slot, want_keep = ref_dispatch(jp, jx, **kw)
    t = tx.shape[0] * tx.shape[1]
    gates, idx = tmoe.moe_route(tp, tx.reshape(t, -1),
                                n_experts=kw["n_experts"], top_k=kw["top_k"])
    assert np.array_equal(idx.numpy(), want_idx)
    cap = tmoe.capacity(t, kw["top_k"], kw["n_experts_padded"],
                        kw["capacity_factor"])
    _, slot, keep = tmoe.moe_dispatch(idx, kw["n_experts_padded"], cap)
    assert np.array_equal(keep.numpy(), want_keep)
    assert np.array_equal(slot.numpy(), want_slot)
    assert bool((~keep).any()) == (name != "no_drops")
    assert (idx < kw["n_experts"]).all()          # padded experts unused
    assert torch.allclose(gates.sum(-1), torch.ones(t), atol=1e-6)


@pytest.mark.parametrize("t,d,cf", [(128, 32, 1.25), (7, 16, 1.25),
                                    (1000, 8, 1.1), (4, 8, 16.0)])
def test_capacity_is_the_reference_formula(t, d, cf):
    for k, e in ((2, 8), (4, 64), (2, 128)):
        assert tmoe.capacity(t, k, e, cf) == int(
            max(8, -(-t * k * cf // e)))


def test_top_k_ties_resolve_lowest_index_first():
    """Identical router columns tie exactly: the reference's top_k takes
    the lower expert index first, and so must the port."""
    d, e, k = 16, 8, 2
    jp, tp = carry(tmoe.moe_specs(d, 8, e), 3, "float32",
                   scale={"router": 1.0})
    r = np.array(jp["router"])
    r[:, 5] = r[:, 2]
    r[:, 7] = r[:, 2]
    r[:, 6] = r[:, 1]
    jp["router"], tp["router"] = jnp.asarray(r), torch.from_numpy(r)
    jx, tx = inputs((2, 16, d), "float32", 4)
    want_idx, want_slot, _ = ref_dispatch(
        jp, jx, n_experts=e, n_experts_padded=e, top_k=k,
        capacity_factor=1.25)
    _, idx = tmoe.moe_route(tp, tx.reshape(32, d), n_experts=e, top_k=k)
    assert np.array_equal(idx.numpy(), want_idx)
    # some token's two picks are a tied pair
    tied = [{2, 5}, {2, 7}, {5, 7}, {1, 6}]
    assert any(set(row) in tied for row in want_idx.tolist())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_expert_matches_reference(dtype):
    specs = tmoe.shared_expert_specs(32, 40)
    jp, tp = carry(specs, 5, dtype, scale={"gate_proj": 0.3, "gate": 0.2,
                                           "up": 0.2, "down": 0.2})
    jx, tx = inputs((2, 9, 32), dtype, 6)
    want = jmoe.shared_expert_apply(jp, jx)
    got = tmoe.shared_expert_apply(tp, tx)
    assert got.dtype == TDT[dtype]
    assert rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,extra", [("qwen2-moe-a2.7b", "shared"),
                                        ("arctic-480b", "dense2"),
                                        ("qwen2-moe-a2.7b+padded", "shared")])
def test_moe_layer_mlp_matches_reference(arch, extra, dtype):
    """The MoE layer's MLP (norm, routed experts, plus the shared expert
    or the dense residual) through both transformers' ``_apply_mlp``;
    ``+padded``: 6 routed experts padded to 8."""
    name, _, variant = arch.partition("+")
    jcfg, tcfg = jconfigs.reduced_config(name), tconfigs.reduced_config(name)
    if variant:
        kw = dict(moe_experts=6, moe_experts_padded=8)
        jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    specs = TT._layer_specs(tcfg, "attn", "moe")
    assert extra in specs
    jp, tp = carry(specs, 7, dtype, scale={"router": 0.5})
    jx, tx = inputs((2, 12, tcfg.d_model), dtype, 8)
    want = JT._apply_mlp(jcfg, "moe", jp, jx)
    got = TT._apply_mlp(tcfg, "moe", tp, tx)
    assert rel(want, got) < TOL[dtype]


def _example(name):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_expert_placement_example_matches_reference(capsys):
    """examples/moe_expert_placement_torch.py on the CPU: the same router
    statistics, the same communities as the JAX example's GSL-LPA, and
    the same report (edges, communities, disconnected share, and the
    placement's cross-device cost against a random placement)."""
    jex = _example("moe_expert_placement")
    tex = _example("moe_expert_placement_torch")
    co, truth = tex.simulate_router_stats()
    jco, jtruth = jex.simulate_router_stats()
    assert np.array_equal(co, jco) and np.array_equal(truth, jtruth)
    e = np.argwhere(np.triu(co, 1) > 0)
    jg = jex.build_graph(e, co[e[:, 0], e[:, 1]].astype(np.float32),
                         n=co.shape[0])
    want = jex.gsl_lpa(jg, split="lp").labels
    got = tex.gsl_lpa(tex.coactivation_graph(co, "cpu"), split="lp",
                      device="cpu").labels
    assert np.array_equal(np.asarray(want), got)
    device_of = tex.pack(got)
    assert sorted(np.bincount(device_of).tolist()) == [8] * 8
    jex.main()
    want_out = capsys.readouterr().out
    tex.main(["--device", "cpu"])
    assert capsys.readouterr().out == want_out
    assert "disconnected=0%" in want_out
