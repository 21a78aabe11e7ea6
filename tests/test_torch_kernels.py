"""PyTorch port, kernel layer: the plain versions of the four LPA kernels
(the CPU path of ``repro_torch.kernels.ops``) against the JAX package's
kernels in ``mode="ref"`` and Pallas ``mode="interpret"``, on the same
numpy-seeded inputs; plus the wrappers' checks and the CUDA build's C
interface.

The port's kernels gather per-vertex vectors through ``nbr`` themselves, so
the JAX side gets the gathered tiles ``labels[nbr]`` (``chg[nbr]``,
``comm[nbr]``) and the rows' own values ``labels[:rows]``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.lpa import _label_hash as jax_label_hash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

SENTINEL = 2147483647


def make_case(rows, d, seed, integer=True):
    """Neighbor tiles and per-vertex state, with the edge cases: an
    edgeless row, a self-pointing masked row, rows whose own label is
    absent from their neighborhood."""
    rng = np.random.default_rng(seed)
    n_labels = max(rows // 2, 2)
    nbr = rng.integers(0, rows, size=(rows, d)).astype(np.int32)
    labels = rng.integers(0, n_labels, size=rows).astype(np.int32)
    absent = np.arange(1, rows, 7)
    labels[absent] = n_labels + 1 + np.arange(len(absent))
    mask = rng.random((rows, d)) < 0.8
    mask[0] = False
    if rows > 2:
        mask[2] = False
        nbr[2] = 2
    w = (rng.integers(1, 5, size=(rows, d)) if integer
         else rng.uniform(0.1, 5.0, size=(rows, d))).astype(np.float32)
    comm = rng.integers(0, 4, size=rows).astype(np.int32)
    chg = rng.random(rows) < 0.3
    active, cand_prev, klass = (rng.random(rows) < p for p in (0.6, .4, .7))
    real = np.ones(rows, dtype=bool)
    real[-max(rows // 8, 1):] = False
    return dict(nbr=nbr, nw=w, nmask=mask, labels=labels, comm=comm,
                chg=chg, active=active, cand_prev=cand_prev, klass=klass,
                real=real)


def T(case):
    return {k: torch.from_numpy(v) for k, v in case.items()}


def J(case):
    """The JAX kernels' operands: gathered tiles plus own-row columns."""
    nbr, rows = case["nbr"], case["nbr"].shape[0]
    lab = case["labels"]
    return dict(nbr_lab=jnp.asarray(lab[nbr]), nw=jnp.asarray(case["nw"]),
                mask=jnp.asarray(case["nmask"]),
                cur=jnp.asarray(lab[:rows]),
                nbr_comm=jnp.asarray(case["comm"][nbr]),
                self_comm=jnp.asarray(case["comm"][:rows]),
                chg_nbr=jnp.asarray(case["chg"][nbr]),
                active=jnp.asarray(case["active"]),
                cand_prev=jnp.asarray(case["cand_prev"]),
                klass=jnp.asarray(case["klass"]),
                real=jnp.asarray(case["real"]))


def same(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 1, 12345, -1, 2**31 - 1, 7])
def test_label_hash_matches_reference(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    x = rng.integers(-2**31, 2**31, size=5000).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    want = jax_label_hash(jnp.asarray(x), jnp.int32(seed))
    got = ref.label_hash(torch.from_numpy(x), seed)
    assert got.dtype == torch.int32
    assert same(want, got)


@pytest.mark.parametrize("mode,shape", [
    ("ref", (8, 128)), ("ref", (40, 128)), ("ref", (24, 3)), ("ref", (9, 1)),
    ("interpret", (8, 128)), ("interpret", (16, 128)),
    ("interpret", (8, 256)), ("interpret", (40, 128)),
    ("ref", (12, 64)), ("ref", (5, 512))])
@pytest.mark.parametrize("seed", [0, 3])
def test_label_argmax_matches_reference(mode, shape, seed):
    """Integer weights: per-label sums are exact in any order, so labels
    and weights are equal, for every tie-break seed."""
    case = make_case(*shape, seed)
    t, j = T(case), J(case)
    for s in (0, 1, 12345, -1):
        got = ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], s)
        want = jops.label_argmax(j["nbr_lab"], j["nw"], j["mask"], j["cur"],
                                 s, mode=mode)
        for a, b in zip(want, got):
            assert same(a, b), (shape, seed, s)
        assert int(got[0][0]) == SENTINEL and float(got[1][0]) == 0.0


@pytest.mark.parametrize("shape", [(24, 3), (40, 4), (12, 64), (5, 512)])
@pytest.mark.parametrize("seed", [0, 3])
def test_label_argmax_slot_order_matches_reference(shape, seed):
    """``ref.label_argmax_slot_order``, the sum the card holds the kernels
    to: on integer weights it equals the JAX package's label_argmax; on
    real weights each label's sum is the left fold of its slots in slot
    order from 0.0, to the last bit."""
    case = make_case(*shape, seed)
    t, j = T(case), J(case)
    for s in (0, 12345):
        got = ref.label_argmax_slot_order(t["nbr"], t["nw"], t["nmask"],
                                          t["labels"], s)
        want = jops.label_argmax(j["nbr_lab"], j["nw"], j["mask"], j["cur"],
                                 s, mode="ref")
        for a, b in zip(want, got):
            assert same(a, b), (shape, seed, s)
    case = make_case(*shape, seed, integer=False)
    t = T(case)
    bl, bw, cw = (x.numpy() for x in ref.label_argmax_slot_order(
        t["nbr"], t["nw"], t["nmask"], t["labels"], 7))
    lab = case["labels"][case["nbr"]]
    for row in range(shape[0]):
        sums = {}
        for k in np.flatnonzero(case["nmask"][row]):
            sums[lab[row, k]] = np.float32(sums.get(lab[row, k], 0.0)
                                           + case["nw"][row, k])
        best = max(sums.values(), default=np.float32(0.0))
        cur = sums.get(case["labels"][row], np.float32(0.0))
        assert bw[row].view(np.int32) == best.view(np.int32), row
        assert cw[row].view(np.int32) == cur.view(np.int32), row
        assert (bl[row] == SENTINEL if not sums else sums[bl[row]] == best)


@pytest.mark.parametrize("mode,shape", [
    ("ref", (8, 128)), ("ref", (10, 5)), ("ref", (16, 640)),
    ("interpret", (8, 128)), ("interpret", (48, 256)),
    ("interpret", (16, 640)),
    # the widths the CUDA kernel's paths split on: narrow 1..8, wide 9..
    ("ref", (10, 2)), ("ref", (10, 8)), ("ref", (10, 9)),
    ("interpret", (10, 2)), ("interpret", (10, 5)), ("interpret", (10, 8)),
    ("interpret", (10, 9))])
def test_min_label_matches_reference(mode, shape):
    case = make_case(*shape, seed=1)
    t, j = T(case), J(case)
    got = ops.min_label(t["nbr"], t["nmask"], t["labels"], t["comm"])
    want = jops.min_label(j["nbr_lab"], j["nbr_comm"], j["mask"], j["cur"],
                          j["self_comm"], mode=mode)
    assert same(want, got)


@pytest.mark.parametrize("mode,shape", [
    ("ref", (8, 128)), ("ref", (12, 7)), ("interpret", (8, 128)),
    ("interpret", (16, 256)), ("ref", (12, 64)), ("ref", (5, 512))])
@pytest.mark.parametrize("seed", [0, 3])
def test_fused_move_matches_reference(mode, shape, seed):
    case = make_case(*shape, seed)
    t, j = T(case), J(case)
    for s in (0, 1, 12345, -1):
        new, act = ops.fused_move(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                  t["chg"], t["active"], t["cand_prev"],
                                  t["klass"], t["real"], s)
        jnew, jact = jops.fused_move(j["nbr_lab"], j["nw"], j["mask"],
                                     j["chg_nbr"], j["cur"], j["active"],
                                     j["cand_prev"], j["klass"], j["real"],
                                     s, mode=mode)
        assert same(jnew, new) and same(jact, act), (shape, seed, s)
        assert int(new[0]) == case["labels"][0]   # edgeless row never moves


@pytest.mark.parametrize("mode,shape", [
    ("ref", (8, 128)), ("ref", (9, 6)), ("interpret", (8, 128)),
    ("interpret", (48, 256)),
    # the widths the CUDA kernel's paths split on: narrow 1..8, wide 9..
    ("ref", (10, 2)), ("ref", (10, 5)), ("ref", (10, 8)), ("ref", (10, 9)),
    ("interpret", (10, 2)), ("interpret", (10, 5)), ("interpret", (10, 8)),
    ("interpret", (10, 9))])
@pytest.mark.parametrize("prune", [True, False])
def test_fused_split_matches_reference(mode, shape, prune):
    case = make_case(*shape, seed=7)
    for chg in (np.ones(shape[0], dtype=bool), case["chg"]):
        case["chg"] = chg
        t, j = T(case), J(case)
        got = ops.fused_split(t["nbr"], t["nmask"], t["labels"], t["comm"],
                              t["chg"], prune)
        want = jops.fused_split(j["nbr_lab"], j["nbr_comm"], j["mask"],
                                j["chg_nbr"], j["cur"], j["self_comm"],
                                prune=prune, mode=mode)
        assert same(want, got), (shape, prune, bool(chg.all()))


@pytest.mark.parametrize("shape", [(16, 4), (32, 33), (8, 130)])
def test_fused_equals_unfused_composition(shape):
    """fused_move == label_argmax + the tile backend's glue, and
    fused_split == min_label (+ wake), bit for bit, real weights too."""
    case = make_case(*shape, seed=5, integer=False)
    t = T(case)
    for s in (0, 1, -1):
        new, act = ops.fused_move(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                  t["chg"], t["active"], t["cand_prev"],
                                  t["klass"], t["real"], s)
        bl, bw, cw = ops.label_argmax(t["nbr"], t["nw"], t["nmask"],
                                      t["labels"], s)
        wake = (t["chg"][t["nbr"]] & t["nmask"]).any(dim=1)
        act_sep = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
        adopt = act_sep & t["klass"] & (bw > cw.clamp_min(0.0))
        assert torch.equal(act, act_sep)
        assert torch.equal(new, torch.where(adopt, bl, t["labels"]))
    m = ops.min_label(t["nbr"], t["nmask"], t["labels"], t["comm"])
    ones = torch.ones_like(t["chg"])
    assert torch.equal(ops.fused_split(t["nbr"], t["nmask"], t["labels"],
                                       t["comm"], t["chg"], False), m)
    assert torch.equal(ops.fused_split(t["nbr"], t["nmask"], t["labels"],
                                       t["comm"], ones, True), m)


def test_labels_vector_longer_than_rows():
    """Neighbor ids may index past the tile's rows (halo vertices)."""
    case = make_case(12, 5, seed=2)
    lab = np.concatenate([case["labels"], np.arange(100, 120,
                                                    dtype=np.int32)])
    nbr = case["nbr"].copy()
    nbr[:, 0] = 12 + np.arange(12)
    wide = dict(case, labels=lab, nbr=nbr,
                comm=np.resize(case["comm"], 32), chg=np.resize(case["chg"], 32))
    t, j = T(wide), J(wide)
    got = ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], 1)
    want = jops.label_argmax(j["nbr_lab"], j["nw"], j["mask"], j["cur"], 1,
                             mode="ref")
    for a, b in zip(want, got):
        assert same(a, b)


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 70), st.integers(0, 99_999),
       st.integers(-2**31, 2**31 - 1))
def test_label_argmax_brute_force_property(rows, d, data_seed, seed):
    """Real weights: the best weight is the true per-label maximum (rtol
    1e-5, float32 sums in another order), the chosen label reaches it, and
    the current weight is the own label's sum."""
    case = make_case(rows, d, data_seed, integer=False)
    t = T(case)
    bl, bw, cw = (x.numpy() for x in ops.label_argmax(
        t["nbr"], t["nw"], t["nmask"], t["labels"], seed))
    lab = case["labels"][case["nbr"]]
    for i in range(rows):
        acc = {}
        for j in np.flatnonzero(case["nmask"][i]):
            acc[lab[i, j]] = acc.get(lab[i, j], 0.0) + float(case["nw"][i, j])
        if not acc:
            assert bw[i] == 0.0 and bl[i] == SENTINEL
            continue
        best = max(acc.values())
        np.testing.assert_allclose(bw[i], best, rtol=1e-5)
        assert bl[i] in acc
        np.testing.assert_allclose(acc[bl[i]], best, rtol=1e-5)
        np.testing.assert_allclose(cw[i], acc.get(case["labels"][i], 0.0),
                                   rtol=1e-5)


# --- wrappers: dispatch and input checks -------------------------------

def test_cpu_path_launches_nothing():
    ops.reset_launches()
    t = T(make_case(8, 4, seed=0))
    ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], 0)
    ops.min_label(t["nbr"], t["nmask"], t["labels"], t["comm"])
    q, kv = torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 1, 64))
    ops.flash_attention(q, kv, kv, causal=True)
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontig", "short",
                                 "empty_width"])
def test_wrappers_reject_bad_inputs(bad):
    t = T(make_case(8, 4, seed=0))
    nbr, nw, nmask, labels = t["nbr"], t["nw"], t["nmask"], t["labels"]
    if bad == "dtype":
        nbr = nbr.long()
    elif bad == "shape":
        nw = nw[:, :3].contiguous()
    elif bad == "noncontig":
        nbr = torch.empty((4, 8), dtype=torch.int32).t()
        nw = nw[:, :].t().contiguous().t()
    elif bad == "short":
        labels = labels[:5]
    else:
        nbr = nbr[:, :0]
        nw, nmask = nw[:, :0], nmask[:, :0]
    with pytest.raises(ValueError):
        ops.label_argmax(nbr, nw, nmask, labels, 0)


def test_wrapper_vector_checks():
    t = T(make_case(8, 4, seed=0))
    with pytest.raises(ValueError):
        ops.min_label(t["nbr"], t["nmask"], t["labels"], t["comm"][:7])
    with pytest.raises(ValueError):
        ops.fused_split(t["nbr"], t["nmask"], t["labels"], t["comm"],
                        t["chg"].int(), True)
    with pytest.raises(ValueError):
        ops.fused_move(t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                       t["active"][:4], t["cand_prev"], t["klass"],
                       t["real"], 0)


def test_resolve_fuse():
    assert ops.resolve_fuse("auto", "cpu") is False
    assert ops.resolve_fuse("auto", torch.device("cuda")) is True
    assert ops.resolve_fuse("on", "cpu") is True
    assert ops.resolve_fuse("off", "cuda") is False
    with pytest.raises(ValueError):
        ops.resolve_fuse("sometimes", "cpu")


def test_seed_wraps_to_int32():
    assert ops._seed32(-1) == -1
    assert ops._seed32(2**32 - 1) == -1
    assert ops._seed32(2**31) == -2**31
    assert ops._seed32(12345) == 12345


# --- the CUDA build, checked without a compiler -------------------------

_C_ENTRY = re.compile(r'extern "C" int ((?:lpa|attn)_\w+)\(([^)]*)\)', re.S)
LPA_SOURCES = ("label_argmax.cu", "min_label.cu", "fused_move.cu",
               "fused_split.cu")


def test_c_entry_points_match_ctypes_signatures():
    """Every C entry point has the argument count its ctypes binding
    declares (a mismatch would pass pointers in the wrong slots); the LPA
    sources share ``lpa_common.cuh``, B5 and B5-bwd ``hopper_common.cuh``,
    and the build hash covers both."""
    assert set(LPA_SOURCES) < set(build.SOURCES)
    found = {}
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        for name, params in _C_ENTRY.findall(text):
            found[name] = len([p for p in params.split(",") if p.strip()])
        if src in LPA_SOURCES:
            assert '#include "lpa_common.cuh"' in text, src
        if src.startswith("flash_attention"):
            assert '#include "hopper_common.cuh"' in text, src
    assert {"lpa_common.cuh", "hopper_common.cuh"} <= set(build.HEADERS)
    assert set(found) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert found[name] == len(argtypes), name


def test_bwd_scratch_tile_matches_kernel():
    """ops sizes B5-bwd's bf16 scratch by the kernel's query-tile height:
    ``_BWD_QROWS`` is ``kBM`` of flash_attention_bwd.cu."""
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    found = re.findall(r"constexpr int kBM = (\d+);", text)
    assert found == [str(ops._BWD_QROWS)]


def test_source_notes_name_the_tpu_kernel():
    replaced = {"label_argmax.cu": "label_argmax.py:label_argmax_pallas",
                "min_label.cu": "min_label.py:min_label_pallas",
                "fused_move.cu": "fused_sweep.py:fused_move_pallas",
                "fused_split.cu": "fused_sweep.py:fused_split_pallas",
                "flash_attention.cu":
                    "flash_attention.py:flash_attention_pallas"}
    for src, tpu in replaced.items():
        head = (build.CSRC / src).read_text()[:1500]
        assert tpu in head and "Bound on the card" in head, src


def test_build_hash_and_ptxas_parse():
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119label_argmax_kernelEPKi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119label_argmax_kernelEPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_PtNS_5ShapeE' for 'sm_90a'
    0 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the wgmma pipeline in the function '_ZN12_GLOBAL__N_118flash_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_PtNS_5ShapeE'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_PtNS_5ShapeE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123min_label_narrow_kernelILi4EEEvPKiPKhS2_S2_xPi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124fused_split_wide_kernelILb0EEEvPKiPKhS2_S2_S4_xiiPi' for 'sm_90a'
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125fused_split_narrow_kernelILi8ELb1EEEvPKiPKhS2_S2_S4_xPi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 0 barriers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121min_label_wide_kernelEPKiPKhS1_S1_xiiPi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116bwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfPtS4_PfPiNS_5ShapeE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dq_cast_kernelILi64EEEvPK6float4PtNS_5ShapeE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert build._resources(log) == {
        "min_label_narrow<4>": {"spill_store_bytes": 0,
                                "spill_load_bytes": 0, "registers": 26},
        "fused_split_wide<false>": {"spill_store_bytes": 4,
                                    "spill_load_bytes": 4, "registers": 40},
        "fused_split_narrow<8, true>": {"spill_store_bytes": 0,
                                        "spill_load_bytes": 0,
                                        "registers": 38},
        "min_label_wide": {"spill_store_bytes": 0, "spill_load_bytes": 0,
                           "registers": 32},
        "bwd_wgmma<128>": {"spill_store_bytes": 0, "spill_load_bytes": 0,
                           "registers": 168},
        "dq_cast<64>": {"spill_store_bytes": 0, "spill_load_bytes": 0,
                        "registers": 26},
        "label_argmax": {"spill_store_bytes": 0, "spill_load_bytes": 0,
                         "registers": 30},
        "flash_wgmma<128>": {"spill_store_bytes": 20, "spill_load_bytes": 20,
                             "registers": 168},
        "flash_wgmma<64>": {
            "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 168,
            "wgmma_serialized": "due to insufficient register resources "
                                "for the wgmma pipeline"}}


def _sp_part(q, k, v, lo, hi, length, window, scales):
    """One sequence-parallel rank's B5 call over cache rows lo .. hi - 1
    (the decode query at position length - 1), as
    ``models.attention._attend_on_mesh`` makes it: (out, lse), zeros and
    -inf for a rank with no visible row, which launches nothing."""
    first = 0 if window is None else max(0, length - window)
    a, e = max(first, lo) - lo, min(length, hi) - lo
    if e <= a:
        return (torch.zeros_like(q), torch.full(
            (q.shape[0], q.shape[2], 1), float("-inf")))
    ks = vs = None
    if scales is not None:
        ks, vs = (t[:, lo:hi].contiguous() for t in scales)
    return ops.flash_attention_fwd(
        q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), causal=True,
        kv_len=e, window=window, q_offset=length - 1 - lo, k_scale=ks,
        v_scale=vs)


@settings(max_examples=40, deadline=None)
@given(cuts=st.lists(st.integers(0, 48), max_size=4),
       length=st.integers(1, 48),
       window=st.one_of(st.none(), st.integers(1, 60)), int8=st.booleans(),
       seed=st.integers(0, 2**16))
def test_lse_merge_of_any_key_split_is_the_whole_attention(cuts, length,
                                                           window, int8,
                                                           seed):
    """Keys split into shards at any points (empty shards included), each
    shard's B5 call with its lse, merged by lse (``parallel.compat.
    lse_merge``, what ``lse_combine`` all-reduces across ranks): the
    attention over every key, within float32 rounding."""
    from repro_torch.models.attention import quantize_kv
    from repro_torch.parallel.compat import lse_merge
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 1, 4, 64, generator=g)
    k, v = (torch.randn(2, 48, 2, 64, generator=g) for _ in range(2))
    scales = None
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    kw = dict(causal=True, kv_len=length, window=window,
              q_offset=length - 1, k_scale=None if scales is None
              else scales[0], v_scale=None if scales is None else scales[1])
    whole = ops.flash_attention(q, k, v, **kw)
    bounds = [0, *sorted(cuts), 48]
    parts = [_sp_part(q, k, v, lo, hi, length, window, scales)
             for lo, hi in zip(bounds, bounds[1:])]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([s for _, s in parts])

    def over_parts(t, op):
        return t.sum(0) if op == "sum" else t.amax(0)
    got = lse_merge(outs, lses, over_parts)
    assert torch.allclose(got, whole, atol=1e-5, rtol=1e-5)
