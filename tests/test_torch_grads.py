"""PyTorch port, LM training gradients: ``jax.grad`` of the reference's
``loss_fn`` against autograd through the port's, one arch per family, in
float32 (the reference's weights upcast, carried over with
``params_from_numpy``), every parameter leaf within 1e-4 (max abs
difference over max abs).

The encoder-decoder's encoder input is bf16 by design (``encode`` casts
its frames), so its first layer's norm output is bf16 and so is the
cotangent that reaches that norm: both frameworks round a float32 sum to
bf16 there, and a sum a last bit apart can round to the neighbouring
value.  The two leaves behind that cast, ``enc_groups/0/norm1``, are held
to one bf16 ulp (2**-8) instead.  The reference's float32 encoder runs
with its scan written as a loop (see ``test_torch_train.py``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from test_torch_train import (  # noqa: E402
    JT,
    _encode_unrolled,
    carried,
    lm_batch,
)

TOL = 1e-4
BF16_ULP = 2.0 ** -8
BEHIND_BF16_CAST = ("['enc_groups']['0']['norm1']",)
FAMILIES = ("yi-9b", "qwen2-moe-a2.7b", "jamba-v0.1-52b", "rwkv6-7b",
            "seamless-m4t-large-v2", "internvl2-26b")


@pytest.mark.parametrize("name", FAMILIES)
def test_grads_match_reference(name, monkeypatch):
    monkeypatch.setattr(JT, "encode", _encode_unrolled)
    jcfg, tcfg, jp, tp = carried(name, "float32")
    jb, tb = lm_batch(tcfg, "float32")
    want_loss, want = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb))(jp)
    loss, got = TS._loss_and_grads(tcfg, tp, tb)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tree_leaves(got))
    for (path, a), b in zip(flat, tree_leaves(got)):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32, key
        err = np.abs(a - b.numpy()).max()
        scale = np.abs(a).max()
        tol = BF16_ULP if key.startswith(BEHIND_BF16_CAST) else TOL
        assert err <= tol * scale or (scale == 0 and err == 0), \
            (key, err / max(scale, 1e-30))
