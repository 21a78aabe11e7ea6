"""Carry a parameter tree from the reference over to the port, exactly.

``params_from_numpy(tree, specs, device)`` takes the reference's parameter
tree as numpy arrays (nested dicts with the same keys as the port's specs,
the stacked ``groups`` layout with its leading ``n_groups`` dimension
included) and returns the port's tree, leaf for leaf, cast to each spec's
dtype.  A bf16 leaf may come as a float32 copy or as its raw 16-bit
pattern (a ``uint16`` / ``int16`` view, or numpy's ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` does not take): both carry the values
exactly.

``caches_from_numpy(tree, device)`` does the same for the reference's
decode caches (``init_decode_caches``' tree, as a prefill or decode step
returns it, its arrays as numpy): each ``KVCache`` (bf16 or int8 K / V
with their bf16 scales; its length, an array there, a host int here),
``MambaState`` and ``RwkvState`` becomes the port's, by name and field,
and the encoder-decoder's memory K / V come along, every value exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import leaf_paths, set_leaf

__all__ = ["caches_from_numpy", "params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """One numpy array as a CPU tensor of ``dtype`` (bf16 bits kept;
    ``None`` for its own dtype, bf16 for numpy's ``ml_dtypes`` one)."""
    if dtype is None:
        dtype = (torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16"
                 else torch.from_numpy(np.zeros(0, np.asarray(a).dtype)).dtype)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # a view of a JAX buffer
        a = a.copy()
    if a.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                      and a.dtype.itemsize == 2
                                      and a.dtype.kind in "ui"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


def params_from_numpy(tree, specs, device=None):
    """The port's parameter tree on ``device`` (``None``: CUDA) from
    the reference's numpy tree; raises on a missing leaf or a shape that
    differs from its spec."""
    dev = torch.device("cuda" if device is None else device)
    out: dict = {}
    for path, spec in leaf_paths(specs):
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"leaf {'/'.join(path)} missing from the tree")
            node = node[k]
        t = tensor_from_numpy(node, spec.dtype)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"leaf {'/'.join(path)}: shape "
                             f"{tuple(t.shape)}, spec {spec.shape}")
        set_leaf(out, path, t.to(dev))
    return out


def caches_from_numpy(tree, device=None):
    """The port's decode caches on ``device`` (``None``: CUDA) from the
    reference's cache tree with numpy leaves: dicts by key, named tuples
    by class name and field, arrays in their own dtypes."""
    from repro_torch.models import attention, mamba, rwkv
    dev = torch.device("cuda" if device is None else device)
    kinds = {"KVCache": attention.KVCache, "MambaState": mamba.MambaState,
             "RwkvState": rwkv.RwkvState}

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(type(node), "_fields"):
            kind = kinds[type(node).__name__]
            fields = {f: getattr(node, f) for f in node._fields}
            if kind is attention.KVCache:
                # a stacked cache's lengths are its groups', all one value
                fields["length"] = int(np.max(np.asarray(fields["length"])))
                return kind(**{f: v if f == "length" else rec(v)
                               for f, v in fields.items()})
            return kind(**{f: rec(v) for f, v in fields.items()})
        if node is None:
            return None
        return tensor_from_numpy(node, None).to(dev)
    return rec(tree)
