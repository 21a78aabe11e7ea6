"""Carry a parameter tree from the reference over to the port, exactly.

``params_from_numpy(tree, specs, device)`` takes the reference's parameter
tree as numpy arrays (nested dicts with the same keys as the port's specs,
the stacked ``groups`` layout with its leading ``n_groups`` dimension
included) and returns the port's tree, leaf for leaf, cast to each spec's
dtype.  A bf16 leaf may come as a float32 copy or as its raw 16-bit
pattern (a ``uint16`` / ``int16`` view, or numpy's ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` does not take): both carry the values
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import leaf_paths, set_leaf

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """One numpy array as a CPU tensor of ``dtype`` (bf16 bits kept)."""
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
