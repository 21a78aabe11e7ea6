"""Logical -> physical sharding rules per (arch, shape, mesh).

The port of ``repro.parallel.rules``, policy for policy:

  batch          -> ('pod', 'data')   (DP; pod is just more DP)
  heads/ff/vocab -> 'model'           (TP)
  kv_heads       -> 'model' iff divisible, else replicated (GQA kv < TP)
  expert         -> 'data' when the padded experts divide it and ff
                    divides 'model' (EP over data, TP over ff inside each
                    expert), else 'model' when it divides, else 'data'
  head_dim       -> 'model' for serving when kv_heads is replicated
  seq_kv         -> ('pod', 'data') only when the global batch does not
                    divide the data axes (batch-1 long-context decode, SP)
  everything else replicated

Optimizer state (ZeRO-1): the parameter's spec with the data axes
claimed on the first unsharded-by-them dim they divide; gradients are
redistributed onto it (the reduce-scatter), the update runs on 1/DP of
the state, and the parameters are redistributed back (the all-gather).

Specs are tuples (``parallel.api``); a sharding is a
``parallel.api.Sharding``, the ``(mesh, placements)`` pair with its spec.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.parallel.api import MeshRules, Sharding, normalize_spec
from repro_torch.parallel.compat import axis_names, axis_sizes

__all__ = ["cache_logical_axes", "data_axes", "dp_size", "make_rules",
           "param_shardings", "serving_param_shardings", "zero1_shardings",
           "zero1_spec"]


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= _axis_size(mesh, a)
        return n
    return axis_sizes(mesh)[name]


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    """Ranks along the data axes."""
    return _axis_size(mesh, data_axes(mesh))


def make_rules(mesh, cfg: ArchConfig, shape: str) -> MeshRules:
    tp = _axis_size(mesh, "model")
    sp = SHAPES[shape]
    batch_axes = data_axes(mesh)
    dp = _axis_size(mesh, batch_axes)

    mapping: dict = {
        "embed": None,
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "layers": None,
        "heads": "model" if (cfg.n_heads_padded % tp == 0) else None,
        "kv_heads": "model" if (cfg.n_kv_padded % tp == 0) else None,
    }
    if cfg.moe_experts:
        # EP over 'data' with TP over 'ff' inside each expert first (the
        # expert weights then shard dp x tp ways); else EP over 'model'
        ep = _axis_size(mesh, "data")
        ff = cfg.moe_ff or cfg.d_ff
        if cfg.moe_experts_padded % ep == 0 and ff % tp == 0:
            mapping["expert"] = "data"
        elif cfg.moe_experts_padded % tp == 0:
            mapping["expert"] = "model"
        else:
            mapping["expert"] = "data"
    # serving with replicated kv heads: the cache shards on head_dim
    if sp.step in ("prefill", "decode") and mapping["kv_heads"] is None \
            and cfg.head_dim % tp == 0:
        mapping["head_dim"] = "model"
    if sp.global_batch % dp == 0 and sp.global_batch >= dp:
        mapping["batch"] = batch_axes
        mapping["seq_kv"] = None
    else:
        # batch-1 long-context decode: sequence-parallel cache (SP)
        mapping["batch"] = None
        mapping["seq_kv"] = batch_axes
    return MeshRules(mesh=mesh, mapping=mapping)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a logical-axes tree (tuples are leaves)
    and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def param_shardings(rules: MeshRules, axes_tree):
    """Tree of :class:`~repro_torch.parallel.api.Sharding` s from a
    logical-axes tree."""
    return _map(lambda ax: rules.sharding(tuple(ax)), axes_tree)


def serving_param_shardings(rules: MeshRules, axes_tree):
    """The parameters' shardings of a serving step: ``param_shardings``
    with ``head_dim`` whole.  Where the rules split the cache's
    ``head_dim`` (the KV heads do not divide ``model``), the reference
    splits the projections' head dims too (``wk`` / ``wv`` and their
    biases), which every step would gather back for the products and
    RoPE; here each rank holds them whole and its cache write takes its
    own head dims out locally.  Every other rule is ``rules``'."""
    whole = MeshRules(mesh=rules.mesh,
                      mapping={**rules.mapping, "head_dim": None})
    return param_shardings(whole, axes_tree)


def zero1_spec(rules: MeshRules, logical: tuple, shape) -> tuple:
    """The optimizer state's physical spec of a parameter of ``shape``:
    its spec with the data axes on the first dim that takes them."""
    mesh = rules.mesh
    dp_axes = data_axes(mesh)
    dp = _axis_size(mesh, dp_axes)
    spec = list(rules.spec(tuple(logical)))
    spec += [None] * (len(shape) - len(spec))
    used: set = set()
    for s in spec:
        used.update(s if isinstance(s, tuple) else (s,))
    if not any(a in used for a in dp_axes):
        for i, (s, dim) in enumerate(zip(spec, shape)):
            shard = _axis_size(mesh, s) if s else 1
            if dim % (shard * dp) == 0:
                spec[i] = (tuple([*(s if isinstance(s, tuple) else
                                    ([s] if s else []))] + list(dp_axes))
                           if s else dp_axes)
                break
    return normalize_spec(spec)


def zero1_shardings(rules: MeshRules, axes_tree, shapes_tree):
    """Optimizer-state shardings (``shapes_tree``: tensors, e.g. on the
    ``meta`` device, or shapes)."""
    def one(ax, shaped):
        shape = tuple(shaped.shape) if isinstance(shaped, torch.Tensor) \
            else tuple(shaped)
        return Sharding(rules.mesh, zero1_spec(rules, ax, shape))
    return _map(one, axes_tree, shapes_tree)


def _cache_axes(cfg: ArchConfig, shp: tuple) -> tuple:
    if len(shp) == 5 and shp[4] == 1:          # (G,B,S,K,1) int8 scales
        return ("layers", "batch", "seq_kv", "kv_heads", None)
    if len(shp) == 5 and shp[2] > shp[3]:      # (G,B,S,K,hd) kv cache
        return ("layers", "batch", "seq_kv", "kv_heads", "head_dim")
    if len(shp) == 5:                          # (G,B,H,hd,hd) rwkv wkv
        return ("layers", "batch", "heads", None, None)
    if len(shp) == 4 and shp[2] == cfg.d_inner:  # (G,B,di,ds) mamba h
        return ("layers", "batch", "ff", None)
    if len(shp) == 4:                          # (G,B,conv,di)
        return ("layers", "batch", None, "ff")
    if len(shp) == 3:                          # (G,B,d) shifts
        return ("layers", "batch", None)
    if len(shp) == 2:
        return ("layers", "batch")
    return (None,) * len(shp)


def cache_logical_axes(cfg: ArchConfig, caches_tree):
    """Logical axes of decode caches, by array rank / shape, the
    reference's heuristics: KV caches (G, B, S_max, K, hd), Mamba states
    (G, B, d_inner, d_state), RWKV (G, B, H, hd, hd) / (G, B, d).  The
    tree keeps the caches' structure (named tuples included); a host int
    (a ``KVCache``'s length) or None stays as it is."""
    def rec(node):
        if isinstance(node, torch.Tensor):
            return _cache_axes(cfg, tuple(node.shape))
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(type(node), "_fields"):
            return type(node)(*(rec(v) for v in node))
        return node
    return rec(caches_tree)
