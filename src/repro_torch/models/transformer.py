"""Model assembler: the decoder-only path, as plain functions over the
parameter dict.

The counterpart of ``repro.models.transformer`` for the dense decoder-only
families (``cfg.family == "dense"``, ``cfg.kind == "decoder"``): specs,
the training forward (logits only; the loss and the backward pass wait for
ROADMAP A15.3), prefill and one-token decode.  The parameter tree keeps the
reference's layout, layers stacked into ``groups`` with a leading
``n_groups`` dimension; a Python loop over the groups takes the place of
``lax.scan`` (remat has no meaning without a backward pass, and the
sharding hints have no counterpart on one card).  Decode caches are stacked
the same way, one ``KVCache`` per position in a group, and are written in
place; their ``length`` is a host int.

Mamba, RWKV, MoE, encoder-decoder and VLM configs raise ``unported``
(ROADMAP A15.3), on the CPU too: their modules are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.common import ParamSpec, stack_specs

__all__ = ["NEG", "decode_step", "forward_train", "group_specs",
           "init_decode_caches", "model_specs", "prefill"]

NEG = -1e30


def _check_family(cfg: ArchConfig) -> None:
    """Raise ``unported`` for every family but the dense decoder."""
    from repro_torch.engine.config import unported   # the engine imports us
    if cfg.kind == "encdec":
        raise unported("encoder-decoder models")
    if cfg.kind == "rwkv":
        raise unported("rwkv models")
    if cfg.family == "vlm":
        raise unported("vlm models")
    if cfg.attn_period:
        raise unported("hybrid (mamba) models")
    if cfg.moe_experts or cfg.moe_period:
        raise unported("moe models")


# ================================================================= specs ====
def _norm_specs(cfg):
    return (L.rmsnorm_specs(cfg.d_model) if cfg.norm == "rms"
            else L.layernorm_specs(cfg.d_model))


def _norm(cfg, params, x):
    return (L.rms_norm(params, x) if cfg.norm == "rms"
            else L.layer_norm(params, x))


def _layer_specs(cfg: ArchConfig, mix: str, mlp: str) -> dict:
    if (mix, mlp) != ("attn", "dense"):
        raise ValueError(f"layer kind {(mix, mlp)} is not a dense decoder "
                         f"layer")
    return {
        "norm1": _norm_specs(cfg),
        "attn": attn.attention_specs(cfg.d_model, cfg.n_heads_padded,
                                     cfg.n_kv_padded, cfg.head_dim,
                                     cfg.qkv_bias),
        "norm2": _norm_specs(cfg),
        "mlp": (L.swiglu_specs(cfg.d_model, cfg.d_ff) if cfg.norm == "rms"
                else L.gelu_mlp_specs(cfg.d_model, cfg.d_ff)),
    }


def group_specs(cfg: ArchConfig) -> dict:
    return {str(pos): _layer_specs(cfg, mix, mlp)
            for pos, (mix, mlp) in enumerate(cfg.group_kinds())}


def model_specs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    s: dict[str, Any] = {
        "embed": L.embedding_specs(cfg.vocab_padded, cfg.d_model),
        "groups": stack_specs(group_specs(cfg), cfg.n_groups,
                              axis_name="layers"),
        "final_norm": _norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = {"table": ParamSpec(
            (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    return s


# ============================================================ layer apply ===
def _apply_mlp(cfg, mlp, params, x):
    if mlp != "dense":
        raise ValueError(mlp)
    h = _norm(cfg, params["norm2"], x)
    y = (L.swiglu(params["mlp"], h) if cfg.norm == "rms"
         else L.gelu_mlp(params["mlp"], h))
    return x + y


def _attn_params(cfg, params):
    return attn.mask_padded_heads(params["attn"], cfg.n_heads, cfg.n_kv)


def _apply_layer_train(cfg, kinds, params, x, positions):
    mix, mlp = kinds
    h = _norm(cfg, params["norm1"], x)
    x = x + attn.attention_train(
        _attn_params(cfg, params), h, positions, n_heads=cfg.n_heads_padded,
        n_kv=cfg.n_kv_padded, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, chunk=cfg.attn_chunk,
        window=cfg.window)
    return _apply_mlp(cfg, mlp, params, x)


def _unstack(tree, n: int) -> list:
    """The stacked group tree as n per-group trees of views (one
    ``unbind`` per leaf)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


def _logits(cfg, params, x):
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"])
    return torch.einsum("...d,vd->...v", x, table)


def _mask_vocab(cfg, logits):
    logits[..., cfg.vocab:] = NEG        # padded ids (a new tensor: in place)
    return logits


# ============================================================== forward =====
def forward_train(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Token logits (B, S, vocab_padded) of the training forward."""
    _check_family(cfg)
    x = L.embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    pattern = cfg.group_kinds()
    for gp in _unstack(params["groups"], cfg.n_groups):
        for pos, kinds in enumerate(pattern):
            x = _apply_layer_train(cfg, kinds, gp[str(pos)], x, positions)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x)


# =============================================================== serving ====
def init_decode_caches(cfg: ArchConfig, batch: int, s_max: int,
                       abstract: bool = False, device=None,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stacked (per group) decode caches, one per layer position: k/v
    (n_groups, B, S_max, K, hd) of zeros in ``dtype``, length 0; int8 with
    bf16 scales under ``kv_cache_dtype="int8"``.  ``abstract`` puts them on
    the ``meta`` device (no storage); ``device=None`` means CUDA."""
    _check_family(cfg)
    dev = torch.device("meta" if abstract else
                       "cuda" if device is None else device)
    return {str(pos): attn.new_cache(
        (cfg.n_groups, batch), s_max, cfg.n_kv_padded, cfg.head_dim, dtype,
        dev, quantize=(cfg.kv_cache_dtype == "int8"))
        for pos in range(len(cfg.group_kinds()))}


def _cache_views(c: attn.KVCache, n: int) -> list:
    """A stacked cache as n per-group caches viewing its storage."""
    fields = [f.unbind(0) if f is not None else [None] * n
              for f in (c.k, c.v, c.k_scale, c.v_scale)]
    return [attn.KVCache(k=fields[0][i], v=fields[1][i], length=c.length,
                         k_scale=fields[2][i], v_scale=fields[3][i])
            for i in range(n)]


def _decode_mix(cfg, kinds, params, x, cache):
    h = _norm(cfg, params["norm1"], x)
    y, cache = attn.attention_decode(_attn_params(cfg, params), h, cache,
                                     rope_theta=cfg.rope_theta,
                                     window=cfg.window)
    return x + y, cache


def decode_step(cfg: ArchConfig, params, caches, batch):
    """One-token decode: batch['tokens'] (B, 1) -> (logits (B, 1,
    vocab_padded), caches).  The caches are written in place and returned
    with their lengths advanced by one."""
    _check_family(cfg)
    x = L.embed(params["embed"], batch["tokens"])
    pattern = cfg.group_kinds()
    g = cfg.n_groups
    views = {p: _cache_views(c, g) for p, c in caches.items()}
    for gi, gp in enumerate(_unstack(params["groups"], g)):
        for pos, kinds in enumerate(pattern):
            p = gp[str(pos)]
            x, _ = _decode_mix(cfg, kinds, p, x, views[str(pos)][gi])
            x = _apply_mlp(cfg, kinds[1], p, x)
    x = _norm(cfg, params["final_norm"], x)
    new = {p: c._replace(length=c.length + 1) for p, c in caches.items()}
    return _mask_vocab(cfg, _logits(cfg, params, x)), new


def prefill(cfg: ArchConfig, params, batch, s_max: int):
    """Populate decode caches from a prompt; returns (last logits (B,
    vocab_padded), caches)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    pattern = cfg.group_kinds()
    g = cfg.n_groups
    # the cache takes the activations' dtype, as the reference's padded
    # K/V do
    caches = init_decode_caches(cfg, b, s_max, device=x.device,
                                dtype=x.dtype)
    views = {p: _cache_views(c, g) for p, c in caches.items()}
    for gi, gp in enumerate(_unstack(params["groups"], g)):
        for pos, (_mix, mlp) in enumerate(pattern):
            p = gp[str(pos)]
            h = _norm(cfg, p["norm1"], x)
            y, _ = attn.attention_prefill(
                _attn_params(cfg, p), h, positions, s_max,
                rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                window=cfg.window, quantize=(cfg.kv_cache_dtype == "int8"),
                cache=views[str(pos)][gi])
            x = _apply_mlp(cfg, mlp, p, x + y)
    x = _norm(cfg, params["final_norm"], x)
    caches = {p: c._replace(length=s) for p, c in caches.items()}
    return _mask_vocab(cfg, _logits(cfg, params, x[:, -1])), caches
