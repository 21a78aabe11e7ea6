"""Model assembler: decoder-only / hybrid / RWKV / encoder-decoder / VLM,
as plain functions over the parameter dict.

The counterpart of ``repro.models.transformer`` for every family: specs,
the training forward and its loss (``loss_fn``; gradients come from
autograd), the encoder, prefill and one-token decode.  The parameter tree
keeps the reference's layout, layers stacked into ``groups`` with a
leading ``n_groups`` dimension (the encoder's into ``enc_groups``, one
layer a group); a Python loop over the groups takes the place of
``lax.scan``.  The reference's sharding hints stand at its places
(``parallel.api.shard_hint``: a no-op on plain tensors or with no rules
active; a redistribute of a DTensor under the train step's rules).  Under
grad, each group runs under the config's remat policy, as the reference's
``_scan_groups`` applies it: ``"full"`` keeps only the group's input and
recomputes the rest in the backward (``torch.utils.checkpoint``,
non-reentrant), ``"dots"`` keeps the matrix products' outputs and
recomputes the rest (selective checkpointing), ``"none"`` keeps
everything.

Decode caches are stacked the same way, one per position in a group: a
``KVCache`` for attention, a ``MambaState`` or an ``RwkvState`` for the
other mixers, and for the encoder-decoder ``{"self": ..., "memory_k",
"memory_v"}`` with the encoder memory's cross-attention K / V.  Decode
writes them in place, through per-group views, and returns them; a
``KVCache``'s ``length`` is a host int.  On the card every attention,
encoder and cross-attention call runs the flash-attention kernel (see
``models.attention``), and its gradient the flash-attention backward.

On a mesh (DTensor parameters under the serving rules, ``train.steps.
make_prefill_step`` / ``make_decode_step``) prefill makes its caches as
DTensors on the rules' shardings of ``parallel.rules.cache_logical_axes``
and decode takes them so: each group's state is a DTensor viewing its
rank's shard of the stacked one, every write lands in the rank's own
shard in local terms (``_store``, ``attention._write_kv``), and no cache
is gathered.  The logits come back whole on every rank.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rk
from repro_torch.models.common import ParamSpec, stack_specs
from repro_torch.parallel.api import shard_hint

__all__ = ["NEG", "decode_step", "encode", "forward_train", "group_specs",
           "init_decode_caches", "loss_fn", "model_specs", "prefill"]

NEG = -1e30


# ================================================================= specs ====
def _norm_specs(cfg):
    return (L.rmsnorm_specs(cfg.d_model) if cfg.norm == "rms"
            else L.layernorm_specs(cfg.d_model))


def _norm(cfg, params, x):
    return (L.rms_norm(params, x) if cfg.norm == "rms"
            else L.layer_norm(params, x))


def _layer_specs(cfg: ArchConfig, mix: str, mlp: str,
                 cross: bool = False) -> dict:
    s: dict[str, Any] = {}
    if mix == "attn":
        s["norm1"] = _norm_specs(cfg)
        s["attn"] = attn.attention_specs(cfg.d_model, cfg.n_heads_padded,
                                         cfg.n_kv_padded, cfg.head_dim,
                                         cfg.qkv_bias)
    elif mix == "mamba":
        s["norm1"] = _norm_specs(cfg)
        s["mamba"] = mb.mamba_specs(cfg.d_model, cfg.d_inner, cfg.d_state,
                                    cfg.d_conv, cfg.dt_rank)
    elif mix == "rwkv":
        s["norm1"] = L.layernorm_specs(cfg.d_model)
        s["time"] = rk.rwkv_time_specs(cfg.d_model, cfg.n_heads, cfg.lora_r)
    if cross:
        s["norm_x"] = _norm_specs(cfg)
        s["cross"] = attn.cross_attention_specs(
            cfg.d_model, cfg.n_heads_padded, cfg.n_kv_padded, cfg.head_dim)
    s["norm2"] = (_norm_specs(cfg) if mlp != "rwkv_ffn"
                  else L.layernorm_specs(cfg.d_model))
    if mlp == "dense":
        s["mlp"] = (L.swiglu_specs(cfg.d_model, cfg.d_ff)
                    if cfg.norm == "rms"
                    else L.gelu_mlp_specs(cfg.d_model, cfg.d_ff))
    elif mlp == "moe":
        s["moe"] = moe_mod.moe_specs(cfg.d_model, cfg.moe_ff or cfg.d_ff,
                                     cfg.moe_experts_padded)
        if cfg.shared_expert_ff:
            s["shared"] = moe_mod.shared_expert_specs(cfg.d_model,
                                                      cfg.shared_expert_ff)
        if cfg.dense_residual:
            s["dense2"] = L.swiglu_specs(cfg.d_model, cfg.d_ff)
    elif mlp == "rwkv_ffn":
        s["chan"] = rk.rwkv_channel_specs(cfg.d_model, cfg.d_ff)
    return s


def group_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    return {str(pos): _layer_specs(cfg, mix, mlp, cross)
            for pos, (mix, mlp) in enumerate(cfg.group_kinds())}


def model_specs(cfg: ArchConfig) -> dict:
    s: dict[str, Any] = {
        "embed": L.embedding_specs(cfg.vocab_padded, cfg.d_model),
        "groups": stack_specs(group_specs(cfg, cross=(cfg.kind == "encdec")),
                              cfg.n_groups, axis_name="layers"),
        "final_norm": _norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = {"table": ParamSpec(
            (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), scale=0.02)}
    if cfg.kind == "encdec":
        enc_pattern = {"0": _layer_specs(cfg, "attn", "dense")}
        s["enc_groups"] = stack_specs(enc_pattern, cfg.enc_layers,
                                      axis_name="layers")
        s["enc_norm"] = _norm_specs(cfg)
    return s


# ============================================================ layer apply ===
def _apply_mlp(cfg, mlp, params, x):
    h = _norm(cfg, params["norm2"], x)
    if mlp == "dense":
        y = (L.swiglu(params["mlp"], h) if cfg.norm == "rms"
             else L.gelu_mlp(params["mlp"], h))
    elif mlp == "moe":
        y = moe_mod.moe_apply(
            params["moe"], h, n_experts=cfg.moe_experts,
            n_experts_padded=cfg.moe_experts_padded, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor)
        if "shared" in params:
            y = y + moe_mod.shared_expert_apply(params["shared"], h)
        if "dense2" in params:
            y = y + L.swiglu(params["dense2"], h)
    else:
        raise ValueError(mlp)
    return x + y


def _heads(cfg, params):
    """Attention params with the padding heads masked."""
    return attn.mask_padded_heads(params, cfg.n_heads, cfg.n_kv)


def _apply_layer_train(cfg, kinds, params, x, positions, memory=None):
    mix, mlp = kinds
    if mix == "attn":
        h = _norm(cfg, params["norm1"], x)
        # the decoder's self attention is causal in every family
        x = x + attn.attention_train(
            _heads(cfg, params["attn"]), h, positions,
            n_heads=cfg.n_heads_padded, n_kv=cfg.n_kv_padded,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=True,
            chunk=cfg.attn_chunk, window=cfg.window)
    elif mix == "mamba":
        h = _norm(cfg, params["norm1"], x)
        x = x + mb.mamba_train(params["mamba"], h, d_state=cfg.d_state,
                               dt_rank=cfg.dt_rank, chunk=cfg.mamba_chunk)
    elif mix == "rwkv":
        h = L.layer_norm(params["norm1"], x)
        y, _ = rk.rwkv_time_mix(params["time"], h, n_heads=cfg.n_heads)
        x = x + y
    if memory is not None and "cross" in params:
        h = _norm(cfg, params["norm_x"], x)
        cp = _heads(cfg, params["cross"])
        mk, mv = attn.project_memory(cp, memory)
        x = x + attn.cross_attention(cp, h, mk, mv)
    if mlp == "rwkv_ffn":
        h = L.layer_norm(params["norm2"], x)
        y, _ = rk.rwkv_channel_mix(params["chan"], h)
        return x + y
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
    if _is_dtensor(logits):               # a mesh's: whole on every rank
        logits = logits.full_tensor()
    logits[..., cfg.vocab:] = NEG        # padded ids (a new tensor: in place)
    return logits


def _embed_inputs(cfg, params, batch):
    """Token embeddings, behind the VLM's vision prefix when given."""
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x


# ============================================================== forward =====
# The matrix products whose outputs remat="dots" keeps (``einsum`` lowers
# to these), as ``checkpoint_policies.checkpoint_dots`` keeps dot_general's.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _scan_groups(cfg, groups, n: int, x, body):
    """``x = body(x, group)`` over the n stacked groups in order, each
    group under the remat policy when grad is on."""
    step = body
    if torch.is_grad_enabled() and cfg.remat in ("full", "dots"):
        kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)}
        step = functools.partial(_ckpt.checkpoint, body, use_reentrant=False,
                                 **kw)
    elif cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none / full / dots, got "
                         f"{cfg.remat!r}")
    for gp in _unstack(groups, n):
        x = step(x, gp)
    return x


def forward_train(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Token logits (B, S, vocab_padded) of the training forward; the
    VLM's S counts its ``frontend_len`` prefix."""
    x = shard_hint(_embed_inputs(cfg, params, batch), "batch", None, "embed")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    memory = (encode(cfg, params, batch["frames"]) if cfg.kind == "encdec"
              else None)
    pattern = cfg.group_kinds()

    def body(xc, gp):
        for pos, kinds in enumerate(pattern):
            xc = _apply_layer_train(cfg, kinds, gp[str(pos)], xc, positions,
                                    memory)
        return shard_hint(xc, "batch", None, "embed")

    x = _scan_groups(cfg, params["groups"], cfg.n_groups, x, body)
    x = _norm(cfg, params["final_norm"], x)
    return shard_hint(_logits(cfg, params, x), "batch", None, "vocab")


def encode(cfg: ArchConfig, params, frames) -> torch.Tensor:
    """Encoder stack (``enc_layers`` non-causal layers) over precomputed
    frame embeddings, cast to bf16 as the reference casts them."""
    x = frames.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(xc, gp):
        p = gp["0"]
        h = _norm(cfg, p["norm1"], xc)
        xc = xc + attn.attention_train(
            _heads(cfg, p["attn"]), h, positions, n_heads=cfg.n_heads_padded,
            n_kv=cfg.n_kv_padded, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=False, chunk=cfg.attn_chunk)
        return _apply_mlp(cfg, "dense", p, xc)

    x = _scan_groups(cfg, params["enc_groups"], cfg.enc_layers, x, body)
    return _norm(cfg, params["enc_norm"], x)


def loss_fn(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 (a 0-d tensor), padded-vocab
    ids masked out, the VLM's prefix positions dropped: the reference's
    ``loss_fn``."""
    logits = forward_train(cfg, params, batch).to(torch.float32)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        logits = logits[:, cfg.frontend_len:]
    if cfg.vocab_padded > cfg.vocab:       # with none padded: the identity
        vmask = torch.arange(cfg.vocab_padded, device=logits.device) \
            < cfg.vocab
        logits = torch.where(vmask, logits, NEG)
    return _mean_xent(logits, batch["targets"].long())


def _mean_xent(logits, targets) -> torch.Tensor:
    """Mean of ``logsumexp - gold logit`` over the tokens; a plain 0-d
    tensor, the same on every rank, for DTensor ``logits``."""
    if _is_dtensor(logits):
        loss = torch.mean(_sharded_xent(logits, targets))
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * loss.device_mesh.ndim
        return loss.redistribute(placements=rep).to_local(
            grad_placements=rep)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded_xent(logits, targets):
    """Per-token ``logsumexp - gold logit`` of DTensor ``logits`` (B, S,
    V), the vocab sharded where the rules put it, without gathering the
    vocab: a DTensor laid out as the logits' leading dims and replicated
    over the vocab's mesh dimensions.  One per-shard function computes it:
    the max and the sum of exponentials reduce over the vocab's shards by
    explicit all-reduces (this reorders the sum against
    ``torch.logsumexp``), and so does the gold logit, picked on the rank
    whose vocab slice holds it.  (Written as DTensor operations, the same
    sums gave wrong gradients on a two-dimensional mesh under torch 2.11.)
    With one vocab shard it is ``torch.logsumexp`` and a gather: the
    one-device sums, bit for bit."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.compat import mesh_max, mesh_sum, shard_map
    mesh, lp = logits.device_mesh, tuple(logits.placements)
    vocab = logits.shape[-1]
    vdims = [i for i, p in enumerate(lp)
             if p == Shard(logits.ndim - 1) and mesh.size(i) > 1]
    tp = [p if p.is_shard() and p.dim < targets.ndim else Replicate()
          for p in lp]

    def local(lg, tg):
        if not vdims:
            gold = torch.gather(lg, -1, tg[..., None])[..., 0]
            return torch.logsumexp(lg, dim=-1) - gold
        off = 0
        for i in vdims:   # chunked as torch.chunk splits: ceil(V / n) rows
            off = mesh.get_local_rank(i) * -(-vocab // mesh.size(i))
        m = mesh_max(lg.amax(dim=-1, keepdim=True), mesh, vdims)
        logz = torch.log(mesh_sum(torch.exp(lg - m).sum(dim=-1), mesh,
                                  vdims)) + m[..., 0]
        n = lg.shape[-1]
        rel = tg - off
        hit = (rel >= 0) & (rel < n)
        got = torch.gather(lg, -1, rel.clamp(0, max(n - 1, 0))[..., None])
        gold = torch.where(hit, got[..., 0], torch.zeros_like(got[..., 0]))
        return logz - mesh_sum(gold, mesh, vdims)

    return shard_map(local, mesh=mesh, in_specs=(lp, tp),
                     out_specs=tp)(logits, targets)


# =============================================================== serving ====
def _self_caches(cfg, batch, s_max, dev, dtype, rules=None) -> dict:
    """One stacked state per position of a group: K / V of zeros in
    ``dtype`` (int8 with bf16 scales under ``kv_cache_dtype="int8"``),
    length 0; Mamba's float32 state and bf16 conv tail; RWKV's float32
    WKV state and its token shifts in ``dtype``.  With mesh ``rules``,
    DTensors of zeros on their shardings (each rank makes its shard; on
    ``meta``, for the dry run, shards of no storage)."""
    if rules is not None:
        return _zeros_on(cfg, _self_caches(cfg, batch, s_max, "meta",
                                           dtype), rules,
                         meta=torch.device(dev).type == "meta")
    g = cfg.n_groups

    def one(mix):
        if mix == "attn":
            return attn.new_cache((g, batch), s_max, cfg.n_kv_padded,
                                  cfg.head_dim, dtype, dev,
                                  quantize=(cfg.kv_cache_dtype == "int8"))
        if mix == "mamba":
            return mb.MambaState(
                h=torch.zeros((g, batch, cfg.d_inner, cfg.d_state),
                              dtype=torch.float32, device=dev),
                conv=torch.zeros((g, batch, cfg.d_conv - 1, cfg.d_inner),
                                 dtype=torch.bfloat16, device=dev))
        hd = cfg.d_model // cfg.n_heads
        shift = lambda: torch.zeros((g, batch, cfg.d_model), dtype=dtype,
                                    device=dev)
        return rk.RwkvState(
            wkv=torch.zeros((g, batch, cfg.n_heads, hd, hd),
                            dtype=torch.float32, device=dev),
            shift_t=shift(), shift_c=shift())

    return {str(pos): one(mix)
            for pos, (mix, _mlp) in enumerate(cfg.group_kinds())}


def _zeros_on(cfg, tree, rules, meta: bool = False):
    """Tree of ``meta`` tensors (caches) as DTensors of zeros on the
    rules' shardings of their ``cache_logical_axes`` (``meta``: shards on
    the ``meta`` device, of no storage)."""
    from torch.distributed.tensor import zeros

    from repro_torch.parallel.api import shard_tree
    from repro_torch.parallel.rules import cache_logical_axes

    def rec(node, ax):
        if isinstance(node, torch.Tensor):
            sharding = rules.sharding(tuple(ax))
            if meta:
                return shard_tree(node, sharding)
            mesh, pl = sharding
            return zeros(tuple(node.shape), dtype=node.dtype,
                         device_mesh=mesh, placements=list(pl))
        if isinstance(node, dict):
            return {k: rec(node[k], ax[k]) for k in node}
        if isinstance(node, tuple) and hasattr(type(node), "_fields"):
            return type(node)(*(rec(a, b) for a, b in zip(node, ax)))
        return node
    return rec(tree, cache_logical_axes(cfg, tree))


def _mesh_rules(x):
    """The active rules when ``x`` is a DTensor on their mesh (serving on
    a mesh), else None."""
    from repro_torch.parallel.api import active_rules
    rules = active_rules()
    if rules is None or not _is_dtensor(x):
        return None
    return rules


def init_decode_caches(cfg: ArchConfig, batch: int, s_max: int,
                       abstract: bool = False, device=None,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stacked (per group) decode caches, one per layer position (see
    ``_self_caches``), the reference's tree; the encoder-decoder's adds
    the memory K / V, (n_groups, B, cross_memory_len, K, hd) in bf16.
    ``abstract`` puts them on the ``meta`` device (no storage);
    ``device=None`` means CUDA."""
    dev = torch.device("meta" if abstract else
                       "cuda" if device is None else device)
    caches = _self_caches(cfg, batch, s_max, dev, dtype)
    if cfg.kind != "encdec":
        return caches
    shape = (cfg.n_groups, batch, cfg.cross_memory_len, cfg.n_kv_padded,
             cfg.head_dim)
    return {"self": caches,
            "memory_k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "memory_v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def _unbind0(t) -> list:
    """``t``'s views along dimension 0 (the groups).  A DTensor's are
    DTensors of its layout over views of the rank's shard (the rules
    never split the groups), so a write into one lands in the stacked
    shard."""
    if not _is_dtensor(t):
        return list(t.unbind(0))
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in t.placements]
    shape = tuple(t.shape[1:])
    stride = attn._contiguous_stride(shape)
    return [DTensor.from_local(x, t.device_mesh, pl, run_check=False,
                               shape=shape, stride=stride)
            for x in t.to_local().unbind(0)]


def _state_views(c, n: int) -> list:
    """A stacked state as n per-group states viewing its storage."""
    if isinstance(c, attn.KVCache):
        fields = [_unbind0(f) if f is not None else [None] * n
                  for f in (c.k, c.v, c.k_scale, c.v_scale)]
        return [attn.KVCache(k=fields[0][i], v=fields[1][i], length=c.length,
                             k_scale=fields[2][i], v_scale=fields[3][i])
                for i in range(n)]
    fields = [_unbind0(f) for f in c]
    return [type(c)(*(f[i] for f in fields)) for i in range(n)]


def _store(view, new) -> None:
    """Write a Mamba / RWKV state back into its stacked view (a KV cache
    is written in place by the attention); on a mesh each rank copies its
    own shard of the new state, laid out as the view."""
    if isinstance(view, attn.KVCache):
        return
    for dst, src in zip(view, new):
        if dst is src:
            continue
        if _is_dtensor(dst):
            if list(src.placements) != list(dst.placements):
                src = src.redistribute(dst.device_mesh, dst.placements)
            dst.to_local().copy_(src.to_local())
        else:
            dst.copy_(src)


def _advance(caches: dict, n: int) -> dict:
    """The caches with every KV cache's length n more."""
    return {p: c._replace(length=c.length + n)
            if isinstance(c, attn.KVCache) else c
            for p, c in caches.items()}


def _decode_mix(cfg, kinds, params, x, cache):
    mix, _ = kinds
    if mix == "attn":
        h = _norm(cfg, params["norm1"], x)
        y, cache = attn.attention_decode(_heads(cfg, params["attn"]), h,
                                         cache, rope_theta=cfg.rope_theta,
                                         window=cfg.window)
        return x + y, cache
    if mix == "mamba":
        h = _norm(cfg, params["norm1"], x)
        y, cache = mb.mamba_decode(params["mamba"], h, cache,
                                   d_state=cfg.d_state, dt_rank=cfg.dt_rank)
        return x + y, cache
    h = L.layer_norm(params["norm1"], x)
    y, (wkv, last_t) = rk.rwkv_time_mix(params["time"], h, state=cache,
                                        n_heads=cfg.n_heads)
    return x + y, cache._replace(wkv=wkv, shift_t=last_t)


def decode_step(cfg: ArchConfig, params, caches, batch):
    """One-token decode: batch['tokens'] (B, 1) -> (logits (B, 1,
    vocab_padded), caches).  The caches are written in place and returned
    with the KV caches' lengths advanced by one."""
    x = shard_hint(L.embed(params["embed"], batch["tokens"]), "batch", None,
                   "embed")
    pattern = cfg.group_kinds()
    g = cfg.n_groups
    is_encdec = cfg.kind == "encdec"
    self_caches = caches["self"] if is_encdec else caches
    views = {p: _state_views(c, g) for p, c in self_caches.items()}
    memory = ((_unbind0(caches["memory_k"]), _unbind0(caches["memory_v"]))
              if is_encdec else None)
    for gi, gp in enumerate(_unstack(params["groups"], g)):
        for pos, kinds in enumerate(pattern):
            p, c = gp[str(pos)], views[str(pos)][gi]
            x, new_c = _decode_mix(cfg, kinds, p, x, c)
            if is_encdec and "cross" in p:
                # the reference leaves the cross heads unmasked here
                h = _norm(cfg, p["norm_x"], x)
                x = x + attn.cross_attention(p["cross"], h, memory[0][gi],
                                             memory[1][gi])
            if kinds[1] == "rwkv_ffn":
                h = L.layer_norm(p["norm2"], x)
                y, last_c = rk.rwkv_channel_mix(p["chan"], h, c.shift_c)
                x = x + y
                new_c = new_c._replace(shift_c=last_c)
            else:
                x = _apply_mlp(cfg, kinds[1], p, x)
            _store(c, new_c)
    x = _norm(cfg, params["final_norm"], x)
    new = _advance(self_caches, 1)
    if is_encdec:
        new = {**caches, "self": new}
    return _mask_vocab(cfg, _logits(cfg, params, x)), new


def prefill(cfg: ArchConfig, params, batch, s_max: int):
    """Populate decode caches from a prompt (behind the VLM's prefix; the
    encoder-decoder encodes ``batch["frames"]``); returns (last logits (B,
    vocab_padded), caches)."""
    x = shard_hint(_embed_inputs(cfg, params, batch), "batch", None, "embed")
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    pattern = cfg.group_kinds()
    g = cfg.n_groups
    is_encdec = cfg.kind == "encdec"
    memory = encode(cfg, params, batch["frames"]) if is_encdec else None
    # KV caches and RWKV shifts take the activations' dtype, as the
    # reference's do; on a mesh they are made on the rules' shardings
    rules = _mesh_rules(x)
    caches = _self_caches(cfg, b, s_max, x.device, x.dtype, rules)
    views = {p: _state_views(c, g) for p, c in caches.items()}
    mem_kv = []
    for gi, gp in enumerate(_unstack(params["groups"], g)):
        for pos, (mix, mlp) in enumerate(pattern):
            p, c = gp[str(pos)], views[str(pos)][gi]
            new_c = c
            if mix == "attn":
                h = _norm(cfg, p["norm1"], x)
                y, _ = attn.attention_prefill(
                    _heads(cfg, p["attn"]), h, positions, s_max,
                    rope_theta=cfg.rope_theta, chunk=cfg.attn_chunk,
                    window=cfg.window,
                    quantize=(cfg.kv_cache_dtype == "int8"), cache=c)
                x = x + y
            elif mix == "mamba":
                h = _norm(cfg, p["norm1"], x)
                y, new_c = mb.mamba_prefill(p["mamba"], h,
                                            d_state=cfg.d_state,
                                            dt_rank=cfg.dt_rank,
                                            chunk=cfg.mamba_chunk)
                x = x + y
            elif mix == "rwkv":
                h = L.layer_norm(p["norm1"], x)
                y, (wkv, last_t) = rk.rwkv_time_mix(p["time"], h,
                                                    n_heads=cfg.n_heads)
                x = x + y
                new_c = c._replace(wkv=wkv, shift_t=last_t)
            if is_encdec and "cross" in p:
                # unmasked cross heads, as the reference's prefill
                h = _norm(cfg, p["norm_x"], x)
                mk, mv = attn.project_memory(p["cross"], memory)
                x = x + attn.cross_attention(p["cross"], h, mk, mv)
                if pos == 0:      # the reference caches position 0's
                    mem_kv.append((mk, mv))
            if mlp == "rwkv_ffn":
                h = L.layer_norm(p["norm2"], x)
                y, last_c = rk.rwkv_channel_mix(p["chan"], h)
                x = x + y
                new_c = new_c._replace(shift_c=last_c)
            else:
                x = _apply_mlp(cfg, mlp, p, x)
            _store(c, new_c)
        x = shard_hint(x, "batch", None, "embed")
    x = _norm(cfg, params["final_norm"], x)
    caches = _advance(caches, s)
    if is_encdec:
        mem = {"memory_k": torch.stack([k for k, _ in mem_kv]),
               "memory_v": torch.stack([v for _, v in mem_kv])}
        if rules is not None:     # onto the rules' cache shardings
            from repro_torch.parallel.rules import cache_logical_axes
            axes = cache_logical_axes(cfg, mem)
            mem = {k: t.redistribute(*rules.sharding(tuple(axes[k])))
                   for k, t in mem.items()}
        caches = {"self": caches, **mem}
    return _mask_vocab(cfg, _logits(cfg, params, x[:, -1])), caches
