"""Architecture config schema + shape-set definitions (assigned cells).

The port's own copy of ``repro.configs.base``, field for field;
``input_specs`` gives the dry run (``launch/dryrun.py``) its inputs on
the ``meta`` device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import round_up


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None
    tie_embeddings: bool = False
    norm: str = "rms"           # rms | layer
    kind: str = "decoder"       # decoder | encdec | rwkv
    # --- MoE ---
    moe_experts: int = 0
    moe_experts_padded: int = 0
    moe_top_k: int = 0
    moe_ff: int = 0             # per-expert ffn width
    moe_period: int = 0         # MoE on layers with i % period == moe_offset
    moe_offset: int = 0
    shared_expert_ff: int = 0   # qwen2-moe shared experts (fused width)
    dense_residual: bool = False  # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    # --- hybrid (jamba) ---
    attn_period: int = 0        # 0 = attention everywhere
    attn_offset: int = 0
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # --- rwkv ---
    lora_r: int = 64
    # --- frontend stubs (vlm / audio) ---
    frontend_len: int = 0       # prepended precomputed-embedding positions
    # --- encdec ---
    enc_layers: int = 0
    cross_memory_len: int = 4096  # encoder memory length for decode cells
    # --- training / memory knobs ---
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (serving cache)
    remat: str = "full"         # none | full | dots
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16
    group_size: int = 1         # layers per scan group
    scan_unroll: int = 1        # dry-run sets n_groups: XLA cost analysis
    #                             counts while bodies once; unrolling makes
    #                             per-layer FLOPs/collectives visible
    attn_chunk: int = 512
    mamba_chunk: int = 64
    # --- which assigned shapes run (long_500k only for sub-quadratic) ---
    supports_long: bool = False

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    # --- TP-divisibility head padding (DESIGN.md §9) ---------------------
    # 40-head (Qwen1.5) / 56-head (Arctic) attention does not divide the
    # 16-way 'model' axis.  The head axis is padded to the next multiple of
    # 16 with *masked-dead* heads: their weights are zero-masked at use, so
    # gradients through them are identically zero and the model is exactly
    # the logical architecture, at the cost of padded attention FLOPs
    # (reported in EXPERIMENTS.md §Roofline notes).
    TP = 16

    @property
    def n_heads_padded(self) -> int:
        if self.n_heads >= self.TP and self.n_heads % self.TP:
            return round_up(self.n_heads, self.TP)
        return self.n_heads

    @property
    def n_kv_padded(self) -> int:
        if self.n_kv >= self.TP and self.n_kv % self.TP:
            return round_up(self.n_kv, self.TP)
        return self.n_kv

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0
        return self.n_layers // self.group_size

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab_padded
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind_mix, kind_mlp in self.layer_kinds():
            if kind_mix == "attn":
                total += d * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
            elif kind_mix == "mamba":
                di = self.d_inner
                total += d * 2 * di + di * (self.dt_rank + 2 * self.d_state)
                total += self.dt_rank * di + di * d + self.d_conv * di
            elif kind_mix == "rwkv":
                total += 5 * d * d + d * self.lora_r * 2
            if kind_mlp == "dense":
                # swiglu = 3 matrices; gelu-mlp (layer-norm archs) = 2
                total += (3 if self.norm == "rms" else 2) * d * self.d_ff
            elif kind_mlp == "moe":
                ff = self.moe_ff or self.d_ff
                total += 3 * d * ff * self.moe_experts + d * self.moe_experts
                if self.shared_expert_ff:
                    total += 3 * d * self.shared_expert_ff
                if self.dense_residual:
                    total += 3 * d * self.d_ff
            elif kind_mlp == "rwkv_ffn":
                total += d * self.d_ff + self.d_ff * d + d * d
        if self.kind == "encdec":
            # encoder layers + decoder cross-attention
            total += self.enc_layers * (
                d * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
                + 3 * d * self.d_ff)
            total += self.n_layers * d * self.head_dim * (
                self.n_heads * 2 + self.n_kv * 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of E experts)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        ff = self.moe_ff or self.d_ff
        per_layer_moe = 3 * d * ff
        n_moe_layers = sum(1 for _, m in self.layer_kinds() if m == "moe")
        inactive = per_layer_moe * (self.moe_experts - self.moe_top_k)
        return self.param_count() - n_moe_layers * inactive

    def layer_kinds(self) -> list[tuple[str, str]]:
        """(mixer, mlp) kind per layer index."""
        kinds = []
        for i in range(self.n_layers):
            if self.kind == "rwkv":
                kinds.append(("rwkv", "rwkv_ffn"))
                continue
            if self.attn_period:
                mix = ("attn" if i % self.attn_period == self.attn_offset
                       else "mamba")
            else:
                mix = "attn"
            if self.moe_period and i % self.moe_period == self.moe_offset:
                mlp = "moe"
            else:
                mlp = "dense"
            kinds.append((mix, mlp))
        return kinds

    def group_kinds(self) -> list[tuple[str, str]]:
        """Layer kinds within one scan group (pattern repeats per group)."""
        kinds = self.layer_kinds()
        pattern = kinds[: self.group_size]
        assert kinds == pattern * self.n_groups, \
            f"{self.name}: layer pattern not periodic with {self.group_size}"
        return pattern


# ------------------------------------------------------- assigned shapes ---
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supported_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out



def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """Every model input of a cell as a tensor on the ``meta`` device (no
    storage), the reference's shapes and dtypes key for key: the global
    batch, which a sharded step splits over the data axes itself."""
    sp = SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    # vlm: the vision prefix counts toward seq_len (total positions = s)
    s_tok = s - cfg.frontend_len if cfg.family == "vlm" else s
    if sp.step == "train":
        d = {"tokens": spec((b, s_tok)), "targets": spec((b, s_tok))}
    elif sp.step == "prefill":
        d = {"tokens": spec((b, s_tok))}
    else:  # decode: one new token against a cache of size s
        d = {"tokens": spec((b, 1))}
    if cfg.family == "vlm" and sp.step != "decode":
        d["vision_embeds"] = spec((b, cfg.frontend_len, cfg.d_model),
                                  torch.bfloat16)
    if cfg.kind == "encdec":
        # audio stub: precomputed frame embeddings replace source tokens
        enc_len = s if sp.step != "decode" else cfg.cross_memory_len
        d["frames"] = spec((b, enc_len, cfg.d_model), torch.bfloat16)
        if sp.step == "prefill":
            # decoder prefill length: short transcript prefix
            d["tokens"] = spec((b, min(s, 4096)))
    return d
