"""Architecture config schema and the four input-shape cells.

A copy of ``repro.configs.base`` for the PyTorch port: the fields, the
registry values, ``reduced()``, ``SHAPES`` and ``cell_applicable`` are the
same, and ``dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "decoder" | "encdec" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    act: str = "swiglu"             # swiglu | geglu | sq_relu
    attn: str = "gqa"               # gqa | mla
    qk_norm: bool = False
    softcap_attn: Optional[float] = None
    softcap_logits: Optional[float] = None
    local_window: Optional[int] = None   # sliding window size
    local_global_period: int = 0         # 0=never local; 2=alternate (gemma2)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0             # hybrid: shared attn block period
    n_enc_layers: int = 0           # encdec only
    q_chunk: int = 1024             # attention query-chunk (flash scan)
    param_dtype: str = "bfloat16"
    sub_quadratic: bool = False     # eligible for long_500k
    notes: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/logit
        dimension shards over any production mesh axis (16/32/...).  Logit
        columns >= vocab are masked to -1e30 (layers.mask_vocab)."""
        return -(-self.vocab // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads,
                                             4 * self.n_kv_heads
                                             // max(self.n_heads, 1), 4)),
            head_dim=16, d_ff=128, vocab=256, q_chunk=32,
            param_dtype="float32",
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=32, n_shared=min(self.moe.n_shared, 1),
                capacity_factor=2.0)
        if self.mla:
            kw["mla"] = MLAConfig(q_lora=32, kv_lora=32, qk_nope=16,
                                  qk_rope=8, v_head=16)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, headdim=8, chunk=8)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
        if self.attn_every:
            kw["attn_every"] = 2
        if self.local_window:
            kw["local_window"] = 16
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs; decode
    shapes skipped for encoder-only archs (none assigned here)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""
