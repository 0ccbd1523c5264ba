"""The 10 assigned architectures (exact configs from the assignment block).

Sources in brackets per the assignment; deviations noted in ``notes``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

DEEPSEEK_V2_236B = ArchConfig(
    name="deepseek-v2-236b", family="decoder",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab=102400, head_dim=128, attn="mla",
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                  v_head=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    notes="[arXiv:2405.04434; hf] MLA kv_lora=512; 2 shared + 160 routed "
          "top-6. All 60 layers MoE (paper has 1 leading dense layer; "
          "homogenized for scan-over-layers).",
)

OLMOE_1B_7B = ArchConfig(
    name="olmoe-1b-7b", family="decoder",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, head_dim=128, qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0),
    notes="[arXiv:2409.02060; hf] 64 experts top-8; qk-norm per OLMoE.",
)

SEAMLESS_M4T_MEDIUM = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, act="geglu",
    notes="[arXiv:2308.11596; hf] enc-dec; audio frontend STUBBED: "
          "input_specs() provides precomputed frame embeddings.",
)

CHAMELEON_34B = ArchConfig(
    name="chameleon-34b", family="decoder",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, qk_norm=True,
    notes="[arXiv:2405.09818; unverified] early-fusion; VQ image tokens are "
          "ordinary vocab entries (frontend stubbed); qk-norm per paper.",
)

ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112, attn_every=9, sub_quadratic=True,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, chunk=256),
    notes="[arXiv:2411.15242; unverified] Mamba2 backbone + weight-shared "
          "attention block every 9 layers (81 = 9x9; paper interleaves 2 "
          "shared blocks aperiodically).",
)

CODEQWEN15_7B = ArchConfig(
    name="codeqwen1.5-7b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, head_dim=128,
    notes="[hf:Qwen/CodeQwen1.5-7B; hf] qwen1.5 arch, MHA, SwiGLU.",
)

NEMOTRON_4_15B = ArchConfig(
    name="nemotron-4-15b", family="decoder",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab=256000, head_dim=128, act="sq_relu",
    notes="[arXiv:2402.16819; unverified] GQA kv=8, squared-ReLU MLP.",
)

GEMMA2_2B = ArchConfig(
    name="gemma2-2b", family="decoder",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256, act="geglu",
    softcap_attn=50.0, softcap_logits=30.0,
    local_window=4096, local_global_period=2, tie_embeddings=True,
    notes="[arXiv:2408.00118; hf] local(4096)+global alternating; attn & "
          "final logit softcaps.",
)

QWEN3_0_6B = ArchConfig(
    name="qwen3-0.6b", family="decoder",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    notes="[hf:Qwen/Qwen3-8B; hf] qk_norm, GQA kv=8.",
)

MAMBA2_780M = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, sub_quadratic=True,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256),
    notes="[arXiv:2405.21060; unverified] SSD; attention-free — attention "
          "sharding aspects of PACO inapplicable (DESIGN.md §5).",
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        DEEPSEEK_V2_236B, OLMOE_1B_7B, SEAMLESS_M4T_MEDIUM, CHAMELEON_34B,
        ZAMBA2_7B, CODEQWEN15_7B, NEMOTRON_4_15B, GEMMA2_2B, QWEN3_0_6B,
        MAMBA2_780M,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
