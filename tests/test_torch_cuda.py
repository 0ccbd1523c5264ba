"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA inputs (the paged GQA pair and the MLA
latent pair), and the serving engine on CUDA running the kernels on every
prefill chunk and decode tick.

These tests carry the ``cuda`` marker and skip on a host without a card;
the file imports neither JAX nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain f32 atol 1e-4; bf16 atol 2e-2 (the plain
version rounds the softmax weights to bf16, the kernel keeps f32).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ops
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
DECODE_KW = [{}, {"window": 6}, {"logit_cap": 20.0},
             {"window": 3, "logit_cap": 5.0}, {"window": 100}]
PREFILL_KW = [{}, {"window": 5}, {"logit_cap": 20.0},
              {"window": 3, "logit_cap": 5.0}]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("kw", DECODE_KW)
@pytest.mark.parametrize("geom", ["prime", "splits"])
def test_decode_kernel_matches_plain(cuda, dtype, atol, kw, geom):
    """A prime pool of 4-position pages, and 64-position pages whose
    512-position tables span two key splits (one slot past its table)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    if geom == "prime":
        b, hq, hkv, d, page, n_pool = 3, 4, 2, 16, 4, 13
        bt = torch.tensor([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]])
        lens = torch.tensor([5, 16, 1])
    else:
        b, hq, hkv, d, page, n_pool = 3, 16, 8, 128, 64, 25
        bt = torch.randperm(24)[:24].reshape(3, 8)
        lens = torch.tensor([300, 511, 512])
    bt = bt.to(cuda, torch.int32)
    lens = lens.to(cuda, torch.int32)
    q = _rand(gen, b, 1, hq, d, dtype=dtype)
    kp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    vp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    before = K.paged_flash_decode.launches
    got = ops.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert K.paged_flash_decode.launches == before + 1
    want = ops.paged_decode_attention(q, kp, vp, bt, lens, use_kernel=False,
                                      **kw)
    assert _err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("kw", PREFILL_KW)
@pytest.mark.parametrize("hq,hkv", [(4, 2), (6, 2), (3, 3), (16, 8)])
def test_prefill_kernel_matches_plain(cuda, dtype, atol, kw, hq, hkv):
    """A late chunk over two key splits, G = 2, 3, 1 and qwen3's heads."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    page, width, n_pool, c, start, d = 16, 16, 20, 24, 200, 16
    row = torch.randperm(n_pool - 1)[:width].to(cuda, torch.int32)
    q = _rand(gen, 1, c, hq, d, dtype=dtype)
    kp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    vp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    before = K.paged_flash_prefill.launches
    got = ops.paged_prefill_attention(q, kp, vp, row, start, **kw)
    torch.cuda.synchronize()
    assert K.paged_flash_prefill.launches == before + 1
    want = ops.paged_prefill_attention(q, kp, vp, row, start,
                                       use_kernel=False, **kw)
    assert _err(got, want) <= atol


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 1, 4, 16, device=cuda)
    kp = torch.zeros(5, 4, 2, 16, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):        # int64 tables
        K.paged_flash_decode(q, kp, kp, bt.long(), lens, scale=0.25)
    with pytest.raises(ValueError):       # non-contiguous pool
        K.paged_flash_decode(q, kp.transpose(0, 1), kp, bt, lens,
                             scale=0.25)
    with pytest.raises(ValueError):       # CPU table for CUDA queries
        K.paged_flash_decode(q, kp, kp, bt.cpu(), lens, scale=0.25)
    with pytest.raises(ValueError):       # chunk past its block row
        K.paged_flash_prefill(q[:1], kp, kp, bt[0], 8, scale=0.25)


def test_engine_on_cuda_runs_the_kernels_and_matches_cpu(cuda):
    """Reduced qwen3 (untied, f32): the CUDA engine launches each kernel
    once per layer per prefill chunk and decode step, and emits the CPU
    engine's tokens."""
    cfg = dataclasses.replace(configs.get_arch("qwen3-0.6b").reduced(),
                              tie_embeddings=False)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [3, 1], [9] * 12,
               [2, 4, 6, 8], [13]]
    out = {}
    for dev in ("cpu", "cuda"):
        K.paged_flash_prefill.launches = K.paged_flash_decode.launches = 0
        eng = ServeEngine(params, cfg, slots=3, max_seq=64,
                          prefill_chunk_len=8, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        out[dev] = [r.out for r in done]
        eng.check_page_invariants()
    assert out["cuda"] == out["cpu"]
    assert K.paged_flash_prefill.launches == \
        eng.stats["prefill_calls"] * cfg.n_layers > 0
    assert K.paged_flash_decode.launches == \
        eng.stats["decode_steps"] * cfg.n_layers > 0
    assert math.isfinite(eng.stats["decode_s"])
    assert np.all(np.asarray(out["cuda"]) < cfg.vocab)


LATENT_GEOMS = [   # (page, n_pool, width, lengths)
    (4, 13, 4, [5, 16, 1]), (64, 31, 8, [300, 511, 515]),
    (128, 29, 8, [48, 1000, 1024])]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("h,kv,rope", [(3, 32, 8), (5, 32, 8), (4, 40, 16),
                                       (5, 64, 16), (128, 512, 64)])
@pytest.mark.parametrize("geom", range(len(LATENT_GEOMS)))
def test_latent_decode_kernel_matches_plain(cuda, dtype, atol, h, kv, rope,
                                            geom):
    """Odd head counts, a kv_lora that is not a multiple of 32, and
    deepseek-v2's full width (bf16 at kv_lora 64 and 512 takes the
    tensor-core kernel); prime pools, tables over several key splits, one
    slot whose length runs past its table."""
    page, n_pool, width, lens = LATENT_GEOMS[geom]
    gen = torch.Generator(device=cuda).manual_seed(geom)
    b = len(lens)
    bt = torch.randperm(n_pool - 1, generator=gen, device=cuda)
    bt = bt[:b * width].reshape(b, width).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    args = (_rand(gen, b, 1, h, kv, dtype=dtype),
            _rand(gen, b, 1, h, rope, dtype=dtype),
            _rand(gen, n_pool, page, kv, dtype=dtype),
            _rand(gen, n_pool, page, rope, dtype=dtype), bt, lens)
    scale = 1 / math.sqrt(kv + rope)
    before = K.paged_latent_decode.launches
    got = ops.paged_latent_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    assert K.paged_latent_decode.launches == before + 1
    want = ops.paged_latent_decode_attention(*args, scale=scale,
                                             use_kernel=False)
    assert _err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("h,kv,rope", [(3, 32, 8), (5, 32, 8), (4, 40, 16),
                                       (5, 64, 16), (128, 512, 64)])
@pytest.mark.parametrize("page,width,n_pool,c,start", [
    (4, 4, 13, 8, 8), (5, 2, 7, 5, 5), (16, 16, 23, 24, 200),
    (128, 8, 11, 128, 896)])
def test_latent_prefill_kernel_matches_plain(cuda, dtype, atol, h, kv, rope,
                                             page, width, n_pool, c, start):
    """Prime pages and pools, a chunk over several key splits, and the
    full-width serving chunk (C = 128 at start 896)."""
    gen = torch.Generator(device=cuda).manual_seed(page)
    row = torch.randperm(n_pool, generator=gen, device=cuda)[:width]
    args = (_rand(gen, 1, c, h, kv, dtype=dtype),
            _rand(gen, 1, c, h, rope, dtype=dtype),
            _rand(gen, n_pool, page, kv, dtype=dtype),
            _rand(gen, n_pool, page, rope, dtype=dtype),
            row.to(torch.int32))
    scale = 1 / math.sqrt(kv + rope)
    before = K.paged_latent_prefill.launches
    got = ops.paged_latent_prefill_attention(*args, start, scale=scale)
    torch.cuda.synchronize()
    assert K.paged_latent_prefill.launches == before + 1
    want = ops.paged_latent_prefill_attention(*args, start, scale=scale,
                                              use_kernel=False)
    assert _err(got, want) <= atol


def test_latent_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ql = torch.zeros(2, 1, 4, 32, device=cuda)
    qr = torch.zeros(2, 1, 4, 8, device=cuda)
    ck = torch.zeros(5, 4, 32, device=cuda)
    kr = torch.zeros(5, 4, 8, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    dec = K.paged_latent_decode
    with pytest.raises(TypeError):        # float16
        dec(ql.half(), qr.half(), ck.half(), kr.half(), bt, lens, scale=1.0)
    with pytest.raises(TypeError):        # pools of another dtype
        dec(ql, qr, ck.bfloat16(), kr, bt, lens, scale=1.0)
    with pytest.raises(ValueError):       # kv_lora not a multiple of 8
        dec(ql[..., :30].contiguous(), qr, ck[..., :30].contiguous(), kr,
            bt, lens, scale=1.0)
    with pytest.raises(ValueError):       # qk_rope not a multiple of 8
        dec(ql, qr[..., :4].contiguous(), ck, kr[..., :4].contiguous(), bt,
            lens, scale=1.0)
    with pytest.raises(ValueError):       # non-contiguous queries
        dec(ql.transpose(0, 2), qr, ck, kr, bt, lens, scale=1.0)
    with pytest.raises(ValueError):       # kv_lora beyond the kernel's 512
        big = torch.zeros(2, 1, 4, 520, device=cuda)
        dec(big, qr, torch.zeros(5, 4, 520, device=cuda), kr, bt, lens,
            scale=1.0)
    with pytest.raises(ValueError):       # CPU lengths
        dec(ql, qr, ck, kr, bt, lens.cpu(), scale=1.0)
    with pytest.raises(TypeError):        # int64 tables
        dec(ql, qr, ck, kr, bt.long(), lens, scale=1.0)
    with pytest.raises(ValueError):       # chunk past its block row
        K.paged_latent_prefill(ql[:1].expand(1, 9, 4, 32).contiguous(),
                               qr[:1].expand(1, 9, 4, 8).contiguous(), ck,
                               kr, bt[0], 0, scale=1.0)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "olmoe-1b-7b"])
def test_mla_and_moe_engines_on_cuda_match_cpu(cuda, arch):
    """Reduced deepseek-v2 (MLA + MoE) and olmoe (MoE), untied, f32: the
    CUDA engine emits the CPU engine's tokens; deepseek-v2 launches each
    latent kernel once per layer per prefill chunk and decode step."""
    cfg = dataclasses.replace(configs.get_arch(arch).reduced(),
                              tie_embeddings=False)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [3, 1], [9] * 12,
               [2, 4, 6, 8], [13]]
    out = {}
    for dev in ("cpu", "cuda"):
        K.paged_latent_prefill.launches = K.paged_latent_decode.launches = 0
        eng = ServeEngine(params, cfg, slots=3, max_seq=64,
                          prefill_chunk_len=8, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        out[dev] = [r.out for r in done]
        eng.check_page_invariants()
    assert out["cuda"] == out["cpu"]
    if cfg.attn == "mla":
        assert K.paged_latent_prefill.launches == \
            eng.stats["prefill_calls"] * cfg.n_layers > 0
        assert K.paged_latent_decode.launches == \
            eng.stats["decode_steps"] * cfg.n_layers > 0
