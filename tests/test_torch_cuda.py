"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA inputs, and the serving engine on CUDA
running the kernels on every prefill chunk and decode tick.

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
