"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA inputs (the paged GQA pair, the MLA
latent pair, the speculative-verify entries of the two prefill kernels,
the dense flash forward and backward, including the wgmma
kernels' geometries (D 112 among them), their bitwise-reproducible
backward, the variant they take and the pair at its own key length
(Sq != Sk), each model
family's forward launching the flash forward, the PACO matmul and the LCS tile), the serving engine on CUDA
running the kernels on every
prefill chunk, decode tick and verify step, a train step on CUDA running the flash
kernels, and the PACO executors launching the matmul kernel once per
cuboid and the LCS kernel once per table.

These tests carry the ``cuda`` marker and skip on a host without a card;
the file imports neither JAX nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain f32 atol 1e-4; bf16 atol 2e-2 (the plain
version rounds the softmax weights to bf16, the kernel keeps f32).  The
flash kernels' gradients are held relative to max(1, max |plain|), as
``chip_smoke.py`` holds them, and so is the matmul kernel (f32 1e-5, bf16
1e-2: chip_smoke's MM_TOL); LCS is exact.
"""
import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ops, ref
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
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("kw", DECODE_KW)
@pytest.mark.parametrize("geom", ["prime", "splits", "g8_d256", "g8_d64"])
def test_decode_kernel_matches_plain(cuda, dtype, atol, kw, geom):
    """A prime pool of 4-position pages; 64-position pages whose
    512-position tables span the eight ranks of a slot's cluster (one slot
    past its table); G 8 at D 256 (gemma2's decode) and at D 64, with a
    zero-length slot, which gets its row's uniform mean as the plain
    version gives it.  One launch of the variant the library names (bf16
    at D 64, 128 and 256 on tensor cores), bitwise the same over two
    calls."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    if geom == "prime":
        b, hq, hkv, d, page, n_pool = 3, 4, 2, 16, 4, 13
        bt = torch.tensor([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]])
        lens = torch.tensor([5, 16, 1])
    elif geom == "splits":
        b, hq, hkv, d, page, n_pool = 3, 16, 8, 128, 64, 25
        bt = torch.randperm(24)[:24].reshape(3, 8)
        lens = torch.tensor([300, 511, 512])
    else:
        hq, hkv, d = (16, 2, 256) if geom == "g8_d256" else (8, 1, 64)
        b, page, n_pool = 3, 16, 29
        bt = torch.randperm(28)[:24].reshape(3, 8)
        lens = torch.tensor([0, 77, 128])
    bt = bt.to(cuda, torch.int32)
    lens = lens.to(cuda, torch.int32)
    q = _rand(gen, b, 1, hq, d, dtype=dtype)
    kp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    vp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    before = (K.paged_flash_decode.launches,
              K.paged_flash_decode.variants.copy())
    got = ops.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert K.paged_flash_decode.launches == before[0] + 1
    variant = ("mma_sync" if dtype == torch.bfloat16 and d in (64, 128, 256)
               else "cuda_cores")
    assert K.paged_flash_decode.variants - before[1] == {variant: 1}
    assert torch.equal(got, ops.paged_decode_attention(q, kp, vp, bt, lens,
                                                       **kw))
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


# (dtype, d, the variant paged_prefill takes)
PREFILL_VARIANT_CASES = [(torch.bfloat16, 16, "mma_sync"),
                         (torch.bfloat16, 64, "mma_sync"),
                         (torch.bfloat16, 128, "mma_sync"),
                         (torch.bfloat16, 256, "mma_sync"),
                         (torch.bfloat16, 8, "cuda_cores"),
                         (torch.bfloat16, 48, "cuda_cores"),
                         (torch.float32, 128, "cuda_cores")]


@pytest.mark.parametrize("dtype,d,variant", PREFILL_VARIANT_CASES)
@pytest.mark.parametrize("kw", [{}, {"window": 300, "logit_cap": 30.0}])
def test_prefill_takes_the_variant_the_library_names(cuda, dtype, d, variant,
                                                     kw):
    """bf16 at D 16 to 256 runs on tensor cores (mma.sync), float32 and
    other widths on CUDA cores; each within ATOL of the plain version at
    qwen3-0.6b's chunk (C 64, Hq 16, Hkv 8: 128 rows a CTA) late in a
    1000-token prompt, over eight key splits."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    hq, hkv, page, width, n_pool, c, start = 16, 8, 64, 16, 40, 64, 960
    row = torch.randperm(n_pool - 1)[:width].to(cuda, torch.int32)
    q = _rand(gen, 1, c, hq, d, dtype=dtype)
    kp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    vp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    before = K.paged_flash_prefill.variants.copy()
    got = K.paged_flash_prefill(q, kp, vp, row, start,
                                scale=1 / math.sqrt(d), **kw)
    torch.cuda.synchronize()
    assert K.paged_flash_prefill.variants - before == {variant: 1}
    want = ops.paged_prefill_attention(q, kp, vp, row, start,
                                       use_kernel=False, **kw)
    assert _err(got, want) <= dict(DTYPES)[dtype]


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


# (dtype, h, kv, rope, page, the variant paged_latent_prefill takes)
LATENT_VARIANT_CASES = [(torch.bfloat16, 3, 512, 64, 64, "wgmma"),
                        (torch.bfloat16, 5, 512, 64, 128, "wgmma"),
                        (torch.bfloat16, 64, 512, 64, 64, "wgmma"),
                        (torch.bfloat16, 128, 512, 64, 128, "wgmma"),
                        (torch.bfloat16, 5, 512, 64, 16, "mma_sync"),
                        (torch.bfloat16, 5, 512, 32, 64, "mma_sync"),
                        (torch.bfloat16, 5, 64, 16, 64, "mma_sync"),
                        (torch.bfloat16, 5, 40, 16, 64, "cuda_cores"),
                        (torch.float32, 5, 512, 64, 128, "cuda_cores")]


@pytest.mark.parametrize("dtype,h,kv,rope,page,variant", LATENT_VARIANT_CASES)
@pytest.mark.parametrize("c,start", [(37, 200), (9, 3), (128, 896)])
def test_latent_prefill_takes_the_variant_the_library_names(
        cuda, dtype, h, kv, rope, page, variant, c, start):
    """deepseek-v2's widths (kv_lora 512, qk_rope 64) in bf16 take the
    wgmma kernel: 64-row blocks that straddle positions (H 3, 5), blocks of
    one position (H 64, 128), starts off the 64-key tile, short chunks
    whose keys split; other pages and widths keep the mma.sync or CUDA-core
    kernel.  Each within ATOL of the plain version and bitwise the same
    over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(c + h)
    width = -(-(start + c) // page)
    n_pool = width + 3
    row = torch.randperm(n_pool, generator=gen, device=cuda)[:width]
    args = (_rand(gen, 1, c, h, kv, dtype=dtype),
            _rand(gen, 1, c, h, rope, dtype=dtype),
            _rand(gen, n_pool, page, kv, dtype=dtype),
            _rand(gen, n_pool, page, rope, dtype=dtype),
            row.to(torch.int32))
    scale = 1 / math.sqrt(kv + rope)
    before = K.paged_latent_prefill.variants.copy()
    got = K.paged_latent_prefill(*args, start, scale=scale)
    torch.cuda.synchronize()
    assert K.paged_latent_prefill.variants - before == {variant: 1}
    assert torch.equal(got, K.paged_latent_prefill(*args, start,
                                                   scale=scale))
    want = ops.paged_latent_prefill_attention(*args, start, scale=scale,
                                              use_kernel=False)
    assert _err(got, want) <= dict(DTYPES)[dtype]


@pytest.mark.parametrize("h,page", [(128, 128), (128, 64), (5, 64),
                                    (70, 128)])
def test_latent_decode_takes_wgmma_with_live_key_ranks(cuda, h, page):
    """deepseek-v2's widths (kv_lora 512, qk_rope 64) in bf16 take the
    wgmma decode: one launch of clusters of 4 ranks, lengths 1, 63,
    64, 65 (ranks past the live keys hold nothing), 1000, the full width
    and past it, and 0 (the whole row's uniform mean); within ATOL of the
    plain version and bitwise the same over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(h + page)
    width = 2048 // page
    lens = [1, 63, 64, 65, 1000, 2048, 2049, 0]
    b = len(lens)
    n_pool = b * width + 1
    bt = torch.randperm(n_pool - 1, generator=gen, device=cuda)
    bt = bt[:b * width].reshape(b, width).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    bf = torch.bfloat16
    args = (_rand(gen, b, 1, h, 512, dtype=bf),
            _rand(gen, b, 1, h, 64, dtype=bf),
            _rand(gen, n_pool, page, 512, dtype=bf),
            _rand(gen, n_pool, page, 64, dtype=bf), bt, lens)
    scale = 1 / math.sqrt(192)
    dec = K.paged_latent_decode
    before = dec.launches, dec.variants.copy()
    got = dec(*args, scale=scale)
    again = dec(*args, scale=scale)
    torch.cuda.synchronize()
    assert dec.launches == before[0] + 2
    assert dec.variants - before[1] == {"wgmma": 2}
    assert torch.equal(got, again)
    want = ops.paged_latent_decode_attention(*args, scale=scale,
                                             use_kernel=False)
    assert _err(got, want) <= 2e-2


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


# ---------------------------------------------------------------------------
# speculative verify: the multi-slot entries of the two prefill kernels
# ---------------------------------------------------------------------------

VERIFY_GEOMS = [   # (B, W, Hq, Hkv, D, page, width, lengths)
    (3, 4, 4, 2, 16, 4, 4, [5, 12, 0]),
    # qwen3-0.6b's serving verify: a window crossing a page, one reaching
    # the last mapped page, an inactive slot, lengths splits apart
    (8, 8, 16, 8, 128, 64, 16, [0, 60, 64, 1016, 1000, 200, 700, 9]),
    (4, 3, 8, 4, 256, 16, 8, [0, 14, 120, 125]),   # gemma2's heads
    (2, 8, 16, 2, 64, 16, 8, [10, 100])]           # G 8: 64 rows a CTA


def _tables(gen, b, width):
    """A pool of b x width pages plus the null page, and b rows of width
    distinct pages."""
    n_pool = b * width + 1
    bt = torch.randperm(n_pool - 1, generator=gen, device=gen.device)
    bt = bt[:b * width].reshape(b, width).to(torch.int32)
    return n_pool, bt


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("kw", PREFILL_KW)
@pytest.mark.parametrize("geom", range(len(VERIFY_GEOMS)))
def test_verify_kernel_matches_plain_and_repeats_bitwise(cuda, dtype, atol,
                                                         kw, geom):
    """The verify entry of kernel 2 (one launch for all slots, starts read
    on the device) against the plain version, bitwise the same over two
    calls, of the family its shape takes: bf16 at D 64, 128 or 256 with
    W x G <= 16 the cluster walk (splits sized from the lengths on the
    device), other bf16 the tensor-core prefill body and float32 the
    CUDA-core one (splits over the table's width)."""
    b, w, hq, hkv, d, page, width, lens = VERIFY_GEOMS[geom]
    gen = torch.Generator(device=cuda).manual_seed(50 + geom)
    n_pool, bt = _tables(gen, b, width)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert int(lens.max()) + w <= width * page
    q = _rand(gen, b, w, hq, d, dtype=dtype)
    kp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    vp = _rand(gen, n_pool, page, hkv, d, dtype=dtype)
    ver = K.paged_flash_verify
    before = ver.launches, ver.variants.copy()
    got = ops.paged_verify_attention(q, kp, vp, bt, lens, **kw)
    again = ver(q, kp, vp, bt, lens, scale=1 / math.sqrt(d), **kw)
    torch.cuda.synchronize()
    assert ver.launches == before[0] + 2
    variant = ("cuda_cores" if dtype == torch.float32 else
               "cluster" if d in (64, 128, 256) and w * hq // hkv <= 16
               else "mma_sync")
    assert ver.variants - before[1] == {variant: 2}
    assert torch.equal(got, again)
    want = ops.paged_verify_attention(q, kp, vp, bt, lens, use_kernel=False,
                                      **kw)
    assert _err(got, want) <= atol


LATENT_VERIFY_GEOMS = [   # (B, W, H, kv_lora, qk_rope, page, width, lengths)
    (3, 4, 3, 32, 8, 4, 4, [5, 12, 0]),
    (3, 3, 5, 64, 16, 16, 8, [0, 60, 125]),
    # deepseek-v2's serving verify
    (8, 8, 128, 512, 64, 128, 16, [0, 127, 128, 2040, 1000, 300, 64, 1500]),
    (3, 8, 5, 512, 64, 64, 8, [0, 60, 504])]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("geom", range(len(LATENT_VERIFY_GEOMS)))
def test_latent_verify_kernel_matches_plain_and_repeats_bitwise(cuda, dtype,
                                                                atol, geom):
    """The verify entry of kernel 4 against the plain version, bitwise the
    same over two calls; bf16 at deepseek-v2's widths takes the cluster
    family, float32 the CUDA-core one."""
    b, w, h, kv, rope, page, width, lens = LATENT_VERIFY_GEOMS[geom]
    gen = torch.Generator(device=cuda).manual_seed(60 + geom)
    n_pool, bt = _tables(gen, b, width)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert int(lens.max()) + w <= width * page
    args = (_rand(gen, b, w, h, kv, dtype=dtype),
            _rand(gen, b, w, h, rope, dtype=dtype),
            _rand(gen, n_pool, page, kv, dtype=dtype),
            _rand(gen, n_pool, page, rope, dtype=dtype), bt, lens)
    scale = 1 / math.sqrt(kv + rope)
    ver = K.paged_latent_verify
    before = ver.launches, ver.variants.copy()
    got = ops.paged_latent_verify_attention(*args, scale=scale)
    again = ver(*args, scale=scale)
    torch.cuda.synchronize()
    assert ver.launches == before[0] + 2
    if dtype == torch.bfloat16 and kv == 512:
        assert ver.variants - before[1] == {"cluster": 2}
    if dtype == torch.float32:
        assert ver.variants - before[1] == {"cuda_cores": 2}
    assert torch.equal(got, again)
    want = ops.paged_latent_verify_attention(*args, scale=scale,
                                             use_kernel=False)
    assert _err(got, want) <= atol


# chip_smoke.py's verify lengths over tables of 1,024 keys (16 pages of 64,
# 8 of 128): an inactive slot, a window across a page, one reaching the
# last mapped page, slots far apart
CLUSTER_LENS = {64: [0, 60, 1016, 1000, 300, 777, 48, 555],
                128: [0, 124, 1016, 1000, 300, 777, 48, 555]}


def _peak_extra(call, out_bytes):
    """Bytes ``call`` allocated at its peak beyond its output's block
    (the caching allocator rounds a block up to 512 bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base \
        - -(-out_bytes // 512) * 512, out


@pytest.mark.parametrize("mla", [False, True])
def test_verify_cluster_call_is_one_launch_without_scratch(cuda, mla):
    """In bf16 at qwen3-0.6b's and deepseek-v2's serving verify (8 slots,
    W 8, chip_smoke.py's lengths) one call is one launch of the cluster
    family and allocates nothing beside its output: no f32 partials."""
    gen = torch.Generator(device=cuda).manual_seed(70 + mla)
    b, w, bf = 8, 8, torch.bfloat16
    page = 128 if mla else 64
    n_pool, bt = _tables(gen, b, 1024 // page)
    lens = torch.tensor(CLUSTER_LENS[page], dtype=torch.int32, device=cuda)
    if mla:
        ver = K.paged_latent_verify
        args = (_rand(gen, b, w, 128, 512, dtype=bf),
                _rand(gen, b, w, 128, 64, dtype=bf),
                _rand(gen, n_pool, page, 512, dtype=bf),
                _rand(gen, n_pool, page, 64, dtype=bf), bt, lens)
        kw = {"scale": 1 / math.sqrt(192)}
    else:
        ver = K.paged_flash_verify
        args = (_rand(gen, b, w, 16, 128, dtype=bf),
                _rand(gen, n_pool, page, 8, 128, dtype=bf),
                _rand(gen, n_pool, page, 8, 128, dtype=bf), bt, lens)
        kw = {"scale": 1 / math.sqrt(128)}
    ver(*args, **kw)                     # built, and its smem attribute set
    before = ver.launches, ver.variants.copy()
    extra, out = _peak_extra(lambda: ver(*args, **kw),
                             args[0].numel() * 2)
    assert ver.launches == before[0] + 1
    assert ver.variants - before[1] == {"cluster": 1}
    assert extra == 0, extra
    assert out.shape == args[0].shape


@pytest.mark.parametrize("kw", [{"logit_cap": 50.0},
                                {"window": 4096, "logit_cap": 50.0},
                                {"window": 100, "logit_cap": 50.0}])
def test_verify_cluster_at_gemma2_window_and_softcap(cuda, kw):
    """gemma2-2b's verify (Hq 8, Hkv 4, D 256, W 8) with its softcap, its
    local layers' window and a window of 100 that cuts inside the slots'
    ranges, over chip_smoke.py's lengths: the cluster family, within bf16
    ATOL of the plain version and bitwise over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(80)
    b, w, bf = 8, 8, torch.bfloat16
    n_pool, bt = _tables(gen, b, 16)
    lens = torch.tensor(CLUSTER_LENS[64], dtype=torch.int32, device=cuda)
    q = _rand(gen, b, w, 8, 256, dtype=bf)
    kp = _rand(gen, n_pool, 64, 4, 256, dtype=bf)
    vp = _rand(gen, n_pool, 64, 4, 256, dtype=bf)
    ver = K.paged_flash_verify
    before = ver.variants.copy()
    got = ver(q, kp, vp, bt, lens, scale=1 / 16, **kw)
    assert torch.equal(got, ver(q, kp, vp, bt, lens, scale=1 / 16, **kw))
    assert ver.variants - before == {"cluster": 2}
    want = ops.paged_verify_attention(q, kp, vp, bt, lens, use_kernel=False,
                                      **kw)
    assert _err(got, want) <= 2e-2


def test_verify_cluster_rows_past_the_table_match_plain(cuda):
    """Windows running past the table (lengths up to 1,020 over 1,024
    keys) and, with a window of 3, rows whose window lies wholly past it
    (the plain version's uniform mean over the table) and a slot wholly
    past it: the cluster family against the plain version in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(81)
    b, w, bf = 4, 8, torch.bfloat16
    n_pool, bt = _tables(gen, b, 16)
    lens = torch.tensor([1020, 1022, 1030, 5], dtype=torch.int32,
                        device=cuda)
    q = _rand(gen, b, w, 16, 128, dtype=bf)
    kp = _rand(gen, n_pool, 64, 8, 128, dtype=bf)
    vp = _rand(gen, n_pool, 64, 8, 128, dtype=bf)
    for kw in ({}, {"window": 3}):
        got = K.paged_flash_verify(q, kp, vp, bt, lens,
                                   scale=1 / math.sqrt(128), **kw)
        want = ops.paged_verify_attention(q, kp, vp, bt, lens,
                                          use_kernel=False, **kw)
        assert _err(got, want) <= 2e-2, kw


def test_chunk_prefills_repeat_bitwise(cuda):
    """Kernels 2 and 4's chunk paths at their serving shapes (qwen3-0.6b's
    64-token chunk at start 896 over 1,024 keys; deepseek-v2's 128-token
    chunk at start 896, its f32 splits merged by the second kernel) are
    bitwise the same over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(82)
    bf = torch.bfloat16
    row = torch.randperm(17, generator=gen, device=cuda)[:16].to(torch.int32)
    q = _rand(gen, 1, 64, 16, 128, dtype=bf)
    kp = _rand(gen, 17, 64, 8, 128, dtype=bf)
    vp = _rand(gen, 17, 64, 8, 128, dtype=bf)
    got = K.paged_flash_prefill(q, kp, vp, row, 896, scale=1 / math.sqrt(128))
    assert torch.equal(got, K.paged_flash_prefill(
        q, kp, vp, row, 896, scale=1 / math.sqrt(128)))
    lrow = row[:8].clone()
    args = (_rand(gen, 1, 128, 128, 512, dtype=bf),
            _rand(gen, 1, 128, 128, 64, dtype=bf),
            _rand(gen, 17, 128, 512, dtype=bf),
            _rand(gen, 17, 128, 64, dtype=bf), lrow, 896)
    got = K.paged_latent_prefill(*args, scale=1 / math.sqrt(192))
    assert torch.equal(got, K.paged_latent_prefill(
        *args, scale=1 / math.sqrt(192)))


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("kv,rope", [(32, 8), (64, 16), (512, 64)])
def test_latent_decode_zero_length_slot_matches_plain(cuda, dtype, atol, kv,
                                                      rope):
    """Every family of kernel 3 gives a slot of length 0 the uniform mean
    of its row's latents, as the plain version does."""
    gen = torch.Generator(device=cuda).manual_seed(kv)
    b, h, page, width = 3, 5, 64, 4
    n_pool, bt = _tables(gen, b, width)
    lens = torch.tensor([0, 100, 0], dtype=torch.int32, device=cuda)
    args = (_rand(gen, b, 1, h, kv, dtype=dtype),
            _rand(gen, b, 1, h, rope, dtype=dtype),
            _rand(gen, n_pool, page, kv, dtype=dtype),
            _rand(gen, n_pool, page, rope, dtype=dtype), bt, lens)
    scale = 1 / math.sqrt(kv + rope)
    got = K.paged_latent_decode(*args, scale=scale)
    want = ops.paged_latent_decode_attention(*args, scale=scale,
                                             use_kernel=False)
    assert _err(got, want) <= atol


def test_verify_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 4, 4, 16, device=cuda)
    kp = torch.zeros(5, 4, 2, 16, device=cuda)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    ver = K.paged_flash_verify
    with pytest.raises(TypeError):        # int64 lengths
        ver(q, kp, kp, bt, lens.long(), scale=0.25)
    with pytest.raises(ValueError):       # tables of another batch
        ver(q, kp, kp, bt[:1], lens, scale=0.25)
    with pytest.raises(ValueError):       # CPU lengths
        ver(q, kp, kp, bt, lens.cpu(), scale=0.25)
    with pytest.raises(TypeError):        # float16
        ver(q.half(), kp.half(), kp.half(), bt, lens, scale=0.25)
    ql = torch.zeros(2, 4, 4, 32, device=cuda)
    qr = torch.zeros(2, 4, 4, 8, device=cuda)
    ck = torch.zeros(5, 4, 32, device=cuda)
    kr = torch.zeros(5, 4, 8, device=cuda)
    with pytest.raises(ValueError):       # lengths of another batch
        K.paged_latent_verify(ql, qr, ck, kr, bt, lens[:1], scale=1.0)
    with pytest.raises(ValueError):       # q_rope of another window
        K.paged_latent_verify(ql, qr[:, :3].contiguous(), ck, kr, bt, lens,
                              scale=1.0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_speculative_and_single_tick_engines_on_cuda_match_cpu(cuda, arch):
    """Reduced qwen3 and deepseek-v2 (untied, f32): the speculative CUDA
    engine launches the verify entry once per layer per verify step (every
    dispatch verifies: spec_min_accept 0) and the single-tick engine the
    decode kernel once per layer per step; both emit the CPU engines'
    tokens, which are the fused engine's."""
    cfg = dataclasses.replace(configs.get_arch(arch).reduced(),
                              tie_embeddings=False)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = [[1, 2, 3, 1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [3, 1],
               [9] * 12, [2, 4, 6, 8], [13]]
    mla = cfg.attn == "mla"
    verify = K.paged_latent_verify if mla else K.paged_flash_verify
    decode = K.paged_latent_decode if mla else K.paged_flash_decode
    out = {}
    for mode, kw in (("fused", {}), ("spec", {"speculate": 3,
                                               "spec_min_accept": 0}),
                     ("single", {"fused": False})):
        for dev in ("cpu", "cuda"):
            verify.launches = decode.launches = 0
            eng = ServeEngine(params, cfg, slots=3, max_seq=64,
                              prefill_chunk_len=8, device=dev, **kw)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
            done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
            out[mode, dev] = [r.out for r in done]
            eng.check_page_invariants()
        steps = eng.stats["decode_steps"] * cfg.n_layers
        if mode == "spec":
            assert verify.launches == steps > 0 and decode.launches == 0
            assert eng.stats["spec_fallback_dispatches"] == 0
        if mode == "single":
            assert decode.launches == steps > 0 and verify.launches == 0
    assert len(set(map(str, out.values()))) == 1, out


# ---------------------------------------------------------------------------
# dense flash attention (training path)
# ---------------------------------------------------------------------------

# As chip_smoke.FLASH_TOL: max abs error over max(1, max |plain|); bf16
# rounds the softmax weights and dS to bf16 before the tensor-core products.
FLASH_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
FLASH_KW = [{"causal": True}, {"causal": False},
            {"causal": True, "window": 9}, {"causal": True, "logit_cap": 5.0},
            {"causal": False, "window": 20, "logit_cap": 30.0}]


def _rel(a, b):
    return _err(a, b) / max(1.0, b.float().abs().max().item())


def _own_rel(a, b):
    """As ``_rel`` with no floor: a gradient held to its own scale."""
    return _err(a, b) / b.float().abs().max().item()


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("kw", FLASH_KW)
@pytest.mark.parametrize("g,d,s", [(1, 64, 128), (2, 128, 77), (8, 256, 77),
                                   (3, 16, 50)])
def test_flash_kernels_match_plain(cuda, dtype, tol, kw, g, d, s):
    """Forward O and backward dQ, dK, dV through the autograd Function
    against ``attention_ref`` and its autograd gradient; each call
    launches each kernel once."""
    gen = torch.Generator(device=cuda).manual_seed(g * d + s)
    b, hkv = 2, 2
    q, k, v, d_o = (_rand(gen, b, s, h, d, dtype=dtype)
                    for h in (hkv * g, hkv, hkv, hkv * g))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = K.flash_attention.launches, K.flash_attention_bwd.launches
    o = K.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, d_o)
    torch.cuda.synchronize()
    assert (K.flash_attention.launches, K.flash_attention_bwd.launches) == \
        (f0 + 1, b0 + 1)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    assert _rel(o, want_o) <= tol
    for got, want in zip(grads, want_g):
        assert got.dtype == dtype and _rel(got, want) <= tol


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _rand(gen, 1, 8, 4, 16, dtype=torch.float32)
    k = _rand(gen, 1, 8, 2, 16, dtype=torch.float32)
    with pytest.raises(TypeError):
        K.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):          # k and v of other lengths
        K.flash_attention(q, k, k[:, :4].contiguous())
    with pytest.raises(ValueError):          # heads do not group
        K.flash_attention(q[:, :, :3].contiguous(), k, k)
    with pytest.raises(ValueError):          # head_dim not a multiple of 8
        K.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                          k[..., :12].contiguous())
    with pytest.raises(ValueError):          # G above the kernel's 32
        K.flash_attention(_rand(gen, 1, 8, 33, 16, dtype=torch.float32),
                          k[:, :, :1].contiguous(), k[:, :, :1].contiguous())
    with pytest.raises(ValueError):          # not contiguous
        K.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError):          # other positions on CUDA
        from repro_torch.models import layers as L
        pos = torch.arange(8, device=cuda)
        L.attention(q, k, k, q_positions=pos + 1, k_positions=pos + 1)


# The forward at its own key length (a cross-attention, Sq != Sk): Sq, Sk,
# D, causal, as chip_smoke.py's kernels phase checks them, and seamless's
# 16 heads at D 64
OWN_KEY_LENGTH = [(256, 1024, 64, False), (1024, 256, 64, False),
                  (300, 1000, 64, True), (512, 768, 128, False),
                  (512, 768, 256, False), (77, 130, 16, True),
                  (2048, 2048, 112, True)]


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("sq,sk,d,causal", OWN_KEY_LENGTH)
def test_flash_forward_at_its_own_key_length_matches_plain(cuda, dtype, tol,
                                                           sq, sk, d, causal):
    """Every forward family (bf16 wgmma at D 64, 112 and 128, or its split
    family where B 2 x Hkv 4 fills few processors, mma.sync at 256, the
    CUDA cores at 16 and in float32) with Sq != Sk, ragged on both sides,
    causal or not: within the plain version's bound, one launch of the
    variant the library names, bitwise the same over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    b, hkv, g = 2, 4, 2
    q = _rand(gen, b, sq, hkv * g, d, dtype=dtype)
    k, v = (_rand(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    name = K._flash_variant("flash_fwd", dtype, d, K._flash_ranks(
        "flash_fwd", dtype, b, sq, sk, hkv * g, hkv, d, causal, 2 ** 31 - 1))
    before = K.flash_attention.variants[name]
    with torch.no_grad():
        o = K.flash_attention(q, k, v, causal=causal)
        again = K.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.flash_attention.variants[name] == before + 2
    assert torch.equal(o, again)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal)
    assert _rel(o, want.transpose(1, 2)) <= tol


# The backward at its own key length: (Sq, Sk, causal, window); Sq < Sk
# causal (and windowed) leaves the keys past Sq seen by no query
BWD_OWN_KEY_LENGTH = [(256, 1024, False, None), (1024, 256, False, None),
                      (300, 1000, True, None), (77, 300, True, 40),
                      (300, 77, False, 260)]
# (dtype, D, the family the library names at one rank): both backward
# families; bf16 at D 64, 112 and 128 takes the split family ``cluster``
# where the library splits the shape
BWD_OWN_KEY_FAMILIES = [(torch.bfloat16, 64, "wgmma"),
                        (torch.bfloat16, 128, "wgmma"),
                        (torch.bfloat16, 112, "wgmma"),
                        (torch.float32, 64, "wgmma_tf32x3"),
                        (torch.float32, 128, "wgmma_tf32x3"),
                        (torch.float32, 16, "cuda_cores"),
                        (torch.bfloat16, 16, "cuda_cores")]


@pytest.mark.parametrize("dtype,d,family", BWD_OWN_KEY_FAMILIES)
@pytest.mark.parametrize("sq,sk,causal,window", BWD_OWN_KEY_LENGTH)
def test_flash_backward_at_its_own_key_length_matches_plain(
        cuda, dtype, d, family, sq, sk, causal, window):
    """Kernel 5b with Sq != Sk (a cross-attention) in both families: autograd
    through ``flash_attention`` launches the forward and the backward once
    each (counted as cross launches, of the family the library names),
    dq, dk and dv each within FLASH_DTYPES' bound of the plain gradient
    relative to its own max |plain| (``_own_rel``, no floor at 1), a
    second backward call bitwise the same, and keys no query sees (past Sq
    under the causal mask, or out of every window) exactly zero in dk and
    dv."""
    gen = torch.Generator(device=cuda).manual_seed(sq + 3 * sk + d)
    b, hkv, g = 2, 4, 2
    tol = dict(FLASH_DTYPES)[dtype]
    q, d_o = (_rand(gen, b, sq, hkv * g, d, dtype=dtype) for _ in range(2))
    k, v = (_rand(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    kw = {"causal": causal, "window": window}
    assert K._flash_variant("flash_bwd", dtype, d) == family
    ranks = K._flash_ranks("flash_bwd", dtype, b, sq, sk, hkv * g, hkv, d,
                           causal, window or 2 ** 31 - 1)
    if ranks > 1:
        assert family == "wgmma"
        family = "cluster"
    n0 = (K.flash_attention_bwd.launches, K.flash_attention_bwd.cross_launches,
          K.flash_attention_bwd.variants[family])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = K.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(o, leaves, d_o)
    torch.cuda.synchronize()
    assert (K.flash_attention_bwd.launches, K.flash_attention_bwd
            .cross_launches, K.flash_attention_bwd.variants[family]) == \
        tuple(n + 1 for n in n0)
    o2, lse = K._flash_fwd(q, k, v, causal=causal, window=window,
                           logit_cap=None)
    assert torch.equal(o2, o.detach())
    again = K.flash_attention_bwd(q, k, v, o2, lse, d_o, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    for got, w in zip(grads, want):
        assert got.dtype == dtype and got.shape == w.shape
        assert _own_rel(got, w) <= tol
    qp = torch.arange(sq, device=cuda)[:, None]
    kp = torch.arange(sk, device=cuda)[None, :]
    seen = ((qp - kp) < (window or 2 ** 31))
    if causal:
        seen &= kp <= qp
    unseen = ~seen.any(0)
    assert bool(unseen.any()) == (causal and sq < sk)
    for grad in grads[1:]:
        assert not grad[:, unseen].any()


# seamless-m4t-medium's cross-attention (B 2, Hq = Hkv = 16, Sq 256 against
# Sk 1024, D 64, no mask) and its decoder self-attention (S 256, causal)
SEAMLESS_CROSS = (2, 16, 16, 256, 1024, 64, False)
SEAMLESS_SELF = (2, 16, 16, 256, 256, 64, True)


def _kernel_launches(fn):
    """(what fn returns, the CUDA kernels it launched by name) from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and "flash" in e.name
             or e.device_type == DeviceType.CUDA and "delta" in e.name]
    return out, names


def test_split_family_takes_seamless_cross_attention(cuda):
    """bf16 at seamless's cross shape runs the split family (variant
    ``cluster``, the chooser's count equal to ``split_ranks``'s on this
    card): the forward is one launch, the backward two (no Delta launch),
    neither allocates more than its outputs and the backward's (B, Hq, Sq)
    f32 Delta, both are bitwise the same over two calls and within
    FLASH_TOL of the plain versions; the training shape keeps ``wgmma``."""
    b, hq, hkv, sq, sk, d, causal = SEAMLESS_CROSS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lib in ("flash_fwd", "flash_bwd"):
        r = K._flash_ranks(lib, torch.bfloat16, b, sq, sk, hq, hkv, d, causal,
                           2 ** 31 - 1)
        assert r == K.split_ranks(lib, b, sq, sk, hq, hkv, d, torch.bfloat16,
                                  causal=causal, sms=sms) > 1
        assert K._flash_variant(lib, torch.bfloat16, d, r) == "cluster"
        assert K._flash_ranks(lib, torch.bfloat16, 2, 4096, 4096, 16, 8, 128,
                              True, 2 ** 31 - 1) == 1
    gen = torch.Generator(device=cuda).manual_seed(24)
    q, d_o = (_rand(gen, b, sq, hq, d, dtype=torch.bfloat16)
              for _ in range(2))
    k, v = (_rand(gen, b, sk, hkv, d, dtype=torch.bfloat16) for _ in range(2))
    n0 = (K.flash_attention.variants["cluster"],
          K.flash_attention_bwd.variants["cluster"])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (o, lse), fwd_names = _kernel_launches(lambda: K._flash_fwd(
        q, k, v, causal=causal, window=None, logit_cap=None))
    assert torch.cuda.max_memory_allocated() - base <= \
        o.numel() * 2 + lse.numel() * 4 + 4096
    assert len(fwd_names) == 1 and "fwd_split" in fwd_names[0], fwd_names
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads, bwd_names = _kernel_launches(lambda: K.flash_attention_bwd(
        q, k, v, o, lse, d_o, causal=causal))
    assert torch.cuda.max_memory_allocated() - base <= \
        sum(t.numel() * 2 for t in grads) + lse.numel() * 4 + 4096
    assert len(bwd_names) == 2 and "dq_split" in bwd_names[0], bwd_names
    assert (K.flash_attention.variants["cluster"],
            K.flash_attention_bwd.variants["cluster"]) == (n0[0] + 1,
                                                          n0[1] + 1)
    o2, lse2 = K._flash_fwd(q, k, v, causal=causal, window=None,
                            logit_cap=None)
    again = K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    assert _rel(o, ref.attention_ref(*tr[:3], causal=causal)
                .transpose(1, 2)) <= 2e-2
    for got, w in zip(grads, ref.attention_ref_grad(*tr, causal=causal)):
        assert _own_rel(got, w.transpose(1, 2)) <= 2e-2


@pytest.mark.parametrize("shape", [SEAMLESS_CROSS, SEAMLESS_SELF],
                         ids=["cross", "decoder_self"])
def test_split_family_through_the_autograd_function(cuda, shape):
    """``FlashAttention`` at seamless's cross and decoder-self shapes runs
    the split family where the library splits (the cross pair, the decoder
    self-attention's backward) and its gradient is within FLASH_TOL of
    ``ref.attention_ref_grad``, each of dq, dk, dv of its own max; at
    each of the library's cluster sizes (``SPLIT_RANKS``) the pair is
    bitwise the same over two calls."""
    b, hq, hkv, sq, sk, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q, d_o = (_rand(gen, b, sq, hq, d, dtype=torch.bfloat16)
              for _ in range(2))
    k, v = (_rand(gen, b, sk, hkv, d, dtype=torch.bfloat16) for _ in range(2))
    ranks = [K._flash_ranks(lib, torch.bfloat16, b, sq, sk, hq, hkv, d,
                            causal, 2 ** 31 - 1)
             for lib in ("flash_fwd", "flash_bwd")]
    assert ranks == ([2, 2] if sq != sk else [1, 2])
    n0 = K.flash_attention_bwd.variants["cluster"]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = K.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(o, leaves, d_o)
    torch.cuda.synchronize()
    assert K.flash_attention_bwd.variants["cluster"] == n0 + 1
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want = [t.transpose(1, 2) for t in ref.attention_ref_grad(
        *tr, causal=causal)]
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and _own_rel(got, w) <= 2e-2
    for r in K.SPLIT_RANKS:
        o1, lse1 = K._flash_fwd(q, k, v, causal=causal, window=None,
                                logit_cap=None, ranks=r)
        o2, lse2 = K._flash_fwd(q, k, v, causal=causal, window=None,
                                logit_cap=None, ranks=r)
        g1 = K.flash_attention_bwd(q, k, v, o1, lse1, d_o, causal=causal,
                                   ranks=r)
        g2 = K.flash_attention_bwd(q, k, v, o1, lse1, d_o, causal=causal,
                                   ranks=r)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
        assert all(torch.equal(a, c) for a, c in zip(g1, g2))
        for got, w in zip(g1, want):
            assert _own_rel(got, w) <= 2e-2


def test_split_entries_refuse_what_they_do_not_take(cuda):
    """A rank count other than 1 or 2 (clusters of 4 are built only with
    FLASH_MAX_RANKS 4, in ``launch.flash_bench``'s copy), or above 1 for a
    family without a split (float32, D 16, D 256), raises before any
    launch: the library refuses it, or, for the float32 family at D 64
    and 128 (``wgmma_tf32x3``), the wrapper."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for dtype, d, r in ((torch.bfloat16, 64, 3), (torch.bfloat16, 64, 4),
                        (torch.float32, 16, 2),
                        (torch.bfloat16, 16, 2), (torch.bfloat16, 256, 2)):
        q = _rand(gen, 1, 64, 2, d, dtype=dtype)
        with pytest.raises(RuntimeError, match="launch failed"):
            K._flash_fwd(q, q, q, causal=True, window=None, logit_cap=None,
                         ranks=r)
    for d in (64, 128):
        q = _rand(gen, 1, 64, 2, d, dtype=torch.float32)
        n0 = K.flash_attention.launches
        with pytest.raises(ValueError, match="no key split"):
            K._flash_fwd(q, q, q, causal=True, window=None, logit_cap=None,
                         ranks=2)
        assert K.flash_attention.launches == n0


def test_cross_attention_refuses_an_empty_row(cuda):
    """Sq != Sk: a window that leaves the last query rows no key raises in
    the forward and the backward wrapper, before any launch; one key more
    runs (and a gradient is taken, no longer refused)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _rand(gen, 1, 64, 4, 64, dtype=torch.bfloat16)
    k = _rand(gen, 1, 32, 4, 64, dtype=torch.bfloat16)
    launches = K.flash_attention.launches, K.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="no key"):
        K.flash_attention(q.detach(), k, k, causal=True, window=32)
    o, lse = K._flash_fwd(q, k, k, causal=True, window=33, logit_cap=None)
    with pytest.raises(ValueError, match="no key"):
        K.flash_attention_bwd(q, k, k, o, lse, q, causal=True, window=32)
    leaves = [t.clone().requires_grad_() for t in (q, k, k)]
    out = K.flash_attention(*leaves, causal=True, window=33)
    torch.autograd.grad(out, leaves, q)
    torch.cuda.synchronize()
    assert (K.flash_attention.launches, K.flash_attention_bwd.launches) == \
        (launches[0] + 2, launches[1] + 1)


# The key-block entries of kernels 5 and 5b (sequence-parallel attention):
# (dtype, D, G, the forward's family, the backward's) over every family
BLOCK_FAMILIES = [(torch.float32, 64, 2, "wgmma_tf32x3", "wgmma_tf32x3"),
                  (torch.float32, 128, 2, "wgmma_tf32x3", "wgmma_tf32x3"),
                  (torch.float32, 16, 2, "cuda_cores", "cuda_cores"),
                  (torch.bfloat16, 16, 2, "cuda_cores", "cuda_cores"),
                  (torch.bfloat16, 64, 2, "wgmma", "wgmma"),
                  (torch.bfloat16, 112, 1, "wgmma", "wgmma"),
                  (torch.bfloat16, 128, 2, "wgmma", "wgmma"),
                  (torch.bfloat16, 256, 2, "wgmma", "wgmma")]
# (Sq, Sk, masks): causal, gemma2's window and softcap (rows that see no
# key in most blocks), a non-causal cross-attention with Sq != Sk
BLOCK_CASES = [(300, 300, {"causal": True}),
               (300, 300, {"causal": True, "window": 40, "logit_cap": 50.0}),
               (200, 300, {"causal": False})]


@pytest.mark.parametrize("dtype,d,g,fwd_family,bwd_family", BLOCK_FAMILIES)
@pytest.mark.parametrize("sq,sk,kw", BLOCK_CASES)
@pytest.mark.parametrize("p", [1, 3, 5])
def test_flash_key_block_entries_match_plain_and_merge(
        cuda, dtype, d, g, fwd_family, bwd_family, sq, sk, kw, p):
    """Each of p contiguous key blocks through ``flash_attention_block``:
    O (f32) within the tolerance of ``ref.attention_block_ref`` on the same
    CUDA inputs, lse -inf exactly on the rows that see no key of the block
    (and nowhere else), bitwise the same over two calls; ``seq_attention``
    over the blocks (the list reduction) against the whole ``attention_ref``
    and, through autograd, its gradient (each relative to its own max);
    p launches of each entry, of the families the library names.  At p = 1
    the merged O is bitwise the whole-sequence kernel's O."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d + p)
    b, hkv = 2, 2
    tol = dict(FLASH_DTYPES)[dtype]
    q, d_o = (_rand(gen, b, sq, hkv * g, d, dtype=dtype) for _ in range(2))
    k, v = (_rand(gen, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    bounds = [round(i * sk / p) for i in range(p + 1)]
    ks = [k[:, a:c].contiguous() for a, c in zip(bounds, bounds[1:])]
    vs = [v[:, a:c].contiguous() for a, c in zip(bounds, bounds[1:])]
    for kb, vb, off in zip(ks, vs, bounds):
        o, lse = K.flash_attention_block(q, kb, vb, k_off=off, **kw)
        o2, lse2 = K.flash_attention_block(q, kb, vb, k_off=off, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        want_o, want_lse = ref.attention_block_ref(q, kb, vb, k_off=off, **kw)
        assert o.dtype == torch.float32
        assert _rel(o, want_o) <= tol
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        live = torch.isfinite(want_lse)
        assert _err(lse[live], want_lse[live]) <= 1e-3
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = (K.flash_attention_block.variants[fwd_family],
          K.flash_attention_block_bwd.variants[bwd_family])
    out = K.seq_attention(
        leaves[0], [leaves[1][:, a:c] for a, c in zip(bounds, bounds[1:])],
        [leaves[2][:, a:c] for a, c in zip(bounds, bounds[1:])], bounds[:-1],
        blocks=K.KeyBlocks(), **kw)
    grads = torch.autograd.grad(out, leaves, d_o)
    torch.cuda.synchronize()
    assert (K.flash_attention_block.variants[fwd_family],
            K.flash_attention_block_bwd.variants[bwd_family]) == \
        (n0[0] + p, n0[1] + p)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    assert _rel(out, ref.attention_ref(*tr[:3], **kw).transpose(1, 2)) <= tol
    want = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    for got, w in zip(grads, want):
        assert got.dtype == dtype and _own_rel(got, w) <= tol
    if p == 1:
        whole, _ = K._flash_fwd(q, k, v, causal=kw["causal"],
                                window=kw.get("window"),
                                logit_cap=kw.get("logit_cap"))
        assert torch.equal(out.detach(), whole)


@pytest.mark.parametrize("arch,launches", [
    ("qwen3-0.6b", 2), ("mamba2-780m", 0), ("zamba2-7b", 1),
    ("seamless-m4t-medium", 6)])
def test_family_forwards_take_the_flash_kernel(cuda, arch, launches):
    """Each family's forward on CUDA (reduced, float32) launches the flash
    forward where ``repro`` calls attention (zamba2: the shared block once
    a group; seamless: the encoder, the decoder's self-attention and its
    cross-attention each layer; mamba2: none) and agrees with the plain
    path within 1e-4; qwen3's non-paged prefill launches it each layer."""
    from repro_torch import models as M

    cfg = configs.get_arch(arch).reduced()
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=gen,
                                     device=cuda)}
    if cfg.family == "encdec":
        batch["src_emb"] = _rand(gen, 2, 40, cfg.d_model,
                                 dtype=torch.float32)
    with torch.no_grad():
        n0 = K.flash_attention.launches
        v0 = K.flash_attention.variants["cuda_cores"]
        got = M.forward(params, cfg, batch)
        torch.cuda.synchronize()
        assert K.flash_attention.launches - n0 == launches
        assert K.flash_attention.variants["cuda_cores"] - v0 == launches
        want = M.forward(params, cfg, batch, use_kernel=False)
        assert _err(got, want) <= 1e-4
        if cfg.family == "decoder":
            n0 = K.flash_attention.launches
            lg, _, _ = M.prefill(params, cfg, batch, 32)
            assert K.flash_attention.launches - n0 == cfg.n_layers
            assert _err(lg, want[:, -1]) <= 1e-4


# bf16 at D 64, 112 (padded to 128), 128 and 256 takes the wgmma kernels:
# the training length, ragged lengths, G 1, 2, 6 (rows of the 128 left
# unused) and 8; zamba2's shared block at D 112 and S 2048; gemma2-2b's
# D 256 (its own tiles) at G 1, 2 and 8
WGMMA_GEOMS = [(2, 128, 4096), (1, 64, 4096), (6, 128, 333), (8, 64, 1000),
               (2, 64, 77), (1, 128, 200), (1, 112, 2048), (2, 112, 333),
               (1, 256, 333), (2, 256, 4096), (8, 256, 1000)]


@pytest.mark.parametrize("kw", FLASH_KW)
@pytest.mark.parametrize("g,d,s", WGMMA_GEOMS)
def test_wgmma_flash_kernels_match_plain_and_repeat_bitwise(cuda, kw, g, d,
                                                            s):
    """The bf16 forward and backward at D 64, 112, 128 and 256 launch the
    wgmma kernels, or the split family where B 2 x Hkv 2 fills few
    processors (the wrappers' per-variant counts, as the library names
    them for the shape), agree with the plain versions within
    FLASH_DTYPES' bf16 bound, and the backward gives bitwise the same dq,
    dk and dv on a second call; the unsplit kernels (``ranks=1``) are held
    so at every geometry too."""
    gen = torch.Generator(device=cuda).manual_seed(g * d + s)
    b, hkv, dtype = 2, 2, torch.bfloat16
    q, k, v, d_o = (_rand(gen, b, s, h, d, dtype=dtype)
                    for h in (hkv * g, hkv, hkv, hkv * g))
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    w = kw.get("window") or 2 ** 31 - 1
    fams = [K._flash_variant(lib, dtype, d, K._flash_ranks(
        lib, dtype, b, s, s, hkv * g, hkv, d, kw["causal"], w))
        for lib in ("flash_fwd", "flash_bwd")]
    assert all(f in ("wgmma", "cluster") for f in fams)
    for ranks in (None, 1):
        f0 = K.flash_attention.variants.copy()
        b0 = K.flash_attention_bwd.variants.copy()
        o, lse = K._flash_fwd(q, k, v, causal=kw["causal"],
                              window=kw.get("window"),
                              logit_cap=kw.get("logit_cap"), ranks=ranks)
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, ranks=ranks,
                                      **kw)
        again = K.flash_attention_bwd(q, k, v, o, lse, d_o, ranks=ranks,
                                      **kw)
        torch.cuda.synchronize()
        assert (K.flash_attention.variants - f0,
                K.flash_attention_bwd.variants - b0) == (
            {fams[0] if ranks is None else "wgmma": 1},
            {fams[1] if ranks is None else "wgmma": 2})
        assert all(torch.equal(a, c) for a, c in zip(grads, again))
        assert _rel(o, want_o) <= 2e-2
        for got, want in zip(grads, want_g):
            assert got.dtype == dtype and _rel(got, want) <= 2e-2


def test_flash_wrappers_take_the_variant_the_library_names(cuda):
    """bf16 at D 64, 112, 128 and 256 reports wgmma, float32 at D 64 and
    128 wgmma_tf32x3 (three TF32 products), other widths the CUDA cores,
    and each wrapper counts its launch under that name."""
    want = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
            (torch.bfloat16, 112): "wgmma",
            (torch.bfloat16, 256): "wgmma",
            (torch.bfloat16, 16): "cuda_cores",
            (torch.float32, 128): "wgmma_tf32x3",
            (torch.float32, 64): "wgmma_tf32x3",
            (torch.float32, 16): "cuda_cores"}
    for (dtype, d), name in want.items():
        assert K._flash_variant("flash_fwd", dtype, d) == name
        gen = torch.Generator(device=cuda).manual_seed(d)
        q, k = (_rand(gen, 1, 40, h, d, dtype=dtype) for h in (4, 2))
        before = K.flash_attention.variants[name]
        K.flash_attention(q, k, k)
        torch.cuda.synchronize()
        assert K.flash_attention.variants[name] == before + 1
    assert K._flash_variant("flash_bwd", torch.bfloat16, 128) == "wgmma"
    assert K._flash_variant("flash_bwd", torch.bfloat16, 112) == "wgmma"
    assert K._flash_variant("flash_bwd", torch.bfloat16, 256) == "wgmma"
    assert K._flash_variant("flash_bwd", torch.float32, 64) == "wgmma_tf32x3"
    assert K._flash_variant("flash_bwd", torch.float32, 16) == "cuda_cores"
    for (dtype, d), name in want.items():   # the wrappers' own choice
        assert K._tf32x3(dtype, d) == (name == "wgmma_tf32x3")


@pytest.mark.parametrize("shape", [(2, 4096, 4096, 16, 8, 128),
                                   (2, 256, 1024, 16, 16, 64),
                                   (1, 37, 75, 6, 2, 128),
                                   (3, 1, 9, 4, 4, 64)])
def test_float32_workspace_is_the_library_count(cuda, shape):
    """``tf32x3_ws_floats`` (the wrappers' workspace, sized with no library
    so that a fake call holds it too) counts the floats
    ``<lib>_tf32x3_ws_floats`` asks for, forward and backward, at rows
    5f's and 5bf's shapes and at ragged ones."""
    b, sq, sk, hq, hkv, d = shape
    for lib in ("flash_fwd", "flash_bwd"):
        want = K._fn(lib, f"{lib}_tf32x3_ws_floats", (ctypes.c_int,) * 6,
                     ctypes.c_longlong)(d, b, sq, sk, hq, hkv)
        assert K.tf32x3_ws_floats(lib, b, sq, sk, hq, hkv, d) == want


def test_flash_wrappers_reject_misaligned_bases(cuda):
    """TMA needs 16-byte aligned bases: a q, k, v, o, d_o or lse that
    starts 2 (or 4) bytes into its storage raises before any launch."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, d = 1, 64, 2, 128

    def shifted(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    q, k, v, d_o = (_rand(gen, b, s, h, d, dtype=torch.bfloat16)
                    for _ in range(4))
    assert shifted(q).data_ptr() % 16 and shifted(q).is_contiguous()
    for args in ((shifted(q), k, v), (q, shifted(k), v), (q, k, shifted(v))):
        with pytest.raises(ValueError, match="16-byte"):
            K.flash_attention(*args)
    o, lse = K._flash_fwd(q, k, v, causal=True, window=None, logit_cap=None)
    for o_, d_o_, lse_ in ((shifted(o), d_o, lse), (o, shifted(d_o), lse),
                           (o, d_o, shifted(lse))):
        with pytest.raises(ValueError, match="16-byte"):
            K.flash_attention_bwd(q, k, v, o_, lse_, d_o_)


def test_train_step_on_cuda_runs_the_kernels_and_matches_cpu(cuda):
    """One reduced qwen3 train step on CUDA (float32) launches the flash
    kernels 2 x layers times forward (remat recomputes) and layers times
    backward, and lands where the same step on the CPU (plain attention)
    lands: loss and gradient norm to 1e-5 relative, the first moment
    within 1e-4 of each leaf's max, and params within 1e-5 plus what that
    moment tolerance allows through AdamW's sign-like first step (an
    element whose gradient is near zero may move either way, by up to
    2 lr; see tests/test_torch_train.py)."""
    from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import TrainConfig, init_train_state, train_step

    cfg = configs.get_arch("qwen3-0.6b").reduced()
    lr = 1e-3
    tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=1))
    dcfg = DataConfig(seq_len=40, global_batch=2, vocab=cfg.vocab)
    out = {}
    f0, b0 = K.flash_attention.launches, K.flash_attention_bwd.launches
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), init_params(cfg, seed=0,
                                                      device="cpu"))
        p, st, m = train_step(p, init_train_state(cfg, tcfg, p),
                              global_batch_rowwise(dcfg, 0, device=dev),
                              cfg=cfg, tcfg=tcfg)
        out[dev] = (m, [t.cpu() for t in tree_leaves(p)],
                    [t.cpu() for t in tree_leaves(st["opt"]["m"])],
                    [t.cpu() for t in tree_leaves(st["opt"]["v"])])
    assert (K.flash_attention.launches - f0,
            K.flash_attention_bwd.launches - b0) == (2 * cfg.n_layers,
                                                     cfg.n_layers)
    mc, mg = out["cpu"][0], out["cuda"][0]
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(
            float(mc[key])), key
    for pg, m_g, _, pc, m_c, v_c in zip(*out["cuda"][1:], *out["cpu"][1:]):
        assert _err(m_g, m_c) <= 1e-4 * m_c.abs().max().item()
        sens = (1e-4 * m_c.abs().max() / 0.1
                / (torch.sqrt(v_c / 0.05) + 1e-8))
        tol = 1e-5 + lr * torch.clamp(sens, max=2.0)
        assert bool(((pg - pc).abs() <= tol).all())


# ---------------------------------------------------------------------------
# the PACO kernels: matmul and the LCS tile
# ---------------------------------------------------------------------------

# kernel vs matmul_ref, relative to max(1, max |plain|): two f32 sums in
# other orders (float32); one bf16 step where the f32 sums round apart
MM_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]
MM_SHAPES = [(1, 1, 1), (17, 23, 31), (97, 131, 61), (128, 32, 128),
             (129, 33, 257), (300, 700, 5), (5, 0, 7), (1024, 1985, 2048)]


@pytest.mark.parametrize("dtype,tol", MM_DTYPES)
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_matmul_kernel_matches_plain(cuda, dtype, tol, shape):
    """Odd, prime and ragged shapes (the last a cuboid of
    plan_mm_1piece(8192, 8192, 8192, 132)), k = 0 included."""
    from repro_torch.kernels.matmul import matmul_kernel, matmul_ref
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    n, k, m = shape
    a, b = _rand(gen, n, k, dtype=dtype), _rand(gen, k, m, dtype=dtype)
    before = matmul_kernel.launches
    got = matmul_kernel(a, b)
    torch.cuda.synchronize()
    assert matmul_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, m)
    assert _rel(got, matmul_ref(a, b)) <= tol


@pytest.mark.parametrize("dtype,tol", MM_DTYPES)
def test_matmul_kernel_reads_strided_views(cuda, dtype, tol):
    from repro_torch.kernels.matmul import matmul_kernel, matmul_ref
    gen = torch.Generator(device=cuda).manual_seed(1)
    big_a = _rand(gen, 300, 400, dtype=dtype)
    big_b = _rand(gen, 400, 500, dtype=dtype)
    odd = _rand(gen, 40, 61, dtype=dtype)   # row stride 61: no 16B phase
    for a, b in [(big_a[3:200, 7:190], big_b[5:188, 11:300]),
                 (big_a[::2, 8:136], big_b[8:136, 128:384]),
                 (big_a[1:2, 1:400], big_b[1:400, 499:500]),
                 (big_a[:, 5:], big_b[5:, 3:]), (odd[:, 2:], big_b[:59, 1:9])]:
        want = matmul_ref(a.contiguous(), b.contiguous())
        assert _rel(matmul_kernel(a, b), want) <= tol


# float32 through three TF32 products (variant "wgmma_tf32x3"): k not a
# multiple of 4 (A padded by the pre-pass where its row stride is not a
# multiple of 4), k = 8192 (the long sum that one accumulator over all of k
# let drift past MM_TOL), a Strassen leaf
TF32_SHAPES = [(1, 1, 1), (17, 23, 31), (129, 33, 257), (1, 4099, 3),
               (130, 4097, 131), (128, 8192, 128), (2048, 2048, 2048)]


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_matmul_kernel_f32_is_wgmma_tf32x3_and_repeats_bitwise(cuda, shape):
    """float32 counts variant ``wgmma_tf32x3``, is within MM_TOL of the
    true-f32 plain version, and is the same bit for bit over two calls."""
    from repro_torch.kernels.matmul import matmul_kernel, matmul_ref
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    n, k, m = shape
    a = _rand(gen, n, k, dtype=torch.float32)
    b = _rand(gen, k, m, dtype=torch.float32)
    before = matmul_kernel.variants.copy()
    got = matmul_kernel(a, b)
    again = matmul_kernel(a, b)
    torch.cuda.synchronize()
    assert matmul_kernel.variants - before == {"wgmma_tf32x3": 2}
    assert torch.equal(got, again)
    assert _rel(got, matmul_ref(a, b)) <= 1e-5


def test_matmul_kernel_f32_views_repeat_bitwise(cuda):
    """Views in float32: row strides of 400 (TMA reads A in place), 61 and
    a base 4 bytes off 16 (the pre-pass pads A), B at any column; within
    MM_TOL and the same bit for bit over two calls, all ``wgmma_tf32x3``."""
    from repro_torch.kernels.matmul import matmul_kernel, matmul_ref
    gen = torch.Generator(device=cuda).manual_seed(11)
    big_a = _rand(gen, 300, 400, dtype=torch.float32)
    big_b = _rand(gen, 400, 500, dtype=torch.float32)
    odd = _rand(gen, 40, 61, dtype=torch.float32)
    pairs = [(big_a[3:200, 8:190], big_b[8:190, 11:300]),
             (big_a[3:200, 7:190], big_b[7:190, 1:2]),
             (odd[:, 2:], big_b[:59, 1:9])]
    before = matmul_kernel.variants.copy()
    for a, b in pairs:
        got = matmul_kernel(a, b)
        assert torch.equal(got, matmul_kernel(a, b))
        assert _rel(got, matmul_ref(a.contiguous(), b.contiguous())) <= 1e-5
    assert matmul_kernel.variants - before == {"wgmma_tf32x3": 2 * len(pairs)}


def test_ops_matmul_launches_the_kernel_where_no_block_divides(cuda):
    """17 x 23 x 31: no size in (128, 64, 32, 16, 8) divides a dimension,
    where repro's ops.matmul falls back to jnp.dot; here the kernel runs."""
    from repro_torch.kernels.matmul import matmul, matmul_kernel, matmul_ref
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = _rand(gen, 17, 23, dtype=torch.float32)
    b = _rand(gen, 23, 31, dtype=torch.float32)
    before = matmul_kernel.launches
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul_kernel.launches == before + 1
    assert _rel(got, matmul_ref(a, b)) <= 1e-5


def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.matmul import matmul_kernel
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = _rand(gen, 8, 8, dtype=torch.float32)
    with pytest.raises(TypeError):            # dtypes differ
        matmul_kernel(a, a.bfloat16())
    with pytest.raises(TypeError):            # not f32 or bf16
        matmul_kernel(a.half(), a.half())
    with pytest.raises(ValueError):           # no unit column stride
        matmul_kernel(a.t(), a)
    with pytest.raises(ValueError):           # not a product
        matmul_kernel(a, a[:5])
    with pytest.raises(ValueError):           # devices differ
        matmul_kernel(a, a.cpu())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("p", [13, 132])
def test_paco_matmul_on_cuda_launches_one_kernel_per_cuboid(cuda, dtype, tol,
                                                            p):
    """One launch per call, p cuboids walked.  bf16 adds the k-cuts'
    partial products in bf16, as repro does: a few bf16 steps, 2e-2 of the
    largest output (chip_smoke's PACO_MM_TOL)."""
    from repro_torch.core import paco_matmul
    from repro_torch.kernels.matmul import (matmul_kernel, matmul_plan_kernel,
                                            matmul_ref)
    gen = torch.Generator(device=cuda).manual_seed(p)
    a = _rand(gen, 1000, 777, dtype=dtype)
    b = _rand(gen, 777, 900, dtype=dtype)
    before = (matmul_plan_kernel.launches, matmul_plan_kernel.cuboids,
              matmul_kernel.launches)
    got = paco_matmul(a, b, p)
    torch.cuda.synchronize()
    assert (matmul_plan_kernel.launches, matmul_plan_kernel.cuboids,
            matmul_kernel.launches) == (before[0] + 1, before[1] + p,
                                        before[2])
    assert _rel(got, matmul_ref(a, b)) <= tol


# (n, k, m, p): k-cut plans (outputs shared by 2 to 4 cuboids, equal or
# partly overlapping rectangles), one without k-cuts, and ragged strides
PLAN_GEOMS = [(64, 64, 64, 5), (64, 64, 64, 13), (61, 97, 67, 12),
              (1000, 776, 900, 13), (1024, 2048, 512, 7), (300, 20, 260, 4)]


@pytest.mark.parametrize("dtype,tol", MM_DTYPES)
@pytest.mark.parametrize("n,k,m,p", PLAN_GEOMS)
def test_matmul_plan_kernel_matches_plain_and_repeats_bitwise(cuda, dtype,
                                                              tol, n, k, m, p):
    """The one-launch plan against ``matmul_plan_ref`` (MM_TOL: the parts'
    f32 sums in other orders; the k-cut adds are the same), bit for bit
    the same over two calls, and the variant its operands call for."""
    from repro_torch.core.matmul import plan
    from repro_torch.kernels.matmul import matmul_plan_kernel, matmul_plan_ref
    gen = torch.Generator(device=cuda).manual_seed(n + k + m + p)
    a, b = _rand(gen, n, k, dtype=dtype), _rand(gen, k, m, dtype=dtype)
    pl = plan(n, m, k, p)
    variants = matmul_plan_kernel.variants.copy()
    got = matmul_plan_kernel(a, b, pl)
    again = matmul_plan_kernel(a, b, pl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, matmul_plan_ref(a, b, pl)) <= tol
    want = ("wgmma_tf32x3" if dtype == torch.float32 else
            "wgmma" if k % 8 == 0 and m % 8 == 0 else "mma_sync")
    assert matmul_plan_kernel.variants - variants == {want: 2}


@pytest.mark.parametrize("dtype,tol", MM_DTYPES)
def test_matmul_plan_kernel_reads_views_and_other_planners(cuda, dtype, tol):
    """Operands that are views (a row stride, a base off 16 bytes: the
    bf16 kernel then gathers), and the "mm" and "hetero" planners (several
    cuboids per processor, uneven cuts)."""
    from repro_torch.core.matmul import plan
    from repro_torch.kernels.matmul import matmul_plan_kernel, matmul_plan_ref
    gen = torch.Generator(device=cuda).manual_seed(7)
    big_a = _rand(gen, 300, 400, dtype=dtype)
    big_b = _rand(gen, 400, 520, dtype=dtype)
    for a, b, kw in [(big_a[:, 8:392], big_b[8:392, 16:512], {}),
                     (big_a[3:200, 7:190], big_b[5:188, 11:300], {}),
                     (big_a[:, 5:], big_b[5:, 3:], {"planner": "mm"}),
                     (big_a, big_b, {"planner": "hetero", "throughputs":
                                     [1.0 + i % 3 for i in range(6)]})]:
        (n, k), m = a.shape, b.shape[1]
        pl = plan(n, m, k, 6, **kw)
        got = matmul_plan_kernel(a, b, pl)
        assert torch.equal(got, matmul_plan_kernel(a, b, pl))
        assert _rel(got, matmul_plan_ref(a.contiguous(), b.contiguous(),
                                         pl)) <= tol


def _lcs_inputs(gen, m, n, monotone):
    ints = lambda *s: torch.randint(0, 4, s, generator=gen,  # noqa: E731
                                    device=gen.device, dtype=torch.int32)
    if monotone:
        top = torch.sort(ints(n) % 3).values
        left = torch.sort(ints(m) % 3).values
        corner = torch.minimum(top[:1], left[:1])
    else:
        big = lambda *s: torch.randint(  # noqa: E731
            -2 ** 31, 2 ** 31 - 1, s, generator=gen, device=gen.device,
            dtype=torch.int32)
        top, left, corner = big(n), big(m), big(1)
        top[::7], left[::5] = 2 ** 31 - 1, 2 ** 31 - 1   # sums that wrap
        top[3::11], left[2::9] = -2 ** 31, -2 ** 31
    return ints(m), ints(n), top, left, corner


@pytest.mark.parametrize("m,n", [(1, 1), (7, 7), (64, 64), (256, 256),
                                 (5, 300), (300, 5), (40, 1030), (9, 8200),
                                 (8200, 9)])
@pytest.mark.parametrize("monotone", [True, False])
def test_lcs_tile_kernel_matches_plain(cuda, m, n, monotone):
    """Exact, on DP borders and on any int32 borders (INT32_MIN and
    INT32_MAX among them); 1030 columns take several strips, 8200 columns
    or rows two tiles of the same launch: one launch each."""
    from repro_torch.kernels.lcs import lcs_tile_kernel, lcs_tile_ref
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    args = _lcs_inputs(gen, m, n, monotone)
    before = lcs_table_kernel.launches
    got = lcs_tile_kernel(*args)
    torch.cuda.synchronize()
    assert lcs_table_kernel.launches == before + 1
    for g, w in zip(got, lcs_tile_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tile", [1, 7, 128, 256, 8192])
def test_lcs_table_kernel_matches_plain(cuda, tile):
    """The whole table in one launch, tiles 1, 7, 128, 256 and 8192 wide
    (a ragged last tile row and column where the tile does not divide),
    on arbitrary int32 borders, against ``lcs_tiles_ref`` as one tile;
    bitwise the same over two calls; the variant names the run (4 up to
    128 columns, 8 above)."""
    from repro_torch.kernels.lcs import lcs_tiles_ref
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    m, n = {1: (23, 41), 7: (61, 45), 128: (300, 520), 256: (700, 600),
            8192: (9000, 8500)}[tile]
    gen = torch.Generator(device=cuda).manual_seed(tile)
    s, t, top, left, corner = _lcs_inputs(gen, m, n, False)
    before = lcs_table_kernel.launches, lcs_table_kernel.variants.copy()
    got = lcs_table_kernel(s, t, top, left, corner, tile, tile)
    again = lcs_table_kernel(s, t, top, left, corner, tile, tile)
    torch.cuda.synchronize()
    assert lcs_table_kernel.launches == before[0] + 2
    took = 4 if tile <= 128 else 8
    assert lcs_table_kernel.variants - before[1] == {f"skew{took}": 2}
    want = lcs_tiles_ref(s[None], t[None], top[None], left[None], corner)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w[0]) and torch.equal(g, a)


@pytest.mark.parametrize("tile", [32, 128])
def test_lcs_table_kernel_many_tiles_match_plain(cuda, tile):
    """A grid of 64 x 64 tiles (up to 64 CTAs claiming and waiting at
    once) on arbitrary int32 borders: the whole bottom row and right
    column against ``lcs_table_plain`` on the same tensors, bitwise the
    same over two calls."""
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel, lcs_table_plain
    n = 64 * tile
    gen = torch.Generator(device=cuda).manual_seed(n)
    args = (*_lcs_inputs(gen, n, n, False), tile, tile)
    got = lcs_table_kernel(*args)
    again = lcs_table_kernel(*args)
    for g, a, w in zip(got, again, lcs_table_plain(*args)):
        assert torch.equal(g, w) and torch.equal(g, a)


@pytest.mark.parametrize("n,p,tile", [(1024, 5, None), (1024, 132, None),
                                      (768, 3, 96), (512, 1, 512),
                                      (2048, 1, 128)])
def test_paco_lcs_on_cuda_launches_once(cuda, n, p, tile):
    """One launch per paco_lcs call, whatever the tiling, exactly the
    plain row scan."""
    from repro_torch.core import lcs_reference, paco_lcs
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    gen = torch.Generator(device=cuda).manual_seed(n + p)
    s, t = (torch.randint(0, 4, (n,), generator=gen, device=cuda,
                          dtype=torch.int32) for _ in range(2))
    before = lcs_table_kernel.launches
    got = paco_lcs(s, t, p, tile=tile)
    torch.cuda.synchronize()
    assert lcs_table_kernel.launches == before + 1
    assert int(got) == int(lcs_reference(s, t))
