"""The port's serving engine against ``repro.serve.reference_decode`` on
the prompt sets of ``tests/test_serve.py`` (max-seq truncation, eos mid
decode and at prefill, arrival mid-flight, one tick per dispatch), with
the same weights in both packages, on the CPU.  Tokens agree exactly.
``reference`` is the padded, jitted form of ``reference_decode``
(``torch_parity``); the eos test holds the two to each other."""
from repro.serve import reference_decode
from repro_torch.serve import Request, ServeEngine
from torch_parity import models, reference, serve  # noqa: F401


def test_engine_max_seq_truncation(models):
    """prompt + budget overruns max_seq: generation stops when the context
    fills, as the reference does."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    eng, done = serve(pt, ct, dict(slots=2, max_seq=16, page_size=4),
                      [list(range(1, 11)), [3, 5]], 50)
    for r in done:
        assert r.out == reference(pj, cj, r, 16), r.uid
    assert len(done[0].prompt) + len(done[0].out) == 16
    assert eng.pool.free_count() == eng.pool.n_pages


def test_engine_one_tick_per_dispatch(models):
    cj, ct, pj, pt = models["qwen3-0.6b"]
    eng, done = serve(pt, ct, dict(slots=2, max_seq=64,
                                   ticks_per_dispatch=1),
                      [[4, 2, 9], [7, 7]], 5)
    assert eng.stats["dispatches"] == eng.stats["decode_steps"]
    for r in done:
        assert r.out == reference(pj, cj, r, 64), r.uid


def test_engine_eos_early_exit_and_at_prefill(models):
    """eos taken from ``reference_decode``'s output so it fires: at the
    third token (mid-decode) and as the first token (prefill retires the
    request before any decode tick).  The padded, jitted reference of the
    other tests agrees with ``reference_decode`` itself."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    ref = reference_decode(pj, cj, [4, 2, 9], max_new_tokens=3, max_seq=64)
    assert ref == reference(pj, cj, Request(0, [4, 2, 9], 3), 64)
    _, done = serve(pt, ct, dict(slots=2, max_seq=64), [[4, 2, 9], [7, 7]],
                    10, eos=ref[2])
    for r in done:
        assert r.out == reference(pj, cj, r, 64), r.uid
    assert done[0].out[-1] == ref[2] and len(done[0].out) <= 3
    eng, done = serve(pt, ct, dict(slots=2, max_seq=64), [[4, 2, 9]], 10,
                      eos=ref[0])
    assert done[0].out == [ref[0]]
    assert eng.stats["decode_steps"] == 0


def test_engine_arrival_mid_flight(models):
    """Requests submitted while others decode join without disturbing
    them."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    eng = ServeEngine(pt, ct, slots=2, max_seq=64, prefill_chunk_len=8,
                      device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=12))
    eng.submit(Request(uid=1, prompt=[9, 8], max_new_tokens=12))
    for _ in range(2):
        eng.tick()
    eng.submit(Request(uid=2, prompt=[5, 5, 5, 5, 5], max_new_tokens=12))
    eng.submit(Request(uid=3, prompt=[2] * 9, max_new_tokens=4))
    done = eng.run_until_drained()
    assert len(done) == 4
    for r in done:
        assert r.out == reference(pj, cj, r, 64), r.uid


def test_engine_window_softcap_arch(models):
    """gemma2 (reduced, untied): sliding-window layers of 16 positions
    alternating with global ones, attention and logit softcaps, post-norms;
    prompts longer than the window, so both kernels' window masks bite."""
    cj, ct, pj, pt = models["gemma2-2b"]
    assert ct.local_window == 16
    eng, done = serve(pt, ct, dict(slots=2, max_seq=48, page_size=4,
                                   prefill_chunk_len=8),
                      [list(range(3, 25)), [7, 7, 7], [30] * 17], 8)
    for r in done:
        assert r.out == reference(pj, cj, r, 48), r.uid
