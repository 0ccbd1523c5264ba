"""Serving launcher of the port: paged continuous batching on one device
or on a mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 16 --new-tokens 16            # on the card

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --reduced --device cpu                   # small, on the CPU

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --reduced --device cpu   # MLA + MoE

  # speculative decoding (n-gram drafts verified in one batched forward,
  # greedy only), each request re-decoded by the reference oracle:
  ... --speculate 0 --verify-parity

  # on a mesh, under torchrun (gloo on cpu, NCCL on cuda):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --device cpu --mesh 2x2

Weights are the port's own random ones, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: PACO leaf tile)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="page-pool size (default: slots*max_seq/page; "
                         "smaller values exercise preemption)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="prefill chunk length (tokens per call)")
    ap.add_argument("--ticks-per-dispatch", type=int, default=8,
                    help="decode steps fused into one dispatch, which "
                         "syncs ONE (N, slots) token block to the host "
                         "(default 8)")
    ap.add_argument("--speculate", type=int, default=None,
                    help="draft length for speculative decoding: each "
                         "dispatch step drafts N tokens per slot from its "
                         "own history (n-gram lookup, no draft model), "
                         "verifies the window in one batched forward and "
                         "keeps the greedy-correct prefix; 0 plans the "
                         "window as a PACO leaf tile of the cache cuboid")
    ap.add_argument("--spec-min-accept", type=float, default=0.25,
                    help="adaptive fallback: below this acceptance rate "
                         "over the last 32 verify windows, dispatch the "
                         "fused decode instead (a speculative probe every "
                         "16th dispatch); 0 turns it off")
    ap.add_argument("--verify-parity", action="store_true",
                    help="after the drain, re-decode every request through "
                         "serve.reference (dense, no cache) and require "
                         "equal tokens; slow, for reduced sizes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the sampler")
    ap.add_argument("--mesh", default=None,
                    help="auto, DxM, production or multi_pod (under "
                         "torchrun); default: one device, no mesh")
    args = ap.parse_args()
    mesh, rank = None, 0
    if args.mesh is not None:
        from repro_torch.launch.mesh import init_from_env, mesh_from_flag
        rank, world = init_from_env(args.device)
        mesh = mesh_from_flag(args.mesh, world, args.device)
    print_ = print if rank == 0 else (lambda *a, **k: None)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(params, cfg, slots=args.slots,
                         max_seq=args.max_seq, page_size=args.page_size,
                         pool_pages=args.pool_pages,
                         prefill_chunk_len=args.chunk,
                         ticks_per_dispatch=args.ticks_per_dispatch,
                         speculate=args.speculate,
                         spec_min_accept=args.spec_min_accept,
                         seed=args.seed, device=args.device, mesh=mesh)
    print_(f"{cfg.name}: device={engine.device} slots={args.slots} "
          f"page={engine.page} chunk={engine.chunk} "
          f"pool={engine.pool.n_pages} pages ticks/dispatch={engine.ticks}"
          + (f" draft_len={engine.draft_len}"
             if engine.draft_len is not None else ""))
    for i in range(args.requests):
        engine.submit(Request(uid=i, prompt=[1 + i % 7, 2, 3 + i % 5],
                              max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    engine.check_page_invariants()
    total = sum(len(r.out) for r in done)
    chunk = engine.chunk
    budget_ok = all(
        r.prefill_calls <= (r.preemptions + 1)
        * -(-(len(r.prompt) + len(r.out)) // chunk) for r in done)
    print_(f"served {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s); prefill calls="
          f"{engine.stats['prefill_calls']} (<=ceil(len/chunk) per admit: "
          f"{'ok' if budget_ok else 'VIOLATED'}), decode steps="
          f"{engine.stats['decode_steps']} in "
          f"{engine.stats['dispatches']} dispatches "
          f"({engine.stats['host_syncs']} host syncs), "
          f"preemptions={engine.stats['preemptions']}")
    if engine.draft_len is not None:
        s = engine.stats
        rate = s["accepted_tokens"] / max(s["drafted_tokens"], 1)
        per_win = s["decode_tokens"] / max(s["spec_windows"], 1)
        print_(f"speculation: draft_len={engine.draft_len} "
              f"windows={s['spec_windows']} "
              f"accepted={s['accepted_tokens']}/{s['drafted_tokens']} "
              f"drafts (rate={rate:.2f}), "
              f"tokens/window={per_win:.2f}, decode tokens/sync="
              f"{s['decode_tokens'] / max(s['dispatches'], 1):.1f}, "
              f"fallback dispatches={s['spec_fallback_dispatches']}")
    for r in done[:4]:
        print_(f"  req {r.uid}: {r.out[:8]}")
    if args.verify_parity:
        from repro_torch.serve import reference_decode
        for r in sorted(done, key=lambda r: r.uid):
            ref = reference_decode(params, cfg, r.prompt,
                                   max_new_tokens=r.max_new_tokens,
                                   eos_id=r.eos_id, max_seq=engine.max_seq)
            if r.out != ref:
                raise SystemExit(f"req {r.uid}: engine {r.out} != "
                                 f"reference {ref}")
        print_(f"reference parity: ok ({len(done)} requests)")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
