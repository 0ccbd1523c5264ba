"""Serving launcher of the port: paged continuous batching on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 16 --new-tokens 16            # on the card

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --reduced --device cpu                   # small, on the CPU

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --reduced --device cpu   # MLA + MoE

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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the sampler")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(params, cfg, slots=args.slots,
                         max_seq=args.max_seq, page_size=args.page_size,
                         pool_pages=args.pool_pages,
                         prefill_chunk_len=args.chunk,
                         ticks_per_dispatch=args.ticks_per_dispatch,
                         seed=args.seed, device=args.device)
    print(f"{cfg.name}: device={engine.device} slots={args.slots} "
          f"page={engine.page} chunk={engine.chunk} "
          f"pool={engine.pool.n_pages} pages ticks/dispatch={engine.ticks}")
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
    print(f"served {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s); prefill calls="
          f"{engine.stats['prefill_calls']} (<=ceil(len/chunk) per admit: "
          f"{'ok' if budget_ok else 'VIOLATED'}), decode steps="
          f"{engine.stats['decode_steps']} in "
          f"{engine.stats['dispatches']} dispatches "
          f"({engine.stats['host_syncs']} host syncs), "
          f"preemptions={engine.stats['preemptions']}")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out[:8]}")


if __name__ == "__main__":
    main()
