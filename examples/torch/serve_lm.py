"""Paged continuous-batching demo on the PyTorch port: page pool, block
tables, chunked prefill, fused decode over slots.

  PYTHONPATH=src python examples/torch/serve_lm.py            # full width,
                                                              # on the card
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu  # reduced

On the card it serves the arch at full width (random weights from a
seed), its prefill and decode through the paged attention kernels; on
the CPU, the tiny same-family config.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_arch(args.arch)
    cfg = cfg.reduced() if dev.type == "cpu" else cfg
    params = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(params, cfg, slots=4, max_seq=128, device=dev)
    for i in range(args.requests):
        engine.submit(Request(uid=i, prompt=[1 + i % 5, 7, 3],
                              max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"{cfg.name}: {len(done)} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.1f} tok/s; paged KV: "
          f"{engine.pool.n_pages} pages of {engine.page} positions, "
          f"{engine.stats['prefill_calls']} prefill calls, "
          f"{engine.stats['decode_steps']} fused decode steps)")
    for r in sorted(done, key=lambda r: r.uid)[:3]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.out}")


if __name__ == "__main__":
    main()
