"""Quickstart: the PACO planner in 60 seconds, on the PyTorch port.

Run:  PYTHONPATH=src python examples/torch/quickstart.py           # card
      PYTHONPATH=src python examples/torch/quickstart.py --device cpu

On the card the matmul cuboids and Strassen's leaf products run through
the hand-written matmul kernel (``repro_torch.kernels.matmul``).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (OMEGA0, paco_matmul, paco_sort,
                              plan_mm_1piece, plan_strassen, strassen)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)

    # --- 1. Plan a matmul over an AWKWARD processor count (p = 13, prime)
    n, m, k = 4096, 2048, 1024
    plan = plan_mm_1piece(n, m, k, p=13)
    vols = plan.per_proc_volume()
    print(f"PACO 1-piece plan for {n}x{m}x{k} over p=13 (prime!):")
    print(f"  exact cover: {plan.check_exact_cover()}")
    print(f"  volume imbalance: {(max(vols) - min(vols)) / np.mean(vols):.3%}")
    print(f"  reduction rounds (k-cuts): {plan.k_cut_rounds()}  "
          f"comm bytes: {plan.comm_bytes():,}")

    # --- 2. Execute it: numerics those of a @ b ---------------------------
    a, b = normal(256, 128), normal(128, 192)
    err = (paco_matmul(a, b, 13) - a @ b).abs().max().item()
    print(f"\npaco_matmul(p=13) max err vs torch matmul: {err:.2e}")

    # --- 3. Strassen on any p (the paper's open-problem answer) ----------
    asg = plan_strassen(2 ** 12, p=11, base=2 ** 6)
    loads = [sum(nd.size ** OMEGA0 for nd in nodes) for nodes in asg.by_proc]
    print(f"\nStrassen 7-ary pruned BFS over p=11: "
          f"imbalance {(max(loads) - min(loads)) / np.mean(loads):.3%}")
    a2, b2 = a[:128, :128].contiguous(), b[:128, :128].contiguous()
    s_err = (strassen(a2, b2, 2) - a2 @ b2).abs().max().item()
    print(f"strassen(depth=2) max err: {s_err:.2e}")

    # --- 4. Sample sort (Theorem 16) -------------------------------------
    x = torch.tensor(rng.random(10000), dtype=torch.float32, device=dev)
    got, sizes = paco_sort(x, 7, torch.Generator(device=dev).manual_seed(3))
    exact = bool(torch.equal(got, torch.sort(x).values))
    print(f"\npaco_sort(p=7): exact={exact} "
          f"max bucket {sizes.max().item() / (10000 / 7):.2f}x mean")


if __name__ == "__main__":
    main()
