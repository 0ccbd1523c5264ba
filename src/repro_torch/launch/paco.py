"""The paper's algorithm suite end to end: LCS, 1D, GAP, MM, Strassen and
sorting, each PACO-partitioned for an arbitrary p and checked against its
reference, at the sizes of ``examples/paco_algorithms.py``.

  PYTHONPATH=src python -m repro_torch.launch.paco --p 5   # on the card
  PYTHONPATH=src python -m repro_torch.launch.paco --device cpu --p 5

On the card, the LCS tiles and every matmul cuboid and Strassen leaf run
through the hand-written kernels.  Inputs are drawn from ``--seed`` (numpy
for the data, a ``torch.Generator`` for the sort's samples).  Each line
says whether its check held; the exit code is 1 if any failed.

Checks: LCS and sort exact; 1D (float32) atol 1e-5; GAP (float64) atol
1e-5; MM (float32, k = 96) atol 1e-4 and Strassen (float32, depth 2 at
128) atol 1e-3, the tolerances of ``tests/test_paco_core.py``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (gap_reference, lcs_reference, onedim_reference,
                              paco_gap, paco_lcs, paco_matmul, paco_onedim,
                              paco_sort, paco_strassen, partition_lcs)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=5,
                    help="processor count (any value works, primes too)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    p = args.p
    rng = np.random.default_rng(args.seed)
    ok = True

    def report(line: str, good: bool) -> None:
        nonlocal ok
        ok = ok and good
        print(f"{line}  [{'ok' if good else 'FAILED'}]", flush=True)

    def tensor(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    s = tensor(rng.integers(0, 4, 256), torch.int32)
    t = tensor(rng.integers(0, 4, 256), torch.int32)
    got, want = int(paco_lcs(s, t, p)), int(lcs_reference(s, t))
    plan = partition_lcs(256, p)
    report(f"LCS      p={p}: {got} (ref {want})  partition regions="
           f"{plan.partition_overhead()}", got == want)

    w = tensor(rng.random((129, 129)), torch.float32)
    err = (paco_onedim(w, p) - onedim_reference(w)).abs().max().item()
    report(f"1D/LWS   p={p}: max err {err:.1e}", err <= 1e-5)

    ng = 16
    sg, wg, w2 = (rng.random((ng + 1, ng + 1)) for _ in range(3))
    got_g = paco_gap(tensor(sg, torch.float64), tensor(wg, torch.float64),
                     tensor(w2, torch.float64), p, tile=4)
    err = float(np.max(np.abs(got_g.cpu().numpy()
                              - gap_reference(sg, wg, w2))))
    report(f"GAP      p={p}: max err {err:.1e}", err <= 1e-5)

    a = tensor(rng.standard_normal((192, 96)), torch.float32)
    b = tensor(rng.standard_normal((96, 160)), torch.float32)
    err = (paco_matmul(a, b, p) - a @ b).abs().max().item()
    report(f"MM       p={p}: max err {err:.1e}", err <= 1e-4)

    a2 = tensor(rng.standard_normal((128, 128)), torch.float32)
    b2 = tensor(rng.standard_normal((128, 128)), torch.float32)
    err = (paco_strassen(a2, b2, p, depth=2) - a2 @ b2).abs().max().item()
    report(f"Strassen p={p}: max err {err:.1e} (7-ary pruned BFS)",
           err <= 1e-3)

    x = tensor(rng.random(5000), torch.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    got_s, sizes = paco_sort(x, p, gen)
    exact = bool(torch.equal(got_s, torch.sort(x).values))
    report(f"Sort     p={p}: exact={exact} buckets={sizes.tolist()}", exact)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
