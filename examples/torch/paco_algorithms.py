"""The paper's algorithm suite end-to-end on the PyTorch port: LCS, 1D,
GAP, MM, Strassen, sorting, each PACO-partitioned for an arbitrary p and
validated against its reference (``repro_torch.launch.paco``).

  PYTHONPATH=src python examples/torch/paco_algorithms.py --p 5
  PYTHONPATH=src python examples/torch/paco_algorithms.py --device cpu

On the card the LCS table and every matmul cuboid and Strassen leaf run
through the hand-written kernels.  Exits 1 if a check fails.
"""
from repro_torch.launch.paco import main

if __name__ == "__main__":
    raise SystemExit(main())
