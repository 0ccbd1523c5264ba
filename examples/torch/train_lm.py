"""End-to-end training on the PyTorch port: train a LM on
synthetic data with the full substrate (PACO shardings, AdamW,
checkpointing, deterministic pipeline).

Default is a fast run on one card, no mesh; ``--preset 100m`` trains a
~100M-param qwen3-family model for a few hundred steps.  Under torchrun it
trains on a mesh over every rank (``--mesh auto``: the best 2-D mesh of
``ft.elastic.make_mesh_for``), NCCL on the cards, gloo on the CPU:

  PYTHONPATH=src python examples/torch/train_lm.py                # card
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu
  PYTHONPATH=src python examples/torch/train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 examples/torch/train_lm.py --device cpu
"""
import argparse
import dataclasses
import os

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainConfig, Trainer


def build_config(preset: str):
    base = get_arch("qwen3-0.6b")
    if preset == "tiny":
        return dataclasses.replace(
            base.reduced(), n_layers=4, d_model=128, d_ff=512, vocab=2048)
    if preset == "100m":
        # ~100M params: 12L x 768 with a 32k vocab (GPT-2-small class)
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=3072, vocab=32768, q_chunk=256,
            param_dtype="float32", tie_embeddings=True)
    raise ValueError(preset)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="auto or DxM (under torchrun; auto there by "
                         "default); default: one device, no mesh")
    args = ap.parse_args(argv)
    flag = args.mesh or ("auto" if "WORLD_SIZE" in os.environ else None)
    mesh, rank = None, 0
    if flag is not None:
        from repro_torch.launch.mesh import init_from_env, mesh_from_flag
        rank, world = init_from_env(args.device)
        mesh = mesh_from_flag(flag, world, args.device)
    cfg = build_config(args.preset)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab)
    tcfg = TrainConfig(opt=AdamWConfig(
        lr=3e-4, warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps))
    trainer = Trainer(cfg, tcfg, dcfg, ckpt_dir=args.ckpt_dir,
                      log_every=max(1, args.steps // 20),
                      device=args.device, mesh=mesh)
    try:
        params, state, hist = trainer.run(args.steps)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    losses = [h["loss"] for h in hist]
    n_params = sum(x.numel() for x in tree_leaves(params))
    if rank == 0:
        print(f"\n{n_params / 1e6:.1f}M params | loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} | "
              f"{np.mean([h['step_time_s'] for h in hist[1:]]) * 1e3:.0f} "
              f"ms/step")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "did not learn"


if __name__ == "__main__":
    main()
