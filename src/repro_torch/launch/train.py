"""Training launcher of the port, on one device or on a mesh.

  # small, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --reduced --device cpu --steps 3 --batch 2 --seq 32

  # full-width qwen3-0.6b on the card (the flash kernels run every
  # attention call, forward and backward):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 5 --batch 2 --seq 4096

  # seamless-m4t-medium (128 source frames, as repro's launcher; its
  # cross-attention through the backward kernel at Sq != Sk) and
  # mamba2-780m (no attention kernel) train the same way; zamba2-7b's 81
  # layers need more than one card's memory for weights, gradients and
  # AdamW moments (about 81 GB), so only a cut depth trains on one card,
  # through Trainer in chip_smoke.py:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch seamless-m4t-medium --steps 3 --batch 2 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch mamba2-780m --steps 3 --batch 2 --seq 256

  # on a mesh, under torchrun: 4 CPU ranks as 2 (data) x 2 (model), or
  # the card as a 1 x 1 mesh (NCCL; the same kernels as without a mesh)
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen3-0.6b --reduced \
      --device cpu --mesh 2x2 --steps 2 --batch 4 --seq 32
  PYTHONPATH=src torchrun --nproc-per-node 1 -m repro_torch.launch.train \
      --arch qwen3-0.6b --mesh 1x1 --steps 5 --batch 2 --seq 4096

Flags as ``repro.launch.train``'s, plus ``--device`` (default cuda).
``--mesh`` (auto: the best 2-D mesh for the world, DxM, production,
multi_pod) needs torchrun, with NCCL on cuda and gloo on cpu; without it
the launcher trains on one device.  Weights are the port's own random
ones (seed 0, as ``repro``'s ``Trainer.init``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import active_param_count, param_count
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="auto, DxM, production or multi_pod (under "
                         "torchrun); default: one device, no mesh")
    args = ap.parse_args()
    mesh, rank = None, 0
    if args.mesh is not None:
        from repro_torch.launch.mesh import init_from_env, mesh_from_flag
        rank, world = init_from_env(args.device)
        mesh = mesh_from_flag(args.mesh, world, args.device)
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab,
                      src_len=128 if cfg.family == "encdec" else 0)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches,
        compress_dp_grads=args.compress_grads)
    trainer = Trainer(cfg, tcfg, dcfg, ckpt_dir=args.ckpt_dir,
                      log_every=1, device=args.device, mesh=mesh)
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params, state = trainer.init()
    say(f"arch={cfg.name} device={args.device} "
        f"params={param_count(params)}"
        + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
           if mesh is not None else ""))
    params, state, history = trainer.run(args.steps, params=params,
                                         state=state)
    losses = [h["loss"] for h in history]
    times = [h["step_time_s"] for h in history[1:]] or [
        history[0]["step_time_s"]]
    mean_s = float(np.mean(times))
    say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean step {mean_s * 1e3:.0f} ms)")
    if on_card:
        tokens = args.batch * args.seq
        flops = 6 * active_param_count(cfg, params) * tokens
        say(f"{tokens / mean_s:.0f} tokens/s, model {flops / mean_s:.3g} "
            f"FLOP/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
            f"{torch.cuda.get_device_name()}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
