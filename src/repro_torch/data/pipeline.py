"""Deterministic synthetic token pipeline, host-sharded (a copy of
``repro.data.pipeline`` for the port).

Every (step, host row) pair maps to its own counter-based numpy RNG
stream, so the global batch is the same whatever the host count: the
streams are ``repro``'s, and the batches equal its batches integer for
integer.  Batches carry ``tokens`` and next-token ``labels`` (int32;
labels < 0 are masked by ``models.loss_fn``) as tensors on the caller's
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    src_len: int = 0  # encdec source frames


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def _place(arrays: dict[str, np.ndarray],
           device: torch.device | str) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def global_batch(cfg: DataConfig, step: int, *, d_model: int = 0,
                 device: torch.device | str = "cpu") -> dict:
    """The full (unsharded) batch for ``step``: deterministic."""
    rng = _batch_rng(cfg, step)
    toks = rng.integers(0, cfg.vocab,
                        (cfg.global_batch, cfg.seq_len + 1), np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.src_len:
        batch["src_emb"] = rng.standard_normal(
            (cfg.global_batch, cfg.src_len, d_model), np.float32)
    return _place(batch, device)


def host_batch(cfg: DataConfig, step: int, host: int, n_hosts: int, *,
               d_model: int = 0, device: torch.device | str = "cpu") -> dict:
    """This host's shard of the global batch (contiguous block split).

    Generates only the needed rows: the stream is counter-based per row, so
    host sharding never materializes the global batch."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    per = cfg.global_batch // n_hosts
    lo = host * per
    rows_tok, rows_lab, rows_src = [], [], []
    for r in range(lo, lo + per):
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, r]))
        t = rng.integers(0, cfg.vocab, (cfg.seq_len + 1,), np.int32)
        rows_tok.append(t[:-1])
        rows_lab.append(t[1:])
        if cfg.src_len:
            rows_src.append(rng.standard_normal((cfg.src_len, d_model),
                                                np.float32))
    out = {"tokens": np.stack(rows_tok), "labels": np.stack(rows_lab)}
    if cfg.src_len:
        out["src_emb"] = np.stack(rows_src)
    return _place(out, device)


def global_batch_rowwise(cfg: DataConfig, step: int, *, d_model: int = 0,
                         device: torch.device | str = "cpu") -> dict:
    """Row-wise-deterministic global batch == concat of all host shards."""
    return host_batch(cfg, step, 0, 1, d_model=d_model, device=device)


def data_config_for(cfg: ArchConfig, seq_len: int, global_batch_size: int,
                    seed: int = 0) -> DataConfig:
    return DataConfig(seq_len=seq_len, global_batch=global_batch_size,
                      vocab=cfg.vocab, seed=seed,
                      src_len=128 if cfg.family == "encdec" else 0)
