"""Checkpoints with a manifest (port of ``repro.checkpoint.ckpt``), in
``repro``'s directory layout, so that either package restores the other's:

    <dir>/step_<k>/
        manifest.json   step, extra, and per leaf: file, shape, dtype and
                        the sha256 of the file
        <key>.npy       one array per leaf; key = the "/"-joined dict path
                        in sorted key order (as ``jax.tree_util`` flattens
                        dicts), "/" written as "__" in the file name

numpy has no bfloat16: ``repro`` writes a bf16 leaf (an ``ml_dtypes``
array) as 2-byte voids with the header descr '<V2' and the manifest dtype
"bfloat16".  The port writes the same bytes from the tensor's 16-bit words
and reads such a leaf back as 16-bit words reinterpreted as
``torch.bfloat16``, keyed by the manifest's dtype.  Writes are atomic (a
temporary directory renamed into place).  Restore places leaves on the
caller's device; ``repro``'s ``shardings`` (placement over a mesh) is not
ported.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

Params = Any
_SEP = "/"


def _flatten(tree: Params, prefix: str = "") -> dict[str, torch.Tensor]:
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _write_npy(path: str, t: torch.Tensor) -> str:
    """np.save's bytes for the tensor; returns the manifest dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        header = {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(words.shape)}
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, header)
            f.write(words.tobytes())
        return "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return str(arr.dtype)


def _read_npy(path: str, dtype: str) -> torch.Tensor:
    arr = np.array(np.load(path), order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Params, *,
         extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "extra": extra or {}, "arrays": {}}
    for key, t in _flatten(tree).items():
        fname = key.replace(_SEP, "__") + ".npy"
        path = os.path.join(tmp, fname)
        dtype = _write_npy(path, t)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["arrays"][key] = {
            "file": fname, "shape": list(t.shape), "dtype": dtype,
            "sha256": digest}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Params, *, verify: bool = True,
            device: torch.device | str | None = None
            ) -> tuple[Params, dict]:
    """Load into the structure of ``like`` (nested dicts of tensors), each
    leaf cast to the dtype of its ``like`` leaf and placed on ``device``
    (default: the ``like`` leaf's device).  Raises on a checksum mismatch
    (``verify``) or a shape that differs from ``like``'s."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(prefix: str, sub: Params) -> Params:
        out = {}
        for k, leaf in sub.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            if isinstance(leaf, dict):
                out[k] = load(key, leaf)
                continue
            meta = manifest["arrays"][key]
            fpath = os.path.join(d, meta["file"])
            if verify:
                with open(fpath, "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != meta["sha256"]:
                        raise IOError(f"checksum mismatch for {key}")
            t = _read_npy(fpath, meta["dtype"])
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"{key}: ckpt {tuple(t.shape)} != model "
                                 f"{tuple(leaf.shape)} (wrong config?)")
            out[k] = t.to(device=device if device is not None
                          else leaf.device, dtype=leaf.dtype)
        return out

    return load("", like), manifest


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
