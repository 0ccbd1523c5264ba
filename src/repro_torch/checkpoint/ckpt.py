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
temporary directory renamed into place).

On a mesh, ``save`` of DTensor leaves gathers each leaf whole (every rank
of the mesh calls it) and the mesh's first rank writes them, in the same
layout; ``restore`` lays each leaf out on the current mesh, from
``placements`` or from the ``like`` leaf's own layout when that is a
DTensor, so a checkpoint saved on one mesh restores onto another of any
size (the elastic restart).
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


def _mesh_of(flat: dict) -> Any:
    from repro_torch.dist.act_sharding import is_dtensor
    for t in flat.values():
        if is_dtensor(t):
            return t.device_mesh
    return None


def _mesh_barrier(mesh: Any) -> None:
    """Every rank of ``mesh`` waits for all of them: one all-reduce per
    mesh dim, in order (rank (i, j) waits for its row, each of which
    waited for its column)."""
    import torch.distributed as dist
    token = torch.zeros(1, device=mesh.device_type)
    for d in range(mesh.ndim):
        dist.all_reduce(token, group=mesh.get_group(d))


def save(ckpt_dir: str, step: int, tree: Params, *,
         extra: dict | None = None) -> str:
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    mesh = _mesh_of(flat)
    if mesh is None:
        return _write(ckpt_dir, final, step, flat, extra)
    from repro_torch.dist.act_sharding import replicate
    flat = {k: replicate(v) for k, v in flat.items()}
    if all(c == 0 for c in mesh.get_coordinate()):
        _write(ckpt_dir, final, step, flat, extra)
    _mesh_barrier(mesh)
    return final


def _write(ckpt_dir: str, final: str, step: int,
           flat: dict[str, torch.Tensor], extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "extra": extra or {}, "arrays": {}}
    for key, t in flat.items():
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
            device: torch.device | str | None = None,
            mesh: Any = None, placements: Params | None = None
            ) -> tuple[Params, dict]:
    """Load into the structure of ``like`` (nested dicts of tensors), each
    leaf cast to the dtype of its ``like`` leaf and placed on ``device``
    (default: the ``like`` leaf's device).  With ``placements`` (a tree of
    DTensor placements matching ``like``) on ``mesh``, each leaf is laid
    out as a DTensor there; a DTensor ``like`` leaf without them keeps its
    own mesh and placements.  Raises on a checksum mismatch (``verify``)
    or a shape that differs from ``like``'s."""
    from repro_torch.dist.act_sharding import is_dtensor
    from repro_torch.dist.sharding import shard_of
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(prefix: str, sub: Params, place: Params | None) -> Params:
        out = {}
        for k, leaf in sub.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            if isinstance(leaf, dict):
                out[k] = load(key, leaf, None if place is None
                              else place[k])
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
            t = t.to(device=device if device is not None else leaf.device,
                     dtype=leaf.dtype)
            if place is not None:
                t = shard_of(t, mesh, tuple(place[k]))
            elif is_dtensor(leaf):
                t = shard_of(t, leaf.device_mesh, tuple(leaf.placements))
            out[k] = t
        return out

    return load("", like, placements), manifest


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
