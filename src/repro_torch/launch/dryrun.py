"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
tensors (port of ``repro.launch.dryrun``).

For each cell ``run_cell``:
  1. starts a ``fake`` process group of 256 ranks (single pod) or 512
     (multi pod) in this process, as rank 0, and builds the production
     mesh (16 x 16, or 2 x 16 x 16) on it;
  2. builds the params, AdamW state and inputs as fake tensors
     (``launch.specs``: no storage) and lays them out as DTensors by
     ``param_specs`` / ``batch_specs`` / ``cache_specs``;
  3. runs the train / prefill / serve step once on them, under the mesh's
     activation rules, ``launch.cost.StepCounters`` and
     ``torch.distributed._tools.mem_tracker.MemTracker``: every aten op
     and kernel the step would run on rank 0's card, at its local shapes;
  4. destroys the process group and writes
     ``experiments/torch/dryrun/<mesh>_<arch>_<shape>.json``.

A record keeps ``repro``'s keys where they carry over: ``status``,
``fn``, ``devices``, ``memory`` (``argument_bytes``: the local bytes of
the step's arguments on one rank; ``output_bytes``: of its outputs, which
for a train or decode step are the arguments updated in place;
``peak_bytes_per_device``: MemTracker's peak, arguments included),
``cost`` (``flops_per_device``, ``bytes_per_device``, and the kernels'
share), ``collectives`` (count and output bytes per rank, by kind and mesh
axis) and ``trace_s`` in place of ``lower_s`` / ``compile_s``.  Nothing
runs on a card and no XLA flag is needed: the fake group lives in the
process.  On a build of torch without CUDA the fake tensors and the mesh
are on the CPU (``cost.trace_device``), and the attention entry points
still take the kernels' lowering.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/torch/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_arch
from repro_torch.launch import cost, specs
from repro_torch.train.train_step import TrainConfig

OUT = "experiments/torch/dryrun"


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree: Any) -> int:
    """Bytes one rank holds of the tensors in ``tree`` (a DTensor's local
    shard)."""
    from repro_torch.dist.act_sharding import is_dtensor

    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in _leaves(tree))


def shardings_for(cfg, shape, mesh: Any, args: dict) -> dict:
    """Specs of the step's arguments (``repro``'s ``shardings_for``):
    params by ``param_specs`` (AdamW's moments as their params, its step
    replicated), batches by ``batch_specs``, the decode cache by
    ``cache_specs``, the decode tokens and lengths over ``data`` when the
    batch divides it."""
    from repro_torch.dist.act_sharding import axis_sizes
    from repro_torch.dist.sharding import (batch_specs, cache_specs,
                                           param_specs)

    out: dict = {"params": param_specs(cfg, args["params"], mesh)}
    if "state" in args:
        p = out["params"]
        out["state"] = {"opt": {"m": p, "v": p, "step": ()}}
    if "batch" in args:
        out["batch"] = batch_specs(cfg, mesh, args["batch"])
    if "cache" in args:
        b = args["tokens"].shape[0]
        cut = b % axis_sizes(mesh)["data"] == 0
        out["tokens"] = ("data", None) if cut else (None, None)
        out["lengths"] = ("data",) if cut else (None,)
        out["cache"] = cache_specs(cfg, mesh, args["cache"])
    return out


def build_args(cfg, shape, mode: Any, tcfg: TrainConfig,
               mesh: Any = None) -> tuple:
    """The step fn's positional args on fake tensors, laid out on
    ``mesh`` when one is given."""
    args: dict = {"params": specs.param_shapes(cfg, mode)}
    args.update(specs.input_specs(cfg, shape, mode))
    if mesh is not None:
        from repro_torch.dist.sharding import distribute
        laid = shardings_for(cfg, shape, mesh, args)
        with mode:
            args = {k: distribute(mesh, v, laid[k]) for k, v in args.items()}
    if shape.kind == "train":
        args["state"] = specs.opt_state_shapes(cfg, tcfg, args["params"],
                                               mode)
        order = ("params", "state", "batch")
    elif shape.kind == "prefill":
        order = ("params", "batch")
    else:
        order = ("params", "tokens", "cache", "lengths")
    return tuple(args[k] for k in order)


def trace(fn, positional: tuple, mode: Any, mesh: Any = None) -> dict:
    """Run ``fn(*positional)`` once on fake tensors under the counters and
    MemTracker (and the mesh's rules): the record's memory, cost and
    collectives, and the wall time of the trace."""
    import contextlib

    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.dist.act_sharding import use_mesh_rules

    mt = MemTracker()
    mt.track_external(*_leaves(positional))
    t0 = time.perf_counter()
    with mode, cost.StepCounters(mesh) as counters, mt, \
            (use_mesh_rules(mesh) if mesh is not None
             else contextlib.nullcontext()):
        out = fn(*positional)
    trace_s = time.perf_counter() - t0
    peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    return {
        "memory": {"argument_bytes": local_bytes(positional),
                   "output_bytes": local_bytes(out),
                   "peak_bytes_per_device": int(peak)},
        "cost": counters.summary(),
        "collectives": counters.collectives.stats,
        "trace_s": round(trace_s, 2),
    }


def trace_cell(cfg, shape, mesh: Any = None) -> dict:
    """``fn`` name, memory, cost and collectives of one (config, shape)
    cell traced on fake tensors, laid out on ``mesh`` when one is given
    (any config: a reduced one, a cut depth)."""
    tcfg = TrainConfig()
    fn, fn_name = specs.step_fn_for(cfg, shape, tcfg)
    mode = specs.fake_mode()
    positional = build_args(cfg, shape, mode, tcfg, mesh)
    return {"fn": fn_name, **trace(fn, positional, mode, mesh)}


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str
             ) -> dict:
    """Trace one cell on the production mesh (see the module docstring);
    a cell that raises is recorded as ``error``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "status": "skipped"}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec["why"] = why
        return _write(rec, out_dir)
    devices = 512 if multi_pod else 256
    rec.update(fn=specs.step_fn_for(cfg, shape)[1], devices=devices)
    _fake_group(devices)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=cost.trace_device())
        rec.update(status="ok", **trace_cell(cfg, shape, mesh))
    except Exception as e:  # record failures: they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    finally:
        dist.destroy_process_group()
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['mesh']}_{rec['arch']}_{rec['shape']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_bad = 0
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "multi" if multi else "single"
                path = os.path.join(
                    args.out, f"{mesh_name}_{arch}_{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            continue
                rec = run_cell(arch, shape, multi, args.out)
                n_bad += rec["status"] == "error"
                msg = rec.get("error", rec.get("why", ""))
                extra = ""
                if rec["status"] == "ok":
                    gb = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
                    extra = (f"peak {gb:.2f} GiB/dev "
                             f"trace {rec['trace_s']:.1f}s")
                print(f"[{rec['status']:7s}] {mesh_name:6s} {arch:22s} "
                      f"{shape:12s} {extra}{msg}", flush=True)
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
