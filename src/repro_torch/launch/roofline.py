"""Roofline analysis on the production mesh (port of
``repro.launch.roofline``), on the card's figures of ``repro_torch.card``.

Per (arch x shape) on the single-pod mesh (16 x 16 = 256 cards), three
terms bound a step, each per card:

    compute    = FLOPs / PEAK_FLOPS[dtype]      (989e12 bf16, 67e12 f32)
    memory     = bytes / HBM_BYTES_PER_S         (3.35e12 B/s)
    collective = sum over mesh axes of the axis's collective bytes over
                 the link that axis crosses

The FLOPs, bytes and collectives are the dry-run's (``launch.dryrun``):
the step traced once at full depth on fake tensors, every aten op and
kernel on rank 0's shards counted (``launch.cost``).  The port is eager
and sees every layer, so ``repro``'s two-depth fit (``cost_analysis``
counts a scan body once) and its TPU-projected memory column (which took
XLA:CPU's bf16 converts and the attention score chain out of the byte
count) have no counterpart here: the kernels' bytes are their own, and no
S x S score tensor exists on the kernel path.

The collective term's links follow ``init_device_mesh``'s rank order
(row-major, the last mesh dim fastest) at 8 cards a node: an axis whose
group fits in one node (size x stride <= 8) runs over NVLink 4, 450 GB/s
a direction; any other crosses nodes over the card's 400 Gb/s NDR
InfiniBand port, 50 GB/s a direction.  On the production meshes every
axis crosses nodes.  Each record keeps the collective bytes per axis and
the rate taken for it, so a reader can redo the term.

MODEL_FLOPS (the useful flops of ``useful_flops_ratio``), as ``repro``:
    train:    6 * N_active * tokens  (fwd 2x + bwd 4x)
    prefill:  2 * N_active * tokens
    decode:   2 * N_active * batch
``ideal_t`` is the larger of the useful flops at peak and the step's
arguments and outputs streamed once at the HBM rate;
``roofline_fraction`` = ideal_t / max(compute, memory, collective).

Every figure is the data sheet's for the NVIDIA H100 80GB HBM3 (SXM5) at
its 700 W limit; a card held to a lower power limit runs slower under
load.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch all \\
      --shape all --out experiments/torch/roofline
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.card import (CARD, CARDS_PER_NODE, HBM_BYTES_PER_S,
                              NDR_BYTES_PER_S, NVLINK_BYTES_PER_S,
                              PEAK_FLOPS)
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_arch


OUT = "experiments/torch/roofline"
DRYRUN = "experiments/torch/dryrun"


def axis_links(axes: dict[str, int]) -> dict[str, float]:
    """Bytes per second of the link each mesh axis crosses: {axis: rate}
    for an ordered {axis: size} mesh laid out row-major over the ranks,
    CARDS_PER_NODE to a node."""
    rates, stride = {}, 1
    for name in reversed(list(axes)):
        size = axes[name]
        rates[name] = (NVLINK_BYTES_PER_S
                       if size * stride <= CARDS_PER_NODE
                       else NDR_BYTES_PER_S)
        stride *= size
    return dict(reversed(list(rates.items())))


def model_flops(cfg, shape) -> float:
    """Analytic useful flops (global, all cards), on the port's
    ``active_param_count`` of fake params."""
    from repro_torch.launch import specs
    from repro_torch.models.model import active_param_count

    params = specs.param_shapes(cfg, specs.fake_mode())
    n_active = active_param_count(cfg, params)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * b * s
    if shape.kind == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b  # decode: one token per sequence


def terms(cfg, rec: dict, axes: dict[str, int]) -> dict:
    """The three terms (seconds) of a dry-run record and their inputs."""
    flops = rec["cost"]["flops_per_device"]
    byts = rec["cost"]["bytes_per_device"]
    links = axis_links(axes)
    by_axis: dict[str, int] = {}
    for kind in rec["collectives"].values():
        for axis, a in kind["axes"].items():
            by_axis[axis] = by_axis.get(axis, 0) + a["bytes"]
    coll_t = sum(b / links.get(a, NDR_BYTES_PER_S)
                 for a, b in by_axis.items())
    return {"compute": flops / PEAK_FLOPS[cfg.dtype],
            "memory": byts / HBM_BYTES_PER_S,
            "collective": coll_t,
            "_flops": flops, "_bytes": byts, "_by_axis": by_axis,
            "_links": {a: links.get(a, NDR_BYTES_PER_S) for a in by_axis}}


def roofline_of(cfg, shape, dr: dict, chips: int = 256) -> dict:
    """The roofline fields of one cell from its dry-run record ``dr``
    (single pod: a 16 x 16 mesh of ``chips`` cards)."""
    t = terms(cfg, dr, {"data": 16, "model": 16})
    mf = model_flops(cfg, shape)
    useful_bytes = (dr["memory"]["argument_bytes"]
                    + dr["memory"]["output_bytes"])
    seconds = {k: t[k] for k in ("compute", "memory", "collective")}
    t_bound = max(seconds.values())
    ideal_t = max(mf / chips / PEAK_FLOPS[cfg.dtype],
                  useful_bytes / HBM_BYTES_PER_S)
    flops = t["_flops"]
    return dict(
        status="ok", seconds=seconds,
        dominant=max(seconds, key=seconds.get), bound_s=t_bound,
        flops_per_chip=flops, bytes_per_chip=t["_bytes"],
        coll_bytes_per_chip=sum(t["_by_axis"].values()),
        coll_bytes_by_axis=t["_by_axis"],
        link_bytes_per_s_by_axis=t["_links"],
        model_flops_total=mf, model_flops_per_chip=mf / chips,
        useful_flops_ratio=(mf / chips) / flops if flops else 0.0,
        useful_bytes_per_chip=useful_bytes,
        roofline_fraction=ideal_t / t_bound if t_bound else 0.0,
        dryrun_memory=dr["memory"], dryrun_trace_s=dr["trace_s"])


def run_cell(arch: str, shape_name: str, out_dir: str,
             dryrun_dir: str = DRYRUN) -> dict:
    """The roofline of one cell on the single-pod mesh, from its dry-run
    record in ``dryrun_dir`` (traced here when there is none)."""
    from repro_torch.launch import dryrun

    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "status": "skipped",
                 "card": CARD}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec["why"] = why
        return _write(rec, out_dir)
    try:
        t0 = time.time()
        path = os.path.join(dryrun_dir, f"single_{arch}_{shape_name}.json")
        dr = None
        if os.path.exists(path):
            with open(path) as f:
                dr = json.load(f)
        if dr is None or dr.get("status") != "ok":
            dr = dryrun.run_cell(arch, shape_name, False, dryrun_dir)
        if dr["status"] != "ok":
            raise RuntimeError(f"dry-run: {dr.get('error')}")
        rec.update(roofline_of(cfg, shape, dr),
                   wall_s=round(time.time() - t0, 1))
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-1500:])
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}"
                                        f".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--dryrun-dir", default=DRYRUN)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    n_bad = 0
    for arch in archs:
        for shape in shapes:
            path = os.path.join(args.out, f"{arch}_{shape}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            rec = run_cell(arch, shape, args.out, args.dryrun_dir)
            n_bad += rec["status"] == "error"
            if rec["status"] == "ok":
                s = rec["seconds"]
                print(f"[ok     ] {arch:22s} {shape:12s} "
                      f"comp {s['compute'] * 1e3:10.2f}ms "
                      f"mem {s['memory'] * 1e3:10.2f}ms "
                      f"coll {s['collective'] * 1e3:10.2f}ms "
                      f"dom={rec['dominant']:10s} "
                      f"frac={rec['roofline_fraction']:.3f}", flush=True)
            else:
                print(f"[{rec['status']:7s}] {arch:22s} {shape:12s} "
                      f"{rec.get('error', rec.get('why', ''))}", flush=True)
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
