"""Render the port's dry-run and roofline tables from the records of
``launch.dryrun`` and ``launch.roofline`` (port of
``repro.launch.report``; ``repro``'s layout less its TPU-projected
columns).

  PYTHONPATH=src python -m repro_torch.launch.report \\
      > experiments/torch/tables.md
"""
from __future__ import annotations

import json

from repro_torch.card import CARD
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.roofline import DRYRUN, OUT as ROOF


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def gib(x):
    return f"{x / 2 ** 30:.2f}"


def dryrun_table(mesh: str, dryrun_dir: str = DRYRUN) -> str:
    rows = ["| arch | shape | fn | peak GiB/dev | args GiB | collectives "
            "(count / GiB per dev) | trace s |",
            "|---|---|---|---|---|---|---|"]
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            r = _load(f"{dryrun_dir}/{mesh}_{arch}_{shape}.json")
            if r is None:
                continue
            if r["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | — | — | — | skipped: "
                            f"{r.get('why', '')[:40]} | — |")
                continue
            if r["status"] != "ok":
                rows.append(f"| {arch} | {shape} | {r.get('fn')} | ERROR | "
                            f"| {r.get('error', '')[:40]} | |")
                continue
            m = r["memory"]
            colls = r.get("collectives", {})
            cs = " ".join(
                f"{k.replace('collective-', 'c-')}:{v['count']}/"
                f"{gib(v['bytes'])}" for k, v in sorted(colls.items()))
            rows.append(
                f"| {arch} | {shape} | {r['fn']} | "
                f"{gib(m['peak_bytes_per_device'])} | "
                f"{gib(m['argument_bytes'])} | {cs} | {r['trace_s']} |")
    return "\n".join(rows)


def roofline_table(roof_dir: str = ROOF) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL_FLOPS/counted | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            r = _load(f"{roof_dir}/{arch}_{shape}.json")
            if r is None:
                continue
            if r["status"] == "skipped":
                rows.append(f"| {arch} | {shape} | — | — | — | skipped "
                            f"| — | — |")
                continue
            if r["status"] != "ok":
                rows.append(f"| {arch} | {shape} | ERR | | | "
                            f"{r.get('error', '')[:40]} | | |")
                continue
            s = r["seconds"]
            rows.append(
                f"| {arch} | {shape} | {s['compute']:.3f} | "
                f"{s['memory']:.3f} | {s['collective']:.3f} | "
                f"{r['dominant']} | "
                f"{r.get('useful_flops_ratio', 0):.2f} | "
                f"{r.get('roofline_fraction', 0):.3f} |")
    return "\n".join(rows)


def main() -> None:
    print(f"Card: {CARD} (data-sheet figures; the records' counts are per "
          f"card)\n")
    print("## Dry-run — single pod (16x16 = 256 cards)\n")
    print(dryrun_table("single"))
    print("\n## Dry-run — multi pod (2x16x16 = 512 cards)\n")
    print(dryrun_table("multi"))
    print("\n## Roofline — single pod, per (arch x shape)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
