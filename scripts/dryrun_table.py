#!/usr/bin/env python3
"""The dry run's sweep as PERF.md's table: one row a (arch, shape), the
(16, 16) and (2, 16, 16) records side by side.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out a.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \\
        --out b.jsonl
    PYTHONPATH=src python scripts/dryrun_table.py a.jsonl b.jsonl

Per cell and mesh: the peak a rank (GB, 1e9 bytes) and whether it fits an
H100; the FLOPs a rank; the collectives' transit within and across pods
(GB); the bytes the rank hands the vote axes and the model group (GB); the
kernel launches of the step; for a train cell the ratio of
``flops_per_chip`` to the reference's analytic FLOPs over the chips
(``dryrun.analytic_train_flops``). Exits non-zero when a record is
"error" or a cell is missing.
"""
import json
import sys

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.configs.presets import default_train_config
from repro_torch.launch.dryrun import analytic_train_flops


def load(path: str) -> dict:
    with open(path) as f:
        return {(r["arch"], r["shape"]): r for r in map(json.loads, f)}


def ratio(r: dict) -> float:
    cell = SHAPES[r["shape"]]
    tcfg = default_train_config(r["arch"], cell)
    want = analytic_train_flops(get_config(r["arch"]), cell.global_batch,
                                cell.seq_len, tcfg.remat != "none")
    return r["flops_per_chip"] / (want / r["n_chips"])


def main(argv) -> int:
    meshes = [load(p) for p in argv[1:3]]
    print("| arch | shape | peak GB (fits) | TFLOPs a rank | ICI / DCI "
          "GB | vote / model GB | launches | FLOPs / analytic |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    bad = 0
    for arch in list_archs():
        for shape in SHAPES:
            recs = [m.get((arch, shape)) for m in meshes]
            if any(r is None or r["status"] == "error" for r in recs):
                print(f"| {arch} | {shape} | missing or error | | | | | |")
                bad += 1
                continue
            if recs[0]["status"] == "skip":
                continue

            def both(fn):
                return " / ".join(fn(r) for r in recs)
            cols = [
                both(lambda r: f"{r['memory']['peak_bytes_per_chip'] / 1e9:.2f}"
                     + ("" if r["fits"] else " (no)")),
                both(lambda r: f"{r['flops_per_chip'] / 1e12:.1f}"),
                both(lambda r: f"{r['collectives']['transit_bytes_ici'] / 1e9:.2f}"
                     f", {r['collectives']['transit_bytes_dci'] / 1e9:.3f}"),
                both(lambda r: f"{r['wire_bytes']['vote'] / 1e9:.3f}, "
                     f"{r['wire_bytes']['model'] / 1e9:.2f}"),
                both(lambda r: str(sum(r["launches"].values()))),
                (both(lambda r: f"{ratio(r):.2f}")
                 if SHAPES[shape].kind == "train" else "-"),
            ]
            print(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
