#!/usr/bin/env python3
"""A short check of the multi-process wire on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 14 alone.

    python3 scripts/mesh_probe.py

Builds the kernels, then phase 14 at full size: the stacked twin (glm4-9b
at every published width, 2 layers, M = 4) of six configurations, 2 steps
each, then a world of 4 processes on the one card, over gloo, one voter
each, whose losses, diagnostics, parameters and momenta must equal the
twin's bit for bit, with exact launches per rank, every launch of each
run's first step on rank 0 held against its plain version, and each leaf's
mesh vote of the trained momentum equal to the virtual vote of the gathered
rows.
One JSON line per result (the bytes each rank handed the collectives per
step beside the wire report and a float32 gradient, the step split into
collectives and the rest), the card's name and power limit, and last
``{"ok": true, ...}``; exits non-zero on any disagreement, or without a
card.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    return {"mesh_launches": C.run_mesh_path(torch, cfg, dev, err)}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("mesh_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
