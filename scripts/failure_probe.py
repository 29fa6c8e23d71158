#!/usr/bin/env python3
"""A short check of the failure drills on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 12 alone.

    python3 scripts/failure_probe.py

Builds the kernels, runs chip_smoke's SASS check, then phase 12 at full
size: the adversary kernel against its plain version (12a), GOLDEN and the
non-adaptive presets on the card against their CPU twins and the Fig. 4
surface (12b), glm4-9b at every published width, 2 layers, M = 4, with one
adversarial voter (12c), the checkpoint round trips (12d), and the
adversary kernel's timing row. One JSON line per result, the card's name
and power limit, and last ``{"ok": true, ...}``; exits non-zero on any
disagreement, or without a card.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops, ref
    for line in build.BUILD_LOG.get("byzantine", "").splitlines():
        if any(k in line for k in ("registers", "spill")):
            C.log(f"ptxas byzantine: {line.strip()}")
    C.check_ftz(build)
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    launches = C.run_failure_path(torch, cfg, dev, ops, ref, err)
    return {"kernels": [C.time_adversary(torch, ops, ref, dev, launches,
                                         err)]}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("failure_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
