#!/usr/bin/env python3
"""A short check of the dry run on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 19 (whose 19a ranks phase
20b is held to), then phase 20.

    python3 scripts/dryrun_probe.py

Builds the kernels, runs phase 19 at full size (see ``tp_probe.py``),
then 20a (phase 3's glm4-9b cell dry-run on "meta" against one real step
on the card: launches and FLOPs exact, the peak within
``chip_smoke.DRY_PEAK_SHARE``), 20b (19a's cells dry-run as each of the 4
ranks of a fake world: bytes by axis and launches equal to 19a's ranks')
and 20c (glm4-9b x train_4k on (16, 16) as rank 0 of 256 fake ranks, and
``dryrun.H100_MEMORY_BYTES`` against the card's ``total_memory``). One
JSON line per result, the card's name and power limit, and last
``{"ok": true, ...}``; exits non-zero on any disagreement, or without a
card.
"""
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = C.run_phase19(torch, dev, err)
    t0 = time.perf_counter()
    C.run_phase20(torch, dataclasses.replace(get_config("glm4-9b"),
                                             num_layers=2), dev)
    return {"tp_launches": launches,
            "phase20_seconds": time.perf_counter() - t0}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("dryrun_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
