#!/usr/bin/env python3
"""A short check of the streamed population vote and the population and
adaptive drills on a CUDA card, before a full ``python3 chip_smoke.py``:
chip_smoke's phase 13 alone.

    python3 scripts/population_probe.py

Builds the kernels, then phase 13 at full size: the streamed vote of
12,000 sampled voters of a 100,000-client population over 2^22
coordinates in six configurations, one full chunk of each held against
the plain versions, each at chunks of 1,024 and 512 rows (bit-equal), its
ms, peak memory and counters, and the dense annotated form against the
streamed form on 1,024 voters (13a), two configurations' votes once more
under torch.profiler (here only); the adaptive presets, the fed-smoke
and scale drills, the breaking-point specs and rows on the card against
their CPU twins (13b). One JSON line per result, the card's name and
power limit, and last ``{"ok": true, ...}``; exits non-zero on any
disagreement, or without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import chip_smoke as C
    C.POP_PROFILED = C.POP_PROBE_PROFILED   # the main path leaves them out
    return C.run_alone("population_probe", lambda torch, dev, build, err: {
        "launches": C.run_population_path(torch, dev, err)})


if __name__ == "__main__":
    sys.exit(main())
