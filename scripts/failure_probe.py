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
import subprocess
import sys
import time

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("failure_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library("vote")
    C.log({"build_s": time.perf_counter() - t0})
    for line in build.BUILD_LOG.get("byzantine", "").splitlines():
        if any(k in line for k in ("registers", "spill")):
            C.log(f"ptxas byzantine: {line.strip()}")
    C.check_ftz(build)
    err = {name: 0.0 for name in ops.launch_counts()}
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    launches = C.run_failure_path(torch, cfg, dev, ops, ref, err)
    C.log({"kernels": [C.time_adversary(torch, ops, ref, dev, launches,
                                        err)]})
    C.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    C.log({"ok": True, "seconds": time.perf_counter() - t0,
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
