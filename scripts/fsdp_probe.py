#!/usr/bin/env python3
"""A short check of the fused ZeRO backward on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 15 alone.

    python3 scripts/fsdp_probe.py

Builds the kernels, then phase 15: (a) the qwen1.5-32b Mode B preset at
every published width (2 layers) with its fsdp on, M = 4 stacked: every
launch of step 0 held against its plain version, the step-0 vote of
``layers.attn_wq`` against a plain recomputation, remat "dots" bit-equal
to "nested", the sgd preset; (b) 4 processes on the one card over gloo
(pod 2 x data 2 with a sign_flip voter, sgd on data 4; 1 layer, 2
microbatches, batch 8), each rank bit-equal to the stacked twin (sgd within
its mean's rounding bound), the bytes each rank hands the collectives
equal to the analytic count; (c) the launcher's ``main`` at full glm4-9b
depth and width, its launches exact and each held against its plain
version, and ``python -m repro_torch.launch.train`` with a reduced run
killed after a checkpoint and resumed. One JSON line per result, the card's name and power limit,
and last ``{"ok": true, ...}``; exits non-zero on any disagreement, or
without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"fsdp_launches": C.run_fsdp_path(torch, dev, err)}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("fsdp_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
