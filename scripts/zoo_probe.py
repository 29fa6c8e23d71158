#!/usr/bin/env python3
"""A short check of the decoder-only model zoo on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 16 alone.

    python3 scripts/zoo_probe.py

Builds the kernels, then phase 16: gemma3's attention at full width and
seq 4096, chunked (q_chunk 1024) against unchunked, a local and a global
layer; then the presets of gemma3-12b (6 layers), pixtral-12b (2),
qwen2-moe-a2.7b (2), qwen3-moe-235b-a22b (1) and deepseek-67b (2) at every
published width, seq 4096, M = 4 stacked voters, one row a voter a
microbatch: step 0 with every launch held against its plain version and
one leaf's vote against a plain recomputation, step 0 again from the same
state (bit-equal), step 1, exact launches, s/step, peak memory, and
qwen2-moe's profiled step. One JSON line per result, the card's name and
power limit, and last ``{"ok": true, ...}``; exits non-zero on any
disagreement, or without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"zoo_launches": C.run_zoo_path(torch, dev, err)}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("zoo_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
