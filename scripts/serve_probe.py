#!/usr/bin/env python3
"""Serving on a CUDA card, before a full ``python3 chip_smoke.py``:
chip_smoke's phase 18 alone.

    python3 scripts/serve_probe.py

Builds the kernels, then 18a (glm4-9b at every published width and full
depth behind the continuous engine with prefill admission, the static
scheduler on the same requests, three lanes against their request served
alone, inline admission against prefill, and a float32 2-layer twin with
every lane against its request served alone), 18b (qwen1.5-32b at half depth,
its int8 KV cache past two KV_CHUNKs, against a bf16-cache twin), 18c (the
other eight archs at phase 16 / 17's depths, each against its float32
twin's forward) and 18d (the launcher publishing into a running engine's
hot swap). One JSON line per result, the card's name and power limit, and
last ``{"ok": true, ...}``; exits non-zero on any disagreement, or without
a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import chip_smoke as C

    def phase(torch, dev, build, err):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {"phase18_launches": C.run_phase18(torch, dev, err)}
    return C.run_alone("serve_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
