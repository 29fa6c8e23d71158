#!/usr/bin/env python3
"""A short check of the model axis on a CUDA card, before a full
``python3 chip_smoke.py``: chip_smoke's phase 19 alone.

    python3 scripts/tp_probe.py

Builds the kernels, then phase 19 at full size: the stacked twins and the
single-device serving reference, then a world of 4 processes sharing the
card over gloo: 19a (glm4-9b at every published width, 2 layers, on data
2 x model 2, sign1bit and ternary2bit), 19g (the same cell with one
adversary of two voters: random leaf-wise, blind under a VotePlan on
psum_int8; each draw held to the twin's at the block's global
coordinates, after the adversary kernel's checks under the counter map),
19d (qwen3-moe-235b-a22b's Mode B
fsdp preset, 1 layer, its experts in the EP form), 19e (the presets of
mamba2-2.7b, zamba2-1.2b and whisper-tiny), 19c (serving glm4-9b, 8
layers, and its float32 twin, on model 4 with the sequence-sharded flash
decode and on data 2 x model 2 with a heads-sharded cache) and 19f
(serving qwen2-moe, mamba2, zamba2 and whisper on model 4 and qwen3-moe on
data 2 x model 2, each beside a float32 twin). One JSON line per result,
the card's name and power limit, and last ``{"ok": true, ...}``; exits
non-zero on any disagreement, or without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"tp_launches": C.run_phase19(torch, dev, err)}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("tp_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
