#!/usr/bin/env python3
"""A short check of the ternary wire's kernels on a CUDA card, before a full
``python3 chip_smoke.py``.

    python3 scripts/ternary_probe.py

Builds the kernels, runs chip_smoke's SASS check and its checks of the
ternary kernels and the three tallies against their plain versions, times
``ternary_majority`` with both tie rules and ``ternary_unpack`` to int8,
bf16 and float32 at the glm4-9b unembedding shape (n = 620,756,992, M = 4),
then runs chip_smoke's phases 9-11 (signSGD, the qwen1.5-32b Mode B preset
and the dense baselines) on reduced configs (d_model 128, 2 layers; the
qwen config with 4 kv heads, as its 40 of 40). One JSON line per result,
the card's name and power limit, and last ``{"ok": true, ...}``; exits
non-zero on any disagreement, or without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase(torch, dev, build, err):
    import chip_smoke as C
    from repro_torch.configs import base as tb
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ops, ref
    C.check_ftz(build)
    checks = (C.check_ternary_kernels(torch, ops, ref, sc, dev, err)
              + C.check_tallies(torch, ops, ref, sc, dev, err))
    C.log({"checks": checks, "max_abs_err": err})
    n = C.N_UNEMBED
    w2 = sc.ternary_words_for(n)
    gen = torch.Generator(device=dev).manual_seed(3)
    packed = torch.randint(-2 ** 31, 2 ** 31, (C.M_MAIN, w2), generator=gen,
                           device=dev, dtype=torch.int32)
    out = torch.empty(w2, dtype=torch.int32, device=dev)
    for ties in ("zero", "plus_one"):
        C.log({"ternary_majority_ties": ties, "ms": C.median_ms(
            torch, lambda: ops.ternary_majority(packed, ties=ties, out=out),
            reps=25)})
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        C.log({"ternary_unpack": str(dtype), "ms": C.median_ms(
            torch, lambda: ops.ternary_unpack(out, n, dtype), reps=25)})
    del packed, out
    C.GLOBAL_BATCH, C.SEQ, C.PRESET_SEQ, C.PRESET_BATCH = 8, 64, 64, 32
    cfg = tb.reduced_config(tb.get_config("glm4-9b"))
    full = tb.get_config
    tb.get_config = lambda name: (
        tb.reduced_config(full(name), num_kv_heads=4)
        if name == "qwen1.5-32b" else full(name))
    C.log({"signsgd_launches": C.run_signsgd_path(torch, cfg, dev)})
    C.log({"mode_b_launches": C.run_mode_b_path(torch, dev)})
    C.run_dense_path(torch, cfg, dev)
    return {"probe": "ok"}


def main() -> int:
    import chip_smoke as C
    return C.run_alone("ternary_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
