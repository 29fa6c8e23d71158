#!/usr/bin/env python3
"""A short check of the priced wire and the SSM, hybrid and encoder-decoder
presets on a CUDA card, before a full ``python3 chip_smoke.py``:
chip_smoke's phase 17 alone.

    python3 scripts/family_probe.py [--mamba2-depth N ...]

Builds the kernels, then phase 17a at phase 3's glm4-9b cell (2 layers at
every published width, M = 4 stacked voters, batch 8, seq 512): the
trainer at ``vote_strategy=auto`` bit-equal to the wire it resolved, the
vote API's default (AUTO) on four codecs of the trained momentum bit-equal
to the named wires, and the AUTO plan (``bucket_bytes=-1``, overlap, the
embeddings on ternary2bit) bit-equal to its named twin, its trace rendered
by the port's report; then phase 17b, the presets of mamba2-2.7b,
zamba2-1.2b and whisper-tiny at every published width, seq 4096, M = 4,
one row a voter a microbatch, mamba2's next step under
torch.profiler. ``--mamba2-depth`` runs mamba2 at each depth given, in
turn (default: chip_smoke's); a depth that does not fit the card is
reported and the next one runs. One JSON line per result, the card's
name and power limit, and last ``{"ok": true, ...}``; exits non-zero on
any disagreement, or without a card.
"""
import argparse
import gc
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import chip_smoke as C
    ap = argparse.ArgumentParser()
    ap.add_argument("--mamba2-depth", type=int, nargs="*", default=None)
    args = ap.parse_args()

    def phase(torch, dev, build, err):
        from repro_torch.configs.base import get_config
        import dataclasses
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
        launches = C.run_wire_path(torch, cfg, dev)
        depths = args.mamba2_depth or [C.FAMILIES[0][1]]
        for arch, depth, leaf in C.FAMILIES:
            for d in (depths if arch == "mamba2-2.7b" else [depth]):
                try:
                    got = C.run_zoo_arch(torch, dev, err, arch, d, leaf,
                                         phase_name="family",
                                         profiled=arch == C.FAMILY_PROFILED)
                except torch.cuda.OutOfMemoryError as e:
                    C.log({"phase": "family_oom", "arch": arch, "depth": d,
                           "error": str(e)[:300]})
                    got = {}
                gc.collect()
                torch.cuda.empty_cache()
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
        return {"phase17_launches": launches}
    return C.run_alone("family_probe", phase)


if __name__ == "__main__":
    sys.exit(main())
