#!/usr/bin/env python3
"""The noise floor of a bf16 step's vote: one arch's preset step 0,
stacked M = 2 voters, against the same step with only its mamba
projections (z, xBC, dt) made another valid way (in float32 from the bf16
operands, rounded once, where the default is a bf16 product), so the two
differ only in the order of a float32 accumulation. Prints, per leaf, the
share of coordinates whose applied sign agrees and the count that differ
where every voter's |m'| is at least 2^-5 of the leaf's largest: what
chip_smoke's phase 19e holds its tensor-parallel votes to.

    python3 scripts/bf16_vote_noise.py [--arch zamba2-1.2b] [--depth 7]
        [--seq 512] [--batch 8] [--microbatches 4] [--device cuda]

The default is 19e's zamba2 cell on the card; ``--device cpu`` runs it on
the CPU (slowly at full width: cut --seq and --batch). The last line is
a JSON object with the worst leaves.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import base, presets
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import mamba2
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = dataclasses.replace(base.get_config(args.arch),
                              num_layers=args.depth)
    tcfg = base.TrainConfig(global_batch=args.batch, seq_len=args.seq,
                            optimizer=presets.default_optimizer(args.arch),
                            microbatches=args.microbatches, remat="full")
    tokens = torch.as_tensor(SyntheticLMPipeline(
        cfg, args.batch, args.seq, seed=0).global_batch_at(0)["tokens"],
        device=dev)

    def step():
        art = TS.make_train_step(cfg, tcfg, 2, device=dev)
        p, s = TS.materialize_state(cfg, tcfg, art, torch.Generator(
            device=dev).manual_seed(0))
        p0 = {k: v.clone() for k, v in p.items()}
        p, s, met = art.step_fn(p, s, {"tokens": tokens}, 0)
        signs = {k: torch.sign(p[k].float() - p0[k].float()).cpu()
                 for k in p}
        mom = {k: v.float().abs().cpu() for k, v in s["momentum"].items()}
        return signs, mom, float(met["loss"])

    a, mom, loss_a = step()
    orig = mamba2._project

    def project_f32(p, prefix, x, tp=None):
        return tuple((x.float() @ p[f"{prefix}_{n}"].float()).to(x.dtype)
                     for n in ("zproj", "xbcproj", "dtproj"))
    mamba2._project = project_f32
    try:
        b, _, loss_b = step()
    finally:
        mamba2._project = orig
    rows = []
    for k in a:
        n = a[k].numel()
        bad = a[k] != b[k]
        m = mom[k].view(2, -1)
        near = (m < 2.0 ** -5 * m.max()).any(0).view(a[k].shape)
        rows.append({"leaf": k, "agree": 1.0 - float(bad.sum()) / n,
                     "n": n, "differ": int(bad.sum()),
                     "differ_at_large_m": int((bad & ~near).sum())})
    rows.sort(key=lambda r: r["agree"])
    for r in rows:
        print(json.dumps(r))
    dev_name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                else "cpu")
    print(json.dumps({"arch": args.arch, "depth": args.depth,
                      "seq": args.seq, "batch": args.batch,
                      "microbatches": args.microbatches, "device": dev_name,
                      "losses": [loss_a, loss_b], "worst": rows[:8]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
