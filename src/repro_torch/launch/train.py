"""Training launcher with checkpoint / restart and a watchdog
(``repro.launch.train``), one process, one voter (M = 1):

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The reference's flags, and ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path). Each step runs under a ``Watchdog`` and a
``train.step`` span (``--trace FILE`` writes the JSONL trace with one step
row each); every ``--ckpt-every`` steps, and after the last, the
parameters, the optimizer state and the data cursor are saved
(``checkpoint.AsyncCheckpointer``). A run started on a directory that
holds a checkpoint restores the latest and resumes after its step, so a
run killed after a save and started again trains as one that was never
stopped. At the end it prints the kernel launches of the run (none on the
CPU, where each wrapper takes its plain version) and, on a card, the peak
device memory. ``--serve-dir`` (publishing serving checkpoints) belongs to
the serving engine, which is not ported yet (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step_dir, restore)
from repro_torch.configs.base import (OptimizerConfig, TrainConfig,
                                      get_config, list_archs,
                                      reduced_config)
from repro_torch.core import attacks
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.distributed.fault_tolerance import Watchdog
from repro_torch.kernels import ops
from repro_torch.obs import recorder as obs
from repro_torch.train import train_step as TS


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          opt_kind: str, lr: float, momentum: float, microbatches: int,
          byz_mode: str, byz_n: int):
    """(model config, train config) of the flags, as the reference builds
    them; an arch the port has no config for raises (ROADMAP.md Queue 1
    item 11)."""
    if arch not in list_archs():
        raise NotImplementedError(
            f"arch {arch!r} arrives with the rest of the model zoo "
            f"(ROADMAP.md Queue 1 item 11); the port has {list_archs()}")
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    opt = OptimizerConfig(kind=opt_kind, learning_rate=lr, momentum=momentum)
    tcfg = TrainConfig(
        global_batch=batch, seq_len=seq, microbatches=microbatches,
        optimizer=opt, byzantine=attacks.build_config(byz_mode, byz_n))
    return cfg, tcfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--opt", default="signum_vote")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--byzantine", default="none")
    ap.add_argument("--adversaries", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--serve-dir", default=None,
                    help="publish params-only serving checkpoints here (not "
                         "ported: ROADMAP.md Queue 1 item 12)")
    ap.add_argument("--serve-every", type=int, default=50)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    obs.add_trace_arg(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    if args.serve_dir:
        raise NotImplementedError(
            "--serve-dir publishes checkpoints to the serving engine, which "
            "is not ported yet (ROADMAP.md Queue 1 item 12)")
    cfg, tcfg = build(args.arch, reduced=args.reduced, batch=args.batch,
                      seq=args.seq, opt_kind=args.opt, lr=args.lr,
                      momentum=args.momentum,
                      microbatches=args.microbatches,
                      byz_mode=args.byzantine, byz_n=args.adversaries)
    trace_rec = obs.activate_trace(args)
    rec = obs.get_recorder()
    art = TS.make_train_step(cfg, tcfg, device=args.device)
    params, opt_state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=art.device).manual_seed(
            args.seed))
    pipe = SyntheticLMPipeline(cfg, args.batch, args.seq, seed=args.seed)

    ckpt: Optional[AsyncCheckpointer] = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step_dir(args.ckpt_dir):
            params, opt_state, data_state, meta = restore(
                args.ckpt_dir, like_params=params, like_opt=opt_state,
                device=art.device)
            # the step counter is a Python int in the optimizer's state
            opt_state["count"] = int(opt_state["count"])
            pipe.restore(data_state)
            start_step = int(meta["step"]) + 1
            print(f"restored checkpoint at step {meta['step']}", flush=True)

    pipe.state.step = start_step
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next(pipe)
        with Watchdog(args.watchdog_s) as wd:
            with rec.span("train.step", step=step) as sp:
                params, opt_state, metrics = art.step_fn(
                    params, opt_state, batch, step)
                loss = float(metrics["loss"])
        if rec.enabled:
            rec.step(kind_detail="train", step=step, loss=loss,
                     arch=args.arch, opt=args.opt,
                     phase_s={"step": sp.dur_s})
        if wd.fired:
            raise TimeoutError(f"step {step} exceeded {args.watchdog_s}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"({dt / max(step - start_step + 1, 1):.3f}s/step)",
                  flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, params, opt_state, pipe.checkpoint(),
                      meta={"arch": args.arch, "step": step})
    if ckpt:
        ckpt.save(args.steps - 1, params, opt_state, pipe.checkpoint(),
                  meta={"arch": args.arch, "step": args.steps - 1})
        ckpt.wait()
    obs.finish_trace(trace_rec)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"kernel launches {json.dumps(launched)}", flush=True)
    if art.device.type == "cuda":
        print(f"max memory allocated {torch.cuda.max_memory_allocated()} "
              "bytes", flush=True)
    print("done.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
