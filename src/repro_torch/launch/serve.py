"""Batched serving driver (``repro.launch.serve``): prefill a batch of
prompts, then decode tokens; or, with ``--engine``, the continuous-batching
:class:`repro_torch.serve.ServeEngine` fed by the deterministic Poisson
generator:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --reduced --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --reduced --engine --requests 16 --rate 0.5

The reference's flags and printed lines, and ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path). ``--trace FILE`` records
the obs spans and counters either way. The weights and the batch loop's
prompts (and frames, for whisper) are drawn from ``--seed`` by the port's
generator, not ``jax.random``, so the sampled ids differ from the
reference's; the batch loop's temperature sampling draws each row's noise
under the key ``fold_in(fold_in(PRNGKey(seed), row), pos)`` (the engine's
rule), where the reference splits one key a step.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.obs import recorder as obs
from repro_torch.serve.engine import sample
from repro_torch.train.serve_step import make_cache_rehome, make_decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_engine(cfg, params, args) -> None:
    from repro_torch.serve import ServeConfig, ServeEngine, poisson_requests

    max_len = args.prompt_len + args.gen
    sc = ServeConfig(n_slots=args.batch, max_len=max_len,
                     prompt_pad=args.prompt_len,
                     temperature=args.temperature, seed=args.seed)
    eng = ServeEngine(cfg, params, sc)
    reqs = poisson_requests(
        n_requests=args.requests, rate=args.rate,
        vocab_size=cfg.vocab_size, prompt_lens=(args.prompt_len,),
        gen_range=(args.gen, args.gen), seed=args.seed)
    t0 = time.time()
    rep = eng.run(reqs)
    dt = time.time() - t0
    print(f"engine: {rep.completed}/{rep.n_requests} requests, "
          f"{rep.total_tokens} tokens in {rep.ticks} ticks "
          f"({dt:.2f}s, goodput {rep.goodput_tokens_per_tick:.2f} "
          f"tok/tick, occupancy {rep.occupancy_mean:.2f})")
    print(f"latency ticks p50/p95/p99: {rep.latency_p50:.1f}/"
          f"{rep.latency_p95:.1f}/{rep.latency_p99:.1f}  "
          f"ttft p50: {rep.ttft_p50:.1f}")
    first = min(rep.records)
    print("sampled token ids (first request):",
          rep.records[first].tokens)


def _next_tokens(logits, pos: int, args) -> torch.Tensor:
    rows = torch.arange(logits.shape[0], device=logits.device)
    return sample(logits, rows, torch.full_like(rows, pos),
                  args.temperature, args.seed)[:, None]


def _run_batch(cfg, params, args, dev: torch.device) -> None:
    rec = obs.get_recorder()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    batch = M.make_batch(cfg, args.batch, args.prompt_len, gen, dev)

    max_len = args.prompt_len + args.gen
    t0 = time.time()
    with rec.span("serve.prefill", batch=args.batch,
                  prompt_len=args.prompt_len):
        logits, cache = M.prefill(cfg, params, batch)
        # the re-home into the max_len decode cache (recurrent state
        # passes through, seq leaves land at the origin)
        cache = make_cache_rehome(cfg, args.batch, max_len)(cache)
        _sync(dev)
    prefill_s = time.time() - t0
    print(f"prefill: {args.batch}x{args.prompt_len} in {prefill_s:.2f}s")

    decode = make_decode_step(cfg)
    tokens = _next_tokens(logits[:, -1], args.prompt_len - 1, args)
    out = [tokens]
    t0 = time.time()
    with rec.span("serve.decode", steps=args.gen):
        for i in range(args.gen):
            pos = args.prompt_len + i
            logits_t, cache = decode(params, tokens, cache, pos)
            tokens = _next_tokens(logits_t, pos, args)
            out.append(tokens)
        _sync(dev)
    gen_s = time.time() - t0
    toks = torch.cat(out, dim=1)
    print(f"decode: {args.gen} steps x batch {args.batch} in {gen_s:.2f}s "
          f"({args.gen * args.batch / max(gen_s, 1e-9):.1f} tok/s)")
    print("sampled token ids (first row):", toks[0].tolist())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching via repro_torch.serve."
                         "ServeEngine (slot pool of --batch, in-flight "
                         "admission)")
    ap.add_argument("--requests", type=int, default=16,
                    help="--engine: number of Poisson requests")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="--engine: offered load in requests/tick")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu (the plain PyTorch path)")
    obs.add_trace_arg(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)

    rec = obs.activate_trace(args)
    try:
        if args.engine:
            _run_engine(cfg, params, args)
        else:
            _run_batch(cfg, params, args, dev)
    finally:
        obs.finish_trace(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
