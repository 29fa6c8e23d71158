"""SIGNUM with majority vote, Mode A — the paper's Algorithm 1
(``repro.core.signum``), over M voters stacked on one device.

Each voter keeps its own float32 momentum ``m_r = beta*m_r + (1-beta)*g_r``
and sends ``sign(m_r)`` on the paper's 1-bit wire (``allgather_1bit``:
32 signs per word, ties -> +1); the majority of the packed words moves
every parameter by ``x <- x - eta*(vote + weight_decay*x)``.

The reference's ``update(grads, state, params, step)`` sees every voter's
gradient at once inside its mesh region. Here the voters share one device
and their gradients are made one at a time, so the optimizer is split at
the wire: :attr:`Optimizer.encode` is the worker side (momentum + sign +
pack, one CUDA kernel per leaf) and runs as soon as a voter's gradient
exists, so that gradient can be freed before the next voter's;
:attr:`Optimizer.update` is the server side (popcount majority + apply,
one kernel each per leaf) once all M voters' words are in. Both write in
place — the momentum rows, the packed words and the parameters — where
the JAX package returns new arrays: at full glm4-9b width a second copy
of the M = 4 momentum alone would be 26 GB.

The gradient codec (``OptimizerConfig.codec``, DESIGN.md §8) decides what
goes on the wire, all on ``allgather_1bit``'s exchange, through its
trainer hooks (``core/codecs/base.py``):

* ``sign1bit`` — the signs of m' (``momentum_sign_pack``'s words);
* ``ternary2bit`` — ``momentum_sign_pack`` writes m' only and
  ``ternary_pack`` writes its 2-bit ternary symbols (0 abstains); the
  tally is ``ternary_majority`` (ties -> 0) and ``apply_ternary_vote``
  applies it, so an abstaining coordinate stays;
* ``ef_sign`` — m' alone, then t = e + m' replaces the residual row in
  place (``state["error"]``, momentum-shaped), ``bitpack`` packs its
  signs, and after the majority every voter's residual becomes
  t - mean|t| * vote;
* ``weighted_vote`` — the 1-bit words are unpacked (``bitunpack``) and
  decoded with reliability weights fixed for the step
  (``state["codec"]["flip_ema"]``, (M,)); the mismatch counts of all
  leaves make one EMA update per step, and the ±1 vote is repacked
  (``bitpack``) for ``apply_vote``.

Only this configuration is ported; every other option raises and names
the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import (MomentumMode, OptimizerConfig,
                                      VoteStrategy)
from repro_torch.core import codecs
from repro_torch.core import sign_compress as sc


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    wire: Callable     # (params) -> one step's wire buffers
    encode: Callable   # (voter, grads, state, wire) -> None, in place
    update: Callable   # (wire, state, params, step) -> None, in place


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """Learning rate at `step`, computed in float32 as the reference does."""
    f32 = np.float32
    lr = f32(cfg.learning_rate)
    if cfg.warmup_steps:
        warm = np.minimum(f32(step) / f32(cfg.warmup_steps), f32(1.0))
        lr = lr * warm
    if cfg.total_steps:
        frac = np.clip(f32(step - cfg.warmup_steps)
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        lr = lr * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
    return float(lr)


def validate(cfg: OptimizerConfig) -> None:
    """Raise for every optimizer option the port does not run yet."""
    def todo(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md {item}); the port runs "
            "signum_vote, per-worker momentum > 0 in float32, "
            "allgather_1bit, leaf-wise, with any codec")
    if cfg.kind != "signum_vote":
        todo(f"optimizer kind {cfg.kind!r}",
             "Queue 4 item 1 (beta = 0 / signsgd_vote and the dense "
             "baselines)")
    if cfg.momentum_mode != MomentumMode.PER_WORKER:
        todo("momentum_mode=global (Mode B)", "Queue 4 item 1")
    if cfg.momentum <= 0:
        todo("momentum = 0 (signSGD)", "Queue 4 item 1")
    if cfg.momentum_dtype != "float32":
        todo(f"momentum_dtype={cfg.momentum_dtype!r}",
             "Queue 4 item 2 (bf16 momentum)")
    if cfg.vote_strategy != VoteStrategy.ALLGATHER_1BIT:
        todo(f"vote_strategy={cfg.vote_strategy.value!r}",
             "Queue 1 item 3 (vote engine: psum_int8, hierarchical, auto)")
    codecs.get_codec(cfg.resolved_codec).validate_strategy(cfg.vote_strategy)
    if cfg.bucket_bytes != 0 or cfg.overlap or cfg.delayed_vote:
        todo("the bucketed VotePlan, overlap and delayed_vote",
             "Queue 1 item 7")


def packed_like(params: Dict[str, torch.Tensor], n_voters: int,
                codec: codecs.GradientCodec) -> Dict[str, torch.Tensor]:
    """One (M, w) int32 word buffer per leaf, row r voter r's packed
    symbols: 1-bit words (w = ceil(n/32)), or 2-bit words (w = ceil(n/16))
    for ``ternary2bit``."""
    return {k: torch.empty((n_voters, codec.words_for(p.numel())),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int) -> Optimizer:
    """Mode A SIGNUM over `n_voters` stacked voters (see module doc).

    State: ``{"count": int, "momentum": {name: (M, *leaf_shape) float32}}``
    — at M = 1 the reference's own per-worker layout ``(1, ...)`` — plus
    ``"error"`` (momentum-shaped) for ``ef_sign`` and ``"codec":
    {"flip_ema": (M,) float32}`` for ``weighted_vote``, as the reference
    lays them out. The codec's arithmetic is its own trainer hooks
    (``core/codecs/base.py``)."""
    validate(cfg)
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    beta = cfg.momentum
    codec = codecs.get_codec(cfg.resolved_codec)

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros():
            return {k: torch.zeros((n_voters,) + tuple(p.shape),
                                   dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
        state = {"count": 0, "momentum": zeros()}
        if codec.worker_state:
            state["error"] = zeros()
        if codec.server_state:
            device = next(iter(params.values())).device
            state["codec"] = codec.init_server_state(n_voters, device)
        return state

    def wire(params: Dict[str, torch.Tensor]) -> Dict:
        """One step's buffers: each leaf's (M, w) words, and what each
        voter's encode hands the codec's feedback (``ef_sign``'s mean|t|)."""
        return {"words": packed_like(params, n_voters, codec),
                "sent": {k: [None] * n_voters for k in params}}

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               wire: Dict) -> None:
        """Voter `voter`'s worker side: m_r <- beta*m_r + (1-beta)*g_r in
        place, and the codec's symbols into row `voter` of each leaf's
        words."""
        for k, g in grads.items():
            error = (state["error"][k][voter].view(-1) if "error" in state
                     else None)
            wire["sent"][k][voter] = codec.encode_voter_(
                g.reshape(-1), state["momentum"][k][voter].view(-1), beta,
                wire["words"][k][voter], error)

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> None:
        """Server side: each leaf's vote of its (M, w) words, then
        x <- x - eta*(vote + weight_decay*x) in place, then the codec's
        feedback."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        ctx = codec.begin_step(state.get("codec"))
        for k, p in params.items():
            flat = p.view(-1)
            votes = codec.vote_(wire["words"][k], flat.shape[0], ctx)
            codec.apply_(flat, votes, eta, wd)
            error = (state["error"][k].view(n_voters, -1)
                     if "error" in state else None)
            codec.feedback_voters_(votes, error, wire["sent"][k])
        codec.end_step(state.get("codec"), ctx)
        state["count"] += 1

    return Optimizer(init, wire, encode, update)
