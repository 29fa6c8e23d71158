"""SIGNUM with majority vote, Mode A — the paper's Algorithm 1
(``repro.core.signum``), over M voters stacked on one device.

Each voter keeps its own momentum ``m_r = beta*m_r + (1-beta)*g_r`` in
``momentum_dtype`` (float32, or bf16 as the glm4-9b preset has it) and
sends the signs of it; the majority moves every parameter by
``x <- x - eta*(vote + weight_decay*x)``.

The reference's ``update(grads, state, params, step)`` sees every voter's
gradient at once inside its mesh region. Here the voters share one device
and their gradients are made one at a time, so the optimizer is split at
the wire: :attr:`Optimizer.encode` is the worker side (momentum + sign +
pack, one CUDA kernel per leaf or two) and runs as soon as a voter's
gradient exists, so that gradient can be freed before the next voter's;
:attr:`Optimizer.update` is the server side (tally + apply, one kernel
each per leaf) once all M voters' words are in. Both write in place — the
momentum rows, the packed words and the parameters — where the JAX package
returns new arrays: at full glm4-9b width a second copy of the M = 4
float32 momentum alone would be 26 GB.

Two wires (``core/codecs/base.py`` has the details):

* ``allgather_1bit`` — the paper's 1-bit wire: 32 signs per word, the
  popcount majority (ties -> +1), ``apply_vote``;
* ``psum_int8`` — the count wire: every voter sends the ternary signs of
  its vote input, the vote is the sign of their sum (ties and all-abstain
  -> 0, the parameter stays). The trainer carries it as 2-bit symbols
  (``ternary_pack``), tallied by ``ternary_majority`` and applied by
  ``apply_ternary_vote``: the same decision as the reference's int8
  psum, with no ``torch.sign`` pass and no count tensor.

The gradient codec (``OptimizerConfig.codec``, DESIGN.md §8) decides what
goes on the wire, through its trainer hooks:

* ``sign1bit`` — the signs of m' (on the 1-bit wire
  ``momentum_sign_pack``'s own words);
* ``ternary2bit`` — the 2-bit wire on every strategy: ``momentum_sign_pack``
  writes m' only and ``ternary_pack`` writes its ternary symbols;
* ``ef_sign`` — m' alone, then t = e + m' replaces the residual row in
  place (``state["error"]``, momentum-shaped and -typed), its signs go on
  the wire, and after the vote every voter's residual becomes
  t - mean|t| * vote;
* ``weighted_vote`` (``allgather_1bit`` only, as in the reference) — the
  1-bit words are unpacked (``bitunpack``) and decoded with reliability
  weights fixed for the step (``state["codec"]["flip_ema"]``, (M,)); the
  mismatch counts of all leaves make one EMA update per step, and the ±1
  vote is repacked (``bitpack``) for ``apply_vote``.

Every other option raises and names the ROADMAP.md item that brings it.
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
from repro_torch.core.vote_engine import resolve_strategy


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    wire: Callable     # (params) -> one step's wire buffers
    encode: Callable   # (voter, grads, state, wire) -> None, in place
    update: Callable   # (wire, state, params, step) -> None, in place
    strategy: VoteStrategy   # the resolved vote strategy, never AUTO


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


#: the momentum dtypes of the momentum kernel's instantiations
MOMENTUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def validate(cfg: OptimizerConfig) -> None:
    """Raise for every optimizer option the port does not run yet (with
    `cfg.vote_strategy` already resolved, never AUTO)."""
    def todo(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md {item}); the port runs "
            "signum_vote, per-worker momentum > 0 in float32 or bfloat16, "
            "allgather_1bit or psum_int8, leaf-wise, with any codec")
    if cfg.kind != "signum_vote":
        todo(f"optimizer kind {cfg.kind!r}",
             "Queue 4 item 1 (beta = 0 / signsgd_vote and the dense "
             "baselines)")
    if cfg.momentum_mode != MomentumMode.PER_WORKER:
        todo("momentum_mode=global (Mode B)", "Queue 4 item 1")
    if cfg.momentum <= 0:
        todo("momentum = 0 (signSGD)", "Queue 4 item 1")
    if cfg.momentum_dtype not in MOMENTUM_DTYPES:
        raise NotImplementedError(
            f"momentum_dtype={cfg.momentum_dtype!r}: the momentum kernel "
            f"takes {sorted(MOMENTUM_DTYPES)}")
    if cfg.vote_strategy == VoteStrategy.HIERARCHICAL:
        todo("vote_strategy='hierarchical' in the trainer",
             "Queue 1 item 3 (the trainer on hierarchical, with Mode B)")
    codecs.get_codec(cfg.resolved_codec).validate_strategy(cfg.vote_strategy)
    if cfg.bucket_bytes != 0 or cfg.overlap or cfg.delayed_vote:
        todo("the bucketed VotePlan, overlap and delayed_vote",
             "Queue 1 item 7")


def packed_like(params: Dict[str, torch.Tensor], n_voters: int,
                codec: codecs.GradientCodec, two_bit: bool
                ) -> Dict[str, torch.Tensor]:
    """One (M, w) int32 word buffer per leaf, row r voter r's packed
    symbols: 1-bit words (w = ceil(n/32)), or 2-bit words (w =
    ceil(n/16)) on the 2-bit wire."""
    return {k: torch.empty((n_voters, codec.words_for(p.numel(), two_bit)),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int) -> Optimizer:
    """Mode A SIGNUM over `n_voters` stacked voters (see module doc).

    State: ``{"count": int, "momentum": {name: (M, *leaf_shape)}}`` in
    ``momentum_dtype``
    — at M = 1 the reference's own per-worker layout ``(1, ...)`` — plus
    ``"error"`` (momentum-shaped) for ``ef_sign`` and ``"codec":
    {"flip_ema": (M,) float32}`` for ``weighted_vote``, as the reference
    lays them out. The codec's arithmetic is its own trainer hooks
    (``core/codecs/base.py``)."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    # AUTO resolves once, for M voters, as the reference's train step
    # resolves it (psum_int8 at M = 1; M > 1 needs an H100 link model)
    cfg = dataclasses.replace(cfg, vote_strategy=resolve_strategy(
        cfg.vote_strategy, 0, n_voters, codec=cfg.resolved_codec))
    validate(cfg)
    beta = cfg.momentum
    codec = codecs.get_codec(cfg.resolved_codec)
    two_bit = codec.two_bit(cfg.vote_strategy)
    mom_dtype = MOMENTUM_DTYPES[cfg.momentum_dtype]

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros():
            return {k: torch.zeros((n_voters,) + tuple(p.shape),
                                   dtype=mom_dtype, device=p.device)
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
        return {"words": packed_like(params, n_voters, codec, two_bit),
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
                wire["words"][k][voter], error, two_bit)

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
            votes = codec.vote_(wire["words"][k], flat.shape[0], ctx,
                                two_bit)
            codec.apply_(flat, votes, eta, wd, two_bit)
            error = (state["error"][k].view(n_voters, -1)
                     if "error" in state else None)
            codec.feedback_voters_(votes, error, wire["sent"][k], two_bit)
        codec.end_step(state.get("codec"), ctx)
        state["count"] += 1

    return Optimizer(init, wire, encode, update, cfg.vote_strategy)
