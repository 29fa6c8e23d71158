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
from repro_torch.core import sign_compress as sc
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    encode: Callable   # (voter, grads, state, packed) -> None, in place
    update: Callable   # (packed, state, params, step) -> None, in place


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
            "allgather_1bit, codec sign1bit, leaf-wise")
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
    if cfg.resolved_codec != "sign1bit":
        todo(f"codec {cfg.resolved_codec!r}", "Queue 1 item 8")
    if cfg.bucket_bytes != 0 or cfg.overlap or cfg.delayed_vote:
        todo("the bucketed VotePlan, overlap and delayed_vote",
             "Queue 1 item 7")


def packed_like(params: Dict[str, torch.Tensor], n_voters: int
                ) -> Dict[str, torch.Tensor]:
    """One (M, ceil(n/32)) int32 word buffer per leaf: row r is voter r's
    packed signs."""
    return {k: torch.empty((n_voters, sc.words_for(p.numel())),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int) -> Optimizer:
    """Mode A SIGNUM over `n_voters` stacked voters (see module doc).

    State: ``{"count": int, "momentum": {name: (M, *leaf_shape) float32}}``
    — at M = 1 the reference's own per-worker layout ``(1, ...)``."""
    validate(cfg)
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    beta = cfg.momentum

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        return {"count": 0,
                "momentum": {k: torch.zeros((n_voters,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()}}

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               packed: Dict[str, torch.Tensor]) -> None:
        """Voter `voter`'s worker side: m_r <- beta*m_r + (1-beta)*g_r in
        place, and its sign bits into row `voter` of each leaf's words."""
        for k, g in grads.items():
            m_row = state["momentum"][k][voter].view(-1)
            ops.momentum_sign_pack(g.reshape(-1), m_row, beta, m_out=m_row,
                                   packed_out=packed[k][voter])

    @torch.no_grad()
    def update(packed: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor], step: int) -> None:
        """Server side: popcount majority of each leaf's (M, w) words, then
        x <- x - eta*(vote + weight_decay*x) in place."""
        eta = lr_at(cfg, step)
        for k, p in params.items():
            flat = p.view(-1)
            ops.apply_vote(flat, ops.majority(packed[k]), eta,
                           cfg.weight_decay, out=flat)
        state["count"] += 1

    return Optimizer(init, encode, update)
