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

With a :class:`~repro_torch.core.vote_plan.VotePlan` (``plan``, built by
the train step from ``OptimizerConfig.bucket_bytes`` / ``codec_map``), the
leaves go to the wire as ONE flat buffer instead (the reference's plan
path, ``core/signum.py:77-145``): each voter's encode runs
``momentum_sign_pack`` without words and writes ``sign_ternary`` of each
leaf's vote input (m', or ``ef_sign``'s t) into its row of a ``(M,
n_params)`` int8 buffer at the leaf's offset; the server walks the plan's
buckets (``vote_plan.run_schedule``, each group on its own codec and
strategy, ``overlap`` selecting the double-buffered issue order), and each
leaf's int8 vote, a view of the flat votes, is applied with
``ternary_pack`` -> ``apply_ternary_vote`` (a 0 vote leaves the parameter
to weight decay). Per-leaf codecs come from the plan: the EF residual
exists only for the leaves mapped to ``ef_sign``, the server state is the
plan's.

``delayed_vote`` (with or without a plan) applies the vote banked at the
previous step and banks this step's: ``state["delayed"]`` holds one int8
tensor per leaf, zeros at init, so step 0 moves the parameters by weight
decay only. EF feedback and the server state observe the fresh vote.

Every other option raises and names the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import (MomentumMode, OptimizerConfig,
                                      VoteStrategy)
from repro_torch.core import codecs
from repro_torch.core import sign_compress as sc
from repro_torch.core import vote_plan as vp
from repro_torch.core.vote_engine import resolve_strategy
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    wire: Callable     # (params) -> one step's wire buffers
    encode: Callable   # (voter, grads, state, wire) -> None, in place
    update: Callable   # (wire, state, params, step) -> None, in place
    strategy: VoteStrategy   # the resolved vote strategy, never AUTO
    plan: Optional[vp.VotePlan] = None


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


def validate(cfg: OptimizerConfig, planned: bool = False) -> None:
    """Raise for every optimizer option the port does not run yet (with
    `cfg.vote_strategy` already resolved, never AUTO; `planned`: the
    leaves vote through a VotePlan, whose groups carry their own
    strategies)."""
    def todo(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md {item}); the port runs "
            "signum_vote, per-worker momentum > 0 in float32 or bfloat16, "
            "allgather_1bit or psum_int8 leaf-wise or any wire through a "
            "VotePlan, with any codec")
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
    if cfg.vote_strategy == VoteStrategy.HIERARCHICAL and not planned:
        todo("vote_strategy='hierarchical' in the leaf-wise trainer",
             "Queue 1 item 3 (the trainer on hierarchical, with Mode B)")
    codecs.get_codec(cfg.resolved_codec).validate_strategy(cfg.vote_strategy)


def packed_like(params: Dict[str, torch.Tensor], n_voters: int,
                codec: codecs.GradientCodec, two_bit: bool
                ) -> Dict[str, torch.Tensor]:
    """One (M, w) int32 word buffer per leaf, row r voter r's packed
    symbols: 1-bit words (w = ceil(n/32)), or 2-bit words (w =
    ceil(n/16)) on the 2-bit wire."""
    return {k: torch.empty((n_voters, codec.words_for(p.numel(), two_bit)),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def apply_int8_(p: torch.Tensor, vote: torch.Tensor, eta: float,
                weight_decay: float) -> None:
    """Flat p <- p - eta*(vote + weight_decay*p) in place, for a flat int8
    vote in {-1, 0, +1}: packed 16 a word (``ternary_pack``) and applied by
    ``apply_ternary_vote``, which rounds as the reference's jnp apply."""
    words = ops.ternary_pack(vote.view(1, -1))
    ops.apply_ternary_vote(p, words[0], eta, weight_decay, out=p)


def apply_delayed_(banked: torch.Tensor, p: torch.Tensor,
                   fresh: torch.Tensor, eta: float,
                   weight_decay: float) -> None:
    """``delayed_vote``: flat p takes the int8 vote `banked` at the
    previous step (as :func:`apply_int8_`), and `banked` takes the flat
    int8 `fresh` vote of this step."""
    words = ops.ternary_pack(banked.view(1, -1))
    banked.view(-1).copy_(fresh)
    ops.apply_ternary_vote(p, words[0], eta, weight_decay, out=p)


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int,
                        plan: Optional[vp.VotePlan] = None) -> Optimizer:
    """Mode A SIGNUM over `n_voters` stacked voters (see module doc),
    leaf-wise or, given `plan`, through its bucket schedule.

    State: ``{"count": int, "momentum": {name: (M, *leaf_shape)}}`` in
    ``momentum_dtype``
    — at M = 1 the reference's own per-worker layout ``(1, ...)`` — plus
    ``"error"`` (momentum-shaped) for ``ef_sign`` (under a plan, for its
    leaves only), ``"codec": {"flip_ema": (M,) float32}`` for
    ``weighted_vote`` and ``"delayed"`` (leaf-shaped int8) for
    ``delayed_vote``, as the reference lays them out. The codec's
    arithmetic is its own trainer hooks (``core/codecs/base.py``)."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    # AUTO resolves once, for M voters, as the reference's train step
    # resolves it (psum_int8 at M = 1; M > 1 needs an H100 link model)
    cfg = dataclasses.replace(cfg, vote_strategy=resolve_strategy(
        cfg.vote_strategy, 0, n_voters, codec=cfg.resolved_codec))
    validate(cfg, planned=plan is not None)
    beta = cfg.momentum
    codec = codecs.get_codec(cfg.resolved_codec)
    two_bit = codec.two_bit(cfg.vote_strategy)
    mom_dtype = MOMENTUM_DTYPES[cfg.momentum_dtype]
    slots = {s.name: s for s in plan.leaves} if plan is not None else {}
    leaf_codec = ({k: codecs.get_codec(c)
                   for k, c in plan.leaf_codecs().items()}
                  if plan is not None else {})
    ef_leaves = plan.worker_state_leaves if plan is not None else None
    has_server_state = (plan.has_server_state if plan is not None
                        else codec.server_state)

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros(names=None):
            return {k: torch.zeros((n_voters,) + tuple(p.shape),
                                   dtype=mom_dtype, device=p.device)
                    for k, p in params.items()
                    if names is None or k in names}
        device = next(iter(params.values())).device
        state = {"count": 0, "momentum": zeros()}
        if cfg.delayed_vote:
            state["delayed"] = {k: torch.zeros(p.shape, dtype=torch.int8,
                                               device=p.device)
                                for k, p in params.items()}
        if ef_leaves is None and codec.worker_state:
            state["error"] = zeros()
        elif ef_leaves:
            state["error"] = zeros(ef_leaves)
        if has_server_state:
            state["codec"] = (plan.init_server_state(n_voters, device)
                              if plan is not None else
                              codec.init_server_state(n_voters, device))
        return state

    def wire(params: Dict[str, torch.Tensor]) -> Dict:
        """One step's buffers: each leaf's (M, w) words (under a plan, the
        (M, n_params) int8 signs), and what each voter's encode hands the
        codec's feedback (``ef_sign``'s mean|t|)."""
        sent = {k: [None] * n_voters for k in params}
        if plan is not None:
            device = next(iter(params.values())).device
            return {"signs": torch.empty((n_voters, plan.n_params),
                                         dtype=torch.int8, device=device),
                    "sent": sent}
        return {"words": packed_like(params, n_voters, codec, two_bit),
                "sent": sent}

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               wire: Dict) -> None:
        """Voter `voter`'s worker side: m_r <- beta*m_r + (1-beta)*g_r in
        place, and the codec's symbols into row `voter` of each leaf's
        words (under a plan, the signs into its row of the flat buffer)."""
        if plan is not None:
            for k, g in grads.items():
                m = state["momentum"][k][voter].view(-1)
                ops.momentum_sign_pack(g.reshape(-1), m, beta, m_out=m,
                                       pack=False)
                error = (state["error"][k][voter].view(-1)
                         if k in state.get("error", {}) else None)
                x = leaf_codec[k].vote_input_(m, error)
                vp.write_signs(slots[k], x, wire["signs"][voter])
                wire["sent"][k][voter] = leaf_codec[k].sent_(x)
            return
        for k, g in grads.items():
            error = (state["error"][k][voter].view(-1) if "error" in state
                     else None)
            wire["sent"][k][voter] = codec.encode_voter_(
                g.reshape(-1), state["momentum"][k][voter].view(-1), beta,
                wire["words"][k][voter], error, two_bit)

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> None:
        """Server side: each leaf's vote of its (M, w) words (under a plan,
        the bucket walk over the flat signs), then x <- x - eta*(vote +
        weight_decay*x) in place (the banked vote under ``delayed_vote``),
        then the codec's feedback."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        if plan is not None:
            votes, new_cstate = vp.run_schedule(
                plan, wire["signs"], vp.VirtualBucketWire(n_voters),
                state.get("codec"), overlap=cfg.overlap)
            for key, v in state.get("codec", {}).items():
                v.copy_(new_cstate[key])
            for k, p in params.items():
                slot = slots[k]
                vote = votes[slot.offset:slot.offset + slot.length]
                if k in state.get("error", {}):
                    error = state["error"][k].view(n_voters, -1)
                    leaf_codec[k].feedback_decoded_(
                        vote.to(error.dtype), error, wire["sent"][k])
                if cfg.delayed_vote:
                    apply_delayed_(state["delayed"][k], p.view(-1), vote,
                                   eta, wd)
                else:
                    apply_int8_(p.view(-1), vote, eta, wd)
            state["count"] += 1
            return
        ctx = codec.begin_step(state.get("codec"))
        for k, p in params.items():
            flat = p.view(-1)
            votes = codec.vote_(wire["words"][k], flat.shape[0], ctx,
                                two_bit)
            if cfg.delayed_vote:
                n = flat.shape[0]
                fresh = (ops.ternary_unpack(votes, n) if two_bit
                         else ops.bitunpack(votes, n, torch.int8))
                apply_delayed_(state["delayed"][k], flat, fresh, eta, wd)
            else:
                codec.apply_(flat, votes, eta, wd, two_bit)
            error = (state["error"][k].view(n_voters, -1)
                     if "error" in state else None)
            codec.feedback_voters_(votes, error, wire["sent"][k], two_bit)
        codec.end_step(state.get("codec"), ctx)
        state["count"] += 1

    return Optimizer(init, wire, encode, update, cfg.vote_strategy, plan)
