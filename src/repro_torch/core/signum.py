"""SIGNUM / signSGD with majority vote — the paper's Algorithm 1 — and the
dense baselines it is benchmarked against (``repro.core.signum``), over M
voters stacked on one device.

Mode A (``momentum_mode=per_worker``, paper-faithful): each voter keeps its
own momentum ``m_r = beta*m_r + (1-beta)*g_r`` in ``momentum_dtype``
(float32, or bf16 as the glm4-9b preset has it) and sends the signs of it;
at beta = 0 (signSGD itself) there is no momentum and each voter sends the
signs of its gradient. The majority moves every parameter by
``x <- x - eta*(vote + weight_decay*x)``.

Mode B (``momentum_mode=global``, the reference's three largest archs):
each voter sends the signs of its gradient; one leaf-shaped momentum, with
no voter axis, takes the vote, ``u = beta*u + (1-beta)*vote``, and the
update applies ``sign(u)``, which is ternary (a coordinate whose u is 0
moves by weight decay only). At beta = 0 the update applies the vote
itself. ``kind`` ``signum_vote`` and ``signsgd_vote`` both build this
sign optimizer; the mode and beta decide what it does, as in the
reference.

The reference's ``update(grads, state, params, step)`` sees every voter's
gradient at once inside its mesh region. Here the voters share one device
and their gradients are made one at a time, so the optimizer is split at
the wire: :attr:`Optimizer.encode` is the worker side (momentum + sign +
pack, one CUDA kernel per leaf or two) and runs as soon as a voter's
gradient exists, so that gradient can be freed before the next voter's;
:attr:`Optimizer.update` is the server side (tally + apply, one kernel
each per leaf; under Mode B with beta > 0 the vote unpacked to a float,
the momentum kernel, the ternary pack of u and the ternary apply) once all
M voters' words are in. Both write in place — the momentum rows, the
packed words and the parameters — where the JAX package returns new
arrays: at full glm4-9b width a second copy of the M = 4 float32 momentum
alone would be 26 GB.

Three wires (``core/codecs/base.py`` has the details):

* ``allgather_1bit`` — the paper's 1-bit wire: 32 signs per word, the
  popcount majority (ties -> +1), ``apply_vote``;
* ``psum_int8`` — the count wire: every voter sends the ternary signs of
  its vote input, the vote is the sign of their sum (ties and all-abstain
  -> 0, the parameter stays). The trainer carries it as 2-bit symbols
  (``ternary_pack``), tallied by ``ternary_majority`` and applied by
  ``apply_ternary_vote``: the same decision as the reference's int8
  psum, with no ``torch.sign`` pass and no count tensor;
* ``hierarchical`` — the same 2-bit symbols, tallied with ties +1
  (``ternary_majority(ties="plus_one")``): the reference's count
  reduce-scatter, ``sign_binary`` of each count and 1-bit rebroadcast,
  without a count tensor.

The gradient codec (``OptimizerConfig.codec``, DESIGN.md §8) decides what
goes on the wire, through its trainer hooks:

* ``sign1bit`` — the signs of the vote input (on the 1-bit wire with
  momentum, ``momentum_sign_pack``'s own words; without, ``bitpack`` of
  the gradient row);
* ``ternary2bit`` — the 2-bit wire on every strategy: ``momentum_sign_pack``
  writes m' only (if there is a momentum) and ``ternary_pack`` writes its
  ternary symbols;
* ``ef_sign`` (Mode A only, as in the reference) — m' alone (or g), then
  t = e + m' (or e + g) replaces the residual row in place
  (``state["error"]``, one row per voter, in ``momentum_dtype``), its
  signs go on the wire, and after the vote every voter's residual becomes
  t - mean|t| * vote;
* ``weighted_vote`` (``allgather_1bit`` only, as in the reference) — the
  1-bit words are unpacked (``bitunpack``) and decoded with reliability
  weights fixed for the step (``state["codec"]["flip_ema"]``, (M,)); the
  mismatch counts of all leaves make one EMA update per step, and the ±1
  vote is repacked (``bitpack``) for the apply.

With a :class:`~repro_torch.core.vote_plan.VotePlan` (``plan``, built by
the train step from ``OptimizerConfig.bucket_bytes`` / ``codec_map``), the
leaves go to the wire as ONE flat buffer instead (the reference's plan
path, ``core/signum.py:77-145``): each voter's encode runs
``momentum_sign_pack`` without words (Mode A, beta > 0) and writes
``sign_ternary`` of each leaf's vote input (m', g, or ``ef_sign``'s t)
into its row of a ``(M, n_params)`` int8 buffer at the leaf's offset; the
server walks the plan's buckets (``vote_plan.run_schedule``, each group on
its own codec and strategy, ``overlap`` selecting the double-buffered
issue order), and each leaf's int8 vote, a view of the flat votes, is
applied with ``ternary_pack`` -> ``apply_ternary_vote`` (a 0 vote leaves
the parameter to weight decay; under Mode B the vote first goes into the
momentum). Per-leaf codecs come from the plan: the EF residual exists only
for the leaves mapped to ``ef_sign``, the server state is the plan's.

A Byzantine model (``byz``, the train step's ``TrainConfig.byzantine``,
as the reference's ``build_optimizer(..., byz=...)`` takes it) makes the
voters below ``byz.num_adversaries`` adversarial, drawing under the step
``update`` is given and salt 0. Leaf-wise, an adversarial voter's vote
input goes to the wire through int8 ``sign_ternary`` symbols, the
adversary (``core.byzantine``, in place) and the wire's pack
(``bitpack`` or ``ternary_pack``), each leaf drawing from the same key
with its counter over the leaf's own elements, as the reference's
per-leaf adversary does; honest voters keep the path above. Under a plan
the adversary acts once on the whole ``(M, n_params)`` sign buffer before
the bucket walk, its counter over the flat row. The dense baselines
ignore it, as the reference's do.

``delayed_vote`` (Mode A, with or without a plan) applies the vote banked
at the previous step and banks this step's: ``state["delayed"]`` holds one
int8 tensor per leaf, zeros at init, so step 0 moves the parameters by
weight decay only. EF feedback and the server state observe the fresh
vote.

The dense baselines (``kind`` ``sgd`` / ``sgdm`` / ``adam``,
:func:`make_dense_optimizer`) mean the voters' gradients, as the
reference's psum-mean does, and update in float32; they have no vote and
no kernel. :func:`build_optimizer` picks the family from ``kind``.

Every other option raises and names the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ByzantineConfig, MomentumMode,
                                      OptimizerConfig, VoteStrategy)
from repro_torch.core import byzantine, codecs, majority_vote
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
#: the optimizer kinds of the sign family and of the dense baselines
SIGN_KINDS = ("signum_vote", "signsgd_vote")
DENSE_KINDS = ("sgd", "sgdm", "adam")


def per_worker(cfg: OptimizerConfig) -> bool:
    """Whether each voter keeps its own momentum row: the reference's
    ``per_worker`` (Mode A with beta > 0)."""
    return (cfg.kind in SIGN_KINDS
            and cfg.momentum_mode == MomentumMode.PER_WORKER
            and cfg.momentum > 0)


def validate(cfg: OptimizerConfig) -> None:
    """Raise for every option of the sign family the port does not run
    yet, and for what the reference refuses (with `cfg.vote_strategy`
    already resolved, never AUTO)."""
    if cfg.kind not in SIGN_KINDS:
        raise ValueError(f"optimizer kind {cfg.kind!r} is not of the sign "
                         f"family {SIGN_KINDS}")
    if cfg.momentum_dtype not in MOMENTUM_DTYPES:
        raise NotImplementedError(
            f"momentum_dtype={cfg.momentum_dtype!r}: the momentum kernel "
            f"takes {sorted(MOMENTUM_DTYPES)}")
    codecs.get_codec(cfg.resolved_codec).validate_strategy(cfg.vote_strategy)


def packed_like(params: Dict[str, torch.Tensor], n_voters: int,
                codec: codecs.GradientCodec, two_bit: bool
                ) -> Dict[str, torch.Tensor]:
    """One (M, w) int32 word buffer per leaf, row r voter r's packed
    symbols: 1-bit words (w = ceil(n/32)), or 2-bit words (w =
    ceil(n/16)) on the 2-bit wires."""
    return {k: torch.empty((n_voters, codec.words_for(p.numel(), two_bit)),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def apply_int8_(p: torch.Tensor, vote: torch.Tensor, eta: float,
                weight_decay: float) -> None:
    """Flat p <- p - eta*(vote + weight_decay*p) in place, for a flat int8
    vote in {-1, 0, +1} (or a float tensor, whose ``sign_ternary`` is the
    vote): packed 16 a word (``ternary_pack``) and applied by
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


def apply_momentum_vote_(u: torch.Tensor, vote: torch.Tensor,
                         p: torch.Tensor, beta: float, eta: float,
                         weight_decay: float) -> None:
    """Mode B's update of one flat leaf, in place: u <- beta*u +
    (1-beta)*vote (the momentum kernel's own arithmetic, with g the vote
    as an exact bf16 ±1/0), then p <- p - eta*(sign(u) + weight_decay*p)
    (``sign(u)`` ternary: :func:`apply_int8_` of u)."""
    ops.momentum_sign_pack(vote, u, beta, m_out=u, pack=False)
    apply_int8_(p, u, eta, weight_decay)


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int,
                        plan: Optional[vp.VotePlan] = None,
                        byz: Optional[ByzantineConfig] = None) -> Optimizer:
    """SIGNUM / signSGD over `n_voters` stacked voters (see module doc),
    leaf-wise or, given `plan`, through its bucket schedule, with the
    voters below ``byz.num_adversaries`` adversarial when `byz` is given.

    State, as the reference's trainer lays it out (``abstract_state``):
    ``{"count": int}``, and ``"momentum"`` in ``momentum_dtype`` when beta
    > 0: per voter ``{name: (M, *leaf_shape)}`` under Mode A (at M = 1 the
    reference's own per-worker layout ``(1, ...)``), leaf-shaped under
    Mode B. Beside it ``"error"`` (one row per voter, in
    ``momentum_dtype``; under a plan for its ``ef_sign`` leaves only) for
    ``ef_sign``, ``"codec": {"flip_ema": (M,) float32}`` for
    ``weighted_vote`` and ``"delayed"`` (leaf-shaped int8) for
    ``delayed_vote``. (At beta = 0 the reference's ``abstract_state``
    gives the residual the parameter's shape, each device holding its own
    voter's; stacked on one device the port keeps the M of them as
    ``(M, *leaf_shape)``.) The codec's arithmetic is its own trainer hooks
    (``core/codecs/base.py``)."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    # AUTO resolves once, for M voters, as the reference's train step
    # resolves it (psum_int8 at M = 1; M > 1 needs an H100 link model)
    cfg = dataclasses.replace(cfg, vote_strategy=resolve_strategy(
        cfg.vote_strategy, 0, n_voters, codec=cfg.resolved_codec))
    validate(cfg)
    beta = cfg.momentum
    mode_b = cfg.momentum_mode == MomentumMode.GLOBAL
    rows = per_worker(cfg)
    codec = codecs.get_codec(cfg.resolved_codec)
    two_bit = codec.two_bit(cfg.vote_strategy)
    ties = codec.ties(cfg.vote_strategy)
    mom_dtype = MOMENTUM_DTYPES[cfg.momentum_dtype]
    slots = {s.name: s for s in plan.leaves} if plan is not None else {}
    leaf_codec = ({k: codecs.get_codec(c)
                   for k, c in plan.leaf_codecs().items()}
                  if plan is not None else {})
    ef_leaves = plan.worker_state_leaves if plan is not None else None
    ef = bool(ef_leaves) if plan is not None else codec.worker_state
    has_server_state = (plan.has_server_state if plan is not None
                        else codec.server_state)
    if ef and mode_b:
        # the reference's refusal, word for word (core/signum.py:106-116)
        raise ValueError(
            f"codec {codec.name if plan is None else ef_leaves!r} carries "
            "a per-worker EF residual and requires "
            "momentum_mode=per_worker (Mode A); Mode B has no "
            "worker-side encode input (DESIGN.md §3/§8)")

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros(names=None, voters=True):
            lead = (n_voters,) if voters else ()
            return {k: torch.zeros(lead + tuple(p.shape), dtype=mom_dtype,
                                   device=p.device)
                    for k, p in params.items()
                    if names is None or k in names}
        device = next(iter(params.values())).device
        state = {"count": 0}
        if beta > 0:
            state["momentum"] = zeros(voters=rows)
        if cfg.delayed_vote:
            state["delayed"] = {k: torch.zeros(p.shape, dtype=torch.int8,
                                               device=p.device)
                                for k, p in params.items()}
        if ef:
            state["error"] = zeros(ef_leaves)
        if has_server_state:
            state["codec"] = (plan.init_server_state(n_voters, device)
                              if plan is not None else
                              codec.init_server_state(n_voters, device))
        return state

    if byz is not None and byz.mode != "none" and byz.num_adversaries:
        byzantine.check_mode(byz.mode)     # an unknown mode raises
    else:
        byz = None

    def wire(params: Dict[str, torch.Tensor], step: int = 0) -> Dict:
        """One step's buffers: each leaf's (M, w) words (under a plan, the
        (M, n_params) int8 signs), what each voter's encode hands the
        codec's feedback (``ef_sign``'s mean|t|) and the step (the
        adversary's draws are keyed by it)."""
        sent = {k: [None] * n_voters for k in params}
        if plan is not None:
            device = next(iter(params.values())).device
            return {"signs": torch.empty((n_voters, plan.n_params),
                                         dtype=torch.int8, device=device),
                    "sent": sent, "step": step}
        return {"words": packed_like(params, n_voters, codec, two_bit),
                "sent": sent, "step": step}

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               wire: Dict) -> None:
        """Voter `voter`'s worker side: under per-worker momentum m_r <-
        beta*m_r + (1-beta)*g_r in place; the codec's symbols of its vote
        input (m', or g itself) into row `voter` of each leaf's words
        (under a plan, the signs into its row of the flat buffer; the
        adversary acts on them in ``update``)."""
        adversary = None
        if byz is not None and plan is None \
                and voter < byz.num_adversaries:
            def adversary(symbols: torch.Tensor) -> None:
                byzantine.evil_signs_(symbols, byz, [voter],
                                      step=wire["step"])
        for k, g in grads.items():
            g = g.reshape(-1)
            m = state["momentum"][k][voter].view(-1) if rows else None
            error = (state["error"][k][voter].view(-1)
                     if k in state.get("error", {}) else None)
            if plan is None:
                wire["sent"][k][voter] = codec.encode_voter_(
                    g, m, beta, wire["words"][k][voter], error, two_bit,
                    adversary)
                continue
            if m is None:
                x = leaf_codec[k].raw_input_(g, error)
            else:
                ops.momentum_sign_pack(g, m, beta, m_out=m, pack=False)
                x = leaf_codec[k].vote_input_(m, error)
            vp.write_signs(slots[k], x, wire["signs"][voter])
            wire["sent"][k][voter] = leaf_codec[k].sent_(x)

    def apply_(k: str, p: torch.Tensor, state: Dict, vote: torch.Tensor,
               eta: float, wd: float) -> None:
        """Flat p moved by the flat vote (int8, or bf16 ±1/0) of this step:
        through the momentum under Mode B (beta > 0; the vote as bf16),
        banked under ``delayed_vote``, else applied."""
        if mode_b and beta > 0:
            apply_momentum_vote_(state["momentum"][k].view(-1),
                                 vote.to(torch.bfloat16), p, beta, eta, wd)
        elif cfg.delayed_vote:
            apply_delayed_(state["delayed"][k], p, vote, eta, wd)
        else:
            apply_int8_(p, vote, eta, wd)

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> None:
        """Server side: each leaf's vote of its (M, w) words (under a plan,
        the bucket walk over the flat signs), then x <- x - eta*(vote +
        weight_decay*x) in place (under Mode B the sign of the momentum
        that took the vote; under ``delayed_vote`` the banked vote), then
        the codec's feedback."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        if plan is not None:
            if byz is not None:
                byzantine.apply_adversary_stacked(wire["signs"], byz,
                                                  step=step)
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
                apply_(k, p.view(-1), state, vote, eta, wd)
            state["count"] += 1
            return
        ctx = codec.begin_step(state.get("codec"))
        for k, p in params.items():
            flat = p.view(-1)
            n = flat.shape[0]
            votes = codec.vote_(wire["words"][k], n, ctx, two_bit, ties)
            if mode_b and beta > 0 or cfg.delayed_vote:
                # the vote decoded: bf16 for the momentum, int8 to bank
                dt = torch.bfloat16 if mode_b else torch.int8
                vote = (ops.ternary_unpack(votes, n, dt) if two_bit
                        else ops.bitunpack(votes, n, dt))
                apply_(k, flat, state, vote, eta, wd)
                del vote
            else:
                codec.apply_(flat, votes, eta, wd, two_bit)
            error = (state["error"][k].view(n_voters, -1)
                     if "error" in state else None)
            codec.feedback_voters_(votes, error, wire["sent"][k], two_bit)
        codec.end_step(state.get("codec"), ctx)
        state["count"] += 1

    return Optimizer(init, wire, encode, update, cfg.vote_strategy, plan)


# ---------------------------------------------------------------------------
# dense baselines (the paper's comparison arm)
# ---------------------------------------------------------------------------


def bias_correction(beta: float, count: int) -> float:
    """Adam's ``1 - beta ** t`` at t = `count`, in float32 as the
    reference computes it (``t`` a float32 array, ``beta`` a weakly typed
    Python float)."""
    f32 = np.float32
    return float(f32(1.0) - f32(beta) ** f32(count))


def sqrt_rn_(x: torch.Tensor) -> torch.Tensor:
    """x <- sqrt(x) in place, each root the float32 nearest to it, as XLA's
    is. PyTorch's vectorized float32 sqrt on the CPU (SLEEF's, within
    0.5000001 ulp) misses the nearest value on about 0.7 % of inputs; there
    the float64 root is rounded instead, which is exact (float64 carries
    more than twice float32's bits). CUDA's sqrtf rounds to nearest."""
    if x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()


def make_dense_optimizer(cfg: OptimizerConfig, n_voters: int) -> Optimizer:
    """Distributed SGD / SGDM / Adam (``repro.core.signum``'s
    ``make_dense_optimizer``) over `n_voters` stacked voters.

    Each voter's encode adds its gradient into one leaf-sized sum, in the
    gradient's own dtype as the reference's ``psum`` sums it (bf16 without
    microbatches, float32 with them: the train step's accumulator; the
    first voter's gradient is the sum's buffer). ``update`` divides by M in
    that dtype (``tree_mean``: ``psum(g) / n``), casts to float32 and runs
    the reference's update in float32 PyTorch ops, each product and sum
    rounded on its own and Adam's root rounded to nearest
    (:func:`sqrt_rn_`): the arithmetic of the reference's eager update,
    bit for bit. (Its jitted trainer may contract a product and a sum into
    an FMA, and reads float32 subnormals as zeros; neither is reproduced
    here.) State:
    ``{"count": int, "m": {name: float32 leaf-shaped}}`` for ``sgdm`` and
    ``adam``, with ``"v"`` beside it for ``adam``. The reference has no
    Pallas kernel here, and nor does the port."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    kind = cfg.kind
    if kind not in DENSE_KINDS:
        raise ValueError(kind)
    strategy = resolve_strategy(cfg.vote_strategy, 0, n_voters,
                                codec=cfg.resolved_codec)

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        state = {"count": 0}
        if kind in ("sgdm", "adam"):
            state["m"] = zeros()
        if kind == "adam":
            state["v"] = zeros()
        return state

    def wire(params: Dict[str, torch.Tensor], step: int = 0) -> Dict:
        return {"sum": {}}

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               wire: Dict) -> None:
        """Voter `voter`'s gradient added into the sum, in its dtype."""
        majority_vote.add_voter_(wire["sum"], grads)

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> None:
        """x <- x - eta*(upd + weight_decay*x) in float32, cast back, with
        upd the mean gradient (``sgd``), the momentum ``beta*m + g``
        (``sgdm``) or Adam's bias-corrected ratio."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        count = state["count"] + 1
        b1, b2 = cfg.momentum, cfg.beta2
        mean = majority_vote.tree_mean_(wire["sum"], n_voters)
        for k, p in params.items():
            g = mean.pop(k).to(torch.float32)
            if kind == "sgd":
                upd = g
            elif kind == "sgdm":
                upd = state["m"][k].mul_(b1).add_(g)
            else:
                m, v = state["m"][k], state["v"][k]
                m.mul_(b1).add_(g.mul(1 - b1))
                v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
                upd = None
            del g
            p32 = p.to(torch.float32)
            if upd is None:
                den = sqrt_rn_(v.div(bias_correction(b2, count))).add_(
                    cfg.eps)
                upd = m.div(bias_correction(b1, count)).div_(den)
                del den
            p32.sub_(p32.mul(wd).add_(upd).mul_(eta))
            p.copy_(p32)
            del p32, upd
        state["count"] = count

    return Optimizer(init, wire, encode, update, strategy)


def build_optimizer(cfg: OptimizerConfig, n_voters: int,
                    plan: Optional[vp.VotePlan] = None,
                    byz: Optional[ByzantineConfig] = None) -> Optimizer:
    """The optimizer of `cfg.kind` (``repro.core.signum.build_optimizer``):
    the sign family for ``signum_vote`` / ``signsgd_vote``, with the
    adversaries of `byz`, else the dense baselines, which ignore `byz` as
    the reference's do."""
    if cfg.kind in SIGN_KINDS:
        return make_sign_optimizer(cfg, n_voters, plan, byz)
    return make_dense_optimizer(cfg, n_voters)
