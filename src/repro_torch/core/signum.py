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

Over the vote ``axes`` of a ``distributed.mesh.ProcessMesh`` (``axes=``,
one voter per rank) the same optimizer runs with one local row: the
momentum and the residual are this voter's, leaf-shaped with no voter
dim; ``encode`` takes the rank's replica index (the adversary keys it),
and ``update`` swaps the virtualised exchange for the collectives: the
1-bit and 2-bit words are all-gathered (the strategies' ``exchange``: pod
first, data-major) and tallied as the stacked words are; on ``psum_int8``
and ``hierarchical`` the voter's 2-bit symbols are unpacked
(``ternary_unpack``) and voted by the strategy's collectives (an int8
all-reduce; the count reduce-scatter, the sum over pod and the packed
all-gather), the decision repacked by ``ternary_pack`` for the same
ternary apply. (That round trip stays: the words are what the stacked
step's encode kernel writes and what its apply and feedback read, so the
mesh step shares every one of them; int8 symbols instead would be written
by PyTorch's ``sign_ternary``, two float passes where ``ternary_pack``
makes one, and an int8 vote is packed again for ``apply_ternary_vote``
all the same, as ``apply_int8_`` does. The unpack reads n/4 bytes and
writes n, a small cost beside the collectives' n bytes through gloo.)
The plan walk runs ``vote_plan.MeshBucketWire``. The votes,
and so the parameters, are the stacked step's bit for bit; a
``weighted_vote`` state's rows are in the gathered order (data-major),
which is the voter order on a mesh without a pod axis. The dense baselines
mean with ``majority_vote.tree_mean``, an all-reduce.

Under ``TrainConfig.fsdp`` (M > 1) the leaves of ``fused_leaves`` arrive
voted: the fused ZeRO backward (``core.majority_vote``) voted each
microbatch inside its reduce-scatter, and the train step hands ``update``
their accumulated votes in ``wire["voted"]`` (over a mesh, this rank's
slices). As in the reference (``voted_leaves``), Mode B skips the wire for
them: no encode, no tally; their momentum takes the voted gradient through
the same momentum kernel (u without words), then ``ternary_pack`` of u and
``apply_ternary_vote``. At beta = 0 the voted gradient, with several
microbatches the mean of their votes and not ternary, is applied itself by
the reference's float32 apply in PyTorch ops (:func:`apply_float_`). The
dense baselines take such leaves' gradient as the mean (``mean_leaves``).
With every leaf fused the diagnostics are NaN, as the reference's.
Mode A (beta = 0; with momentum the reference refuses fsdp) takes the
fused leaves' accumulated votes as gradients and votes them a second time
on the wire, as the reference does: over a mesh each rank's slice (its
coordinates) against the other ranks' slices; stacked, voter r sends its
slice r (``tiles``: the leaf's words, residual and banked vote have the
shape of one slice, and every slice of the parameter takes the vote).

Over a mesh with a ``"model"`` axis (`shares`: each leaf's
``codecs.base.LeafShare``, the train step's tensor parallelism) every
leaf is the rank's shard and each model rank votes its shards over the
vote axes at its model index: the momentum, the signs, the tally and the
apply are elementwise, so a shard's vote is the global leaf's vote at its
coordinates. What the reference computes over a whole leaf is summed over
the model group, a replicated leaf counted once: ef_sign's mean|t|,
weighted_vote's mismatch counts and coordinates, the diagnostics'
agreement, margin and coordinate count, and AUTO's size. A stochastic
adversary draws at each shard's global coordinates (the leaf's counter
map, ``LeafShare.counter_map``), under the key of the voter, so the model
ranks of one voter send what it would send for the whole leaf. A VotePlan
is built on the global leaves, as the reference's, and each rank walks its
part of it (``vote_plan.shard_plan``): its blocks in manifest order, every
global bucket's one contiguous window of them (an empty one sends
nothing), the adversary over each leaf's segment at its global flat
counters (the manifest offset plus the map), and the statistics summed
over the model group as leaf-wise, the window's replicated coordinates
counted on model index 0 only.

``diagnostics=True`` makes ``update`` return the reference's
``vote_margin`` (mean |tally| / M over every coordinate, on the signs that
reached the wire) and ``vote_agreement`` (the fraction of coordinates
where voter 0's sign is the vote: the value the reference's mesh step
returns, its metrics' out spec being replicated), computed as
``core.vote_api``'s tree and plan forms compute them; otherwise ``{}``.

Every other option raises and names the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (ByzantineConfig, MomentumMode,
                                      OptimizerConfig, VoteStrategy)
from repro_torch.core import byzantine, codecs, majority_vote
from repro_torch.core import sign_compress as sc
from repro_torch.core import vote_api as va
from repro_torch.core import vote_plan as vp
from repro_torch.core.codecs.base import LeafShare
from repro_torch.core.vote_engine import (STRATEGIES, count_dtype,
                                          num_voters, resolve_strategy)
from repro_torch.distributed import mesh as pm
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params) -> state
    wire: Callable     # (params) -> one step's wire buffers
    encode: Callable   # (voter, grads, state, wire) -> None, in place
    update: Callable   # (wire, state, params, step) -> diagnostics dict
    strategy: VoteStrategy   # the resolved vote strategy, never AUTO
    plan: Optional[vp.VotePlan] = None
    #: over a model axis, this rank's part of `plan` (``vp.shard_plan``)
    shard: Optional[vp.ShardPlan] = None


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
                codec: codecs.GradientCodec, two_bit: bool,
                sizes: Optional[Dict[str, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """One (M, w) int32 word buffer per leaf, row r voter r's packed
    symbols of its n coordinates (``p.numel()``, or ``sizes[k]``): 1-bit
    words (w = ceil(n/32)), or 2-bit words (w = ceil(n/16)) on the 2-bit
    wires."""
    sizes = sizes or {}
    return {k: torch.empty((n_voters, codec.words_for(
                sizes.get(k, p.numel()), two_bit)),
                           dtype=sc.WORD_DTYPE, device=p.device)
            for k, p in params.items()}


def slice_rows(p: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """A (parts, n/parts) copy of `p`'s `parts` equal slices along `dim`,
    row d slice d flattened as that slice copied on its own would be."""
    lead = int(np.prod(p.shape[:dim], dtype=np.int64))
    out = torch.empty((parts, p.numel() // parts), dtype=p.dtype,
                      device=p.device)
    out.view(parts, lead, -1).copy_(p.view(lead, parts, -1).transpose(0, 1))
    return out


def join_rows_(p: torch.Tensor, rows: torch.Tensor, dim: int,
               parts: int) -> None:
    """Write :func:`slice_rows`' `rows` back into `p`, in place."""
    lead = int(np.prod(p.shape[:dim], dtype=np.int64))
    p.view(lead, parts, -1).copy_(rows.view(parts, lead, -1).transpose(0, 1))


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


def apply_float_(p: torch.Tensor, vote: torch.Tensor, eta: float,
                 weight_decay: float) -> None:
    """Flat p <- p - eta*(vote + weight_decay*p) in place for a float vote
    that need not be ternary (the mean of several microbatches' fused
    votes), in float32 PyTorch ops rounded one by one as the reference's
    jnp apply, then cast back."""
    p32 = p.to(torch.float32)
    p32.sub_(p32.mul(weight_decay).add_(vote.to(torch.float32)).mul_(eta))
    p.copy_(p32)


def _mesh_vote(words: torch.Tensor, n: int, ctx, codec, two_bit: bool,
               ties: str, strategy: VoteStrategy, axes, counted: bool = True
               ) -> torch.Tensor:
    """This rank's (1, w) words of an n-coordinate leaf -> the packed vote
    over the mesh `axes`, in the format the stacked tally gives (1-bit
    words, or 2-bit words on a 2-bit wire)."""
    if not two_bit or strategy == VoteStrategy.ALLGATHER_1BIT:
        gathered = STRATEGIES[VoteStrategy.ALLGATHER_1BIT].exchange(words,
                                                                   axes)
        return codec.vote_(gathered, n, ctx, two_bit, ties, counted)
    symbols = ops.ternary_unpack(words[0], n, torch.int8)
    if strategy == VoteStrategy.PSUM_INT8:
        counts = STRATEGIES[strategy].exchange(
            symbols.to(count_dtype(num_voters(axes))), axes)
        vote = torch.sign(counts).to(torch.int8)
    else:
        vote = STRATEGIES[strategy].vote(symbols, axes)
    return ops.ternary_pack(vote.view(1, -1))[0]


def _concrete_strategy(cfg: OptimizerConfig, n_voters: int) -> VoteStrategy:
    """`cfg`'s wire. One voter has no wire (AUTO gives ``psum_int8``); AUTO
    over M > 1 voters is priced on the voted leaves' size, which
    :func:`build_optimizer` resolves it on at the first call
    (:class:`_AutoOptimizer`)."""
    if cfg.vote_strategy == VoteStrategy.AUTO and n_voters > 1:
        raise ValueError(
            f"vote_strategy=auto over {n_voters} voters is resolved on the "
            "voted leaves' size: build the optimizer with build_optimizer")
    return resolve_strategy(cfg.vote_strategy, 0, n_voters,
                            codec=cfg.resolved_codec)


class _AutoOptimizer:
    """An optimizer built with ``vote_strategy=auto`` over M > 1 voters:
    AUTO resolves at its first call (``init``, ``wire`` or ``update``) on
    the total size of the leaves it votes (Mode B's fused leaves, voted in
    the backward, left out), over the vote mesh's data and pod sizes (M
    stacked voters: a data axis of M), as the reference's ``_tree_execute``
    resolves it at each vote (``src/repro/core/vote_api.py:779-782``); the
    optimizer `build` makes for the resolved wire then does the work.
    ``strategy`` reads AUTO until then."""

    def __init__(self, cfg: OptimizerConfig, n_voters: int, axes,
                 fused_leaves: Sequence[str],
                 build: Callable[[OptimizerConfig], Optimizer],
                 shares: Optional[Dict[str, LeafShare]] = None):
        self._cfg, self._build = cfg, build
        self._fused = frozenset(fused_leaves)
        self._shares = shares or {}
        self._sizes = ((n_voters, 1) if axes is None else
                       (pm.axis_size(axes, "data") if "data" in axes else 1,
                        pm.axis_size(axes, "pod") if "pod" in axes else 1))
        self._opt: Optional[Optimizer] = None
        self.strategy = VoteStrategy.AUTO

    def _resolved(self, params: Dict[str, torch.Tensor]) -> Optimizer:
        if self._opt is None:
            # the global leaves' size: a model-sharded leaf's shards
            total = sum(p.numel() * (self._shares[k].parts
                                     if k in self._shares else 1)
                        for k, p in params.items() if k not in self._fused)
            strategy = resolve_strategy(VoteStrategy.AUTO, total,
                                        *self._sizes,
                                        codec=self._cfg.resolved_codec)
            self._opt = self._build(dataclasses.replace(
                self._cfg, vote_strategy=strategy))
            self.strategy = self._opt.strategy
        return self._opt

    @property
    def plan(self) -> Optional[vp.VotePlan]:
        return None if self._opt is None else self._opt.plan

    @property
    def shard(self) -> Optional[vp.ShardPlan]:
        return None if self._opt is None else self._opt.shard

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return self._resolved(params).init(params)

    def wire(self, params: Dict[str, torch.Tensor], step: int = 0) -> Dict:
        return self._resolved(params).wire(params, step)

    def encode(self, voter: int, grads: Dict[str, torch.Tensor],
               state: Dict, wire: Dict) -> None:
        self._opt.encode(voter, grads, state, wire)

    def update(self, wire: Dict, state: Dict,
               params: Dict[str, torch.Tensor], step: int
               ) -> Dict[str, float]:
        return self._resolved(params).update(wire, state, params, step)


def make_sign_optimizer(cfg: OptimizerConfig, n_voters: int,
                        plan: Optional[vp.VotePlan] = None,
                        byz: Optional[ByzantineConfig] = None,
                        diagnostics: bool = False,
                        axes=None,
                        fused_leaves: Sequence[str] = (),
                        tiles: Optional[Dict[str, Tuple[int, int]]] = None,
                        shares: Optional[Dict[str, LeafShare]] = None
                        ) -> Optimizer:
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
    (``core/codecs/base.py``). Over mesh `axes` (bound vote axes of M =
    `n_voters` voters) the momentum and residual are this rank's voter's,
    leaf-shaped (see the module doc). The leaves of `fused_leaves` come
    voted (``wire["voted"]``; Mode B only, the reference's
    ``voted_leaves``). A leaf of `tiles` ({leaf: (dim, parts)}; Mode A at
    beta = 0, stacked) is voted at the shape of one of its `parts` slices
    along `dim`, which every voter's gradient of it has, and every slice
    of the parameter takes that vote. `shares` ({leaf: its LeafShare})
    places the leaves over a mesh's model axis (see the module doc)."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    shares = dict(shares or {})
    model_sum = next(iter(shares.values())).total if shares else None
    # over a model axis the plan (built on the global leaves) is walked on
    # this rank's windows of it
    shard = vp.shard_plan(plan, shares) if plan is not None and shares \
        else None
    walk = shard.plan if shard is not None else plan

    def counted(k: str) -> bool:
        return k not in shares or shares[k].counted
    if axes is not None and num_voters(axes) != n_voters:
        raise ValueError(f"{n_voters} voters over vote axes of "
                         f"{num_voters(axes)}")
    # rows of per-voter state this process holds: every voter's stacked,
    # one voter's over a mesh
    local = n_voters if axes is None else 1
    cfg = dataclasses.replace(cfg, vote_strategy=_concrete_strategy(
        cfg, n_voters))
    validate(cfg)
    beta = cfg.momentum
    mode_b = cfg.momentum_mode == MomentumMode.GLOBAL
    rows = per_worker(cfg)
    codec = codecs.get_codec(cfg.resolved_codec)
    two_bit = codec.two_bit(cfg.vote_strategy)
    ties = codec.ties(cfg.vote_strategy)
    mom_dtype = MOMENTUM_DTYPES[cfg.momentum_dtype]
    slots = {s.name: s for s in walk.leaves} if plan is not None else {}
    leaf_codec = ({k: codecs.get_codec(c)
                   for k, c in plan.leaf_codecs().items()}
                  if plan is not None else {})
    ef_leaves = plan.worker_state_leaves if plan is not None else None
    ef = bool(ef_leaves) if plan is not None else codec.worker_state
    has_server_state = (plan.has_server_state if plan is not None
                        else codec.server_state)
    fused = frozenset(fused_leaves)
    if fused and not mode_b:
        raise ValueError("fused (pre-voted) leaves belong to Mode B "
                         "(momentum_mode=global)")
    tiles = dict(tiles or {})
    if tiles and (mode_b or rows):
        raise ValueError("tiled leaves belong to Mode A at beta = 0")

    def shape_of(k: str, p: torch.Tensor) -> tuple:
        """The shape of leaf k's vote: one slice of a tiled leaf."""
        shape = list(p.shape)
        if k in tiles:
            dim, parts = tiles[k]
            shape[dim] //= parts
        return tuple(shape)
    if ef and mode_b:
        # the reference's refusal, word for word (core/signum.py:106-116)
        raise ValueError(
            f"codec {codec.name if plan is None else ef_leaves!r} carries "
            "a per-worker EF residual and requires "
            "momentum_mode=per_worker (Mode A); Mode B has no "
            "worker-side encode input (DESIGN.md §3/§8)")

    def init(params: Dict[str, torch.Tensor]) -> Dict:
        def zeros(names=None, voters=True):
            lead = (n_voters,) if voters and axes is None else ()
            return {k: torch.zeros(lead + shape_of(k, p), dtype=mom_dtype,
                                   device=p.device)
                    for k, p in params.items()
                    if names is None or k in names}
        device = next(iter(params.values())).device
        state = {"count": 0}
        if beta > 0:
            state["momentum"] = zeros(voters=rows)
        if cfg.delayed_vote:
            state["delayed"] = {k: torch.zeros(shape_of(k, p),
                                               dtype=torch.int8,
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

    me = None if axes is None else pm.replica_index(axes)

    def wire(params: Dict[str, torch.Tensor], step: int = 0) -> Dict:
        """One step's buffers: each leaf's (M, w) words (under a plan, the
        (M, n_params) int8 signs; over a mesh one row of each), what each
        voter's encode hands the codec's feedback (``ef_sign``'s mean|t|)
        and the step (the adversary's draws are keyed by it); with
        diagnostics, each leaf's tally of the wire signs and voter 0's own
        signs (over a mesh, this rank's)."""
        params = {k: p for k, p in params.items() if k not in fused}
        out = {"sent": {k: [None] * local for k in params}, "step": step}
        if diagnostics and plan is None:
            out["counts"], out["own"] = {}, {}
        if plan is not None:
            device = next(iter(params.values())).device
            out["signs"] = torch.empty((local, walk.n_params),
                                       dtype=torch.int8, device=device)
        else:
            out["words"] = packed_like(params, local, codec, two_bit, {
                k: int(np.prod(shape_of(k, params[k]))) for k in tiles})
        return out

    def row_of(voter: int) -> int:
        if axes is not None and voter != me:
            raise ValueError(f"this rank holds voter {me}, not {voter}")
        return voter if axes is None else 0

    def local_row(t: torch.Tensor, row: int) -> torch.Tensor:
        return (t[row] if axes is None else t).view(-1)

    def encode(voter: int, grads: Dict[str, torch.Tensor], state: Dict,
               wire: Dict) -> None:
        """Voter `voter`'s worker side: under per-worker momentum m_r <-
        beta*m_r + (1-beta)*g_r in place; the codec's symbols of its vote
        input (m', or g itself) into row `voter` of each leaf's words
        (under a plan, the signs into its row of the flat buffer; the
        adversary acts on them in ``update``). Over a mesh `voter` is
        this rank's replica index and its row the only one."""
        row = row_of(voter)
        evil = {}
        evil_voter = (byz is not None and plan is None
                      and voter < byz.num_adversaries)

        def adversary_of(k: str, shape) -> Optional[Callable]:
            """Voter `voter`'s transform of leaf k's symbols: its draws at
            the leaf's own counters, or a model shard's global ones."""
            if not evil_voter:
                return None
            cut = shares[k].counter_map(shape) if k in shares else {}

            def adversary(symbols: torch.Tensor) -> None:
                byzantine.evil_signs_(symbols, byz, [voter],
                                      step=wire["step"], **cut)
                if diagnostics:
                    evil["signs"] = symbols.view(-1).clone()
            return adversary
        # under a plan in its manifest's order (a leaf of the wrong shape
        # raises at the first such leaf of it, as the reference's flatten)
        names = ([sl.name for sl in walk.leaves if sl.name in grads]
                 if plan is not None else list(grads))
        for k in names:
            g = grads[k]
            if k in fused:
                continue
            if plan is not None:
                vp.check_size(slots[k], g)
            adversary = adversary_of(k, g.shape)
            g = g.reshape(-1)
            m = local_row(state["momentum"][k], row) if rows else None
            error = (local_row(state["error"][k], row)
                     if k in state.get("error", {}) else None)
            if plan is None:
                wire["sent"][k][row] = codec.encode_voter_(
                    g, m, beta, wire["words"][k][row], error, two_bit,
                    adversary, shares.get(k))
                if diagnostics:
                    diag_encode(k, g, m, error, voter, wire, evil)
                continue
            if m is None:
                x = leaf_codec[k].raw_input_(g, error)
            else:
                ops.momentum_sign_pack(g, m, beta, m_out=m, pack=False)
                x = leaf_codec[k].vote_input_(m, error)
            vp.write_signs(slots[k], x, wire["signs"][row])
            wire["sent"][k][row] = leaf_codec[k].sent_(x, shares.get(k))

    def diag_encode(k: str, g: torch.Tensor, m: Optional[torch.Tensor],
                    error: Optional[torch.Tensor], voter: int, wire: Dict,
                    evil: Dict) -> None:
        """One voter's share of a leaf's diagnostics: its wire signs into
        the leaf's tally and, for voter 0 (over a mesh, this rank), its
        own signs. The vote input is the residual row t (``ef_sign``), m'
        or g."""
        x = error if error is not None else (m if m is not None else g)
        own = sc.sign_ternary(x)
        sent = evil.pop("signs", own)
        counts = wire["counts"]
        if k not in counts:
            # a copy: `own` is kept, and int8 counts would alias it
            counts[k] = sent.to(count_dtype(n_voters), copy=True)
        else:
            counts[k].add_(sent)
        if voter == 0 or axes is not None:
            wire["own"][k] = own

    def diag_result(agree: int, num: int, n: int,
                    device: torch.device) -> Dict[str, float]:
        """The two metrics (``vote_api.vote_diagnostics``) from this
        process's agreement count (voter 0's, stacked), the summed |tally|
        and the coordinates; over a mesh voter 0's count is broadcast so
        that every rank reports it, and over a model axis the three are
        first summed over the model group (the global leaves')."""
        if model_sum is not None:
            agree, num, n = model_sum(torch.tensor(
                [agree, num, n], dtype=torch.int64, device=device)).tolist()
        if not n:
            # every leaf took the fused vote: the wire is not observable,
            # but the keys are a contract (the reference reports NaN)
            return {"vote_agreement": float("nan"),
                    "vote_margin": float("nan")}
        margin, agreement = va.vote_diagnostics(
            agree, [num], n, n_voters, axes or (),
            reporter=None if axes is None else 0, device=device)
        return {"vote_agreement": agreement, "vote_margin": margin}

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

    def apply_voted_(k: str, p: torch.Tensor, state: Dict, wire: Dict,
                     eta: float, wd: float) -> None:
        """Flat p moved by its fused (pre-voted) gradient: through the
        momentum (beta > 0), else applied itself."""
        vote = wire["voted"][k].reshape(-1)
        if beta > 0:
            apply_momentum_vote_(state["momentum"][k].view(-1),
                                 vote.to(torch.bfloat16), p, beta, eta, wd)
        else:
            apply_float_(p, vote, eta, wd)

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> Dict[str, float]:
        """Server side: each leaf's vote of its (M, w) words (under a plan,
        the bucket walk over the flat signs; over a mesh, of the gathered
        or reduced words), then x <- x - eta*(vote + weight_decay*x) in
        place (under Mode B the sign of the momentum that took the vote;
        under ``delayed_vote`` the banked vote), then the codec's feedback.
        Returns the diagnostics (``{}`` without them)."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        device = next(iter(params.values())).device
        diag = {}
        if plan is not None:
            signs = wire["signs"] if axes is None else wire["signs"][0]
            own = signs[0] if axes is None else signs
            if diagnostics and byz is not None and (
                    0 if axes is None else me) < byz.num_adversaries:
                own = own.clone()   # voter 0's honest signs
            if byz is not None and axes is None:
                byzantine.apply_adversary_stacked(signs, byz, step=step)
            elif byz is not None and (
                    shard is None
                    or byz.mode not in byzantine.STOCHASTIC_MODES):
                byzantine.apply_adversary(signs, byz, axes, step=step)
            elif byz is not None:
                # each segment draws at its global flat counters
                for seg in shard.segments:
                    byzantine.apply_adversary(
                        signs[seg.lo:seg.hi], byz, axes, step=step,
                        offset=seg.offset, block=seg.block, gap=seg.gap)
            bucket_wire = (vp.VirtualBucketWire(n_voters) if axes is None
                           else vp.MeshBucketWire(axes))
            votes, new_cstate = vp.run_schedule(
                walk, signs, bucket_wire, state.get("codec"),
                overlap=cfg.overlap, reduce=model_sum)
            if diagnostics:
                tally = (torch.sum(signs, 0, dtype=count_dtype(n_voters))
                         if axes is None else va.psum_counts(signs, axes))
                ranges = (shard.counted if shard is not None
                          else ((0, walk.n_params),))
                diag = diag_result(
                    sum(va.count_equal(own[a:b], votes[a:b])
                        for a, b in ranges),
                    sum(va.abs_sum(tally[a:b]) for a, b in ranges),
                    sum(b - a for a, b in ranges), device)
                del tally, own
            for key, v in state.get("codec", {}).items():
                v.copy_(new_cstate[key])
            for k, p in params.items():
                if k in fused:
                    apply_voted_(k, p.view(-1), state, wire, eta, wd)
                    continue
                slot = slots[k]
                vote = votes[slot.offset:slot.offset + slot.length]
                if k in state.get("error", {}):
                    error = state["error"][k].view(local, -1)
                    leaf_codec[k].feedback_decoded_(
                        vote.to(error.dtype), error, wire["sent"][k])
                apply_(k, p.view(-1), state, vote, eta, wd)
            state["count"] += 1
            return diag
        ctx = codec.begin_step(state.get("codec"))
        agree = num = total = 0
        for k, p in params.items():
            # the flat leaf, or a tiled leaf's slices, each taking the vote
            slices = (slice_rows(p, *tiles[k]) if k in tiles
                      else p.view(1, -1))
            flat = slices[-1]
            n = flat.shape[0]
            if k in fused:
                apply_voted_(k, flat, state, wire, eta, wd)
                continue
            if axes is None:
                votes = codec.vote_(wire["words"][k], n, ctx, two_bit, ties)
            else:
                votes = _mesh_vote(wire["words"][k], n, ctx, codec, two_bit,
                                   ties, cfg.vote_strategy, axes,
                                   counted(k))
            if diagnostics and not counted(k):
                del wire["own"][k], wire["counts"][k]
            elif diagnostics:
                decoded = (ops.ternary_unpack(votes, n, torch.int8) if two_bit
                           else ops.bitunpack(votes, n, torch.int8))
                agree += va.count_equal(wire["own"].pop(k), decoded)
                tally = wire["counts"].pop(k)
                if axes is not None:
                    tally = va.psum_counts(tally, axes)
                num += va.abs_sum(tally)
                total += n
                del decoded, tally
            if mode_b and beta > 0 or cfg.delayed_vote:
                # the vote decoded: bf16 for the momentum, int8 to bank
                dt = torch.bfloat16 if mode_b else torch.int8
                vote = (ops.ternary_unpack(votes, n, dt) if two_bit
                        else ops.bitunpack(votes, n, dt))
                for other in slices[:-1]:   # the last slice banks the vote
                    apply_int8_(other, state["delayed"][k].view(-1), eta, wd)
                apply_(k, flat, state, vote, eta, wd)
                del vote
            else:
                for one in slices:
                    codec.apply_(one, votes, eta, wd, two_bit)
            if k in tiles:
                join_rows_(p, slices, *tiles[k])
            error = (state["error"][k].view(local, -1)
                     if "error" in state else None)
            codec.feedback_voters_(votes, error, wire["sent"][k], two_bit)
        if model_sum is not None:
            codec.reduce_step_(ctx, model_sum)
        codec.end_step(state.get("codec"), ctx)
        state["count"] += 1
        return diag_result(agree, num, total, device) if diagnostics else {}

    return Optimizer(init, wire, encode, update, cfg.vote_strategy, plan,
                     shard)


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


def make_dense_optimizer(cfg: OptimizerConfig, n_voters: int,
                         axes=None, mean_leaves: Sequence[str] = ()
                         ) -> Optimizer:
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
    bit for bit. Over mesh `axes` the mean is an all-reduce of this rank's
    gradient (``majority_vote.tree_mean``). (Its jitted trainer may
    contract a product and a sum into an FMA, and reads float32 subnormals
    as zeros; neither is reproduced here.) State:
    ``{"count": int, "m": {name: float32 leaf-shaped}}`` for ``sgdm`` and
    ``adam``, with ``"v"`` beside it for ``adam``. The reference has no
    Pallas kernel here, and nor does the port. The leaves of `mean_leaves`
    arrive as the mean already (the fused ZeRO backward's, in
    ``wire["voted"]``) and skip the voters' sum, as the reference's."""
    if n_voters < 1:
        raise ValueError(f"n_voters must be >= 1, got {n_voters}")
    kind = cfg.kind
    if kind not in DENSE_KINDS:
        raise ValueError(kind)
    strategy = _concrete_strategy(cfg, n_voters)
    pre = frozenset(mean_leaves)

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
        majority_vote.add_voter_(wire["sum"], {
            k: g for k, g in grads.items() if k not in pre})

    @torch.no_grad()
    def update(wire: Dict, state: Dict, params: Dict[str, torch.Tensor],
               step: int) -> Dict[str, float]:
        """x <- x - eta*(upd + weight_decay*x) in float32, cast back, with
        upd the mean gradient (``sgd``), the momentum ``beta*m + g``
        (``sgdm``) or Adam's bias-corrected ratio."""
        eta, wd = lr_at(cfg, step), cfg.weight_decay
        count = state["count"] + 1
        b1, b2 = cfg.momentum, cfg.beta2
        sums = wire["sum"]

        def mean_of(k: str) -> torch.Tensor:
            # leaf by leaf, each sum freed once its mean exists (over a
            # mesh the all-reduce makes a new tensor)
            total = {k: sums.pop(k)}
            return (majority_vote.tree_mean_(total, n_voters)
                    if axes is None else
                    majority_vote.tree_mean(total, axes))[k]
        for k, p in params.items():
            g = (wire["voted"][k] if k in pre else mean_of(k)).to(
                torch.float32)
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
        return {}

    return Optimizer(init, wire, encode, update, strategy)


def build_optimizer(cfg: OptimizerConfig, n_voters: int,
                    plan: Optional[vp.VotePlan] = None,
                    byz: Optional[ByzantineConfig] = None,
                    diagnostics: bool = False, axes=None,
                    fused_leaves: Sequence[str] = (),
                    tiles: Optional[Dict[str, Tuple[int, int]]] = None,
                    shares: Optional[Dict[str, LeafShare]] = None
                    ) -> Optimizer:
    """The optimizer of `cfg.kind` (``repro.core.signum.build_optimizer``):
    the sign family for ``signum_vote`` / ``signsgd_vote``, with the
    adversaries of `byz` and the vote `diagnostics`, else the dense
    baselines, which ignore both as the reference's do; over mesh `axes`
    when given; `fused_leaves` arrive voted (or meaned) by the fused ZeRO
    backward; the sign family's `tiles` are voted slice by slice (see
    :func:`make_sign_optimizer`); `shares` places the leaves over a mesh's
    model axis (the dense baselines' mean is elementwise and needs no
    global statistic)."""
    def build(cfg: OptimizerConfig) -> Optimizer:
        if cfg.kind in SIGN_KINDS:
            return make_sign_optimizer(cfg, n_voters, plan, byz, diagnostics,
                                       axes, fused_leaves, tiles, shares)
        return make_dense_optimizer(cfg, n_voters, axes, fused_leaves)
    if cfg.vote_strategy == VoteStrategy.AUTO and n_voters > 1:
        return _AutoOptimizer(cfg, n_voters, axes, fused_leaves, build,
                              shares)
    return build(cfg)
