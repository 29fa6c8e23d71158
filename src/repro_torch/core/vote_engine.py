"""The vote strategies (``repro.core.vote_engine``; DESIGN.md §2).

The paper's parameter server is a four-stage pipeline

    pack  ->  exchange  ->  tally  ->  unpack

and each :class:`VoteStrategyImpl` realises its stages differently. Over
a stacked voter dim the exchange is virtualised by ``core.vote_api`` (the
reference's ``_virtual_wire_vote``); over a
``distributed.mesh.ProcessMesh`` each rank holds one voter and
:meth:`VoteStrategyImpl.exchange` runs the collectives over the bound vote
axes (``mesh.VoteAxes``), :meth:`VoteStrategyImpl.vote` composing the four
stages there as the reference does inside its ``shard_map`` region:

* ``psum_int8`` — one all-reduce of the count dtype (int16 counts ride as
  int32, ``distributed/mesh.py``);
* ``allgather_1bit`` — an all-gather of the packed words over each axis,
  pod first, then data, the voter dim collapsed data-major (row ``d * pod
  + p``) as the reference collapses it (``weighted_vote``'s per-voter
  rows follow that order);
* ``hierarchical`` — pad to ``PACK * data``, a reduce-scatter of the
  counts over data and their sum over pod, the ties-+1 sign, and the
  packed decision all-gathered (tiled) over data.

On a CUDA tensor the 1-bit stages run the hand-written kernels: the
gathered wire packs with ``bitpack``, tallies with ``majority`` and
unpacks with ``bitunpack``; hierarchical's 1-bit rebroadcast packs and
unpacks with the same two. The count wire (``psum_int8``) is torch ops,
as the reference has no kernel there.

Tie conventions differ by wire format (DESIGN.md §5): the count
strategies sum ternary signs (a tied or all-zero coordinate gives 0),
while the 1-bit wire can only encode two states, so ties go to +1.

AUTO resolves only for a single voter (``psum_int8``, no wire at all).
The reference prices the strategies for more voters with a TPU link model
(``distributed/comm_model.py``); the port carries no TPU number, so AUTO
over M > 1 raises until an H100 link model exists (ROADMAP.md Queue 1
item 15).
"""
from __future__ import annotations

import abc
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core import sign_compress as sc
from repro_torch.distributed import mesh as pm
from repro_torch.kernels import ops
from repro_torch.obs import recorder as obs


def vote_axes_in(mesh_axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The mesh axes the vote runs over, outermost first."""
    return tuple(a for a in pm.VOTE_AXES if a in mesh_axis_names)


def num_voters(axes) -> int:
    """Voters over the bound vote axes (1 for none)."""
    return pm.num_voters(axes)


def count_dtype(n_voters: int) -> torch.dtype:
    """Narrowest signed integer that can hold a vote count of `n_voters`."""
    if n_voters <= 127:
        return torch.int8
    if n_voters <= 32_767:
        return torch.int16
    return torch.int32


def count_bytes(n_voters: int) -> int:
    return count_dtype(n_voters).itemsize


class VoteStrategyImpl(abc.ABC):
    """One wire protocol for the majority vote: its pack / tally / unpack
    stages and the accounting of its exchange."""

    kind: VoteStrategy
    #: bits each replica puts on the wire per parameter, per exchange
    wire_bits_per_param: float
    #: tie convention of the decoded majority ("zero" or "plus_one")
    ties: str

    @abc.abstractmethod
    def pack(self, signs: torch.Tensor, n_voters: int) -> torch.Tensor:
        """Stacked (M, n) int8 signs -> wire tensor."""

    @abc.abstractmethod
    def tally(self, arrived: torch.Tensor, n_voters: int) -> torch.Tensor:
        """Aggregate to the (still-encoded) majority decision."""

    @abc.abstractmethod
    def unpack(self, decision: torch.Tensor, n: int,
               dtype: torch.dtype) -> torch.Tensor:
        """Decode the decision to (n,) ±1/0 signs in `dtype`."""

    @abc.abstractmethod
    def exchange(self, wire: torch.Tensor, axes) -> torch.Tensor:
        """Run the collectives over the bound vote `axes`; returns what
        tally needs."""

    def vote(self, signs: torch.Tensor, axes) -> torch.Tensor:
        """This rank's flat int8 signs (n,) -> the (n,) int8 majority over
        the vote `axes`, through the four stages (each in a host span
        ``stage.pack`` .. ``stage.unpack`` when a recorder is active)."""
        m = num_voters(axes)
        n = signs.shape[-1]
        rec = obs.get_recorder()
        kind = self.kind.value
        with rec.span("stage.pack", strategy=kind, n=n):
            wire = self.pack(signs.view(1, -1), m)
        with rec.span("stage.exchange", strategy=kind, n=n):
            arrived = self.exchange(wire, axes)
        with rec.span("stage.tally", strategy=kind, n=n):
            decision = self.tally(arrived, m)
        with rec.span("stage.unpack", strategy=kind, n=n):
            return self.unpack(decision, n, torch.int8).view(-1)

    def payload_bytes(self, n_params: int, n_voters: int = 2) -> float:
        """One replica's outbound wire payload (the paper's 'bits sent')."""
        return n_params * self.wire_bits_per_param / 8.0

    @abc.abstractmethod
    def ring_bytes(self, n_params: int, data_size: int,
                   pod_size: int = 1) -> Dict[str, float]:
        """Per-device transit bytes of the exchange, split within a pod
        ("ici") and across pods ("dci"), plus the collective count."""


class PsumInt8Strategy(VoteStrategyImpl):
    """Integer-sum vote: one all-reduce of narrow counts, then sign.

    pack casts ternary signs to the narrowest count dtype; the exchange
    sums them; tally is the identity (the sum already is the count);
    unpack takes the sign (ties and all-abstain coordinates -> 0)."""

    kind = VoteStrategy.PSUM_INT8
    wire_bits_per_param = 8.0   # int8 counts up to 127 voters
    ties = "zero"

    def pack(self, signs, n_voters):
        return signs.to(count_dtype(n_voters))

    def exchange(self, wire, axes):
        return pm.psum(wire, axes)

    def tally(self, arrived, n_voters):
        return arrived

    def unpack(self, decision, n, dtype):
        return torch.sign(decision).to(dtype)

    def ring_bytes(self, n_params, data_size, pod_size=1):
        c = count_bytes(data_size * pod_size)
        m = data_size * pod_size
        return {"ici": 2.0 * n_params * c * (data_size - 1) / data_size,
                "dci": (2.0 * (n_params / data_size) * c
                        * (pod_size - 1) / pod_size if pod_size > 1 else 0.0),
                "n_collectives": 1, "total": 2.0 * n_params * c * (m - 1) / m}


class Allgather1BitStrategy(VoteStrategyImpl):
    """The paper-faithful wire protocol: every device plays the server.

    pack bit-packs 32 signs per word, each voter's row on its own
    (``bitpack``); the exchange all-gathers the words; tally is the
    bit-sliced popcount majority across voters (``majority``); unpack
    decodes the packed majority (``bitunpack``, ties -> +1)."""

    kind = VoteStrategy.ALLGATHER_1BIT
    wire_bits_per_param = 1.0
    ties = "plus_one"

    def pack(self, signs, n_voters):
        return ops.bitpack(signs)

    def exchange(self, wire, axes):
        """(rows, w) local words -> (M * rows, w): gathered over each axis,
        pod first, the stacked dims collapsed data-major."""
        packed = wire
        for a in axes:
            packed = pm.all_gather(packed, axes, a)
        return packed.reshape((-1,) + tuple(wire.shape[1:]))

    def tally(self, arrived, n_voters):
        return ops.majority(arrived)

    def unpack(self, decision, n, dtype):
        return ops.bitunpack(decision, n, dtype)

    def ring_bytes(self, n_params, data_size, pod_size=1):
        # pod-first gather: the cross-pod hop moves one packed payload, the
        # in-pod hop then gathers the stacked (pod, w) words
        dci = (pod_size - 1) * n_params / 8.0
        ici = (data_size - 1) * pod_size * n_params / 8.0
        return {"ici": ici, "dci": dci,
                "n_collectives": 1 + (1 if pod_size > 1 else 0),
                "total": ici + dci}


class HierarchicalStrategy(VoteStrategyImpl):
    """Count-shards within the pod, sums counts across pods, rebroadcasts
    the 1-bit result: the global majority (counts cross pods, not a
    vote of votes).

    pack casts to counts; the exchange is the count reduce-scatter (each
    of the M voters ends with one shard of the summed counts, the payload
    padded to 32*M so shards stay word-aligned); tally is the binary sign
    of each shard; unpack packs every shard's decision (``bitpack``),
    gathers the words in voter order and decodes them (``bitunpack``)."""

    kind = VoteStrategy.HIERARCHICAL
    wire_bits_per_param = 8.0   # int8 counts in the reduce-scatter
    ties = "plus_one"

    def pack(self, signs, n_voters):
        return signs.to(count_dtype(n_voters))

    def tally(self, arrived, n_voters):
        return sc.sign_binary(arrived)       # ties -> +1 (1-bit wire)

    def unpack(self, decision, n, dtype):
        # decision: (M, shard) — the gather of the packed shards is their
        # concatenation in voter order
        return ops.bitunpack(ops.bitpack(decision).view(-1), n, dtype)

    def exchange(self, wire, axes):
        """(n_pad,) local counts -> this rank's shard of their sum: a
        reduce-scatter over data, then a sum over pod."""
        counts = pm.psum_scatter(wire, axes, "data")
        if "pod" in tuple(axes):
            counts = pm.psum(counts, axes, ("pod",))
        return counts

    def gather_unpack(self, decision, n, dtype, axes):
        """This rank's shard decision -> the (n,) decision: packed
        (``bitpack``), all-gathered over data (tiled) and decoded
        (``bitunpack``)."""
        words = ops.bitpack(decision.view(1, -1))[0]
        return ops.bitunpack(pm.all_gather(words, axes, "data", tiled=True),
                             n, dtype)

    def vote(self, signs, axes):
        dsize = pm.axis_size(axes, "data")
        m = num_voters(axes)
        n = signs.shape[-1]
        padded, _ = sc.pad_last(signs.view(-1), sc.PACK * dsize)
        decision = self.tally(self.exchange(self.pack(padded, m), axes), m)
        return self.gather_unpack(decision, n, torch.int8, axes)

    def ring_bytes(self, n_params, data_size, pod_size=1):
        d = float(n_params)
        rs = d * 1 * (data_size - 1) / data_size        # int8 RS in pod
        xpod = ((d / data_size) * 1 * 2 * (pod_size - 1) / max(pod_size, 1)
                if pod_size > 1 else 0.0)
        ag = (d / 8) * (data_size - 1) / data_size      # packed AG
        return {"ici": rs + ag, "dci": xpod,
                "n_collectives": 2 + (1 if pod_size > 1 else 0),
                "total": rs + xpod + ag}


STRATEGIES: Dict[VoteStrategy, VoteStrategyImpl] = {
    VoteStrategy.PSUM_INT8: PsumInt8Strategy(),
    VoteStrategy.ALLGATHER_1BIT: Allgather1BitStrategy(),
    VoteStrategy.HIERARCHICAL: HierarchicalStrategy(),
}


def resolve_strategy(strategy: VoteStrategy, n_params: int,
                     data_size: int, pod_size: int = 1,
                     codec: str = "sign1bit") -> VoteStrategy:
    """A concrete strategy for `strategy`. AUTO over one voter is
    ``psum_int8`` (no wire traffic at all), as in the reference; AUTO over
    more voters needs a link model of the H100 host, which is not there
    yet."""
    if strategy != VoteStrategy.AUTO:
        return strategy
    from repro_torch.core import codecs
    candidates = codecs.get_codec(codec).supported_strategies
    if data_size * pod_size <= 1:
        return (VoteStrategy.PSUM_INT8
                if VoteStrategy.PSUM_INT8 in candidates else candidates[0])
    raise NotImplementedError(
        f"vote_strategy=auto over {data_size * pod_size} voters prices the "
        "wires with a link model, and the port has no H100 link model yet "
        "(ROADMAP.md Queue 1 item 15); name a concrete strategy")
