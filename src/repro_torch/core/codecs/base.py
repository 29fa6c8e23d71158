"""The GradientCodec interface (``repro.core.codecs.base``; DESIGN.md §8).

A codec decides what each voter puts on the wire and how the tally
decodes it, in three pieces:

* **worker state** (``init_state`` / ``encode_leaf`` / ``feedback_leaf``)
  — per-voter memory beside the momentum (the EF residual), momentum-
  shaped with the leading voter axis under Mode A;
* **server state** (``init_server_state``) — per-voter-set decode memory
  (the weighted vote's flip-rate estimates), one copy for all voters;
* **the wire** (``supported_strategies`` / ``wire_bits`` / ``ties``) —
  which strategies transport the codec's symbols, at what width and with
  which tie rule;
* **the trainer's hooks** (``two_bit`` / ``words_for`` / ``raw_input_`` /
  ``encode_voter_`` / ``begin_step`` / ``vote_`` / ``apply_`` /
  ``feedback_voters_`` / ``end_step``) — the same three pieces with M
  voters stacked on one device, written in place over the momentum, the
  residual and the parameters, on one of three trainer wires that
  :meth:`GradientCodec.two_bit` and :meth:`GradientCodec.ties` pick from
  the strategy:

  - the 1-bit wire (``allgather_1bit``): the signs of the vote input
    (``momentum_sign_pack``'s own words when that input is m'), the
    popcount majority (ties +1) and ``apply_vote``;
  - the 2-bit count wire (``psum_int8``): the vote input's
    ``sign_ternary`` symbols packed 16 a word (``ternary_pack``), the
    ternary majority (``ternary_majority``: the sign of the symbol sum,
    ties and all-abstain 0) and ``apply_ternary_vote``, which leaves a 0
    vote's parameter still. ``ternary2bit`` rides it on every strategy;
    every codec that the count wire ``psum_int8`` carries rides it there.
    The reference's ``psum_int8`` sends ``sign_ternary`` of the vote input
    (``repro.core.vote_api._leaf_execute``), sums the symbols over the
    voters as int8 counts (int16 above 127 voters) and votes the sign of
    the count, ties and all-abstain 0 (``vote_engine.PsumInt8Strategy``).
    The ternary tally compares the count of +1 symbols with the count of
    -1 symbols, which is the same decision, and its counters have no
    width limit; so the count wire needs no ``torch.sign`` pass and no
    int8 sum;
  - the 2-bit wire with ties +1 (``hierarchical``): the same symbols and
    packing, tallied by ``ternary_majority(ties="plus_one")`` (+1 wherever
    the +1 symbols are at least the -1 symbols) and applied by
    ``apply_ternary_vote``. The reference's ``hierarchical`` sums the
    ternary symbols as counts (a reduce-scatter), takes ``sign_binary`` of
    each count (ties and all-abstain +1) and rebroadcasts it 1 bit a
    coordinate (``vote_engine.HierarchicalStrategy``): the same decision,
    with no count tensor. An abstaining voter counts nothing here, where
    the 1-bit wire would read its 0 as +1.

  The vote input is each voter's new momentum m' under per-worker
  momentum (Mode A, beta > 0), and its gradient g itself at beta = 0 and
  under Mode B (``raw_input_``; the reference votes ``grads`` there,
  ``core/signum.py:185-190`` and ``:200-205``).

Over a mesh's ``"model"`` axis a leaf is a rank's shard, but a codec's
leaf statistics are the global leaf's, as in the reference (whose step is
automatic over ``"model"``): each hook that takes one gets the leaf's
:class:`LeafShare`, and a statistic becomes the sum over the model group
of the shards' parts, a replicated leaf counted once.

Implementations are stateless singletons; state lives in the caller's
dictionaries.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core import sign_compress as sc
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LeafShare:
    """How one leaf lies over a mesh's model axis: `sharded` over it (a
    rank holds one of ``mesh.model`` equal slices along `dim`, the dim its
    spec names ``"model"``, of the leaf's global `shape`) or whole on every
    model rank."""

    mesh: Any
    sharded: bool
    dim: Optional[int] = None
    shape: Tuple[int, ...] = ()

    @property
    def parts(self) -> int:
        """The shards of the leaf (1 for a replicated one)."""
        return self.mesh.model if self.sharded else 1

    @property
    def counted(self) -> bool:
        """Whether this rank counts the leaf in a sum over the model group:
        every rank its shard, model index 0 a replicated leaf."""
        return self.sharded or self.mesh.axis_index("model") == 0

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over the model group (``mesh.model_sum``)."""
        from repro_torch.distributed import mesh as pm
        return pm.model_sum(x, self.mesh)

    def counter_map(self, local_shape, offset: int = 0) -> Dict[str, int]:
        """The adversary's counter map (``core.prng.counter_map``) for this
        rank's block of local shape `local_shape`, the whole leaf starting
        at counter `offset`: ``{"offset", "block", "gap"}``, the
        keywords of ``byzantine.evil_signs_``. A replicated leaf draws as
        without a model axis (block 0)."""
        if not self.sharded:
            return {"offset": offset, "block": 0, "gap": 0}
        from repro_torch.core import prng
        base, block, gap = prng.counter_map(
            tuple(local_shape), self.dim, self.parts,
            self.mesh.axis_index("model"), offset)
        return {"offset": base, "block": block, "gap": gap}


class GradientCodec(abc.ABC):
    """One point on the compression/robustness frontier."""

    #: registry key (also the OptimizerConfig spelling)
    name: str
    #: wire bits per parameter on the codec's native packed exchange
    bits_per_param: float
    #: strategies whose exchange can transport this codec's symbols
    supported_strategies: Tuple[VoteStrategy, ...]
    #: True if encode carries per-worker memory (EF residual)
    worker_state: bool = False
    #: True if decode carries server-side memory (reliability weights)
    server_state: bool = False

    # ---- worker side -----------------------------------------------------

    def init_state(self, values: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-worker encode memory for one leaf (None if stateless)."""
        return None

    def encode_leaf(self, values: torch.Tensor,
                    state: Optional[torch.Tensor]) -> torch.Tensor:
        """values -> the tensor whose SIGNS go to the wire; stateful codecs
        fold their memory in here."""
        return values

    def feedback_leaf(self, encoded: torch.Tensor, vote: torch.Tensor,
                      state: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
        """Post-vote worker-state update; `encoded` is what encode_leaf
        returned, `vote` the decoded ±1/0 tensor."""
        return state

    # ---- server side -----------------------------------------------------

    def init_server_state(self, n_workers: int, device=None
                          ) -> Dict[str, torch.Tensor]:
        """Server-side decode memory for an M-voter set ({} if none); all
        zeros is the uninformed prior."""
        return {}

    # ---- the trainer (M voters stacked, in place) --------------------------

    def two_bit(self, strategy: VoteStrategy) -> bool:
        """Whether the trainer's wire under `strategy` is a 2-bit one (see
        the module doc): ``psum_int8`` and ``hierarchical``, whose counts
        let a voter abstain."""
        return strategy in (VoteStrategy.PSUM_INT8,
                            VoteStrategy.HIERARCHICAL)

    def words_for(self, n: int, two_bit: bool) -> int:
        """Words of one voter's symbols of an n-coordinate leaf."""
        return sc.ternary_words_for(n) if two_bit else sc.words_for(n)

    def vote_input_(self, m: torch.Tensor, error: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """What one voter's symbols are taken of, from its new momentum row
        `m` (flat) and residual row `error`: m' itself by default."""
        return m

    def raw_input_(self, g: torch.Tensor, error: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """:meth:`vote_input_` without momentum (beta = 0, or Mode B): from
        the voter's flat gradient `g` itself, which, unlike a momentum
        kernel's m', may hold subnormals (the sign kernels read them as
        zeros)."""
        return self.vote_input_(g, error)

    def encode_voter_(self, g: torch.Tensor, m: Optional[torch.Tensor],
                      beta: float, words: torch.Tensor,
                      error: Optional[torch.Tensor], two_bit: bool,
                      adversary: Optional[Callable[[torch.Tensor], Any]]
                      = None, share: Optional[LeafShare] = None) -> Any:
        """One voter's worker side of one flat leaf: m <- beta*m +
        (1-beta)*g in place, and the voter's symbols of
        :meth:`vote_input_` into `words` (its row of the leaf's words);
        without a momentum row (`m` None: beta = 0, or Mode B) the symbols
        of :meth:`raw_input_` of g. `error` is the voter's residual row
        (None without worker state). An adversarial voter's `adversary`
        transforms its ``(1, n)`` int8 ``sign_ternary`` symbols in place
        before they are packed (the 1-bit words of m' cannot take it: an
        honest 0 and a flipped 0 both pack as +1). `share` is the leaf's
        place over a model axis (None without one). Returns what
        :meth:`feedback_voters_` needs of this voter."""
        if m is None:
            x = self.raw_input_(g, error)
        elif not two_bit and not self.worker_state and adversary is None:
            # the vote input is m' (only worker state, the EF residual,
            # changes it): its 1-bit signs are momentum_sign_pack's words
            ops.momentum_sign_pack(g, m, beta, m_out=m, packed_out=words)
            return None
        else:
            ops.momentum_sign_pack(g, m, beta, m_out=m, pack=False)
            x = self.vote_input_(m, error)
        symbols = x.view(1, -1)
        if adversary is not None:
            symbols = sc.sign_ternary(symbols)
            adversary(symbols)
        if two_bit:
            ops.ternary_pack(symbols, out=words.view(1, -1))
        else:
            ops.bitpack(symbols, out=words.view(1, -1))
        return self.sent_(x, share)

    def sent_(self, x: torch.Tensor, share: Optional[LeafShare] = None
              ) -> Any:
        """What one voter's encode hands :meth:`feedback_voters_`, from its
        vote input `x` (a shard of the leaf `share` places): nothing by
        default."""
        return None

    def begin_step(self, server_state: Optional[Dict[str, torch.Tensor]]
                   ) -> Any:
        """The server's decode context for one step, fixed for the step."""
        return None

    def vote_(self, words: torch.Tensor, n: int, ctx: Any, two_bit: bool,
              ties: str = "zero", counted: bool = True) -> torch.Tensor:
        """(M, w) words of an n-coordinate leaf -> the packed vote; `ties`
        is the 2-bit tally's tie rule (:meth:`ties` of the strategy);
        `counted` False leaves the leaf out of the step's statistics (a
        replicated leaf on a model rank other than the first)."""
        return (ops.ternary_majority(words, ties=ties) if two_bit
                else ops.majority(words))

    def apply_(self, p: torch.Tensor, votes: torch.Tensor, eta: float,
               weight_decay: float, two_bit: bool) -> None:
        """Flat p <- p - eta*(vote + weight_decay*p) in place."""
        apply = ops.apply_ternary_vote if two_bit else ops.apply_vote
        apply(p, votes, eta, weight_decay, out=p)

    def feedback_voters_(self, votes: torch.Tensor,
                         error: Optional[torch.Tensor], sent: List[Any],
                         two_bit: bool) -> None:
        """After the vote: the (M, n) residual of the leaf from the packed
        `votes` and each voter's :meth:`encode_voter_` result."""

    def feedback_decoded_(self, vote: torch.Tensor,
                          error: Optional[torch.Tensor],
                          sent: List[Any]) -> None:
        """:meth:`feedback_voters_` with the vote already decoded to a
        flat ±1/0 tensor in the residual's dtype (the plan path's)."""

    def reduce_step_(self, ctx: Any, total: Callable) -> None:
        """Sum the step's statistics in `ctx` over the model group with
        `total` (``LeafShare.total``) before :meth:`end_step`: nothing by
        default."""

    def end_step(self, server_state: Optional[Dict[str, torch.Tensor]],
                 ctx: Any) -> None:
        """The server state's update once every leaf is voted."""

    # ---- wire ------------------------------------------------------------

    def ties(self, strategy: VoteStrategy) -> str:
        """Decoded tie convention under `strategy` ("zero"/"plus_one")."""
        from repro_torch.core.vote_engine import STRATEGIES
        return STRATEGIES[strategy].ties

    def wire_bits(self, strategy: VoteStrategy) -> float:
        """Wire bits per param this codec puts on `strategy`'s exchange."""
        from repro_torch.core.vote_engine import STRATEGIES
        if strategy == VoteStrategy.ALLGATHER_1BIT:
            return self.bits_per_param
        return STRATEGIES[strategy].wire_bits_per_param

    def validate_strategy(self, strategy: VoteStrategy) -> None:
        if strategy not in self.supported_strategies:
            raise ValueError(
                f"codec {self.name!r} cannot ride strategy "
                f"{strategy.value!r}; supported: "
                f"{tuple(s.value for s in self.supported_strategies)}")
