"""Majority-vote aggregation over the mesh and the dense baselines' mean
(``repro.core.majority_vote``).

Over the bound vote axes of a ``distributed.mesh.ProcessMesh`` (one voter
per rank): the flat strategy wrappers :func:`vote_psum`,
:func:`vote_allgather_1bit` and :func:`vote_hierarchical` (the strategies'
``vote`` stages), :func:`majority_vote_flat`, the tree entry points
:func:`tree_vote` / :func:`tree_vote_codec` (tree-form requests on
``MeshBackend``, the reference's deprecated shims) and the dense
baselines' :func:`tree_mean`, an all-reduce of each gradient in its dtype
divided by M in that dtype. The all-reduce sums in the backend's order,
so a bf16 mean agrees with the stacked sum of :func:`add_voter_` within
bf16's rounding, not bit for bit.

With M voters stacked on one device the gradients arrive one voter at a
time, so the dense mean is made as they arrive (:func:`add_voter_`, in
place, voter 0's gradient being the sum's buffer) and divided once all
are in (:func:`tree_mean_`). A bf16 sum rounds after each voter's add; the
reference's ``psum`` rounds in an order its collective chooses, so the two
agree within bf16 rounding and bit for bit at M = 1 (the mean is g
itself).

The fused ZeRO-3 backward (``TrainConfig.fsdp``, the reference's Mode B
scalable path): :func:`make_fsdp_hooks` gives the model a parameter hook
that all-gathers each FSDP-sharded leaf over ``"data"`` in the forward
pass (:func:`make_gather_vote`, a ``torch.autograd.Function``) and, in
the backward pass, votes inside the reduce-scatter: the ternary signs of
the whole cotangent (:func:`fused_signs`: subnormals read as 0, an
adversarial replica's signs corrupted by ``byzantine.evil_signs_`` under
no step, as the reference passes none), summed in ``count_dtype(M)`` by a
reduce-scatter over ``"data"`` along the leaf's FSDP dim and an
all-reduce over ``"pod"``, and the sign of the count (ties 0) in the
cotangent's dtype becomes this rank's slice of the gradient. The dense
baselines' form reduce-scatters the cotangent in its own dtype, sums over
``"pod"`` and divides by M. Every collective a backward issues is logged
(:attr:`FsdpHooks.issued`), so the trainer can assert that every rank
issued them in one order. With the voters stacked on one device the same
vote is made without a collective (:func:`add_fused_signs_`,
:func:`fused_vote`). Over a mesh with a ``"model"`` axis a leaf that
carries both a ``"data"`` and a ``"model"`` dim (the Mode B presets' layer
matrices) is the rank's model slice, cut again along its FSDP dim: the
hook gathers and reduce-scatters over ``"data"`` within the rank's model
slice (the vote axes' groups at its model index), each coordinate voted
as without the model axis. An adversarial replica's stochastic draw there
is over the gathered block's own shape (one layer of it for a stacked
leaf), from counter 0, under the voter's key on every model rank: the
reference votes inside a region manual over ``"model"`` too, where the
block is the whole array its ``bernoulli`` sees.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.configs.base import ByzantineConfig, VoteStrategy
from repro_torch.core import byzantine
from repro_torch.core import sign_compress as sc
from repro_torch.core.vote_engine import (  # noqa: F401  (re-exported API)
    STRATEGIES, count_dtype, num_voters, vote_axes_in)
from repro_torch.distributed import mesh as pm


def vote_psum(signs: torch.Tensor, axes) -> torch.Tensor:
    """This rank's int8 signs (ternary) -> the int8 majority over `axes`
    (ties and all-abstain 0)."""
    return STRATEGIES[VoteStrategy.PSUM_INT8].vote(signs.reshape(-1),
                                                   axes).view(signs.shape)


def vote_allgather_1bit(signs: torch.Tensor, axes) -> torch.Tensor:
    """int8 signs -> the ±1 majority over the packed 1-bit wire."""
    return STRATEGIES[VoteStrategy.ALLGATHER_1BIT].vote(
        signs.reshape(-1), axes).view(signs.shape)


def vote_hierarchical(signs: torch.Tensor, axes) -> torch.Tensor:
    """int8 signs -> ±1: the count reduce-scatter over data, the sum over
    pod and the packed all-gather (the reference names the data and pod
    axes; here they are the bound `axes`' own)."""
    return STRATEGIES[VoteStrategy.HIERARCHICAL].vote(
        signs.reshape(-1), axes).view(signs.shape)


def majority_vote_flat(signs: torch.Tensor, strategy: VoteStrategy, axes
                       ) -> torch.Tensor:
    """A flat sign tensor through the wire, as a leaf-form request."""
    from repro_torch.core import vote_api as va
    return va.MeshBackend(axes=axes, device=signs.device).execute(
        va.VoteRequest(payload=signs, form="leaf", strategy=strategy)).votes


def tree_vote_codec(tree: Dict[str, torch.Tensor], strategy: VoteStrategy,
                    axes, byz: Optional[ByzantineConfig] = None, step=None,
                    codec: str = "sign1bit", server_state=None):
    """A tree of this rank's values -> (±1/0 tree in the leaf dtypes, new
    server state), as a tree-form request on ``MeshBackend``."""
    from repro_torch.core import vote_api as va
    out = va.MeshBackend(axes=axes, device=next(iter(tree.values())).device
                         ).execute(va.VoteRequest(
                             payload=tree, form="tree", strategy=strategy,
                             codec=codec, failures=va.FailureSpec(byz=byz),
                             step=step, server_state=server_state))
    return out.votes, out.server_state


def tree_vote(tree: Dict[str, torch.Tensor], strategy: VoteStrategy, axes,
              byz: Optional[ByzantineConfig] = None, step=None):
    """:func:`tree_vote_codec` with ``sign1bit``; returns the vote tree.
    Without vote axes (M = 1) the vote is each leaf's own sign."""
    return tree_vote_codec(tree, strategy, axes, byz, step)[0]


def tree_mean(tree: Dict[str, torch.Tensor], axes) -> Dict[str, torch.Tensor]:
    """Dense baseline: each leaf summed over `axes` in its dtype and
    divided by M in that dtype (``psum(g) / n``)."""
    n = num_voters(axes)
    return {k: (pm.psum(g, axes) if axes else g.clone()).div_(n)
            for k, g in tree.items()}


# ---------------------------------------------------------------------------
# fused ZeRO-3 gather + vote-in-backward (Mode B scalable path)
# ---------------------------------------------------------------------------


def fused_signs(g: torch.Tensor, byz: Optional[ByzantineConfig],
                replica: int, rows: int = 1) -> torch.Tensor:
    """The int8 ternary signs voter `replica` puts into the fused vote of
    its cotangent `g` (a subnormal reads as 0): corrupted as an adversary's
    when `replica` is below ``byz.num_adversaries``, drawn under no step and
    salt 0 (the reference's fused backward passes no step, so a stochastic
    adversary draws the same bits every step and microbatch). `g` holds
    `rows` equal blocks that the reference gathers one at a time (the
    layers of a stacked leaf): each draws over its own elements, alike.
    Over a model axis `g` is the rank's model block, drawn as a whole."""
    s = sc.sign_ternary(g)
    if byz is not None and byz.mode != "none" \
            and replica < byz.num_adversaries:
        byzantine.evil_signs_(s.view(rows, -1), byz, [replica] * rows,
                              step=None)
    return s


def add_fused_signs_(count: Optional[torch.Tensor], g: torch.Tensor,
                     byz: Optional[ByzantineConfig], replica: int,
                     n_voters: int, rows: int = 1) -> torch.Tensor:
    """Voter `replica`'s :func:`fused_signs` of `g` added into the stacked
    count (a new ``count_dtype(n_voters)`` tensor when `count` is None)."""
    s = fused_signs(g, byz, replica, rows)
    if count is None:
        return s.to(count_dtype(n_voters))
    return count.add_(s)


def fused_vote(count: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The fused vote of a count: its sign (ties 0) in `dtype`."""
    return torch.sign(count).to(dtype)


class _Gather(torch.autograd.Function):
    """All-gather of this rank's slice over ``"data"`` along `dim`; the
    backward is `bwd(cotangent)`, this rank's slice of the vote (or of
    the mean)."""

    @staticmethod
    def forward(ctx, x, axes, dim, bwd):
        ctx.bwd = bwd
        return pm.all_gather(x, axes, "data", tiled=True, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None, None


def make_gather_vote(dim: int, axes, *, vote: bool,
                     byz: Optional[ByzantineConfig] = None,
                     log: Optional[Callable[[str], None]] = None,
                     name: str = "") -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    """all_gather over the ``"data"`` axis of the bound vote `axes` along
    `dim`, whose backward is the majority vote (`vote`) or the dense mean
    (the reference's ``make_gather_vote``; see the module doc). `log(name)`
    is called as each of its collectives is issued."""
    n_voters = num_voters(axes)
    pod = "pod" in axes
    replica = pm.replica_index(axes)

    def reduce(x: torch.Tensor) -> torch.Tensor:
        if log is not None:
            log(name)
        out = pm.psum_scatter(x, axes, "data", dim=dim)
        return pm.psum(out, axes, ("pod",)) if pod else out

    def bwd_vote(g: torch.Tensor) -> torch.Tensor:
        s = fused_signs(g, byz, replica).to(count_dtype(n_voters))
        return fused_vote(reduce(s), g.dtype)

    def bwd_mean(g: torch.Tensor) -> torch.Tensor:
        return reduce(g).div_(n_voters)

    bwd = bwd_vote if vote else bwd_mean

    def gather(x: torch.Tensor) -> torch.Tensor:
        if log is not None:
            log(name)
        return _Gather.apply(x, axes, dim, bwd)
    return gather


class FsdpHooks:
    """The parameter hook of :func:`make_fsdp_hooks`: ``hook(tree, scope)``
    gathers every FSDP-sharded leaf of `tree` ("top": full names; "layers":
    one layer's tree, names without ``"layers."`` and the leading L dim, so
    the FSDP dim shifts down by one). :attr:`issued` lists, in order, the
    leaves whose collectives this rank issued (forward gathers, the
    backward's reduce-scatters and remat's re-gathers)."""

    def __init__(self, dims: Mapping[str, int], axes, *, vote: bool,
                 byz: Optional[ByzantineConfig] = None):
        self.issued: List[str] = []
        self.top, self.layers = {}, {}
        for name, d in dims.items():
            if name.startswith(("layers.", "encoder.")):
                short = name.split(".", 1)[1]
                self.layers[short] = make_gather_vote(
                    d - 1, axes, vote=vote, byz=byz,
                    log=self.issued.append, name=name)
            else:
                self.top[name] = make_gather_vote(
                    d, axes, vote=vote, byz=byz, log=self.issued.append,
                    name=name)

    def __call__(self, tree: Dict[str, torch.Tensor], scope: str
                 ) -> Dict[str, torch.Tensor]:
        table = self.top if scope == "top" else self.layers
        return {k: (table[k](v) if k in table else v)
                for k, v in tree.items()}


def make_fsdp_hooks(dims: Mapping[str, int], axes, *, vote: bool,
                    byz: Optional[ByzantineConfig] = None) -> FsdpHooks:
    """The ZeRO-3 parameter hook over the bound vote `axes` for the leaves
    of `dims` (``{name: FSDP dim}``, ``distributed.sharding.fused_dims``);
    its backward votes (`vote`) or means. See :class:`FsdpHooks`."""
    return FsdpHooks(dims, axes, vote=vote, byz=byz)


def add_voter_(total: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
    """One voter's gradients added into the running sum `total`, leaf by
    leaf in the gradient's dtype (the first voter's tensors become the sum
    and are written in place from then on)."""
    for k, g in grads.items():
        if k in total:
            total[k].add_(g)
        else:
            total[k] = g.detach()


def tree_mean_(total: Dict[str, torch.Tensor],
               n_voters: int) -> Dict[str, torch.Tensor]:
    """The summed gradients divided by `n_voters` in place, in their dtype
    (``psum(g) / n``)."""
    for g in total.values():
        g.div_(n_voters)
    return total
