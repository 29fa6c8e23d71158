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
itself). The fused ZeRO backward (``make_gather_vote`` /
``make_fsdp_hooks``, the vote inside the reduce-scatter) is not ported
yet: both raise citing ROADMAP.md Queue 4 item 4 (R4's ``fsdp``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ByzantineConfig, VoteStrategy
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


def _fsdp(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (the fused ZeRO backward: the vote inside the "
        "reduce-scatter) is not ported yet (ROADMAP.md Queue 4 item 4, "
        "R4's fsdp)")


def make_gather_vote(*args, **kwargs):
    """The reference's ZeRO-3 gather whose backward votes: not ported."""
    raise _fsdp("make_gather_vote")


def make_fsdp_hooks(*args, **kwargs):
    """The reference's per-parameter ZeRO-3 hooks: not ported."""
    raise _fsdp("make_fsdp_hooks")


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
