"""The dense baselines' aggregation (``repro.core.majority_vote``, only
its ``tree_mean``): the mean of the voters' gradients.

The reference sums each leaf over the vote axes with ``psum`` in the
gradient's own dtype and divides by the voter count in that dtype. With M
voters stacked on one device the gradients arrive one voter at a time, so
the sum is made as they arrive (:func:`add_voter_`, in place, voter 0's
gradient being the sum's buffer) and divided once all are in
(:func:`tree_mean_`). A bf16 sum rounds after each voter's add; the
reference's ``psum`` rounds in an order its collective chooses, so the two
agree within bf16 rounding and bit for bit at M = 1 (the mean is g
itself). The fused ZeRO backward's psum-mean (``make_gather_vote`` with
``vote=False``) needs ``fsdp`` and stays with it (ROADMAP.md Queue 4
item 4).
"""
from __future__ import annotations

from typing import Dict

import torch


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
