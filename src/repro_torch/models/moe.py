"""Mixture-of-Experts FFN with sort-based capacity dispatch
(``repro.models.moe``).

Routing: a float32 softmax router, the top-k experts of each token (ties to
the lower expert index, as ``jax.lax.top_k`` breaks them), weights
renormalised over the k. Dispatch: the token's slots are sorted by expert
(a stable sort) and gathered into an ``(E, C, d)`` buffer of capacity
``C = ceil(T*k/E * capacity_factor)`` padded to 8; slots beyond an
expert's capacity are dropped. Expert GEMMs run as batched ``(E, C, d) x
(E, d, f)`` products; the combine adds each token's weighted expert outputs
back. The Switch load-balancing loss times ``router_aux_weight`` is the
aux. qwen2-moe's shared branch (one SwiGLU of the merged shared experts,
gated by a learned sigmoid) is added when its weights are present.

Every sum over a token's slots runs in slot order (expert-major), one add
at a time in the activations' dtype from zeros: the reference's
``out.at[buf_token].add(...)`` in the forward, and the transpose of its
``take`` in the backward. Both are written as gathers over a ``(T, k)``
slot map (:class:`_Dispatch`, :class:`_Combine`), so no ``index_add_`` or
atomic scatter runs and two runs of a step on the card are bit-equal.
None of this is a kernel: the reference's MoE is jnp.

Over a model group (`tp`; ``distributed.tensor_parallel``) the routing is
computed replicated and a rank runs its experts (EP) or its d_ff columns
of every expert (M2); its weighted slots are added in slot order into a
float32 partial that one sum over the group closes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.models.layers import model_group, swiglu_mlp


def _capacity(num_tokens: int, num_experts: int, top_k: int,
              factor: float) -> int:
    cap = int(math.ceil(num_tokens * top_k / num_experts * factor))
    return max(8, int(math.ceil(cap / 8)) * 8)  # the reference pads to 8


def route_topk(router_logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) -> (weights (T,k) float32, experts (T,k) int64, aux scalar).

    Router probabilities are renormalised over the selected top-k (qwen
    convention); aux is the Switch load-balancing loss ``E * sum_e f_e *
    p_e`` (its gradient through the mean probabilities only)."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    # a stable descending sort puts the lower index first among equal
    # probabilities, as jax.lax.top_k does; torch.topk promises no order
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    experts = order[:, :top_k]
    weights = torch.gather(probs, 1, experts)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    counts = torch.bincount(experts.reshape(-1), minlength=E)
    frac_tokens = counts.to(torch.float32) / T
    mean_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * mean_probs)
    return weights, experts, aux


def _ordered_sum(src: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """out[t] = sum over j of src[slots[t, j]], added in j order from zeros
    in src's dtype (one rounding per add); ``slots`` points absent entries
    at a zero row appended to src."""
    pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    out = src.new_zeros((slots.shape[0],) + src.shape[1:])
    for j in range(slots.shape[1]):
        out.add_(pad.index_select(0, slots[:, j]))
    return out


class _Dispatch(torch.autograd.Function):
    """expert_in = xt_pad[buf_token] (xt with a zero row T appended): the
    reference's ``jnp.take``. Its backward adds each token's slot
    cotangents in slot order (:func:`_ordered_sum`), as the transpose of
    the take does, instead of ``index_add_``'s atomics."""

    @staticmethod
    def forward(ctx, xt, buf_token, slots):
        ctx.save_for_backward(slots)
        pad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))])
        return pad.index_select(0, buf_token)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return _ordered_sum(g, slots), None, None


class _Combine(torch.autograd.Function):
    """out[t] = the sum of token t's weighted expert outputs in slot order
    (the reference's ``out.at[buf_token].add(...)``); its backward gathers
    each slot's token cotangent (zero for an empty slot)."""

    @staticmethod
    def forward(ctx, expert_out, slots, buf_token):
        ctx.save_for_backward(buf_token)
        return _ordered_sum(expert_out, slots)

    @staticmethod
    def backward(ctx, g):
        (buf_token,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return pad.index_select(0, buf_token), None, None


def dispatch_plan(experts: torch.Tensor, num_experts: int, capacity: int
                  ) -> Dict[str, torch.Tensor]:
    """The sort-based dispatch of (T, k) expert choices: ``order`` (the
    slots sorted by expert, stable), ``dest`` (each sorted slot's place in
    the flat (E*C) buffer, E*C when dropped), ``buf_token`` (the token of
    each buffer place, T when empty) and ``slots`` (T, k): each token's
    buffer places in ascending order, E*C where a slot was dropped."""
    T, k = experts.shape
    E, C = num_experts, capacity
    dev = experts.device
    flat_expert = experts.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    counts = torch.bincount(flat_expert, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[sorted_expert]
    keep = pos < C
    dest = torch.where(keep, sorted_expert * C + pos,
                       torch.full_like(pos, E * C))
    # dropped slots all land on the overflow place E*C, which is cut off
    buf_token = torch.full((E * C + 1,), T, dtype=torch.int64,
                           device=dev).scatter(0, dest, sorted_token)
    # each token's places: its slots are k distinct experts, so sorting
    # its places puts them in slot (expert-major) order, dropped ones last
    places = torch.empty(T * k, dtype=torch.int64, device=dev)
    places[order] = dest
    slots = torch.sort(places.view(T, k), dim=1)[0]
    return {"order": order, "dest": dest, "buf_token": buf_token[:E * C],
            "slots": slots, "dropped": (~keep).sum()}


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, moe_cfg,
            min_capacity: int = 0, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux loss times ``router_aux_weight``).

    Expects router_w (d,E), experts_w_gate/up (E,d,f), experts_w_down
    (E,f,d); and shared_w_* with shared_gate_w (d,1) for the shared
    branch. T = B*S tokens of this call are routed together: a voter's
    microbatch alone, as each replica's is in the reference. An expert
    holds at least `min_capacity` slots: the serving engine's decode
    passes its batch, so that no slot's token is dropped, as none is when
    the reference decodes each slot as a batch of one. Over a model group
    `tp` the expert leaves are the rank's blocks (:func:`_tp_routed`)."""
    B, S, d = x.shape
    T = B * S
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    C = max(_capacity(T, E, k, moe_cfg.capacity_factor), min_capacity)

    xt = x.reshape(T, d)
    logits = xt @ p["router_w"]
    weights, experts, aux = route_topk(logits, k)
    plan = dispatch_plan(experts, E, C)
    # each buffer place's routing weight (0 where empty); the scatter's
    # backward is a gather, and a dropped slot's weight gets no gradient
    tp = model_group(tp)
    if tp is not None:
        # the rank's slots take a partial of the weights' cotangent
        weights = tpar.copy_to_model(weights, tp)
    buf_weight = weights.new_zeros(E * C + 1).scatter(
        0, plan["dest"], weights.reshape(-1)[plan["order"]])[:E * C]

    if tp is not None:
        out = _tp_routed(p, xt, plan, buf_weight, moe_cfg, C, tp)
        if "shared_w_gate" in p:
            shared = swiglu_mlp(p, "shared", x, tp).reshape(T, d)
            gate_logit = xt @ p["shared_gate_w"]
            out = out + torch.sigmoid(gate_logit.to(torch.float32)).to(
                shared.dtype) * shared
        return out.reshape(B, S, d), aux * moe_cfg.router_aux_weight

    expert_in = _Dispatch.apply(xt, plan["buf_token"], plan["slots"])
    expert_in = expert_in.view(E, C, d)
    gate = torch.bmm(expert_in, p["experts_w_gate"])
    up = torch.bmm(expert_in, p["experts_w_up"])
    h = F.silu(gate) * up
    expert_out = torch.bmm(h, p["experts_w_down"])
    expert_out = expert_out * buf_weight.view(E, C, 1).to(expert_out.dtype)
    out = _Combine.apply(expert_out.view(E * C, d), plan["slots"],
                         plan["buf_token"])

    if "shared_w_gate" in p:
        shared = swiglu_mlp(p, "shared", x).reshape(T, d)
        gate_logit = xt @ p["shared_gate_w"]
        out = out + torch.sigmoid(gate_logit.to(torch.float32)).to(
            shared.dtype) * shared

    return out.reshape(B, S, d), aux * moe_cfg.router_aux_weight


def moe_form(moe_cfg, model: int) -> str:
    """How the experts split over a model axis of `model` ranks, as
    ``param_spec`` lays their leaves out: "EP" (whole experts a rank) when
    the experts divide it, else "M2" (every expert's d_ff columns) when
    d_ff does, else "whole"."""
    if moe_cfg.num_experts % model == 0:
        return "EP"
    return "M2" if moe_cfg.expert_d_ff % model == 0 else "whole"


def _tp_routed(p: Dict[str, torch.Tensor], xt: torch.Tensor, plan,
               buf_weight: torch.Tensor, moe_cfg, C: int, tp
               ) -> torch.Tensor:
    """The routed experts' output (T, d) over the model group `tp`: the
    rank's experts (EP: rows ``[e0 C, (e0 + E/m) C)`` of the buffer, each
    expert's GEMMs as the unsharded block runs them, in the activations'
    dtype) or every expert's d_ff columns (M2: gate and up on the rank's
    columns, down a float32 partial); the weighted slots added in slot
    order into a float32 (T, d) partial, summed over the group in model-
    index order and rounded once. The tokens enter in float32, so their
    cotangent (a partial of the rank's slots) is summed over the group."""
    T, d = xt.shape
    E, dt = moe_cfg.num_experts, xt.dtype
    e_loc = p["experts_w_gate"].shape[0]
    if e_loc == E and p["experts_w_gate"].shape[-1] == moe_cfg.expert_d_ff:
        raise NotImplementedError(
            f"the experts over a 'model' axis of {tp.model}: neither the "
            f"{E} experts nor their d_ff {moe_cfg.expert_d_ff} divide it")
    e0 = 0 if e_loc == E else tp.axis_index("model") * e_loc
    lo, hi = e0 * C, (e0 + e_loc) * C
    slots = plan["slots"]
    # the token's places outside the rank's rows point at the zero row
    local = torch.where((slots >= lo) & (slots < hi), slots - lo,
                        torch.full_like(slots, hi - lo))
    buf_token = plan["buf_token"][lo:hi]
    expert_in = _Dispatch.apply(tpar.enter_model(xt, tp), buf_token, local)
    expert_in = expert_in.to(dt).view(e_loc, C, d)
    gate = torch.bmm(expert_in, p["experts_w_gate"])
    up = torch.bmm(expert_in, p["experts_w_up"])
    h = F.silu(gate) * up
    w = buf_weight[lo:hi].view(e_loc, C, 1)
    if e_loc == E:   # M2: the rank's d_ff rows of w_down, a partial
        f32 = torch.float32
        out = torch.bmm(h.to(f32), p["experts_w_down"].to(f32)) * w
    else:
        out = torch.bmm(h, p["experts_w_down"])
        out = (out * w.to(out.dtype)).to(torch.float32)
    part = _Combine.apply(out.view(e_loc * C, d), local, buf_token)
    return tpar.reduce_from_model(part, tp, dt)
