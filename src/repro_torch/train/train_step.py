"""Train-step factory of the port (``repro.train.train_step``): Algorithm 1
with M voters stacked on one device.

    art = make_train_step(cfg, tcfg, n_voters)             # device "cuda"
    params, opt_state = materialize_state(cfg, tcfg, art, generator)
    params, opt_state, metrics = art.step_fn(params, opt_state, batch, step)

``tcfg`` may be the reference's preset, ``configs.presets.default_train_
config(arch, cell)``: for glm4-9b bf16 momentum on ``psum_int8``, 8
microbatches and ``remat="full"``; for the Mode B archs (qwen1.5-32b)
``signsgd_vote`` with one global float32 momentum on ``hierarchical``,
8 microbatches and ``remat="nested"`` (their ``fsdp=True`` raises: pass
``dataclasses.replace(tcfg, fsdp=False)``). ``tcfg.optimizer.kind`` picks
the optimizer as the reference's ``build_optimizer`` does: the sign family
(Mode A or B, any beta, ``core.signum.make_sign_optimizer``) or a dense
baseline (``sgd`` / ``sgdm`` / ``adam``, ``make_dense_optimizer``).

One step:

1. for each voter r, on rows ``[r*B/M, (r+1)*B/M)`` of the global batch
   (the rows ``SyntheticLMPipeline.replica_batch`` gives replica r), cut
   into ``microbatches`` equal chunks: per chunk the loss (each decoder
   block checkpointed under ``remat``) and ``torch.autograd.grad`` over
   every leaf; with more than one chunk the gradients accumulate as the
   reference's ``acc_body`` scan has them (an accumulator from zeros,
   ``acc + g.to(acc.dtype)`` chunk by chunk, then ``acc / microbatches``:
   bf16 for the sign family, where only the sign of the sum survives, and
   float32 for the dense baselines), one leaf-sized buffer per leaf. Then
   per leaf the optimizer's encode (``core.signum``): for the sign family
   the codec's momentum + sign + pack kernels, which update voter r's
   momentum row in place (if it has one) and write its words into row r of
   the leaf's (M, w) buffer; for the dense baselines an add into the
   voters' gradient sum. The gradients are freed before the next voter;
2. per leaf, the tally kernel and the vote-apply kernel (Mode B: through
   the global momentum), updating the parameters in place, and the
   codec's feedback; or the dense update of the mean gradient.

``tcfg.byzantine`` makes the voters below its ``num_adversaries``
adversarial in the sign family's vote (``core.signum``), keyed by the step
and salt 0; at M = 1 it does nothing, as in the reference without a mesh.
An adaptive mode (``adaptive_flip``, ``low_margin``, ``reputation``) has no
observation channel on the trainer's vote: as the reference's tree-form
``VoteRequest`` does, a sign-family step then raises ``ValueError`` when it
is called, at any M; the dense baselines ignore the mode and train.
``tcfg.loss_dtype`` is accepted and ignored, as in the reference.

With ``OptimizerConfig.bucket_bytes > 0`` a sign optimizer's step builds a
``core.vote_plan.VotePlan`` over every leaf, as the reference's
``make_train_step`` does (``train/train_step.py:161-187``: the
optimizer's codec map and strategy, ``data_size = M``, since the stacked
voters are the virtual mesh, and the parameters' dtype), and the
optimizer votes through its buckets (``core.signum``); ``art.plan`` is
the plan and ``art.vote_strategy`` its groups' one strategy (None for a
map whose groups resolve differently).

``metrics["loss"]`` (and ``"ce"``, ``"aux"``) is the mean over the voters
of each voter's mean over its chunks. Unlike the JAX step, which returns
new arrays, this one updates `params` and `opt_state` in place (and
returns them): at full glm4-9b width that saves a second copy of the
momentum. At M = 1 it is the reference's ``make_train_step(cfg, tcfg,
mesh=None)`` step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig, VoteStrategy
from repro_torch.core import byzantine, signum
from repro_torch.core import vote_plan as vp
from repro_torch.models import model as M, transformer


@dataclasses.dataclass
class StepArtifacts:
    """The step function, its optimizer (whose ``init`` builds the state),
    its device and its resolved gradient codec."""

    step_fn: Callable
    optimizer: signum.Optimizer
    device: torch.device
    codec: str = "sign1bit"
    #: voters stacked on the device (the reference's ``n_vote_replicas``)
    n_voters: int = 1
    #: resolved (never AUTO), as the reference's ``StepArtifacts`` has it
    #: (under a plan its groups' one strategy, None for a mixed map)
    vote_strategy: Optional[VoteStrategy] = None
    #: the bucketed vote plan (``OptimizerConfig.bucket_bytes > 0``)
    plan: Optional[vp.VotePlan] = None


def _validate(tcfg: TrainConfig, n_voters: int) -> None:
    def todo(what: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue 4 item 4: "
            "trainer options of the launcher)")
    if tcfg.remat not in transformer.REMAT_MODES:
        todo(f"remat={tcfg.remat!r}")
    if tcfg.fsdp:
        # with a mesh the reference's fused ZeRO backward votes inside the
        # reduce-scatter (majority of the microbatches' votes); that needs
        # the multi-process wire
        todo("fsdp=True (the fused ZeRO backward's vote)")
    if tcfg.diagnostics:
        todo("vote diagnostics")
    if n_voters < 1 or tcfg.global_batch % n_voters:
        raise ValueError(f"global_batch {tcfg.global_batch} must split "
                         f"evenly over n_voters={n_voters}")
    if tcfg.microbatches < 1 or (tcfg.global_batch // n_voters
                                 ) % tcfg.microbatches:
        raise ValueError(f"each voter's {tcfg.global_batch // n_voters} "
                         f"rows must split evenly into microbatches="
                         f"{tcfg.microbatches}")


def accumulate_(acc: Optional[List[torch.Tensor]],
                grads: Sequence[torch.Tensor],
                dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """One microbatch of the reference's ``acc_body``: ``acc +
    g.to(acc.dtype)`` in place, each leaf rounded to the accumulator's
    dtype (from zeros of `dtype` when `acc` is None: bf16 for the sign
    family, float32 for the dense baselines, the reference's ``acc_dt``)."""
    if acc is None:
        acc = [torch.zeros_like(g, dtype=dtype) for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g.to(a.dtype))
    return acc


def voter_grads(cfg: ModelConfig, tcfg: TrainConfig,
                params: Dict[str, torch.Tensor], tokens: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One voter's gradients of every leaf on its rows `tokens` and its
    metrics (``loss``, ``ce``, ``aux``): one ``autograd.grad`` per
    microbatch, accumulated as the reference does (see the module doc)."""
    micro = tcfg.microbatches
    rows = tokens.shape[0] // micro
    acc_dtype = (torch.bfloat16 if tcfg.optimizer.kind in signum.SIGN_KINDS
                 else torch.float32)
    acc, mets = None, []
    for i in range(micro):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, met = M.loss_fn(cfg, leaves,
                              {"tokens": tokens[i * rows:(i + 1) * rows]},
                              remat=tcfg.remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        acc = (list(grads) if micro == 1
               else accumulate_(acc, grads, acc_dtype))
        del grads
        mets.append({"loss": loss.detach(), "ce": met["ce"].detach(),
                     "aux": met["aux"].detach()})
    if micro > 1:
        for a in acc:
            a.div_(micro)
    return (dict(zip(params, acc)),
            {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]})


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, n_voters: int = 1,
                    device: DeviceLike = None) -> StepArtifacts:
    """Build ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)`` for `n_voters` stacked voters on `device`
    (default ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    _validate(tcfg, n_voters)
    opt_cfg = tcfg.optimizer
    plan = None
    if opt_cfg.bucket_bytes != 0 and opt_cfg.kind in signum.SIGN_KINDS:
        # the reference's plan: every leaf (Mode A, and Mode B, whose
        # leaves all vote explicitly without fsdp), its codec map and the
        # configured (unresolved) strategy, over the M stacked voters
        shapes = cfg.param_shapes()
        plan = vp.build_plan(
            shapes, bucket_bytes=opt_cfg.bucket_bytes,
            codec_map=opt_cfg.codec_map,
            default_codec=opt_cfg.resolved_codec,
            strategy=opt_cfg.vote_strategy, data_size=n_voters,
            pod_size=1, dtypes={k: cfg.dtype for k in shapes},
            overlap=opt_cfg.overlap)
    # the voters below num_adversaries act adversarially (salt 0, keyed by
    # the step), as the reference's trainer passes its byzantine config to
    # build_optimizer; at M = 1 the reference (mesh=None) has no vote axes
    # and applies no adversary, and nor does the port
    byz = (tcfg.byzantine if tcfg.byzantine.mode != "none" and n_voters > 1
           else None)
    adaptive = (opt_cfg.kind in signum.SIGN_KINDS
                and tcfg.byzantine.mode in byzantine.ATTACK_MODES)
    if adaptive:
        byz = None
    opt = signum.build_optimizer(opt_cfg, n_voters, plan, byz)
    resolved = opt.strategy
    if plan is not None:
        group_strats = {g.strategy for g in plan.groups}
        resolved = group_strats.pop() if len(group_strats) == 1 else None
    per = tcfg.global_batch // n_voters

    def step_fn(params: Dict[str, torch.Tensor], opt_state: Dict, batch,
                step) -> Tuple[Dict[str, torch.Tensor], Dict, Dict]:
        if adaptive:
            # the reference's tree-form VoteRequest refuses the mode
            raise ValueError(
                f"adaptive adversary mode {tcfg.byzantine.mode!r} observes "
                "the previous round's flat broadcast vote; the 'tree' form "
                "has no such observation channel (use the stacked or "
                "streamed form)")
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if tokens.shape[0] != tcfg.global_batch:
            raise ValueError(f"batch has {tokens.shape[0]} rows, expected "
                             f"global_batch={tcfg.global_batch}")
        wire = opt.wire(params, int(step))
        voters = []
        for r in range(n_voters):
            grads, met = voter_grads(cfg, tcfg, params,
                                     tokens[r * per:(r + 1) * per])
            opt.encode(r, grads, opt_state, wire)
            del grads
            voters.append(met)
        opt.update(wire, opt_state, params, int(step))
        metrics = {k: torch.stack([v[k] for v in voters]).mean()
                   for k in ("ce", "aux", "loss")}
        return params, opt_state, metrics

    return StepArtifacts(step_fn=step_fn, optimizer=opt, device=dev,
                         codec=tcfg.optimizer.resolved_codec,
                         n_voters=n_voters, vote_strategy=resolved,
                         plan=plan)


def materialize_state(cfg: ModelConfig, tcfg: TrainConfig,
                      art: StepArtifacts, generator: torch.Generator,
                      device: DeviceLike = None) -> Tuple[Any, Any]:
    """Concrete (params, opt_state) on the step's device: parameters drawn
    from `generator` by the reference's init rules, and the optimizer's
    zero state laid out key for key as the reference's ``abstract_state``
    (``train_step.py:331-400``): ``"count"``; for the sign family the
    momentum in ``momentum_dtype`` when beta > 0, ``(M, *leaf_shape)``
    under Mode A and leaf-shaped under Mode B, a zero ``"error"`` residual
    for ``ef_sign`` (one row per voter; under a plan for its ``ef_sign``
    leaves only), ``"codec": {"flip_ema": (M,) float32 zeros}`` for
    ``weighted_vote`` (or a plan that maps a leaf to it) and
    ``"delayed"``, one zero int8 tensor per leaf, for ``delayed_vote``;
    for the dense baselines float32 leaf-shaped ``"m"`` (``sgdm``,
    ``adam``) and ``"v"`` (``adam``). See ``core.signum`` for the one
    place the port's layout differs (ef_sign's residual at beta = 0)."""
    dev = art.device if device is None else resolve_device(device)
    if dev != art.device:
        raise ValueError(f"state on {dev} but the step runs on {art.device}")
    params = M.init_params(cfg, generator, dev)
    return params, art.optimizer.init(params)
