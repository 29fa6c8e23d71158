"""Train-step factory of the port (``repro.train.train_step``): Algorithm 1
with M voters stacked on one device, or one voter per process over a
``distributed.mesh.ProcessMesh``.

    art = make_train_step(cfg, tcfg, n_voters)             # device "cuda"
    params, opt_state = materialize_state(cfg, tcfg, art, generator)
    params, opt_state, metrics = art.step_fn(params, opt_state, batch, step)

    # one voter per rank of an initialised torch.distributed world
    art = make_train_step(cfg, tcfg, mesh=ProcessMesh((4,), ("data",)))

``tcfg`` may be the reference's preset, ``configs.presets.default_train_
config(arch, cell)``: for glm4-9b, gemma3-12b, pixtral-12b and
qwen2-moe-a2.7b bf16 momentum on ``psum_int8``, 8 microbatches and
``remat="full"``; for mamba2-2.7b, zamba2-1.2b and whisper-tiny the same
with float32 momentum (4, 4 and 8 microbatches); for the Mode B archs
(qwen1.5-32b, deepseek-67b, qwen3-moe-235b-a22b) ``signsgd_vote`` with one
global float32 momentum on ``hierarchical``, 8 microbatches (qwen3-moe 4),
``remat="nested"`` and ``fsdp=True`` (the fused ZeRO backward below). The
batch's ``patch_embeds`` (pixtral) and ``enc_embeds`` (whisper) are cut
into voters' and microbatches' rows as its tokens are.
``tcfg.optimizer.kind`` picks the optimizer as the reference's
``build_optimizer`` does: the sign family
(Mode A or B, any beta, ``core.signum.make_sign_optimizer``) or a dense
baseline (``sgd`` / ``sgdm`` / ``adam``, ``make_dense_optimizer``).

One step:

1. for each voter r, on rows ``[r*B/M, (r+1)*B/M)`` of the global batch
   (the rows ``SyntheticLMPipeline.replica_batch`` gives replica r), cut
   into ``microbatches`` equal chunks: per chunk the loss (each decoder
   block checkpointed under ``remat``) and one backward pass over every
   leaf; with more than one chunk the gradients accumulate as the
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

``vote_strategy=auto`` resolves once, as in the reference's
``make_train_step``: ``core.vote_engine.select_strategy`` on the model's
parameter count, the data size (M for the stacked voters, the virtual
mesh), the pod size and the codec, under the H100 link model
(``distributed.comm_model``).

With ``OptimizerConfig.bucket_bytes`` > 0 (or -1, the priced ladder of
bucket sizes) a sign optimizer's step builds a ``core.vote_plan.VotePlan``
over every leaf, as the reference's ``make_train_step`` does
(``train/train_step.py:161-187``: the optimizer's codec map and its
configured strategy, so that AUTO prices each codec group's schedule,
``data_size = M`` and the parameters' dtype), and the optimizer votes
through its buckets (``core.signum``); ``art.plan`` is the plan and
``art.vote_strategy`` its groups' one strategy (None for a map whose
groups resolve differently).

``metrics["loss"]`` (and ``"ce"``, ``"aux"``) is the mean over the voters
of each voter's mean over its chunks. Unlike the JAX step, which returns
new arrays, this one updates `params` and `opt_state` in place (and
returns them): at full glm4-9b width that saves a second copy of the
momentum. At M = 1 it is the reference's ``make_train_step(cfg, tcfg,
mesh=None)`` step. ``tcfg.diagnostics`` adds the sign family's
``vote_agreement`` and ``vote_margin`` (``core.signum``) to the metrics,
as Python floats.

With ``mesh=`` (every rank of the world calls the step in lockstep) the M
= ``mesh.size`` voters are the ranks: rank r, replica index r over
``(pod, data)``, takes rows ``[r*B/M, (r+1)*B/M)`` of the global batch,
the rows voter r of the stacked step takes, keeps its own momentum (and
residual) leaf-shaped, and votes through the optimizer's mesh exchange
(``core.signum``); the plan, if any, is built with the mesh's data and
pod sizes. The metrics are the mean of every rank's (gathered in replica
order and averaged as the stacked step averages them), so the mesh step's
losses, parameters and states are the stacked step's bit for bit.

``tcfg.fsdp`` (the reference's ZeRO-3 path, ``fused = fsdp and mesh is not
None``): without a mesh at M = 1 it is ignored, as in the reference, and
the step is the ``fsdp=False`` step bit for bit. Over a mesh, the leaves
``distributed.sharding`` shards over ``"data"`` (``art.fused_leaves``:
the layers' matrices; not the embeddings) are held as slices: rank r
keeps slice ``data_index`` of ``data`` along each leaf's FSDP dim, of the
parameter, the global momentum and the dense ``m`` / ``v``
(``materialize_state``; ``distributed.sharding.shard_tree`` cuts full
arrays). The model gathers each layer's slices as it runs the layer
(``core.majority_vote.make_fsdp_hooks``) and the backward pass votes
inside the reduce-scatter, once per microbatch: the sign family sums the
ternary signs of every voter's whole gradient of that leaf and takes the
sign (ties 0), the dense baselines take the mean. The microbatches'
votes (means) accumulate as every gradient does (bf16 for the sign
family, float32 for the dense, divided by ``microbatches``), the
reference's "majority of microbatch votes", and the optimizer takes them
as voted (``core.signum``: no wire for them). Every rank asserts, once a
step, that all ranks issued these collectives in one order. The other
leaves vote on the configured wire as without fsdp.

With M > 1 voters stacked on one device, ``fsdp`` makes the same step
without a collective, its virtual form: per microbatch each voter's
ternary signs of each fused leaf's gradient (its adversary's, under no
step, for an adversarial voter) are summed into one int8 count per leaf
and microbatch, then each count's sign accumulates as above (the dense
baselines: the voters' gradients summed in their dtype and divided by
M). The mesh step is held to it bit for bit (the dense within its mean's
rounding). Mode A under fsdp: with momentum the reference refuses at
``materialize_state`` (its per-worker momentum spec names ``"data"``
twice), and so does the port, with the same error
(``sharding.DuplicateSpecError``); at beta = 0 the optimizer takes the
fused leaves' accumulated votes as gradients and votes them a second time
on the wire, as the reference's does: over a mesh each rank sends its
slice, so a slice's coordinate is voted against the same coordinate of
the other ranks' slices; stacked, voter r sends slice r (of M slices:
the stacked voters are a data axis of M) and every slice of the parameter
takes the vote (``core.signum``'s ``tiles``). Under a plan, whose leaves
have the whole parameters' shapes, the step raises the reference's
``ValueError`` at the first fused leaf's slice.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import (ModelConfig, MomentumMode, TrainConfig,
                                      VoteStrategy)
from repro_torch.core import byzantine, majority_vote, signum
from repro_torch.core import vote_plan as vp
from repro_torch.core.codecs.base import LeafShare
from repro_torch.core.vote_engine import resolve_strategy
from repro_torch.distributed import mesh as pm
from repro_torch.distributed import sharding as shd
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
    #: the vote axes over a mesh (empty for the stacked step)
    vote_axes: Tuple[str, ...] = ()
    #: every leaf's spec (``distributed.sharding.param_specs``)
    param_specs: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    #: {fused leaf: its FSDP dim} (``fsdp`` with M > 1)
    fused_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: this rank's data index and the data size (slices of fused leaves)
    data_index: int = 0
    data_size: int = 1
    #: this rank's mesh coordinates and the mesh's axis sizes (the blocks
    #: of ``param_specs`` it holds; empty for the stacked step)
    mesh_coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: whether the momentum is per voter (Mode A with beta > 0: one row a
    #: voter stacked, a rank's own row over a mesh)
    per_worker: bool = False

    @property
    def fused_leaves(self) -> Tuple[str, ...]:
        """The leaves the fused ZeRO backward votes, as the reference's
        ``StepArtifacts.fused_leaves``."""
        return tuple(self.fused_dims)


def _validate(tcfg: TrainConfig, n_voters: int) -> None:
    if tcfg.remat not in transformer.REMAT_MODES:
        raise ValueError(f"unknown remat {tcfg.remat!r}; the reference has "
                         f"{transformer.REMAT_MODES}")
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


def acc_dtype(tcfg: TrainConfig) -> torch.dtype:
    """The microbatch accumulator's dtype (the reference's ``acc_dt``): bf16
    for the sign family, where only the sign of the sum survives, float32
    for the dense baselines."""
    return (torch.bfloat16 if tcfg.optimizer.kind in signum.SIGN_KINDS
            else torch.float32)


#: the batch's stubbed frontend inputs, cut into rows with its tokens
FRONTEND_KEYS = ("patch_embeds", "enc_embeds")


def voter_grads(cfg: ModelConfig, tcfg: TrainConfig,
                params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                hook=None,
                on_fused: Optional[Callable[[int, str, torch.Tensor],
                                            None]] = None,
                extras: Optional[Dict[str, torch.Tensor]] = None,
                tp=None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One voter's gradients of every leaf on its rows `tokens` (and, for
    the VLM and the encoder-decoder, the same rows of each tensor of
    `extras`, the batch's ``patch_embeds`` or ``enc_embeds``) and
    its metrics (``loss``, ``ce``, ``aux``): one backward pass per microbatch,
    accumulated as the reference does (see the module doc). Each leaf's
    gradient is taken as soon as autograd has made it (a post-accumulate-
    grad hook): with one microbatch kept as it is, with more added into
    its accumulator and freed, so at most one leaf's gradient exists
    beside the accumulators (the same additions, in the same order, as
    adding whole gradients).
    `hook` is the model's parameter hook (the mesh's fused ZeRO backward,
    whose "gradients" are this rank's slices of the votes);
    `on_fused(i, name, g)`, when given, takes microbatch i's gradient of
    each leaf it names (``on_fused.leaves``) instead of the accumulator
    (the stacked step's virtual fused vote). Over a model group `tp` the
    loss is tensor-parallel and the gradients are the rank's slices'."""
    micro = tcfg.microbatches
    rows = tokens.shape[0] // micro
    taken = getattr(on_fused, "leaves", ())
    dtype = acc_dtype(tcfg)
    acc: Dict[str, torch.Tensor] = {}
    mets = []

    def folder(i: int, k: str):
        def fold(leaf: torch.Tensor) -> None:
            g, leaf.grad = leaf.grad, None
            if k in taken:
                on_fused(i, k, g)
            elif micro == 1:
                acc[k] = g
            elif k in acc:
                acc[k].add_(g.to(dtype))
            else:   # the reference's accumulator starts from zeros
                acc[k] = accumulate_(None, [g], dtype)[0]
        return fold

    for i in range(micro):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        mb = {"tokens": tokens[i * rows:(i + 1) * rows]}
        for k, v in (extras or {}).items():
            mb[k] = v[i * rows:(i + 1) * rows]
        loss, met = M.loss_fn(cfg, leaves, mb, hook=hook, remat=tcfg.remat,
                              tp=tp)
        for k, leaf in leaves.items():
            leaf.register_post_accumulate_grad_hook(folder(i, k))
        torch.autograd.backward(loss, inputs=list(leaves.values()))
        del leaves
        mets.append({"loss": loss.detach(), "ce": met["ce"].detach(),
                     "aux": met["aux"].detach()})
    if micro > 1:
        for a in acc.values():
            a.div_(micro)
    return ({k: acc[k] for k in params if k not in taken},
            {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]})


class StackedFusedVote:
    """The virtual form of the fused ZeRO backward for M voters stacked on
    one device: as each voter's microbatch gradients arrive
    (:meth:`__call__`, the ``on_fused`` of :func:`voter_grads`), the sign
    family adds its ternary signs into one ``count_dtype(M)`` count per
    microbatch and leaf (``majority_vote.add_fused_signs_``, each layer of a
    stacked leaf drawing its adversary alike), the dense baselines add the
    gradient into a sum in its dtype; :meth:`result` then gives each leaf's
    accumulated vote (mean) as the mesh's backward and accumulator make
    it."""

    def __init__(self, tcfg: TrainConfig, leaves: Sequence[str],
                 n_voters: int, byz):
        self.tcfg, self.leaves = tcfg, tuple(leaves)
        self.n_voters, self.byz = n_voters, byz
        self.vote = tcfg.optimizer.kind in signum.SIGN_KINDS
        self.voter = 0
        self.parts: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(tcfg.microbatches)]

    def __call__(self, i: int, k: str, g: torch.Tensor) -> None:
        part = self.parts[i]
        if self.vote:
            rows = g.shape[0] if k.startswith(("layers.", "encoder.")) else 1
            part[k] = majority_vote.add_fused_signs_(
                part.get(k), g, self.byz, self.voter, self.n_voters, rows)
            self.dtype = g.dtype
        elif k in part:
            part[k].add_(g)
        else:
            part[k] = g

    def result(self) -> Dict[str, torch.Tensor]:
        micro = self.tcfg.microbatches
        out = {}
        for k in self.leaves:
            acc = None
            for part in self.parts:
                # one microbatch's vote (mean), in the gradient's dtype
                if self.vote:
                    g = majority_vote.fused_vote(part.pop(k), self.dtype)
                else:
                    g = part.pop(k).div_(self.n_voters)
                if micro == 1:
                    acc = g
                    break
                acc = accumulate_(None if acc is None else [acc], [g],
                                  acc_dtype(self.tcfg))[0]
            out[k] = acc.div_(micro) if micro > 1 else acc
        return out


def _issued_order_check(hooks, axes) -> None:
    """Assert that every rank issued the fused backward's collectives in
    one order this step (a crc of the leaf names, in issue order)."""
    names = "\n".join(hooks.issued).encode()
    mine = torch.tensor([zlib.crc32(names), len(hooks.issued)],
                        dtype=torch.int64)
    hooks.issued.clear()
    every = pm.gather_voters(mine, axes)
    if not bool((every == mine).all()):
        raise AssertionError(
            "the ranks issued the fused ZeRO backward's collectives in "
            f"different orders: (crc, count) by rank {every.tolist()}")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, n_voters: int = 1,
                    device: DeviceLike = None,
                    mesh: Optional[pm.ProcessMesh] = None) -> StepArtifacts:
    """Build ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)`` for `n_voters` stacked voters on `device`
    (default ``"cuda"``; raises without a card unless ``device="cpu"``),
    or, with `mesh`, for this rank's voter of the mesh's ``mesh.size``
    (`n_voters` must then be 1 or that size)."""
    dev = resolve_device(device)
    axes = None
    model = 1 if mesh is None else mesh.model
    tp = mesh if model > 1 else None
    if tp is not None:
        _check_model_axis(cfg, tcfg, model)
    if mesh is not None:
        if n_voters not in (1, mesh.size):
            raise ValueError(f"n_voters={n_voters} on a mesh of "
                             f"{mesh.size} voters")
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is not in {mesh!r}")
        n_voters, axes = mesh.size, mesh.vote_axes
    _validate(tcfg, n_voters)
    opt_cfg = tcfg.optimizer
    is_sign = opt_cfg.kind in signum.SIGN_KINDS
    shapes = cfg.param_shapes()
    data, pod = (n_voters, 1) if mesh is None else (mesh.data, mesh.pod)
    # AUTO resolves here, once, under the link model, as the reference's
    # trainer resolves it: on the parameter count, the data and pod sizes
    # (M stacked voters are the virtual data axis) and the codec
    resolved = resolve_strategy(opt_cfg.vote_strategy, cfg.param_count(),
                                data, pod, codec=opt_cfg.resolved_codec)
    if resolved != opt_cfg.vote_strategy:
        opt_cfg = dataclasses.replace(opt_cfg, vote_strategy=resolved)
    sizes = {"pod": pod, "data": data, "model": model}
    specs = shd.param_specs(shapes, fsdp=tcfg.fsdp, mesh_shape=sizes)
    shares = ({k: LeafShare(mesh, "model" in spec, shd.model_dim(spec),
                            tuple(shapes[k]))
               for k, spec in specs.items()} if tp is not None else None)
    # the reference's fused = fsdp and mesh is not None; M stacked voters
    # are the virtual mesh
    fused = tcfg.fsdp and (mesh is not None or n_voters > 1)
    dims = shd.fused_dims(specs) if fused else {}
    mode_b = opt_cfg.momentum_mode == MomentumMode.GLOBAL
    # Mode A votes the fused leaves' accumulated votes again on the wire
    # (with momentum materialize_state refuses, as the reference's does)
    revote = bool(dims) and is_sign and not mode_b
    plan = None
    # the reference's plan: under Mode B the leaves the fused backward
    # does not vote (every leaf without fsdp), under Mode A every leaf;
    # its codec map and the configured (unresolved) strategy, so that AUTO
    # prices each codec group's whole schedule, over the M stacked voters
    explicit = {k: v for k, v in shapes.items()
                if not (mode_b and k in dims)}
    if opt_cfg.bucket_bytes != 0 and is_sign and explicit:
        plan = vp.build_plan(
            explicit, bucket_bytes=opt_cfg.bucket_bytes,
            codec_map=opt_cfg.codec_map,
            default_codec=opt_cfg.resolved_codec,
            strategy=tcfg.optimizer.vote_strategy, data_size=data,
            pod_size=pod,
            dtypes={k: cfg.dtype for k in explicit}, overlap=opt_cfg.overlap)
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
    # stacked, voter r sends slice r of each fused leaf (data = M)
    tiles = ({k: (d, data) for k, d in dims.items()}
             if revote and axes is None and not signum.per_worker(opt_cfg)
             else None)
    opt = signum.build_optimizer(opt_cfg, n_voters, plan, byz,
                                 tcfg.diagnostics, axes,
                                 () if revote else tuple(dims), tiles,
                                 shares)
    hooks = (majority_vote.make_fsdp_hooks(dims, axes, vote=is_sign, byz=byz)
             if dims and axes is not None else None)
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
        extras = {k: torch.as_tensor(batch[k], device=dev)
                  for k in FRONTEND_KEYS if batch.get(k) is not None}
        if tokens.shape[0] != tcfg.global_batch:
            raise ValueError(f"batch has {tokens.shape[0]} rows, expected "
                             f"global_batch={tcfg.global_batch}")
        wire = opt.wire(params, int(step))
        stacked = (StackedFusedVote(tcfg, dims, n_voters, byz)
                   if dims and axes is None else None)
        voters = []
        for r in (range(n_voters) if axes is None
                  else [pm.replica_index(axes)]):
            if stacked is not None:
                stacked.voter = r
            grads, met = voter_grads(
                cfg, tcfg, params, tokens[r * per:(r + 1) * per],
                hook=hooks, on_fused=stacked,
                extras={k: v[r * per:(r + 1) * per]
                        for k, v in extras.items()}, tp=tp)
            if hooks is not None and not revote:
                wire["voted"] = {k: grads.pop(k) for k in dims}
            opt.encode(r, grads, opt_state, wire)
            del grads
            voters.append(met)
        if hooks is not None:
            _issued_order_check(hooks, axes)
        if stacked is not None:
            voted = stacked.result()
            del stacked
            if revote:
                for r in range(n_voters):
                    opt.encode(r, shd.shard_tree(voted, dims, r, data),
                               opt_state, wire)
            else:
                wire["voted"] = voted
            del voted
        diag = opt.update(wire, opt_state, params, int(step))
        names = ("ce", "aux", "loss")
        if axes is None:
            metrics = {k: torch.stack([v[k] for v in voters]).mean()
                       for k in names}
        else:
            # every voter's metrics in replica order, averaged as above
            every = pm.gather_voters(torch.stack([voters[0][k]
                                                  for k in names]), axes)
            metrics = {k: every[:, i].contiguous().mean()
                       for i, k in enumerate(names)}
        metrics.update(diag)
        return params, opt_state, metrics

    return StepArtifacts(step_fn=step_fn, optimizer=opt, device=dev,
                         codec=tcfg.optimizer.resolved_codec,
                         n_voters=n_voters, vote_strategy=resolved,
                         plan=plan, vote_axes=tuple(axes or ()),
                         param_specs=specs, fused_dims=dims,
                         data_index=(0 if mesh is None
                                     else mesh.axis_index("data")),
                         data_size=data,
                         mesh_coords=({} if mesh is None
                                      else dict(mesh.coords)),
                         mesh_sizes={} if mesh is None else sizes,
                         per_worker=signum.per_worker(opt_cfg))


def _check_model_axis(cfg: ModelConfig, tcfg: TrainConfig,
                      model: int) -> None:
    """Raise ``NotImplementedError`` for a leaf layout the port cannot run
    over a model axis of `model` ranks (``models.model.check_model_axis``;
    no arch of the repo meets one). Every adversary and a VotePlan run
    there; an adaptive mode raises the reference's ``ValueError`` at the
    step's call, as without a model axis."""
    M.check_model_axis(cfg, model)


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
    place the port's layout differs (ef_sign's residual at beta = 0).

    Over a mesh with fused leaves (``fsdp``) each fused leaf is this rank's
    slice (``art.data_index`` of ``art.data_size`` along its FSDP dim),
    drawn whole and cut leaf by leaf, so every rank holds the slices of the
    same full parameters; the state follows the parameters' shapes. Over a
    model axis each leaf is the block its spec gives this rank (its
    ``"model"`` dim cut by the model index, its ``"data"`` dim under fsdp
    by the data index). Mode A
    with momentum under fsdp raises here, as the reference's does: its
    per-worker momentum would be sharded over ``"data"`` twice."""
    dev = art.device if device is None else resolve_device(device)
    if dev != art.device:
        raise ValueError(f"state on {dev} but the step runs on {art.device}")
    shard = _rank_blocks(tcfg, art)
    params = M.init_params(cfg, generator, dev, shard=shard)
    return params, art.optimizer.init(params)


def _rank_blocks(tcfg: TrainConfig, art: StepArtifacts
                 ) -> Optional[Callable[[str, torch.Tensor], torch.Tensor]]:
    """`shard(name, full)`, the copy of this rank's block of a leaf, where
    the rank holds blocks (a mesh with fused leaves or a model axis), else
    None; raises for Mode A with momentum under fsdp (see
    :func:`materialize_state`)."""
    if art.fused_dims and signum.per_worker(tcfg.optimizer):
        lead = tuple(art.vote_axes) or ("data",)
        for k in art.fused_dims:
            shd.check_spec((lead,) + tuple(art.param_specs[k]))
    if not (art.mesh_sizes and (art.fused_dims
                                or art.mesh_sizes.get("model", 1) > 1)):
        return None

    def shard(name: str, t: torch.Tensor) -> torch.Tensor:
        return shd.shard_leaf(t, art.param_specs[name], art.mesh_coords,
                              art.mesh_sizes).clone()
    return shard


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig, art: StepArtifacts,
                   mesh: Optional[pm.ProcessMesh] = None) -> Tuple[Any, Any]:
    """(params, opt_state) of this rank as "meta" tensors, for the dry run
    (``launch.dryrun``; the reference's ``abstract_state``,
    ``train_step.py:331-398``): the keys, shapes and dtypes
    :func:`materialize_state` gives on a real rank (its blocks over a mesh,
    fsdp slices and model blocks, every optimizer's state), with no draw
    and no memory. `mesh`, when given, must be the one `art` was built
    over."""
    if mesh is not None and dict(mesh.coords) != art.mesh_coords:
        raise ValueError(f"the step was built for coordinates "
                         f"{art.mesh_coords}, not {mesh.coords}")
    shard = _rank_blocks(tcfg, art)
    params = {}
    for name, shape in sorted(cfg.param_shapes().items()):
        full = torch.empty(shape, dtype=M.param_dtype(cfg, name),
                           device="meta")
        params[name] = full if shard is None else shard(name, full)
    return params, art.optimizer.init(params)
