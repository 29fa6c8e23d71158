"""Train-step factory of the port (``repro.train.train_step``): Algorithm 1
with M voters stacked on one device.

    art = make_train_step(cfg, tcfg, n_voters)             # device "cuda"
    params, opt_state = materialize_state(cfg, tcfg, art, generator)
    params, opt_state, metrics = art.step_fn(params, opt_state, batch, step)

One step:

1. for each voter r, on rows ``[r*B/M, (r+1)*B/M)`` of the global batch
   (the rows ``SyntheticLMPipeline.replica_batch`` gives replica r):
   the loss, ``torch.autograd.grad`` over every leaf, then per leaf the
   momentum + sign + pack kernel, which updates voter r's momentum row in
   place and writes its words into row r of the leaf's (M, w) buffer (the
   codec's encode: ``core.signum``); the gradients are freed before the
   next voter;
2. per leaf, the majority kernel and the vote-apply kernel, updating the
   parameters in place, and the codec's feedback.

``metrics["loss"]`` is the mean of the voters' losses. Unlike the JAX
step, which returns new arrays, this one updates `params` and `opt_state`
in place (and returns them): at full glm4-9b width that saves a second
copy of the 26 GB momentum. At M = 1 it is the reference's
``make_train_step(cfg, tcfg, mesh=None)`` step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import signum
from repro_torch.models import model as M


@dataclasses.dataclass
class StepArtifacts:
    """The step function, its optimizer (whose ``init`` builds the state),
    its device and its resolved gradient codec."""

    step_fn: Callable
    optimizer: signum.Optimizer
    device: torch.device
    codec: str = "sign1bit"


def _validate(tcfg: TrainConfig, n_voters: int) -> None:
    def todo(what: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md Queue 4 item 4: "
            "trainer options of the launcher)")
    if tcfg.microbatches != 1:
        todo(f"microbatches={tcfg.microbatches}")
    if tcfg.remat != "none":
        todo(f"remat={tcfg.remat!r}")
    if tcfg.fsdp:
        todo("fsdp=True")
    if tcfg.diagnostics:
        todo("vote diagnostics")
    if tcfg.loss_dtype != "float32":
        todo(f"loss_dtype={tcfg.loss_dtype!r}")
    if tcfg.byzantine.mode != "none":
        raise NotImplementedError(
            f"byzantine mode {tcfg.byzantine.mode!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 6)")
    if n_voters < 1 or tcfg.global_batch % n_voters:
        raise ValueError(f"global_batch {tcfg.global_batch} must split "
                         f"evenly over n_voters={n_voters}")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, n_voters: int = 1,
                    device: DeviceLike = None) -> StepArtifacts:
    """Build ``step_fn(params, opt_state, batch, step) -> (params,
    opt_state, metrics)`` for `n_voters` stacked voters on `device`
    (default ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    _validate(tcfg, n_voters)
    opt = signum.make_sign_optimizer(tcfg.optimizer, n_voters)
    per = tcfg.global_batch // n_voters

    def step_fn(params: Dict[str, torch.Tensor], opt_state: Dict, batch,
                step) -> Tuple[Dict[str, torch.Tensor], Dict, Dict]:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if tokens.shape[0] != tcfg.global_batch:
            raise ValueError(f"batch has {tokens.shape[0]} rows, expected "
                             f"global_batch={tcfg.global_batch}")
        wire = opt.wire(params)
        losses, ces, auxes = [], [], []
        for r in range(n_voters):
            leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
            loss, met = M.loss_fn(cfg, leaves,
                                  {"tokens": tokens[r * per:(r + 1) * per]})
            grads = torch.autograd.grad(loss, list(leaves.values()))
            opt.encode(r, dict(zip(leaves, grads)), opt_state, wire)
            del grads, leaves
            losses.append(loss.detach())
            ces.append(met["ce"].detach())
            auxes.append(met["aux"].detach())
        opt.update(wire, opt_state, params, int(step))
        metrics = {"ce": torch.stack(ces).mean(),
                   "aux": torch.stack(auxes).mean(),
                   "loss": torch.stack(losses).mean()}
        return params, opt_state, metrics

    return StepArtifacts(step_fn=step_fn, optimizer=opt, device=dev,
                         codec=tcfg.optimizer.resolved_codec)


def materialize_state(cfg: ModelConfig, tcfg: TrainConfig,
                      art: StepArtifacts, generator: torch.Generator,
                      device: DeviceLike = None) -> Tuple[Any, Any]:
    """Concrete (params, opt_state) on the step's device: parameters drawn
    from `generator` by the reference's init rules, zero momentum
    ``(M, *leaf_shape)`` float32, and the codec's state as the reference
    lays it out (``train_step.py:375-390``): a zero ``"error"`` residual
    shaped like the momentum for ``ef_sign``, ``"codec": {"flip_ema":
    (M,) float32 zeros}`` for ``weighted_vote``."""
    dev = art.device if device is None else resolve_device(device)
    if dev != art.device:
        raise ValueError(f"state on {dev} but the step runs on {art.device}")
    params = M.init_params(cfg, generator, dev)
    return params, art.optimizer.init(params)
