"""Model API of the port, dense family (``repro.models.model``):

  init_params(cfg, generator, device)   -> flat param dict (stacked layout)
  params_from_numpy(arrays, device)     -> the same dict from numpy arrays
  forward_logits(cfg, params, batch, remat=...) -> ((B, S, V) logits, aux)
  loss_fn(cfg, params, batch, remat=...)        -> (scalar loss, metrics)

Parameters are a flat ``dict[str, Tensor]`` under the JAX package's names
and in its stacked layout (``layers.attn_wq`` is ``(L, d, H*hd)``), so
parameters and momentum carry across between the packages by name.
Batches are dicts with ``tokens`` (B, S) integer tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchFamily, ModelConfig
from repro_torch.models import layers as L, transformer

_BIAS_SUFFIXES = ("_b", "_bq", "_bk", "_bv", "_conv_b", "dt_bias")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != ArchFamily.DENSE:
        raise NotImplementedError(
            f"the port runs the dense family only, not {cfg.family.value!r} "
            f"({cfg.name}); other families arrive with the rest of the "
            "model zoo (ROADMAP.md Queue 1 item 11)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's init rules: names in sorted order, ones for scales,
    zeros for biases, ``normal * 1/sqrt(fan_in)`` drawn in float32 from
    `generator` (which must live on `device`) and then cast.

    The draws differ from ``jax.random``'s; tests that compare the two
    packages init in the JAX package and carry the arrays across with
    :func:`params_from_numpy`."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params = {}
    for name, shape in sorted(cfg.param_shapes().items()):
        if name.endswith("_scale") or ".scale" in name:
            params[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif name.endswith(_BIAS_SUFFIXES):
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            params[name] = w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
    return params


def params_from_numpy(arrays: Mapping[str, Any], device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """numpy arrays (e.g. ``np.asarray`` of the JAX package's parameters or
    momentum) -> tensors on `device`, dtype kept (bfloat16 included).

    The tensors own copies: the train step updates them in place."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.array(a, order="C")
        if a.dtype.name == "bfloat16":   # ml_dtypes: no torch.from_numpy
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(dev)
    return out


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward_logits(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], remat: str = "none"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V) in the parameter dtype, aux_loss scalar);
    `remat` checkpoints each decoder block (``transformer.maybe_remat``)."""
    _require_dense(cfg)
    h = L.embed_tokens(params["embed.table"], batch["tokens"])
    h, aux = transformer.decoder_stack(params, h, cfg, remat=remat)
    h = L.rms_norm(h, params["final_norm.scale"], cfg.norm_eps)
    table = params.get("unembed.table", params["embed.table"])
    return h @ table.T, aux


def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward_logits(cfg, params, batch, remat=remat)
    tokens = batch["tokens"]
    ce = L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
    return ce + aux, {"ce": ce, "aux": aux}
