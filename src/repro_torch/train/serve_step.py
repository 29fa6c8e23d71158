"""Serving steps on one device (``repro.train.serve_step``, its
single-device builders): the decode step, the prefill, and the re-home of
a prefill cache into a decode cache.

Serving needs no vote. The reference jits these under auto SPMD; the port
runs them eagerly, the decode step writing its cache in place as the
reference donates it, so a multi-GB cache never exists twice. The
reference's cache and parameter shardings, its sharded prefill and its
abstract serve inputs place work over a mesh's "model" axis: a
``mesh_shape`` with a "model" axis of size > 1 raises here, as the port's
``sharding.param_spec`` does (ROADMAP.md Queue 1 item 14); any other runs
on the one device.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _one_device(mesh_shape: Optional[Mapping[str, int]]) -> None:
    if mesh_shape and mesh_shape.get("model", 1) > 1:
        raise NotImplementedError(
            "serving over a 'model' axis of size > 1 (the sequence-sharded "
            "flash decode, the cache and parameter shardings) is not ported "
            "yet (ROADMAP.md Queue 1 item 14)")


def make_decode_step(cfg: ModelConfig,
                     mesh_shape: Optional[Mapping[str, int]] = None
                     ) -> Callable:
    """``step(params, tokens, cache, pos) -> (logits, cache)``: one token
    for each row of the batch (``model.decode_step``), the cache advanced
    in place."""
    _one_device(mesh_shape)

    def step(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos)
    return step


def make_cache_rehome(cfg: ModelConfig, batch: int, max_len: int
                      ) -> Callable:
    """``rehome(cache) -> cache``: a prefill cache moved into a fresh
    ``max_len`` one, leaf by leaf by *shape*, not by name, as the
    reference's:

    * a leaf already at its target shape (the recurrent ``ssm`` / ``conv``
      state, a cross-attention K / V as long as the target's) passes
      through, the same tensor: a prompt's SSM state is the decode state;
    * a shorter leaf (attention K / V, their int8 scales, a cross K / V
      over fewer source frames) is copied into the zero target at the
      origin;
    * a leaf longer than its target on any dim, or a cache whose leaves
      are not the serving cache's, raises ``ValueError``.
    The target lives on each leaf's device."""
    full_abs = M.init_cache(cfg, batch, max_len, device="meta")

    def rehome(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if set(cache) != set(full_abs):
            raise ValueError(
                f"cache structure mismatch: got {sorted(cache)}, "
                f"serving cache has {sorted(full_abs)}")
        out = {}
        for k, want in full_abs.items():
            src = cache[k].to(want.dtype)
            if src.shape == want.shape:
                out[k] = src
                continue
            if src.ndim != want.ndim or any(
                    s > d for s, d in zip(src.shape, want.shape)):
                raise ValueError(
                    f"cache leaf {k!r} {tuple(src.shape)} does not fit the "
                    f"max_len={max_len} serving cache {tuple(want.shape)}")
            dst = torch.zeros(want.shape, dtype=want.dtype,
                              device=src.device)
            dst[tuple(slice(0, s) for s in src.shape)] = src
            out[k] = dst
        return out
    return rehome


def make_prefill(cfg: ModelConfig,
                 mesh_shape: Optional[Mapping[str, int]] = None
                 ) -> Callable:
    """``step(params, batch) -> (logits, cache)``: ``model.prefill``."""
    _one_device(mesh_shape)

    def step(params, batch):
        return M.prefill(cfg, params, batch)
    return step


__all__ = ["make_cache_rehome", "make_decode_step", "make_prefill"]
