"""Hot checkpoint swap: trainer-side emitter, server-side watcher
(``repro.serve.swap``).

The handoff rides the port's checkpoint layer unchanged: atomic
``step_<k>.tmp`` + ``os.rename`` saves and the ``LATEST`` pointer file, so
a watcher polling mid-save never observes a torn checkpoint, and the
on-disk layout is the reference's (either package reads what the other
published). The emitter writes a params-only checkpoint (optimizer state
stays with the trainer) stamped with a monotonic ``param_version``; the
watcher notices a moved ``LATEST`` pointer between decode ticks, restores
through ``checkpoint.restore(like_params=...)`` (the refit path elastic
restores use) and hands the engine a :class:`ParamUpdate` to install
between steps.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class ParamUpdate:
    """One swap-ready parameter dict (tensors on the watcher's device) and
    its provenance."""

    params: Any
    version: int
    step: int
    path: str


def like_tree(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params``' shapes and dtypes as "meta" tensors: the
    ``like_params`` a watcher restores against (structure checked, leading
    axes refit) without holding a second copy of the weights."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in params.items()}


class CheckpointEmitter:
    """Trainer side: publish params for serving every few steps.

    Writes through :func:`checkpoint.save` with an empty optimizer tree,
    so the serve directory holds only what the server needs, and stamps
    ``param_version`` into the step meta (monotonic per emitter; the
    engine tags every step record with the version it decoded under)."""

    def __init__(self, serve_dir: str):
        os.makedirs(serve_dir, exist_ok=True)
        self.serve_dir = serve_dir
        self._version = 0

    def emit(self, step: int, params: Dict[str, torch.Tensor], *,
             version: Optional[int] = None,
             meta: Optional[Dict] = None) -> str:
        """Blocking atomic publish; returns the step directory."""
        v = self._version + 1 if version is None else int(version)
        path = checkpoint.save(
            self.serve_dir, step, params, {},
            meta={"param_version": v, **(meta or {})})
        self._version = v
        return path


class CheckpointWatcher:
    """Server side: poll the serve directory between decode ticks.

    :meth:`poll` is cheap when nothing changed (one pointer-file read); on
    a new checkpoint it restores the params onto `device` (``cuda`` unless
    told otherwise) and returns a :class:`ParamUpdate` for the engine to
    install. Each checkpoint is surfaced at most once."""

    def __init__(self, serve_dir: str, like_params: Any = None,
                 device: DeviceLike = None):
        self.serve_dir = serve_dir
        self.like_params = like_params
        self.device = resolve_device(device)
        self._seen: Optional[str] = None

    def poll(self) -> Optional[ParamUpdate]:
        path = checkpoint.latest_step_dir(self.serve_dir)
        if path is None or path == self._seen:
            return None
        params, _, _, meta = checkpoint.restore(
            self.serve_dir, like_params=self.like_params, device=self.device)
        self._seen = path
        return ParamUpdate(
            params=params,
            version=int(meta.get("param_version", meta.get("step", 0))),
            step=int(meta.get("step", -1)),
            path=path)


__all__ = ["CheckpointEmitter", "CheckpointWatcher", "ParamUpdate",
           "like_tree"]
