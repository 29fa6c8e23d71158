"""Parameter sharding rules (``repro.distributed.sharding``, its parameter
half): which dim of each leaf is FSDP-sharded over ``"data"``.

A spec is a tuple with one entry per dim: ``"data"`` (ZeRO-3 sharded over
the data axis), ``"model"`` (tensor parallel) or None (replicated); there
is no ``PartitionSpec``. The rules and their fallbacks are the
reference's (``src/repro/distributed/sharding.py:94-195``): an ``"F"`` tag
becomes ``"data"`` only with ``fsdp``, and any sharded entry whose dim
does not divide by its axis size is dropped. The leaves whose spec names
``"data"`` are what the reference's trainer calls ``fused_leaves``: the
fused ZeRO backward votes them (``core.majority_vote.make_fsdp_hooks``).

The ``"model"`` entries are carried for parity and do nothing: the port
has no tensor parallelism, and a model axis of size > 1 raises (ROADMAP.md
Queue 1 item 14). The activation helper ``shard`` (an identity without
XLA) and ``kv_cache_spec`` (serving) are not ported.

A rank of a ``ProcessMesh`` holds slice ``data_index`` of ``data`` equal
slices of each fused leaf along its FSDP dim; pod replicas hold the same
slice. :func:`shard_tree` cuts full parameters (numpy arrays or tensors)
into one rank's slices and :func:`join_shards` puts them back together.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]

# Legend for the rules' tags: "M" = 'model' (TP/EP), "F" = 'data' (FSDP),
# "M2" = 'model' only when the "M" dim dropped, None = replicated. The
# embeddings are deliberately not FSDP-sharded (the reference's note: a
# vocab-sharded, d-FSDP table forces a full rematerialisation); their
# gradients take the explicit per-leaf vote instead.
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"^embed\.table$", ("M", None)),
    (r"^unembed\.table$", ("M", None)),
    (r"^enc_embed\.pos$", (None, None)),
    # attention (stacked: leading L axis)
    (r"\.attn_wq$|\.xattn_wq$", (None, "F", "M")),
    (r"\.attn_wk$|\.xattn_wk$", (None, "F", "M")),
    (r"\.attn_wv$|\.xattn_wv$", (None, "F", "M")),
    (r"\.attn_wo$|\.xattn_wo$", (None, "M", "F")),
    (r"\.attn_b[qkv]$|\.xattn_b[qkv]$", (None, "M")),
    # dense mlp / shared-expert mlp (stacked)
    (r"\.(mlp|shared)_w_gate$", (None, "F", "M")),
    (r"\.(mlp|shared)_w_up$", (None, "F", "M")),
    (r"\.(mlp|shared)_w_down$", (None, "M", "F")),
    (r"\.shared_gate_w$", (None, "F", None)),
    # MoE experts: expert axis over model, else the per-expert d_ff
    (r"\.experts_w_gate$", (None, "M", "F", "M2")),
    (r"\.experts_w_up$", (None, "M", "F", "M2")),
    (r"\.experts_w_down$", (None, "M", "M2", "F")),
    (r"\.router_w$", (None, "F", None)),
    # mamba2 (stacked): inner dim over model
    (r"\.mamba_(zproj|xbcproj|dtproj)$", (None, "F", "M")),
    (r"\.mamba_out_proj$", (None, "M", "F")),
    (r"\.mamba_conv_w$", (None, None, "M")),
    (r"\.mamba_conv_b$", (None, "M")),
    (r"\.mamba_norm_scale$", (None, "M")),
    (r"\.mamba_(dt_bias|A_log|D)$", (None, "M")),
    # zamba2 shared block (no leading L axis)
    (r"^shared_block\.attn_wq$", ("F", "M")),
    (r"^shared_block\.attn_wk$", ("F", "M")),
    (r"^shared_block\.attn_wv$", ("F", "M")),
    (r"^shared_block\.attn_wo$", ("M", "F")),
    (r"^shared_block\.mlp_w_gate$", ("F", "M")),
    (r"^shared_block\.mlp_w_up$", ("F", "M")),
    (r"^shared_block\.mlp_w_down$", ("M", "F")),
    # norms etc: replicated
    (r".*", (None,) * 8),
)


def _entry(tag: Optional[str], fsdp: bool) -> Optional[str]:
    if tag in ("M", "M2"):
        return "model"
    if tag == "F":
        return "data" if fsdp else None
    return tag


def param_spec(name: str, shape: Tuple[int, ...], *, fsdp: bool,
               mesh_shape: Optional[Mapping[str, int]] = None) -> Spec:
    """The spec of parameter `name` of `shape` (the reference's
    ``param_spec``): a sharded entry is dropped when its dim does not divide
    by the axis size; an "M2" entry is used only when the "M" dim dropped;
    no axis is named twice."""
    if mesh_shape and mesh_shape.get("model", 1) > 1:
        raise NotImplementedError(
            "a 'model' axis of size > 1 (tensor parallelism) is not ported "
            "yet (ROADMAP.md Queue 1 item 14)")
    for pat, tags in _RULES:
        if re.search(pat, name):
            tags = list(tags[:len(shape)])
            tags += [None] * (len(shape) - len(tags))
            entries = [_entry(t, fsdp) if t != "M2" else None for t in tags]
            if mesh_shape:
                for i, e in enumerate(entries):
                    if e is not None and shape[i] % mesh_shape.get(e, 1):
                        entries[i] = None
            if "M2" in tags and "model" not in entries:
                i = tags.index("M2")
                if not mesh_shape or shape[i] % mesh_shape.get("model",
                                                               1) == 0:
                    entries[i] = "model"
            seen = set()
            for i, e in enumerate(entries):
                if e in seen:
                    entries[i] = None
                elif e is not None:
                    seen.add(e)
            return tuple(entries)
    raise AssertionError("unreachable: catch-all rule")


def param_specs(shapes: Mapping[str, Tuple[int, ...]], *, fsdp: bool,
                mesh_shape: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Spec]:
    return {k: param_spec(k, tuple(v), fsdp=fsdp, mesh_shape=mesh_shape)
            for k, v in shapes.items()}


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of `spec` sharded over ``"data"`` (None if none is)."""
    for i, e in enumerate(spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return i
    return None


def fused_dims(specs: Mapping[str, Spec]) -> Dict[str, int]:
    """{leaf: its FSDP dim} for every leaf sharded over ``"data"``: the
    reference's ``fused_leaves``, in the specs' order."""
    return {k: d for k, d in ((k, fsdp_dim(s)) for k, s in specs.items())
            if d is not None}


class DuplicateSpecError(Exception):
    """A spec names one mesh axis on two dims (the reference's
    ``jax.sharding``: the per-worker momentum's leading vote axes beside
    an FSDP dim, ``("data", None, "data", "model")``)."""


def _fmt(entry) -> str:
    if isinstance(entry, tuple) and len(entry) == 1:
        entry = entry[0]
    return repr(entry)


def check_spec(spec: Sequence) -> None:
    """Raise :class:`DuplicateSpecError`, as ``NamedSharding`` does, when
    `spec` maps a mesh axis to more than one dim."""
    seen = set()
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is None:
                continue
            if a in seen:
                raise DuplicateSpecError(
                    "A single NamedSharding spec specification can map "
                    "every mesh axis to at most one positional dimension, "
                    f"but PartitionSpec({', '.join(map(_fmt, spec))}) has "
                    f"duplicate entries for `{a}`")
            seen.add(a)


def _slice(x, dim: int, index: int, count: int):
    size = x.shape[dim] // count
    return x[(slice(None),) * dim + (slice(index * size,
                                           (index + 1) * size),)]


def shard_tree(tree: Mapping, dims: Mapping[str, int], index: int,
               count: int) -> Dict:
    """One rank's leaves of the full `tree`: slice `index` of `count` along
    each leaf's FSDP dim in `dims` (other leaves whole). Slices of numpy
    arrays or tensors are views; copy them to own them."""
    return {k: (_slice(v, dims[k], index, count) if k in dims else v)
            for k, v in tree.items()}


def join_shards(trees: Sequence[Mapping], dims: Mapping[str, int]) -> Dict:
    """The full tree from every data index's :func:`shard_tree`, in data
    order (numpy arrays or tensors; the unsharded leaves from the first)."""
    first = trees[0]
    out = {}
    for k, v in first.items():
        if k not in dims:
            out[k] = v
            continue
        parts = [t[k] for t in trees]
        out[k] = (torch.cat(parts, dim=dims[k]) if torch.is_tensor(v)
                  else np.concatenate(parts, axis=dims[k]))
    return out


__all__ = ["DuplicateSpecError", "Spec", "check_spec", "fsdp_dim",
           "fused_dims", "join_shards", "param_spec", "param_specs",
           "shard_tree"]
