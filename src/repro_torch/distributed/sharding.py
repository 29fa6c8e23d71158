"""Parameter sharding rules (``repro.distributed.sharding``, its parameter
half, and ``kv_cache_spec``): which dim of each leaf is sharded over
``"model"`` (tensor parallel) and which over ``"data"`` (FSDP).

A spec is a tuple with one entry per dim: ``"data"`` (ZeRO-3 sharded over
the data axis), ``"model"`` (tensor parallel) or None (replicated); there
is no ``PartitionSpec``. The rules and their fallbacks are the
reference's (``src/repro/distributed/sharding.py:94-195``): an ``"F"`` tag
becomes ``"data"`` only with ``fsdp``, and any sharded entry whose dim
does not divide by its axis size is dropped. The leaves whose spec names
``"data"`` are what the reference's trainer calls ``fused_leaves``: the
fused ZeRO backward votes them (``core.majority_vote.make_fsdp_hooks``).

The ``"model"`` entries place a leaf over the model axis
(``distributed.tensor_parallel``). The activation helper ``shard`` (an
identity without XLA's partitioner) is not ported.

A rank of a ``ProcessMesh`` holds, of each leaf, the block its spec names:
along a ``"data"`` dim slice ``data_index`` of ``data`` equal slices, along
a ``"model"`` dim slice ``model_index`` of ``model``, along a dim named by
a tuple of axes (a serving cache's ``("data", "model")``) the slice of
their joint index, outermost axis major; pod replicas (and the ranks of an
axis no dim names) hold the same block. :func:`shard_tree` cuts full
parameters (numpy arrays or tensors) into one rank's blocks, and
:func:`join_shards` puts every rank's blocks back together: this is how
the reference's numpy parameters (``model.params_from_numpy``) become one
rank's shards, and back again.
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


def model_tagged(name: str, ndim: int) -> bool:
    """Whether the rules place leaf `name` (of `ndim` dims) over
    ``"model"`` when its dim divides (an "M" or "M2" tag)."""
    for pat, tags in _RULES:
        if re.search(pat, name):
            return any(t in ("M", "M2") for t in tags[:ndim])
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


def model_dim(spec: Spec) -> Optional[int]:
    """The dim of `spec` cut over ``"model"`` (None if none is): at most
    one, since a spec names no axis twice. A model rank's block of the leaf
    is contiguous runs along it (the adversary's counter map,
    ``core.prng.counter_map``)."""
    return spec.index("model") if "model" in spec else None


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


#: the batch dim's entry of a spec: the vote axes jointly
BATCH = ("pod", "data")


def kv_cache_spec(num_kv_heads: int, model_axis: int) -> Tuple[Spec, str]:
    """The spec of an (L, B, S, Hkv, hd) cache and its kind (the
    reference's ``kv_cache_spec``): heads over ``"model"`` when they
    divide the axis (``"heads"``), else the sequence (``"seq"``, read by
    the sharded flash decode)."""
    if num_kv_heads % model_axis == 0:
        return (None, BATCH, None, "model", None), "heads"
    return (None, BATCH, "model", None, None), "seq"


def _slice(x, dim: int, index: int, count: int):
    size = x.shape[dim] // count
    return x[(slice(None),) * dim + (slice(index * size,
                                           (index + 1) * size),)]


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_block(spec: Sequence, coords: Mapping[str, int],
               sizes: Mapping[str, int]) -> Tuple[Tuple[int, int], ...]:
    """(index, count) of the block a rank at `coords` holds along each dim
    of `spec` over a mesh of `sizes` (an axis absent from `sizes` has size
    1); (0, 1) for a dim the spec leaves whole."""
    out = []
    for e in spec:
        idx, count = 0, 1
        for a in _axes_of(e):
            n = sizes.get(a, 1)
            idx, count = idx * n + coords.get(a, 0), count * n
        out.append((idx, count))
    return tuple(out)


def shard_leaf(x, spec: Sequence, coords: Mapping[str, int],
               sizes: Mapping[str, int]):
    """The block of `x` a rank at `coords` holds under `spec` (a view)."""
    for dim, (idx, count) in enumerate(spec_block(spec, coords, sizes)):
        if count > 1:
            x = _slice(x, dim, idx, count)
    return x


def shard_tree(tree: Mapping, dims: Mapping, index: int = 0,
               count: int = 1, *, coords: Optional[Mapping[str, int]] = None,
               sizes: Optional[Mapping[str, int]] = None) -> Dict:
    """One rank's leaves of the full `tree`. With `dims` ``{leaf: FSDP
    dim}``: slice `index` of `count` along each leaf's dim (other leaves
    whole). With `dims` ``{leaf: spec}`` and the rank's `coords` over a
    mesh of `sizes`: the block of every dim each spec names (leaves
    without a spec whole). Slices of numpy arrays or tensors are views;
    copy them to own them."""
    if coords is None:
        return {k: (_slice(v, dims[k], index, count) if k in dims else v)
                for k, v in tree.items()}
    return {k: (shard_leaf(v, dims[k], coords, sizes) if k in dims else v)
            for k, v in tree.items()}


def _concat(parts, dim: int):
    return (torch.cat(parts, dim=dim) if torch.is_tensor(parts[0])
            else np.concatenate(parts, axis=dim))


def join_shards(trees: Sequence[Mapping], dims: Mapping,
                sizes: Optional[Mapping[str, int]] = None) -> Dict:
    """The full tree back from every rank's :func:`shard_tree` (numpy
    arrays or tensors; a leaf no spec shards from the first tree). With
    `dims` ``{leaf: FSDP dim}``, `trees` are every data index's, in data
    order. With `dims` ``{leaf: spec}`` and the mesh's `sizes`, `trees`
    are every rank's, row-major over the axes of `sizes` in
    ``("pod", "data", "model")`` order."""
    first = trees[0]
    if sizes is None:
        return {k: (_concat([t[k] for t in trees], dims[k]) if k in dims
                    else v) for k, v in first.items()}
    axes = [a for a in ("pod", "data", "model") if a in sizes]
    coords = []
    for flat in range(len(trees)):
        at, rest = {}, flat
        for a in reversed(axes):
            rest, at[a] = divmod(rest, sizes[a])
        coords.append(at)
    out = {}
    for k, v in first.items():
        if k not in dims:
            out[k] = v
            continue
        blocks = {}
        for c, t in zip(coords, trees):
            key = tuple(i for i, _ in spec_block(dims[k], c, sizes))
            blocks.setdefault(key, t[k])
        counts = [n for _, n in spec_block(dims[k], {}, sizes)]

        def build(prefix, dim):
            if dim == len(counts):
                return blocks[tuple(prefix)]
            return _concat([build(prefix + [i], dim + 1)
                            for i in range(counts[dim])], dim)
        out[k] = build([], 0)
    return out


__all__ = ["BATCH", "DuplicateSpecError", "Spec", "check_spec", "fsdp_dim",
           "fused_dims", "join_shards", "kv_cache_spec", "model_dim",
           "model_tagged", "param_spec",
           "param_specs", "shard_leaf", "shard_tree", "spec_block"]
