"""Serving steps (``repro.train.serve_step``): the decode step, the
prefill, the batch-sharded prefill, the re-home of a prefill cache into a
decode cache, and the cache and parameter layouts over a mesh.

Serving needs no vote. The reference jits these under auto SPMD; the port
runs them eagerly, the decode step writing its cache in place as the
reference donates it, so a multi-GB cache never exists twice.

Over a ``distributed.mesh.ProcessMesh`` (``mesh=``; every rank calls the
step in lockstep) every arch runs tensor-parallel over its ``"model"``
axis (``distributed.tensor_parallel``). The layouts are the reference's,
as tuple specs (``distributed.sharding``):

* the parameters: ``serve_param_shardings``, the training layout
  (``sharding.param_specs``, with or without fsdp);
* an attention cache (L, B, S, K, hd) and its int8 scales:
  ``cache_leaf_spec``, the batch over the vote axes when it divides
  (``batch_entry``), the heads over ``"model"`` when they divide, else the
  sequence (over ``("data", "model")`` at batch 1), read by the sharded
  flash decode (``models.layers``); the hybrid's ``attn_k`` / ``attn_v``
  and whisper's cross cache ``xk`` / ``xv`` alike (a sequence-sharded
  cross cache read by the same online softmax, unmasked);
* an SSM state ``ssm`` (L, B, H, P, N): heads over ``"model"``; its conv
  window ``conv`` (L, B, W-1, conv_dim): channels over ``"model"``.

A rank holds its block of each (``sharding.shard_tree`` cuts full
parameters or caches into it). The decode step takes the global tokens
and positions and the rank's cache block, decodes the rows its block
holds, and returns every row's full logits on every rank (gathered over
the vocabulary and the batch axes) with the cache block advanced in
place. :func:`make_prefill` runs every prompt row on every rank and keeps
each layer's K / V block as the layout gives it; :func:`make_prefill_sharded`
runs each rank's batch rows only, as the reference's ``shard_map`` over
the batch axes. A prefill's logits stay the rank's vocab shard (B, S,
V / model), as the reference's stay sharded over "model" (``shard(logits,
BATCH, None, "model")``): a (B, S, V) tensor on every rank would be the
largest of the step; :func:`gather_vocab` joins the positions a caller
needs (a vocabulary the axis does not divide stays whole: whisper's).
:func:`make_cache_rehome` moves a prefill cache into a decode cache of
``max_len`` rows, each row to the rank that owns it. The reference's
engine and launchers serve on one device, and so do the port's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed import mesh as pm
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M

Spec = shd.Spec


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``ProcessMesh`` (or of such a mapping itself)."""
    return dict(mesh.axis_sizes if hasattr(mesh, "axis_sizes") else mesh)


def batch_entry(b: int, sizes: Mapping[str, int]):
    """The batch dim's spec entry (the reference's ``batch_entry``)."""
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if _div(b, dp) and dp > 1:
        return ("pod", "data") if "pod" in sizes else "data"
    if _div(b, sizes.get("data", 1)) and sizes.get("data", 1) > 1:
        return "data"
    return None


def cache_leaf_spec(name: str, shape: Tuple[int, ...],
                    sizes: Mapping[str, int]) -> Spec:
    """The spec of a cache leaf (the reference's ``cache_leaf_spec``)."""
    model = sizes.get("model", 1)
    if name in ("ssm",):  # (L,B,H,P,N)
        h = shape[2]
        return (None, batch_entry(shape[1], sizes),
                "model" if _div(h, model) else None, None, None)
    if name in ("conv",):  # (L,B,W-1,CD)
        return (None, batch_entry(shape[1], sizes), None,
                "model" if _div(shape[3], model) else None)
    if name in ("k_scale", "v_scale"):  # (L,B,S,K)
        b, s, k = shape[1], shape[2], shape[3]
        be = batch_entry(b, sizes)
        if _div(k, model):
            return (None, be, None, "model")
        if be is None and _div(s, model * sizes.get("data", 1)):
            return (None, None, ("data", "model"), None)
        return (None, be, "model" if _div(s, model) else None, None)
    if name in ("k", "v", "attn_k", "attn_v", "xk", "xv"):  # (L,B,S,K,hd)
        b, s, k = shape[1], shape[2], shape[3]
        be = batch_entry(b, sizes)
        if _div(k, model):
            return (None, be, None, "model", None)
        if be is None and _div(s, model * sizes.get("data", 1)):
            return (None, None, ("data", "model"), None, None)
        return (None, be, "model" if _div(s, model) else None, None, None)
    return ()


def cache_shardings(cfg: ModelConfig, cache_abs: Mapping[str, Any], mesh
                    ) -> Dict[str, Spec]:
    """{leaf: spec} of a cache (tensors or shapes) over `mesh` (a
    ``ProcessMesh`` or its {axis: size})."""
    sizes = _sizes(mesh)
    return {k: cache_leaf_spec(k, tuple(v.shape), sizes)
            for k, v in cache_abs.items()}


def serve_param_shardings(cfg: ModelConfig, mesh, *, fsdp: bool
                          ) -> Dict[str, Spec]:
    """{leaf: spec} of the parameters over `mesh` (its training layout)."""
    return shd.param_specs(cfg.param_shapes(), fsdp=fsdp,
                           mesh_shape=_sizes(mesh))


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _global_shapes(cfg: ModelConfig, batch: int, seq: int,
                   src: int = 0) -> Dict[str, Tuple[int, ...]]:
    """The global shape of every cache leaf of a cache of `seq` rows for
    `batch` sequences (a block's shape alone cannot tell an unsharded
    short cache from a sharded one: the caller names them), the cross
    cache over `src` source rows (default ``max_source_positions``)."""
    out = {k: tuple(v.shape) for k, v in M.cache_specs(
        cfg, batch, seq).items()}
    for k in ("xk", "xv"):
        if k in out and src:
            out[k] = out[k][:2] + (src,) + out[k][3:]
    return out


def _block_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    return tuple(n // c for n, (_, c) in zip(
        shape, shd.spec_block(spec, mesh.coords, mesh.axis_sizes)))


def _keep(cfg: ModelConfig, mesh: pm.ProcessMesh, batch: int, seq: int,
          local_batch: bool, src: int = 0) -> Callable:
    """`keep(name, t)` for ``model.prefill``: a layer's K / V (B, S, K',
    hd), scales (B, S, K') or cross K / V (B, T_src, K', hd) cut to the
    rank's block of the cache layout (the heads are already the rank's
    when they divide the axis; with `local_batch` the rows are already
    the rank's)."""
    sizes, coords = mesh.axis_sizes, mesh.coords
    grouped = cfg.num_kv_heads % mesh.model == 0
    shapes = _global_shapes(cfg, batch, seq, src)

    def keep(name: str, t: torch.Tensor) -> torch.Tensor:
        spec = list(cache_leaf_spec(name, shapes[name], sizes))
        if grouped:
            spec[3] = None
        if local_batch:
            spec[1] = None
        return shd.shard_leaf(t, tuple(spec[1:]), coords, sizes)
    return keep


def _zero_block(mesh: pm.ProcessMesh, batch: int) -> Callable:
    """`zeros(name, shape, dtype, device)` for ``model.prefill``: the
    rank's block of a zero cache leaf of `shape`, its batch `batch` rows
    globally."""
    def zeros(name, shape, dtype, device):
        shape = (shape[0], batch) + tuple(shape[2:])
        spec = cache_leaf_spec(name, shape, mesh.axis_sizes)
        return torch.zeros(_block_shape(shape, spec, mesh), dtype=dtype,
                           device=device)
    return zeros


def gather_vocab(logits: torch.Tensor, mesh: pm.ProcessMesh,
                 vocab: int = 0) -> torch.Tensor:
    """The full vocabulary of vocab-sharded `logits` (..., V / model),
    joined over the model group in model-index order; logits of a
    whole-table model (their last dim `vocab`) as they are."""
    if mesh.model == 1 or logits.shape[-1] == vocab:
        return logits
    return pm.model_gather(logits.contiguous(), mesh, dim=-1)


def _gather_rows(x: torch.Tensor, mesh: pm.ProcessMesh, entry
                 ) -> torch.Tensor:
    """Every rank's rows of `x` along dim 0 over the batch `entry`'s axes."""
    names = _axes_of(entry)
    return pm.model_gather(x, mesh, dim=0, names=names) if names else x


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ModelConfig,
                     mesh: Optional[pm.ProcessMesh] = None,
                     max_len: Optional[int] = None, *,
                     fsdp: bool = False) -> Callable:
    """``step(params, tokens, cache, pos) -> (logits, cache)``: one token
    for each row of the batch (``model.decode_step``), the cache advanced
    in place. Over `mesh`, `params` and `cache` are the rank's blocks of a
    cache of `max_len` rows and `tokens` / `pos` global; the logits (B, V)
    are every row's, on every rank (see the module doc). With `fsdp` the
    parameters are the rank's blocks of the FSDP layout
    (``serve_param_shardings(..., fsdp=True)``, the reference's serving
    layout of the Mode B archs), gathered over the vote axes by the
    ZeRO-3 hooks as :func:`make_prefill_sharded`'s are, for every family:
    the top-level leaves once a tick (the hybrid's shared block), each
    layer's as the layer runs. After the gather a rank holds its
    plain-layout block of each leaf, so a tick equals the plain layout's
    bit for bit."""
    if mesh is None:
        def step(params, tokens, cache, pos):
            return M.decode_step(cfg, params, tokens, cache, pos)
        return step
    M.check_model_axis(cfg, mesh.model)
    if max_len is None:
        raise ValueError("a decode step over a mesh needs the cache's "
                         "global length, max_len")
    tp = mesh if mesh.model > 1 else None
    sizes = mesh.axis_sizes
    hook = _fsdp_hook(cfg, mesh) if fsdp else None

    def step(params, tokens, cache, pos):
        B = tokens.shape[0]
        specs = {k: cache_leaf_spec(k, shape, sizes) for k, shape in
                 _global_shapes(cfg, B, max_len).items()}
        spec = next(iter(specs.values()))
        bi, bc = shd.spec_block(spec, mesh.coords, sizes)[1]
        rows = slice(bi * B // bc, (bi + 1) * B // bc)
        pos_t = torch.as_tensor(pos, device=tokens.device)
        pos_loc = pos_t[rows] if pos_t.ndim == 1 else pos
        attn = next((specs[k] for k in ("k", "attn_k") if k in specs), None)
        logits, cache = M.decode_step(
            cfg, params, tokens[rows], cache, pos_loc, tp=tp,
            seq_names=_axes_of(attn[2]) if attn else (), seq_len=max_len,
            cross_names=(_axes_of(specs["xk"][2]) if "xk" in specs
                         else ()), hook=hook)
        return _gather_rows(gather_vocab(logits, mesh, cfg.vocab_size),
                            mesh, spec[1]), cache
    return step


def _fsdp_hook(cfg: ModelConfig, mesh: pm.ProcessMesh):
    """The ZeRO-3 gather (no vote: serving has no backward) of the leaves
    the FSDP layout shards over `mesh`, None when it shards none."""
    from repro_torch.core.majority_vote import make_fsdp_hooks
    dims = shd.fused_dims(serve_param_shardings(cfg, mesh, fsdp=True))
    return make_fsdp_hooks(dims, mesh.vote_axes, vote=False) if dims \
        else None


def make_cache_rehome(cfg: ModelConfig, batch: int, max_len: int,
                      mesh: Optional[pm.ProcessMesh] = None) -> Callable:
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
    The target lives on each leaf's device. Over `mesh` each leaf is the
    rank's block of its layout, and ``rehome(cache, seq_len[, src_len])``
    takes the prompt's length (and the encoder's source rows, default
    ``max_source_positions``): a sequence-sharded prompt is gathered over
    its axes and each rank keeps the target rows it owns."""
    full_abs = M.cache_specs(cfg, batch, max_len)

    def check(cache):
        if set(cache) != set(full_abs):
            raise ValueError(
                f"cache structure mismatch: got {sorted(cache)}, "
                f"serving cache has {sorted(full_abs)}")

    def fit(k: str, src_shape, want_shape):
        if len(src_shape) != len(want_shape) or any(
                s > d for s, d in zip(src_shape, want_shape)):
            raise ValueError(
                f"cache leaf {k!r} {tuple(src_shape)} does not fit the "
                f"max_len={max_len} serving cache {tuple(want_shape)}")

    if mesh is None:
        def rehome(cache: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
            check(cache)
            out = {}
            for k, want in full_abs.items():
                src = cache[k].to(want.dtype)
                if src.shape == want.shape:
                    out[k] = src
                    continue
                fit(k, src.shape, want.shape)
                dst = torch.zeros(want.shape, dtype=want.dtype,
                                  device=src.device)
                dst[tuple(slice(0, s) for s in src.shape)] = src
                out[k] = dst
            return out
        return rehome
    M.check_model_axis(cfg, mesh.model)
    sizes, coords = mesh.axis_sizes, mesh.coords

    def rehome(cache: Dict[str, torch.Tensor], seq_len: int, src_len: int = 0
               ) -> Dict[str, torch.Tensor]:
        check(cache)
        shapes = _global_shapes(cfg, batch, seq_len, src_len)
        out = {}
        for k, want in full_abs.items():
            src = cache[k].to(want.dtype)
            shape = shapes[k]
            fit(k, shape, want.shape)
            if shape == tuple(want.shape):   # the SSM state, a full cross
                out[k] = src
                continue
            S = shape[2]
            names = _axes_of(cache_leaf_spec(k, shape, sizes)[2])
            if names:
                src = pm.model_gather(src, mesh, dim=2, names=names)
            spec = cache_leaf_spec(k, tuple(want.shape), sizes)
            block = shd.spec_block(spec, coords, sizes)
            shape = [n // c for n, (_, c) in zip(want.shape, block)]
            si, sc = block[2]
            start = si * shape[2]
            dst = torch.zeros(shape, dtype=want.dtype, device=src.device)
            n = max(0, min(S, start + shape[2]) - start)
            if n:
                dst[:, :, :n] = src[:, :, start:start + n]
            out[k] = dst
        return out
    return rehome


def make_prefill(cfg: ModelConfig, cache_shardings_=None,
                 mesh: Optional[pm.ProcessMesh] = None) -> Callable:
    """``step(params, batch) -> (logits, cache)``: ``model.prefill``. Over
    `mesh` (the reference pins the produced cache to its serving layout,
    `cache_shardings_`, which the port's layout always is) every rank runs
    every prompt row, `params` are its blocks, and the step returns the
    rank's vocab shard of the logits (:func:`gather_vocab`) and its block
    of the cache."""
    if mesh is None:
        def step(params, batch):
            return M.prefill(cfg, params, batch)
        return step
    M.check_model_axis(cfg, mesh.model)
    tp = mesh if mesh.model > 1 else None

    def step(params, batch):
        B, S = batch["tokens"].shape
        src = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
        return M.prefill(cfg, params, batch, tp=tp,
                         keep=_keep(cfg, mesh, B, S, False, src),
                         zeros=_zero_block(mesh, B))
    return step


def make_prefill_sharded(cfg: ModelConfig, mesh: pm.ProcessMesh, *,
                         fsdp: bool, global_batch: int) -> Callable:
    """Prefill over the batch axes (the reference's ``shard_map`` manual
    over them, automatic over ``"model"``, the training layout): each rank
    runs its rows of the global batch, tensor-parallel over the model
    axis, FSDP-sharded parameters gathered by the ZeRO-3 hooks (no vote:
    no backward runs in serving). ``step(params, batch) -> (logits,
    cache)`` takes the global batch and returns the rank's rows' vocab
    shard of the logits (B / dp, S, V / model) and its block of the
    cache. With one replica, or a batch that does not split over them, it
    is :func:`make_prefill`."""
    dp = mesh.size
    if dp <= 1 or global_batch % dp != 0:
        return make_prefill(cfg, mesh=mesh)
    M.check_model_axis(cfg, mesh.model)
    tp = mesh if mesh.model > 1 else None
    hook = _fsdp_hook(cfg, mesh) if fsdp else None
    per = global_batch // dp
    r = mesh.replica_index()

    def step(params, batch):
        mine = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        S = batch["tokens"].shape[1]
        src = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
        return M.prefill(cfg, params, mine, tp=tp, hook=hook,
                         keep=_keep(cfg, mesh, global_batch, S, True, src),
                         zeros=_zero_block(mesh, global_batch))
    return step


def abstract_serve_inputs(cfg: ModelConfig, cell: ShapeCell, mesh, *,
                          fsdp: bool) -> Dict[str, Any]:
    """The inputs of a serve cell as "meta" tensors of their global shapes,
    each with its spec over `mesh` (a ``ProcessMesh`` or its {axis:
    size}): ``params`` and ``param_specs``; for a prefill cell ``batch``
    and ``batch_specs``; for a decode cell ``tokens``, ``cache``,
    ``cache_specs``, ``pos`` and their specs (the reference's
    ``ShapeDtypeStruct`` pytrees with shardings)."""
    sizes = _sizes(mesh)
    shapes = cfg.param_shapes()
    dt = getattr(torch, cfg.dtype)
    params = {k: torch.empty(v, dtype=dt, device="meta")
              for k, v in shapes.items()}
    out = {"params": params,
           "param_specs": serve_param_shardings(cfg, sizes, fsdp=fsdp)}
    specs = M.input_specs(cfg, cell)
    if cell.kind == "prefill":
        batch = specs["batch"]
        out["batch"] = batch
        out["batch_specs"] = {k: (batch_entry(v.shape[0], sizes),)
                              for k, v in batch.items()}
        return out
    out["tokens"] = specs["tokens"]
    out["tokens_spec"] = (batch_entry(specs["tokens"].shape[0], sizes),)
    out["cache"] = specs["cache"]
    out["cache_specs"] = cache_shardings(cfg, specs["cache"], sizes)
    out["pos"] = specs["pos"]
    out["pos_spec"] = ()
    return out


__all__ = ["abstract_serve_inputs", "batch_entry", "cache_leaf_spec",
           "cache_shardings", "gather_vocab", "make_cache_rehome",
           "make_decode_step", "make_prefill", "make_prefill_sharded",
           "serve_param_shardings"]
