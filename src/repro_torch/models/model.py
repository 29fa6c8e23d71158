"""Model API of the port (``repro.models.model``): every family of the
reference, the decoder-only (dense, MoE and the VLM's decoder with its
stubbed patch input), the SSM (mamba2), the hybrid (zamba2) and the
encoder-decoder (whisper, its frontend stubbed):

  init_params(cfg, generator, device)   -> flat param dict (stacked layout)
  params_from_numpy(arrays, device)     -> the same dict from numpy arrays
  forward_logits(cfg, params, batch, hook=..., remat=...) -> (logits, aux)
  loss_fn(cfg, params, batch, hook=..., remat=...)  -> (scalar loss, metrics)
  init_cache(cfg, batch, max_len, device=...) -> cache dict (family-specific)
  prefill(cfg, params, batch)           -> (logits, cache)
  decode_step(cfg, params, tokens, cache, pos) -> (logits, cache)
  input_specs(cfg, cell)                -> tensors on the "meta" device

Over a mesh's ``"model"`` axis (``tp=``, a ``distributed.mesh.ProcessMesh``
with a model axis larger than 1; ``distributed.tensor_parallel``) every
arch runs tensor-parallel on a rank's slices of the parameters (the MoE's
experts in the EP or M2 form, the SSD on the rank's heads, whisper's
cross-attention in the three attention forms): the embedding and the
cross-entropy vocab-parallel and the logits the rank's vocab shard where
the table is sharded, plain and whole where the axis does not divide the
vocabulary; the cache the rank's block of the serving layout. A leaf
layout the port cannot run raises (:func:`check_model_axis`).

Parameters are a flat ``dict[str, Tensor]`` under the JAX package's names
and in its stacked layout (``layers.attn_wq`` is ``(L, d, H*hd)``), so
parameters and momentum carry across between the packages by name.
Batches are dicts with ``tokens`` (B, S) integer tensors and, for the VLM
(pixtral), ``patch_embeds`` (B, S_img, d): the image prefix's embeddings,
placed before the tokens' (the ViT frontend is stubbed, as in the
reference), or, for the encoder-decoder (whisper), ``enc_embeds`` (B,
T_src, d): the encoder's input frames.

The decode step writes its cache in place (the reference donates it) and
returns it; its `pos` is one position for the batch, as the reference's,
or one a row, as the serving engine decodes its slots. The reference's
quirks are kept: ``prefill`` returns a zero cache for the SSM and the
hybrid (their prefill is the forward pass) and zero self-attention caches
for the encoder-decoder, whose cross-attention K / V it fills; a VLM
prompt without ``patch_embeds`` is its tokens alone.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchFamily, ModelConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.models import encdec, hybrid, layers as L, transformer
from repro_torch.models.mamba2 import mamba2_init_state

_BIAS_SUFFIXES = ("_b", "_bq", "_bk", "_bv", "_conv_b", "dt_bias")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: the leaves that may stay whole under a sharded computation: a
#: vocabulary the axis does not divide (``layers.vocab_group``)
WHOLE_OK = ("embed.table", "unembed.table")


def check_model_axis(cfg: ModelConfig, model: int) -> None:
    """Raise ``NotImplementedError`` naming the leaf and the axis where the
    port cannot run `cfg` over a model axis of `model` > 1 ranks: a leaf
    the rules place over ``"model"`` whose dim the axis does not divide
    (``param_spec`` then keeps it whole), other than a vocabulary table.
    No published or reduced config meets one at model 2-16."""
    if model <= 1:
        return
    specs = shd.param_specs(cfg.param_shapes(), fsdp=False,
                            mesh_shape={"model": model})
    for k, shape in cfg.param_shapes().items():
        if (k not in WHOLE_OK and "model" not in specs[k]
                and shd.model_tagged(k, len(shape))):
            raise NotImplementedError(
                f"{cfg.name}: leaf {k} {tuple(shape)} over a 'model' axis "
                f"of {model}: the axis divides none of its sharded dims, "
                "so param_spec keeps it whole, and the port runs no such "
                "layout")


def _frames(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """The encoder's input frames in the model's dtype, the dtype the
    reference's ``make_batch`` and ``input_specs`` give them (its numpy
    pipeline hands float32 frames, which JAX would promote the encoder
    to, and its decoder scan then refuses: ROADMAP.md, the differences)."""
    return batch["enc_embeds"].to(_dtype(cfg))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype :func:`init_params` gives leaf `name`: float32 for mamba's
    ``A_log`` and ``mamba_D``, the model's dtype for every other leaf."""
    return (torch.float32 if name.endswith(("A_log", "mamba_D"))
            else _dtype(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None, shard=None
                ) -> Dict[str, torch.Tensor]:
    """The reference's init rules: names in sorted order, ones for scales,
    zeros for biases, ``normal * 1/sqrt(fan_in)`` drawn in float32 from
    `generator` (which must live on `device`) and then cast.
    `shard(name, tensor)`, when given, replaces each leaf once it is made
    (a mesh rank keeps its slice of a fused leaf), so only one whole leaf
    exists at a time.

    Mamba's ``A_log`` is float32 ``log(1 .. nh) + 0.5`` for each layer (A
    in [1, 16) as in mamba2's own init) and its ``mamba_D`` float32 ones,
    in a model of any dtype, as in the reference.

    The draws differ from ``jax.random``'s; tests that compare the two
    packages init in the JAX package and carry the arrays across with
    :func:`params_from_numpy`."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    params = {}
    for name, shape in sorted(cfg.param_shapes().items()):
        if name.endswith("_scale") or ".scale" in name:
            params[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif name.endswith(_BIAS_SUFFIXES):
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif name.endswith("A_log"):
            nh = shape[-1]
            a = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                       device=dev) + 0.5)
            params[name] = a.expand(shape).contiguous()
        elif name.endswith("mamba_D"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            params[name] = w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
            del w
        if shard is not None:
            params[name] = shard(name, params[name])
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


def _vlm_split(cell_seq: int) -> Tuple[int, int]:
    """pixtral: the first quarter of the sequence is image patches."""
    s_img = cell_seq // 4
    return s_img, cell_seq - s_img


def _embed_input(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor], tp=None) -> torch.Tensor:
    """The (B, S, d) input stream: the tokens' embeddings, after the patch
    embeddings (cast to the tokens' dtype) for the VLM."""
    tok = L.embed_tokens(params["embed.table"], batch["tokens"], tp)
    if cfg.family == ArchFamily.VLM and "patch_embeds" in batch:
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return tok


def _top_leaves(params: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The leaves outside the stacked layers (the ZeRO-3 hook's "top"
    scope): the tables, the final norm, the hybrid's shared block."""
    return {k: v for k, v in params.items()
            if not k.startswith(("layers.", "encoder."))}


def _final_hidden(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], hook, remat: str, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Any]:
    """(the final-normed stream (B,S,d), aux_loss, the unembedding table,
    the model group its vocabulary is sharded over or None): the family's
    stack, each block under `remat` (over a model group `tp`,
    tensor-parallel)."""
    tp = L.model_group(tp)
    if tp is not None:
        check_model_axis(cfg, tp.model)
    if hook is not None:
        params = {**params, **hook(_top_leaves(params), "top")}
    table = params.get("unembed.table", params["embed.table"])
    vtp = L.vocab_group(table, cfg.vocab_size, tp)
    aux = None
    if cfg.family == ArchFamily.AUDIO:
        enc = encdec.encoder_forward(params, _frames(cfg, batch), cfg,
                                     hook=hook, remat=remat, tp=tp)
        h = L.embed_tokens(params["embed.table"], batch["tokens"], vtp)
        pos = torch.arange(h.shape[1], device=h.device)
        h = h + L.sinusoidal_positions(pos, cfg.d_model).to(h.dtype)
        h = encdec.decoder_forward(params, h, enc, cfg, hook=hook,
                                   remat=remat, tp=tp)
    elif cfg.family == ArchFamily.SSM:
        h = _embed_input(cfg, params, batch, vtp)
        h = hybrid.mamba_stack(params, h, cfg, hook=hook, remat=remat, tp=tp)
    elif cfg.family == ArchFamily.HYBRID:
        h = _embed_input(cfg, params, batch, vtp)
        h = hybrid.hybrid_forward(params, h, cfg, hook=hook, remat=remat,
                                  tp=tp)
    else:
        h = _embed_input(cfg, params, batch, vtp)
        h, aux = transformer.decoder_stack(params, h, cfg, hook=hook,
                                           remat=remat, tp=tp)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = L.rms_norm(h, params["final_norm.scale"], cfg.norm_eps)
    return h, aux, table, vtp


def forward_logits(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], hook=None,
                   remat: str = "none", tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V) in the parameter dtype, aux_loss scalar);
    `remat` checkpoints each block (``transformer.maybe_remat``; the SSM,
    hybrid and encoder-decoder stacks each layer, as the reference's scans
    do, and the hybrid's shared block too).
    `hook(tree, scope)` is the ZeRO-3 gather whose backward votes
    (``core.majority_vote.make_fsdp_hooks``): applied to the top-level
    parameters here and to each layer's inside the decoder stack. Over a
    model group `tp` the logits are the rank's vocab shard (B,S,V/m), as
    the reference's ``shard(logits, BATCH, None, "model")`` (whole where
    the table is whole)."""
    h, aux, table, vtp = _final_hidden(cfg, params, batch, hook, remat, tp)
    return L.unembed(table, h, vtp), aux


def loss_fn(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], hook=None, remat: str = "none",
            tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``ce + aux`` and {"ce", "aux"}: next-token CE over the tokens (for
    the VLM over the text segment only, the last ``len(tokens)``
    positions, whose logits alone are made) and the MoE aux loss. Over a
    model group `tp` the CE is vocab-parallel (plain, where the table is
    whole) and every model rank's loss is the same."""
    h, aux, table, vtp = _final_hidden(cfg, params, batch, hook, remat, tp)
    tokens = batch["tokens"]
    if cfg.family == ArchFamily.VLM and "patch_embeds" in batch:
        h = h[:, -tokens.shape[1]:]
    ce = L.cross_entropy_loss(L.unembed(table, h, vtp)[:, :-1],
                              tokens[:, 1:], vtp)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches / prefill / decode
# ---------------------------------------------------------------------------


def _cache_device(device: DeviceLike) -> torch.device:
    """`device`, resolved as an entry point's (``cuda`` unless told
    otherwise), or the "meta" device for shapes alone."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = None, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """The family's zero decode cache for `batch` sequences of up to
    `max_len` positions: ``k`` / ``v`` (and int8 scales) for the
    decoder-only; ``ssm`` / ``conv`` for the SSM; those and one KV slot
    per shared-block call for the hybrid; ``k`` / ``v`` and the
    cross-attention ``xk`` / ``xv`` over ``max_source_positions`` for the
    encoder-decoder. Leaves lead with the layer axis, then the batch."""
    dtype = dtype or _dtype(cfg)
    dev = _cache_device(device)
    if cfg.family == ArchFamily.SSM:
        st = mamba2_init_state(cfg, batch, dtype, device=dev)
        return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=dev)
                for k, v in st.items()}
    if cfg.family == ArchFamily.HYBRID:
        return hybrid.hybrid_init_cache(cfg, batch, max_len, dtype, dev)
    if cfg.family == ArchFamily.AUDIO:
        return encdec.encdec_init_cache(cfg, batch, max_len,
                                        cfg.max_source_positions, dtype, dev)
    return transformer.init_kv_cache(cfg, batch, max_len, dtype, dev)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, torch.Tensor]:
    """:func:`init_cache`'s leaves as "meta" tensors, for their shapes and
    dtypes only: made outside any dispatch mode, so the dry run
    (``launch.dryrun``), which runs a step on "meta", does not count
    them as the step's memory."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return init_cache(cfg, batch, max_len, device="meta")


def _logits(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            h: torch.Tensor, tp=None) -> torch.Tensor:
    h = L.rms_norm(h, params["final_norm.scale"], cfg.norm_eps)
    table = params.get("unembed.table", params["embed.table"])
    return L.unembed(table, h, L.vocab_group(table, cfg.vocab_size, tp))


def _zeros(name: str, shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], tp=None, keep=None, hook=None,
            zeros=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt: (logits (B, S, V), its cache). The decoder-only
    families fill the cache from the forward pass (S positions); see the
    module doc for the others'. Over a model group `tp` the logits are the
    rank's vocab shard (whole where the table is), `keep(name, t)` cuts
    each layer's K / V (and the cross cache's) to the rank's block of the
    cache and `zeros(name, global_shape, dtype, device)` makes the rank's
    block of a zero leaf; `hook` is the ZeRO-3 gather of FSDP-sharded
    parameters (the reference's sharded prefill)."""
    tp = L.model_group(tp)
    if tp is not None:
        check_model_axis(cfg, tp.model)
    keep = keep or (lambda name, t: t)
    zeros = zeros or _zeros
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    if cfg.family in (ArchFamily.SSM, ArchFamily.HYBRID, ArchFamily.AUDIO):
        cache = {k: zeros(k, tuple(v.shape), v.dtype, dev) for k, v in
                 cache_specs(cfg, B, S).items()}
        if cfg.family != ArchFamily.AUDIO:
            h, _, table, vtp = _final_hidden(cfg, params, batch, hook,
                                             "none", tp)
            return L.unembed(table, h, vtp), cache
    if hook is not None:
        params = {**params, **hook(_top_leaves(params), "top")}
    if cfg.family == ArchFamily.AUDIO:
        enc = encdec.encoder_forward(params, _frames(cfg, batch), cfg,
                                     hook=hook, tp=tp)
        xk, xv = encdec.encdec_precompute_cross(params, enc, cfg, tp, hook)
        cache["xk"] = torch.stack([keep("xk", t) for t in xk])
        cache["xv"] = torch.stack([keep("xv", t) for t in xv])
        table = params["embed.table"]
        h = L.embed_tokens(table, tokens,
                           L.vocab_group(table, cfg.vocab_size, tp))
        h = h + L.sinusoidal_positions(torch.arange(S, device=dev),
                                       cfg.d_model).to(h.dtype)
        h = encdec.decoder_forward(params, h, enc, cfg, hook=hook, tp=tp)
        return _logits(cfg, params, h, tp), cache
    table = params["embed.table"]
    h = _embed_input(cfg, params, batch,
                     L.vocab_group(table, cfg.vocab_size, tp))
    h, cache = transformer.decoder_prefill(params, h, cfg, tp=tp, keep=keep,
                                           hook=hook)
    return _logits(cfg, params, h, tp), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos,
                tp=None, seq_names=(), seq_len: int = 0, cross_names=(),
                hook=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, 1); `pos` one position (an int or a 0-d tensor) or one a
    row (B,) -> (logits (B, V), cache). The cache is advanced in place.
    Over a model group `tp` the logits are the rank's vocab shard (whole
    where the table is) and the cache its block of the serving layout:
    the self-attention cache's rows those the axes `seq_names` give it
    within its `seq_len` (``layers.decode_self_attention``), the cross
    cache's those of `cross_names`. `hook` gathers the FSDP slices
    (``core.majority_vote.make_fsdp_hooks``): the top-level leaves' (the
    hybrid's shared block among them) once, each decoder layer's as the
    layer runs."""
    tp = L.model_group(tp)
    if tp is not None:
        check_model_axis(cfg, tp.model)
    if hook is not None:
        params = {**params, **hook(_top_leaves(params), "top")}
    table = params["embed.table"]
    h = L.embed_tokens(table, tokens, L.vocab_group(table, cfg.vocab_size,
                                                    tp))
    if cfg.family == ArchFamily.AUDIO:
        posv = torch.as_tensor(pos, device=h.device).reshape(-1)
        h = h + L.sinusoidal_positions(posv, cfg.d_model)[:, None].to(
            h.dtype)
        h, cache = encdec.encdec_decode_step(
            params, h, cache, pos, cfg, tp=tp, seq_names=seq_names,
            seq_len=seq_len, cross_names=cross_names, hook=hook)
    elif cfg.family == ArchFamily.SSM:
        h = hybrid.mamba_decode_layers(
            hybrid._unbound_layers(params), h,
            {k: v.unbind(0) for k, v in cache.items()}, cfg, 0,
            cfg.num_layers, tp, hook)
    elif cfg.family == ArchFamily.HYBRID:
        h, cache = hybrid.hybrid_decode_step(params, h, cache, pos, cfg,
                                             tp=tp, seq_names=seq_names,
                                             seq_len=seq_len, hook=hook)
    else:
        h, cache = transformer.decoder_decode_step(
            params, h, cache, pos, cfg, tp=tp, seq_names=seq_names,
            seq_len=seq_len, hook=hook)
    return _logits(cfg, params, h, tp)[:, 0], cache


# ---------------------------------------------------------------------------
# input specs (tensors on the "meta" device: shapes and dtypes, no memory)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """The inputs of a shape cell as "meta" tensors (the reference's
    ``ShapeDtypeStruct`` pytrees): ``{"batch": {...}}`` for train and
    prefill cells; ``{"tokens", "cache", "pos"}`` for decode (a cache of
    ``seq_len`` positions, one new token at a scalar position)."""
    B, S = cell.global_batch, cell.seq_len
    dt, i32 = _dtype(cfg), torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        if cfg.family == ArchFamily.AUDIO:
            batch = {"tokens": meta((B, S), i32),
                     "enc_embeds": meta((B, cfg.max_source_positions,
                                         cfg.d_model), dt)}
        elif cfg.family == ArchFamily.VLM:
            s_img, s_txt = _vlm_split(S)
            batch = {"tokens": meta((B, s_txt), i32),
                     "patch_embeds": meta((B, s_img, cfg.d_model), dt)}
        else:
            batch = {"tokens": meta((B, S), i32)}
        return {"batch": batch}
    return {"tokens": meta((B, 1), i32),
            "cache": init_cache(cfg, B, S, device="meta"),
            "pos": meta((), i32)}


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: torch.Generator, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """A random batch drawn from `generator` (which must live on
    `device`), shaped as the reference's ``make_batch``: ``tokens`` (batch,
    seq); for the encoder-decoder ``enc_embeds`` (batch, min(T_src, 64),
    d); for the VLM the first quarter of the sequence as ``patch_embeds``
    and the rest as tokens. The draws differ from ``jax.random``'s."""
    dev = resolve_device(device)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=generator, device=dev)}
    if cfg.family == ArchFamily.AUDIO:
        t_src = min(cfg.max_source_positions, 64)
        out["enc_embeds"] = torch.randn(
            (batch, t_src, cfg.d_model), generator=generator,
            device=dev).to(_dtype(cfg))
    if cfg.family == ArchFamily.VLM:
        s_img, s_txt = _vlm_split(seq)
        out["tokens"] = out["tokens"][:, :s_txt]
        out["patch_embeds"] = torch.randn(
            (batch, s_img, cfg.d_model), generator=generator,
            device=dev).to(_dtype(cfg))
    return out
