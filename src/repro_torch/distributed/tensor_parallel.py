"""Tensor parallelism over a mesh's ``"model"`` axis: the autograd functions
that carry activations across the model group, and the design note of the
port's model axis.

The reference partitions its model with XLA: its train step is a
``shard_map`` manual over ``"pod"`` and ``"data"`` and automatic over
``"model"`` (``src/repro/train/train_step.py:1-20``), so inside the step
every leaf looks whole over ``"model"`` and the function computed is the
unsharded one up to the order of its reductions. The port has no SPMD
partitioner, so it shards by hand, in the manner of Megatron-LM, and
computes the same function:

* **Placement.** A rank holds the slice of every leaf that
  ``distributed.sharding.param_spec`` gives it: a ``"model"`` dim cut by
  the rank's model index, a ``"data"`` dim (fsdp) by its data index
  (``sharding.shard_tree``). The reference's layout choices are binding.
* **Columns, not heads.** ``attn_wq`` / ``attn_wk`` / ``attn_wv`` shard
  their output columns, which need not be whole heads (glm4-9b's
  ``attn_wk`` at model 4 is half a kv head a rank). Attention takes the
  reference's ``_attn_form`` (``models/layers.py:117-136``): *grouped*
  when the kv heads divide the axis (a rank holds whole kv heads and the q
  heads that read them), *repeat* when only the q heads divide (the k / v
  columns are gathered over the model group, K·hd a token, and a rank
  attends its H / m q heads), *seq* when neither does (q, k and v are
  gathered and a rank attends its S / m query rows; the output's rows are
  gathered and its own columns kept for ``attn_wo``). RoPE rotates whole
  heads, after any gather.
* **Column and row parallel.** ``w_gate`` / ``w_up`` and the q / k / v
  projections are column-parallel: their input enters the model group
  through :func:`copy_to_model` (forward the identity, backward the sum of
  the ranks' input cotangents). ``w_down`` and ``attn_wo`` are
  row-parallel: each rank's product is a partial sum, and
  :func:`reduce_from_model` adds the partials (backward the identity).
* **Sum order.** Every float sum over the model group (the row-parallel
  partials, :func:`copy_to_model`'s cotangents, a gather's backward) is
  the float32 sum of the ranks' parts in model-index order, rounded once to
  the model's dtype (``distributed.mesh.model_sum``). Every rank holds the
  same bits. The products of a bf16 model's tensor-parallel region are
  made in float32 (its bf16 operands are exact there): a column-parallel
  product (:func:`enter_model`, :func:`column_parallel`) rounds its output
  to bf16 once, as the unsharded product does, and its input cotangent
  stays float32 through the sum over the group, rounded once; a
  row-parallel product (:func:`row_parallel`) carries its partial in
  float32 and the sum rounds once. The unsharded model's bf16 products
  round their float32 accumulation once too, so the two differ by the
  order of the accumulation, and where the unsharded backward adds the
  rounded cotangents of several products (q, k and v; gate and up) in
  bf16, by those additions' roundings.
* **The vocabulary.** ``embed.table`` and ``unembed.table`` shard their
  rows (V). The embedding is a masked lookup of the rank's rows plus a
  sum (:func:`embed_tokens`, exact: one rank's row is non-zero). The
  logits stay vocab-sharded, as the reference's ``shard(logits, BATCH,
  None, "model")`` (``models/model.py:140``), and the cross-entropy is
  vocab-parallel in float32 (:func:`cross_entropy`: a maximum over the
  group, then one sum of the exponentials and the target's logit). A tied
  table (gemma3) is the same shard both ways.
* **Replicated leaves.** Norm scales and every leaf whose spec names no
  ``"model"`` stay whole on every model rank. The residual stream is
  replicated too: the reference's ``residual_shard`` / ``act_seq_shard``
  (``models/transformer.py:25-31``) is a layout hint and an identity on
  the function, and the port keeps the stream whole. Because each
  column-parallel entry sums its cotangent over the group, a replicated
  leaf's gradient comes out bit-equal on every model rank, and each model
  rank votes it over ``"data"`` as the reference votes its replicated
  leaves.
* **Leaf-global statistics.** The vote, its codecs' leaf statistics, the
  diagnostics and AUTO's resolution see global leaves in the reference.
  Each becomes a sum over the model group of the shards' parts, a
  replicated leaf counted once: ef_sign's mean|t|, weighted_vote's
  mismatch counts, the diagnostics' agreement and margin, and AUTO's
  coordinate count (``core.signum``, ``core.codecs``, ``core.vote_api``).
* **Serving.** A KV cache is laid out as ``serve_step.cache_leaf_spec``
  lays it: heads over ``"model"`` when the kv heads divide the axis, else
  the sequence (over ``("data", "model")`` at batch 1). A
  sequence-sharded cache is read by the sharded flash decode
  (``models/layers.py``: each rank's online softmax over its rows, then a
  maximum and two weighted sums over the group, (B, K, G, D) floats a
  layer).
* **Mixture of experts** (``models/moe.py``). The router is replicated,
  so every model rank computes the same routing, capacity and dispatch
  plan. A rank runs its own experts when they divide the axis (*EP*:
  experts ``[r E/m, (r+1) E/m)``, its rows of the (E, C, d) buffer), else
  its d_ff columns of every expert (*M2*: gate and up column-parallel,
  down row-parallel). Its weighted slots are added in the port's slot
  order into a float32 (T, d) partial, and :func:`reduce_from_model`
  closes the combine (one float32 sum, rounded once). The routing weights
  enter the rank's slots through :func:`copy_to_model`, so their
  cotangent, a partial of the rank's slots, is summed over the group
  before it reaches ``router_w``; the aux loss is computed from the
  replicated routing and counted once.
* **The SSD** (``models/mamba2.py``). z, xBC and dt are column-parallel
  and the depthwise conv runs on the rank's channels; the conv's output is
  then gathered (:func:`gather_from_model`, its backward a reduce-scatter)
  and the rank takes its heads' x columns and the whole of B and C, which
  its column block does not line up with. The scan runs on the rank's
  heads; the gated RMSNorm spans all of ``d_inner``, so its float32 sum
  of squares is summed over the group (:func:`group_sum`, forward and
  backward); ``out_proj`` is row-parallel. Decoding, the SSM state is
  heads-sharded and the conv window channels-sharded, and each tick
  gathers one (B, conv_dim) row a layer.
* **Cross-attention** (whisper). The queries are the decoder's columns,
  k / v the rank's columns of the replicated encoder output, and the
  three forms are self-attention's (in the seq form a rank attends its
  decoder rows against the gathered source). Its cache ``xk`` / ``xv`` is
  heads-sharded when the kv heads divide the axis, else sequence-sharded
  when the source rows do (read by the sharded online softmax without the
  causal mask), else whole.
* **The hybrid's shared block** (zamba2). Its leaves have no leading L,
  so the stacked layers' rules, which match first, lay them out: q / k /
  v and gate / up carry no ``"model"`` and ``attn_wo`` / ``mlp_w_down``
  carry it on their output dim d. So the block computes q, k, v, the
  attention and gate / up whole on every rank, and each of the two output
  products makes the rank's d / m columns of a replicated input and
  gathers them (:func:`out_columns`). Its cache ``attn_k`` / ``attn_v``
  follows ``cache_leaf_spec``: a rank attends its kv heads and the heads'
  outputs are gathered, or the sharded online softmax reads its rows.
* **Mixed specs.** ``param_spec`` drops ``"model"`` from a leaf whose dim
  the axis does not divide. Only the vocabulary tables lose it for the
  published and reduced configs at model 2-16 (whisper's 51,865 rows at
  every model > 1, mamba2's 50,280 at 16); such a table stays whole on
  every rank and takes the plain lookup, whole logits and the plain
  float32 CE, each rank computing the same bits. Any other leaf that
  loses it raises ``NotImplementedError`` naming the leaf and the mesh
  (``models.model.check_model_axis``).
* **Checkpoints** (``checkpoint/checkpoint.py``). A model-sharded run's
  blocks are joined over the mesh (``sharding.join_shards``) and one rank
  writes the unsharded arrays, Mode A's per-voter state stacked in replica
  order: the stacked run's files, array for array. A restore cuts each
  rank's block again (``sharding.shard_tree``) under any mesh.

The layouts the published and reduced configs take (``tests/
test_torch_tp_families.py`` builds each on a world of fake ranks; the
(2, 16, 16) mesh is model 16's column; "-" where the arch has no such
part):

==================== ===== ======= ======= ======= =======
arch (published)     part  model 2 model 4 model 8 model 16
==================== ===== ======= ======= ======= =======
glm4-9b              attn  grouped repeat  repeat  repeat
qwen1.5-32b          attn  grouped grouped grouped seq
deepseek-67b         attn  grouped grouped grouped repeat
gemma3-12b           attn  grouped grouped grouped repeat
pixtral-12b          attn  grouped grouped grouped repeat
qwen2-moe-a2.7b      attn  grouped grouped grouped grouped
qwen2-moe-a2.7b      moe   EP      EP      M2      M2
qwen3-moe-235b-a22b  attn  grouped grouped repeat  repeat
qwen3-moe-235b-a22b  moe   EP      EP      EP      EP
mamba2-2.7b          ssd   heads   heads   heads   heads
mamba2-2.7b          vocab sharded sharded sharded whole
zamba2-1.2b          attn  whole   whole   whole   whole
zamba2-1.2b          ssd   heads   heads   heads   heads
whisper-tiny         attn  grouped seq     seq     seq
whisper-tiny         vocab whole   whole   whole   whole
==================== ===== ======= ======= ======= =======

("whole": zamba2's shared block, its wo and w_down output-sharded.) The
reduced configs (4 heads, 2 kv heads, 4 experts of d_ff 64, vocab 512)
take grouped / repeat / seq attention at model 2 / 4 / 8-16 (zamba2's
shared block whole), the MoE EP at 2 and 4 and M2 at 8 and 16, the SSD
heads-sharded and the vocabulary sharded throughout; every other part not
named above is sharded at every model size.

The vote side of the axis lives in ``core.signum``: each rank votes its
shards over the vote axes; a stochastic adversary draws at a shard's
global coordinates (the counter map of ``kernels/csrc/byzantine.cu``,
``codecs.base.LeafShare.counter_map``), in the fused ZeRO backward over
the rank's block as a whole, as the reference's; a VotePlan is built on
the global leaves and each rank walks its windows of it
(``vote_plan.shard_plan``).
An adaptive adversary raises the reference's ``ValueError`` at the step's
call, as without a model axis.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import mesh as pm


class _CopyToModel(torch.autograd.Function):
    """Forward the identity; backward the sum of the cotangents over the
    model group (the entry of a column-parallel region)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return pm.model_sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward the sum of the partials over the model group, rounded once
    to `dtype`; backward the identity (the exit of a row-parallel
    region)."""

    @staticmethod
    def forward(ctx, x, mesh, dtype):
        ctx.dtype = x.dtype
        return pm.model_sum(x.to(torch.float32), mesh).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _GatherFromModel(torch.autograd.Function):
    """Forward every rank's slice concatenated along `dim` (model-index
    order); backward this rank's block of the cotangents summed over the
    group."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return pm.model_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return pm.model_sum_scatter(g, ctx.mesh, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` (whole on every model rank) entering column-parallel work."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh, dtype=None) -> torch.Tensor:
    """The row-parallel partials `x` summed over the model group, in
    `dtype` (default x's)."""
    return _ReduceFromModel.apply(x, mesh, dtype or x.dtype)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Each rank's slice `x` joined along `dim` in model-index order."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


class _GroupSum(torch.autograd.Function):
    """Forward the sum over the model group of each rank's part (float32,
    model-index order), a statistic every rank's sharded work reads
    whole; backward the same sum of the ranks' cotangents, each a partial
    of its own work's."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return pm.model_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return pm.model_sum(g, ctx.mesh), None


class _GatherColumns(torch.autograd.Function):
    """Forward every rank's columns joined in model-index order; backward
    this rank's block of the cotangent, which is whole on every rank (the
    work after the gather is replicated), unsummed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.cols = mesh, x.shape[-1]
        return pm.model_gather(x, mesh, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.axis_index("model")
        return g[..., r * ctx.cols:(r + 1) * ctx.cols].contiguous(), None


def out_columns(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w`` of a weight whose output columns are sharded and whose
    input is whole (zamba2's shared block: ``param_spec`` gives its
    ``attn_wo`` and ``mlp_w_down`` "model" on the output dim, its q / k /
    v and gate / up none): the replicated x enters the group (its
    cotangent, a partial of the rank's columns, summed over it), the
    rank's columns are made in x's dtype and gathered."""
    return _GatherColumns.apply(copy_to_model(x, mesh) @ w, mesh)


def group_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's part `x` over the model group, read whole
    by each rank's sharded work (the gated RMSNorm's sum of squares)."""
    return _GroupSum.apply(x, mesh)


def enter_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` (whole on every model rank) entering column-parallel work, in
    float32: its cotangent is summed over the group in float32 and rounded
    once to x's dtype."""
    return copy_to_model(x.to(torch.float32), mesh)


def column_parallel(x32: torch.Tensor, w: torch.Tensor, dtype
                    ) -> torch.Tensor:
    """``x @ w`` of a column-parallel weight slice `w` from :func:`enter_model`'s
    float32 input, rounded once to `dtype`."""
    return (x32 @ w.to(torch.float32)).to(dtype)


def row_parallel(h: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``h @ w`` of a row-parallel weight slice `w`: the rank's partial
    product made in float32 (bf16 operands are exact there), summed over
    the model group and rounded once to h's dtype."""
    if h.dtype == torch.float32:
        return reduce_from_model(h @ w, mesh)
    return reduce_from_model(h.to(torch.float32) @ w.to(torch.float32),
                             mesh, h.dtype)


def vocab_range(rows: int, mesh) -> tuple:
    """[start, stop) of the vocabulary rows a rank's table shard holds."""
    start = mesh.axis_index("model") * rows
    return start, start + rows


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, mesh
                 ) -> torch.Tensor:
    """The vocab-parallel embedding: the rank's rows looked up (zeros for
    tokens outside its shard) and summed over the model group, which is
    exact (one rank's row is non-zero)."""
    start, stop = vocab_range(table.shape[0], mesh)
    mine = (tokens >= start) & (tokens < stop)
    local = torch.where(mine, tokens - start, torch.zeros_like(tokens))
    rows = torch.nn.functional.embedding(local, table)
    rows = rows * mine[..., None].to(rows.dtype)
    return reduce_from_model(rows, mesh)


class _VocabParallelCE(torch.autograd.Function):
    """Mean next-token CE over vocab-sharded logits, float32 statistics:
    the maximum over the group, then one sum of the shards' exp-sums and
    target logits; backward (softmax - onehot) * g / n in the logits'
    dtype, the reference's ``_ce_bwd``."""

    @staticmethod
    def forward(ctx, logits, targets, mesh):
        lf = logits.to(torch.float32)
        start, stop = vocab_range(logits.shape[-1], mesh)
        top = pm.model_max(lf.amax(dim=-1), mesh)
        sumexp = torch.exp(lf - top[..., None]).sum(dim=-1)
        mine = (targets >= start) & (targets < stop)
        local = torch.where(mine, targets - start, torch.zeros_like(targets))
        gold = torch.gather(lf, -1, local[..., None].long())[..., 0]
        gold = gold * mine.to(gold.dtype)
        both = pm.model_sum(torch.stack([sumexp, gold]), mesh)
        logz = torch.log(both[0]) + top
        ctx.save_for_backward(logits, local, mine, logz)
        return torch.mean(logz - both[1])

    @staticmethod
    def backward(ctx, g):
        logits, local, mine, logz = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - logz[..., None])
        onehot = torch.zeros_like(p).scatter_(
            -1, local[..., None].long(), mine[..., None].to(p.dtype))
        n = logz.numel()
        return ((p - onehot) * (g / n)).to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mesh
                  ) -> torch.Tensor:
    """The vocab-parallel mean CE of vocab-sharded `logits` (B, S, V/m)
    against global token ids `targets` (B, S); every model rank returns
    the same loss."""
    return _VocabParallelCE.apply(logits, targets, mesh)


__all__ = ["column_parallel", "copy_to_model", "cross_entropy",
           "embed_tokens", "enter_model", "gather_from_model", "group_sum",
           "out_columns",
           "reduce_from_model", "row_parallel", "vocab_range"]
