"""VotePlan: the flat-buffer bucketed vote (``repro.core.vote_plan``;
DESIGN.md §9, §11).

The leaf-wise vote runs one pack -> exchange -> tally -> unpack round per
tensor. A :class:`VotePlan`, built once from the parameter shapes, lays
the voted leaves out in ONE contiguous sign buffer and cuts it into
buckets:

* **layout manifest** — leaf -> offset / length / shape / dtype, leaves
  sorted by name and grouped by codec (deterministic on every host);
* **codec map** — a first-match glob map over leaf names
  (``(("embed*", "ternary2bit"), ("*", "sign1bit"))``); each codec's
  leaves form one contiguous group;
* **bucket schedule** — each group cut into buckets of ``bucket_bytes``
  wire payload, the length rounded UP to the pack alignment (32, or
  ``32 * M`` on ``hierarchical``), so only each group's last bucket is
  ragged.

:func:`run_schedule` walks the schedule over a stacked ``(M, n_params)``
int8 sign buffer with :class:`VirtualBucketWire`, whose ``issue`` (pack +
the virtualised exchange) and ``complete`` (tally + unpack + the codec's
decode) are the strategies' and codecs' own stages, the hand-written
kernels on a CUDA tensor; or over one rank's ``(n_params,)`` signs with
:class:`MeshBucketWire`, whose exchange is the collectives over the vote
axes of a ``distributed.mesh.ProcessMesh`` (hierarchical's segment padded
to ``PACK * data`` before its pack). :func:`plan_vote_signs` and
:func:`plan_tree_vote` are the reference's entry points over the mesh.
``overlap=True`` issues bucket k before bucket k-1 completes; the
per-bucket dataflow is the same, so the votes are bit-identical to the
synchronous walk. A server-stateful codec
(``weighted_vote``) decodes every bucket under weights fixed for the step
and folds ONE flip-rate EMA update over the weighted buckets' true
coordinates, rounded as XLA fuses it (``weighted.ema_update_fused``).
:func:`plan_vote_stacked` is the fused-kernel twin on the
gathered 1-bit wire: one ``fused_majority`` and one ``bitunpack`` per
bucket.

A bucket's columns of the stacked buffer are not contiguous: its rows are
``n_params`` apart. ``bitpack`` takes that row stride, so a 1-bit bucket
(``allgather_1bit``, ``weighted_vote``) is packed in place; ``ternary_pack``
and ``fused_majority`` take contiguous rows, so a bucket that either reads
is copied with ``.contiguous()`` first.

AUTO prices each candidate wire's WHOLE bucket schedule through the α–β
link model of an H100 host (``distributed.comm_model.schedule_time``: one
latency term per bucket message), overlap-aware when the plan is built
with ``overlap=True``, and ``bucket_bytes = AUTO_BUCKET_BYTES`` sweeps a
ladder of bucket sizes per strategy, ties going to the larger bucket: the
reference's selector under the port's constants.

Every walk counts its buckets into ``obs.COUNTERS`` (``plan.buckets``)
and, under an active ``TraceRecorder``, records the reference's
``plan.schedule`` span around the walk and a ``plan.issue`` /
``plan.complete`` span per bucket; the issue span carries ``pred_s``, the
link model's time of the bucket's message over the walk's voters (as the
data axis, pod 1, as the reference prices it). The spans time the host's
launches, not the card's work.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core import codecs as codecs_mod
from repro_torch.core import sign_compress as sc
from repro_torch.core.codecs import weighted
from repro_torch.core.codecs.ternary import TERNARY_WIRE
from repro_torch.core.vote_engine import STRATEGIES, message_parts
from repro_torch.distributed import comm_model
from repro_torch.kernels import ops
from repro_torch.obs import recorder as obs

#: base bucket alignment: lcm of the 1-bit pack (32/word) and the ternary
#: 2-bit pack (16/word), so an aligned bucket enters every wire pad-free
ALIGN = 32

#: sentinel for ``bucket_bytes``: the reference's priced ladder of sizes
AUTO_BUCKET_BYTES = -1


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's slice of the flat buffer (offsets are global)."""

    name: str
    offset: int
    length: int
    shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One schedule entry: a uniform vote over flat[start:start+length].
    `skip` (a rank's window of a bucket over a model axis): ranges of the
    window, relative to its start, that this rank leaves out of the step's
    statistics (replicated leaves, counted on model index 0 only)."""

    codec: str
    strategy: VoteStrategy
    start: int
    length: int
    skip: Tuple[Tuple[int, int], ...] = ()

    @property
    def counted(self) -> int:
        """The coordinates this bucket adds to the step's statistics."""
        return self.length - sum(hi - lo for lo, hi in self.skip)


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """All leaves sharing one codec: a contiguous run of the flat buffer."""

    codec: str
    strategy: VoteStrategy          # resolved, never AUTO
    start: int
    total: int
    leaves: Tuple[LeafSlot, ...]
    buckets: Tuple[Bucket, ...]
    #: the bucket size the schedule was cut at
    bucket_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class VotePlan:
    """The layout manifest + bucket schedule (hashable, static)."""

    groups: Tuple[PlanGroup, ...]
    bucket_bytes: int
    n_params: int

    @property
    def buckets(self) -> Tuple[Bucket, ...]:
        return tuple(b for g in self.groups for b in g.buckets)

    @property
    def leaves(self) -> Tuple[LeafSlot, ...]:
        return tuple(s for g in self.groups for s in g.leaves)

    @property
    def n_buckets(self) -> int:
        return sum(len(g.buckets) for g in self.groups)

    @property
    def has_server_state(self) -> bool:
        return any(codecs_mod.get_codec(g.codec).server_state
                   for g in self.groups)

    @property
    def worker_state_leaves(self) -> Tuple[str, ...]:
        """Leaf names whose codec carries per-worker memory (EF residual)."""
        return tuple(s.name for g in self.groups for s in g.leaves
                     if codecs_mod.get_codec(g.codec).worker_state)

    def leaf_codecs(self) -> Dict[str, str]:
        return {s.name: g.codec for g in self.groups for s in g.leaves}

    def init_server_state(self, n_workers: int, device=None
                          ) -> Dict[str, torch.Tensor]:
        """Union of the schedule's codec server states ({} if stateless)."""
        state: Dict[str, torch.Tensor] = {}
        for g in self.groups:
            state.update(codecs_mod.get_codec(g.codec)
                         .init_server_state(n_workers, device))
        return state

    def schedule_cost(self, data_size: int, pod_size: int = 1,
                      overlap: bool = False) -> float:
        """α–β wall-clock of the whole bucket schedule (one latency term
        per bucket message: what AUTO minimised); with ``overlap=True``
        priced as the double-buffered walk (:func:`run_schedule`)."""
        return _schedule_time(self.buckets, data_size, pod_size, overlap)


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------


def resolve_codec_map(names: Sequence[str],
                      codec_map: Sequence[Tuple[str, str]],
                      default_codec: str = "sign1bit") -> Dict[str, str]:
    """First matching glob wins; unmatched leaves take `default_codec`.
    Every mapped codec name is validated against the registry."""
    for pat, codec in codec_map:
        codecs_mod.get_codec(codec)          # raises on unknown codec
        if not pat:
            raise ValueError("empty glob pattern in codec_map")
    out = {}
    for name in names:
        for pat, codec in codec_map:
            if fnmatch.fnmatchcase(name, pat):
                out[name] = codec
                break
        else:
            out[name] = default_codec
    return out


def _bucket_elems(bucket_bytes: int, bits_per_param: float,
                  align: int) -> int:
    """Bucket length in coordinates: `bucket_bytes` of wire payload,
    rounded UP to `align`."""
    elems = max(1, int(bucket_bytes * 8 / bits_per_param))
    return -(-elems // align) * align


def _group_align(strategy: VoteStrategy, data_size: int) -> int:
    # hierarchical pads each vote to PACK * data_size (its reduce-scatter
    # shards stay word-aligned); aligning its buckets to that keeps one
    # padded lane set per group
    if strategy == VoteStrategy.HIERARCHICAL:
        return ALIGN * max(data_size, 1)
    return ALIGN


def _schedule_time(buckets: Sequence[Bucket], data_size: int,
                   pod_size: int, overlap: bool = False) -> float:
    return comm_model.schedule_time(
        (message_parts(b.strategy, b.length, data_size, pod_size,
                       codecs_mod.get_codec(b.codec).bits_per_param)
         for b in buckets), overlap=overlap).time_s


def _bucket_pred_s(bucket: Bucket, data_size: int) -> float:
    """The link model's time of one bucket's message over `data_size`
    voters and one pod (a ``plan.issue`` span's ``pred_s``)."""
    return comm_model.collective_time(*message_parts(
        bucket.strategy, bucket.length, data_size, 1,
        codecs_mod.get_codec(bucket.codec).bits_per_param)).time_s


def _candidate_bucket_bytes(total: int, bits_per_param: float) -> list:
    """The ladder ``AUTO_BUCKET_BYTES`` sweeps: powers of two below the
    group's whole wire payload, then that payload (one bucket)."""
    total_bytes = max(1, -(-int(total * bits_per_param) // 8))
    ladder = [1 << k for k in range(3, 25) if (1 << k) < total_bytes]
    ladder.append(total_bytes)
    return ladder


def _resolve_group(codec_name: str, strategy: VoteStrategy, total: int,
                   bucket_bytes: int, data_size: int, pod_size: int,
                   overlap: bool = False) -> Tuple[VoteStrategy, int]:
    """Concrete (strategy, bucket_bytes) for one codec group: each
    candidate wire (and with ``AUTO_BUCKET_BYTES`` each size of the
    ladder) priced on its whole bucket schedule, the cheapest kept, a tie
    going to the larger bucket (fewer messages), then to the earlier
    candidate."""
    codec = codecs_mod.get_codec(codec_name)
    if strategy != VoteStrategy.AUTO:
        codec.validate_strategy(strategy)
        candidates = [strategy]
    else:
        candidates = list(codec.supported_strategies)
        if data_size * pod_size <= 1:
            candidates = [VoteStrategy.PSUM_INT8
                          if VoteStrategy.PSUM_INT8 in candidates
                          else candidates[0]]
    bits = codec.bits_per_param
    sizes = ([bucket_bytes] if bucket_bytes != AUTO_BUCKET_BYTES else
             _candidate_bucket_bytes(total, bits))
    best = None
    for cand in candidates:
        for bb in sizes:
            # _cut_buckets' schedule as runs of equal buckets: the full
            # ones, then the ragged last
            elems = _bucket_elems(bb, bits, _group_align(cand, data_size))
            full, last = divmod(total, elems)
            runs = ((*message_parts(cand, length, data_size, pod_size,
                                    bits), count)
                    for length, count in ((elems, full),
                                          (last, 1 if last else 0)))
            cost = comm_model.repeated_schedule_time(runs, overlap).time_s
            key = (cost, -bb)
            if best is None or key < best[0]:
                best = (key, cand, bb)
    return best[1], best[2]


def _cut_buckets(codec_name: str, strategy: VoteStrategy, start: int,
                 total: int, bucket_bytes: int, data_size: int
                 ) -> Tuple[Bucket, ...]:
    bits = codecs_mod.get_codec(codec_name).bits_per_param
    elems = _bucket_elems(bucket_bytes, bits,
                          _group_align(strategy, data_size))
    out = []
    off = 0
    while off < total:
        length = min(elems, total - off)
        out.append(Bucket(codec=codec_name, strategy=strategy,
                          start=start + off, length=length))
        off += length
    return tuple(out)


def build_plan(shapes: Dict[str, Tuple[int, ...]], *, bucket_bytes: int,
               codec_map: Sequence[Tuple[str, str]] = (),
               default_codec: str = "sign1bit",
               strategy: VoteStrategy = VoteStrategy.AUTO,
               data_size: int = 1, pod_size: int = 1,
               dtypes: Optional[Dict[str, str]] = None,
               overlap: bool = False) -> VotePlan:
    """Build the static plan for a tree of `shapes` (leaf name -> shape),
    as the reference does: leaves in sorted-name order, grouped by their
    resolved codec (groups in order of first appearance).
    ``bucket_bytes=AUTO_BUCKET_BYTES`` (-1) sweeps a ladder of sizes per
    strategy; ``overlap`` prices the candidates as the double-buffered walk
    (it changes the selector's arithmetic only: the manifest never depends
    on how the schedule will be walked)."""
    if bucket_bytes <= 0 and bucket_bytes != AUTO_BUCKET_BYTES:
        raise ValueError(
            f"bucket_bytes must be positive (or AUTO_BUCKET_BYTES=-1 for "
            f"the priced ladder), got {bucket_bytes}")
    names = sorted(shapes)
    if not names:
        raise ValueError("cannot build a VotePlan over an empty tree")
    leaf_codec = resolve_codec_map(names, codec_map, default_codec)
    codec_order = []
    for name in names:
        if leaf_codec[name] not in codec_order:
            codec_order.append(leaf_codec[name])
    groups = []
    offset = 0
    for codec_name in codec_order:
        members = [n for n in names if leaf_codec[n] == codec_name]
        slots, start = [], offset
        for n in members:
            shape = tuple(shapes[n])
            length = 1
            for d in shape:
                length *= d
            slots.append(LeafSlot(
                name=n, offset=offset, length=length, shape=shape,
                dtype=(dtypes or {}).get(n, "float32")))
            offset += length
        total = offset - start
        resolved, group_bytes = _resolve_group(
            codec_name, strategy, total, bucket_bytes, data_size,
            pod_size, overlap)
        groups.append(PlanGroup(
            codec=codec_name, strategy=resolved, start=start, total=total,
            leaves=tuple(slots),
            buckets=_cut_buckets(codec_name, resolved, start, total,
                                 group_bytes, data_size),
            bucket_bytes=group_bytes))
    return VotePlan(groups=tuple(groups), bucket_bytes=bucket_bytes,
                    n_params=offset)


# ---------------------------------------------------------------------------
# a rank's part of a plan over a model axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run ``[lo, hi)`` of a rank's flat buffer whose stochastic draws
    take the counter map ``(offset, block, gap)`` (``core.prng``): one
    sharded leaf's block, or adjacent replicated leaves."""

    lo: int
    hi: int
    offset: int
    block: int = 0
    gap: int = 0


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A rank's part of a :class:`VotePlan` built on the global leaves,
    over a mesh's model axis. `plan` is the rank's own layout: its blocks
    of the leaves in manifest order at local offsets (a replicated leaf
    whole), and, for every global bucket ``[a, b)``, the one contiguous
    window of the local buffer whose global coordinates fall in it (inside
    a leaf the global row-major index grows with the local one), empty
    windows dropped; `segments` map the buffer to the global flat
    counters; `counted` lists the local ranges this rank counts in a sum
    over the model group (a replicated leaf on model index 0 only)."""

    plan: VotePlan
    segments: Tuple[Segment, ...]
    counted: Tuple[Tuple[int, int], ...]


def _local_below(segments: Sequence[Segment], g: int) -> int:
    """How many of the rank's local elements draw at a global flat index
    below `g` (monotone in `g`): a segment's local element l sits at
    ``offset + l + (l // block) * gap``, runs of `block` apart by `gap`."""
    out = 0
    for seg in segments:
        t = g - seg.offset
        if t <= 0:
            break
        if seg.block:
            row, rem = divmod(t, seg.block + seg.gap)
            t = row * seg.block + min(rem, seg.block)
        out += min(t, seg.hi - seg.lo)
    return out


def shard_plan(plan: VotePlan, shares) -> ShardPlan:
    """This rank's :class:`ShardPlan` of `plan` (built on the global leaves)
    from each leaf's ``codecs.base.LeafShare`` (`shares`; a leaf without
    one is whole)."""
    first = next(iter(shares.values())).mesh.axis_index("model") == 0 \
        if shares else True
    local_slots, segments, counted = {}, [], []
    off = 0
    for slot in plan.leaves:
        share = shares.get(slot.name)
        local_shape = list(slot.shape)
        length = slot.length
        if share is not None and share.sharded:
            local_shape[share.dim] //= share.parts
            length //= share.parts
        local_slots[slot.name] = LeafSlot(
            name=slot.name, offset=off, length=length,
            shape=tuple(local_shape), dtype=slot.dtype)
        if share is not None:
            cut = share.counter_map(local_shape, offset=slot.offset)
        else:
            cut = {"offset": slot.offset, "block": 0, "gap": 0}
        seg = Segment(off, off + length, **cut)
        prev = segments[-1] if segments else None
        if (prev is not None and not prev.block and not seg.block
                and prev.hi == seg.lo
                and prev.offset + (prev.hi - prev.lo) == seg.offset):
            segments[-1] = dataclasses.replace(prev, hi=seg.hi)
        else:
            segments.append(seg)
        if first or (share is not None and share.sharded):
            if counted and counted[-1][1] == off:
                counted[-1] = (counted[-1][0], off + length)
            else:
                counted.append((off, off + length))
        off += length
    groups = []
    for g in plan.groups:
        windows = []
        for b in g.buckets:
            lo = _local_below(segments, b.start)
            hi = _local_below(segments, b.start + b.length)
            if hi <= lo:
                continue
            skip, at = [], lo
            for c_lo, c_hi in counted:      # the gaps between counted runs
                if c_lo > at:
                    skip.append((at, min(c_lo, hi)))
                at = max(at, c_hi)
                if at >= hi:
                    break
            if at < hi:
                skip.append((at, hi))
            windows.append(dataclasses.replace(
                b, start=lo, length=hi - lo,
                skip=tuple((a - lo, z - lo) for a, z in skip if z > a)))
        leaves = tuple(local_slots[s.name] for s in g.leaves)
        start = leaves[0].offset
        total = sum(s.length for s in leaves)
        groups.append(dataclasses.replace(g, start=start, total=total,
                                          leaves=leaves,
                                          buckets=tuple(windows)))
    local = VotePlan(groups=tuple(groups), bucket_bytes=plan.bucket_bytes,
                     n_params=off)
    return ShardPlan(plan=local, segments=tuple(segments),
                     counted=tuple(counted))


# ---------------------------------------------------------------------------
# flatten / unflatten (the layout round-trip)
# ---------------------------------------------------------------------------


def check_size(slot: LeafSlot, values: torch.Tensor) -> None:
    """Raise the reference's ``ValueError`` unless `values` has the
    slot's number of elements."""
    if values.numel() != slot.length:
        raise ValueError(
            f"leaf {slot.name!r} has shape {tuple(values.shape)}, plan "
            f"manifest says {slot.shape}")


def write_signs(slot: LeafSlot, values: torch.Tensor,
                out: torch.Tensor) -> None:
    """``sign_ternary`` of one leaf's `values` into its slice of the flat
    int8 buffer `out` (``(n_params,)``, or a voter's row of the stacked
    buffer)."""
    check_size(slot, values)
    sc.sign_ternary(values.reshape(-1),
                    out=out[slot.offset:slot.offset + slot.length])


def flatten_signs(plan: VotePlan, tree: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Tree of one voter's values -> (n_params,) int8 ternary signs in
    manifest order (sign extraction per leaf, as the trainer's plan path
    writes each voter's row with :func:`write_signs`)."""
    out = torch.empty(plan.n_params, dtype=torch.int8,
                      device=tree[plan.leaves[0].name].device)
    for slot in plan.leaves:
        leaf = tree[slot.name]
        if tuple(leaf.shape) != slot.shape:
            raise ValueError(
                f"leaf {slot.name!r} has shape {tuple(leaf.shape)}, plan "
                f"manifest says {slot.shape}")
        write_signs(slot, leaf, out)
    return out


def unflatten_votes(plan: VotePlan, flat: torch.Tensor,
                    tree: Dict[str, torch.Tensor]) -> Dict:
    """(n_params,) flat votes -> tree of leaf-shaped votes in each leaf's
    own dtype (the inverse of :func:`flatten_signs`)."""
    return {slot.name: flat[slot.offset:slot.offset + slot.length]
            .view(slot.shape).to(tree[slot.name].dtype)
            for slot in plan.leaves}


# ---------------------------------------------------------------------------
# execution: the schedule executor (DESIGN.md §11)
# ---------------------------------------------------------------------------


class VirtualBucketWire:
    """issue/complete of one bucket over a stacked ``(M, n)`` voter dim,
    the exchange replaced by its exact equivalent (the reference's
    ``VirtualBucketWire``)."""

    def __init__(self, m: int):
        self.m = m

    def issue(self, bucket: Bucket, seg: torch.Tensor) -> torch.Tensor:
        m = self.m
        if bucket.codec == "ternary2bit" \
                and bucket.strategy == VoteStrategy.ALLGATHER_1BIT:
            return TERNARY_WIRE.pack(seg.contiguous(), m)  # gathered
        if bucket.codec == "weighted_vote":   # bitpack reads the view
            return STRATEGIES[VoteStrategy.ALLGATHER_1BIT].pack(seg, m)
        impl = STRATEGIES[bucket.strategy]
        if bucket.strategy == VoteStrategy.PSUM_INT8:
            wire = impl.pack(seg, m)
            # psum over the voters == sum over the voter dim, in the wire
            # dtype (safe: |sum| <= M <= dtype max)
            return torch.sum(wire, dim=0, dtype=wire.dtype)
        if bucket.strategy == VoteStrategy.ALLGATHER_1BIT:
            return impl.pack(seg, m)          # bitpack reads the view
        if bucket.strategy == VoteStrategy.HIERARCHICAL:
            # one virtual pod: the data axis is all M voters; pad so the
            # reduce-scatter shards stay word-aligned
            padded, _ = sc.pad_last(seg, sc.PACK * m)
            wire = impl.pack(padded, m)
            summed = torch.sum(wire, dim=0, dtype=wire.dtype)
            return summed.view(m, -1)
        raise ValueError(f"virtual wire cannot realise {bucket.strategy!r}")

    def complete(self, bucket: Bucket, arrived: torch.Tensor,
                 w: Optional[Sequence[float]]):
        """-> (votes int8 (length,), mismatch (M,) int64 or None)."""
        m = self.m
        if bucket.codec == "ternary2bit" \
                and bucket.strategy == VoteStrategy.ALLGATHER_1BIT:
            return TERNARY_WIRE.unpack(TERNARY_WIRE.tally(arrived, m),
                                       bucket.length, torch.int8), None
        if bucket.codec == "weighted_vote":
            # the padding lanes are cropped before the decode
            return weighted.decode_leaf_fixed(
                weighted.stacked_signs(arrived, bucket.length), w)
        impl = STRATEGIES[bucket.strategy]
        return impl.unpack(impl.tally(arrived, m), bucket.length,
                           torch.int8), None


class MeshBucketWire:
    """issue/complete of one bucket over the collectives of the bound vote
    `axes` (``mesh.VoteAxes``), each rank holding its own segment (the
    reference's ``MeshBucketWire``)."""

    def __init__(self, axes):
        self.axes = axes

    def issue(self, bucket: Bucket, seg: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed.mesh import axis_size, num_voters
        m, row = num_voters(self.axes), seg.reshape(1, -1)
        if bucket.codec == "ternary2bit" \
                and bucket.strategy == VoteStrategy.ALLGATHER_1BIT:
            return TERNARY_WIRE.exchange(TERNARY_WIRE.pack(row, m),
                                         self.axes)
        if bucket.codec == "weighted_vote":
            impl = STRATEGIES[VoteStrategy.ALLGATHER_1BIT]
            return impl.exchange(impl.pack(row, m), self.axes)
        impl = STRATEGIES[bucket.strategy]
        if bucket.strategy == VoteStrategy.HIERARCHICAL:
            # the reduce-scatter's shards stay word-aligned: pad to
            # PACK * data BEFORE the pack
            row, _ = sc.pad_last(row, sc.PACK * axis_size(self.axes, "data"))
            return impl.exchange(impl.pack(row.view(-1), m), self.axes)
        return impl.exchange(impl.pack(row, m), self.axes)

    def complete(self, bucket: Bucket, arrived: torch.Tensor,
                 w: Optional[Sequence[float]]):
        """-> (votes int8 (length,), mismatch (M,) int64 or None)."""
        from repro_torch.distributed.mesh import num_voters
        m = num_voters(self.axes)
        if bucket.codec == "ternary2bit" \
                and bucket.strategy == VoteStrategy.ALLGATHER_1BIT:
            return TERNARY_WIRE.unpack(TERNARY_WIRE.tally(arrived, m),
                                       bucket.length, torch.int8), None
        if bucket.codec == "weighted_vote":
            stacked = weighted.stacked_signs(arrived, bucket.length)
            vote, mismatch = weighted.decode_leaf_fixed(stacked, w)
            for lo, hi in bucket.skip:     # not this rank's to count
                mismatch -= (stacked[:, lo:hi] != vote[lo:hi]).sum(1)
            return vote, mismatch
        impl = STRATEGIES[bucket.strategy]
        if bucket.strategy == VoteStrategy.HIERARCHICAL:
            # the unpack stage carries the second collective, the packed
            # all-gather of the shard decisions
            return impl.gather_unpack(impl.tally(arrived, m), bucket.length,
                                      torch.int8, self.axes), None
        return impl.unpack(impl.tally(arrived, m), bucket.length,
                           torch.int8).view(-1), None


def run_schedule(plan: VotePlan, buf: torch.Tensor, wire,
                 server_state=None, overlap: bool = False, reduce=None):
    """Walk the bucket schedule over `buf`, the ``(M, n_params)`` stacked
    int8 signs on a :class:`VirtualBucketWire` or this rank's
    ``(n_params,)`` (or ``(1, n_params)``) signs on a
    :class:`MeshBucketWire` -> ((n_params,) int8 votes, new server state).

    ``overlap=False`` completes each bucket before issuing the next;
    ``overlap=True`` issues bucket k, THEN completes bucket k-1. The
    per-bucket dataflow is the same, so the two walks are bit-identical.
    Server-stateful codecs decode every bucket under weights fixed for the
    step and fold ONE flip-rate EMA update across the schedule, over the
    weighted buckets' true coordinate count. Over a model axis (`plan` a
    :class:`ShardPlan`'s windows) `reduce` sums an int64 tensor over the
    model group: the mismatch counts and coordinates are then the global
    leaves', each bucket's `skip` ranges left out on this rank."""
    state = dict(server_state) if server_state else {}
    w = None
    if plan.has_server_state:
        if "flip_ema" not in state:
            raise ValueError(
                "plan carries a server-stateful codec; thread its server "
                "state (init_server_state) through the request")
        ema = torch.as_tensor(state["flip_ema"], dtype=torch.float32,
                              device=buf.device)
        w = weighted.reliability_weights(ema).tolist()
    buckets = plan.buckets
    obs.COUNTERS.inc("plan.buckets", len(buckets))
    rec = obs.get_recorder()
    votes = torch.empty(plan.n_params, dtype=torch.int8, device=buf.device)
    mismatch, total_w = None, 0
    if w is not None and reduce is not None:
        # every model rank takes part in the sum, with or without a window
        mismatch = torch.zeros(len(w), dtype=torch.int64, device=buf.device)
    if rec.enabled:
        # pred_s prices the walk's voters as the data axis, as the
        # reference does: the virtual wire's stack is its own mesh
        from repro_torch.distributed.mesh import num_voters
        data = wire.m if hasattr(wire, "m") else num_voters(wire.axes)

    def issue(k: int) -> torch.Tensor:
        b = buckets[k]
        with rec.span("plan.issue", bucket=k, codec=b.codec,
                      strategy=b.strategy.value, length=b.length,
                      pred_s=(_bucket_pred_s(b, data) if rec.enabled
                              else None)):
            return wire.issue(b, buf[..., b.start:b.start + b.length])

    def complete(k: int, inflight) -> None:
        nonlocal mismatch, total_w
        b = buckets[k]
        with rec.span("plan.complete", bucket=k, codec=b.codec,
                      strategy=b.strategy.value):
            vote, mis = wire.complete(b, inflight, w)
        votes[b.start:b.start + b.length] = vote
        if mis is not None:
            mismatch = mis if mismatch is None else mismatch + mis
            total_w += b.counted

    with rec.span("plan.schedule", n_buckets=len(buckets),
                  overlap=bool(overlap and len(buckets) > 1)):
        if overlap and len(buckets) > 1:
            inflight = issue(0)
            for k in range(1, len(buckets)):
                nxt = issue(k)
                complete(k - 1, inflight)
                inflight = nxt
            complete(len(buckets) - 1, inflight)
        else:
            for k in range(len(buckets)):
                complete(k, issue(k))
    if mismatch is not None:
        if reduce is not None:
            both = reduce(torch.cat([mismatch.to(torch.int64), torch.tensor(
                [total_w], dtype=torch.int64, device=mismatch.device)]))
            mismatch, total_w = both[:-1], int(both[-1])
        state["flip_ema"] = weighted.ema_update_fused(ema, mismatch,
                                                      total_w)
    return votes, state


def plan_vote_signs(plan: VotePlan, flat_signs: torch.Tensor, axes,
                    server_state=None):
    """The bucket walk over this rank's (n_params,) effective int8 signs
    inside the vote `axes` -> ((n_params,) int8 votes, new server state),
    as a leaf-form VoteRequest on ``MeshBackend``."""
    from repro_torch.core import vote_api as va
    out = va.MeshBackend(axes=axes, device=flat_signs.device).execute(
        va.VoteRequest(payload=flat_signs, form="leaf", plan=plan,
                       server_state=server_state))
    return out.votes, out.server_state


def plan_tree_vote(plan: VotePlan, tree, axes, byz=None, step=None,
                   salt: int = 0, server_state=None,
                   diagnostics: bool = False):
    """The trainer's plan path over the mesh: a tree of this rank's values
    -> (±1/0 tree in the leaf dtypes, new server state, diagnostics dict),
    as a tree-form VoteRequest on ``MeshBackend``."""
    from repro_torch.core import vote_api as va
    device = next(iter(tree.values())).device
    out = va.MeshBackend(axes=axes, device=device).execute(va.VoteRequest(
        payload=tree, form="tree", plan=plan,
        failures=va.FailureSpec(byz=byz), step=step, salt=salt,
        server_state=server_state, diagnostics=diagnostics))
    diag = {}
    if diagnostics:
        diag = {"vote_margin": out.wire.margin,
                "vote_agreement": out.wire.agreement}
    return out.votes, out.server_state, diag


# ---------------------------------------------------------------------------
# execution: the stacked fused-kernel path
# ---------------------------------------------------------------------------


def plan_vote_stacked(plan: VotePlan, stacked: torch.Tensor,
                      use_kernels: bool = True) -> torch.Tensor:
    """The stacked ``(M, n_params)`` values -> (n_params,) int8 votes, per
    bucket on the bucket's uniform shape: a 1-bit bucket with ONE
    ``fused_majority`` and ONE ``bitunpack`` launch (``use_kernels=False``:
    the staged ``bitpack`` -> ``majority`` -> ``bitunpack``, the same
    decision), a ternary bucket with ``ternary_pack`` -> ``ternary_majority``
    -> ``ternary_unpack``.

    Realises the GATHERED wire only: the binary majority (ties -> +1) is
    ``allgather_1bit``'s tie rule, and there is no server-state decode, so
    other plans are rejected with the reference's reasons."""
    for bucket in plan.buckets:
        if bucket.strategy != VoteStrategy.ALLGATHER_1BIT:
            raise ValueError(
                f"plan_vote_stacked realises the gathered 1-bit wire; "
                f"bucket strategy {bucket.strategy.value!r} has different "
                "tie semantics (use plan_vote_signs / virtual_plan_vote)")
        if bucket.codec == "weighted_vote":
            raise ValueError(
                "plan_vote_stacked has no server-state decode; route "
                "weighted_vote plans through virtual_plan_vote")
    votes = torch.empty(plan.n_params, dtype=torch.int8,
                        device=stacked.device)
    for bucket in plan.buckets:
        seg = stacked[:, bucket.start:bucket.start + bucket.length]
        out = votes[bucket.start:bucket.start + bucket.length]
        if bucket.codec == "ternary2bit":
            out.copy_(TERNARY_WIRE.vote(seg.contiguous()))
        elif use_kernels:
            out.copy_(ops.bitunpack(ops.fused_majority(seg.contiguous()),
                                    bucket.length, torch.int8))
        else:   # bitpack reads the view
            out.copy_(ops.bitunpack(ops.majority(ops.bitpack(seg)),
                                    bucket.length, torch.int8))
    return votes


__all__ = [
    "ALIGN", "AUTO_BUCKET_BYTES", "Bucket", "LeafSlot", "MeshBucketWire",
    "PlanGroup", "Segment", "ShardPlan", "VirtualBucketWire", "VotePlan",
    "build_plan", "flatten_signs", "plan_tree_vote", "plan_vote_signs",
    "plan_vote_stacked", "resolve_codec_map", "run_schedule", "shard_plan",
    "unflatten_votes", "write_signs",
]
