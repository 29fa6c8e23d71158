"""The vote mesh over ``torch.distributed`` process groups: the port's
counterpart of what the reference takes from ``jax.sharding.Mesh`` and
``repro.compat`` (``axis_size`` / ``axis_index`` / ``all_gather`` /
``psum`` / ``psum_scatter`` inside a manual ``shard_map`` region).

    dist.init_process_group("gloo", init_method=..., rank=r, world_size=4)
    mesh = ProcessMesh((2, 2), ("pod", "data"))        # every rank calls it
    axes = mesh.vote_axes                               # ("pod", "data")
    counts = psum(signs.to(torch.int8), axes)

A :class:`ProcessMesh` lays the vote axes ``"pod"`` and ``"data"`` and the
tensor-parallel axis ``"model"`` over ranks of an initialised world,
row-major over ``("pod", "data", "model")`` as ``jax.make_mesh`` lays its
devices: the rank at coordinates ``(p, d, m)`` is ``ranks[(p * data + d) *
model + m]``. Each ``(p, d)`` is one voter, whose ``model`` ranks hold the
slices of one replica of the parameters (``distributed.tensor_parallel``);
its replica index over ``(pod, data)`` is ``p * data + d``, as
``byzantine.replica_index`` counts it in the reference, whatever the model
index. :attr:`ProcessMesh.size` counts the voters and
:attr:`ProcessMesh.world` the ranks.

The process groups of each line of ranks (one per row of the mesh along
each axis: the vote groups over pod, data or both at a fixed model index,
the model group at a fixed (pod, data), and the (data, model) group of a
batch-1 serving cache) are created when the mesh is built, by every rank
of the world in the same order (``torch.distributed.new_group`` is
collective), and cached by their rank set, so building the same mesh
again, or a mesh of the first M ranks for a smaller drill, creates nothing
new. A rank outside the mesh builds it too and is no member
(:attr:`member`). A group of one rank needs no process group: its
collectives are the identity, so a one-rank mesh works without
``torch.distributed``.

The same collectives run on every backend; each group's backend
(``torch.distributed.get_backend(group)``) decides how a tensor reaches
it. Gloo takes CPU tensors, so a CUDA tensor is staged through a pinned
host buffer (one per direction, grown to the largest tensor so far) and
the result copied back to the card; NCCL takes the device tensor itself.
The tensor forms of the collectives are ``all_gather_into_tensor`` and
``reduce_scatter_tensor``, which every PyTorch from 2.0 has (2.11 has no
``*_single`` forms; 2.13 has both and warns that these are deprecated).
Neither backend carries
int16 (gloo raises "Invalid scalar type", NCCL has no such type), so an
int16 count tensor (``vote_engine.count_dtype`` of 128-32,767 voters) is
widened to int32 on the wire and narrowed after; the sums are the same.

Every collective adds the bytes this rank handed it, its host time and
one to its count into the :class:`WireStats` of its axis: the vote axes'
into :attr:`ProcessMesh.stats`, the model axis' into
:attr:`ProcessMesh.model_stats` (:meth:`ProcessMesh.reset_stats` zeroes
both).

The model group's collectives (:func:`model_sum`, :func:`model_max`,
:func:`model_gather`, :func:`model_sum_scatter`) serve tensor parallelism.
A float sum over the model group is the float32 sum of the ranks' parts
taken in model-index order, ``((part_0 + part_1) + part_2) + ...``, and
rounded once to the parts' dtype, so every rank holds the same bits and
the order does not depend on the backend's reduction (an all-reduce's
order is the backend's). Over two ranks, or for a tensor under
``A2A_MIN_BYTES`` of float32, the parts are all-gathered and each rank
adds them itself; a larger one over more ranks is cut into as many blocks
as ranks, an all-to-all hands rank i every rank's block i, which it adds
in the same order, and an all-gather of the blocks' sums follows: the same
sums, with (k - 1) / k of the tensor received twice instead of k - 1
times (:func:`model_sum_bytes` counts what each rank hands over). An
integer sum is exact in any order and takes the all-reduce.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: the vote axes, outermost first (the reference's ``vote_axes_in`` order)
VOTE_AXES = ("pod", "data")
#: every axis of a mesh, outermost first (rank-major order)
MESH_AXES = VOTE_AXES + ("model",)

#: process groups by sorted rank tuple, created collectively and kept
_GROUPS: Dict[Tuple[int, ...], object] = {}
#: pinned host byte buffers by role ("src", "dst") for gloo's staging of
#: CUDA tensors, each grown to the largest request so far
_STAGING: Dict[str, torch.Tensor] = {}


def _group(ranks: Tuple[int, ...]):
    """The process group of `ranks` (None for one rank), created on its
    first request. Every rank of the world must request the same groups in
    the same order."""
    if len(ranks) == 1:
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


@dataclasses.dataclass
class WireStats:
    """What this rank handed to the collectives since the last reset."""

    bytes: int = 0
    seconds: float = 0.0
    calls: int = 0


class ProcessMesh:
    """The ``(pod, data, model)`` mesh over ranks of the initialised world.

    `shape` and `axis_names` follow ``jax.sharding.Mesh``: e.g. ``(4,),
    ("data",)``, ``(2, 4), ("pod", "data")`` or ``(4, 2), ("data",
    "model")``. `ranks` are the world ranks laid out row-major over
    ``("pod", "data", "model")`` (default ``0 .. world-1``). Build it on
    every rank of the world, in the same order as every other mesh."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "differ in length")
        for a, s in zip(names, shape):
            if a not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                                 f"{MESH_AXES}")
            if s < 1:
                raise ValueError(f"axis {a!r} has size {s}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names {names} repeat an axis")
        sizes = dict(zip(names, shape))
        self.axis_names = tuple(a for a in VOTE_AXES if a in sizes)
        self.pod = sizes.get("pod", 1)
        self.data = sizes.get("data", 1)
        self.model = sizes.get("model", 1)
        #: the mesh's axes as given (the reference's ``mesh.axis_names``)
        self.mesh_axes = tuple(a for a in MESH_AXES if a in sizes)
        self.size = self.pod * self.data
        self.world = self.size * self.model
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks = (tuple(range(self.world)) if ranks is None
                      else tuple(int(r) for r in ranks))
        if len(self.ranks) != self.world:
            raise ValueError(f"a {self.pod} x {self.data} x {self.model} "
                             f"mesh needs {self.world} ranks, got "
                             f"{len(self.ranks)}")
        if max(self.ranks) >= world:
            raise ValueError(f"the mesh needs ranks {self.ranks}; the world "
                             f"has {world} (initialise torch.distributed "
                             "with enough ranks)")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.member = self.rank in self.ranks
        pos = self.ranks.index(self.rank) if self.member else 0
        voter, m = divmod(pos, self.model)
        self.coords = {"pod": voter // self.data, "data": voter % self.data,
                       "model": m}
        self.stats = WireStats()
        self.model_stats = WireStats()
        # every group of the mesh, in one order on every rank
        self._groups = {}
        for key in self._group_keys():
            ranks = self._line(*key)
            self._groups[key] = (ranks, _group(ranks))

    def _at(self, p: int, d: int, m: int) -> int:
        return self.ranks[(p * self.data + d) * self.model + m]

    def _group_keys(self):
        """(axes, fixed coordinates) of every line of the mesh, in one
        order: each axis set varies its axes over the others held fixed."""
        sets = (("data",), ("pod",), ("pod", "data"), ("model",),
                ("data", "model"))
        for names in sets:
            fixed = [a for a in MESH_AXES if a not in names]
            sizes = [self.axis_size(a) for a in fixed]
            for flat in range(int(np.prod(sizes))):
                at, rest = {}, flat
                for a, n in zip(reversed(fixed), reversed(sizes)):
                    rest, at[a] = divmod(rest, n)
                yield (names, tuple(at[a] for a in fixed))

    def _line(self, names, fixed) -> Tuple[int, ...]:
        """The world ranks of the line varying `names` through `fixed`
        (the other axes' coordinates, outermost first), rank-major."""
        others = [a for a in MESH_AXES if a not in names]
        at = dict(zip(others, fixed))
        out = []
        for p in (range(self.pod) if "pod" in names else [at["pod"]]):
            for d in (range(self.data) if "data" in names
                      else [at["data"]]):
                for m in (range(self.model) if "model" in names
                          else [at["model"]]):
                    out.append(self._at(p, d, m))
        return tuple(out)

    def __repr__(self):
        return (f"ProcessMesh(pod={self.pod}, data={self.data}, "
                f"model={self.model}, ranks={self.ranks}, rank={self.rank})")

    @property
    def vote_axes(self) -> "VoteAxes":
        """The mesh's vote axes, bound to it."""
        return VoteAxes(self.axis_names, self)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """{axis: size} of the axes the mesh was built with (the
        reference's ``dict(zip(mesh.axis_names, mesh.devices.shape))``)."""
        return {a: self.axis_size(a) for a in self.mesh_axes}

    def axis_size(self, name: str) -> int:
        return {"pod": self.pod, "data": self.data, "model": self.model}[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def replica_index(self) -> int:
        """This rank's voter index, pod-major (``p * data + d``)."""
        return self.coords["pod"] * self.data + self.coords["data"]

    def reset_stats(self) -> WireStats:
        """Zero the wire statistics of every axis; returns the vote axes'
        before."""
        old, self.stats = self.stats, WireStats()
        self.model_stats = WireStats()
        return old

    # ---- groups ---------------------------------------------------------

    def group_of(self, names: Sequence[str]):
        """(ranks, process group) of the line through this rank that
        varies the axes `names` (the vote axes at this rank's model index,
        the model axis at its (pod, data), or (data, model) at its pod);
        no axis is this rank alone."""
        names = tuple(a for a in MESH_AXES if a in names)
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        if not names:
            return (self.rank,), None
        if names not in (("data",), ("pod",), ("pod", "data"), ("model",),
                         ("data", "model")):
            raise ValueError(f"no process group varies {names}")
        fixed = tuple(self.coords[a] for a in MESH_AXES if a not in names)
        return self._groups[(names, fixed)]

    # ---- staging --------------------------------------------------------

    @staticmethod
    def _stage(x: torch.Tensor, role: str, backend: str, numel: int = 0
               ) -> torch.Tensor:
        """`x` (or an empty buffer of `numel` elements of x's dtype) where
        a group of `backend` reads it: a pinned host buffer for a CUDA
        tensor on gloo, the tensor itself otherwise."""
        n = numel or x.numel()
        if not (x.is_cuda and backend == "gloo"):
            return x.reshape(-1) if not numel else torch.empty(
                n, dtype=x.dtype, device=x.device)
        nbytes = n * x.element_size()
        raw = _STAGING.get(role)
        if raw is None or raw.numel() < nbytes:
            _STAGING.pop(role, None)
            raw = _STAGING[role] = torch.empty(nbytes, dtype=torch.uint8,
                                               pin_memory=True)
        buf = raw[:nbytes].view(x.dtype)
        if not numel:
            buf.copy_(x.reshape(-1))
        return buf

    def _run(self, x: torch.Tensor, fn, out_numel: int, group,
             stats: Optional[WireStats] = None) -> torch.Tensor:
        """Run the collective `fn(src, dst)` of process group `group` on
        `x`, widening int16 to int32; returns a new flat tensor of
        `out_numel` elements on x's device, in x's dtype. The bytes go to
        `stats` (default the vote axes')."""
        src = x.to(torch.int32) if x.dtype == torch.int16 else x
        backend = dist.get_backend(group)
        t0 = time.perf_counter()
        s = self._stage(src, "src", backend)
        d = self._stage(src, "dst", backend, out_numel)
        fn(s, d)
        # a staging buffer is reused by the next call: copy out of it
        out = d if d.device == x.device else d.to(x.device)
        if out.dtype != x.dtype:
            out = out.to(x.dtype)
        stats = self.stats if stats is None else stats
        stats.bytes += src.numel() * src.element_size()
        stats.seconds += time.perf_counter() - t0
        stats.calls += 1
        return out


class VoteAxes(tuple):
    """The names of the vote axes (a tuple, outermost first), bound to the
    :class:`ProcessMesh` they run over. Empty is the M = 1 case: no
    collective at all."""

    mesh: Optional[ProcessMesh]

    def __new__(cls, names: Sequence[str] = (),
                mesh: Optional[ProcessMesh] = None):
        axes = super().__new__(cls, tuple(names))
        if axes and mesh is None:
            raise ValueError(f"vote axes {tuple(names)} need the ProcessMesh "
                             "they run over")
        axes.mesh = mesh
        return axes


def _mesh(axes) -> ProcessMesh:
    mesh = getattr(axes, "mesh", None)
    if mesh is None:
        raise ValueError(
            f"vote axes {tuple(axes)} are not bound to a ProcessMesh "
            "(use ProcessMesh.vote_axes)")
    return mesh


def axis_size(axes, name: str) -> int:
    return _mesh(axes).axis_size(name)


def axis_index(axes, name: str) -> int:
    return _mesh(axes).axis_index(name)


def num_voters(axes) -> int:
    """Voters over the vote axes (1 for none)."""
    n = 1
    for a in axes:
        n *= axis_size(axes, a)
    return n


def replica_index(axes) -> int:
    """This rank's linear index over `axes`, outermost first (the
    reference's ``byzantine.replica_index``)."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(axes, a) + axis_index(axes, a)
    return idx


def psum(x: torch.Tensor, axes, names: Optional[Sequence[str]] = None
         ) -> torch.Tensor:
    """The sum of `x` over the axes `names` (default every axis of `axes`),
    in x's dtype (int16 summed as int32 and narrowed)."""
    mesh = _mesh(axes)
    ranks, group = mesh.group_of(tuple(axes) if names is None else names)
    if group is None:
        return x.clone()

    def fn(src, dst):
        dst.copy_(src)
        dist.all_reduce(dst, group=group)
    return mesh._run(x, fn, x.numel(), group).view(x.shape)


def all_gather(x: torch.Tensor, axes, name: str, tiled: bool = False,
               dim: int = -1) -> torch.Tensor:
    """`x` of every rank along axis `name`, in axis order: stacked on a new
    leading dim, or (``tiled``) concatenated along `dim` (default the
    last)."""
    mesh = _mesh(axes)
    ranks, group = mesh.group_of((name,))
    k = len(ranks)
    if group is None:
        out = x.clone().unsqueeze(0)
    else:
        def fn(src, dst):
            dist.all_gather_into_tensor(dst, src, group=group)
        out = mesh._run(x, fn, k * x.numel(), group).view(
            (k,) + tuple(x.shape))
    if not tiled:
        return out
    dim = dim % x.dim()
    shape = x.shape[:dim] + (k * x.shape[dim],) + x.shape[dim + 1:]
    # rank i's block lands at [i * size, (i + 1) * size) along `dim`
    return out.movedim(0, dim).reshape(shape)


def psum_scatter(x: torch.Tensor, axes, name: str,
                 dim: Optional[int] = None) -> torch.Tensor:
    """Shard i of the sum of `x` over axis `name` on the rank at index i
    (tiled: x's length must split evenly): of a 1-D `x`, or, given `dim`,
    the i-th of equal blocks along that dim (x's shape with that dim cut
    by the axis size)."""
    mesh = _mesh(axes)
    ranks, group = mesh.group_of((name,))
    k = len(ranks)
    if dim is not None:
        dim = dim % x.dim()
        if x.shape[dim] % k:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split over {k} ranks")
        front = x.movedim(dim, 0)
        out = psum_scatter(front.reshape(-1), axes, name)
        return out.view((x.shape[dim] // k,) + front.shape[1:]).movedim(
            0, dim)
    if x.dim() != 1 or x.numel() % k:
        raise ValueError(f"psum_scatter takes a 1-D tensor whose length "
                         f"splits over {k} ranks, got {tuple(x.shape)}")
    if group is None:
        return x.clone()

    def fn(src, dst):
        dist.reduce_scatter_tensor(dst, src, group=group)
    return mesh._run(x, fn, x.numel() // k, group)


def gather_voters(x: torch.Tensor, axes) -> torch.Tensor:
    """(M, *x.shape): every voter's `x` in replica order (pod-major), by
    one all-gather over the whole mesh."""
    mesh = _mesh(axes)
    ranks, group = mesh.group_of(tuple(axes))
    if group is None:
        return x.clone().unsqueeze(0)

    def fn(src, dst):
        dist.all_gather_into_tensor(dst, src, group=group)
    return mesh._run(x, fn, len(ranks) * x.numel(), group).view(
        (len(ranks),) + tuple(x.shape))


def broadcast(x: torch.Tensor, axes, src_index: int = 0) -> torch.Tensor:
    """Voter `src_index`'s `x` on every rank of the mesh."""
    mesh = _mesh(axes)
    ranks, group = mesh.group_of(tuple(axes))
    if group is None:
        return x.clone()

    def fn(src, dst):
        dst.copy_(src)
        dist.broadcast(dst, src=ranks[src_index], group=group)
    return mesh._run(x, fn, x.numel(), group).view(x.shape)


# ---------------------------------------------------------------------------
# the model group's collectives (tensor parallelism)
# ---------------------------------------------------------------------------


def _tp_group(mesh: ProcessMesh, names: Sequence[str]):
    ranks, group = mesh.group_of(names)
    return len(ranks), group


def _stats_of(mesh: ProcessMesh, names: Sequence[str]) -> WireStats:
    """The statistics a line's collective adds to: the model axis' when
    it spans the model axis, else the vote axes'."""
    return mesh.model_stats if "model" in names else mesh.stats


def model_gather(x: torch.Tensor, mesh: ProcessMesh, dim: int = -1,
                 names: Sequence[str] = ("model",)) -> torch.Tensor:
    """Every rank's `x` along the model axis (or the line of `names`),
    concatenated along `dim` in model-index order (data-major over
    several axes)."""
    k, group = _tp_group(mesh, names)
    if group is None:
        return x.clone()

    def fn(src, dst):
        dist.all_gather_into_tensor(dst, src, group=group)
    parts = mesh._run(x.contiguous(), fn, k * x.numel(), group,
                      _stats_of(mesh, names)).view((k,) + tuple(x.shape))
    dim = dim % x.dim()
    shape = x.shape[:dim] + (k * x.shape[dim],) + x.shape[dim + 1:]
    return parts.movedim(0, dim).reshape(shape)


def _ordered_parts(x: torch.Tensor, mesh: ProcessMesh,
                   names: Sequence[str]) -> Optional[torch.Tensor]:
    """(k, *x.shape) float32: every rank's `x` in line order (None for a
    line of one rank)."""
    k, group = _tp_group(mesh, names)
    if group is None:
        return None
    x32 = x.to(torch.float32).contiguous()

    def fn(src, dst):
        dist.all_gather_into_tensor(dst, src, group=group)
    return mesh._run(x32, fn, k * x.numel(), group,
                     _stats_of(mesh, names)).view((k,) + tuple(x.shape))


#: float32 bytes from which a sum over more than two ranks takes the
#: all-to-all (see the module doc)
A2A_MIN_BYTES = 1 << 20


def _blocked(n: int, k: int) -> bool:
    """Whether a float sum of n elements over k ranks goes by blocks."""
    return k > 2 and 4 * n >= A2A_MIN_BYTES


def model_sum_bytes(n: int, k: int) -> int:
    """The bytes one rank hands the collectives in :func:`model_sum` of n
    floats over k ranks (float32 on the wire): n, or by blocks the n padded
    to k equal blocks and then one block."""
    if k == 1:
        return 0
    if not _blocked(n, k):
        return 4 * n
    block = -(-n // k)
    return 4 * (k * block + block)


def _blocks_in_order(x32: torch.Tensor, mesh: ProcessMesh, names,
                     k: int, group) -> torch.Tensor:
    """Of flat float32 `x32` (n) over the line's k ranks: this rank's
    block i of the n padded to k blocks, summed over every rank's block i
    in line order (one all-to-all)."""
    block = -(-x32.numel() // k)
    flat = x32.new_zeros(k * block)
    flat[:x32.numel()] = x32

    def fn(src, dst):
        dist.all_to_all_single(dst, src, group=group)
    got = mesh._run(flat, fn, k * block, group, _stats_of(mesh, names))
    return _sum_rows(got.view(k, block))


def _sum_rows(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0].clone()
    for i in range(1, parts.shape[0]):
        out.add_(parts[i])
    return out


def model_sum(x: torch.Tensor, mesh: ProcessMesh,
              names: Sequence[str] = ("model",)) -> torch.Tensor:
    """The sum of `x` over the model axis (or the line of `names`) on
    every rank: an integer tensor by an all-reduce; a float one as the
    float32 sum of the ranks' parts in model-index order, rounded once to
    x's dtype (see the module doc)."""
    if not x.is_floating_point():
        k, group = _tp_group(mesh, names)
        if group is None:
            return x.clone()
        wide = x.to(torch.int64) if x.dtype != torch.int64 else x

        def fn(src, dst):
            dst.copy_(src)
            dist.all_reduce(dst, group=group)
        return mesh._run(wide, fn, x.numel(), group,
                         _stats_of(mesh, names)).view(x.shape).to(x.dtype)
    k, group = _tp_group(mesh, names)
    if group is None:
        return x.clone()
    if _blocked(x.numel(), k):
        mine = _blocks_in_order(x.to(torch.float32).reshape(-1), mesh, names,
                                k, group)

        def fn(src, dst):
            dist.all_gather_into_tensor(dst, src, group=group)
        every = mesh._run(mine, fn, k * mine.numel(), group,
                          _stats_of(mesh, names))
        return every[:x.numel()].view(x.shape).to(x.dtype)
    return _sum_rows(_ordered_parts(x, mesh, names)).to(x.dtype)


def model_max(x: torch.Tensor, mesh: ProcessMesh,
              names: Sequence[str] = ("model",)) -> torch.Tensor:
    """The elementwise maximum of `x` over the model axis (or the line of
    `names`), exact in any order."""
    k, group = _tp_group(mesh, names)
    if group is None:
        return x.clone()

    def fn(src, dst):
        dst.copy_(src)
        dist.all_reduce(dst, op=dist.ReduceOp.MAX, group=group)
    return mesh._run(x.contiguous(), fn, x.numel(), group,
                     _stats_of(mesh, names)).view(x.shape)


def model_sum_scatter(x: torch.Tensor, mesh: ProcessMesh, dim: int = -1,
                      names: Sequence[str] = ("model",)) -> torch.Tensor:
    """Block i (of equal blocks along `dim`) of the sum of `x` over the
    model axis, on the rank at model index i: the float32 sum of the
    ranks' blocks in model-index order, rounded once to x's dtype, as
    :func:`model_sum` sums it (the blocks moved to their ranks by one
    all-to-all; over two ranks, or under ``A2A_MIN_BYTES``, the whole
    tensors gathered)."""
    k, group = _tp_group(mesh, names)
    dim = dim % x.dim()
    if x.shape[dim] % k:
        raise ValueError(f"model_sum_scatter: dim {dim} of "
                         f"{tuple(x.shape)} does not split over {k} ranks")
    if group is None:
        return x.clone()
    idx = line_index(mesh, names)
    size = x.shape[dim] // k
    if _blocked(x.numel(), k):
        front = x.to(torch.float32).movedim(dim, 0)
        mine = _blocks_in_order(front.reshape(-1), mesh, names, k, group)
        shape = (size,) + tuple(front.shape[1:])
        return mine.view(shape).movedim(0, dim).to(x.dtype)
    parts = _ordered_parts(x, mesh, names)
    block = parts.narrow(dim + 1, idx * size, size)
    return _sum_rows(block).to(x.dtype)


def line_index(mesh: ProcessMesh, names: Sequence[str]) -> int:
    """This rank's index along the line of `names` (data-major over
    ("data", "model"))."""
    idx = 0
    for a in MESH_AXES:
        if a in names:
            idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    return idx


def first_ranks(m: int) -> ProcessMesh:
    """The data-only mesh of world ranks ``0 .. m-1`` (a drill of m voters
    in a larger world); build it on every rank of the world."""
    return ProcessMesh((m,), ("data",))


__all__ = ["MESH_AXES", "ProcessMesh", "VOTE_AXES", "VoteAxes", "WireStats",
           "all_gather", "axis_index", "axis_size", "broadcast",
           "first_ranks", "gather_voters", "line_index", "model_gather",
           "model_max", "model_sum", "model_sum_bytes", "model_sum_scatter",
           "num_voters",
           "psum", "psum_scatter", "replica_index"]
