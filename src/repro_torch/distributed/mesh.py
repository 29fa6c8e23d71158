"""The vote mesh over ``torch.distributed`` process groups: the port's
counterpart of what the reference takes from ``jax.sharding.Mesh`` and
``repro.compat`` (``axis_size`` / ``axis_index`` / ``all_gather`` /
``psum`` / ``psum_scatter`` inside a manual ``shard_map`` region).

    dist.init_process_group("gloo", init_method=..., rank=r, world_size=4)
    mesh = ProcessMesh((2, 2), ("pod", "data"))        # every rank calls it
    axes = mesh.vote_axes                               # ("pod", "data")
    counts = psum(signs.to(torch.int8), axes)

A :class:`ProcessMesh` lays the vote axes ``"pod"`` and ``"data"`` over
ranks of an initialised world, row-major: the rank at coordinates
``(p, d)`` is ``ranks[p * data + d]``. Each rank runs one voter; its
replica index over ``(pod, data)`` is ``p * data + d``, as
``byzantine.replica_index`` counts it in the reference. There is no model
axis (tensor parallelism is ROADMAP.md Queue 1 item 14): an axis named
``"model"`` must have size 1.

The process groups of each axis (one per row or column of the mesh) and of
the whole mesh are created when the mesh is built, by every rank of the
world in the same order (``torch.distributed.new_group`` is collective),
and cached by their rank set, so building the same mesh again, or a mesh
of the first M ranks for a smaller drill, creates nothing new. A rank
outside the mesh builds it too and is no member (:attr:`member`). A group
of one rank needs no process group: its collectives are the identity, so
a one-rank mesh works without ``torch.distributed``.

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
one to its count into :attr:`ProcessMesh.stats`, which
:meth:`ProcessMesh.reset_stats` zeroes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the vote axes, outermost first (the reference's ``vote_axes_in`` order)
VOTE_AXES = ("pod", "data")

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
    """The ``(pod, data)`` vote mesh over ranks of the initialised world.

    `shape` and `axis_names` follow ``jax.sharding.Mesh``: e.g. ``(4,),
    ("data",)`` or ``(2, 4), ("pod", "data")``. `ranks` are the world ranks
    laid out row-major (default ``0 .. size-1``). Build it on every rank of
    the world, in the same order as every other mesh."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "differ in length")
        for a, s in zip(names, shape):
            if a == "model" and s != 1:
                raise NotImplementedError(
                    "a 'model' axis of size > 1 (tensor parallelism) is not "
                    "ported yet (ROADMAP.md Queue 1 item 14)")
            if a not in VOTE_AXES + ("model",):
                raise ValueError(f"unknown mesh axis {a!r}; the vote mesh has "
                                 f"{VOTE_AXES}")
            if s < 1:
                raise ValueError(f"axis {a!r} has size {s}")
        sizes = dict(zip(names, shape))
        self.axis_names = tuple(a for a in VOTE_AXES if a in sizes)
        self.pod = sizes.get("pod", 1)
        self.data = sizes.get("data", 1)
        self.size = self.pod * self.data
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks = (tuple(range(self.size)) if ranks is None
                      else tuple(int(r) for r in ranks))
        if len(self.ranks) != self.size:
            raise ValueError(f"a {self.pod} x {self.data} mesh needs "
                             f"{self.size} ranks, got {len(self.ranks)}")
        if max(self.ranks) >= world:
            raise ValueError(f"the mesh needs ranks {self.ranks}; the world "
                             f"has {world} (initialise torch.distributed "
                             "with enough ranks)")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.member = self.rank in self.ranks
        pos = self.ranks.index(self.rank) if self.member else 0
        self.coords = {"pod": pos // self.data, "data": pos % self.data}
        self.stats = WireStats()
        # every group of the mesh, in one order on every rank
        self._groups = {}
        for p in range(self.pod):
            row = self.ranks[p * self.data:(p + 1) * self.data]
            self._groups[("data", p)] = (row, _group(row))
        for d in range(self.data):
            col = self.ranks[d::self.data]
            self._groups[("pod", d)] = (col, _group(col))
        self._groups["all"] = (self.ranks, _group(self.ranks))

    def __repr__(self):
        return (f"ProcessMesh(pod={self.pod}, data={self.data}, "
                f"ranks={self.ranks}, rank={self.rank})")

    @property
    def vote_axes(self) -> "VoteAxes":
        """The mesh's vote axes, bound to it."""
        return VoteAxes(self.axis_names, self)

    def axis_size(self, name: str) -> int:
        return {"pod": self.pod, "data": self.data}[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def replica_index(self) -> int:
        """This rank's voter index, pod-major (``p * data + d``)."""
        return self.coords["pod"] * self.data + self.coords["data"]

    def reset_stats(self) -> WireStats:
        """Zero the wire statistics; returns the ones before."""
        old, self.stats = self.stats, WireStats()
        return old

    # ---- groups ---------------------------------------------------------

    def group_of(self, names: Sequence[str]):
        """(ranks, process group) spanning the axes `names` through this
        rank: one axis is this rank's row (data) or column (pod), both
        axes the whole mesh."""
        names = tuple(a for a in VOTE_AXES if a in names)
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        if len(names) == 2 or (names and self.size == self.axis_size(
                names[0])):
            return self._groups["all"]
        if not names:
            return (self.rank,), None
        if names[0] == "data":
            return self._groups[("data", self.coords["pod"])]
        return self._groups[("pod", self.coords["data"])]

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

    def _run(self, x: torch.Tensor, fn, out_numel: int, group
             ) -> torch.Tensor:
        """Run the collective `fn(src, dst)` of process group `group` on
        `x`, widening int16 to int32; returns a new flat tensor of
        `out_numel` elements on x's device, in x's dtype."""
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
        self.stats.bytes += src.numel() * src.element_size()
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
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


def first_ranks(m: int) -> ProcessMesh:
    """The data-only mesh of world ranks ``0 .. m-1`` (a drill of m voters
    in a larger world); build it on every rank of the world."""
    return ProcessMesh((m,), ("data",))


__all__ = ["ProcessMesh", "VOTE_AXES", "VoteAxes", "WireStats", "all_gather",
           "axis_index", "axis_size", "broadcast", "first_ranks",
           "gather_voters", "num_voters", "psum", "psum_scatter",
           "replica_index"]
