"""Collective statistics of a step (``repro.launch.hlo_stats``).

The reference reads its collectives out of compiled HLO text and
multiplies each by the trip counts of the while loops around it. Eager
PyTorch has no HLO: every collective of the port goes through one place,
``distributed.mesh.ProcessMesh._run``, and under :func:`record_collectives`
that place records a :class:`CollectiveOp` for each call the step makes. A
collective inside a loop is recorded at every iteration, so no trip count
is needed (``trip_mult`` stays 1).

    with record_collectives(pod_stride=256) as ops:
        step(...)
    summarize(ops)   # n_collectives, transit_bytes_ici / _dci, by_op/*

Transit factors (bytes through each rank's links, ring algorithms; `size`
is the result's bytes, `m` the group's size), as the reference's:

  all-reduce      2 * size * (m-1)/m
  all-gather      size * (m-1)/m
  reduce-scatter  size * (m-1)        (input = m * output)
  all-to-all      size * (m-1)/m
  collective-permute (and broadcast)  size

A group crosses pods when its members' ranks fall in more than one block
of `pod_stride` ranks (the reference's rule on an HLO replica group).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class CollectiveOp:
    op: str
    bytes_result: int
    group_size: int
    crosses_pod: bool
    transit_bytes: float
    trip_mult: int = 1


def group_info(members: Sequence[int], pod_stride: int) -> Tuple[int, bool]:
    """(size, crosses_pod) of the group of world ranks `members` (the
    reference's ``_group_info`` on an explicit replica group)."""
    crosses = (pod_stride > 0
               and len({r // pod_stride for r in members}) > 1)
    return max(len(members), 1), crosses


def _transit(op: str, size: int, m: int) -> float:
    if m <= 1:
        return 0.0
    if op.startswith("all-reduce"):
        return 2.0 * size * (m - 1) / m
    if op.startswith("all-gather"):
        return size * (m - 1) / m
    if op == "reduce-scatter":
        return float(size) * (m - 1)
    if op == "all-to-all":
        return size * (m - 1) / m
    return float(size)  # collective-permute, broadcast


class Recorder:
    """The collectives recorded under :func:`record_collectives`."""

    def __init__(self, pod_stride: int):
        self.pod_stride = pod_stride
        self.ops: List[CollectiveOp] = []

    def add(self, op: str, members: Sequence[int], bytes_result: int
            ) -> CollectiveOp:
        size, crosses = group_info(members, self.pod_stride)
        rec = CollectiveOp(op=op, bytes_result=int(bytes_result),
                           group_size=size, crosses_pod=crosses,
                           transit_bytes=_transit(op, bytes_result, size))
        self.ops.append(rec)
        return rec


_ACTIVE: List[Recorder] = []


def active() -> Optional[Recorder]:
    """The innermost recorder, or None outside :func:`record_collectives`."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def record_collectives(pod_stride: int = 0) -> Iterator[List[CollectiveOp]]:
    """Record every collective issued inside, without running it (see
    ``ProcessMesh._run``); yields the list the ops are appended to."""
    rec = Recorder(pod_stride)
    _ACTIVE.append(rec)
    try:
        yield rec.ops
    finally:
        _ACTIVE.remove(rec)


def summarize(ops: List[CollectiveOp]) -> Dict[str, float]:
    summary: Dict[str, float] = {
        "n_collectives": len(ops),
        "transit_bytes_ici": 0.0,
        "transit_bytes_dci": 0.0,
    }
    by_op: Dict[str, float] = {}
    for o in ops:
        key = "transit_bytes_dci" if o.crosses_pod else "transit_bytes_ici"
        summary[key] += o.transit_bytes
        by_op[o.op] = by_op.get(o.op, 0.0) + o.transit_bytes
    for k, v in sorted(by_op.items()):
        summary[f"by_op/{k}"] = v
    return summary


__all__ = ["CollectiveOp", "Recorder", "active", "group_info",
           "record_collectives", "summarize"]
