"""Alpha-beta communication time model of an H100 host
(``repro.distributed.comm_model``, its functions and arithmetic; the
constants are the H100's).

Prices the vote's exchange for ``vote_strategy=auto``
(``core.vote_engine.select_strategy``), the VotePlan's priced schedules
(``core.vote_plan``: AUTO per codec group, ``bucket_bytes = -1`` and
``VotePlan.schedule_cost``), the ``pred_s`` of every ``plan.issue`` span and
the Scenario Lab's ``est_exchange_time_s``.

Every message costs ``alpha + bytes / BW`` per hop class: the alpha term
(launch and synchronisation) is paid PER COLLECTIVE, so L leaf-sized
messages cost L alphas where one flat buffer cut into a few buckets pays a
few. :func:`schedule_time` prices a schedule of messages, each with its
own latency term.

The two hop classes of a strategy's ``ring_bytes``:

* ``"ici"`` bytes stay within a node, over NVLink (the mesh's ``data``
  axis): 18 NVLink 4 links a GPU, 50 GB/s each both ways together, so
  25 GB/s each way a link and 450 GB/s each way a GPU (900 GB/s both ways:
  the NVIDIA H100 Tensor Core GPU data sheet, SXM,
  https://www.nvidia.com/en-us/data-center/h100/);
* ``"dci"`` bytes cross nodes (the ``pod`` axis) over the network: one
  400 Gb/s ConnectX-7 port a GPU, 50 GB/s each way (the NVIDIA DGX H100
  data sheet: eight single-port ConnectX-7 adapters for eight GPUs).

``ALPHA_NVLINK`` and ``ALPHA_NET`` have no data-sheet figure. They are this
port's assumption, not a measurement: a few microseconds for the launch and
the synchronisation of a collective within a node, more for one that
crosses the network. One card cannot time a link between cards.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

#: dense bf16 tensor-core peak of one H100 SXM: half the data sheet's
#: 1,979 TFLOP/s, which is quoted with sparsity (H100 data sheet)
PEAK_FLOPS = 989.5e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (H100 data sheet)
HBM_BW = 3.35e12
#: one NVLink 4 link, bytes/s each way: 50 GB/s both ways (H100 data sheet)
NVLINK_BW_PER_LINK = 25e9
#: NVLink 4 links of one H100 SXM (900 GB/s both ways; H100 data sheet)
NVLINK_LINKS = 18
#: one 400 Gb/s ConnectX-7 port a GPU, bytes/s each way (DGX H100 data
#: sheet)
NET_BW = 50e9
#: latency of one collective within a node (s): an assumption of the
#: port, not a data-sheet figure or a measurement
ALPHA_NVLINK = 5e-6
#: latency added by a collective that crosses nodes (s): an assumption of
#: the port, not a data-sheet figure or a measurement
ALPHA_NET = 20e-6
#: fraction of a message's latency terms still exposed under a
#: double-buffered schedule walk (bucket k's exchange issued while bucket
#: k-1 tallies): every message after the first keeps this residue of its
#: latency for the issue gap itself. Bandwidth terms stay serial (the wire
#: is one resource), so overlap removes latency, never bytes.
OVERLAP_ALPHA_RESIDUE = 0.1


@dataclasses.dataclass(frozen=True)
class CommEstimate:
    bytes_ici: float
    bytes_dci: float
    time_s: float


def collective_time(bytes_ici: float, bytes_dci: float = 0.0,
                    n_collectives: int = 1) -> CommEstimate:
    """Per-GPU transit bytes -> seconds (bandwidth and latency terms) for
    ONE message of `n_collectives` chained collectives."""
    t = (bytes_ici / (NVLINK_BW_PER_LINK * NVLINK_LINKS)
         + bytes_dci / NET_BW
         + n_collectives * ALPHA_NVLINK
         + (ALPHA_NET if bytes_dci else 0.0))
    return CommEstimate(bytes_ici, bytes_dci, t)


def schedule_time(messages: Iterable[Tuple[float, float, int]],
                  overlap: bool = False) -> CommEstimate:
    """α–β time of a static schedule of messages, each ``(bytes_ici,
    bytes_dci, n_collectives)`` (one VotePlan bucket each), every message
    paying its own latency term. With ``overlap=True`` the schedule is
    priced as the double-buffered walk (``core.vote_plan.run_schedule``):
    every message after the first keeps only ``OVERLAP_ALPHA_RESIDUE`` of
    its latency terms; the bandwidth terms are untouched."""
    ici = dci = t = 0.0
    first = True
    for b_ici, b_dci, n_coll in messages:
        est = collective_time(b_ici, b_dci, n_collectives=n_coll)
        time_s = est.time_s
        if overlap and not first:
            alpha = (n_coll * ALPHA_NVLINK
                     + (ALPHA_NET if b_dci else 0.0))
            time_s -= (1.0 - OVERLAP_ALPHA_RESIDUE) * alpha
        ici += b_ici
        dci += b_dci
        t += time_s
        first = False
    return CommEstimate(ici, dci, t)


#: runs of identical messages longer than this are added up by numpy
_LOOP_MAX = 4096


def _add_repeated(total: float, x: float, count: int) -> float:
    """`total` + x + x + ... (`count` times), each addition rounded as a
    Python loop rounds it: numpy's ``add.accumulate`` adds one element at a
    time, in order, in float64."""
    if count <= _LOOP_MAX:
        for _ in range(count):
            total += x
        return total
    a = np.full(count + 1, x, dtype=np.float64)
    a[0] = total
    return float(np.add.accumulate(a)[-1])


def repeated_schedule_time(runs: Iterable[Tuple[float, float, int, int]],
                           overlap: bool = False) -> CommEstimate:
    """:func:`schedule_time` of the messages ``(bytes_ici, bytes_dci,
    n_collectives)`` of each run ``(bytes_ici, bytes_dci, n_collectives,
    count)`` repeated `count` times, run after run, float for float, with
    no message materialised: a bucket schedule cut at a small bucket size
    has tens of millions of equal buckets (the AUTO ladder prices one from
    8 bytes up)."""
    ici = dci = t = 0.0
    first = True
    for b_ici, b_dci, n_coll, count in runs:
        if count <= 0:
            continue
        time_s = collective_time(b_ici, b_dci, n_collectives=n_coll).time_s
        later = time_s
        if overlap:
            alpha = (n_coll * ALPHA_NVLINK
                     + (ALPHA_NET if b_dci else 0.0))
            later = time_s - (1.0 - OVERLAP_ALPHA_RESIDUE) * alpha
        if first:
            ici += b_ici
            dci += b_dci
            t += time_s
            count -= 1
            first = False
        ici = _add_repeated(ici, b_ici, count)
        dci = _add_repeated(dci, b_dci, count)
        t = _add_repeated(t, later, count)
    return CommEstimate(ici, dci, t)


def compute_time(flops_per_chip: float, mfu: float = 0.5) -> float:
    return flops_per_chip / (PEAK_FLOPS * mfu)


def memory_time(bytes_per_chip: float) -> float:
    return bytes_per_chip / HBM_BW


def step_time_estimate(flops_per_chip: float, hbm_bytes_per_chip: float,
                       comm: CommEstimate, overlap: float = 0.7) -> float:
    """Step wall-clock with `overlap` of comm hidden under compute."""
    roof = max(compute_time(flops_per_chip, mfu=1.0),
               memory_time(hbm_bytes_per_chip))
    return roof + (1.0 - overlap) * comm.time_s + overlap * max(
        0.0, comm.time_s - roof)

