"""The streamed population engine (``repro.core.population``; DESIGN.md §12).

``VirtualBackend`` executes a ``"streamed"`` :class:`~repro_torch.core.
vote_api.VoteRequest` here: the voters of a
:class:`~repro_torch.core.vote_api.PopulationStream` are materialised a
chunk of rows at a time (chunk -> effective signs -> partial tally ->
accumulate), so a vote over 10^4–10^5 voters holds O(chunk_size x n) rows
instead of O(M x n).

Every wire here reduces the voter dim with exact integer arithmetic, so no
chunking can change a bit of the result:

* the count wires (``psum_int8``, and ``ternary2bit`` on either strategy)
  decide ``sign(sum_m s_m)``;
* the gathered 1-bit wire counts, per coordinate, the voters whose bit is
  set (a sign >= 0; the dense tally's per-bit count) and applies the
  majority threshold ``2 * count >= M`` once, M being the round's voters;
* dataset-weighted votes sum integer weight times integer sign;
* ``weighted_vote``'s reliability weights are multiples of 1/256 by
  definition (``codecs.weighted``), so its weighted sum is integer
  arithmetic at scale 256; a second pass over the stream counts each
  voter's mismatches against the final vote, and the EMA then touches
  only the sampled ids.

Tensors stay on the engine's device and accumulate in int64 there; a
chunk's column sums never widen the ``(k, n)`` int8 signs to int64 (64 rows
at a time are summed in int8, weighted rows a block at a time in int32, as
the reference sums a chunk). A chunk's signs
come from ``vote_api.effective_stacked_signs`` keyed by the chunk's
*logical* ids, so on a card the ``adversary`` kernel draws each row under
its id's key; the 1-bit wire's pack / unpack round trip is the
``bitpack`` / ``bitunpack`` kernels.

Where the reference narrows its int64 accumulator to int32 (JAX with
64-bit mode off: ``jnp.asarray`` of the numpy tally), the port does too,
with the same two's-complement wrap, before taking the vote's sign; the
int32 headroom check of each chunk (:func:`_validate`, with
:data:`W256_CAP`) is the reference's. ``margin`` is the reference's numpy
``mean(|tally|) / weight``: the int64 sum of ``|tally|`` is exact, so the
float64 division gives the same bits.

``hierarchical`` is refused: its reduce-scatter pads the coordinates to
``32 * M`` words, an O(M) layout this engine exists to avoid.

Chunk accounting goes to ``obs.COUNTERS``: cumulative ``population.chunks``
/ ``population.passes`` / ``population.votes``, the high-water
``population.peak_rows`` and the last run's ``population.last.*``. The
reference's deprecated ``LAST_STATS`` view is not ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ByzantineConfig, VoteStrategy
from repro_torch.core import sign_compress as sc
from repro_torch.core.codecs import weighted
from repro_torch.kernels import ops
from repro_torch.obs.recorder import COUNTERS

#: default voter-chunk size (rows materialised at once)
DEFAULT_CHUNK = 2048

#: largest |reliability weight| * 256 the weighted_vote codec can emit
W256_CAP = int(round(math.log((1.0 - weighted.P_MIN) / weighted.P_MIN)
                     * 256.0))

#: the registry namespace of the engine's counters
STATS_PREFIX = "population."

_STAT_KEYS = ("n_voters", "peak_rows", "n_chunks", "n_passes")

_CODECS = ("sign1bit", "ef_sign", "ternary2bit", "weighted_vote")

#: rows whose int8 column sum cannot overflow (|partial| <= 64)
_I8_ROWS = 64
#: elements of a row block's widened temporary (the weighted sum, the
#: mismatch count)
_BLOCK_ELEMS = 1 << 26


def _publish_stats(stats: Dict[str, int]) -> None:
    for k in _STAT_KEYS:
        COUNTERS.set(STATS_PREFIX + "last." + k, stats[k])
    COUNTERS.inc(STATS_PREFIX + "chunks", stats["n_chunks"])
    COUNTERS.inc(STATS_PREFIX + "passes", stats["n_passes"])
    COUNTERS.inc(STATS_PREFIX + "votes")
    COUNTERS.record_max(STATS_PREFIX + "peak_rows", stats["peak_rows"])


# ---------------------------------------------------------------------------
# per-chunk stages
# ---------------------------------------------------------------------------


def _colsum(x: torch.Tensor) -> torch.Tensor:
    """(k, n) int8 of values in {-1, 0, 1} -> (n,) int64 column sums,
    summing 64 rows at a time in int8."""
    k, n = x.shape
    acc = torch.zeros(n, dtype=torch.int64, device=x.device)
    full = k - k % _I8_ROWS
    if full:
        acc += x[:full].reshape(full // _I8_ROWS, _I8_ROWS, n).sum(
            dim=1, dtype=torch.int8).sum(dim=0)
    if k > full:
        acc += x[full:].sum(dim=0, dtype=torch.int8)
    return acc


def _weighted_colsum_(acc: torch.Tensor, x: torch.Tensor,
                      w: np.ndarray) -> None:
    """acc += sum_r w[r] * x[r]: each block of rows summed in int32 (exact:
    :func:`_validate` bounds a whole chunk's weighted sum below 2^31),
    then added to the int64 `acc`."""
    k, n = x.shape
    w_dev = torch.from_numpy(np.ascontiguousarray(w, dtype=np.int32)).to(
        x.device)
    step = max(1, _BLOCK_ELEMS // max(n, 1))
    for lo in range(0, k, step):
        acc += torch.mul(x[lo:lo + step], w_dev[lo:lo + step, None]).sum(
            dim=0, dtype=torch.int32)


def _wire_signs_1bit(eff: torch.Tensor) -> torch.Tensor:
    """What the 1-bit wire delivers for a chunk: the ``bitpack`` /
    ``bitunpack`` round trip, abstentions binarised to +1, padding lanes
    cropped."""
    return weighted.stacked_signs(ops.bitpack(eff), eff.shape[1])


def _chunk_mismatch(eff: torch.Tensor, vote: torch.Tensor) -> torch.Tensor:
    """(k,) int64: each voter's wire signs that differ from the vote (the
    weighted_vote codec's flip-rate observation)."""
    s_wire = _wire_signs_1bit(eff)
    k, n = s_wire.shape
    step = max(1, _BLOCK_ELEMS // max(n, 1))
    return torch.cat([(s_wire[lo:lo + step] != vote[None]).sum(dim=1)
                      for lo in range(0, k, step)])


def _sign32(acc: torch.Tensor) -> torch.Tensor:
    """``sign`` of the tally narrowed to int32 (wrapping as JAX does)."""
    return torch.sign(acc.to(torch.int32)).to(torch.int8)


def _nonneg_vote32(acc: torch.Tensor) -> torch.Tensor:
    """``acc >= 0 -> +1 else -1`` of the tally narrowed to int32."""
    return torch.where(acc.to(torch.int32) >= 0, 1, -1).to(torch.int8)


def _mean_abs(acc: torch.Tensor) -> float:
    """numpy's ``mean(|acc|)`` of an int64 tally: its exact sum over n."""
    return float(acc.abs().sum().item()) / acc.numel()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _validate(stream, strategy: VoteStrategy, codec: str,
              chunk_size: int, server_state) -> None:
    if strategy == VoteStrategy.HIERARCHICAL:
        raise ValueError(
            "hierarchical's reduce-scatter wire pads to PACK*M words — "
            "O(M) layout the streamed engine exists to avoid; use "
            "psum_int8 or allgather_1bit")
    if strategy not in (VoteStrategy.PSUM_INT8,
                        VoteStrategy.ALLGATHER_1BIT):
        raise ValueError(f"streamed engine cannot realise {strategy!r}")
    if codec not in _CODECS:
        raise ValueError(f"streamed engine cannot realise codec "
                         f"{codec!r}; have {_CODECS}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    max_w = (int(np.max(np.asarray(stream.weights)))
             if stream.weights is not None else 1)
    # int32 partial-tally headroom (the reference's per-chunk int32 sum):
    # |per-chunk sum| <= chunk * max per-term magnitude
    max_mag = max_w * (W256_CAP if codec == "weighted_vote" else 1)
    if chunk_size * max_mag >= 2 ** 31:
        raise ValueError(
            f"chunk_size={chunk_size} x max per-voter weight magnitude "
            f"{max_mag} overflows the int32 partial tally; reduce "
            "chunk_size or the dataset weights")
    if codec == "weighted_vote":
        if not server_state or "flip_ema" not in server_state:
            raise ValueError(
                "codec 'weighted_vote' needs server_state['flip_ema'] "
                "over the LOGICAL population (init_server_state(pop))")
        pop = int(server_state["flip_ema"].shape[0])
        ids = stream.row_ids()
        if ids.size and int(ids[-1]) >= pop:
            raise ValueError(
                f"stream ids reach logical voter {int(ids[-1])} but "
                f"server_state['flip_ema'] covers only {pop} clients; "
                "refit it to the population size "
                "(checkpoint.refit_tree_leading_axis)")


def _chunks(stream, chunk_size: int):
    ids_all = stream.row_ids()
    for lo in range(0, stream.n_voters, chunk_size):
        yield lo, ids_all[lo:lo + chunk_size]


def _rows(a, k: int, n: int, what: str, dtype: Optional[torch.dtype],
          device: torch.device) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.array(a))).to(device)
    if t.dtype == torch.float64:
        # what the reference's arrays hold with JAX's 64-bit mode off
        t = t.to(torch.float32)
    if dtype is not None:
        t = t.to(dtype)
    if tuple(t.shape) != (k, n):
        raise ValueError(f"stream.{what} returned shape {tuple(t.shape)} "
                         f"for a {k}-id chunk, want ({k}, {n})")
    return t


def _chunk_signs(stream, ids_np: np.ndarray, step, n_stale: int,
                 byz: Optional[ByzantineConfig], salt: int, obs=None,
                 device: DeviceLike = None) -> torch.Tensor:
    """Materialise ONE chunk's effective wire signs ((k, n) int8 on
    `device`): ``values`` (and ``prev``) called with the chunk's logical
    ids as a (k,) int32 CPU tensor."""
    from repro_torch.core import vote_api as va
    dev = resolve_device(device)
    k, n = len(ids_np), stream.n_coords
    ids = torch.from_numpy(np.ascontiguousarray(ids_np, dtype=np.int32))
    vals = _rows(stream.values(ids), k, n, "values", None, dev)
    prev = None
    if n_stale and stream.prev is not None:
        prev = _rows(stream.prev(ids), k, n, "prev", torch.int8, dev)
    return va.effective_stacked_signs(vals, prev, n_stale, byz, step, salt,
                                      ids=ids_np, obs=obs)


def streamed_vote(stream, *, strategy: VoteStrategy, codec: str,
                  n_stale: int = 0,
                  byz: Optional[ByzantineConfig] = None,
                  step=None, salt: int = 0,
                  server_state: Optional[Dict[str, Any]] = None,
                  chunk_size: int = DEFAULT_CHUNK,
                  attack_obs: Optional[Dict[str, Any]] = None,
                  device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any], float,
                             torch.Tensor]:
    """One majority vote over a ``PopulationStream`` in voter-chunks, on
    `device` (``"cuda"`` unless told otherwise).

    Returns ``(votes, new_server_state, margin, counts)``: votes (n,) int8,
    bit-equal to the dense stacked path on the same request; margin the
    mean |tally| over the total vote weight; counts the per-coordinate
    signed tally ((n,) int64, at the wire's own weight scale: the attack
    engine's ``margin`` channel). ``attack_obs`` goes whole to every chunk,
    so chunking cannot change an adaptive adversary."""
    _validate(stream, strategy, codec, chunk_size, server_state)
    dev = resolve_device(device)
    state = dict(server_state) if server_state else {}
    m, n = stream.n_voters, stream.n_coords
    weights = (None if stream.weights is None
               else np.asarray(stream.weights, dtype=np.int64))
    stats = {"n_voters": m, "peak_rows": 0, "n_chunks": 0, "n_passes": 1}

    def eff_of(ids_np):
        stats["peak_rows"] = max(stats["peak_rows"], len(ids_np))
        stats["n_chunks"] += 1
        return _chunk_signs(stream, ids_np, step, n_stale, byz, salt,
                            obs=attack_obs, device=dev)

    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    if codec == "weighted_vote":
        votes, state, margin = _weighted_codec_vote(
            stream, weights, state, chunk_size, eff_of, stats, acc)
        counts = acc
    elif weights is not None:
        votes, margin = _data_weighted_vote(
            stream, strategy, codec, weights, chunk_size, eff_of, acc)
        counts = acc
    elif strategy == VoteStrategy.PSUM_INT8 or codec == "ternary2bit":
        # the count wires: psum sums ternary counts; the 2-bit ternary
        # wire carries the same counts through a gather
        for _, ids_np in _chunks(stream, chunk_size):
            acc += _colsum(eff_of(ids_np))
        votes = _sign32(acc)
        margin = _mean_abs(acc) / m
        counts = acc
    else:
        # the gathered 1-bit wire: count the set bits (signs >= 0) per
        # coordinate, then apply the dense tally's threshold once
        for _, ids_np in _chunks(stream, chunk_size):
            acc += _colsum(sc.nonneg(eff_of(ids_np)).view(torch.int8))
        votes = torch.where(2 * acc.to(torch.int32) >= m, 1, -1).to(
            torch.int8)
        # +1-count c -> signed count 2c - M
        counts = 2 * acc - m
        margin = _mean_abs(counts) / m
    _publish_stats(stats)
    return votes, state, margin, counts


def _data_weighted_vote(stream, strategy, codec, weights, chunk_size,
                        eff_of, acc):
    """Dataset-weighted plain codecs: each voter casts weight-many
    identical votes on its wire."""
    gathered_binary = (strategy == VoteStrategy.ALLGATHER_1BIT
                       and codec != "ternary2bit")
    for lo, ids_np in _chunks(stream, chunk_size):
        eff = eff_of(ids_np)
        s = _wire_signs_1bit(eff) if gathered_binary else eff
        _weighted_colsum_(acc, s, weights[lo:lo + len(ids_np)])
        del eff, s     # before the next chunk's rows are made
    votes = _nonneg_vote32(acc) if gathered_binary else _sign32(acc)
    return votes, _mean_abs(acc) / float(np.sum(weights))


def _weighted_codec_vote(stream, weights, state, chunk_size, eff_of,
                         stats, acc):
    """The weighted_vote codec over a streamed population, in two passes:
    (1) the reliability-weighted (times dataset-weighted) sum at the
    codec's 1/256 integer scale; (2) each voter's mismatches against the
    final vote, then the EMA of the sampled ids only."""
    m, n = stream.n_voters, stream.n_coords
    dev = acc.device
    ema = torch.as_tensor(state["flip_ema"], dtype=torch.float32,
                          device=dev)
    # the codec's weights are multiples of 1/256 by definition, so w * 256
    # is an exact integer; one host copy serves every chunk
    w256 = torch.round(weighted.reliability_weights(ema) * 256.0).to(
        torch.int64).cpu().numpy()
    wtot = 0
    for lo, ids_np in _chunks(stream, chunk_size):
        w = w256[ids_np]
        if weights is not None:
            w = w * weights[lo:lo + len(ids_np)]
        _weighted_colsum_(acc, _wire_signs_1bit(eff_of(ids_np)), w)
        wtot += int(np.sum(np.abs(w)))
    vote = _nonneg_vote32(acc)

    # pass 2: the flip-rate observation needs the final vote, so the
    # stream is walked again (its chunks regenerate deterministically)
    stats["n_passes"] += 1
    mis = torch.cat([_chunk_mismatch(eff_of(ids_np), vote)
                     for _, ids_np in _chunks(stream, chunk_size)])
    idx = torch.from_numpy(stream.row_ids().astype(np.int64)).to(dev)
    f = sc.flush_subnormals
    # the reference's eager (1 - RHO) * ema + RHO * mis / n, each operation
    # rounded on its own; the divisor is a device tensor, so the card
    # divides too (a CPU-scalar divisor becomes a reciprocal product there)
    observed = f(weighted.RHO * mis.to(torch.float32))
    upd = f(f((1.0 - weighted.RHO) * f(ema[idx]))
            + f(observed / torch.tensor(float(n), device=dev)))
    new_ema = ema.clone()
    new_ema[idx] = upd
    margin = _mean_abs(acc) / max(wtot, 1)
    return vote, {**state, "flip_ema": new_ema}, margin


__all__ = ["DEFAULT_CHUNK", "STATS_PREFIX", "W256_CAP", "streamed_vote"]
