"""Continuous-batching serve engine (``repro.serve.engine``; DESIGN.md §14).

A fixed pool of decode *slots* under one decode step: finished sequences
retire (EOS / generation budget / cache exhaustion) and queued prompts are
admitted mid-flight, while every tensor of the engine state keeps a shape
keyed only to ``(n_slots, max_len, prompt_pad)``; per-slot scheduling is
carried by *values* (position / length / budget vectors and an active
mask). The reference jits the step once per key and counts its traces
(``serve.decode.compiles``); the port runs eagerly and counts the builds
of its step functions the same way: one per key, shared by every engine of
that key (:func:`_serve_fns`), whatever its scheduler or admission mode.

The reference vmaps a batch-1 ``decode_step`` over the slots; the port
decodes the pool as one batch with one position a row
(``model.decode_step`` with a (B,) `pos`: each row is RoPE'd at, writes
at and reads up to its own position, and in an MoE block is routed as its
own batch), so each lane computes what a batch-1 decode of it would.

Slot recycling is safe without clearing attention caches, because decode
attends under a ``kv_pos <= pos`` mask and writes position ``pos`` before
the mask lets it be read: a recycled slot overwrites each stale KV row
before its new occupant can attend to it. Recurrent leaves (``ssm`` /
``conv``) carry no position mask, so admission zeroes exactly those lanes.

Two admission paths share one sampling rule, so they agree:

* ``inline`` streams the prompt through the decode step one token a tick;
  it serves every family the engine takes (SSM and hybrid state too);
* ``prefill`` runs the prompt through ``model.prefill`` at a padded bucket
  length and writes the produced cache into the slot; right padding is
  harmless, since causal attention never reads past ``plen - 1`` for the
  first token and decode overwrites each padded row before attending to
  it. Decoder-only families only (``model.prefill`` returns unpopulated
  state for the recurrent ones).

Sampling: greedy ``argmax`` (ties to the lowest index) at ``temperature
<= 0``; else ``jax.random.categorical`` under the key ``fold_in(fold_in(
PRNGKey(seed), req), pos)``: the argmax of ``logits / temperature`` plus
Gumbel noise ``-log(-log(u))``, u JAX's uniform of the logits' dtype
(float32: 23 bits of each threefry word; bfloat16: 7 bits of its low byte)
floored at the dtype's smallest normal, drawn through ``core/prng.py``: the
uniforms are JAX's bit for bit, the noise within PyTorch's ``log``.

Hot checkpoint swap: :meth:`ServeEngine.swap` replaces the parameters
between decode ticks. Slot state never references them, so a swap drops
nothing in flight and builds nothing; step records carry the
``param_version`` tag.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchFamily, ModelConfig
from repro_torch.core import prng
from repro_torch.models import model as M
from repro_torch.obs import recorder as obs
from repro_torch.serve.traffic import Request

#: cache leaves holding recurrent state: no position mask protects them,
#: so admission zeroes the slot's lane (attention leaves are protected by
#: the write-before-read ``kv_pos <= pos`` discipline)
_RECURRENT_LEAVES = ("ssm", "conv")

#: families whose ``model.prefill`` returns a populated cache
_PREFILL_FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.VLM)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static engine shape + policy. Every field but ``admit``,
    ``scheduler`` and ``prefill_buckets`` keys the step functions (the
    lru-cached :func:`_serve_fns`), so two engines with equal configs share
    one build."""

    n_slots: int = 4
    max_len: int = 64              # KV/position capacity per slot
    prompt_pad: int = 32           # prompt buffer width (inline path)
    temperature: float = 0.0       # <=0 -> greedy argmax
    seed: int = 0                  # sampling PRNG root (keyed per req/pos)
    eos_id: Optional[int] = None   # None -> retire on budget only
    admit: str = "inline"          # "inline" | "prefill"
    scheduler: str = "continuous"  # "continuous" | "static"
    prefill_buckets: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if not (1 <= self.prompt_pad <= self.max_len):
            raise ValueError(
                f"need 1 <= prompt_pad <= max_len, got prompt_pad="
                f"{self.prompt_pad}, max_len={self.max_len}")
        if self.admit not in ("inline", "prefill"):
            raise ValueError(f"admit must be 'inline' or 'prefill', "
                             f"got {self.admit!r}")
        if self.scheduler not in ("continuous", "static"):
            raise ValueError(f"scheduler must be 'continuous' or "
                             f"'static', got {self.scheduler!r}")
        if self.admit == "prefill":
            b = self.prefill_buckets
            if not b or tuple(sorted(b)) != tuple(b) or b[0] < 1 \
                    or b[-1] > self.max_len:
                raise ValueError(
                    "prefill admission needs ascending prefill_buckets "
                    f"within [1, max_len], got {b}")


@dataclasses.dataclass
class RequestRecord:
    """Host-side lifecycle of one request (ticks are engine-loop
    rounds; ``arrival`` keeps the generator's fractional tick)."""

    req_id: int
    arrival: float
    admit_tick: int = -1
    first_token_tick: int = -1
    finish_tick: int = -1
    slot: int = -1
    param_version_admit: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.finish_tick >= 0

    @property
    def ttft(self) -> float:
        return self.first_token_tick - self.arrival

    @property
    def latency(self) -> float:
        return self.finish_tick - self.arrival


@dataclasses.dataclass
class ServeReport:
    """One run's outcome. Everything except occupancy is derived from
    the deterministic tick schedule, so equal seeds give equal reports."""

    ticks: int
    n_requests: int
    completed: int
    dropped: int
    total_tokens: int
    goodput_tokens_per_tick: float
    ttft_p50: float
    latency_p50: float
    latency_p95: float
    latency_p99: float
    tpot_mean: float
    occupancy_mean: float
    swaps: int
    records: Dict[int, RequestRecord]

    def tokens_by_request(self) -> Dict[int, Tuple[int, ...]]:
        """req_id -> sampled token ids."""
        return {rid: tuple(r.tokens) for rid, r in
                sorted(self.records.items())}


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: an integer index into the sorted sample,
    no interpolation, so the value is exactly reproducible."""
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[i])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_keys(seed: int, req: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``fold_in(fold_in(PRNGKey(seed), req), pos)`` as two
    int64 tensors of 32-bit words."""
    zero = torch.zeros_like(req)
    key = prng.threefry2x32(prng.prng_key(seed), zero, req & prng.MASK32)
    return prng.threefry2x32(key, zero, pos & prng.MASK32)


def uniform(key: Tuple[torch.Tensor, torch.Tensor], n: int,
            dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype, minval=tiny, maxval=1)`` for
    each row's key: (B, n) in `dtype` (float32 or bfloat16), bit for
    bit."""
    idx = torch.arange(n, dtype=torch.int64, device=key[0].device)
    out0, out1 = prng.threefry2x32((key[0][:, None], key[1][:, None]),
                                   idx >> 32, idx & prng.MASK32)
    bits = out0 ^ out1
    if dtype == torch.float32:
        u = prng.bits_to_uniform(bits)
    elif dtype == torch.bfloat16:
        # 8 random bits (the word's low byte), the top 7 under 1.0's
        # exponent: JAX's uniform for a dtype of under 8 mantissa bits
        word = ((bits & 0xFF) >> 1) | 0x3F80
        u = word.to(torch.int16).view(torch.bfloat16) - 1.0
    else:
        raise NotImplementedError(
            f"sampling draws float32 or bfloat16 noise, not {dtype}")
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def gumbel(key: Tuple[torch.Tensor, torch.Tensor], n: int,
           dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), dtype)`` for each row's key:
    ``-log(-log(u))`` of :func:`uniform` (PyTorch's float32 ``log`` may
    differ from XLA's by an ulp)."""
    return -torch.log(-torch.log(uniform(key, n, dtype)))


def sample(logits: torch.Tensor, req: torch.Tensor, pos: torch.Tensor,
           temperature: float, seed: int) -> torch.Tensor:
    """Each row's next token (int64): the argmax of its logits at
    ``temperature <= 0`` (ties to the lowest index), else
    ``jax.random.categorical`` of ``logits / temperature`` under the row's
    (seed, req, pos) key."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    noise = gumbel(sample_keys(seed, req, pos), logits.shape[-1],
                   logits.dtype)
    return torch.argmax(noise + logits / temperature, dim=-1)


# ---------------------------------------------------------------------------
# the step functions (shared across engines via lru_cache)
# ---------------------------------------------------------------------------


class _ServeFns:
    """The step functions of one (cfg, ServeConfig) key: ``step``,
    ``admit`` and per-bucket ``admit_prefill_for(lb)``. Every
    :class:`ServeEngine` with equal keys reuses one instance; the first
    call of each function counts its build (``serve.decode.compiles``,
    ``serve.admit.compiles``, ``serve.prefill.compiles`` per bucket), as
    the reference's trace-time increments count its compiles."""

    def __init__(self, cfg: ModelConfig, sc: ServeConfig):
        self.cfg, self.sc = cfg, sc
        self._prefill: Dict[int, Callable] = {}
        self._built = set()

    def _build(self, name: str, key: Any = None) -> None:
        """Count the first call of function `key` (default: `name`)."""
        key = name if key is None else key
        if key not in self._built:
            self._built.add(key)
            obs.COUNTERS.inc(name)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        """One decode tick of the whole pool. Returns the new state and a
        (3, n_slots) int64 tensor: each slot's sampled token, whether it
        was emitted, whether the slot finished."""
        self._build("serve.decode.compiles")
        sc = self.sc
        pos, active = state["pos"], state["active"]
        logits, cache = M.decode_step(self.cfg, params,
                                      state["tokens"][:, None],
                                      state["cache"], pos)
        nxt = sample(logits, state["req"], pos, sc.temperature, sc.seed)
        in_prompt = (pos + 1) < state["plen"]
        emit = active & ~in_prompt
        gen = state["gen"] + emit.to(torch.int64)
        stop = gen >= state["max_gen"]
        if sc.eos_id is not None:
            stop = stop | (nxt == sc.eos_id)
        done = active & ((emit & stop) | (pos + 1 >= sc.max_len))
        nactive = active & ~done
        idx = torch.clamp(pos + 1, max=sc.prompt_pad - 1)
        prompt_next = torch.gather(state["prompts"], 1, idx[:, None])[:, 0]
        fed = torch.where(in_prompt, prompt_next, nxt)
        new = dict(state, cache=cache, gen=gen, active=nactive,
                   tokens=torch.where(active, fed, state["tokens"]),
                   pos=torch.where(nactive, pos + 1, pos))
        return new, torch.stack([nxt, emit.to(torch.int64),
                                 done.to(torch.int64)])

    @torch.no_grad()
    def admit(self, state: Dict[str, Any], slot: int, prompt: torch.Tensor,
              plen: int, max_gen: int, req: int) -> Dict[str, Any]:
        """Inline admission of a request into `slot`: its prompt, length,
        budget and id; its recurrent lanes zeroed."""
        self._build("serve.admit.compiles")
        for k in _RECURRENT_LEAVES:
            if k in state["cache"]:
                state["cache"][k][:, slot].zero_()
        for k, v in (("tokens", prompt[0]), ("pos", 0), ("plen", plen),
                     ("gen", 0), ("max_gen", max_gen), ("req", req),
                     ("active", True)):
            state[k][slot] = v
        state["prompts"][slot] = prompt
        return state

    def admit_prefill_for(self, lb: int) -> Callable:
        """The prefill admission at bucket length `lb` (one build per
        bucket, kept for the life of this object)."""
        fn = self._prefill.get(lb)
        if fn is not None:
            return fn
        cfg, sc = self.cfg, self.sc

        @torch.no_grad()
        def admitp(params, state, slot, prompt, plen, max_gen, req):
            self._build("serve.prefill.compiles", ("prefill", lb))
            logits, pcache = M.prefill(cfg, params,
                                       {"tokens": prompt[:lb][None]})
            for k, v in state["cache"].items():
                src = pcache[k][:, 0]
                v[:, slot][tuple(slice(0, n) for n in src.shape)] = \
                    src.to(v.dtype)
            dev = logits.device
            first = sample(logits[0, plen - 1][None],
                           torch.tensor([req], device=dev),
                           torch.tensor([plen - 1], device=dev),
                           sc.temperature, sc.seed)[0]
            done0 = (first == sc.eos_id if sc.eos_id is not None else
                     torch.zeros((), dtype=torch.bool, device=dev))
            done0 = done0 | (max_gen <= 1) | (plen >= sc.max_len)
            for k, v in (("tokens", first), ("pos", plen), ("plen", plen),
                         ("gen", 1), ("max_gen", max_gen), ("req", req),
                         ("active", ~done0)):
                state[k][slot] = v
            state["prompts"][slot] = prompt
            return state, torch.stack([first, done0.to(torch.int64)])

        self._prefill[lb] = admitp
        return admitp


@functools.lru_cache(maxsize=None)
def _serve_fns_cached(cfg: ModelConfig, n_slots: int, max_len: int,
                      prompt_pad: int, temperature: float, seed: int,
                      eos_id: Optional[int]) -> _ServeFns:
    return _ServeFns(cfg, ServeConfig(
        n_slots=n_slots, max_len=max_len, prompt_pad=prompt_pad,
        temperature=temperature, seed=seed, eos_id=eos_id))


def _serve_fns(cfg: ModelConfig, sc: ServeConfig) -> _ServeFns:
    """One set of step functions per (model config, engine shape and
    sampling) key. ``admit`` and ``scheduler`` are host-side policy (they
    pick which functions run, never what they compute), so they are not
    part of the key, as in the reference: the static baseline and a
    prefill-admission engine reuse the continuous engine's decode step."""
    return _serve_fns_cached(cfg, sc.n_slots, sc.max_len, sc.prompt_pad,
                             sc.temperature, sc.seed, sc.eos_id)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """The host-side scheduler over the step functions: admits arrived
    requests into free slots, runs one decode tick for the whole pool,
    reads back (token, emit, done), retires finished slots, and swaps
    parameters between ticks. It runs on the device its parameters live
    on."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 serve_cfg: ServeConfig = ServeConfig(), *,
                 param_version: int = 0, watcher: Any = None):
        if cfg.family == ArchFamily.AUDIO:
            raise ValueError(
                "ServeEngine serves token prompts; AUDIO archs need "
                "encoder features per request (use launch/serve.py)")
        if serve_cfg.admit == "prefill" \
                and cfg.family not in _PREFILL_FAMILIES:
            raise ValueError(
                f"prefill admission needs a populated model.prefill "
                f"cache; {cfg.family.name} is recurrent — use "
                f"admit='inline'")
        self.cfg = cfg
        self.sc = serve_cfg
        self.params = params
        self.device = next(iter(params.values())).device
        self.param_version = int(param_version)
        self.watcher = watcher
        self.fns = _serve_fns(cfg, serve_cfg)
        self._state = self._init_state()
        self._slot_req: List[Optional[int]] = [None] * serve_cfg.n_slots

    def _init_state(self) -> Dict[str, Any]:
        sc, dev = self.sc, self.device
        n = sc.n_slots

        def vec(fill, dtype=torch.int64):
            return torch.full((n,), fill, dtype=dtype, device=dev)
        return {
            "cache": M.init_cache(self.cfg, n, sc.max_len, device=dev),
            "tokens": vec(0), "pos": vec(0), "plen": vec(1), "gen": vec(0),
            "max_gen": vec(1), "req": vec(0),
            "active": vec(False, torch.bool),
            "prompts": torch.zeros((n, sc.prompt_pad), dtype=torch.int64,
                                   device=dev),
        }

    # -- parameter swap --

    def swap(self, params: Dict[str, torch.Tensor], version: int) -> None:
        """Install new parameters between ticks. Nothing in slot state
        references the old ones, so in-flight requests simply continue
        under the new ones at their next decode tick."""
        rec = obs.get_recorder()
        with rec.span("serve.swap", version=int(version)):
            self.params = {k: v.to(self.device) for k, v in params.items()}
        self.param_version = int(version)
        obs.COUNTERS.inc("serve.swaps")

    def _poll_watcher(self) -> None:
        upd = self.watcher.poll()
        if upd is not None and upd.version != self.param_version:
            self.swap(upd.params, upd.version)

    # -- admission --

    def _validate(self, r: Request) -> None:
        sc = self.sc
        cap = (sc.prefill_buckets[-1] if sc.admit == "prefill"
               else sc.prompt_pad)
        if not (1 <= r.prompt_len <= cap):
            raise ValueError(
                f"request {r.req_id}: prompt length {r.prompt_len} "
                f"outside [1, {cap}]")
        if r.prompt_len >= sc.max_len:
            raise ValueError(
                f"request {r.req_id}: prompt length {r.prompt_len} "
                f"leaves no room to generate within max_len="
                f"{sc.max_len}")

    def _admit_one(self, r: Request, slot: int, t: int,
                   records: Dict[int, RequestRecord]) -> int:
        """Admit one request into a free slot; returns 1 if it finished
        at admission (prefill hit EOS/budget on the first token)."""
        rec = obs.get_recorder()
        sc = self.sc
        plen = r.prompt_len
        eff_gen = min(r.max_gen, sc.max_len - plen)
        prompt = np.zeros((sc.prompt_pad,), np.int64)
        prompt[:plen] = r.prompt
        prompt = torch.from_numpy(prompt).to(self.device)
        row = RequestRecord(req_id=r.req_id, arrival=r.arrival,
                            admit_tick=t, slot=slot,
                            param_version_admit=self.param_version)
        records[r.req_id] = row
        obs.COUNTERS.inc("serve.admissions")
        if sc.admit == "prefill":
            lb = next(b for b in sc.prefill_buckets if b >= plen)
            with rec.span("serve.prefill", req=r.req_id, bucket=lb):
                self._state, out = self.fns.admit_prefill_for(lb)(
                    self.params, self._state, slot, prompt, plen,
                    eff_gen, r.req_id)
                tok, done = out.tolist()
            row.tokens.append(int(tok))
            row.first_token_tick = t
            obs.COUNTERS.inc("serve.tokens")
            if done:
                row.finish_tick = t
                obs.COUNTERS.inc("serve.retired")
                return 1
        else:
            with rec.span("serve.admit", req=r.req_id):
                self._state = self.fns.admit(
                    self._state, slot, prompt, plen, eff_gen, r.req_id)
        self._slot_req[slot] = r.req_id
        return 0

    def _admit_arrived(self, queue: deque, t: int,
                       records: Dict[int, RequestRecord]) -> int:
        """Fill free slots from the arrived queue; returns the number of
        requests that finished at admission. The static scheduler only
        admits into an EMPTY pool (the whole batch completes together:
        the baseline continuous batching beats)."""
        free = [i for i, s in enumerate(self._slot_req) if s is None]
        if self.sc.scheduler == "static" \
                and len(free) < self.sc.n_slots:
            return 0
        finished = 0
        for slot in free:
            if not queue or queue[0].arrival > t:
                break
            finished += self._admit_one(queue.popleft(), slot, t,
                                        records)
        return finished

    # -- the run loop --

    def run(self, requests: Sequence[Request], *,
            max_ticks: int = 100_000,
            on_tick: Optional[Callable[["ServeEngine", int], None]] = None
            ) -> ServeReport:
        """Serve `requests` to completion (or `max_ticks`). One tick = an
        optional watcher poll + admissions + one pooled decode step + the
        retirement readback. Deterministic: equal (requests, config,
        params) give equal reports, traced or not."""
        for r in requests:
            self._validate(r)
        rec = obs.get_recorder()
        queue = deque(sorted(requests,
                             key=lambda r: (r.arrival, r.req_id)))
        records: Dict[int, RequestRecord] = {}
        remaining = len(queue)
        swaps0 = obs.COUNTERS.get("serve.swaps")
        occupancy_ticks = 0
        t = 0
        while remaining > 0 and t < max_ticks:
            if on_tick is not None:
                on_tick(self, t)
            if self.watcher is not None:
                self._poll_watcher()
            remaining -= self._admit_arrived(queue, t, records)
            n_active = sum(s is not None for s in self._slot_req)
            emitted = 0
            if n_active:
                with rec.span("serve.decode", tick=t):
                    self._state, out = self.fns.step(self.params,
                                                     self._state)
                    out = out.cpu().numpy()
                emitted, retired = self._collect(out, t, records)
                remaining -= retired
            occupancy_ticks += n_active
            obs.COUNTERS.inc("serve.ticks")
            obs.COUNTERS.inc("serve.slot_occupancy_ticks", n_active)
            if rec.enabled:
                rec.step(kind_detail="serve", tick=t, active=n_active,
                         emitted=emitted,
                         param_version=self.param_version)
            t += 1
        # prefill-admitted tokens are counted at admission, not decode
        total_tokens = sum(len(r.tokens) for r in records.values())
        return self._report(records, len(requests), t, total_tokens,
                            occupancy_ticks,
                            obs.COUNTERS.get("serve.swaps") - swaps0)

    def _collect(self, out: np.ndarray, t: int,
                 records: Dict[int, RequestRecord]) -> Tuple[int, int]:
        rec = obs.get_recorder()
        tok, emit, done = out
        emitted = retired = 0
        for slot, rid in enumerate(self._slot_req):
            if rid is None:
                continue
            row = records[rid]
            if emit[slot]:
                if row.first_token_tick < 0:
                    row.first_token_tick = t
                row.tokens.append(int(tok[slot]))
                emitted += 1
            if done[slot]:
                with rec.span("serve.retire", req=rid, tick=t):
                    row.finish_tick = t
                    self._slot_req[slot] = None
                retired += 1
                obs.COUNTERS.inc("serve.retired")
        obs.COUNTERS.inc("serve.tokens", emitted)
        return emitted, retired

    def _report(self, records, n_requests, ticks, total_tokens,
                occupancy_ticks, swaps) -> ServeReport:
        fin = [r for r in records.values() if r.finished]
        lat = [r.latency for r in fin]
        tpots = [(r.finish_tick - r.first_token_tick)
                 / (len(r.tokens) - 1)
                 for r in fin if len(r.tokens) > 1]
        denom = max(ticks, 1)
        return ServeReport(
            ticks=ticks,
            n_requests=n_requests,
            completed=len(fin),
            dropped=n_requests - len(fin),
            total_tokens=total_tokens,
            goodput_tokens_per_tick=total_tokens / denom,
            ttft_p50=_percentile([r.ttft for r in fin], 50),
            latency_p50=_percentile(lat, 50),
            latency_p95=_percentile(lat, 95),
            latency_p99=_percentile(lat, 99),
            tpot_mean=(sum(tpots) / len(tpots)) if tpots else 0.0,
            occupancy_mean=occupancy_ticks
            / (denom * self.sc.n_slots),
            swaps=swaps,
            records=records,
        )


__all__ = ["RequestRecord", "ServeConfig", "ServeEngine", "ServeReport",
           "gumbel", "sample", "sample_keys", "uniform"]
