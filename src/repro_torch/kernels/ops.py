"""Wrappers around the CUDA kernels (``repro.kernels.ops``).

Each wrapper takes tensors of any length (the kernels need no tile
padding: the last packed word is completed inside the kernel) and
dispatches on the device of its input:

* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`,
  zero-padded to the pack width (each row on its own) and cropped back;
* a CUDA tensor launches the hand-written kernel on the current stream,
  or raises. It never falls back to the plain version.

Packed words are int32 bit patterns (bit j of word k is element 32k + j).
The padding bits of the last word are 1 (sign(0) = +1) on both paths.
The ternary wire's words hold 16 two-bit fields (field j of word k is
element 16k + j); its padding fields are ``0b00``, an abstention.

``launch_counts()`` reports, under the reference's names, how many times
each kernel was launched on a card since ``reset_launch_counts()`` (both
momentum dtypes of ``momentum_sign_pack`` under its one name, every output
dtype of an unpack under its one name; the ternary tally with ties +1,
which has no Pallas counterpart, as ``ternary_majority_plus_one``, and
the stochastic adversaries, which have none either, as ``adversary``, and
again as ``adversary_map`` when a launch draws under a counter map); CPU
calls do not count.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core import sign_compress as sc
from repro_torch.kernels import build, ref

WORD = sc.WORD_DTYPE

_COUNTS: Dict[str, int] = {"momentum_sign_pack": 0, "majority": 0,
                           "apply_vote": 0, "bitpack": 0, "bitunpack": 0,
                           "fused_majority": 0, "ternary_pack": 0,
                           "ternary_majority": 0,
                           "ternary_majority_plus_one": 0,
                           "ternary_unpack": 0, "apply_ternary_vote": 0,
                           "adversary": 0, "adversary_map": 0}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: element types the sign kernels read and bitunpack writes
_SIGN_SUFFIX = {**_SUFFIX, torch.int8: "i8"}


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def _check(t: torch.Tensor, what: str, *, ndim: int, dtypes,
           device: torch.device, strided_rows: bool = False) -> None:
    """Raise unless `t` has `ndim` dims, one of `dtypes`, lies on `device`
    and is contiguous; with `strided_rows` a 2-D `t` may instead have rows
    of contiguous elements any distance >= their length apart."""
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} must be one of {list(dtypes)}, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if strided_rows:
        rows, n = t.shape
        if n > 1 and t.stride(1) != 1:
            raise ValueError(f"{what} must have contiguous rows (stride(1) "
                             f"== 1), got strides {t.stride()}")
        if rows > 1 and t.stride(0) < n:
            raise ValueError(f"{what}'s rows overlap: stride(0) "
                             f"{t.stride(0)} < {n} elements a row")
    elif not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _launch(lib: str, fn: str, *args) -> None:
    status = getattr(build.library(lib), fn)(*args)
    build.check(status, fn)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def momentum_sign_pack(g: torch.Tensor, m: torch.Tensor, beta: float, *,
                       m_out: Optional[torch.Tensor] = None,
                       packed_out: Optional[torch.Tensor] = None,
                       pack: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flat g (n,) f32/bf16 and m (n,) f32/bf16 -> (m' (n,) in m's dtype,
    packed (ceil(n/32),) int32) with m' = beta*m + (1-beta)*g, rounded as
    the reference rounds it in m's dtype (``ref.momentum_sign_pack``).

    `m_out` (m's dtype; may be `m` itself, for an in-place update) and
    `packed_out` receive the results when given. With ``pack=False`` (for
    a codec whose wire is not the 1-bit signs of m') no words are written
    and the second result is None."""
    dev = g.device
    _check(g, "g", ndim=1, dtypes=_SUFFIX, device=dev)
    _check(m, "m", ndim=1, dtypes=_SUFFIX, device=dev)
    n = g.shape[0]
    if m.shape[0] != n:
        raise ValueError(f"g and m lengths differ: {n} vs {m.shape[0]}")
    w = sc.words_for(n)
    if m_out is None:
        m_out = torch.empty_like(m)
    _check(m_out, "m_out", ndim=1, dtypes=(m.dtype,), device=dev)
    if m_out.shape[0] != n:
        raise ValueError(f"m_out must be ({n},), got {tuple(m_out.shape)}")
    if not pack:
        if packed_out is not None:
            raise ValueError("packed_out given with pack=False")
    else:
        if packed_out is None:
            packed_out = torch.empty(w, dtype=WORD, device=dev)
        _check(packed_out, "packed_out", ndim=1, dtypes=(WORD,), device=dev)
        if packed_out.shape[0] != w:
            raise ValueError(f"packed_out must be ({w},), got "
                             f"{tuple(packed_out.shape)}")
    if not _on_card(g):
        m_new, packed = ref.momentum_sign_pack(
            sc.pad_to_pack(g)[0], sc.pad_to_pack(m)[0], beta)
        m_out.copy_(m_new[:n])
        if pack:
            packed_out.copy_(packed)
        return m_out, packed_out
    # ctypes passes each constant as float32 (bf16-exact for bf16 m, see
    # ref.momentum_constants). A null packed pointer makes the kernel write
    # m' only.
    b, c = ref.momentum_constants(beta, m.dtype)
    mom = "" if m.dtype == torch.float32 else "_mbf16"
    _launch("signum_update", f"momentum_sign_pack_{_SUFFIX[g.dtype]}{mom}",
            g.data_ptr(), m.data_ptr(), m_out.data_ptr(),
            packed_out.data_ptr() if pack else None, n, b, c, _stream(g))
    _COUNTS["momentum_sign_pack"] += 1
    return m_out, packed_out


def majority(packed: torch.Tensor, *, out: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """(M, w) int32 packed votes -> (w,) packed majority (ties -> +1)."""
    dev = packed.device
    _check(packed, "packed", ndim=2, dtypes=(WORD,), device=dev)
    m, w = packed.shape
    if m < 1:
        raise ValueError("majority needs at least one voter")
    if out is None:
        out = torch.empty(w, dtype=WORD, device=dev)
    _check(out, "out", ndim=1, dtypes=(WORD,), device=dev)
    if out.shape[0] != w:
        raise ValueError(f"out must be ({w},), got {tuple(out.shape)}")
    if not _on_card(packed):
        return out.copy_(ref.majority(packed))
    _launch("vote", "majority_packed", packed.data_ptr(), out.data_ptr(), m,
            w, _stream(packed))
    _COUNTS["majority"] += 1
    return out


def _check_apply(p: torch.Tensor, votes: torch.Tensor, words: int,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    """Validate an apply's arguments; returns its output tensor."""
    dev = p.device
    _check(p, "p", ndim=1, dtypes=_SUFFIX, device=dev)
    _check(votes, "votes", ndim=1, dtypes=(WORD,), device=dev)
    n = p.shape[0]
    if votes.shape[0] != words:
        raise ValueError(f"votes must hold {words} words for {n} elements, "
                         f"got {votes.shape[0]}")
    if out is None:
        out = torch.empty_like(p)
    _check(out, "out", ndim=1, dtypes=(p.dtype,), device=dev)
    if out.shape[0] != n:
        raise ValueError(f"out must be ({n},), got {tuple(out.shape)}")
    return out


def apply_vote(p: torch.Tensor, votes: torch.Tensor, eta: float,
               weight_decay: float, *, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Flat p (n,) f32/bf16, votes (ceil(n/32),) int32 packed -> updated p:
    p - eta*(unpack(votes) + weight_decay*p) in float32, cast back.

    `out` (may be `p` itself, for an in-place update) receives the result
    when given."""
    n = p.shape[0] if p.dim() else 0
    out = _check_apply(p, votes, sc.words_for(n), out)
    if not _on_card(p):
        new = ref.apply_vote(sc.pad_to_pack(p)[0], votes, eta, weight_decay)
        return out.copy_(new[:n])
    _launch("signum_update", f"apply_vote_{_SUFFIX[p.dtype]}", p.data_ptr(),
            votes.data_ptr(), out.data_ptr(), n, float(eta),
            float(weight_decay), _stream(p))
    _COUNTS["apply_vote"] += 1
    return out


def apply_ternary_vote(p: torch.Tensor, votes: torch.Tensor, eta: float,
                       weight_decay: float, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``apply_vote`` with a 2-bit ternary vote: flat p (n,) f32/bf16,
    votes (ceil(n/16),) int32 words -> p - eta*(v + weight_decay*p), v in
    {-1, 0, +1} decoded on the fly (``0b10`` reads 0)."""
    n = p.shape[0] if p.dim() else 0
    out = _check_apply(p, votes, sc.ternary_words_for(n), out)
    if not _on_card(p):
        new = ref.apply_ternary_vote(sc.pad_to_pack(p, sc.PACK2)[0], votes,
                                     eta, weight_decay)
        return out.copy_(new[:n])
    _launch("signum_update", f"apply_ternary_vote_{_SUFFIX[p.dtype]}",
            p.data_ptr(), votes.data_ptr(), out.data_ptr(), n, float(eta),
            float(weight_decay), _stream(p))
    _COUNTS["apply_ternary_vote"] += 1
    return out


def _rows_out(out: Optional[torch.Tensor], rows: int, w: int,
              dev: torch.device) -> torch.Tensor:
    if out is None:
        return torch.empty((rows, w), dtype=WORD, device=dev)
    _check(out, "out", ndim=2, dtypes=(WORD,), device=dev)
    if tuple(out.shape) != (rows, w):
        raise ValueError(f"out must be ({rows}, {w}), got {tuple(out.shape)}")
    return out


def bitpack(x: torch.Tensor, *, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """(rows, n) f32/bf16/int8 -> (rows, ceil(n/32)) int32 words of the
    signs ``x >= 0``, each row padded on its own (padding bits 1). `out`
    receives the words when given.

    `x` may be a view whose rows are not adjacent (a bucket of a VotePlan's
    ``(M, n_params)`` buffer): each row's elements contiguous
    (``stride(1) == 1``) and the rows ``stride(0) >= n`` elements apart;
    the kernel reads it in place, with no copy."""
    dev = x.device
    _check(x, "x", ndim=2, dtypes=_SIGN_SUFFIX, device=dev,
           strided_rows=True)
    rows, n = x.shape
    out = _rows_out(out, rows, sc.words_for(n), dev)
    if not _on_card(x):
        return out.copy_(ref.bitpack(sc.pad_last(x, sc.PACK)[0]))
    _launch("bitpack", f"bitpack_{_SIGN_SUFFIX[x.dtype]}", x.data_ptr(),
            out.data_ptr(), rows, n, x.stride(0) if rows > 1 else n,
            _stream(x))
    _COUNTS["bitpack"] += 1
    return out


def bitunpack(packed: torch.Tensor, n: int, dtype=torch.float32
              ) -> torch.Tensor:
    """(w,) int32 words -> (n,) of ±1 in `dtype` (int8, f32 or bf16): the
    first n of the 32*w signs."""
    dev = packed.device
    _check(packed, "packed", ndim=1, dtypes=(WORD,), device=dev)
    if dtype not in _SIGN_SUFFIX:
        raise TypeError(f"dtype must be one of {list(_SIGN_SUFFIX)}, got "
                        f"{dtype}")
    w = packed.shape[0]
    if not 0 <= n <= sc.PACK * w:
        raise ValueError(f"{w} words hold at most {sc.PACK * w} signs, "
                         f"asked for {n}")
    if not _on_card(packed):
        return ref.bitunpack(packed, dtype)[:n].clone()
    out = torch.empty(n, dtype=dtype, device=dev)
    _launch("bitpack", f"bitunpack_{_SIGN_SUFFIX[dtype]}",
            packed.data_ptr(), out.data_ptr(), n, _stream(packed))
    _COUNTS["bitunpack"] += 1
    return out


def fused_majority(x: torch.Tensor) -> torch.Tensor:
    """(M, n) f32/bf16/int8 voter values -> (ceil(n/32),) int32 packed
    majority of the signs ``x >= 0`` in one pass (ties and padding bits
    -> +1)."""
    dev = x.device
    _check(x, "x", ndim=2, dtypes=_SIGN_SUFFIX, device=dev)
    m, n = x.shape
    if m < 1:
        raise ValueError("fused_majority needs at least one voter")
    if not _on_card(x):
        return ref.fused_majority(sc.pad_last(x, sc.PACK)[0])
    out = torch.empty(sc.words_for(n), dtype=WORD, device=dev)
    _launch("fused_vote", f"fused_majority_{_SIGN_SUFFIX[x.dtype]}",
            x.data_ptr(), out.data_ptr(), m, n, _stream(x))
    _COUNTS["fused_majority"] += 1
    return out


def ternary_pack(x: torch.Tensor, *, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """(rows, n) int8 symbols or f32/bf16 values -> (rows, ceil(n/16)) int32
    words of 2-bit fields (+1 -> 0b01, -1 -> 0b11, 0 -> 0b00), each row
    padded on its own with abstaining 0b00 fields. An int8 symbol s is
    stored as ``s & 3``; a real value as its ``sign_ternary`` (so -0.0
    abstains). `out` receives the words when given."""
    dev = x.device
    _check(x, "x", ndim=2, dtypes=_SIGN_SUFFIX, device=dev)
    rows, n = x.shape
    out = _rows_out(out, rows, sc.ternary_words_for(n), dev)
    if not _on_card(x):
        return out.copy_(ref.ternary_pack(sc.pad_last(x, sc.PACK2)[0]))
    _launch("ternary_pack", f"ternary_pack_{_SIGN_SUFFIX[x.dtype]}",
            x.data_ptr(), out.data_ptr(), rows, n, _stream(x))
    _COUNTS["ternary_pack"] += 1
    return out


#: the ternary tally's tie rules: the count wire's (ties and all-abstain
#: 0) and the hierarchical wire's (``sign_binary`` of the count: +1)
TIES = ("zero", "plus_one")


def ternary_majority(packed: torch.Tensor, *, ties: str = "zero",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, w) int32 packed ternary votes -> (w,) packed ternary majority:
    per field the +1 votes against the -1 votes (abstentions and the unused
    pattern 0b10 count nothing). ``ties="zero"``: the sign of the symbol
    sum, ties and all-abstain 0b00; ``ties="plus_one"``: 0b01 wherever the
    sum is >= 0, ties and all-abstain included, else 0b11 (the reference's
    ``hierarchical`` wire, ``sign_binary`` of the count)."""
    dev = packed.device
    _check(packed, "packed", ndim=2, dtypes=(WORD,), device=dev)
    if ties not in TIES:
        raise ValueError(f"ties must be one of {TIES}, got {ties!r}")
    m, w = packed.shape
    if m < 1:
        raise ValueError("ternary_majority needs at least one voter")
    if out is None:
        out = torch.empty(w, dtype=WORD, device=dev)
    _check(out, "out", ndim=1, dtypes=(WORD,), device=dev)
    if out.shape[0] != w:
        raise ValueError(f"out must be ({w},), got {tuple(out.shape)}")
    if not _on_card(packed):
        return out.copy_(ref.ternary_majority(packed, ties))
    name = "ternary_majority" + ("" if ties == "zero" else "_plus_one")
    _launch("vote", name, packed.data_ptr(), out.data_ptr(), m, w,
            _stream(packed))
    _COUNTS[name] += 1
    return out


def ternary_unpack(packed: torch.Tensor, n: int, dtype=torch.int8
                   ) -> torch.Tensor:
    """(w,) int32 ternary words -> (n,) of {-1, 0, +1} in `dtype` (int8,
    f32 or bf16; 0 is +0.0): the first n of the 16*w symbols (``0b10``
    reads 0)."""
    dev = packed.device
    _check(packed, "packed", ndim=1, dtypes=(WORD,), device=dev)
    if dtype not in _SIGN_SUFFIX:
        raise TypeError(f"dtype must be one of {list(_SIGN_SUFFIX)}, got "
                        f"{dtype}")
    w = packed.shape[0]
    if not 0 <= n <= sc.PACK2 * w:
        raise ValueError(f"{w} words hold at most {sc.PACK2 * w} symbols, "
                         f"asked for {n}")
    if not _on_card(packed):
        return ref.ternary_unpack(packed, dtype)[:n].clone()
    out = torch.empty(n, dtype=dtype, device=dev)
    _launch("ternary_pack", f"ternary_unpack_{_SIGN_SUFFIX[dtype]}",
            packed.data_ptr(), out.data_ptr(), n, _stream(packed))
    _COUNTS["ternary_unpack"] += 1
    return out


def draw_threshold(p: float) -> int:
    """The integer form of ``uniform < p``: JAX's uniform is ``(bits >> 9)
    / 2^23`` exactly, so it is below the float32 `p` iff ``bits >> 9 <
    ceil(p * 2^23)`` (float64 holds ``p * 2^23`` exactly)."""
    return min(1 << 23, max(0, math.ceil(prng.as_float32(p) * 2.0 ** 23)))


def adversary_(x: torch.Tensor, keys, p: float, flip: bool,
               offset: int = 0, *, start: int = 0, block: int = 0,
               gap: int = 0) -> torch.Tensor:
    """In place on (rows, n) int8 signs `x`: row r drawn under the threefry
    key ``keys[r]`` (``(k0, k1)`` Python ints, ``core.prng``), each column j
    at counter ``offset + start + j``, or under the counter map (`block` >
    0: a model rank's block of a leaf cut along one dim, runs of `block`
    elements each followed by `gap` in the whole leaf) at
    ``offset + l + (l // block) * gap`` with ``l = start + j``: with
    ``flip=False`` (random, colluding) the row becomes +1 where
    ``bernoulli(key, p)`` draws, else -1; with ``flip=True`` (blind) its
    sign is negated there (0 stays 0). `x` may be a view whose rows are not
    adjacent (``stride(1) == 1``, rows ``stride(0) >= n`` apart), and may
    start anywhere. Returns `x`."""
    dev = x.device
    _check(x, "x", ndim=2, dtypes=(torch.int8,), device=dev,
           strided_rows=True)
    rows, n = x.shape
    if len(keys) != rows:
        raise ValueError(f"{rows} rows need {rows} keys, got {len(keys)}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")
    if min(offset, start, block, gap) < 0:
        raise ValueError(f"counter offset {offset}, start {start}, block "
                         f"{block} and gap {gap} must be >= 0")
    if gap and not block:
        raise ValueError(f"a gap of {gap} needs a block (block 0 is no cut)")
    if not _on_card(x):
        return x.copy_(ref.adversary(x, keys, p, flip, offset, start, block,
                                     gap))
    if rows == 0 or n == 0:
        return x
    k = torch.tensor([[int(a) & 0xFFFFFFFF for a in key] for key in keys],
                     dtype=torch.int64).to(torch.int32).to(dev)
    _launch("byzantine", "adversary_i8", x.data_ptr(), k.data_ptr(), rows, n,
            x.stride(0) if rows > 1 else n, offset, draw_threshold(p),
            int(bool(flip)), start, block, gap, _stream(x))
    _COUNTS["adversary"] += 1
    if block:
        _COUNTS["adversary_map"] += 1
    return x
